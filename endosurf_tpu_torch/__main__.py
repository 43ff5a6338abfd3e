"""CLI: python -m endosurf_tpu_torch --cfg <yaml> --mode <mode>

The modes of the JAX package's CLI (``python -m endosurf_tpu``); the model
family is the config's render.type (endosurf | endonerf):
  train    — run / resume training, checkpoints into the exp dir
  test     — test split: view synthesis + metrics, meshes + geometric error
  test_2d  — test split, view synthesis + metrics
  test_3d  — test split, meshes (PLYs) + geometric error (geo_err_mean, mm)
  demo     — all frames, 2D and 3D
  demo_2d  — all frames, 2D
  demo_3d  — all frames, 3D

The serving modes render the checkpoint that training wrote into the
experiment directory; ``--params`` (an npz written by
``endosurf_tpu_torch.bridge``, see ``tools/export_params_npz.py`` for JAX
checkpoints) overrides it, and with neither the seeded init is rendered.
``--device`` defaults to cuda and never falls back.

Under ``torchrun`` (``python -m torch.distributed.run --nproc_per_node N -m
endosurf_tpu_torch ...``) each process joins the group first (NCCL for cuda,
Gloo for cpu), takes the card ``cuda:LOCAL_RANK``, and trains or serves
data-parallel; the main rank writes the files.
"""

from __future__ import annotations

import argparse

MODES = ("train", "test", "test_2d", "test_3d", "demo", "demo_2d", "demo_3d")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--cfg", required=True, help="config yaml path")
    parser.add_argument("--mode", default="test_2d", choices=MODES)
    parser.add_argument("--params", default=None, help="params npz (bridge format)")
    parser.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    args = parser.parse_args(argv)

    import torch

    from endosurf_tpu_torch.parallel import distributed
    from endosurf_tpu_torch.serve import resolve_device
    device = torch.device(args.device)
    if distributed.initialize(device=device):
        if device.type == "cuda":
            device = torch.device("cuda", distributed.local_rank())
            torch.cuda.set_device(device)
        print(f"DIST|rank {distributed.rank()}/{distributed.process_count()}|device {device}",
              flush=True)
    try:
        return run(args, resolve_device(device))
    finally:
        distributed.shutdown()


def run(args, device):
    """The mode ``args.mode`` on ``device``."""
    if args.mode == "train":
        from endosurf_tpu_torch.config import load_config
        cfg = load_config(args.cfg)
        render_type = cfg["render"].get("type", "endosurf")
        if render_type == "endosurf":
            from endosurf_tpu_torch.train.trainer_endosurf import EndoSurfTrainer as trainer
        elif render_type == "endonerf":
            from endosurf_tpu_torch.train.trainer_endonerf import EndoNeRFTrainer as trainer
        else:
            raise ValueError(f"unknown render type {render_type!r}")
        trainer(cfg, mode="train", device=device).start()
        return None

    from endosurf_tpu_torch.bridge import load_params_npz
    from endosurf_tpu_torch.serve import make_renderer
    from endosurf_tpu_torch.train.checkpoint import load_checkpoint

    params, step = None, 0
    if args.params:
        params, npz_step = load_params_npz(args.params, device)
        step = npz_step or 0
    renderer = make_renderer(args.cfg, params=params, step=step, device=device)
    if params is None:
        restored = load_checkpoint(renderer.exp_dir, device)
        if restored is not None:
            renderer.params, renderer.step = restored["params"], int(restored["n_iter"])
            renderer.params_from_init = False
            print(f"PARAMS|checkpoint of iter {renderer.step} in {renderer.exp_dir}",
                  flush=True)
    if renderer.params_from_init:
        print("PARAMS|seeded init (no checkpoint, no --params): metrics are of an "
              "untrained model", flush=True)
    return renderer.demo(test_mode=args.mode.startswith("test"),
                         demo_2d=not args.mode.endswith("_3d"),
                         demo_3d=not args.mode.endswith("_2d"))


if __name__ == "__main__":
    main()
