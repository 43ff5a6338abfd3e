#!/usr/bin/env python
"""GPU smoke test of the PyTorch/CUDA port (endosurf_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. a CUDA card must be present; prints its name and power limit;
  2. builds the CUDA kernel from the sources in this checkout;
  3. parity: the CUDA fused_render_rays against its plain PyTorch twin on
     8192 rays of a synthetic 512x640 frame, full-width seeded model (three
     9x256 MLPs, 32+32 samples, 4 rounds), float32 and bf16 dot modes, at
     fused_render.PARITY_TOL;
  4. end to end: eval_frames with an EndoSurfRenderer on a synthetic
     512x640 scene with the base.yml settings (bf16 dots, 2048-ray chunks);
     checks that the kernel served every chunk and that maps and metrics
     are finite;
  5. timing: kernel vs plain twin, rays/s, on one chunk in each mode.
The second-to-last line is the kernel record (JSON), the last the device
record (JSON).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

N_PARITY = 8192
H, W = 512, 640
CHUNK = 2048


def base_cfg() -> dict:
    """configs/endosurf/base.yml's keys for serving, in memory."""
    net = {
        "bound": 1.0, "use_deform": True,
        "deform_network": {"enc_pos_cfg": {"multires": 6}, "enc_time_cfg": {"multires": 6},
                           "n_layers": 9, "hidden_dim": 256, "skips": [4], "out_dim": 3},
        "sdf_network": {"enc_pos_cfg": {"multires": 6}, "n_layers": 9, "hidden_dim": 256,
                        "skips": [4], "out_dim": 257, "geometric_init": True,
                        "geometric_init_bias": 0.8},
        "color_network": {"enc_pos_cfg": {"multires": 10}, "enc_dir_cfg": {"multires": 4},
                          "n_layers": 9, "hidden_dim": 256, "skips": [4], "feat_dim": 256,
                          "out_dim": 3},
        "deviation_network": {"init_val": 0.3},
    }
    return {
        "exp": {"project_name": "endosurf", "exp_name": "chip_smoke",
                "exp_dir": "logs", "seed": 0},
        "render": {"type": "endosurf", "anneal_end": 50000, "n_samples": 32,
                   "n_importance": 32, "important_begin_iter": 0, "up_sample_steps": 4,
                   "perturb": True},
        "train": {"matmul_precision": "default", "sampling_precision": "default",
                  "eval": {"ray_chunk": CHUNK}},
        "net": net,
        "demo": {"ray_batch": 1024},
    }


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call (CUDA events, after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from endosurf_tpu_torch.data.scene_data import frame_rays, make_synthetic_arrays
    from endosurf_tpu_torch.evaluation.render_eval import eval_frames
    from endosurf_tpu_torch.kernels import build
    from endosurf_tpu_torch.kernels import fused_render as fr
    from endosurf_tpu_torch.models.endosurf import RenderSpec
    from endosurf_tpu_torch.models.fields import EndoSurfSpec, init_endosurf_params
    from endosurf_tpu_torch.serve import EndoSurfRenderer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build_library()
    build.load_library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # 3. parity on the card
    cfg = base_cfg()
    renderer_scene = make_synthetic_arrays(n_frames=4, h=H, w=W, seed=0, device=dev)
    spec = EndoSurfSpec.from_config(cfg["net"])
    rspec = RenderSpec.from_config(cfg["render"])
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    all_rays = frame_rays(renderer_scene.device_arrays, H, W, 3).reshape(-1, 9)
    rays = all_rays[:: all_rays.shape[0] // N_PARITY][:N_PARITY].contiguous()
    step = 30000.0
    args = (rspec.n_samples, rspec.n_importance, rspec.up_sample_steps, rspec.anneal_end)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    got, ref, errs = {}, {}, {}
    for name, dt in dtypes.items():
        got[name] = fr.fused_render_rays_cuda(spec, params, rays, step, *args, dt, dt)
        ref[name] = fr.fused_render_rays_reference(spec, params, rays, step, *args, dt, dt)
        torch.cuda.synchronize()
        errs[name] = fr.parity_errors(got[name], ref[name], dt)
        bulk, max_tol = fr.PARITY_TOL[dt]
        for k, (p99, mx, ok) in errs[name].items():
            print(f"parity {name} {k} ({N_PARITY} rays): max {mx:.3e} (tol {max_tol[k]:g}), "
                  f"p99 {p99:.3e} (tol {bulk:g})", flush=True)
    bad = [(n, k) for n, e in errs.items() for k, v in e.items() if not v[2]]
    check(not bad, f"kernel vs plain twin out of tolerance: {bad}")
    # The limits must tell the precisions apart: the kernel at one dot
    # precision fails against the twin at the other.
    for k_name, t_name in (("float32", "bfloat16"), ("bfloat16", "float32")):
        ctl = fr.parity_errors(got[k_name], ref[t_name], dtypes[t_name])
        worst = max(ctl, key=lambda k: ctl[k][0])
        print(f"control: kernel {k_name} vs twin {t_name}: worst p99 {worst} "
              f"{ctl[worst][0]:.3e} (tol {fr.PARITY_TOL[dtypes[t_name]][0]:g})", flush=True)
        check(not all(v[2] for v in ctl.values()),
              f"kernel {k_name} passes the {t_name} parity limits")

    # 4. end to end through the serving entry point
    renderer = EndoSurfRenderer(cfg, scene=renderer_scene, step=int(step), device=dev)
    fr.LAUNCHES["fused_render_rays"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats, pred = eval_frames(renderer, renderer_scene.list_test[:1], int(step),
                              ray_chunk=cfg["train"]["eval"]["ray_chunk"],
                              save_images=False, return_pred=True)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = fr.LAUNCHES["fused_render_rays"]
    n_chunks = math.ceil(H * W / CHUNK)
    print(f"e2e: {H}x{W} frame in {e2e_s:.2f} s ({H * W / e2e_s:.0f} rays/s), "
          f"{launches} kernel launches for {n_chunks} chunks; "
          + ", ".join(f"{k} {v:.4f}" for k, v in stats.items()), flush=True)
    check(launches == n_chunks, f"{launches} kernel launches for {n_chunks} chunks")
    for k, ch in (("rgb", 3), ("depth", 1), ("normal", 3)):
        check(pred[k].shape == (1, H, W, ch), f"{k} map shape {pred[k].shape}")
        check(bool(np.isfinite(pred[k]).all()), f"{k} map finite")
    check(all(math.isfinite(v) for v in stats.values()), f"finite metrics {stats}")

    # 5. timing on one main-path chunk, kernel vs plain, in each mode
    chunk = all_rays[:CHUNK].contiguous()
    times = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        k_ms = cuda_ms(lambda: fr.fused_render_rays_cuda(spec, params, chunk, step, *args, dt, dt), 5)
        p_ms = cuda_ms(lambda: fr.fused_render_rays_reference(spec, params, chunk, step, *args, dt, dt), 5)
        times[name] = (k_ms, p_ms)
        print(f"timing {name} ({CHUNK} rays, {smi}): kernel {k_ms:.3f} ms "
              f"({CHUNK / k_ms * 1e3:.0f} rays/s), plain {p_ms:.3f} ms "
              f"({CHUNK / p_ms * 1e3:.0f} rays/s)", flush=True)

    k_ms, p_ms = times["bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "fused_render_rays", "route": "cuda",
        "source": "endosurf_tpu_torch/kernels/csrc/fused_render.cu",
        "replaces": "endosurf_tpu/kernels/fused_render.py:274",
        "launches": launches,
        "max_abs_err": max(v[1] for v in errs["bfloat16"].values()),
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
