#!/usr/bin/env python
"""GPU smoke test of the PyTorch/CUDA port (endosurf_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. a CUDA card must be present; prints its name and power limit;
  2. builds the CUDA kernels from the sources in this checkout (one nvcc per
     source, in parallel);
  3. render parity: the CUDA fused_render_rays against its plain PyTorch twin
     on 8192 rays of a synthetic 512x640 frame, full-width seeded model
     (three 9x256 MLPs, 32+32 samples, 4 rounds), float32 and bf16 dot modes,
     at fused_render.PARITY_TOL, with the wrong-precision controls failing;
  4. serving end to end: eval_frames with an EndoSurfRenderer on a synthetic
     512x640 scene with the base.yml settings (bf16 dots, 2048-ray chunks);
     checks that the render kernel served every chunk and that maps and
     metrics are finite;
  5. render timing: kernel vs plain twin on one chunk in each mode;
  6. upsample parity: the CUDA fused_upsample_z against its plain twin on
     8192 rays from sample_train_batch on the synthetic scene with perturbed
     z0, return_sdf, both dot modes, two weight seeds, at
     fused_sampler.PARITY_TOL and, on the kernel's own samples, at
     fused_sampler.CONSISTENCY_TOL, with the wrong-precision controls
     failing; prints every reading the limits were set from;
  7. training end to end: EndoSurfTrainer on the in-memory base.yml config
     and scene (1024 rays, all six losses, march reuse, bf16 dots), 12 steps
     through Trainer.start (2 warm-up steps, then 10), checkpoints in a
     temporary directory read back; checks one upsample launch per step,
     finite losses (logged at steps 1 and 12), the checkpoint round trip;
     reports train rays/s and peak memory; then splits a step into forward /
     backward / Adam (CUDA events) and traces the device's busy and idle
     time (torch.profiler);
  8. upsample timing: kernel vs plain twin on one train batch.
The third-to-last line is the card, the second-to-last the kernel record
(JSON), the last the device record (JSON).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

N_PARITY = 8192
H, W = 512, 640
CHUNK = 2048
RAY_BATCH = 1024
N_STEPS, N_WARM = 12, 2
N_SPLIT = 3                                    # steps of the time split and trace
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
UPSAMPLE_KERNELS = ("sweep_kernel", "draw_kernel", "merge_kernel", "upsample_prep_kernel")
GEMM_KERNELS = ("gemm", "xmma", "cutlass", "cublas", "sm90_", "sm80_")


def base_cfg() -> dict:
    """configs/endosurf/base.yml's keys for serving and training, in memory."""
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
        "train": {"n_iter": N_STEPS, "matmul_precision": "default",
                  "sampling_precision": "default", "ray_batch": RAY_BATCH,
                  "mask_guided_ray_sampling": True,
                  "color_loss_weight": 1.0, "depth_loss_weight": 1.0, "sdf_loss_weight": 1.0,
                  "angle_loss_weight": 0.1, "eikonal_loss_weight": 0.1,
                  "surf_neig_loss_weight": 0.1, "surf_neig_rad": 0.1, "resume": False,
                  "optim": {"lr": 0.0005, "lr_alpha": 0.05, "warm_up_end": 5000},
                  "eval": {"ray_chunk": CHUNK}},
        "net": net,
        "log": {"i_eval": 0, "i_save": N_STEPS},
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


def _macs(params, name, head_cols=None):
    """Multiply-adds per point of a net's layers (the last layer with only
    ``head_cols`` outputs when given)."""
    layers = params[name]["layers"]
    out = 0
    for l, layer in enumerate(layers):
        d_in, d_out = layer["v"].shape
        out += d_in * (head_cols if head_cols is not None and l == len(layers) - 1 else d_out)
    return out


def _param_bytes(params, names, dtype) -> int:
    width = 2 if dtype == torch.bfloat16 else 4
    return sum(t.numel() * width for n in names
               for layer in params[n]["layers"] for t in layer.values())


def bound_ms(flops: float, bytes_moved: float, dtype):
    """(least time in ms, what bounds it) for the work on one H100 SXM."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], bytes_moved / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def train_step_split(trainer, step_ms: float, smi: str) -> None:
    """Where a train step's time goes, after the counted run: forward /
    backward / Adam by CUDA events, then device time by kernel family in a
    torch.profiler trace, and the device's idle share of ``step_ms`` (the
    untraced step)."""
    from torch.profiler import ProfilerActivity, profile

    from endosurf_tpu_torch.train.trainer_endosurf import make_loss_fn
    tc = trainer.train_cfg
    loss_fn = make_loss_fn(trainer.spec, trainer.rspec, H, W, RAY_BATCH, trainer.loss_weights,
                           tc["surf_neig_rad"], precision=trainer.precision,
                           sampling_precision=trainer.sampling_precision)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    split = [0.0, 0.0, 0.0]
    for s in range(N_SPLIT):
        trainer.optimizer.zero_grad(set_to_none=True)
        ev[0].record()
        total, _ = loss_fn(trainer.params, trainer.scene.device_arrays, N_STEPS + 1 + s,
                           trainer.generator)
        ev[1].record()
        total.backward()
        ev[2].record()
        trainer.optimizer.step()
        ev[3].record()
        torch.cuda.synchronize()
        for i in range(3):
            split[i] += ev[i].elapsed_time(ev[i + 1]) / N_SPLIT
    whole = sum(split)
    print(f"train step split ({smi}, CUDA events, {N_SPLIT} steps, a sync per step): "
          f"{whole:.2f} ms = forward {split[0]:.2f} ({100 * split[0] / whole:.1f} %), "
          f"backward {split[1]:.2f} ({100 * split[1] / whole:.1f} %), "
          f"Adam {split[2]:.2f} ({100 * split[2] / whole:.1f} %)", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for s in range(N_SPLIT):
            trainer.train_step(N_STEPS + N_SPLIT + 1 + s)
        torch.cuda.synchronize()
    fam = {"upsample kernel": 0.0, "matrix products": 0.0, "other kernels": 0.0}
    launches = 0
    for evt in prof.key_averages():
        dev_us = (getattr(evt, "self_device_time_total", None)
                  or getattr(evt, "self_cuda_time_total", 0))
        if dev_us <= 0 or evt.key.startswith(("aten::", "cuda", "Activity")):
            continue
        launches += evt.count
        key = evt.key.lower()
        if any(k in evt.key for k in UPSAMPLE_KERNELS):
            fam["upsample kernel"] += dev_us / N_SPLIT / 1e3
        elif any(k in key for k in GEMM_KERNELS):
            fam["matrix products"] += dev_us / N_SPLIT / 1e3
        else:
            fam["other kernels"] += dev_us / N_SPLIT / 1e3
    busy = sum(fam.values())
    if busy == 0:
        print("train step trace: the profiler recorded no device time", flush=True)
        return
    print(f"train step trace ({N_SPLIT} steps): device busy {busy:.2f} ms of the "
          f"{step_ms:.1f} ms step (idle {100 * (1 - busy / step_ms):.1f} %), "
          f"{launches // N_SPLIT} kernel launches a step; "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in fam.items()), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from endosurf_tpu_torch.data.scene_data import (
        frame_rays,
        make_synthetic_arrays,
        sample_train_batch,
    )
    from endosurf_tpu_torch.evaluation.render_eval import eval_frames
    from endosurf_tpu_torch.kernels import build
    from endosurf_tpu_torch.kernels import fused_render as fr
    from endosurf_tpu_torch.kernels import fused_sampler as fs
    from endosurf_tpu_torch.models.endosurf import RenderSpec, _split_rays, _stratified_z
    from endosurf_tpu_torch.models.fields import EndoSurfSpec, init_endosurf_params
    from endosurf_tpu_torch.ops.geometry import ray_sphere_intersection
    from endosurf_tpu_torch.serve import EndoSurfRenderer
    from endosurf_tpu_torch.train.checkpoint import load_checkpoint
    from endosurf_tpu_torch.train.trainer_endosurf import EndoSurfTrainer

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

    # 3. render parity on the card
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

    # 4. serving end to end through the serving entry point
    renderer = EndoSurfRenderer(cfg, scene=renderer_scene, step=int(step), device=dev)
    fr.LAUNCHES["fused_render_rays"] = 0
    fs.LAUNCHES["fused_upsample_z"] = 0
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
    check(fs.LAUNCHES["fused_upsample_z"] == 0, "serving launched the upsample kernel")
    for k, ch in (("rgb", 3), ("depth", 1), ("normal", 3)):
        check(pred[k].shape == (1, H, W, ch), f"{k} map shape {pred[k].shape}")
        check(bool(np.isfinite(pred[k]).all()), f"{k} map finite")
    check(all(math.isfinite(v) for v in stats.values()), f"finite metrics {stats}")

    # 5. render timing on one main-path chunk, kernel vs plain, in each mode
    chunk = all_rays[:CHUNK].contiguous()
    times = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        k_ms = cuda_ms(lambda: fr.fused_render_rays_cuda(spec, params, chunk, step, *args, dt, dt), 5)
        p_ms = cuda_ms(lambda: fr.fused_render_rays_reference(spec, params, chunk, step, *args, dt, dt), 5)
        times[name] = (k_ms, p_ms)
        print(f"timing {name} ({CHUNK} rays, {smi}): kernel {k_ms:.3f} ms "
              f"({CHUNK / k_ms * 1e3:.0f} rays/s), plain {p_ms:.3f} ms "
              f"({CHUNK / p_ms * 1e3:.0f} rays/s)", flush=True)

    # 6. upsample parity on train-batch rays with perturbed z0, two seeds
    arrays = renderer_scene.device_arrays
    up_args = (rspec.n_importance, rspec.up_sample_steps)

    def upsample_inputs(n, gen):
        rays_b = sample_train_batch(arrays, H, W, n, generator=gen)["rays"]
        rays_o, rays_d, rays_d_z, t = _split_rays(rays_b)
        near, far, _ = ray_sphere_intersection(rays_o, rays_d)
        z0 = _stratified_z(near, far, rspec.n_samples,
                           torch.rand(n, 1, generator=gen, device=dev))
        return rays_o, rays_d_z, t, z0

    u_max_err = 0.0
    for seed in (0, 1):
        s_params = init_endosurf_params(spec, torch.Generator().manual_seed(seed), dev)
        up_in = upsample_inputs(N_PARITY, torch.Generator(device=dev).manual_seed(seed))
        ugot, uref = {}, {}
        for name, dt in dtypes.items():
            z, sdf = fs.fused_upsample_z_cuda(spec, s_params, *up_in, *up_args, dt, True)
            ugot[name] = {"z": z, "sdf": sdf}
            z, sdf = fs.fused_upsample_z_reference(spec, s_params, *up_in, *up_args, dt, True)
            uref[name] = {"z": z, "sdf": sdf}
        torch.cuda.synchronize()
        for k_name, k_dt in dtypes.items():
            for t_name, t_dt in dtypes.items():
                u_errs = fs.parity_errors(ugot[k_name], uref[t_name], t_dt)
                cons = fs.consistency_report(fs.consistency_errors(
                    spec, s_params, *up_in, ugot[k_name]["z"], ugot[k_name]["sdf"], *up_args,
                    t_dt), t_dt)
                tol = fs.PARITY_TOL[t_dt]
                what = "sound" if k_name == t_name else "control"
                for k, (med, p99, mx, share, _) in u_errs.items():
                    print(f"upsample {what} seed {seed} kernel {k_name} twin {t_name} {k} "
                          f"({N_PARITY} rays): median {med:.3e} (tol {tol['median']:g}), p99 "
                          f"{p99:.3e} (tol {tol['p99']:g}), max {mx:.3e} (tol "
                          f"{tol['max'][k]:g}), over {tol['share'][0]:g} {100 * share:.2f} % "
                          f"(tol {100 * tol['share'][1]:g} %)", flush=True)
                (kept,), _ = cons["kept"]
                (sp_med, sp_share, sp_max), _ = cons["sdf_point"]
                (judged, worst), _ = cons["draw"]
                print(f"upsample {what} seed {seed} kernel {k_name} consistency at {t_name}: "
                      f"z0 kept on {100 * kept:.2f} % of rays; sdf at its own z: median "
                      f"{sp_med:.3e}, {100 * sp_share:.2f} % over "
                      f"{fs.CONSISTENCY_TOL[t_dt]['sdf_point'][1][0]:g}, max {sp_max:.3e}; "
                      f"draws replayed: {100 * judged:.2f} % of rays judged, worst "
                      f"{worst:.3e} of the error model", flush=True)
                ok = all(v[-1] for v in u_errs.values()) and all(v[1] for v in cons.values())
                if k_name == t_name:
                    check(ok, f"upsample kernel vs plain twin out of tolerance ({k_name}, "
                              f"seed {seed}): {u_errs} {cons}")
                else:   # the limits must tell the precisions apart
                    check(not ok, f"upsample kernel {k_name} passes the {t_name} limits")
        u_max_err = max(u_max_err, max(v[2] for v in fs.parity_errors(
            ugot["bfloat16"], uref["bfloat16"], torch.bfloat16).values()))

    # 7. training end to end through the trainer's entry points
    with tempfile.TemporaryDirectory() as exp_root:
        tcfg = base_cfg()
        tcfg["exp"]["exp_dir"] = exp_root
        trainer = EndoSurfTrainer(tcfg, mode="train", scene=renderer_scene, device=dev)
        fr.LAUNCHES["fused_render_rays"] = 0
        fs.LAUNCHES["fused_upsample_z"] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.start(log_every=N_STEPS, stop_after=N_WARM)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.start(log_every=N_STEPS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        train_launches = fs.LAUNCHES["fused_upsample_z"]
        check(train_launches == N_STEPS,
              f"{train_launches} upsample launches for {N_STEPS} steps")
        check(fr.LAUNCHES["fused_render_rays"] == 0, "training launched the render kernel")
        metrics = {}
        with open(os.path.join(trainer.exp_dir, "logs", "metrics.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                if rec["tag"].startswith("train/loss"):
                    metrics.setdefault(rec["step"], {})[rec["tag"]] = rec["value"]
        check(sorted(metrics) == [1, N_STEPS], f"logged steps {sorted(metrics)}")
        check(all(len(m) == 7 and all(math.isfinite(v) for v in m.values())
                  for m in metrics.values()), f"every loss finite at steps 1, {N_STEPS}")
        restored = load_checkpoint(trainer.exp_dir, dev)
        check(restored is not None and restored["n_iter"] == N_STEPS, "checkpoint written")
        for name, layers in trainer.params.items():
            if name == "deviation_network":
                check(torch.equal(restored["params"][name]["variance"],
                                  layers["variance"].detach()), "checkpoint variance")
                continue
            for a, b in zip(restored["params"][name]["layers"], layers["layers"]):
                check(all(torch.equal(a[k], b[k].detach()) for k in b), f"checkpoint {name}")
        train_s = t2 - t1
        train_rps = (N_STEPS - N_WARM) * RAY_BATCH / train_s
        step_ms = train_s / (N_STEPS - N_WARM) * 1e3
        last = metrics[N_STEPS]
        print(f"train: {N_STEPS} steps x {RAY_BATCH} rays, warm-up {t1 - t0:.2f} s for "
              f"{N_WARM}, then {train_s:.3f} s for {N_STEPS - N_WARM} = "
              f"{step_ms:.1f} ms/step, {train_rps:.0f} rays/s "
              f"({smi}); peak memory {peak_gib:.2f} GiB; {train_launches} upsample launches; "
              f"step {N_STEPS}: " + ", ".join(f"{k[6:]} {v:.4f}" for k, v in last.items()),
              flush=True)
        train_step_split(trainer, step_ms, smi)

    # 8. upsample timing on one train batch (the main path's shape), both modes
    tb_in = upsample_inputs(RAY_BATCH, torch.Generator(device=dev).manual_seed(2))
    utimes = {}
    for name, dt in dtypes.items():
        k_ms = cuda_ms(lambda: fs.fused_upsample_z_cuda(spec, params, *tb_in, *up_args, dt, True), 10)
        p_ms = cuda_ms(lambda: fs.fused_upsample_z_reference(spec, params, *tb_in, *up_args, dt, True), 10)
        utimes[name] = (k_ms, p_ms)
        print(f"upsample timing {name} ({RAY_BATCH} rays, {smi}): kernel {k_ms:.3f} ms, "
              f"plain {p_ms:.3f} ms", flush=True)
    print(f"train step breakdown (bf16): {step_ms:.1f} ms/step, upsample kernel "
          f"{utimes['bfloat16'][0]:.3f} ms ({100 * utimes['bfloat16'][0] / step_ms:.1f} %), "
          f"rest {step_ms - utimes['bfloat16'][0]:.1f} ms", flush=True)

    # the kernel record: work, bounds and times at the main paths' shapes (bf16)
    bf = torch.bfloat16
    deform, sdf_hidden = _macs(params, "deform_network"), _macs(params, "sdf_network", 0)
    sdf_full, color = _macs(params, "sdf_network"), _macs(params, "color_network")
    chain = deform + _macs(params, "sdf_network", 1)      # deform -> sdf head
    k_new = rspec.n_importance // rspec.up_sample_steps
    n_sweep = rspec.n_samples + k_new * (rspec.up_sample_steps - 1)
    n_field = rspec.n_samples + rspec.n_importance
    render_flops = 2 * CHUNK * (n_sweep * chain
                                + n_field * (4 * deform + sdf_full + sdf_hidden + color))
    render_bytes = (CHUNK * 9 * 4 * 2 + _param_bytes(
        params, ("deform_network", "sdf_network", "color_network"), bf))
    upsample_flops = 2 * RAY_BATCH * n_field * chain        # return_sdf: every sample
    upsample_bytes = (RAY_BATCH * (7 + rspec.n_samples + 2 * n_field) * 4
                      + _param_bytes(params, ("deform_network", "sdf_network"), bf))
    r_bound, r_by = bound_ms(render_flops, render_bytes, bf)
    u_bound, u_by = bound_ms(upsample_flops, upsample_bytes, bf)
    print(f"bounds (H100 SXM peaks, bf16 989 TFLOP/s, 3.35 TB/s): render {CHUNK} rays "
          f"{render_flops / 1e12:.3f} TFLOP -> {r_bound:.3f} ms ({r_by}); upsample "
          f"{RAY_BATCH} rays {upsample_flops / 1e12:.4f} TFLOP -> {u_bound:.4f} ms ({u_by})",
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {"name": "fused_render_rays", "route": "cuda",
         "source": "endosurf_tpu_torch/kernels/csrc/fused_render.cu",
         "replaces": "endosurf_tpu/kernels/fused_render.py:274",
         "launches": launches,
         "max_abs_err": max(v[1] for v in errs["bfloat16"].values()),
         "ms": times["bfloat16"][0], "plain_ms": times["bfloat16"][1],
         "bound_ms": r_bound, "bound_by": r_by, "library_ms": None},
        {"name": "fused_upsample_z", "route": "cuda",
         "source": "endosurf_tpu_torch/kernels/csrc/fused_sampler.cu",
         "replaces": "endosurf_tpu/kernels/fused_sampler.py:515",
         "launches": train_launches,
         "max_abs_err": u_max_err,
         "ms": utimes["bfloat16"][0], "plain_ms": utimes["bfloat16"][1],
         "bound_ms": u_bound, "bound_by": u_by, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
