#!/usr/bin/env python
"""Device-time breakdown of the CUDA render kernel's launch sequence.

Runs ``fused_render_rays_cuda`` on one chunk of a synthetic 512x640 frame
(full-width seeded model, 32+32 samples, 4 rounds) under torch.profiler and
prints the device time of each __global__ kernel and of each family
(chip_smoke.py's RENDER_FAMILIES: sweep -- prep, sdf sweep, draw, merge;
in bf16 the tensor-core field stage's deform, sdf, coupling -- midpoint and
coupling kernels -- and colour; in float32 the SIMT field_kernel;
composite), the share of each, the wrapper's host time per call, and the
achieved FLOP rate from the model's shapes. Needs a CUDA device:

    python tools/profile_render_kernel.py [--rays 2048] [--dtype bf16|f32] [--reps 5]
"""

from __future__ import annotations

import argparse
import re
import os.path as osp
import subprocess
import sys
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from chip_smoke import RENDER_FAMILIES, net_macs  # noqa: E402  (chip_smoke's work count)


def field_flops_per_ray(params, n0=32, k=8, rounds=4):
    """FLOPs per ray of the sweeps and the field evaluation (2 per MAC), from
    the parameter shapes: a sweep point runs deform -> SDF head; a field point
    runs the deform net on 4 streams (primal + 3 tangents), the SDF net with
    its feature columns, the adjoint over its hidden layers, and the colour
    net."""
    deform, color = net_macs(params, "deform_network"), net_macs(params, "color_network")
    sdf_full, sdf_hidden = net_macs(params, "sdf_network"), net_macs(params, "sdf_network", 0)
    sweep_points = n0 + k * (rounds - 1)
    field_points = n0 + k * rounds
    return (2 * sweep_points * (deform + net_macs(params, "sdf_network", 1)),
            2 * field_points * (4 * deform + sdf_full + sdf_hidden + color))


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from endosurf_tpu_torch.data.scene_data import frame_rays, make_synthetic_arrays
    from endosurf_tpu_torch.kernels import fused_render as fr
    from endosurf_tpu_torch.models.fields import EndoSurfSpec, init_endosurf_params

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--rays", type=int, default=2048)
    parser.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dt = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    spec = EndoSurfSpec()
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    scene = make_synthetic_arrays(4, 512, 640, 0, dev)
    rays = frame_rays(scene.device_arrays, 512, 640, 3).reshape(-1, 9)[:args.rays].contiguous()

    def call():
        return fr.fused_render_rays_cuda(spec, params, rays, 30000.0, 32, 32, 4, 50000.0, dt, dt)

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.reps):
        call()
    host_enqueue_ms = (time.perf_counter() - t0) / args.reps * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / args.reps * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            call()
        torch.cuda.synchronize()
    rows = []   # device kernels: ours and the operand prep's elementwise ones
    for evt in prof.key_averages():
        dev_us = (getattr(evt, "self_device_time_total", None)
                  or getattr(evt, "self_cuda_time_total", 0))
        # aten:: ops report their kernels' time again; runtime API rows are host
        if dev_us > 0 and not evt.key.startswith(("aten::", "cuda", "Activity")):
            rows.append((evt.key, dev_us / args.reps, evt.count // args.reps))
    total = sum(r[1] for r in rows)
    print(f"card: {smi}")
    print(f"{args.rays} rays, {args.dtype}: wall {wall_ms:.3f} ms/call, "
          f"host enqueue {host_enqueue_ms:.3f} ms/call, device kernels {total / 1e3:.3f} ms/call")
    for key, us, n in sorted(rows, key=lambda r: -r[1]):
        ours = re.search(r"(\w+_kernel)(<\w+>)?\(", key)
        name = ours.group(1) + (ours.group(2) or "") if ours else "operand prep: " + key[:50]
        print(f"  {us / 1e3:9.3f} ms  {100 * us / max(total, 1):5.1f} %  x{n:<3d} {name}")
    families = {}
    for key, us, _ in rows:
        fam = next((f for f, names in RENDER_FAMILIES.items() if any(n in key for n in names)),
                   "other")
        families[fam] = families.get(fam, 0.0) + us
    print("  by family: " + ", ".join(f"{f} {us / 1e3:.3f} ms ({100 * us / max(total, 1):.1f} %)"
                                      for f, us in sorted(families.items(), key=lambda r: -r[1])))
    sweep_f, field_f = field_flops_per_ray(params)
    flops = (sweep_f + field_f) * args.rays
    busy_ms = total / 1e3 if total > 0 else wall_ms
    if total == 0:
        print("profiler recorded no device time; rates below use the wall time")
    print(f"model FLOPs/ray: sweeps {sweep_f / 1e6:.1f} M, field {field_f / 1e6:.1f} M; "
          f"achieved {flops / (busy_ms * 1e-3) / 1e12:.2f} TFLOP/s")


if __name__ == "__main__":
    main()
