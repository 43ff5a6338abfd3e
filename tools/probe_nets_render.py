#!/usr/bin/env python
"""The render kernel on one of chip_smoke.py's NET_SHAPES (phase 37's nets),
against its plain twin and against a float64 twin, per map.

    python tools/probe_nets_render.py [SHAPE ...] [--rays N] [--dtype float32|bfloat16]

For each shape (default: all of NET_SHAPES): seeded weights (seed 0), the
first N rays (default 8192) of frame 3 of chip_smoke.py's synthetic
512x640 scene, strided as phase 3 takes them, base.yml's render settings.
Prints per map the p99 and max of the per-ray max-over-channels error of
the kernel against the plain twin (fused_render.parity_errors, with the
PARITY_TOL verdict), and the median, p99 and max of the kernel's and of the
plain twin's error against the twin run in float64 (parameters and rays in
float64; float32 only: in bf16 the float64 yardstick is
fused_render_rays_float64), and the share of rays over the p99 limit. A
kernel that is only as far from float64 as its twin differs from the twin
by float32 noise. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys

import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))


def main() -> int:
    import chip_smoke as cs
    from endosurf_tpu_torch.data.scene_data import frame_rays, make_synthetic_arrays
    from endosurf_tpu_torch.kernels import fused_render as fr
    from endosurf_tpu_torch.kernels.fused_sampler import to_float64
    from endosurf_tpu_torch.models.endosurf import RenderSpec
    from endosurf_tpu_torch.models.fields import EndoSurfSpec, init_endosurf_params

    ap = argparse.ArgumentParser()
    ap.add_argument("shapes", nargs="*", default=list(cs.NET_SHAPES))
    ap.add_argument("--rays", type=int, default=cs.N_PARITY)
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    dt = getattr(torch, args.dtype)
    scene = make_synthetic_arrays(n_frames=4, h=cs.H, w=cs.W, seed=0, device=dev)
    rays = frame_rays(scene.device_arrays, cs.H, cs.W, 3).reshape(-1, 9)
    rays = rays[:: rays.shape[0] // args.rays][:args.rays].contiguous()
    print(torch.cuda.get_device_name(0), f"{args.rays} rays, {args.dtype}")
    for shape in args.shapes:
        cfg = cs.nets_cfg(shape)
        spec, rspec = EndoSurfSpec.from_config(cfg["net"]), RenderSpec.from_config(cfg["render"])
        params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
        ra = (30000.0, rspec.n_samples, rspec.n_importance, rspec.up_sample_steps,
              rspec.anneal_end)
        got = fr.fused_render_rays_cuda(spec, params, rays, *ra, dt, dt)
        twin = fr.fused_render_rays_reference(spec, params, rays, *ra, dt, dt)
        if dt == torch.float32:
            ref = fr.fused_render_rays_reference(spec, to_float64(params), rays.double(), *ra)
        else:
            ref = fr.fused_render_rays_float64(spec, params, rays, *ra)
        par = fr.parity_errors(got, twin, dt)
        for k, (p99, mx, ok) in par.items():
            bulk = fr.PARITY_TOL[dt][k][0]
            per_ray = (got[k] - twin[k]).abs().amax(-1)

            def q(x):
                e = (x[k].double() - ref[k].double()).abs().amax(-1)
                qs = torch.quantile(e, torch.tensor([0.5, 0.99], dtype=e.dtype, device=e.device))
                return f"{float(qs[0]):.3e} / {float(qs[1]):.3e} / {float(e.max()):.3e}"
            print(f"{shape} {k}: kernel vs twin p99 {p99:.3e} max {mx:.3e} "
                  f"({'within' if ok else 'OUTSIDE'} PARITY_TOL; "
                  f"{100 * float((per_ray > bulk).float().mean()):.2f} % of rays over {bulk:g}); "
                  f"vs float64 (median / p99 / max): kernel {q(got)}, twin {q(twin)}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
