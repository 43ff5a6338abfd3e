#!/usr/bin/env python
"""sha256 of every EndoSurf kernel's outputs on base.yml's nets, in float32
and in bf16, to hold one checkout's kernels against another's bit for bit on
one card.

On the full seeded net (seed 0): the render (``fused_render_rays_cuda``,
1024 rays, 32 + 32 samples, 4 rounds, both passes at one precision), the
upsampling (``fused_upsample_z_cuda`` with return_sdf, 1024 rays), the march
(``fused_ray_march_cuda``, the same rays), the grid query
(``fused_sdf_observed_cuda``, a 1,048,576-point slab of the 128^3 grid over
[-1.2, 1.2]^3 at t = 0.5) and the six segment kernels
(``fused_train_cuda``: each forward's outputs and each backward's weight
gradients and input cotangents, 65,536 seeded points, seeded cotangents),
each at "highest" (float32, SIMT) and "default" (bf16, tensor cores):

    python tools/endosurf_bits.py [--root CHECKOUT]             # prints the digests
    python tools/endosurf_bits.py --root A --other B            # both, then compares

With ``--other`` each checkout runs in a process of its own and the script
exits 1 if any digest differs. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os.path as osp
import subprocess
import sys


def _sha(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def digests() -> dict:
    """{kernel and precision: digest} of the checkout on sys.path."""
    import numpy as np
    import torch

    from endosurf_tpu_torch.evaluation.geometry3d import grid_axes, grid_slab
    from endosurf_tpu_torch.kernels import fused_render as fr
    from endosurf_tpu_torch.kernels import fused_sampler as fs
    from endosurf_tpu_torch.kernels import fused_sdf as fsd
    from endosurf_tpu_torch.kernels import fused_train as ft
    from endosurf_tpu_torch.kernels import fused_train_cuda as ftc
    from endosurf_tpu_torch.models import endosurf as es
    from endosurf_tpu_torch.models.fields import EndoSurfSpec, init_endosurf_params
    from endosurf_tpu_torch.ops.geometry import ray_sphere_intersection

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    spec = EndoSurfSpec()
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    n = 1024
    g = torch.Generator().manual_seed(1)
    o = torch.cat([torch.rand(n, 2, generator=g) * 0.6 - 0.3, torch.full((n, 1), -1.5)], -1)
    d = torch.rand(n, 3, generator=g) * 0.4 - 0.2 - o
    d = d / d.norm(dim=-1, keepdim=True)
    rays = torch.cat([o, d, torch.zeros(n, 2), torch.rand(n, 1, generator=g)], -1).to(dev)
    ro, rd, rdz, rt = es._split_rays(rays)
    near, far, _ = ray_sphere_intersection(ro, rd)
    z0 = es._stratified_z(near, far, 32, torch.rand(n, 1, generator=g).to(dev))
    x = grid_slab(grid_axes(np.full(3, -1.2), np.full(3, 1.2), 128), 0, 64, dev)
    t = torch.full((x.shape[0], 1), 0.5, device=dev)
    gp = torch.Generator().manual_seed(2)
    m = 65536
    px = (torch.rand(m, 3, generator=gp) * 1.6 - 0.8).to(dev)
    pd = torch.randn(m, 3, generator=gp)
    pd = (pd / pd.norm(dim=-1, keepdim=True)).to(dev)
    pt = torch.rand(m, 1, generator=gp).to(dev)
    out = {}
    for prec, dt in (("highest", torch.float32), ("default", torch.bfloat16)):
        maps = fr.fused_render_rays_cuda(spec, params, rays, 30000.0, 32, 32, 4, 50000.0, dt, dt)
        out[f"render {prec}"] = _sha(*(maps[k] for k in sorted(maps)))
        out[f"upsample {prec}"] = _sha(*fs.fused_upsample_z_cuda(spec, params, ro, rdz, rt, z0,
                                                                 32, 4, dt, True))
        march = fs.fused_ray_march_cuda(spec, params, ro, rdz, rt, near, far, sampling_dtype=dt)
        out[f"march {prec}"] = _sha(*(march[k] for k in sorted(march)))
        out[f"sdf query {prec}"] = _sha(fsd.fused_sdf_observed_cuda(spec, params, x, t, dt))
        with torch.no_grad():
            eff = ft.prepare_effective(spec, params)
            x_c, jrows = ft.seg_deform_math(spec, eff["deform"], torch.cat([px, pt], -1), prec)
            _, feat, grad_c = ft.seg_sdf_math(spec, eff["sdf"], eff["sdf_head"],
                                              eff["sdf_feat"], x_c, prec)
            _, d_c = ft.coupling_math(jrows, grad_c, pd)
        inputs = {"deform": (torch.cat([px, pt], -1),), "sdf": (x_c,),
                  "color": (x_c, grad_c, d_c, feat)}
        gc = torch.Generator(device=dev).manual_seed(3)
        for seg in ftc.SEGMENTS:
            like, flat = ft.segment_weights(eff, seg)
            packed = ftc.pack_segment(spec, seg, flat, like, prec)
            outs = ftc.FWD[seg](packed, *inputs[seg])
            out[f"{seg}_fwd {prec}"] = _sha(*outs)
            cots = tuple(torch.randn(*o.shape, generator=gc, device=dev) for o in outs)
            leaves, d_in = ftc.BWD[seg](packed, *inputs[seg], *cots)
            out[f"{seg}_bwd {prec}"] = _sha(*leaves, *d_in)
    torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=osp.dirname(osp.dirname(osp.abspath(__file__))))
    ap.add_argument("--other", default=None, help="a second checkout to compare with")
    ap.add_argument("--json", action="store_true", help="print one JSON object only")
    args = ap.parse_args()
    if args.other is None:
        sys.path.insert(0, osp.abspath(args.root))
        got = digests()
        if args.json:
            print(json.dumps(got))
            return 0
        import torch
        print(torch.cuda.get_device_name(0), args.root)
        for k, v in got.items():
            print(f"{k}: {v}")
        return 0
    res = {}
    for root in (args.root, args.other):
        proc = subprocess.run([sys.executable, osp.abspath(__file__), "--root", root, "--json"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"{root} failed:\n{proc.stdout}{proc.stderr[-4000:]}")
            return 1
        res[root] = json.loads(proc.stdout.strip().splitlines()[-1])
    a, b = res[args.root], res[args.other]
    diff = [k for k in a if a[k] != b.get(k)]
    for k in a:
        print(f"{k}: {a[k]} {'==' if k not in diff else '!='} {b.get(k)}")
    print(f"{len(a)} digests, {len(diff)} differ: {diff}")
    return 1 if diff else 0


if __name__ == "__main__":
    sys.exit(main())
