#!/usr/bin/env python
"""sha256 of the float32 render's maps and of the float32 observed-SDF
query's and ray march's outputs, to hold a checkout's float32 render, grid
query and march against another's bit for bit on one card.

Renders 1024 rays (tests/test_torch_cuda.py's ``_rays(1024)``) with the full
seeded net (seed 0) at step 30000, 32 + 32 samples, 4 rounds, anneal end
50000, float32 in both passes, through ``fused_render_rays_cuda`` of the
checkout at ``--root`` (default: this one): the digest of the five maps
concatenated (float32 bytes). Queries the same net's SDF with
``fused_sdf_observed_cuda`` in float32 on a 1,048,576-point grid slab (the
first 64 x-planes of a 128^3 grid over [-1.2, 1.2]^3, as the demo builds
them, at t = 0.5): the digest of the SDF. Marches the same rays through the
same net with ``fused_ray_march_cuda`` in float32 (128 steps, 8 secant
steps, tau 0): the digest of depth, valid, d_low, d_high and idx. Prints the
three with the card and nvcc's version. The card test
``test_render_f32_is_the_simt_render`` holds the digests it prints. Needs a
CUDA device:

    python tools/render_f32_digest.py [--root CHECKOUT]
"""

from __future__ import annotations

import argparse
import hashlib
import os.path as osp
import subprocess
import sys

MAPS = ("color_map", "depth_map", "normal_map", "acc_map", "weight_max")


def sdf_query_digest(dev) -> str:
    """The float32 observed-SDF query's digest on the grid slab, of the
    checkout on sys.path."""
    import hashlib

    import numpy as np
    import torch
    from endosurf_tpu_torch.evaluation.geometry3d import grid_axes, grid_slab
    from endosurf_tpu_torch.kernels import fused_sdf as fsd
    from endosurf_tpu_torch.models.fields import EndoSurfSpec, init_endosurf_params
    spec = EndoSurfSpec()
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    x = grid_slab(grid_axes(np.full(3, -1.2), np.full(3, 1.2), 128), 0, 64, dev)
    t = torch.full((x.shape[0], 1), 0.5, device=dev)
    sdf = fsd.fused_sdf_observed_cuda(spec, params, x, t, torch.float32)
    return hashlib.sha256(sdf.cpu().numpy().tobytes()).hexdigest()


def digest_rays(dev):
    """The 1024 rays [n, 9] the render and the march take."""
    import torch
    n = 1024
    g = torch.Generator().manual_seed(1)
    o = torch.cat([torch.rand(n, 2, generator=g) * 0.6 - 0.3, torch.full((n, 1), -1.5)], -1)
    d = torch.rand(n, 3, generator=g) * 0.4 - 0.2 - o
    d = d / d.norm(dim=-1, keepdim=True)
    return torch.cat([o, d, torch.zeros(n, 2), torch.rand(n, 1, generator=g)], -1).to(dev)


def march_digest(dev) -> str:
    """The float32 ray march's digest on digest_rays, of the checkout on
    sys.path."""
    import torch
    from endosurf_tpu_torch.kernels import fused_sampler as fs
    from endosurf_tpu_torch.models.endosurf import _split_rays
    from endosurf_tpu_torch.models.fields import EndoSurfSpec, init_endosurf_params
    from endosurf_tpu_torch.ops.geometry import ray_sphere_intersection
    spec = EndoSurfSpec()
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    o, d, d_z, t = _split_rays(digest_rays(dev))
    near, far, _ = ray_sphere_intersection(o, d)
    out = fs.fused_ray_march_cuda(spec, params, o, d_z, t, near, far)
    cat = torch.cat([out["depth"], out["valid"].float(), out["d_low"][:, None],
                     out["d_high"][:, None], out["idx"][:, None].float()], -1)
    return hashlib.sha256(cat.cpu().numpy().tobytes()).hexdigest()


def main():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--root", default=osp.dirname(osp.dirname(osp.abspath(__file__))))
    args = parser.parse_args()
    sys.path.insert(0, osp.abspath(args.root))
    import torch
    from endosurf_tpu_torch.kernels import build
    from endosurf_tpu_torch.kernels import fused_render as fr
    from endosurf_tpu_torch.models.fields import EndoSurfSpec, init_endosurf_params
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    rays = digest_rays(dev)
    spec = EndoSurfSpec()
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    out = fr.fused_render_rays_cuda(spec, params, rays, 30000.0, 32, 32, 4, 50000.0)
    cat = torch.cat([out[k] for k in MAPS], -1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    print(f"{osp.abspath(args.root)}: float32 render digest "
          f"{hashlib.sha256(cat.cpu().numpy().tobytes()).hexdigest()}; float32 sdf query digest "
          f"{sdf_query_digest(dev)}; float32 march digest {march_digest(dev)} ({smi}; {nvcc})")


if __name__ == "__main__":
    main()
