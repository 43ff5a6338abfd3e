#!/usr/bin/env python
"""sha256 of the float32 render's maps, to hold a checkout's float32 render
against another's bit for bit on one card.

Renders 1024 rays (tests/test_torch_cuda.py's ``_rays(1024)``) with the full
seeded net (seed 0) at step 30000, 32 + 32 samples, 4 rounds, anneal end
50000, float32 in both passes, through ``fused_render_rays_cuda`` of the
checkout at ``--root`` (default: this one), and prints the digest of the five
maps concatenated (float32 bytes) with the card and nvcc's version. The card
test ``test_render_f32_is_the_simt_render`` holds the digest it prints. Needs
a CUDA device:

    python tools/render_f32_digest.py [--root CHECKOUT]
"""

from __future__ import annotations

import argparse
import hashlib
import os.path as osp
import subprocess
import sys

MAPS = ("color_map", "depth_map", "normal_map", "acc_map", "weight_max")


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
    n = 1024
    g = torch.Generator().manual_seed(1)
    o = torch.cat([torch.rand(n, 2, generator=g) * 0.6 - 0.3, torch.full((n, 1), -1.5)], -1)
    d = torch.rand(n, 3, generator=g) * 0.4 - 0.2 - o
    d = d / d.norm(dim=-1, keepdim=True)
    rays = torch.cat([o, d, torch.zeros(n, 2), torch.rand(n, 1, generator=g)], -1).to(dev)
    spec = EndoSurfSpec()
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    out = fr.fused_render_rays_cuda(spec, params, rays, 30000.0, 32, 32, 4, 50000.0)
    cat = torch.cat([out[k] for k in MAPS], -1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    print(f"{osp.abspath(args.root)}: float32 render digest "
          f"{hashlib.sha256(cat.cpu().numpy().tobytes()).hexdigest()} ({smi}; {nvcc})")


if __name__ == "__main__":
    main()
