#!/usr/bin/env python
"""sha256 of the float32 EndoNeRF render's maps and of the float32 density
backward's outputs, to hold a checkout's float32 D-NeRF kernels against
another's bit for bit on one card.

The render: 1024 depth-guided rays (tests/test_torch_cuda.py's
``_dn_rays(1024, dev, True)``) with the full seeded D-NeRF nets (seed 0),
64 + 64 samples, float32 in both passes, through
``fused_render_rays_dnerf_cuda``: the digest of the three maps concatenated
(float32 bytes). The backward: ``dnerf_density_bwd`` on 65,531 points
(``_seg_points(65531, dev)``) with the full nets (seed 0), x_c from the
plain deform segment and seeded cotangents (a generator seeded 5 on the
card), float32: the digest of d x_c and the packed gradient. Run on the
checkout at ``--root`` (default: this one); prints both digests with the
card and nvcc's version. The card test ``test_dnerf_f32_is_the_simt_path``
holds the digests it prints. Needs a CUDA device:

    python tools/dnerf_f32_digest.py [--root CHECKOUT]
"""

from __future__ import annotations

import argparse
import hashlib
import os.path as osp
import subprocess
import sys


def digests(dev):
    """(render digest, backward digest) of the checkout on sys.path."""
    import torch
    from endosurf_tpu_torch.kernels import fused_render_dnerf as frd
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    from endosurf_tpu_torch.models import endonerf as en
    n = 1024
    g = torch.Generator().manual_seed(1)
    o = torch.cat([torch.rand(n, 2, generator=g) * 0.6 - 0.3, torch.full((n, 1), -1.5)], -1)
    d = torch.rand(n, 3, generator=g) * 0.4 - 0.2 - o
    d = d / d.norm(dim=-1, keepdim=True)
    rays = torch.cat([o, d, torch.zeros(n, 2), torch.rand(n, 1, generator=g)], -1)
    rays[:, 3:6] /= rays[:, 5:6]
    g = torch.Generator().manual_seed(101)
    rays[:, 6] = torch.rand(n, generator=g) * 0.3 + 1.3
    rays[:, 7] = 0.08
    rays = rays.to(dev)
    spec = en.DNeRFSpec()
    params = en.init_dnerf_params(spec, torch.Generator().manual_seed(0), dev)
    out = frd.fused_render_rays_dnerf_cuda(spec, en.DNeRFRenderSpec(), params, rays)
    render = torch.cat([out[k] for k in ("color_map", "depth_map", "acc_map")], -1)

    m = 65531
    g = torch.Generator().manual_seed(10)
    x = (torch.rand(m, 3, generator=g) * 1.6 - 0.8).to(dev)
    torch.randn(m, 3, generator=g)
    t = torch.rand(m, 1, generator=g).to(dev)
    eff = ftd.prepare_effective_dnerf(spec, params)
    with torch.no_grad():
        x_c = ftd.seg_deform_math(spec, eff["deform"], torch.cat([x, t], -1), "highest")
    gen = torch.Generator(device=dev).manual_seed(5)
    g_raw = torch.randn(m, 1, generator=gen, device=dev)
    g_feat = torch.randn(m, spec.geo_feat_dim, generator=gen, device=dev)
    packed = ftd.pack_dnerf(spec, params, torch.float32)
    like, _ = ftd.segment_weights(eff, "density")
    leaves, (d_xc,) = ftd.dnerf_density_bwd(packed, like, x_c, g_raw, g_feat)
    bwd = torch.cat([d_xc.reshape(-1)] + [v.reshape(-1) for v in leaves])
    return tuple(hashlib.sha256(v.detach().cpu().numpy().tobytes()).hexdigest()
                 for v in (render, bwd))


def main():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--root", default=osp.dirname(osp.dirname(osp.abspath(__file__))))
    args = parser.parse_args()
    sys.path.insert(0, osp.abspath(args.root))
    import torch
    from endosurf_tpu_torch.kernels import build
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    render, bwd = digests(torch.device("cuda"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    print(f"{osp.abspath(args.root)}: float32 dnerf render digest {render}; float32 density "
          f"backward digest {bwd} ({smi}; {nvcc})")


if __name__ == "__main__":
    main()
