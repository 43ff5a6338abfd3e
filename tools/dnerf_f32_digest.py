#!/usr/bin/env python
"""sha256 of the float32 EndoNeRF render's maps and of the float32 density
backward's, deform backward's, density forward's, deform forward's, raw
density query's, colour backward's and colour forward's outputs, to hold a
checkout's float32 D-NeRF kernels against another's bit for bit on one card.

The render: 1024 depth-guided rays (tests/test_torch_cuda.py's
``_dn_rays(1024, dev, True)``) with the full seeded D-NeRF nets (seed 0),
64 + 64 samples, float32 in both passes, through
``fused_render_rays_dnerf_cuda``: the digest of the three maps concatenated
(float32 bytes). The backward: ``dnerf_density_bwd`` on 65,531 points
(``_seg_points(65531, dev)``) with the full nets (seed 0), x_c from the
plain deform segment and seeded cotangents (a generator seeded 5 on the
card), float32: the digest of d x_c and the packed gradient. The deform
backward on the same points' xt with a cotangent on x_c drawn next from that
generator: the digest of its packed gradient. The density forward on the
same x_c: the digest of raw sigma and the feature. The deform forward on
the same xt: the digest of x_c. The raw density query
(``fused_density_raw_cuda``) on the same points: the digest of the raw
density. The colour backward on the same points' directions (the normal
draw after x) and the plain density segment's feature, with a cotangent on
rgb drawn next from the card's generator: the digest of d feat and the
packed gradient. The colour forward on the same directions and feature: the
digest of rgb. Run on the checkout at ``--root`` (default: this one); prints
the eight digests with the card and nvcc's version. The card test
``test_dnerf_f32_is_the_simt_path`` holds the digests it prints. Needs a
CUDA device:

    python tools/dnerf_f32_digest.py [--root CHECKOUT]
"""

from __future__ import annotations

import argparse
import hashlib
import os.path as osp
import subprocess
import sys


def digests(dev):
    """(render, density backward, deform backward, density forward, deform
    forward, raw density, colour backward, colour forward) digests of the
    checkout on sys.path."""
    import torch
    from endosurf_tpu_torch.kernels import fused_render_dnerf as frd
    from endosurf_tpu_torch.kernels import fused_sdf as fsd
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
    d = torch.randn(m, 3, generator=g).to(dev)
    t = torch.rand(m, 1, generator=g).to(dev)
    eff = ftd.prepare_effective_dnerf(spec, params)
    xt = torch.cat([x, t], -1)
    with torch.no_grad():
        x_c = ftd.seg_deform_math(spec, eff["deform"], xt, "highest")
    gen = torch.Generator(device=dev).manual_seed(5)
    g_raw = torch.randn(m, 1, generator=gen, device=dev)
    g_feat = torch.randn(m, spec.geo_feat_dim, generator=gen, device=dev)
    packed = ftd.pack_dnerf(spec, params, torch.float32)
    like, _ = ftd.segment_weights(eff, "density")
    leaves, (d_xc,) = ftd.dnerf_density_bwd(packed, like, x_c, g_raw, g_feat)
    bwd = torch.cat([d_xc.reshape(-1)] + [v.reshape(-1) for v in leaves])
    g_xc = torch.randn(m, 3, generator=gen, device=dev)
    like, _ = ftd.segment_weights(eff, "deform")
    leaves, _ = ftd.dnerf_deform_bwd(packed, like, xt, g_xc)
    deform_bwd = torch.cat([v.reshape(-1) for v in leaves])
    density_fwd = torch.cat(ftd.dnerf_density_fwd(packed, x_c), -1)
    deform_fwd = ftd.dnerf_deform_fwd(packed, xt)
    density_raw = fsd.fused_density_raw_cuda(spec, params, x, t)
    with torch.no_grad():
        _, feat = ftd.seg_density_math(spec, eff["density"], eff["sigma_head"], eff["geo_feat"],
                                       x_c, "highest")
    g_rgb = torch.randn(m, 3, generator=gen, device=dev)
    like, _ = ftd.segment_weights(eff, "color")
    leaves, (_, d_feat) = ftd.dnerf_color_bwd(packed, like, d, feat, g_rgb)
    color_bwd = torch.cat([d_feat.reshape(-1)] + [v.reshape(-1) for v in leaves])
    color_fwd = ftd.dnerf_color_fwd(packed, d, feat)
    return tuple(hashlib.sha256(v.detach().cpu().numpy().tobytes()).hexdigest()
                 for v in (render, bwd, deform_bwd, density_fwd, deform_fwd, density_raw,
                           color_bwd, color_fwd))


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
    (render, bwd, deform_bwd, density_fwd, deform_fwd, density_raw, color_bwd,
     color_fwd) = digests(torch.device("cuda"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    print(f"{osp.abspath(args.root)}: float32 dnerf render digest {render}; float32 density "
          f"backward digest {bwd}; float32 deform backward digest {deform_bwd}; float32 "
          f"density forward digest {density_fwd}; float32 deform forward digest "
          f"{deform_fwd}; float32 raw density digest {density_raw}; float32 colour backward "
          f"digest {color_bwd}; float32 colour forward digest {color_fwd} ({smi}; {nvcc})")


if __name__ == "__main__":
    main()
