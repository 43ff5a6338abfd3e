#!/usr/bin/env python
"""Where the bf16 D-NeRF density backward's weight gradients sit against
float64, leaf by leaf.

For the cells of tests/test_torch_cuda.py's
``test_dnerf_density_bwd_tensor_cores_no_farther_from_float64`` (the narrow,
full and full-static nets, 65,531 points, weight seeds 0 and 1, seeded
random cotangents) it prints, per weight leaf, the median and p99 of the
per-element error (|g - ref| over the rms of the leaf in ``ref``) against
the float64 yardstick (``fused_train_dnerf.dnerf_density_bwd_float64``) of
the tensor-core kernel and of the SIMT one (``simt=True``), marks the
leaves on which the tensor cores read farther, and then the whole set's
readings (``bwd_float64_distance``, what the card test judges).

Needs a CUDA device. CHECKOUT (default: the one holding this file) is the
tree whose package is imported, so that two trees can be compared in one
call:

    python tools/dnerf_wgrad_floor.py [CHECKOUT]
"""

from __future__ import annotations

import os.path as osp
import subprocess
import sys

RAGGED_N = 65531      # the card test's point count


def seg_points(n: int, dev, seed: int):
    """tests/test_torch_cuda.py's _seg_points."""
    import torch
    g = torch.Generator().manual_seed(10 + seed)
    x = torch.rand(n, 3, generator=g) * 1.6 - 0.8
    d = torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    return x.to(dev), d.to(dev), torch.rand(n, 1, generator=g).to(dev)


def quantiles(err):
    import torch
    q = torch.quantile(err, torch.tensor([0.5, 0.99], dtype=err.dtype, device=err.device))
    return float(q[0]), float(q[1])


def main():
    root = osp.abspath(sys.argv[1]) if len(sys.argv) > 1 else osp.dirname(
        osp.dirname(osp.abspath(__file__)))
    sys.path.insert(0, root)
    import torch
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    from endosurf_tpu_torch.models import endonerf as en
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{smi}; package {root}", flush=True)
    specs = {"narrow": en.DNeRFSpec(deform_layers=(3, 64, (1,)), density_layers=(3, 64, (1,)),
                                    color_layers=(2, 64, ()), geo_feat_dim=32),
             "full": en.DNeRFSpec(), "full-static": en.DNeRFSpec(use_deform=False)}
    for sid, spec in specs.items():
        for seed in (0, 1):
            params = en.init_dnerf_params(spec, torch.Generator().manual_seed(seed), dev)
            x, d, t = seg_points(RAGGED_N, dev, seed)
            packed, like, _, inputs, cots = ftd.bwd_segment_parity(
                spec, params, x, d, t, "default", seed)[2]["dnerf_density_bwd"]
            ref, (ref_dxc,) = ftd.dnerf_density_bwd_float64(spec, params, *inputs, *cots)
            got = {name: ftd.dnerf_density_bwd(packed, like, *inputs, *cots, simt=flag)
                   for name, flag in (("tensor cores", False), ("SIMT", True))}
            farther = []
            for i, leaf in enumerate(ftd.leaf_names(like, "density")):
                r = ref[i].double()
                rms = r.pow(2).mean().sqrt() + 1e-300
                q = {name: quantiles(((g[0][i].double() - r).abs() / rms).reshape(-1))
                     for name, g in got.items()}
                tc, simt = q["tensor cores"], q["SIMT"]
                far = tc[0] > simt[0] or tc[1] > simt[1]
                if far:
                    farther.append(leaf)
                print(f"{sid} seed {seed} {leaf} {tuple(r.shape)} (median, p99): tensor cores "
                      f"{tc[0]:.4e}, {tc[1]:.4e}; SIMT {simt[0]:.4e}, {simt[1]:.4e}"
                      + ("  FARTHER" if far else ""), flush=True)
            whole = {name: ftd.bwd_float64_distance(g[0], g[1][0], ref, ref_dxc)
                     for name, g in got.items()}
            print(f"{sid} seed {seed} all weights (median, p99): " + "; ".join(
                f"{name} {v['weights'][0]:.4e}, {v['weights'][1]:.4e}"
                for name, v in whole.items()) + f"; tensor cores farther on {farther}",
                flush=True)
            del packed, got, ref


if __name__ == "__main__":
    main()
