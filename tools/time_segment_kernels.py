#!/usr/bin/env python
"""Device ms of the six EndoSurf segment kernels of one checkout, bf16 on
base.yml's nets (seed 0), at 65,536 seeded points with the plain chain's
inputs and seeded cotangents (``fused_train_cuda.segment_parity``'s cases),
each call timed by CUDA events after two warm-up calls:

    python tools/time_segment_kernels.py [--root CHECKOUT] [--reps N]

Prints one line per kernel, the median and the least of N calls. To compare
two checkouts on one card, run them one after the other in the order
parent, change, change, parent, each in a process of its own. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=osp.dirname(osp.dirname(osp.abspath(__file__))))
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    sys.path.insert(0, osp.abspath(args.root))
    import torch

    from endosurf_tpu_torch.kernels import build
    from endosurf_tpu_torch.kernels import fused_train_cuda as ftc
    from endosurf_tpu_torch.models.fields import EndoSurfSpec, init_endosurf_params
    build.load_library()
    dev = torch.device("cuda")
    spec = EndoSurfSpec()
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    n = 65536
    x = (torch.rand(n, 3, generator=gen, device=dev) * 2 - 1) * 0.8
    d = torch.randn(n, 3, generator=gen, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    t = torch.rand(n, 1, generator=gen, device=dev)
    _, _, cases = ftc.segment_parity(spec, params, x, d, t, "default", 0)
    calls = {}
    for seg, (like, flat, packed, inputs, cots) in cases.items():
        calls[f"{seg}_fwd"] = lambda seg=seg, p=packed, i=inputs: ftc.FWD[seg](p, *i)
        calls[f"{seg}_bwd"] = lambda seg=seg, p=packed, i=inputs, c=cots: ftc.BWD[seg](p, *i, *c)
    for name, fn in calls.items():
        for _ in range(2):
            fn()
        times = []
        for _ in range(args.reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        print(f"{osp.abspath(args.root)}: {name} median {times[len(times) // 2]:.3f} ms, "
              f"least {times[0]:.3f} ms ({args.reps} calls, {torch.cuda.get_device_name(0)})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
