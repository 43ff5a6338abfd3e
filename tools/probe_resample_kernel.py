#!/usr/bin/env python
"""Device time of the EndoNeRF resample on one card.

The standalone ``fused_fine_resample_cuda`` at the train step's shape (2048
rays, 64 + 64, on ``dnerf_f32_digest.resample_inputs``: the full seeded
nets' float32 raw density plus unit noise) timed two ways: by torch.profiler
(the device kernels of a call, without the host time between them) and by
CUDA events around the Python call (which also hold the wrapper's host time:
the checks, ``torch.empty``, the ctypes call). Then one 2048-ray chunk of the
EndoNeRF render (``fused_render_rays_dnerf_cuda``, the full seeded nets,
depth-guided rays, 64 + 64) in the bf16 tensor-core mode (its resample stage
in double) and in the float32 mode, its device time by kernel family
(chip_smoke.py's ``DN_RENDER_FAMILIES``, whose timing helpers it uses) and
in all.

Runs the checkout at ``--root`` (default: this one) in this fresh process (a
long process's later torch.profiler traces can record no device events;
chip_smoke.py's phase 27 runs this script as a subprocess). To compare two
trees, run it on each in one chip call (parent, change, change, parent).
Prints one JSON line with the card's name and power limit. Needs a CUDA
device:

    python tools/probe_resample_kernel.py [--root CHECKOUT] [--reps N]
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import subprocess
import sys

HERE = osp.dirname(osp.abspath(__file__))


def by_family(kernels: dict) -> dict:
    """Device ms of a render chunk by chip_smoke.py's DN_RENDER_FAMILIES
    ("other" for the rest), in all, and the resample family's kernel names."""
    from chip_smoke import DN_RENDER_FAMILIES
    parts = {k: 0.0 for k in DN_RENDER_FAMILIES}
    parts["other"] = 0.0
    for key, ms in kernels.items():
        parts[next((f for f, names in DN_RENDER_FAMILIES.items()
                    if any(n in key for n in names)), "other")] += ms
    parts["total"] = sum(kernels.values())
    parts["resample kernels"] = sorted(
        k for k in kernels if any(n in k for n in DN_RENDER_FAMILIES["resample"]))
    return parts


def probe(reps: int) -> dict:
    import torch
    from chip_smoke import cuda_ms, kernel_device_ms
    from endosurf_tpu_torch.kernels import fused_render_dnerf as frd
    from endosurf_tpu_torch.kernels import fused_sampler as fs
    from endosurf_tpu_torch.models import endonerf as en
    sys.path.insert(0, HERE)
    from dnerf_f32_digest import dn_rays, resample_inputs
    dev = torch.device("cuda")
    spec = en.DNeRFSpec()
    params = en.init_dnerf_params(spec, torch.Generator().manual_seed(0), dev)
    z0, sigma, dn = resample_inputs(spec, params, dev)

    def call():
        return fs.fused_fine_resample_cuda(z0, sigma, dn, 64)
    kernels = kernel_device_ms(call, reps)
    out = {"standalone": {"rays": z0.shape[0], "n0": z0.shape[1], "n_new": 64,
                          "device_ms": sum(kernels.values()), "event_ms": cuda_ms(call, reps),
                          "kernels": kernels}}
    rays = dn_rays(2048, dev)
    rspec = en.DNeRFRenderSpec()
    bf = torch.bfloat16
    with torch.no_grad():
        for mode, dts in (("bf16", (bf, bf)), ("float32", (torch.float32, torch.float32))):
            kernels = kernel_device_ms(lambda: frd.fused_render_rays_dnerf_cuda(
                spec, rspec, params, rays, None, *dts), max(1, reps // 10))
            out[f"render chunk {mode}"] = {"rays": rays.shape[0], **by_family(kernels)}
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--root", default=osp.dirname(HERE))
    parser.add_argument("--reps", type=int, default=50)
    args = parser.parse_args()
    sys.path.insert(0, osp.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    out = probe(args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"root": osp.abspath(args.root), "card": smi, **out}), flush=True)


if __name__ == "__main__":
    main()
