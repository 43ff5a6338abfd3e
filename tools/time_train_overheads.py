#!/usr/bin/env python
"""What the bf16 upsample's pack and the tensor-core SDF forward's workspace
cost the EndoSurf train step, on one CUDA card:

    python tools/time_train_overheads.py

1. pack_operands (the float32 layout) and pack_sampling (the same plus the
   hidden layers' bf16 mma fragments) on base.yml's seeded nets: each call's
   time by CUDA events, its host time, and its device time (torch.profiler);
2. the SDF forward's workspace (each hidden layer's pre-activations) at a
   train batch's 65,536 midpoints: its size, the host time of its
   torch.empty, and the forward (ftc.sdf_fwd, bf16) by CUDA events as built,
   then from a copy of csrc/ whose SDF forward neither writes nor reads the
   workspace (its gates read sigma(0): a timing probe, its grad_c is wrong).

Prints one line per reading, each with the card's name and power limit.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# the workspace's write and its two reads in csrc/field_tc.cuh's sdf_tc_forward
NO_WORKSPACE = [
    ("      if (base + row < n) *(float2*)(sv.z[l] + (size_t)(base + row) * out_l + c) = "
     "make_float2(z0, z1);\n", "\n"),
    ("sigmoidf_(100.f * sv.z[l - 1][(size_t)(base + p) * n_in + i])", "sigmoidf_(0.f)"),
    ("o = v[e] * sigmoidf_(100.f * sv.z[l - 1][q]);", "o = v[e] * sigmoidf_(0.f);"),
]


def host_ms(fn, reps: int) -> float:
    """Mean host milliseconds a call, the device synchronised before and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def main() -> int:
    from endosurf_tpu_torch.data.scene_data import make_synthetic_arrays
    from endosurf_tpu_torch.kernels import build
    from endosurf_tpu_torch.kernels import fused_render as fr
    from endosurf_tpu_torch.kernels import fused_sampler as fs
    from endosurf_tpu_torch.kernels import fused_train as ft
    from endosurf_tpu_torch.kernels import fused_train_cuda as ftc
    from endosurf_tpu_torch.models.endosurf import RenderSpec
    from endosurf_tpu_torch.models.fields import EndoSurfSpec, init_endosurf_params

    if not torch.cuda.is_available():
        print("time_train_overheads: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    build.load_library()
    cfg = cs.base_cfg()
    spec, rspec = EndoSurfSpec.from_config(cfg["net"]), RenderSpec.from_config(cfg["render"])
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    bf = torch.bfloat16

    for name, fn in (("pack_operands", lambda: fr.pack_operands(spec, params, bf)),
                     ("pack_sampling", lambda: fs.pack_sampling(spec, params, bf))):
        ev, host = cs.cuda_ms(fn, 20), host_ms(fn, 20)
        dev_ms = sum(cs.kernel_device_ms(fn, 20).values())
        print(f"{name} (bf16, {smi}): {ev:.4f} ms a call (CUDA events), host {host:.4f} ms, "
              f"device {dev_ms:.4f} ms", flush=True)

    scene = make_synthetic_arrays(n_frames=4, h=cs.H, w=cs.W, seed=0, device=dev)
    x, _, t = cs.train_midpoints(spec, rspec, params, scene.device_arrays,
                                 torch.Generator(device=dev).manual_seed(3), dev)
    with torch.no_grad():
        eff = ft.prepare_effective(spec, params)
        x_c, _ = ft.seg_deform_math(spec, eff["deform"], torch.cat([x, t], -1), "default")
        like, flat = ft.segment_weights(eff, "sdf")
        packed = ftc.pack_segment(spec, "sdf", flat, like, "default")
    n = x_c.shape[0]
    floats = ftc.fwd_work_floats(packed, n)
    alloc = host_ms(lambda: torch.empty(floats, dtype=torch.float32, device=dev), 50)
    with_ws = cs.cuda_ms(lambda: ftc.sdf_fwd(packed, x_c), 10)
    print(f"sdf_fwd workspace ({n} points, {smi}): {floats * 4 / 2 ** 30:.3f} GiB, torch.empty "
          f"{alloc * 1e3:.1f} us a call (host); sdf_fwd {with_ws:.4f} ms", flush=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        src = os.path.join(tmp, "csrc")
        shutil.copytree(build.CSRC, src)
        path = os.path.join(src, "field_tc.cuh")
        text = open(path).read()
        for old, new in NO_WORKSPACE:
            assert text.count(old) == 1, old
            text = text.replace(old, new)
        open(path, "w").write(text)
        build.CSRC, build.BUILD_DIR, build._LIB = Path(src), Path(tmp) / "_build", None
        build.load_library()
        without = cs.cuda_ms(lambda: ftc.sdf_fwd(packed, x_c), 10)
    print(f"sdf_fwd without the workspace's write and reads ({n} points, {smi}): {without:.4f} ms "
          f"(as built {with_ws:.4f} ms)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
