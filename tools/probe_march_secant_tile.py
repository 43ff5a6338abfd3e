#!/usr/bin/env python
"""Whether the bf16 ray march's secant phase gains from its 16-point sweep
tile (64 blocks for its 1,024-point sweeps, where the scan's 32-point tile
gives 32 on 132 SMs).

Builds copies of ``csrc/`` whose march runs its secant sweeps in 32-point
tiles (``sweep_rays_tc<2>``, the scan's) and whose every tensor-core sweep
takes 16 points (``SW_MT`` 1, the scan's too), each into a library of its
own, and times ``fused_sampler.fused_ray_march_cuda`` (bf16, 1024 rays,
base.yml's nets, seed 0; CUDA events) with 8 secant steps and with none,
with those libraries and with this checkout's, three rounds: the secant
phase is the difference; each variant's march must equal this checkout's
bit for bit. Needs a CUDA device and nvcc; the builds take a minute or two:

    python tools/probe_march_secant_tile.py
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
from probe_color_bwd_phases import build_variants  # noqa: E402

VARIANTS = {"32-point secant tile": ("fused_sampler.cu", "sweep_rays_tc<1>(", "sweep_rays_tc<2>("),
            "16-point tiles everywhere": ("sweep_tc.cuh", "#define SW_MT 2 ",
                                          "#define SW_MT 1 ")}


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from endosurf_tpu_torch.kernels import build
    from endosurf_tpu_torch.kernels import fused_sampler as fs
    from endosurf_tpu_torch.models.fields import EndoSurfSpec, init_endosurf_params
    from endosurf_tpu_torch.models.endosurf import _split_rays
    from endosurf_tpu_torch.ops.geometry import ray_sphere_intersection
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(dir=build.BUILD_DIR, prefix="probe")
    try:
        libs = {}
        for name, (cu, old, new) in VARIANTS.items():   # one file each: one build each
            libs.update(build_variants(work, {name: [(old, new)]}, cu))
        dev = torch.device("cuda")
        spec = EndoSurfSpec()
        params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
        n = 1024
        g = torch.Generator().manual_seed(2)
        o = torch.cat([torch.rand(n, 2, generator=g) * 0.6 - 0.3, torch.full((n, 1), -1.5)], -1)
        v = torch.rand(n, 3, generator=g) * 0.4 - 0.2 - o
        v = v / v.norm(dim=-1, keepdim=True)
        rays = torch.cat([o, v, torch.zeros(n, 2), torch.rand(n, 1, generator=g)], -1).to(dev)
        ro, rd, rdz, t = _split_rays(rays)
        near, far, _ = ray_sphere_intersection(ro, rd)
        ins = (ro, rdz, t, near, far)
        main_lib = build.load_library()

        class Variant:
            """The main library with the march's entry of another."""
            def __init__(self, path):
                self.lib = ctypes.CDLL(path)
                fn, ref = self.lib.fused_ray_march_launch, main_lib.fused_ray_march_launch
                fn.argtypes, fn.restype = ref.argtypes, ref.restype

            def __getattr__(self, k):
                return getattr(self.lib if k == "fused_ray_march_launch" else main_lib, k)

        def ev_ms(fn, reps=10):
            fn()
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b) / reps
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout
        print(smi.strip(), flush=True)
        variants = {"16-point secant tile (this checkout)": main_lib,
                    **{k: Variant(v) for k, v in libs.items()}}
        outs = {}
        for rnd in range(3):
            for name, lib in variants.items():
                build._LIB = lib
                outs[name] = fs.fused_ray_march_cuda(spec, params, *ins,
                                                     sampling_dtype=torch.bfloat16)
                whole, scan = (ev_ms(lambda k=k: fs.fused_ray_march_cuda(
                    spec, params, *ins, n_secant=k, sampling_dtype=torch.bfloat16))
                    for k in (8, 0))
                print(f"[{rnd}] {name}: march {whole:.3f} ms, scan {scan:.3f} ms, secant phase "
                      f"{whole - scan:.3f} ms", flush=True)
            build._LIB = main_lib
            ref = next(iter(outs.values()))
            print(f"[{rnd}] marches equal bit for bit: " + ", ".join(
                f"{k} {all(torch.equal(v[x], ref[x]) for x in ref)}" for k, v in outs.items()),
                flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
