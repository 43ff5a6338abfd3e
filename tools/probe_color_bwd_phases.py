#!/usr/bin/env python
"""Where the bf16 D-NeRF colour backward's time goes, phase by phase.

Builds copies of ``csrc/`` in which ``dnerf_color_bwd_tc_kernel`` stops
after a phase (the forward recompute; the output layer and the rank-3 dot;
d feat computed but not stored; the direction encoding left out), each into
a library of its own, and times ``fused_train_dnerf.dnerf_color_bwd`` with
each at the EndoNeRF train step's 262,144 points (base.yml's nets, seed 0;
CUDA events, and the call's kernels by torch.profiler), two rounds, beside
the SIMT kernel. A phase's cost is the difference of two variants' calls.
Needs a CUDA device and nvcc; the builds take a few minutes:

    python tools/probe_color_bwd_phases.py
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CU = "fused_train_dnerf.cu"
# variant -> edits (old, new) of csrc/fused_train_dnerf.cu
VARIANTS = {
    "full": [],
    "recompute": [("  // ---- the output layer and the sigmoid in double (the render field\n",
                   "  if (n > 0) return;\n"
                   "  // ---- the output layer and the sigmoid in double (the render field\n")],
    "to_walk": [("  // ---- the hidden layers L-2 .. 1 through W^T (the h rows); each layer's\n",
                 "  if (n > 0) return;\n"
                 "  // ---- the hidden layers L-2 .. 1 through W^T (the h rows); each layer's\n")],
    "no_dfeat_store": [("      if (c >= cr && c < cr + F) o[c - cr] = bf16r(a0);",
                        "      if (a0 == 1234.5f && c >= cr && c < cr + F) o[c - cr] = bf16r(a0);"),
                       ("      if (c + 1 >= cr && c + 1 < cr + F) o[c + 1 - cr] = bf16r(a1);",
                        "      if (a1 == 1234.5f && c + 1 >= cr && c + 1 < cr + F) "
                        "o[c + 1 - cr] = bf16r(a1);")],
    "no_encode": [("  dt_encode<true>(s.d, m.f_cdir, s.E, cr, tid);\n"
                   "  for (int idx = tid; idx < DT_P * F; idx += NT) {",
                   "  for (int idx = tid; idx < DT_P * F; idx += NT) {")],
}


def build_variants(work: str) -> dict:
    """Each variant's library path, built in parallel."""
    sys.path.insert(0, str(ROOT))
    from endosurf_tpu_torch.kernels import build
    procs = {}
    for name, edits in VARIANTS.items():
        src = os.path.join(work, name, "csrc")
        shutil.copytree(build.CSRC, src)
        path = os.path.join(src, CU)
        text = open(path).read()
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        open(path, "w").write(text)
        code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); from pathlib import Path; "
                f"from endosurf_tpu_torch.kernels import build; build.CSRC = Path({src!r}); "
                f"build.BUILD_DIR = Path({os.path.join(work, name, '_build')!r}); "
                f"print(build.build_library())")
        procs[name] = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: {out[-3000:]}")
        libs[name] = out.strip().splitlines()[-1]
    return libs


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from endosurf_tpu_torch.kernels import build
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    from endosurf_tpu_torch.models import endonerf as en
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(dir=build.BUILD_DIR, prefix="probe")
    try:
        t0 = time.time()
        libs = build_variants(work)
        print(f"variant builds {time.time() - t0:.1f} s", flush=True)
        dev = torch.device("cuda")
        spec = en.DNeRFSpec()
        params = en.init_dnerf_params(spec, torch.Generator().manual_seed(0), dev)
        n = 262144
        g = torch.Generator().manual_seed(3)
        x = (torch.rand(n, 3, generator=g) * 1.6 - 0.8).to(dev)
        d = torch.randn(n, 3, generator=g).to(dev)
        t = torch.rand(n, 1, generator=g).to(dev)
        main_lib = build.load_library()
        _, _, cases = ftd.bwd_segment_parity(spec, params, x, d, t, "default", 0)
        packed, like, _, inputs, cots = cases["dnerf_color_bwd"]

        def call(simt=False):
            return ftd.dnerf_color_bwd(packed, like, *inputs, *cots, simt=simt)

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

        class Variant:
            """The main library with the colour backward's entry of another."""
            def __init__(self, path):
                self.lib = ctypes.CDLL(path)
                fn, ref = self.lib.dnerf_color_bwd, main_lib.dnerf_color_bwd
                fn.argtypes, fn.restype = ref.argtypes, ref.restype

            def __getattr__(self, k):
                return getattr(self.lib if k == "dnerf_color_bwd" else main_lib, k)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout
        print(smi.strip(), flush=True)
        for rnd in range(2):
            for name, path in libs.items():
                build._LIB = Variant(path)
                ms = ev_ms(call)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        call()
                    torch.cuda.synchronize()
                kern = sorted(((e.device_time_total / 5e3,
                                e.key.replace("(anonymous namespace)::", "")
                                .replace("void ", "").split("(")[0])
                               for e in prof.key_averages()
                               if e.device_type == DeviceType.CUDA), reverse=True)
                print(f"[{rnd}] {name}: call {ms:.3f} ms; kernels " + "; ".join(
                    f"{k} {v:.3f}" for v, k in kern), flush=True)
                build._LIB = main_lib
        print(f"SIMT bf16 call {ev_ms(lambda: call(True)):.3f} ms", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
