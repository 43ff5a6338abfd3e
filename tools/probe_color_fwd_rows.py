#!/usr/bin/env python
"""Whether the bf16 D-NeRF colour forward gains from splitting its 128-wide
layers by rows (``dt_hidden``'s HALVES: the four warps that own no columns
of a 128-wide layer take half of the tile's rows).

Builds a copy of ``csrc/`` whose ``dnerf_color_fwd_tc_kernel`` runs
``dt_hidden`` without HALVES, into a library of its own, and times
``fused_train_dnerf.dnerf_color_fwd`` with it and with this checkout's
library at the EndoNeRF train step's 262,144 points and at 65,536
(base.yml's nets, seed 0; a normal draw of the feature; CUDA events), three
rounds, beside the SIMT kernel; the two libraries' rgb must be equal bit for
bit. Needs a CUDA device and nvcc; the build takes a minute or two:

    python tools/probe_color_fwd_rows.py
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

VARIANTS = {"whole rows": [(
    "  dt_hidden<false, true>(C, wts, fr.color, s.H, ldh, s.E, cr, ring, 0, 0, nullptr, nullptr);",
    "  dt_hidden<false, false>(C, wts, fr.color, s.H, ldh, s.E, cr, ring, 0, 0, nullptr, "
    "nullptr);")]}


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from endosurf_tpu_torch.kernels import build
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    from endosurf_tpu_torch.models import endonerf as en
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(dir=build.BUILD_DIR, prefix="probe")
    try:
        libs = build_variants(work, VARIANTS, "fused_train_dnerf.cu")
        dev = torch.device("cuda")
        spec = en.DNeRFSpec()
        params = en.init_dnerf_params(spec, torch.Generator().manual_seed(0), dev)
        packed = ftd.pack_dnerf(spec, params, torch.bfloat16)
        g = torch.Generator().manual_seed(3)
        d = torch.randn(262144, 3, generator=g)
        d = (d / d.norm(dim=-1, keepdim=True)).to(dev)
        feat = torch.randn(262144, spec.geo_feat_dim, generator=g).to(dev)
        main_lib = build.load_library()

        class Variant:
            """The main library with the colour forward's entry of another."""
            def __init__(self, path):
                self.lib = ctypes.CDLL(path)
                fn, ref = self.lib.dnerf_color_fwd, main_lib.dnerf_color_fwd
                fn.argtypes, fn.restype = ref.argtypes, ref.restype

            def __getattr__(self, k):
                return getattr(self.lib if k == "dnerf_color_fwd" else main_lib, k)

        def ev_ms(fn, reps=20):
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
        variants = {"split rows (this checkout)": main_lib,
                    **{k: Variant(v) for k, v in libs.items()}}
        rgb = {}
        for rnd in range(3):
            for n in (262144, 65536):
                for name, lib in variants.items():
                    build._LIB = lib
                    rgb[name] = ftd.dnerf_color_fwd(packed, d[:n], feat[:n])
                    ms = ev_ms(lambda: ftd.dnerf_color_fwd(packed, d[:n], feat[:n]))
                    print(f"[{rnd}] {n} points, {name}: {ms:.4f} ms", flush=True)
                build._LIB = main_lib
                ms = ev_ms(lambda: ftd.dnerf_color_fwd(packed, d[:n], feat[:n], simt=True))
                print(f"[{rnd}] {n} points, SIMT bf16: {ms:.4f} ms", flush=True)
                a, b = rgb.values()
                print(f"[{rnd}] {n} points: rgb equal bit for bit: {torch.equal(a, b)}",
                      flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
