#!/usr/bin/env python
"""Where the bf16 D-NeRF kernels tip a bf16 rounding, against float64.

Part "field": for the narrow and full D-NeRF nets, weight seeds 0-2, 5000
and 65,536 points (tests/test_torch_cuda.py's _seg_points), the bf16 field
(``models.endonerf.field_eval``) against the plain field
(``fused_train_dnerf.forward_math``): rgb median / p99 / max, how many points
round x_c to bf16 apart from the float64 deform
(``dnerf_deform_fwd_float64``) for the tensor-core deform forward, the plain
deform and the SIMT kernel (``simt=True``), how many points
``test_dnerf_field_runs_the_segment_kernels``'s rule excuses and the max
elsewhere, and for each point over 1e-3 which side tipped.

Part "density": the bf16 raw density query (``fused_sdf.fused_density_raw_cuda``)
against its plain version on the card tests' cells (1000, 65,537 and
1,048,576 random points; full, full-static and narrow nets; seeds 0 and 1):
median / p99 / max, the max as a share of the reference's largest |raw|
(what ``DENSITY_PARITY_TOL``'s bf16 max limits), each side's max against
the float64 yardstick; then the same with two planted sparse faults built
into both sweeps: the last partial tile written as 0, and one point in each
tile written as 0.

Needs a CUDA device and nvcc (the faults build their own library):

    python tools/dnerf_tip_probe.py [field] [density]
"""

from __future__ import annotations

import os.path as osp
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import torch  # noqa: E402

from endosurf_tpu_torch.kernels import build  # noqa: E402
from endosurf_tpu_torch.kernels import fused_sdf as fsd  # noqa: E402
from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd  # noqa: E402
from endosurf_tpu_torch.models import endonerf as en  # noqa: E402

BF = torch.bfloat16
NARROW = en.DNeRFSpec(deform_layers=(3, 64, (1,)), density_layers=(3, 64, (1,)),
                      color_layers=(2, 64, ()), geo_feat_dim=32)
NETS = {"narrow": NARROW, "full": en.DNeRFSpec(),
        "full-static": en.DNeRFSpec(use_deform=False)}
FAULTS = {   # (file, old, new) edits of csrc/, as the card test plants them
    "tail_tile_zeroed": [
        ("sdf_chain.cuh", "    if (i < src.n) src.store(i, a + wts[N.b_off[l]]);",
         "    if (i < src.n) src.store(i, base + P_SWEEP > src.n ? 0.f : a + wts[N.b_off[l]]);"),
        ("dnerf_tc.cuh",
         "  if (tid < DT_P && base + tid < src.n) src.store(base + tid, s.out[tid * 4]);",
         "  if (tid < DT_P && base + tid < src.n)\n"
         "    src.store(base + tid, base + DT_P > src.n ? 0.f : s.out[tid * 4]);")],
    "one_point_a_tile_zeroed": [
        ("sdf_chain.cuh", "    if (i < src.n) src.store(i, a + wts[N.b_off[l]]);",
         "    if (i < src.n) src.store(i, tid == 0 ? 0.f : a + wts[N.b_off[l]]);"),
        ("dnerf_tc.cuh",
         "  if (tid < DT_P && base + tid < src.n) src.store(base + tid, s.out[tid * 4]);",
         "  if (tid < DT_P && base + tid < src.n)\n"
         "    src.store(base + tid, tid == 0 ? 0.f : s.out[tid * 4]);")],
}


def params_of(spec, seed: int, dev):
    return en.init_dnerf_params(spec, torch.Generator().manual_seed(seed), dev)


def seg_points(n: int, dev, seed: int):
    """tests/test_torch_cuda.py's _seg_points."""
    g = torch.Generator().manual_seed(10 + seed)
    x = torch.rand(n, 3, generator=g) * 1.6 - 0.8
    d = torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    return x.to(dev), d.to(dev), torch.rand(n, 1, generator=g).to(dev)


def sdf_points(n: int, dev, seed: int):
    """tests/test_torch_cuda.py's _sdf_points."""
    g = torch.Generator().manual_seed(seed)
    return ((torch.rand(n, 3, generator=g) * 2.4 - 1.2).to(dev),
            torch.rand(n, 1, generator=g).to(dev))


def field(dev) -> None:
    for sid in ("narrow", "full"):
        spec = NETS[sid]
        for seed in (0, 1, 2):
            for n in (5000, 65536):
                params = params_of(spec, seed, dev)
                x, d, t = seg_points(n, dev, seed)
                xt = torch.cat([x, t], -1)
                packed = ftd.pack_dnerf(spec, params, BF)
                with torch.no_grad():
                    rgb, _ = en.field_eval(spec, params, x, d, t, precision="default")
                    eff = ftd.prepare_effective_dnerf(spec, params)
                    ref = ftd.forward_math(spec, eff, x, t, d, "default")["rgb"]
                    xc = {"tensor cores": ftd.dnerf_deform_fwd(packed, xt),
                          "plain": ftd.seg_deform_math(spec, eff["deform"], xt, "default"),
                          "SIMT": ftd.dnerf_deform_fwd(packed, xt, simt=True)}
                    f64 = ftd.dnerf_deform_fwd_float64(spec, params, xt)
                off = {k: (v.double() - f64).abs().amax(-1) for k, v in xc.items()}
                apart = {k: int((v.to(BF) != f64.to(BF)).any(-1).sum()) for k, v in xc.items()}
                err = (rgb - ref).abs().amax(-1)
                q = torch.quantile(err, torch.tensor([0.5, 0.99], device=dev)).tolist()
                excused = ((xc["tensor cores"].to(BF) != xc["plain"].to(BF)).any(-1)
                           & (torch.maximum(off["tensor cores"], off["plain"]) > 1e-6))
                print(f"field {sid} seed {seed} {n} points: rgb median {q[0]:.3e} p99 "
                      f"{q[1]:.3e} max {float(err.max()):.3e}; x_c rounds apart from float64 "
                      f"on " + ", ".join(f"{k} {v}" for k, v in apart.items())
                      + f"; excused {int(excused.sum())}, max elsewhere "
                      f"{float(err[~excused].max()):.3e}", flush=True)
                for i in torch.nonzero(err > 1e-3).reshape(-1).tolist():
                    print(f"  point {i}: rgb {float(err[i]):.3e}, excused {bool(excused[i])}, "
                          "|x_c - float64| " + ", ".join(f"{k} {float(v[i]):.3e}"
                                                         for k, v in off.items()), flush=True)


CELLS = [("full", 1000), ("full", 65537), ("narrow", 65537), ("full-static", 65537),
         ("narrow", 1000), ("full", 1048576), ("narrow", 1048576)]


def density(dev, tag: str) -> None:
    for sid, n in CELLS:
        spec = NETS[sid]
        for seed in (0, 1):
            params = params_of(spec, seed, dev)
            x, t = sdf_points(n, dev, seed)
            got = fsd.fused_density_raw_cuda(spec, params, x, t, BF)
            ref = fsd.fused_density_raw_reference(spec, params, x, t, BF)
            f64 = fsd.fused_density_raw_float64(spec, params, x, t)
            med, p99, mx, ok = fsd.parity_errors(got, ref, BF, fsd.DENSITY_PARITY_TOL)
            scale = float(ref.abs().max())
            print(f"density {tag} {sid} {n} points seed {seed}: median {med:.3e} p99 {p99:.3e} "
                  f"max {mx:.3e} = {mx / scale:.3f} of max|raw| {scale:.3e}, within limits {ok}; "
                  f"against float64: query max {float((got.double() - f64).abs().max()):.3e}, "
                  f"plain max {float((ref.double() - f64).abs().max()):.3e}", flush=True)


def main() -> int:
    parts = sys.argv[1:] or ["field", "density"]
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    if "field" in parts:
        field(dev)
    if "density" in parts:
        density(dev, "sound")
        csrc = build.CSRC
        for name, edits in FAULTS.items():
            work = Path(tempfile.mkdtemp())
            shutil.copytree(csrc, work / "csrc")
            for f, old, new in edits:
                text = (work / "csrc" / f).read_text()
                assert text.count(old) == 1, (f, old)
                (work / "csrc" / f).write_text(text.replace(old, new))
            build.CSRC, build.BUILD_DIR, build._LIB = work / "csrc", work / "_build", None
            density(dev, name)
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
