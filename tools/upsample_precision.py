#!/usr/bin/env python
"""How far the bf16 upsample's sweeps sit from exact arithmetic, and why.

    python tools/upsample_precision.py emulate [--cells narrow,full] [--seeds 0,1] [--rays 1024]
    python tools/upsample_precision.py card

``emulate`` (CPU) runs the plain upsampling (fused_sampler.fused_upsample_z_
reference, bf16) with its SDF evaluated by emulations of the sweeps'
arithmetic, each against the float64 yardstick (fused_sampler.fused_upsample_
z_float64, the kernels' bf16 weights): "plain" (float32 sums and math, the
SIMT sweep's kind), "mma order" (16-wide k-tiles summed in float32, each
promoted by a float32 add), "truncated" (each k-tile's products truncated
within 2^-23 of its largest product, the sum truncated to float32, promoted
exactly; double epilogue, encodings, output layer and head) and "split" (as
"truncated", with a row's operands under 1/16 of its largest in a second
term whose k-tile sum is added to the first's in float32: csrc/sweep_tc.cuh's
arithmetic). It also reads the plain emulation against the yardstick with
its own float64 weight norm. Per cell: the median and p99 of the per-ray
max error of z and sdf.

``card`` (one CUDA card, nvcc) reads, per narrow and full net and seed, the
upsample kernel's sdf at its own samples against the float64 SDF there (the
quantiles and the share over 1e-6 and 1e-5), for the kernel as built, for a
copy of csrc/ whose bf16 upsample runs the SIMT sweep, a copy without the
sweep's small-operand term and a copy that rounds its doubles to bf16 once
(VARIANTS); and each one's per-ray median and p99 against the yardstick.
"""

from __future__ import annotations

import argparse
import math
import os
import shutil
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from endosurf_tpu_torch.kernels import fused_sampler as fs  # noqa: E402
from endosurf_tpu_torch.models import endosurf as es  # noqa: E402
from endosurf_tpu_torch.models.fields import (  # noqa: E402
    EndoSurfSpec,
    MLPSpec,
    init_endosurf_params,
    sdf_observed,
)
from endosurf_tpu_torch.ops.encoding import freq_encode  # noqa: E402
from endosurf_tpu_torch.ops.geometry import ray_sphere_intersection  # noqa: E402
from endosurf_tpu_torch.ops.mlp import effective_weight, operand  # noqa: E402

NARROW = EndoSurfSpec(deform=MLPSpec(9, 64, (4,), 3), sdf=MLPSpec(9, 64, (4,), 65),
                      color=MLPSpec(9, 64, (4,), 3), color_feat_dim=64)
SPECS = {"narrow": NARROW, "full": EndoSurfSpec(), "full-static": EndoSurfSpec(use_deform=False)}
SKIP = 1.0 / math.sqrt(2.0)


def bf(x):
    return operand(x, "default")


def inputs(n: int, seed: int, dev):
    """o, d_z, t and perturbed z0 [n, 32], as tests/test_torch_cuda.py draws them."""
    g = torch.Generator().manual_seed(1 + seed)
    o = torch.cat([torch.rand(n, 2, generator=g) * 0.6 - 0.3, torch.full((n, 1), -1.5)], -1)
    d = torch.rand(n, 3, generator=g) * 0.4 - 0.2 - o
    d = d / d.norm(dim=-1, keepdim=True)
    rays = torch.cat([o, d, torch.zeros(n, 2), torch.rand(n, 1, generator=g)], -1)
    o, d, d_z, t = es._split_rays(rays)
    near, far, _ = ray_sphere_intersection(o, d)
    z0 = es._stratified_z(near, far, 32,
                          torch.rand(n, 1, generator=torch.Generator().manual_seed(2 + seed)))
    return [x.contiguous().to(dev) for x in (o, d_z, t, z0)]


def softplus100(z):
    y = z * 100.0
    return (torch.clamp(y, min=0.0) + torch.log1p(torch.exp(-torch.abs(y)))) / 100.0


def truncated_tile(a, w):
    """sum_k a_k w_k of a k-tile with each product truncated within 2^-23 of
    the largest and the sum truncated to float32 (float64 in, out)."""
    p = a[:, :, None] * w[None]
    q = torch.exp2(torch.floor(torch.log2(p.abs().amax(1, keepdim=True).clamp_min(1e-300))) - 23)
    ex = (torch.trunc(p / q) * q).sum(1)
    t = ex.float()
    return torch.where(t.double().abs() > ex.abs(), torch.nextafter(t, torch.zeros_like(t)),
                       t)


def product(a, w, kind):
    """a @ w of bf16 values the way `kind` sums them."""
    if kind == "plain":
        return a.float() @ w.float()
    if kind == "mma order":
        acc = None
        for k in range(0, a.shape[1], 16):
            part = a[:, k:k + 16].float() @ w[k:k + 16].float()
            acc = part if acc is None else acc + part
        return acc
    a, w = a.double(), w.double()
    terms = [a]
    if kind == "split":
        small = a.abs() < a.abs().amax(1, keepdim=True) / 16
        terms = [torch.where(small, 0.0, a), torch.where(small, a, 0.0)]
    out = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float64)
    for r in range(0, a.shape[0], 2048):
        for k in range(0, a.shape[1], 16):
            part = None
            for term in terms:
                t = truncated_tile(term[r:r + 2048, k:k + 16], w[k:k + 16])
                part = t if part is None else part + t
            out[r:r + 2048] += part.double()
    return out


def emulated_sdf(kind):
    """sdf_observed's replacement: the sweep's arithmetic of `kind`."""
    exact = kind in ("truncated", "split")

    def mlp(layers, enc, skips, relu):
        h = bf(enc)
        for l, (w, b) in enumerate(layers[:-1]):
            if l in skips:
                h = torch.cat([h, bf(enc * SKIP)], -1)
            z = product(h, w, kind)
            z = z.double() + b.double() if exact else z + b
            a = torch.relu(z) if relu else softplus100(z)
            post = SKIP if l + 1 in skips else 1.0
            h = bf(a * post)
        return h

    def out_layer(h, w, b, cols):
        if exact:
            return h.double() @ w[:, cols].double() + b[cols].double()
        return h.float() @ w[:, cols].float() + b[cols].float()

    def sdf(spec, params, x, t, precision):
        layers = {n: [(bf(effective_weight(L).float()), L["b"].float())
                      for L in params[n]["layers"]] for n in ("deform_network", "sdf_network")
                  if n in params}
        xe = x.double() if exact else x.float()
        if spec.use_deform:
            enc = torch.cat([freq_encode(xe, spec.deform_pos_freqs),
                             freq_encode(t.to(xe.dtype), spec.deform_time_freqs)], -1)
            lay = layers["deform_network"]
            x_c = xe + out_layer(mlp(lay, enc, spec.deform.skips, True), *lay[-1], slice(0, 3))
        else:
            x_c = xe
        lay = layers["sdf_network"]
        h = mlp(lay, freq_encode(x_c, spec.sdf_pos_freqs), spec.sdf.skips, False)
        return out_layer(h, *lay[-1], slice(0, 1)).float()
    return sdf


def readings(got, ref) -> str:
    e = fs.parity_errors({k: v.double() for k, v in zip(("z", "sdf"), got)},
                         dict(zip(("z", "sdf"), ref)), torch.bfloat16)
    return "; ".join(f"{k} median {v[0]:.3e} p99 {v[1]:.3e}" for k, v in e.items())


def emulate(cells, seeds, n_rays) -> None:
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    up = fs.fused_upsample_z_reference
    for name in cells:
        spec = SPECS[name]
        for seed in seeds:
            params = init_endosurf_params(spec, torch.Generator().manual_seed(seed), "cpu")
            inp = inputs(n_rays, seed, "cpu")
            ref = fs.fused_upsample_z_float64(spec, params, *inp, 32, 4)
            old = up(spec, fs.to_float64(params), *(a.double() for a in inp), 32, 4,
                     torch.bfloat16, True)
            plain = up(spec, params, *inp, 32, 4, torch.bfloat16, True)
            print(f"emulate {name} seed {seed} plain vs the float64 weight norm's yardstick: "
                  f"{readings(plain, old)}", flush=True)
            for kind in ("plain", "mma order", "truncated", "split"):
                orig = es.sdf_observed
                es.sdf_observed = emulated_sdf(kind)
                try:
                    got = up(spec, params, *inp, 32, 4, torch.bfloat16, True)
                finally:
                    es.sdf_observed = orig
                print(f"emulate {name} seed {seed} {kind}: {readings(got, ref)}", flush=True)


# The copies of csrc/ the card mode reads beside the kernel as built: (name,
# file, text, replacement).
VARIANTS = [
    ("SIMT", "fused_sampler.cu",
     "return rb_samp ? sweep_rays_tc(w, m, fr, R, K, rb, z, ldz, dst, ldd, st)",
     "return rb_samp ? sweep_rays(w, m, true, R, K, rb, z, ldz, dst, ldd, st)"),
    ("no small-operand term", "sweep_tc.cuh", "< 0.0625f * t.rmax[r];", "< 0.f * t.rmax[r];"),
    # a double rounded to bf16 once, not through float32 as the yardstick is
    ("doubles rounded once", "sweep_tc.cuh",
     "bf16 bf16_rn_d(double x) { return __float2bfloat16_rn((float)x); }",
     "bf16 bf16_rn_d(double x) {\n  float f = (float)x;\n"
     "  if ((__float_as_uint(f) & 0xFFFFu) == 0x8000u && (double)f != x)\n"
     "    f = nextafterf(f, x > (double)f ? INFINITY : -INFINITY);\n"
     "  return __float2bfloat16_rn(f);\n}"),
]


def rebuild(csrc: Path, edit) -> None:
    """Point the kernel build at a copy of csrc with (file, old, new) applied."""
    from endosurf_tpu_torch.kernels import build
    tmp = tempfile.mkdtemp(dir=build.BUILD_DIR)
    src = os.path.join(tmp, "csrc")
    shutil.copytree(csrc, src)
    path = os.path.join(src, edit[0])
    text = open(path).read()
    assert text.count(edit[1]) == 1, edit
    open(path, "w").write(text.replace(edit[1], edit[2]))
    build.CSRC, build.BUILD_DIR, build._LIB = Path(src), Path(tmp) / "_build", None


def card() -> None:
    from endosurf_tpu_torch.kernels import build
    dev = "cuda"
    csrc = build.CSRC
    build.load_library()
    cases = {}
    for name in ("narrow", "full"):
        for seed in (0, 1):
            params = init_endosurf_params(SPECS[name], torch.Generator().manual_seed(seed), dev)
            cases[name, seed] = (params, inputs(1024, seed, dev))

    def quantiles(e):
        q = torch.quantile(e.flatten()[:1000000], torch.tensor([0.5, 0.9, 0.99, 0.999],
                                                                dtype=e.dtype, device=e.device))
        return (" ".join(f"{v:.2e}" for v in q.tolist()) + f" max {float(e.max()):.2e}, over 1e-6 "
                f"{100 * float((e > 1e-6).double().mean()):.2f} %, over 1e-5 "
                f"{100 * float((e > 1e-5).double().mean()):.2f} %")

    def per_point(tag):
        for (name, seed), (params, (o, d_z, t, z0)) in cases.items():
            spec = SPECS[name]
            z, s = fs.fused_upsample_z_cuda(spec, params, o, d_z, t, z0, 32, 4, torch.bfloat16,
                                            True)
            n, k = z.shape
            x = (o.double()[:, None] + d_z.double()[:, None] * z.double()[..., None])
            tt = t.double()[:, None].expand(n, k, 1)
            p64 = fs.to_float64(params)
            for net in ("deform_network", "sdf_network"):
                p64[net] = {**p64[net], "layers": [
                    {"w": bf(effective_weight(L)).double(), "b": L["b"].double()}
                    for L in params[net]["layers"]]}
            with torch.no_grad():
                y = sdf_observed(spec, p64, x.reshape(-1, 3), tt.reshape(-1, 1), "default")
            print(f"card {tag} {name} seed {seed}, sdf at its own samples against float64 "
                  f"(median, p90, p99, p99.9): {quantiles((s.double() - y.view(n, k)).abs())}",
                  flush=True)
            ref = fs.fused_upsample_z_float64(spec, params, o, d_z, t, z0, 32, 4)
            print(f"card {tag} {name} seed {seed} against the yardstick: "
                  f"{readings((z, s), ref)}", flush=True)

    per_point("tensor cores")
    for name, *edit in VARIANTS:
        rebuild(csrc, edit)
        per_point(name)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("emulate", "card"))
    ap.add_argument("--cells", default="narrow,full")
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--rays", type=int, default=1024)
    args = ap.parse_args()
    if args.mode == "card":
        if not torch.cuda.is_available():
            print("upsample_precision card: CUDA is not available", file=sys.stderr)
            return 2
        card()
    else:
        emulate(args.cells.split(","), [int(s) for s in args.seeds.split(",")], args.rays)
    return 0


if __name__ == "__main__":
    sys.exit(main())
