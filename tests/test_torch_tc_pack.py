"""The host side of the tensor-core (bf16 mode) kernels, on the CPU: the
bf16 fragment copies ``fused_train_cuda.pack_segment`` and the upsampling's
``fused_sampler.pack_sampling`` write, the float32 packing each leaves as it
was, the scratch sizes of both modes (``bwd_sizes``) and the SDF forward's
workspace (``fwd_work_floats``), which the card test
``test_segment_scratch_sizes_match_the_planner`` holds against csrc's
planners, and the plain version of the split product (``split_product``)
against a float64 product.

Weights come from a seeded init, points from numpy seeds; tolerances are
stated per test.
"""

import dataclasses

import numpy as np
import pytest
import torch

from endosurf_tpu_torch.kernels import fused_render as fr
from endosurf_tpu_torch.kernels import fused_sampler as fs
from endosurf_tpu_torch.kernels import fused_train as ft
from endosurf_tpu_torch.kernels import fused_train_cuda as ftc
from endosurf_tpu_torch.kernels.fused_render import META_NET, NL
from endosurf_tpu_torch.models.fields import EndoSurfSpec, MLPSpec, init_endosurf_params

NARROW = EndoSurfSpec(deform=MLPSpec(9, 64, (4,), 3), sdf=MLPSpec(9, 64, (4,), 65),
                      color=MLPSpec(9, 64, (4,), 3), color_feat_dim=64)
SPECS = {"narrow": NARROW, "full": EndoSurfSpec()}
# Colour nets besides base.yml's that the tensor-core colour backward walks:
# no skip layer, and hidden widths that are not multiples of 16.
COLOR_NETS = {"noskip": MLPSpec(9, 256, (), 3), "w200": MLPSpec(9, 200, (4,), 3)}


def _segment(spec, seg):
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        eff = ft.prepare_effective(spec, params)
    return ft.segment_weights(eff, seg)


def _unfrag(frag: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """The [K, N] matrix whose mma B fragments ``frag`` holds, read element by
    element from the layout: lane 4 g + t of the (kt, np) block, element
    4 q + 2 h + e, is B[16 kt + 8 h + 2 t + e, 16 np + 8 q + g]."""
    kp, np_ = -(-k // 16) * 16, -(-n // 16) * 16
    assert frag.numel() == kp * np_
    idx = torch.arange(kp * np_)
    el, lane, blk = idx % 8, (idx // 8) % 32, idx // 256
    kt, npair = blk // (np_ // 16), blk % (np_ // 16)
    g, t = lane // 4, lane % 4
    q, h, e = el // 4, (el // 2) % 2, el % 2
    out = torch.empty(kp, np_, dtype=frag.dtype)
    out[16 * kt + 8 * h + 2 * t + e, 16 * npair + 8 * q + g] = frag
    return out


@pytest.mark.parametrize("spec_id", sorted(SPECS))
@pytest.mark.parametrize("seg", ftc.TC_SEGMENTS)
def test_pack_segment_bf16_fragments(seg, spec_id):
    """In the bf16 mode every segment's pack ends with every layer's W and
    W^T as bf16 mma fragments, at the (16-byte aligned) float offsets the
    meta appends after its first META_LEN entries: bit for bit the bf16 of
    the packed (bf16-rounded) float32 weights, zeros in the padding."""
    _check_fragments(SPECS[spec_id], seg)


@pytest.mark.parametrize("net_id", sorted(COLOR_NETS))
def test_pack_segment_takes_other_colour_nets(net_id):
    """A colour net with no skip layer, or with hidden widths that are not
    multiples of 16, packs its fragments as base.yml's does, and its bf16
    scratch is smaller than its float32 one."""
    spec = dataclasses.replace(EndoSurfSpec(), color=COLOR_NETS[net_id])
    _check_fragments(spec, "color")
    like, flat = _segment(spec, "color")
    sizes = {p: ftc.bwd_sizes(ftc.pack_segment(spec, "color", flat, like, p), 4096)
             for p in ("highest", "default")}
    assert sizes["default"][0] < sizes["highest"][0]
    assert sizes["default"][1] == sizes["highest"][1]


def test_pack_segment_refuses_two_colour_skip_layers():
    """The tensor-core colour backward keeps one skip layer's cotangent on
    the colour input: its pack refuses two; the float32 pack takes them."""
    spec = dataclasses.replace(EndoSurfSpec(), color=MLPSpec(9, 256, (2, 5), 3))
    like, flat = _segment(spec, "color")
    ftc.pack_segment(spec, "color", flat, like, "highest")
    with pytest.raises(ValueError, match="one skip layer at most"):
        ftc.pack_segment(spec, "color", flat, like, "default")


def _check_fragments(spec, seg):
    like, flat = _segment(spec, seg)
    packed = ftc.pack_segment(spec, seg, flat, like, "default")
    meta = list(packed.meta)
    assert len(meta) == ftc.META_LEN + 2 * NL
    as_bf16 = packed.w.view(torch.bfloat16)
    for l, (w_off, _, n_in, n_out, _) in enumerate(packed.layers):
        w = packed.w[w_off:w_off + n_in * n_out].view(n_in, n_out)
        assert torch.equal(w.to(torch.bfloat16).to(torch.float32), w)
        for mat, off in ((w, meta[ftc.META_LEN + l]), (w.T, meta[ftc.META_LEN + NL + l])):
            k, n = mat.shape
            assert off % 4 == 0
            size = -(-k // 16) * 16 * (-(-n // 16) * 16)
            got = _unfrag(as_bf16[2 * off:2 * off + size], k, n)
            assert torch.equal(got[:k, :n].view(torch.int16),
                               mat.to(torch.bfloat16).contiguous().view(torch.int16))
            assert not got[k:].any() and not got[:, n:].any()


@pytest.mark.parametrize("spec_id", sorted(SPECS))
@pytest.mark.parametrize("seg", ftc.SEGMENTS)
def test_pack_segment_float32_layout_unchanged(seg, spec_id):
    """Without the fragments the packing is the float32 layout the other
    kernels read: per layer W [in, out] (row blocks stacked), b, W^T, then
    the SDF head column; in the float32 mode exactly that and the meta's
    META_LEN entries, in the bf16 mode the same with W rounded to bf16,
    followed by the fragments of the tensor-core segments (all three)."""
    spec = SPECS[spec_id]
    like, flat = _segment(spec, seg)
    for precision in ("highest", "default"):
        packed = ftc.pack_segment(spec, seg, flat, like, precision)
        rnd = (lambda v: v.to(torch.bfloat16).to(torch.float32)) if precision == "default" \
            else (lambda v: v)
        blocks, i = [], 0
        for lay in like:
            n_rows = int("wh" in lay) + len(lay.get("wsec", [])) + int("w" in lay)
            blocks.append((torch.cat(flat[i:i + n_rows], 0), flat[i + n_rows]))
            i += n_rows + 1
        if seg == "sdf":
            hw, hb, fw, fb = flat[i:i + 4]
            blocks.append((torch.cat([hw, fw], 1), torch.cat([hb, fb])))
        want = [t for w, b in blocks for t in (rnd(w).reshape(-1), b, rnd(w).T.reshape(-1))]
        if seg == "sdf":
            want.append(hw[:, 0])
        want = torch.cat(want)
        assert torch.equal(packed.w[:want.numel()], want)
        frags = precision == "default" and seg in ftc.TC_SEGMENTS
        assert len(packed.meta) == ftc.META_LEN + (2 * NL if frags else 0)
        if not frags:
            assert packed.w.numel() == want.numel()


def test_bwd_sizes_halve_the_deform_scratch():
    """At the train step's 65,536 points: in the bf16 mode the deform and
    colour backward's scratch is about half its float32 size (every array
    but the 3-wide output layer's float32 cotangent is bf16), the SDF's
    smaller; the partial sums are the same. So the step's peak (the largest
    scratch: the float32 deform's) does not grow."""
    spec = EndoSurfSpec()
    sizes = {}
    for seg in ftc.SEGMENTS:
        like, flat = _segment(spec, seg)
        for precision in ("highest", "default"):
            packed = ftc.pack_segment(spec, seg, flat, like, precision)
            sizes[seg, precision] = ftc.bwd_sizes(packed, 65536)
    for seg in ftc.SEGMENTS:
        assert sizes[seg, "default"][1] == sizes[seg, "highest"][1]
    for seg in ("deform", "color"):
        ratio = sizes[seg, "default"][0] / sizes[seg, "highest"][0]
        assert 0.49 < ratio < 0.51, (seg, ratio)
    assert sizes["sdf", "default"][0] < sizes["sdf", "highest"][0]
    assert max(sizes[s, "default"][0] for s in ftc.SEGMENTS) <= \
        max(sizes[s, "highest"][0] for s in ftc.SEGMENTS)
    # the float32 deform scratch: 4 streams x (operands + cotangents) x 4 bytes
    like, flat = _segment(spec, "deform")
    packed = ftc.pack_segment(spec, "deform", flat, like, "highest")
    widths = sum(lay[2] + lay[3] for lay in packed.layers)
    assert sizes["deform", "highest"][0] == 4 * 65536 * widths


def _sdf_dz(layer: int):
    """The SDF segment's cotangent on layer ``layer``'s pre-activation per
    point, from the plain backward (bf16 mode, narrow spec, 512 numpy-seeded
    points, normal cotangents): the gradient of a per-point copy of the
    layer's bias."""
    like, flat = _segment(NARROW, "sdf")
    rng = np.random.default_rng(7)
    x_c = torch.from_numpy(rng.uniform(-0.8, 0.8, (512, 3)).astype(np.float32))
    names = ftc.leaf_names(like, "sdf")
    bi = names.index(f"{layer}.b")
    flat = list(flat)
    flat[bi] = flat[bi].expand(512, -1).clone()
    with torch.no_grad():
        outs = ft.seg_math(NARROW, "sdf", like, flat, (x_c,), "default")
    cots = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32)) for o in outs]
    grads, _ = ft.plain_bwd(NARROW, "sdf", like, flat, (x_c,), cots, "default")
    wt = flat[names.index(f"{layer}.w")].T                       # W^T [out, in]
    return grads[bi], wt.to(torch.bfloat16).to(torch.float32)


@pytest.mark.parametrize("layer", [3, 7])
def test_split_product_error_bound(layer):
    """The plain version of the kernels' split product (a float32 operand as a
    sum of bf16 terms times bf16 weights), on the SDF primal walk's operands
    dz_l W_l^T from the plain backward, against the float64 product: per
    element |got - exact| <= (2^(-8 terms) + terms K 2^-24) (|dz| |W^T|), the
    split's remainder and the float32 sums, for two and three terms; the
    operand rounded once to bf16 (one term) misses the two-term bound."""
    dz, wt = _sdf_dz(layer)
    assert not torch.equal(dz, dz.to(torch.bfloat16).to(torch.float32))   # not bf16 values
    k = dz.shape[1]
    exact = dz.double() @ wt.double()
    scale = dz.double().abs() @ wt.double().abs()
    ratio = {}
    for terms in (1, 2, 3):
        parts = ftc.split_bf16_terms(dz, terms)
        rest = (dz.double() - sum(p.double() for p in parts)).abs()
        assert bool((rest <= 2.0 ** (-8 * terms) * dz.double().abs()).all())
        err = (ftc.split_product(dz, wt, terms).double() - exact).abs()
        ratio[terms] = float((err / scale).max())
    bound = {t: 2.0 ** (-8 * t) + t * k * 2.0 ** -24 for t in (1, 2, 3)}
    print(f"layer {layer}: max |err| / (|dz| |W^T|) one term {ratio[1]:.3e}, two "
          f"{ratio[2]:.3e} (bound {bound[2]:.3e}), three {ratio[3]:.3e} "
          f"(bound {bound[3]:.3e})")
    assert ratio[2] <= bound[2] and ratio[3] <= bound[3]
    assert ratio[1] > bound[2]


@pytest.mark.parametrize("seg", ftc.SEGMENTS)
def test_out_biases_are_the_output_layer_biases(seg):
    """The leaves PARITY_TOL's "bias" kind judges are the biases of the
    segment's output layer (the SDF's: its head and feature columns), named
    as fused_train_cuda.leaf_names names the flat weights, and each is a
    bias: a vector as long as the layer's output columns it feeds."""
    like, flat = _segment(EndoSurfSpec(), seg)
    names = ftc.leaf_names(like, seg)
    widths = {"deform": {"8.b": 3}, "sdf": {"head.b": 1, "feat.b": 256},
              "color": {"8.b": 3}}[seg]
    assert set(ftc.OUT_BIASES[seg]) == set(widths)
    for name in ftc.OUT_BIASES[seg]:
        assert tuple(flat[names.index(name)].shape) == (widths[name],)


# Sampling nets besides base.yml's that the tensor-core sweep takes: no skip
# layer, and hidden widths that are not multiples of 16 (the deform net's
# layer before the skip is then 148 wide).
SWEEP_SPECS = {
    "full": EndoSurfSpec(), "static": EndoSurfSpec(use_deform=False), "narrow": NARROW,
    "noskip": dataclasses.replace(EndoSurfSpec(), deform=MLPSpec(9, 256, (), 3),
                                  sdf=MLPSpec(9, 256, (), 257)),
    "w200": dataclasses.replace(EndoSurfSpec(), deform=MLPSpec(9, 200, (4,), 3),
                                sdf=MLPSpec(9, 200, (4,), 201), color_feat_dim=200),
}


def _meta_net(meta, q):
    """(in dims, out dims, W offsets) of net q (0 deform, 1 sdf) of a render meta."""
    net = meta[8 + q * META_NET:8 + (q + 1) * META_NET]
    return net[2:2 + NL], net[2 + NL:2 + 2 * NL], net[2 + 2 * NL:2 + 3 * NL]


@pytest.mark.parametrize("spec_id", sorted(SWEEP_SPECS))
def test_pack_sampling_bf16_fragments(spec_id):
    """In the bf16 mode the upsampling's pack ends with the deform and SDF
    nets' hidden-layer W as bf16 mma fragments, at the 16-byte aligned float
    offsets its meta appends after the render meta's entries (deform net,
    then SDF; -1 for the output layers and an absent deform net): bit for
    bit the bf16 of the packed (bf16-rounded) float32 W, zeros in the
    padding."""
    spec = SWEEP_SPECS[spec_id]
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), "cpu")
    w, meta = fs.pack_sampling(spec, params, torch.bfloat16)
    base_len = len(fr.pack_operands(spec, params, torch.bfloat16)[1])
    assert len(meta) == base_len + 2 * NL
    as_bf16 = w.view(torch.bfloat16)
    for q in (0, 1):
        offs = meta[base_len + q * NL:base_len + (q + 1) * NL]
        if q == 0 and not spec.use_deform:
            assert offs == [-1] * NL
            continue
        ins, outs, w_offs = _meta_net(meta, q)
        assert offs[NL - 1] == -1
        for l in range(NL - 1):
            k, n = ins[l], outs[l]
            mat = w[w_offs[l]:w_offs[l] + k * n].view(k, n)
            assert torch.equal(mat.to(torch.bfloat16).to(torch.float32), mat)
            assert offs[l] % 4 == 0
            size = -(-k // 16) * 16 * (-(-n // 16) * 16)
            got = _unfrag(as_bf16[2 * offs[l]:2 * offs[l] + size], k, n)
            assert torch.equal(got[:k, :n].view(torch.int16),
                               mat.to(torch.bfloat16).view(torch.int16))
            assert not got[k:].any() and not got[:, n:].any()


@pytest.mark.parametrize("spec_id", sorted(SWEEP_SPECS))
def test_pack_sampling_keeps_the_float32_layout(spec_id):
    """The upsampling's pack is ``pack_operands``' buffer and meta byte for
    byte in float32, and their prefix in bf16, so the render (which packs with
    ``pack_operands``) reads the layout it always did: a meta of the render's
    META_LEN entries, which it decodes alone."""
    spec = SWEEP_SPECS[spec_id]
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), "cpu")
    for dtype in (torch.float32, torch.bfloat16):
        w, meta = fs.pack_sampling(spec, params, dtype)
        w0, meta0 = fr.pack_operands(spec, params, dtype)
        assert len(meta0) == ftc.META_LEN
        assert meta[:len(meta0)] == meta0
        assert torch.equal(w[:w0.numel()], w0)
        if dtype == torch.float32:
            assert len(meta) == len(meta0) and w.numel() == w0.numel()


@pytest.mark.parametrize("spec_id", sorted(SPECS))
def test_fwd_work_floats_holds_the_sdf_pre_activations(spec_id):
    """``fwd_work_floats`` (the CPU mirror of field_tc.cuh's
    plan_sdf_fwd_tc, which the card test test_segment_scratch_sizes_match_the_planner
    holds against csrc): in bf16 the SDF forward's workspace holds each hidden
    layer's pre-activations [n, out] in float32, 256-byte aligned, the same
    widths as the backward's saved pre-activations (``tc_scratch_layout``'s
    "z"); no workspace in float32 or for the other segments."""
    spec = SPECS[spec_id]
    for seg in ftc.SEGMENTS:
        like, flat = _segment(spec, seg)
        for precision in ("highest", "default"):
            packed = ftc.pack_segment(spec, seg, flat, like, precision)
            for n in (1, 63, 4097, 65536):
                got = ftc.fwd_work_floats(packed, n)
                if seg != "sdf" or precision == "highest":
                    assert got == 0
                    continue
                outs = [lay[3] for lay in packed.layers[:-1]]
                z = [a for a in ftc.tc_scratch_layout(packed, n)[0] if a[0] == "z"]
                assert [a[3] for a in z] == [(n, o) for o in outs]
                used = 0
                for o in outs:
                    used = -(-used // 256) * 256 + 4 * n * o
                assert got == -(-used // 4)
                if n % 64 == 0:
                    assert got == n * sum(outs)
