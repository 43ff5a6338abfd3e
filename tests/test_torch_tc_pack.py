"""The host side of the tensor-core (bf16 mode) kernels, on the CPU: the
bf16 fragment copies ``fused_train_cuda.pack_segment``, the upsampling's
``fused_sampler.pack_sampling`` and the render's ``fused_render.pack_render``
write, the float32 packing each leaves as it was, the render pack's cache,
the render's workspace (``render_work_floats``), the scratch sizes of both
modes (``bwd_sizes``) and the SDF forward's workspace (``fwd_work_floats``),
which the card tests ``test_segment_scratch_sizes_match_the_planner`` and
``test_render_workspace_matches_the_planner`` hold against csrc's planners;
the D-NeRF pack's fragments and cache (``fused_train_dnerf.pack_dnerf``),
its backward scratch sizes (``fused_train_dnerf.bwd_sizes``, held against
csrc by ``test_dnerf_bwd_sizes_match_the_planner``) and its tiles' shared
memory gate,
and the plain version of the split product (``split_product``)
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
from endosurf_tpu_torch.kernels import fused_sdf as fsd
from endosurf_tpu_torch.kernels import fused_train as ft
from endosurf_tpu_torch.kernels import fused_train_cuda as ftc
from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
from endosurf_tpu_torch.kernels.fused_render import META_NET, NL
from endosurf_tpu_torch.models import endonerf as en
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


def _unfrag_at(w: torch.Tensor, off: int, k: int, n: int) -> torch.Tensor:
    """The [K, N] bf16 matrix whose fragments start at float offset off of w
    (padding included)."""
    size = -(-k // 16) * 16 * (-(-n // 16) * 16)
    return _unfrag(w.view(torch.bfloat16)[2 * off:2 * off + size], k, n)


@pytest.mark.parametrize("spec_id", sorted(SWEEP_SPECS))
def test_pack_render_bf16_fragments(spec_id):
    """In the bf16 mode the render's pack ends with four blocks of NL
    fragment offsets after the render meta's entries: the deform net's W,
    the SDF net's W (its output layer too), the colour net's W and the SDF
    net's W^T, -1 where a layer has none. Each block equals
    ``fused_train_cuda.mma_frags`` of the packed bf16 weights, bit for bit,
    and the first two are ``pack_sampling``'s (but for the SDF output
    layer's, which the sweeps do not read), so the sweeps read the same
    offsets. Nets the tensor-core field stage does not take are refused."""
    spec = SWEEP_SPECS[spec_id]
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), "cpu")
    if spec_id == "w200":          # SDF hidden widths not multiples of 16
        with pytest.raises(ValueError, match="multiples of 16"):
            fr.pack_render(spec, params, torch.bfloat16)
        return
    w, meta = fr.pack_render(spec, params, torch.bfloat16)
    base_len = len(fr.pack_operands(spec, params, torch.bfloat16)[1])
    assert len(meta) == base_len + 4 * NL
    samp_w, samp_meta = fs.pack_sampling(spec, params, torch.bfloat16)
    # pack_sampling's layout up to its last block's -1 (the SDF output layer,
    # which the render's SDF forward takes and the sweeps do not read)
    assert meta[:base_len + 2 * NL - 1] == samp_meta[:-1] and samp_meta[-1] == -1
    assert torch.equal(w[:samp_w.numel()], samp_w)
    for block, (q, transposed, output) in enumerate(fr.RENDER_FRAG_NETS):
        offs = meta[base_len + block * NL:base_len + (block + 1) * NL]
        net = meta[8 + q * META_NET:8 + (q + 1) * META_NET]
        if net[0] == 0:
            assert offs == [-1] * NL
            continue
        for l in range(NL):
            if l == NL - 1 and not output:
                assert offs[l] == -1
                continue
            k, n = net[2 + l], net[2 + NL + l]
            off = net[2 + (4 if transposed else 2) * NL + l]
            mat = w[off:off + k * n].view((n, k) if transposed else (k, n))
            assert torch.equal(mat.to(torch.bfloat16).to(torch.float32), mat)
            assert offs[l] % 4 == 0
            want = ftc.mma_frags(mat.to(torch.bfloat16))
            got = w.view(torch.bfloat16)[2 * offs[l]:2 * offs[l] + want.numel()]
            assert torch.equal(got.view(torch.int16), want.view(torch.int16)), (block, l)
            kk, nn = mat.shape
            assert torch.equal(_unfrag_at(w, offs[l], kk, nn)[:kk, :nn].view(torch.int16),
                               mat.to(torch.bfloat16).view(torch.int16))


@pytest.mark.parametrize("spec_id", sorted(SWEEP_SPECS))
def test_pack_render_keeps_the_float32_layout(spec_id):
    """The render's pack is ``pack_operands``' buffer and meta byte for
    byte in float32, and their prefix in bf16."""
    spec = SWEEP_SPECS[spec_id]
    params = init_endosurf_params(spec, torch.Generator().manual_seed(1), "cpu")
    for dtype in (torch.float32, torch.bfloat16):
        if dtype == torch.bfloat16 and spec_id == "w200":
            continue
        w, meta = fr.pack_render(spec, params, dtype)
        w0, meta0 = fr.pack_operands(spec, params, dtype)
        assert meta[:len(meta0)] == meta0
        assert torch.equal(w[:w0.numel()].view(torch.int32), w0.view(torch.int32))
        if dtype == torch.float32:
            assert len(meta) == len(meta0) and w.numel() == w0.numel()


def test_pack_render_is_cached_per_parameter_set():
    """A frame's chunks share one pack: a second call on the same parameter
    tensors returns it without packing; an in-place update of any weight
    or an Adam step (the trainer's, in place) or new tensors repack, and the
    new pack holds the new weights."""
    spec = NARROW
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), "cpu")
    for dtype in (torch.float32, torch.bfloat16):
        first = fr.pack_render(spec, params, dtype)
        n = fr.PACKS["render"]
        assert fr.pack_render(spec, params, dtype) is first and fr.PACKS["render"] == n
        layer = params["color_network"]["layers"][3]
        with torch.no_grad():
            layer["b"].add_(1.0)
        w, meta = fr.pack_render(spec, params, dtype)
        assert fr.PACKS["render"] == n + 1
        assert torch.equal(w, fr.pack_render(spec, params, dtype)[0])
        b_off = meta[8 + 2 * META_NET + 2 + 3 * NL + 3]
        assert torch.equal(w[b_off:b_off + layer["b"].numel()], layer["b"])
        w_sdf = params["sdf_network"]["layers"][1]["b"].requires_grad_(True)
        opt = torch.optim.Adam([w_sdf], lr=1e-3)
        w_sdf.sum().backward()
        opt.step()                 # the trainer's update: in place
        fr.pack_render(spec, params, dtype)
        assert fr.PACKS["render"] == n + 2
        params = init_endosurf_params(spec, torch.Generator().manual_seed(0), "cpu")
        fr.pack_render(spec, params, dtype)
        assert fr.PACKS["render"] == n + 3


def test_pack_render_does_not_outlive_its_parameters():
    """The cache holds its parameter tensors weakly: once they are freed the
    pack goes too, and a parameter set made later at the same ids packs
    anew."""
    import gc
    spec = NARROW
    for dtype in (torch.float32, torch.bfloat16):
        params = init_endosurf_params(spec, torch.Generator().manual_seed(0), "cpu")
        pack = fr.pack_render(spec, params, dtype)
        assert fr._RENDER_PACKS[dtype][2] is pack
        del params
        gc.collect()
        assert dtype not in fr._RENDER_PACKS
        n = fr.PACKS["render"]
        params = init_endosurf_params(spec, torch.Generator().manual_seed(1), "cpu")
        w, _ = fr.pack_render(spec, params, dtype)
        assert fr.PACKS["render"] == n + 1 and not torch.equal(w, pack[0])


@pytest.mark.parametrize("spec_id", sorted(SPECS))
def test_render_work_floats_lays_out_the_field_stage(spec_id):
    """``render_work_floats`` (the CPU mirror of csrc/fused_render.cu's
    plan_render_work, which the card test
    test_render_workspace_matches_the_planner holds against csrc): the field
    stage's per-point arrays (xt 4, x_c 3, the rows 9, sdf 1, feat F, grad_c
    3, d_c 3) and then the SDF forward's workspace as ``fwd_work_floats``
    sizes it, each array 256-byte aligned."""
    spec = SPECS[spec_id]
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), "cpu")
    _, meta = fr.pack_render(spec, params, torch.bfloat16)
    like, flat = _segment(spec, "sdf")
    packed = ftc.pack_segment(spec, "sdf", flat, like, "default")
    for n in (1, 63, 4097, 2048 * 64):
        used = 0
        for wd in (4, 3, 9, 1, spec.color_feat_dim, 3, 3):
            used = -(-used // 256) * 256 + 4 * n * wd
        head = -(-used // 256) * 256 // 4
        assert fr.render_work_floats(meta, n) == head + ftc.fwd_work_floats(packed, n)


# ---------------------------------------------------------------------------
# the D-NeRF pack (fused_train_dnerf.pack_dnerf) and the density backward's
# scratch (fused_train_dnerf.bwd_sizes)
# ---------------------------------------------------------------------------

DN_SPECS = {"narrow": en.DNeRFSpec(deform_layers=(3, 64, (1,)), density_layers=(3, 64, (1,)),
                                   color_layers=(2, 64, ()), geo_feat_dim=32),
            "full": en.DNeRFSpec(), "full-static": en.DNeRFSpec(use_deform=False)}


@pytest.mark.parametrize("spec_id", sorted(DN_SPECS))
def test_pack_dnerf_bf16_fragments(spec_id):
    """In the bf16 mode the D-NeRF pack ends with six blocks of NL fragment
    offsets after the Model meta (``fused_train_dnerf.DN_FRAG_BLOCKS``): the
    deform, density and colour nets' hidden W, the density output layer's
    feature columns W[:, 1:], then the density net's W^T of the same layers,
    then the deform net's hidden W^T, then the colour net's hidden W^T; -1
    where a layer has none (output layers but the density's, an absent
    deform net, layers past a net's depth). Each block is
    ``fused_train_cuda.mma_frags`` of the packed bf16 weights bit for bit,
    16-byte aligned; the float32 buffer and meta before it are the float32
    pack's layout with bf16-rounded weights."""
    spec = DN_SPECS[spec_id]
    params = en.init_dnerf_params(spec, torch.Generator().manual_seed(0), "cpu")
    packed = ftd.pack_dnerf(spec, params, torch.bfloat16)
    f32 = ftd.pack_dnerf(spec, params, torch.float32)
    meta = list(packed.meta)
    assert meta[:ftd.META_LEN] == list(f32.meta) and len(meta) == ftd.META_LEN + 6 * NL
    assert ftd.DN_FRAG_BLOCKS[4] == (ftd.SLOTS["deform"], True, False)   # the deform's W^T
    assert ftd.DN_FRAG_BLOCKS[5] == (ftd.SLOTS["color"], True, False)    # the colour's W^T
    n_w = f32.w.numel()
    for block, (q, transposed, output) in enumerate(ftd.DN_FRAG_BLOCKS):
        offs = meta[ftd.META_LEN + block * NL:ftd.META_LEN + (block + 1) * NL]
        net = meta[8 + q * META_NET:8 + (q + 1) * META_NET]
        assert bool(output) == (q == ftd.SLOTS["density"])
        if q == ftd.SLOTS["deform"] and not spec.use_deform:
            assert offs == [-1] * NL, block
        for l in range(NL):
            out_layer = l == net[0] - 1
            if l >= net[0] or (out_layer and q != ftd.SLOTS["density"]):
                assert offs[l] == -1, (block, l)
                continue
            k, n = net[2 + l], net[2 + NL + l]
            mat = packed.w[net[2 + 2 * NL + l]:net[2 + 2 * NL + l] + k * n].view(k, n)
            assert torch.equal(mat.to(torch.bfloat16).to(torch.float32), mat)
            if out_layer:
                mat = mat[:, 1:]
            if transposed:
                mat = mat.T
            assert offs[l] % 4 == 0 and offs[l] >= n_w
            kk, nn = mat.shape
            want = ftc.mma_frags(mat.contiguous().to(torch.bfloat16))
            got = packed.w.view(torch.bfloat16)[2 * offs[l]:2 * offs[l] + want.numel()]
            assert torch.equal(got.view(torch.int16), want.view(torch.int16)), (block, l)
            assert torch.equal(_unfrag_at(packed.w, offs[l], kk, nn)[:kk, :nn].view(torch.int16),
                               mat.to(torch.bfloat16).view(torch.int16))


@pytest.mark.parametrize("spec_id", sorted(DN_SPECS))
def test_pack_dnerf_keeps_the_float32_layout(spec_id):
    """The float32 D-NeRF pack is the Model meta and the weights as they
    were packed before the fragments (no extension); the bf16 pack's first
    floats are the same layout with each weight rounded to bf16 and the
    biases unrounded."""
    spec = DN_SPECS[spec_id]
    params = en.init_dnerf_params(spec, torch.Generator().manual_seed(1), "cpu")
    f32 = ftd.pack_dnerf(spec, params, torch.float32)
    bf = ftd.pack_dnerf(spec, params, torch.bfloat16)
    assert len(f32.meta) == ftd.META_LEN and not f32.rb and bf.rb
    for seg in ftd.SEGMENTS if spec.use_deform else ("density", "color"):
        for l, ((wo, bo, n_in, n_out), layer) in enumerate(
                zip(f32.layout(seg), params[seg]["layers"])):
            w = layer["w"].detach()
            assert torch.equal(f32.w[wo:wo + n_in * n_out].view(n_in, n_out), w)
            assert torch.equal(bf.w[wo:wo + n_in * n_out].view(n_in, n_out),
                               w.to(torch.bfloat16).to(torch.float32))
            assert torch.equal(bf.w[bo:bo + n_out], layer["b"].detach())


def test_pack_dnerf_is_cached_per_parameter_set():
    """A frame's chunks share one D-NeRF pack: a second call on the same
    parameter tensors returns it without packing; an in-place update (an
    Adam step) or new tensors repack; the cache holds the tensors weakly, so
    a pack goes with its parameters."""
    import gc
    spec = DN_SPECS["narrow"]
    for dtype in (torch.float32, torch.bfloat16):
        params = en.init_dnerf_params(spec, torch.Generator().manual_seed(0), "cpu")
        first = ftd.pack_dnerf(spec, params, dtype)
        n = ftd.PACKS["dnerf"]
        assert ftd.pack_dnerf(spec, params, dtype) is first and ftd.PACKS["dnerf"] == n
        b = params["color"]["layers"][0]["b"].requires_grad_(True)
        opt = torch.optim.Adam([b], lr=1e-3)
        b.sum().backward()
        opt.step()                 # the trainer's update: in place
        again = ftd.pack_dnerf(spec, params, dtype)
        assert ftd.PACKS["dnerf"] == n + 1 and not torch.equal(again.w, first.w)
        bo = again.layout("color")[0][1]
        assert torch.equal(again.w[bo:bo + b.numel()], b.detach())
        del params, b, opt
        gc.collect()
        assert dtype not in ftd._DN_PACKS
        params = en.init_dnerf_params(spec, torch.Generator().manual_seed(0), "cpu")
        ftd.pack_dnerf(spec, params, dtype)
        assert ftd.PACKS["dnerf"] == n + 2


@pytest.mark.parametrize("kernel, name", [("dnerf_density_bwd", "x_c"),
                                          ("dnerf_color_bwd", "feat")])
def test_dnerf_bwd_cot_limits_per_input(kernel, name):
    """``fused_train_dnerf.cot_tol``: in bf16 only the density backward's
    d x_c has a p99 limit of its own (5e-3); every other input cotangent of
    a backward, and every one in float32, is held at "cot" (p99 1e-3 in
    bf16). ``bwd_parity_errors`` judges each input at its own limits: a d
    x_c p99 of 3e-3 passes, a d feat p99 of 3e-3 fails."""
    bf, f32 = torch.bfloat16, torch.float32
    own = kernel == "dnerf_density_bwd"
    assert ftd.cot_tol(bf, kernel, name) == ((1e-4, 5e-3, 2.0) if own
                                              else ftd.BWD_PARITY_TOL[bf]["cot"])
    assert ftd.BWD_PARITY_TOL[bf]["cot"][1] == 1e-3
    assert ftd.cot_tol(f32, kernel, name) == ftd.BWD_PARITY_TOL[f32]["cot"]
    ref = torch.ones(1000, 3)
    got = ref.clone()
    got[:20, 0] += 3e-3        # 2 % of the points off by 3e-3 of the rms
    med, p99, _, ok = ftd.bwd_parity_errors(kernel, {name: got}, {name: ref}, {}, {},
                                            bf)["cot"][name]
    assert med == 0 and abs(p99 - 3e-3) < 1e-4 and ok == own


@pytest.mark.parametrize("spec_id", sorted(DN_SPECS))
def test_dnerf_bwd_sizes_lay_out_the_scratch(spec_id):
    """``fused_train_dnerf.bwd_sizes`` (the CPU mirror of csrc's planners,
    which the card test test_dnerf_bwd_sizes_match_the_planner holds against
    them): the SIMT backward's float32 operands and cotangents of every
    layer back to back; the tensor-core backwards' bf16 operand rows [n,
    c16(in)] and cotangents [n, c16(out)], float32 from layer L-2 on in the
    density's and at layer L-1 in the deform's and the colour's, bf16 below,
    each array 256-byte aligned, under 60 % of the SIMT scratch at base.yml's
    widths (the deform's 50.6 %, the colour's 53.1 %); partial sums of each
    weight and bias gradient per chunk of 4096 points."""
    spec = DN_SPECS[spec_id]
    params = en.init_dnerf_params(spec, torch.Generator().manual_seed(0), "cpu")
    meta = list(ftd.pack_dnerf(spec, params, torch.bfloat16).meta)

    def c16(x):
        return -(-x // 16) * 16
    for seg, f32_layers in (("density", 2), ("deform", 1), ("color", 1)):
        if seg == "deform" and not spec.use_deform:
            continue
        net = meta[8 + ftd.SLOTS[seg] * META_NET:8 + (ftd.SLOTS[seg] + 1) * META_NET]
        n_layers = net[0]
        ins, outs = net[2:2 + n_layers], net[2 + NL:2 + NL + n_layers]
        for n in (1, 63, 4097, 262144):
            chunks = -(-n // 4096)
            partial = chunks * sum((i + 1) * o for i, o in zip(ins, outs))
            simt = ftd.bwd_sizes(meta, seg, n)
            assert simt == (n * sum(i + o for i, o in zip(ins, outs)), partial)
            used = 0
            for l, (i, o) in enumerate(zip(ins, outs)):
                for size in (2 * c16(i), (2 if l < n_layers - f32_layers else 4) * c16(o)):
                    used = -(-used // 256) * 256 + n * size
            tc = ftd.bwd_sizes(meta, seg, n, tc=True)
            assert tc == (-(-used // 4), partial), (seg, n)
            if spec_id != "narrow" and n == 262144:
                assert tc[0] < 0.6 * simt[0], (seg, tc, simt)


def test_tc_smem_gates_the_nets():
    """The tensor-core D-NeRF tiles fit base.yml's nets: the density
    backward's at most 227 KiB (one block an SM), the deform and colour
    backwards' (one size: one operand term, the relu' bits) and the
    forward's (the sweep's, the render field stage's and the density
    forward's) under half of it (two); a net whose tile would not fit is
    refused: a 40-octave density encoding by the density backward (the other
    tiles fit), a 90-octave deform encoding by the three backwards (the
    forward's fits; the density backward's tile, with the same row pitch and
    three operand terms, is never the smaller), a 110-octave one of either by
    every tile; an unknown tile raises. The forward tile's gate runs before
    the device checks in its point callers, the deform and colour forwards
    (dnerf_deform_fwd, dnerf_color_fwd) and the raw density query
    (fused_density_raw_cuda), and the colour backward's in dnerf_color_bwd:
    in bf16 they refuse the nets their tile refuses, with simt=True they
    reach the device check instead."""
    spec = en.DNeRFSpec()
    params = en.init_dnerf_params(spec, torch.Generator().manual_seed(0), "cpu")
    packed = ftd.pack_dnerf(spec, params, torch.bfloat16)
    assert ftd.tc_smem_bytes(packed.meta, "density_bwd") <= ftd.SMEM_LIMIT
    for tile in ("fwd", "deform_bwd", "color_bwd"):
        assert 2 * ftd.tc_smem_bytes(packed.meta, tile) <= ftd.SMEM_LIMIT, tile
    assert (ftd.tc_smem_bytes(packed.meta, "color_bwd")
            == ftd.tc_smem_bytes(packed.meta, "deform_bwd"))
    assert ftd.TC_TILES == ("fwd", "density_bwd", "deform_bwd", "color_bwd")
    for tile in ftd.TC_TILES:
        ftd.check_tc_nets(packed, tile)
        with pytest.raises(ValueError, match="bf16 pack"):
            ftd.check_tc_nets(ftd.pack_dnerf(spec, params, torch.float32), tile)
    with pytest.raises(ValueError, match="no tensor-core tile"):
        ftd.tc_smem_bytes(packed.meta, "bwd")
    for key, freqs, refused in (("pos_density_freqs", 40, ("density_bwd",)),
                                ("pos_deform_freqs", 90, ("density_bwd", "deform_bwd",
                                                          "color_bwd")),
                                ("pos_density_freqs", 110, ftd.TC_TILES),
                                ("pos_deform_freqs", 110, ftd.TC_TILES)):
        wide = dataclasses.replace(spec, **{key: freqs})
        wide_params = en.init_dnerf_params(wide, torch.Generator().manual_seed(0), "cpu")
        packed = ftd.pack_dnerf(wide, wide_params, torch.bfloat16)
        for tile in ftd.TC_TILES:
            if tile in refused:
                with pytest.raises(ValueError, match="shared memory"):
                    ftd.check_tc_nets(packed, tile)
            else:
                ftd.check_tc_nets(packed, tile)
        x, t = torch.zeros(5, 3), torch.zeros(5, 1)
        like, _ = ftd.segment_weights(ftd.prepare_effective_dnerf(wide, wide_params), "color")
        for simt in (False, True):
            gated = "fwd" in refused and not simt
            with pytest.raises(ValueError, match="shared memory" if gated else "CUDA tensor"):
                ftd.dnerf_deform_fwd(packed, torch.cat([x, t], -1), simt=simt)
            with pytest.raises(ValueError, match="shared memory" if gated else "CUDA tensor"):
                ftd.dnerf_color_fwd(packed, x, torch.zeros(5, wide.geo_feat_dim), simt=simt)
            with pytest.raises(ValueError, match="shared memory" if gated else "CUDA tensors"):
                fsd.fused_density_raw_cuda(wide, wide_params, x, t, torch.bfloat16, simt=simt)
            gated = "color_bwd" in refused and not simt
            with pytest.raises(ValueError, match="shared memory" if gated else "CUDA tensor"):
                ftd.dnerf_color_bwd(packed, like, x, torch.zeros(5, wide.geo_feat_dim), x,
                                    simt=simt)
