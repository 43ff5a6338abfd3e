"""Port of ``endosurf_tpu/kernels/fused_train.py``: the explicit field math
that the render kernel runs per sample point, split into the three segments
of the train-step field megakernel.

``prepare_effective`` turns (v, g, b) params into effective weights with the
skip layers split into an h block and per-section encoding blocks. The
segments, each the plain PyTorch version of a kernel pair in
``csrc/fused_train.cu``:

    (x_c, jrows)        = seg_deform_math(eff_d, xt)        deform + 3 Jacobian rows
    (sdf, feat, grad_c) = seg_sdf_math(eff_s, head, featw, x_c)   + in-forward adjoint
    (grad_o, d_c)       = coupling_math(jrows, grad_c, d)   plain tensor code
    color               = seg_color_math(eff_c, x_c, grad_c, d_c, feat)

``forward_math`` is their composition (the render kernel's field evaluation,
and the autograd path of the train step). ``megakernel_point_eval`` runs the
same chain through ``SegDeform`` / ``SegSdf`` / ``SegColor``, autograd
Functions whose backward recomputes the segment from its saved inputs: on
CUDA tensors the kernels (``fused_train_cuda``), on CPU tensors the plain
math (``seg_math``) and ``plain_bwd``, its ``torch.autograd.grad``, as JAX's
jnp path takes ``jax.vjp``.
All of it holds the dot semantics of ``ops.mlp.dot``.

The JAX module pads everything to 128 lanes and forms encodings with selector
matmuls; that is TPU layout, not math, and is dropped here. One consequence
is kept on purpose: under ``"default"`` precision the JAX kernel rounds the
coordinates it feeds its selector matmuls to bf16, so ``forward_math`` rounds
x, t, x_c and d_c before encoding them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch

from endosurf_tpu_torch.ops.encoding import encode_with_derivative, freq_encode_dim
from endosurf_tpu_torch.ops.mlp import dot, effective_weight, operand, softplus100

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def _split_rows(w: torch.Tensor, widths: Sequence[int]) -> List[torch.Tensor]:
    parts, ofs = [], 0
    for wd in widths:
        parts.append(w[ofs:ofs + wd])
        ofs += wd
    assert ofs == w.shape[0], (ofs, w.shape)
    return parts


def _build(layers, skips, sec_widths) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    n_sec = sum(sec_widths)
    for l, layer in enumerate(layers):
        w, b = effective_weight(layer), layer["b"]
        if l == 0:
            out.append({"wsec": _split_rows(w, sec_widths), "b": b})
        elif l in skips:
            n_h = w.shape[0] - n_sec
            out.append({"wh": w[:n_h], "wsec": _split_rows(w[n_h:], sec_widths),
                        "b": b})
        else:
            out.append({"w": w, "b": b})
    return out


def color_sections(spec) -> Tuple[int, int, int, int]:
    """Widths of the colour net's input sections: enc(x_c), grad_c, enc(d_c), feat."""
    return (freq_encode_dim(3, spec.color_pos_freqs), 3,
            freq_encode_dim(3, spec.color_dir_freqs), spec.color_feat_dim)


def prepare_effective(spec, params: Dict[str, Any]) -> Dict[str, Any]:
    """(v, g, b) params -> effective weights ([in, out]) with split skips.

    Layer dicts: ``{"wsec": [..], "b"}`` first layer, ``{"wh", "wsec", "b"}``
    skip layer, ``{"w", "b"}`` plain layer. The SDF output layer is split
    into ``sdf_head`` [H, 1] and ``sdf_feat`` [H, F].
    """
    eff: Dict[str, Any] = {}
    if spec.use_deform:
        d_in = (freq_encode_dim(3, spec.deform_pos_freqs)
                + freq_encode_dim(1, spec.deform_time_freqs))
        eff["deform"] = _build(params["deform_network"]["layers"],
                               spec.deform.skips, (d_in,))
    sdf = _build(params["sdf_network"]["layers"], spec.sdf.skips,
                 (freq_encode_dim(3, spec.sdf_pos_freqs),))
    last = sdf.pop()
    eff["sdf"] = sdf
    eff["sdf_head"] = {"w": last["w"][:, :1], "b": last["b"][:1]}
    eff["sdf_feat"] = {"w": last["w"][:, 1:], "b": last["b"][1:]}
    eff["color"] = _build(params["color_network"]["layers"], spec.color.skips,
                          color_sections(spec))
    return eff


def _mlp_fwd(layers, secs, act, precision, skip_scale: float = _INV_SQRT2):
    """Split-skip MLP (skips scale after the dot). Returns (out, zs) with
    zs[l] the pre-activations."""
    h, zs = None, []
    for l, lay in enumerate(layers):
        if "wh" in lay:
            z = dot(h, lay["wh"], precision)
            for s_, w_ in zip(secs, lay["wsec"]):
                z = z + dot(s_, w_, precision)
            z = z * skip_scale + lay["b"]
        elif "wsec" in lay:
            z = dot(secs[0], lay["wsec"][0], precision)
            for s_, w_ in zip(secs[1:], lay["wsec"][1:]):
                z = z + dot(s_, w_, precision)
            z = z + lay["b"]
        else:
            z = dot(h, lay["w"], precision) + lay["b"]
        zs.append(z)
        h = act(z) if l != len(layers) - 1 else z
    return h, zs


def _tangent_fwd(layers, seed, gates, precision):
    """Jacobian tangent pass: no biases, relu gates from the primal, the
    seed re-injected at skips."""
    u = None
    for l, lay in enumerate(layers):
        if "wh" in lay:
            m = (dot(u, lay["wh"], precision)
                 + dot(seed, lay["wsec"][0], precision)) * _INV_SQRT2
        elif "wsec" in lay:
            m = dot(seed, lay["wsec"][0], precision)
        else:
            m = dot(u, lay["w"], precision)
        u = m * gates[l] if l != len(layers) - 1 else m
    return u


def _sdf_adjoint(layers, head_w, gates, precision):
    """d sdf / d e_s: the SDF chain walked in reverse from the head column."""
    a = head_w.T.expand(gates[0].shape[0], head_w.shape[0])
    aE = None
    for l in range(len(layers) - 1, -1, -1):
        a = a * gates[l]
        lay = layers[l]
        if "wh" in lay:
            contrib = dot(a, lay["wsec"][0].T, precision) * _INV_SQRT2
            aE = contrib if aE is None else aE + contrib
            a = dot(a, lay["wh"].T, precision) * _INV_SQRT2
        elif "wsec" in lay:
            contrib = dot(a, lay["wsec"][0].T, precision)
            aE = contrib if aE is None else aE + contrib
        else:
            a = dot(a, lay["w"].T, precision)
    return aE


def _fold(cols: torch.Tensor, coord: torch.Tensor, scale: torch.Tensor,
          n: int) -> torch.Tensor:
    """[N, C] per-column values -> [N, n]: sum_c cols[:, c] * scale_c over
    the columns of each input (the transposed selector product)."""
    sel = torch.zeros(n, cols.shape[1], dtype=cols.dtype, device=cols.device)
    sel[coord, torch.arange(cols.shape[1], device=cols.device)] = scale
    return cols @ sel.T


def seg_deform_math(spec, eff_d, xt: torch.Tensor, precision: str = "highest"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xt [N, 4] (x, t) -> (x_c [N, 3], jrows [N, 3, 3]) with
    jrows[n, k, m] = d x_c[m] / d x[k]: the deform MLP and its three Jacobian
    tangent rows."""
    n = xt.shape[0]
    x = xt[:, :3]
    e_d, g1_d, coord, scale = encode_with_derivative(
        operand(xt, precision), (3, 1), (spec.deform_pos_freqs, spec.deform_time_freqs))
    dx, zs = _mlp_fwd(eff_d, [e_d], torch.relu, precision)
    gates = [(z > 0.0).to(z.dtype) for z in zs[:-1]] + [None]
    # the three tangent seeds ride one stacked pass: [3N, E]
    seeds = torch.cat([(coord == k).to(xt.dtype) * scale * g1_d for k in range(3)], dim=0)
    gates3 = [None if g is None else torch.cat([g] * 3, dim=0) for g in gates]
    u3 = _tangent_fwd(eff_d, seeds, gates3, precision)
    eye = torch.eye(3, dtype=xt.dtype, device=xt.device)
    return x + dx, eye + u3.reshape(3, n, 3).permute(1, 0, 2)


def seg_sdf_math(spec, eff_s, head, featw, x_c: torch.Tensor, precision: str = "highest"
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x_c [N, 3] -> (sdf [N, 1], feat [N, F], grad_c [N, 3]); grad_c = d sdf /
    d x_c by the in-forward adjoint pass."""
    e_s, g1_s, coord_s, scale_s = encode_with_derivative(
        operand(x_c, precision), (3,), (spec.sdf_pos_freqs,))
    _, s_zs = _mlp_fwd(eff_s, [e_s], softplus100, precision)
    h_last = softplus100(s_zs[-1])
    sdf = dot(h_last, head["w"], precision) + head["b"]
    feat = dot(h_last, featw["w"], precision) + featw["b"]
    s_gates = [torch.sigmoid(z * 100.0) for z in s_zs]
    aE = _sdf_adjoint(eff_s, head["w"], s_gates, precision)
    grad_c = _fold(operand(aE * g1_s, precision), coord_s, scale_s, 3)
    return sdf, feat, grad_c


def coupling_math(jrows: torch.Tensor, grad_c: torch.Tensor, d: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grad_o, d_c): grad_o = J^T grad_c, d_c = J d / |J d| (d the raw, unit
    view direction). Plain differentiable tensor code."""
    grad_o = (jrows * grad_c[:, None, :]).sum(-1)
    r = (d[:, :, None] * jrows).sum(1)
    return grad_o, r / (torch.sqrt((r * r).sum(-1, keepdim=True)) + 1e-10)


def seg_color_math(spec, eff_c, x_c: torch.Tensor, grad_c: torch.Tensor, d_c: torch.Tensor,
                   feat: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """-> color [N, 3]: the colour MLP on [enc(x_c), grad_c, enc(d_c), feat]."""
    e_p, _, _, _ = encode_with_derivative(operand(x_c, precision), (3,),
                                          (spec.color_pos_freqs,))
    e_r, _, _, _ = encode_with_derivative(operand(d_c, precision), (3,),
                                          (spec.color_dir_freqs,))
    z_c, _ = _mlp_fwd(eff_c, [e_p, grad_c, e_r, feat], torch.relu, precision)
    return torch.sigmoid(z_c)


def _static_jrows(x: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(x.shape[0], 3, 3)


def forward_math(spec, eff: Dict[str, Any], x: torch.Tensor, t: torch.Tensor,
                 d: torch.Tensor, precision: str = "highest") -> Dict[str, torch.Tensor]:
    """x, d [N, 3], t [N, 1] -> {sdf [N,1], color [N,3], grad_o [N,3],
    grad_c [N,3]} (d is the raw, unit view direction): the segments composed."""
    if spec.use_deform:
        x_c, jrows = seg_deform_math(spec, eff["deform"], torch.cat([x, t], dim=-1), precision)
    else:
        x_c, jrows = x, _static_jrows(x)
    sdf, feat, grad_c = seg_sdf_math(spec, eff["sdf"], eff["sdf_head"], eff["sdf_feat"], x_c,
                                     precision)
    grad_o, d_c = coupling_math(jrows, grad_c, d)
    color = seg_color_math(spec, eff["color"], x_c, grad_c, d_c, feat, precision)
    return {"sdf": sdf, "color": color, "grad_o": grad_o, "grad_c": grad_c}


# ---------------------------------------------------------------------------
# the segments as autograd Functions (port of fused_train._build_segments)
# ---------------------------------------------------------------------------

def flatten_layers(layers: Sequence[Dict[str, Any]]) -> List[torch.Tensor]:
    """A segment's effective layers as a flat tensor list: per layer its row
    blocks in order (``wsec``..., or ``wh`` then ``wsec``..., or ``w``), then
    ``b``."""
    flat: List[torch.Tensor] = []
    for lay in layers:
        flat += ([lay["wh"]] if "wh" in lay else []) + list(lay.get("wsec", []))
        flat += [lay["w"]] if "w" in lay else []
        flat.append(lay["b"])
    return flat


def unflatten_layers(flat: Sequence[torch.Tensor], like: Sequence[Dict[str, Any]]
                     ) -> List[Dict[str, Any]]:
    """Inverse of :func:`flatten_layers` on the structure of ``like``."""
    out, i = [], 0
    for lay in like:
        new: Dict[str, Any] = {}
        if "wh" in lay:
            new["wh"] = flat[i]
            i += 1
        if "wsec" in lay:
            new["wsec"] = list(flat[i:i + len(lay["wsec"])])
            i += len(lay["wsec"])
        if "w" in lay:
            new["w"] = flat[i]
            i += 1
        new["b"] = flat[i]
        i += 1
        out.append(new)
    return out


def _sdf_parts(flat, like):
    """Flat SDF segment weights -> (eff_s layers, head, featw)."""
    n = len(flat) - 4
    return (unflatten_layers(flat[:n], like), {"w": flat[n], "b": flat[n + 1]},
            {"w": flat[n + 2], "b": flat[n + 3]})


# The segments' per-point inputs, in the order the Functions, the kernels and
# ``seg_math`` take them; the deform segment's xt gets no cotangent.
SEGMENT_INPUTS = {"deform": ("xt",), "sdf": ("x_c",), "color": ("x_c", "grad_c", "d_c", "feat")}


def segment_weights(eff: Dict[str, Any], seg: str
                    ) -> Tuple[List[Dict[str, Any]], List[torch.Tensor]]:
    """(layer structure, flat effective weights) of one segment; the SDF
    segment's hidden layers are followed by head w, head b, feat w, feat b."""
    flat = flatten_layers(eff[seg])
    if seg == "sdf":
        flat += [eff["sdf_head"]["w"], eff["sdf_head"]["b"], eff["sdf_feat"]["w"],
                 eff["sdf_feat"]["b"]]
    return eff[seg], flat


def seg_math(spec, seg: str, like, flat: Sequence[torch.Tensor],
             inputs: Sequence[torch.Tensor], precision: str) -> Tuple[torch.Tensor, ...]:
    """The plain version of one segment's forward on flat weights: its
    outputs as a tuple."""
    if seg == "deform":
        return seg_deform_math(spec, unflatten_layers(flat, like), *inputs, precision)
    if seg == "sdf":
        return seg_sdf_math(spec, *_sdf_parts(flat, like), *inputs, precision)
    return (seg_color_math(spec, unflatten_layers(flat, like), *inputs, precision),)


def plain_bwd(spec, seg: str, like, flat: Sequence[torch.Tensor],
              inputs: Sequence[torch.Tensor], cots: Sequence[torch.Tensor], precision: str
              ) -> Tuple[List[torch.Tensor], Tuple[torch.Tensor, ...]]:
    """The plain version of one segment's backward: recompute ``seg_math`` on
    detached copies and pull ``cots`` with autograd, as JAX's jnp path takes
    ``jax.vjp``. Returns (gradients of the flat weights, cotangents of the
    inputs; none for deform's xt). Unused weights get zeros."""
    n = len(flat)
    diff_inputs = seg != "deform"
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (*flat, *(inputs if diff_inputs else ()))]
        outs = seg_math(spec, seg, like, leaves[:n], leaves[n:] if diff_inputs else inputs,
                        precision)
        got = torch.autograd.grad(outs, leaves, cots, allow_unused=True)
    got = [torch.zeros_like(l) if g is None else g for l, g in zip(leaves, got)]
    return got[:n], tuple(got[n:])


def _no_grad_inputs(name: str, *data: torch.Tensor) -> None:
    if any(t.requires_grad for t in data):
        raise ValueError(f"{name}: x, d and t receive no cotangents; pass them without grad")


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no field segments for device {t.device}")
    return False


def _segment_function(seg: str, name: str, doc: str):
    """The autograd Function of one segment: ``apply(spec, like, precision,
    *inputs, *flat)`` (``SEGMENT_INPUTS`` order, then the flat effective
    weights) -> its outputs. CUDA tensors run the segment's kernels
    (``fused_train_cuda``), CPU tensors ``seg_math`` and ``plain_bwd``."""
    n_in = len(SEGMENT_INPUTS[seg])

    class Segment(torch.autograd.Function):
        __doc__ = doc

        @staticmethod
        def forward(ctx, spec, like, precision, *args):
            inputs, flat = args[:n_in], args[n_in:]
            if seg == "deform":
                _no_grad_inputs(name, *inputs)
            ctx.spec, ctx.like, ctx.precision = spec, like, precision
            ctx.save_for_backward(*args)
            if _on_cuda(inputs[0]):
                from endosurf_tpu_torch.kernels import fused_train_cuda as ftc
                ctx.packed = ftc.pack_segment(spec, seg, flat, like, precision)
                outs = ftc.FWD[seg](ctx.packed, *inputs)
            else:
                outs = seg_math(spec, seg, like, flat, inputs, precision)
            return outs if len(outs) > 1 else outs[0]

        @staticmethod
        def backward(ctx, *cots):
            args = ctx.saved_tensors
            inputs, flat = args[:n_in], args[n_in:]
            if _on_cuda(inputs[0]):
                from endosurf_tpu_torch.kernels import fused_train_cuda as ftc
                d_flat, d_in = ftc.BWD[seg](ctx.packed, *inputs, *cots)
            else:
                d_flat, d_in = plain_bwd(ctx.spec, seg, ctx.like, flat, inputs, cots,
                                         ctx.precision)
            return (None, None, None, *(d_in or (None,) * n_in), *d_flat)

    Segment.__name__ = Segment.__qualname__ = name
    return Segment


SegDeform = _segment_function(
    "deform", "SegDeform", "(xt, eff_d...) -> (x_c [N, 3], jrows [N, 3, 3]); xt gets no "
    "cotangent. CUDA tensors run deform_fwd / deform_bwd.")
SegSdf = _segment_function(
    "sdf", "SegSdf", "(x_c, eff_s..., head, featw) -> (sdf [N, 1], feat [N, F], "
    "grad_c [N, 3]). CUDA tensors run sdf_fwd / sdf_bwd.")
SegColor = _segment_function(
    "color", "SegColor", "(x_c, grad_c, d_c, feat, eff_c...) -> color [N, 3]. CUDA "
    "tensors run color_fwd / color_bwd.")
SEGMENT_FUNCTIONS = {"deform": SegDeform, "sdf": SegSdf, "color": SegColor}


def megakernel_point_eval(spec, params: Dict[str, Any], x: torch.Tensor, d: torch.Tensor,
                          t: torch.Tensor, precision: str = "highest"
                          ) -> Dict[str, torch.Tensor]:
    """The field evaluation as three segments with hand-structured backwards
    (contract of JAX's ``fused_train.megakernel_point_eval``): x, d [N, 3],
    t [N, 1] -> {sdf [N], color [N, 3], grad_o [N, 3], grad_c [N, 3]}. x, d
    and t receive no cotangents (data rays, sample locations without grad).
    The weight-norm prep and the coupling stay differentiable tensor code,
    so the (v, g, b) gradients follow by autograd."""
    _no_grad_inputs("megakernel_point_eval", x, d, t)
    eff = prepare_effective(spec, params)

    def run(seg, *inputs):
        like, flat = segment_weights(eff, seg)
        return SEGMENT_FUNCTIONS[seg].apply(spec, like, precision, *inputs, *flat)
    if spec.use_deform:
        x_c, jrows = run("deform", torch.cat([x, t], dim=-1).to(torch.float32).contiguous())
    else:
        x_c, jrows = x, _static_jrows(x)
    sdf, feat, grad_c = run("sdf", x_c)
    grad_o, d_c = coupling_math(jrows, grad_c, d)
    color = run("color", x_c, grad_c, d_c, feat)
    return {"sdf": sdf[:, 0], "color": color, "grad_o": grad_o, "grad_c": grad_c}
