"""Forward half of ``endosurf_tpu/kernels/fused_train.py``: the explicit field
math that the render kernel runs per sample point.

``prepare_effective`` turns (v, g, b) params into effective weights with the
skip layers split into an h block and per-section encoding blocks;
``forward_math`` evaluates deform (+ 3 Jacobian tangent rows), SDF (+ the
in-forward adjoint giving grad_c), the coupling (grad_o = J^T grad_c,
d_c = J d / |J d|) and the colour MLP. It is the plain PyTorch version of the
field evaluation inside ``csrc/fused_render.cu`` and holds the same dot
semantics (``ops.mlp.dot``).

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


def _mlp_fwd(layers, secs, act, precision):
    """Split-skip MLP. Returns (out, zs) with zs[l] the pre-activations."""
    h, zs = None, []
    for l, lay in enumerate(layers):
        if "wh" in lay:
            z = dot(h, lay["wh"], precision)
            for s_, w_ in zip(secs, lay["wsec"]):
                z = z + dot(s_, w_, precision)
            z = z * _INV_SQRT2 + lay["b"]
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


def forward_math(spec, eff: Dict[str, Any], x: torch.Tensor, t: torch.Tensor,
                 d: torch.Tensor, precision: str = "highest") -> Dict[str, torch.Tensor]:
    """x, d [N, 3], t [N, 1] -> {sdf [N,1], color [N,3], grad_o [N,3],
    grad_c [N,3]} (d is the raw, unit view direction)."""
    n = x.shape[0]
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    if spec.use_deform:
        xt = operand(torch.cat([x, t], dim=-1), precision)
        e_d, g1_d, coord, scale = encode_with_derivative(
            xt, (3, 1), (spec.deform_pos_freqs, spec.deform_time_freqs))
        dx, zs = _mlp_fwd(eff["deform"], [e_d], torch.relu, precision)
        gates = [(z > 0.0).to(z.dtype) for z in zs[:-1]] + [None]
        x_c = x + dx
        # the three tangent seeds ride one stacked pass: [3N, E]
        seeds = torch.cat([(coord == k).to(x.dtype) * scale * g1_d
                           for k in range(3)], dim=0)
        gates3 = [None if g is None else torch.cat([g] * 3, dim=0) for g in gates]
        u3 = _tangent_fwd(eff["deform"], seeds, gates3, precision)
        jac = eye + u3.reshape(3, n, 3).permute(1, 0, 2)    # J[n, k, m] = dxc_m/dx_k
    else:
        x_c = x
        jac = eye.expand(n, 3, 3)

    # SDF + in-forward adjoint
    e_s, g1_s, coord_s, scale_s = encode_with_derivative(
        operand(x_c, precision), (3,), (spec.sdf_pos_freqs,))
    _, s_zs = _mlp_fwd(eff["sdf"], [e_s], softplus100, precision)
    h_last = softplus100(s_zs[-1])
    sdf = dot(h_last, eff["sdf_head"]["w"], precision) + eff["sdf_head"]["b"]
    feat = dot(h_last, eff["sdf_feat"]["w"], precision) + eff["sdf_feat"]["b"]
    s_gates = [torch.sigmoid(z * 100.0) for z in s_zs]
    aE = _sdf_adjoint(eff["sdf"], eff["sdf_head"]["w"], s_gates, precision)
    grad_c = _fold(operand(aE * g1_s, precision), coord_s, scale_s, 3)

    # coupling: grad_o = J^T grad_c, d_c = J d / |J d|
    grad_o = (jac * grad_c[:, None, :]).sum(-1)
    r = (d[:, :, None] * jac).sum(1)
    d_c = r / (torch.sqrt((r * r).sum(-1, keepdim=True)) + 1e-10)

    e_p, _, _, _ = encode_with_derivative(operand(x_c, precision), (3,),
                                          (spec.color_pos_freqs,))
    e_r, _, _, _ = encode_with_derivative(operand(d_c, precision), (3,),
                                          (spec.color_dir_freqs,))
    z_c, _ = _mlp_fwd(eff["color"], [e_p, grad_c, e_r, feat], torch.relu, precision)
    return {"sdf": sdf, "color": torch.sigmoid(z_c), "grad_o": grad_o,
            "grad_c": grad_c}
