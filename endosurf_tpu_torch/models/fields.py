"""EndoSurf neural fields: deformation, SDF, colour, deviation (port of
``endosurf_tpu/models/fields.py``).

``fused_point_eval`` gives sdf, colour and both SDF gradients in one pass; it
runs the explicit tangent/adjoint math of ``kernels/fused_train.py``, which
is what the render kernel computes per point. On the card (and with
``megakernel: on``) it runs as three segments whose backwards are written
out, the CUDA segment kernels; otherwise the math is plain tensor code and
autograd differentiates it. Either way one backward carries the Eikonal
term's mixed second-order gradient.
``sdf_grad_observed`` is the SDF's spatial gradient by autograd, kept
differentiable (``create_graph``) for the losses built on it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from endosurf_tpu_torch.ops.encoding import freq_encode, freq_encode_dim
from endosurf_tpu_torch.ops.mlp import init_skip_mlp, skip_mlp_apply

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    n_layers: int
    hidden_dim: int
    skips: Tuple[int, ...]
    out_dim: int


@dataclasses.dataclass(frozen=True)
class EndoSurfSpec:
    """Static network configuration (reference YAML ``net`` section)."""
    use_deform: bool = True
    bound: float = 1.0
    deform_pos_freqs: int = 6
    deform_time_freqs: int = 6
    sdf_pos_freqs: int = 6
    color_pos_freqs: int = 10
    color_dir_freqs: int = 4
    deform: MLPSpec = MLPSpec(9, 256, (4,), 3)
    sdf: MLPSpec = MLPSpec(9, 256, (4,), 257)
    color: MLPSpec = MLPSpec(9, 256, (4,), 3)
    color_feat_dim: int = 256
    geometric_init: bool = True
    geometric_init_bias: float = 0.8
    deviation_init: float = 0.3

    @staticmethod
    def from_config(net_cfg: Dict[str, Any]) -> "EndoSurfSpec":
        def mlp_spec(section: Dict[str, Any]) -> MLPSpec:
            return MLPSpec(
                n_layers=section.get("n_layers", 9),
                hidden_dim=section.get("hidden_dim", 256),
                skips=tuple(section.get("skips", [4])),
                out_dim=section.get("out_dim", 3),
            )

        d = net_cfg.get("deform_network", {})
        s = net_cfg.get("sdf_network", {})
        c = net_cfg.get("color_network", {})
        return EndoSurfSpec(
            use_deform=net_cfg.get("use_deform", True),
            bound=net_cfg.get("bound", 1.0),
            deform_pos_freqs=d.get("enc_pos_cfg", {}).get("multires", 6),
            deform_time_freqs=d.get("enc_time_cfg", {}).get("multires", 6),
            sdf_pos_freqs=s.get("enc_pos_cfg", {}).get("multires", 6),
            color_pos_freqs=c.get("enc_pos_cfg", {}).get("multires", 10),
            color_dir_freqs=c.get("enc_dir_cfg", {}).get("multires", 4),
            deform=mlp_spec(d),
            sdf=dataclasses.replace(mlp_spec(s), out_dim=s.get("out_dim", 257)),
            color=mlp_spec(c),
            color_feat_dim=c.get("feat_dim", 256),
            geometric_init=s.get("geometric_init", True),
            geometric_init_bias=s.get("geometric_init_bias", 0.8),
            deviation_init=net_cfg.get("deviation_network", {}).get("init_val", 0.3),
        )


def init_endosurf_params(spec: EndoSurfSpec,
                         generator: Optional[torch.Generator] = None,
                         device: Any = "cpu") -> Params:
    """All field parameters, drawn from ``generator`` (a CPU generator).

    Same keys, shapes and distributions as the JAX init; the draws differ.
    """
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    params: Params = {}
    if spec.use_deform:
        in_dim = (freq_encode_dim(3, spec.deform_pos_freqs)
                  + freq_encode_dim(1, spec.deform_time_freqs))
        params["deform_network"] = init_skip_mlp(
            spec.deform.n_layers, spec.deform.hidden_dim, in_dim,
            spec.deform.out_dim, spec.deform.skips, style="idr",
            generator=gen, device=device)
    params["sdf_network"] = init_skip_mlp(
        spec.sdf.n_layers, spec.sdf.hidden_dim,
        freq_encode_dim(3, spec.sdf_pos_freqs), spec.sdf.out_dim,
        spec.sdf.skips, style="nerf", geometric_init=spec.geometric_init,
        geometric_init_bias=spec.geometric_init_bias, generator=gen,
        device=device)
    color_in = (freq_encode_dim(3, spec.color_pos_freqs) + 3
                + freq_encode_dim(3, spec.color_dir_freqs) + spec.color_feat_dim)
    params["color_network"] = init_skip_mlp(
        spec.color.n_layers, spec.color.hidden_dim, color_in,
        spec.color.out_dim, spec.color.skips, style="nerf", generator=gen,
        device=device)
    params["deviation_network"] = {
        "variance": torch.tensor(spec.deviation_init, dtype=torch.float32,
                                 device=device)}
    return params


def deform_apply(spec: EndoSurfSpec, params: Params, x: torch.Tensor,
                 t: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """(x [N,3], t [N,1]) -> canonical-space offset [N,3]."""
    enc = torch.cat([freq_encode(x, spec.deform_pos_freqs),
                     freq_encode(t, spec.deform_time_freqs)], dim=-1)
    return skip_mlp_apply(params["deform_network"], enc, skips=spec.deform.skips,
                          activation="relu", precision=precision)


def warp_to_canonical(spec: EndoSurfSpec, params: Params, x: torch.Tensor,
                      t: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    if spec.use_deform:
        return x + deform_apply(spec, params, x, t, precision)
    return x


def sdf_feat_apply(spec: EndoSurfSpec, params: Params, x_c: torch.Tensor,
                   precision: str = "highest") -> torch.Tensor:
    """Canonical point -> [N, 1 + feat_dim] (sdf, geometric feature)."""
    enc = freq_encode(x_c, spec.sdf_pos_freqs)
    return skip_mlp_apply(params["sdf_network"], enc, skips=spec.sdf.skips,
                          activation="softplus100", precision=precision)


def sdf_observed(spec: EndoSurfSpec, params: Params, x: torch.Tensor,
                 t: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """Observed point -> sdf [N, 1]."""
    x_c = warp_to_canonical(spec, params, x, t, precision)
    return sdf_feat_apply(spec, params, x_c, precision)[..., :1]


def color_apply(spec: EndoSurfSpec, params: Params, x_c: torch.Tensor,
                normal_c: torch.Tensor, dir_c: torch.Tensor, feat: torch.Tensor,
                precision: str = "highest") -> torch.Tensor:
    """Canonical (point, normal, dir, feature) -> rgb in [0, 1]."""
    enc = torch.cat([freq_encode(x_c, spec.color_pos_freqs), normal_c,
                     freq_encode(dir_c, spec.color_dir_freqs), feat], dim=-1)
    h = skip_mlp_apply(params["color_network"], enc, skips=spec.color.skips,
                       activation="relu", precision=precision)
    return torch.sigmoid(h)


def inv_s(params: Params) -> torch.Tensor:
    """NeuS sharpness exp(10 * variance), clipped to [1e-6, 1e6]."""
    return torch.clamp(torch.exp(params["deviation_network"]["variance"] * 10.0),
                       1e-6, 1e6)


MEGAKERNEL_MODES = ("auto", "on", "off")


def fused_point_eval(spec: EndoSurfSpec, params: Params, x: torch.Tensor,
                     d: torch.Tensor, t: torch.Tensor, precision: str = "highest",
                     megakernel: str = "auto") -> Dict[str, torch.Tensor]:
    """x, d [N,3], t [N,1] -> {sdf [N], color [N,3], grad_o [N,3], grad_c [N,3]}.

    grad_o is the observed-space SDF gradient, grad_c the canonical one fed
    to the colour net. ``megakernel`` (``train.megakernel``) picks the path:
    "on", and "auto" for CUDA tensors, run the three segments of
    ``kernels.fused_train.megakernel_point_eval`` (the CUDA segment kernels
    on the card at every point count, their plain versions on the CPU);
    "off", and "auto" for CPU tensors, run ``plain_point_eval``. "off" on
    CUDA tensors raises: the card always runs the kernels.
    """
    from endosurf_tpu_torch.kernels import fused_train
    if megakernel not in MEGAKERNEL_MODES:
        raise ValueError(f"unknown megakernel mode {megakernel!r}")
    if x.device.type == "cuda":
        if megakernel == "off":
            raise NotImplementedError("not yet ported: megakernel: off on CUDA tensors "
                                      "(the card always runs the field segment kernels)")
        return fused_train.megakernel_point_eval(spec, params, x, d, t, precision)
    if megakernel == "on":
        return fused_train.megakernel_point_eval(spec, params, x, d, t, precision)
    return plain_point_eval(spec, params, x, d, t, precision)


def plain_point_eval(spec: EndoSurfSpec, params: Params, x: torch.Tensor,
                     d: torch.Tensor, t: torch.Tensor, precision: str = "highest"
                     ) -> Dict[str, torch.Tensor]:
    """The plain version of ``fused_point_eval``: ``kernels.fused_train.
    forward_math`` under autograd, on any device (the CPU path, and the
    render kernel's plain twin)."""
    from endosurf_tpu_torch.kernels.fused_train import forward_math, prepare_effective
    out = forward_math(spec, prepare_effective(spec, params), x, t, d, precision)
    return {"sdf": out["sdf"][:, 0], "color": out["color"],
            "grad_o": out["grad_o"], "grad_c": out["grad_c"]}


def sdf_grad_observed(spec: EndoSurfSpec, params: Params, x: torch.Tensor,
                      t: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """d sdf / d x [N, 3] at observed points. Under grad mode the result is
    differentiable with respect to the parameters (second order)."""
    create_graph = torch.is_grad_enabled()
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        sdf = sdf_observed(spec, params, xg, t, precision)
        (grad,) = torch.autograd.grad(sdf.sum(), xg, create_graph=create_graph)
    return grad
