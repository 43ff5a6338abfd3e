"""Weight-normalized skip MLPs with SAL/IDR geometric init (port of
``endosurf_tpu/ops/mlp.py``).

Parameters are plain dicts of tensors in the JAX layout: weight-norm layers
``{v [in, out], g [out], b [out]}``, plain layers ``{w, b}``, so a forward is
``x @ W``.

Matmul precision is an explicit argument instead of the JAX package's module
globals:

* ``"highest"`` and ``"high"``: float32 dots (keep TF32 off on the GPU);
* ``"default"``: both dot operands rounded to bfloat16, products accumulated
  in float32 — what the TPU kernels compute with bf16 MXU feeds.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

Params = Dict[str, Any]
PRECISIONS = ("default", "high", "highest")


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A dot operand as the precision mode feeds it (bf16-rounded or not).
    The rounded value is float32, or float64 for a float64 ``x`` (the
    float64 yardsticks: the same roundings, float64 sums)."""
    if precision == "default":
        return x.to(torch.bfloat16).to(torch.float64 if x.dtype == torch.float64
                                        else torch.float32)
    return x


def dot(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` with the precision mode's operand rounding, f32 accumulation."""
    return operand(a, precision) @ operand(b, precision)


def softplus100(x: torch.Tensor) -> torch.Tensor:
    """Softplus with beta = 100, exact for all inputs (no threshold cut)."""
    z = x * 100.0
    return (torch.clamp(z, min=0.0) + torch.log1p(torch.exp(-torch.abs(z)))) / 100.0


ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": torch.relu,
    "softplus100": softplus100,
}


def _layer_dims(n_layers: int, hidden_dim: int, in_dim: int, out_dim: int,
                skips: Sequence[int], style: str) -> List[tuple]:
    dims = []
    for l in range(n_layers):
        if style == "nerf":
            d0 = in_dim if l == 0 else (hidden_dim + in_dim if l in skips else hidden_dim)
            d1 = out_dim if l == n_layers - 1 else hidden_dim
        elif style == "idr":
            d0 = in_dim if l == 0 else hidden_dim
            if l == n_layers - 1:
                d1 = out_dim
            elif (l + 1) in skips:
                d1 = hidden_dim - in_dim
                if d1 <= 0:
                    raise ValueError(
                        f"idr-style skip MLP needs hidden_dim > encoded "
                        f"in_dim (got hidden={hidden_dim}, in={in_dim})")
            else:
                d1 = hidden_dim
        else:
            raise ValueError(f"unknown mlp style {style!r}")
        dims.append((d0, d1))
    return dims


def _torch_default_linear(gen: torch.Generator, d0: int, d1: int):
    """nn.Linear's init: weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(d0)
    w = (torch.rand(d0, d1, generator=gen) * 2.0 - 1.0) * bound
    b = (torch.rand(d1, generator=gen) * 2.0 - 1.0) * bound
    return w, b


def _geometric_linear(gen: torch.Generator, l: int, n_layers: int, d0: int,
                      d1: int, in_dim: int, skips: Sequence[int],
                      bias_val: float, inside_outside: bool):
    """SAL geometric init for one [d0, d1] layer."""
    if l == n_layers - 1:
        mean = math.sqrt(math.pi) / math.sqrt(d0)
        if inside_outside:
            mean, b_const = -mean, bias_val
        else:
            b_const = -bias_val
        w = mean + 0.0001 * torch.randn(d0, d1, generator=gen)
        b = torch.full((d1,), b_const)
        return w, b
    std = math.sqrt(2.0) / math.sqrt(d1)
    w = std * torch.randn(d0, d1, generator=gen)
    if l == 0:
        w[3:, :] = 0.0                       # only raw xyz feeds layer 0
    elif l in skips:
        w[-(in_dim - 3):, :] = 0.0           # zero the re-injected encoding
    return w, torch.zeros(d1)


def init_skip_mlp(n_layers: int, hidden_dim: int, in_dim: int, out_dim: int,
                  skips: Sequence[int] = (), style: str = "nerf",
                  geometric_init: bool = False,
                  geometric_init_bias: float = 0.8,
                  inside_outside: bool = False, weight_norm: bool = True,
                  generator: Optional[torch.Generator] = None,
                  device: Any = "cpu") -> Params:
    """Initialize a skip MLP (same distributions as the JAX init).

    Draws on the CPU ``generator`` and moves the result to ``device``.
    """
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    dims = _layer_dims(n_layers, hidden_dim, in_dim, out_dim, skips, style)
    layers = []
    for l, (d0, d1) in enumerate(dims):
        if geometric_init:
            w, b = _geometric_linear(gen, l, n_layers, d0, d1, in_dim, skips,
                                     geometric_init_bias, inside_outside)
        else:
            w, b = _torch_default_linear(gen, d0, d1)
        w, b = w.to(device), b.to(device)
        if weight_norm:
            layers.append({"v": w, "g": torch.linalg.norm(w, dim=0), "b": b})
        else:
            layers.append({"w": w, "b": b})
    return {"layers": layers}


def effective_weight(layer: Params) -> torch.Tensor:
    """Weight-norm ``(v, g)`` -> ``W = v * g / ||v||`` (columns); or ``w``."""
    if "v" in layer:
        v = layer["v"]
        return v * (layer["g"] / (torch.linalg.norm(v, dim=0) + 1e-12))[None, :]
    return layer["w"]


def linear_apply(layer: Params, x: torch.Tensor, precision: str) -> torch.Tensor:
    return dot(x, effective_weight(layer), precision) + layer["b"]


def skip_mlp_apply(params: Params, x_enc: torch.Tensor,
                   skips: Sequence[int] = (), activation: str = "relu",
                   skip_scale: float = 1.0 / math.sqrt(2.0),
                   precision: str = "highest") -> torch.Tensor:
    """Run a skip MLP on encoded input (no output activation).

    Before each skip layer the running features are concatenated with the
    encoded input and scaled by ``skip_scale`` (the scale is applied before
    the dot, as the JAX sampling kernels do).
    """
    act = ACTIVATIONS[activation]
    layers = params["layers"]
    h = x_enc
    for l, layer in enumerate(layers):
        if l in skips:
            h = torch.cat([h, x_enc], dim=-1) * skip_scale
        h = linear_apply(layer, h, precision)
        if l != len(layers) - 1:
            h = act(h)
    return h
