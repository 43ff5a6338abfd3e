"""Positional (frequency) encoding (port of ``endosurf_tpu/ops/encoding.py``).

Column order is ``[x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...]`` with every
sin/cos block holding all D input dims, the order the geometric init and the
converted checkpoints rely on.

``encode_columns`` describes the same columns as (input dim, kind, scale)
triples so the field math can form an encoding of several inputs at once and
its analytic derivative, as the kernels do.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch


def freq_encode_dim(input_dim: int, n_freqs: int, include_input: bool = True) -> int:
    """Output dimension of :func:`freq_encode`."""
    out = input_dim if include_input else 0
    return out + input_dim * n_freqs * 2


def freq_encode(x: torch.Tensor, n_freqs: int, include_input: bool = True) -> torch.Tensor:
    """Log-spaced sin/cos frequency encoding of ``x`` [..., D]."""
    if n_freqs == 0:
        return x
    parts = [x] if include_input else []
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    scaled = x[..., None, :] * freqs[:, None]               # [..., F, D]
    inter = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-2)
    parts.append(inter.reshape(*x.shape[:-1], n_freqs * 2 * x.shape[-1]))
    return torch.cat(parts, dim=-1)


@functools.lru_cache(maxsize=32)
def encode_columns(dims: Tuple[int, ...], freqs: Tuple[int, ...]
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-column (input index, kind, scale) of a concatenated encoding.

    Groups of ``dims[g]`` inputs with ``freqs[g]`` octaves are concatenated;
    input indices count across groups. kind: 0 = identity, 1 = sin, 2 = cos.
    """
    coord, kind, scale = [], [], []
    offset = 0
    for d, nf in zip(dims, freqs):
        for i in range(d):
            coord.append(offset + i)
            kind.append(0)
            scale.append(1.0)
        for f in range(nf):
            for k in (1, 2):
                for i in range(d):
                    coord.append(offset + i)
                    kind.append(k)
                    scale.append(2.0 ** f)
        offset += d
    return (np.asarray(coord, np.int64), np.asarray(kind, np.int64),
            np.asarray(scale, np.float32))


def encode_with_derivative(x: torch.Tensor, dims: Sequence[int],
                           freqs: Sequence[int]):
    """Encode the columns of ``x`` [N, sum(dims)].

    Returns (e [N, C], g1 [N, C], coord [C], scale [C]) where g1 is the
    derivative of each column's nonlinearity at its scaled input, so
    d e_c / d x_coord(c) = scale_c * g1_c.
    """
    coord_np, kind_np, scale_np = encode_columns(tuple(dims), tuple(freqs))
    coord = torch.as_tensor(coord_np, device=x.device)
    kind = torch.as_tensor(kind_np, device=x.device)
    scale = torch.as_tensor(scale_np, device=x.device, dtype=x.dtype)
    v = x[:, coord] * scale
    s, c = torch.sin(v), torch.cos(v)
    e = torch.where(kind == 0, v, torch.where(kind == 1, s, c))
    g1 = torch.where(kind == 0, torch.ones_like(v),
                     torch.where(kind == 1, c, -s))
    return e, g1, coord, scale
