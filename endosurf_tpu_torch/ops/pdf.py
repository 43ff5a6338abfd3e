"""Inverse-CDF sampling (port of ``endosurf_tpu/ops/pdf.py``).

Random draws come from an explicit ``torch.Generator`` or are passed in as a
tensor of uniforms (``u``, and for ``sample_from_alias`` the integer draws
``j``), so a test can feed both packages the same numbers.
"""

from __future__ import annotations

from typing import Optional

import torch


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               generator: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Samples [..., n_samples] of the piecewise linear inverse CDF of
    ``weights`` [..., B-1] over ``bins`` [..., B].

    The quantiles are ``u`` when given, else uniforms from ``generator``,
    else the deterministic midpoints (j + 0.5) / n_samples."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)

    shape = cdf.shape[:-1] + (n_samples,)
    if u is None and generator is not None:
        u = torch.rand(shape, generator=generator, device=cdf.device, dtype=cdf.dtype)
    if u is None:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           dtype=cdf.dtype, device=cdf.device)
        u = u.expand(shape).contiguous()

    # searchsorted(right=True) as a compare-count, like the JAX version
    inds = (cdf[..., None, :] <= u[..., :, None]).sum(-1)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)

    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def sample_from_cdf(cdf: torch.Tensor, n_samples: int,
                    generator: Optional[torch.Generator] = None,
                    u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Indices [n_samples] (int64) drawn from a normalized CDF [N] by binary
    search (``searchsorted`` side="left", as ``jnp.searchsorted``), at the
    uniforms ``u`` or fresh ones from ``generator``."""
    if u is None:
        u = torch.rand(n_samples, generator=generator, device=cdf.device, dtype=cdf.dtype)
    inds = torch.searchsorted(cdf, u.to(cdf.dtype), side="left")
    return torch.clamp(inds, 0, cdf.shape[0] - 1)


def inverse_cdf_sample(weights: torch.Tensor, n_samples: int,
                       generator: Optional[torch.Generator] = None,
                       u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Indices [n_samples] drawn proportionally to unnormalized ``weights``
    [N] (a 1e-12 floor on every weight)."""
    cdf = torch.cumsum(weights + 1e-12, dim=0)
    return sample_from_cdf(cdf / cdf[-1], n_samples, generator, u)


def sample_from_alias(prob: torch.Tensor, alias: torch.Tensor, j: torch.Tensor,
                      u: torch.Tensor) -> torch.Tensor:
    """Indices [n] (int64) drawn from a Walker/Vose alias table
    (``native.alias_table``): bin ``j`` [n] (integers uniform in [0, N)) kept
    where ``u`` [n] (uniforms in [0, 1)) < prob[j], else its alias. Two
    gathers a draw; the categorical distribution is the table's weights
    exactly (the ``cdf`` sampler's carries a 1e-12 floor on every weight)."""
    j = j.to(device=prob.device, dtype=torch.int64)
    return torch.where(u.to(prob.device) < prob[j], j, alias[j].to(torch.int64))
