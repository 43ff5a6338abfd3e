"""Inverse-CDF sampling (port of ``endosurf_tpu/ops/pdf.py``, deterministic
midpoint path only; the random draws and the pixel samplers serve training)."""

from __future__ import annotations

import torch


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Samples [..., n_samples] at u = (j + 0.5) / n_samples of the piecewise
    linear inverse CDF of ``weights`` [..., B-1] over ``bins`` [..., B]."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)

    u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                       dtype=cdf.dtype, device=cdf.device)
    u = u.expand(cdf.shape[:-1] + (n_samples,)).contiguous()

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
