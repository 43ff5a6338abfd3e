"""NeuS SDF -> opacity math (port of ``endosurf_tpu/ops/neus.py``)."""

from __future__ import annotations

from typing import Tuple

import torch


def annealed_iter_cos(true_cos: torch.Tensor, cos_anneal_ratio) -> torch.Tensor:
    """relu(-c/2 + 0.5) blended toward relu(-c) as the ratio goes 0 -> 1."""
    return -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
             + torch.relu(-true_cos) * cos_anneal_ratio)


def neus_alpha(sdf: torch.Tensor, iter_cos: torch.Tensor, dists: torch.Tensor,
               inv_s) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample opacity from section-endpoint SDF estimates.

    Returns (alpha, prev_cdf), alpha clipped to [0, 1].
    """
    est_next = sdf + iter_cos * dists * 0.5
    est_prev = sdf - iter_cos * dists * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    alpha = torch.clamp((prev_cdf - next_cdf + 1e-6) / (prev_cdf + 1e-6), 0.0, 1.0)
    return alpha, prev_cdf


def exclusive_cumprod_weights(alpha: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """w_i = alpha_i * prod_{j<i} (1 - alpha_j + eps)."""
    trans = torch.cumprod(1.0 - alpha + eps, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    return alpha * trans


def upsample_weights_from_sdf(z_vals: torch.Tensor, sdf: torch.Tensor,
                              radius: torch.Tensor, inv_s: float) -> torch.Tensor:
    """Importance weights [R, S-1] for SDF-guided upsampling at sharpness
    ``inv_s``, with the min(cos, prev_cos) rule and the inside-sphere gate."""
    prev_sdf, next_sdf = sdf[..., :-1], sdf[..., 1:]
    prev_z, next_z = z_vals[..., :-1], z_vals[..., 1:]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-6)
    prev_cos = torch.cat([torch.zeros_like(cos_val[..., :1]), cos_val[..., :-1]], dim=-1)
    cos_val = torch.minimum(cos_val, prev_cos)
    inside = (radius[..., :-1] < 1.0) | (radius[..., 1:] < 1.0)
    cos_val = torch.clamp(cos_val, -1e3, 0.0) * inside.to(cos_val.dtype)

    dist = next_z - prev_z
    prev_esti = mid_sdf - cos_val * dist * 0.5
    next_esti = mid_sdf + cos_val * dist * 0.5
    prev_cdf = torch.sigmoid(prev_esti * inv_s)
    next_cdf = torch.sigmoid(next_esti * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-6) / (prev_cdf + 1e-6)
    return exclusive_cumprod_weights(alpha)


def merge_sorted_z(z_vals: torch.Tensor, new_z: torch.Tensor, sdf: torch.Tensor,
                   new_sdf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Concatenate and co-sort (z, sdf) along the sample axis (stable)."""
    z_cat = torch.cat([z_vals, new_z], dim=-1)
    sdf_cat = torch.cat([sdf, new_sdf], dim=-1)
    z_sorted, order = torch.sort(z_cat, dim=-1, stable=True)
    return z_sorted, torch.gather(sdf_cat, -1, order)
