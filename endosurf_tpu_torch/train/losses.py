"""The training objectives (port of ``endosurf_tpu/train/losses.py``).

EndoSurf's six terms: masked-L1 colour, masked-L1 depth gated by the valid
depth region, SDF and angle error at the ground-truth depth points, the
Eikonal error, and the surface-neighbour normal consistency. EndoNeRF's two:
masked MSE colour and masked Huber (delta 0.2) depth.

All reductions are masked sums over fixed-shape tensors.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def masked_l1(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum |err * mask| / (sum mask + 1e-10)."""
    return (err * mask).abs().sum() / (mask.sum() + 1e-10)


def masked_mse(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum (err * mask)^2 / (sum mask + 1e-10)."""
    return ((err * mask) ** 2).sum() / (mask.sum() + 1e-10)


def masked_huber(err: torch.Tensor, mask: torch.Tensor, delta: float = 0.2) -> torch.Tensor:
    """Masked Huber: torch's ``huber_loss(reduction="sum")`` of ``err * mask``
    over (sum mask + 1e-10), quadratic where |e| <= delta."""
    e = err * mask
    abs_e = e.abs()
    per = torch.where(abs_e <= delta, 0.5 * e ** 2, delta * (abs_e - 0.5 * delta))
    return per.sum() / (mask.sum() + 1e-10)


def masked_psnr(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """PSNR over the masked pixels of [R, 3] colours."""
    mse = ((a - b) ** 2 * mask).sum() / ((mask.sum() + 1e-10) * 3.0)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def endosurf_loss_terms(render_out: Dict[str, torch.Tensor], sdf_err: torch.Tensor,
                        angle_err: torch.Tensor, valid_depth_region: torch.Tensor,
                        surf_neig_err: torch.Tensor, batch: Dict[str, torch.Tensor],
                        weights: Dict[str, float]
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, metrics) from the render, the auxiliary errors and the
    batch's supervision."""
    color_mask = batch["color_mask"]
    mask = batch["mask"]
    color_loss = masked_l1(render_out["color_map"] - batch["color"], color_mask)
    depth_loss = masked_l1(render_out["depth_map"] - batch["depth"],
                           valid_depth_region * mask)
    eikonal_loss = render_out["gradient_o_error"]
    total = (color_loss * weights["color_loss_weight"]
             + depth_loss * weights["depth_loss_weight"]
             + sdf_err * weights["sdf_loss_weight"]
             + angle_err * weights["angle_loss_weight"]
             + eikonal_loss * weights["eikonal_loss_weight"]
             + surf_neig_err * weights["surf_neig_loss_weight"])
    mask_sum = mask.sum() + 1e-10
    metrics = {
        "loss_color": color_loss,
        "loss_depth": depth_loss,
        "loss_sdf": sdf_err,
        "loss_angle": angle_err,
        "loss_eikonal": eikonal_loss,
        "loss_surf_neig": surf_neig_err,
        "loss_total": total,
        "psnr_color": masked_psnr(render_out["color_map"], batch["color"], color_mask),
        "s_val": render_out["s_val"].mean(),
        "cdf": (render_out["cdf"][:, :1] * mask).sum() / mask_sum,
        "weight_max": (render_out["weight_max"] * mask).sum() / mask_sum,
    }
    return total, metrics


def endonerf_loss_terms(render_out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                        weights: Dict[str, float]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """EndoNeRF's (total loss, metrics): masked MSE colour on the colour mask
    and masked Huber(0.2) depth on the mask."""
    color_mask = batch["color_mask"]
    color_loss = masked_mse(render_out["color_map"] - batch["color"], color_mask)
    depth_loss = masked_huber(render_out["depth_map"] - batch["depth"], batch["mask"])
    total = (color_loss * weights["color_loss_weight"]
             + depth_loss * weights["depth_loss_weight"])
    return total, {
        "loss_color": color_loss,
        "loss_depth": depth_loss,
        "loss_total": total,
        "psnr_color": masked_psnr(render_out["color_map"], batch["color"], color_mask),
    }
