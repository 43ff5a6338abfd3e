"""The training objectives (port of ``endosurf_tpu/train/losses.py``).

EndoSurf's six terms: masked-L1 colour, masked-L1 depth gated by the valid
depth region, SDF and angle error at the ground-truth depth points, the
Eikonal error, and the surface-neighbour normal consistency. EndoNeRF's two:
masked MSE colour and masked Huber (delta 0.2) depth.

All reductions are masked sums over fixed-shape tensors. Each masked mean is
built as an ``ops.ratio.Ratio`` (this rank's sum and count) and resolved by
``global_means``: without a data mesh that is the single-process division;
with one, each rank's loss is its share of the global mean (the counts
all-reduced once a step) and the metrics are the global values, as JAX's
psums give them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from endosurf_tpu_torch.ops.ratio import Ratio, Term, as_is, plus
from endosurf_tpu_torch.parallel.mesh import DataMesh, global_means


def masked_l1_ratio(err: torch.Tensor, mask: torch.Tensor) -> Ratio:
    """sum |err * mask| over sum mask (+ 1e-10)."""
    return Ratio((err * mask).abs().sum(), mask.sum())


def masked_mse_ratio(err: torch.Tensor, mask: torch.Tensor) -> Ratio:
    """sum (err * mask)^2 over sum mask (+ 1e-10)."""
    return Ratio(((err * mask) ** 2).sum(), mask.sum())


def masked_huber_ratio(err: torch.Tensor, mask: torch.Tensor, delta: float = 0.2) -> Ratio:
    """Masked Huber: torch's ``huber_loss(reduction="sum")`` of ``err * mask``
    over sum mask (+ 1e-10), quadratic where |e| <= delta."""
    e = err * mask
    abs_e = e.abs()
    per = torch.where(abs_e <= delta, 0.5 * e ** 2, delta * (abs_e - 0.5 * delta))
    return Ratio(per.sum(), mask.sum())


def masked_colour_mse_ratio(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> Ratio:
    """The MSE over the masked pixels of [R, 3] colours (PSNR's argument)."""
    return Ratio(((a - b) ** 2 * mask).sum(), mask.sum(), lambda den: (den + 1e-10) * 3.0)


def psnr_of_mse(mse: torch.Tensor) -> torch.Tensor:
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def masked_mse(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The masked MSE over one process's rows."""
    return masked_mse_ratio(err, mask).value()


def masked_huber(err: torch.Tensor, mask: torch.Tensor, delta: float = 0.2) -> torch.Tensor:
    """The masked Huber mean over one process's rows."""
    return masked_huber_ratio(err, mask, delta).value()


def _weighted_total(terms: Dict[str, torch.Tensor], weights: Dict[str, float],
                    keys: Tuple[Tuple[str, str], ...]) -> torch.Tensor:
    total = None
    for term, weight in keys:
        part = terms[term] * weights[weight]
        total = part if total is None else total + part
    return total


ENDOSURF_TERMS = (("loss_color", "color_loss_weight"), ("loss_depth", "depth_loss_weight"),
                  ("loss_sdf", "sdf_loss_weight"), ("loss_angle", "angle_loss_weight"),
                  ("loss_eikonal", "eikonal_loss_weight"),
                  ("loss_surf_neig", "surf_neig_loss_weight"))
ENDONERF_TERMS = (("loss_color", "color_loss_weight"), ("loss_depth", "depth_loss_weight"))


def _resolve(terms: Dict[str, Term], stats: Dict[str, Term], weights: Dict[str, float],
             keys, mesh: Optional[DataMesh]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(this rank's differentiable total, the metrics): the loss terms and
    the statistics resolved together (one all-reduce with a mesh)."""
    shares, values = global_means({**terms, **stats}, mesh)
    total = _weighted_total(shares, weights, keys)
    metrics = {k: values[k] for k in terms}
    metrics["loss_total"] = _weighted_total(values, weights, keys)
    metrics["psnr_color"] = psnr_of_mse(values["mse_color"])
    metrics.update({k: values[k] for k in stats if k != "mse_color"})
    return total, metrics


def endosurf_loss_terms(render_out: Dict[str, torch.Tensor], sdf_err: Term,
                        angle_err: Term, valid_depth_region: torch.Tensor,
                        surf_neig_err: Term, batch: Dict[str, torch.Tensor],
                        weights: Dict[str, float], mesh: Optional[DataMesh] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, metrics) from the render, the auxiliary errors (tensors,
    or Ratios of this rank's rows) and the batch's supervision. The Eikonal
    term is the render's ``eikonal_num`` / ``eikonal_den`` where it has them,
    else its ``gradient_o_error``. With ``mesh`` the total is this rank's
    share of the global loss and the metrics are global."""
    color_mask = batch["color_mask"]
    mask = batch["mask"]
    eikonal = render_out["gradient_o_error"]
    if "eikonal_num" in render_out:
        eikonal = Ratio(render_out["eikonal_num"], render_out["eikonal_den"], plus(1e-6))
    terms = {
        "loss_color": masked_l1_ratio(render_out["color_map"] - batch["color"], color_mask),
        "loss_depth": masked_l1_ratio(render_out["depth_map"] - batch["depth"],
                                      valid_depth_region * mask),
        "loss_sdf": sdf_err,
        "loss_angle": angle_err,
        "loss_eikonal": eikonal,
        "loss_surf_neig": surf_neig_err,
    }
    stats = {
        "mse_color": masked_colour_mse_ratio(render_out["color_map"], batch["color"],
                                             color_mask),
        "s_val": Ratio(render_out["s_val"].sum(),
                       render_out["s_val"].new_tensor(float(render_out["s_val"].numel())), as_is),
        "cdf": Ratio((render_out["cdf"][:, :1] * mask).sum(), mask.sum()),
        "weight_max": Ratio((render_out["weight_max"] * mask).sum(), mask.sum()),
    }
    return _resolve(terms, stats, weights, ENDOSURF_TERMS, mesh)


def endonerf_loss_terms(render_out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                        weights: Dict[str, float], mesh: Optional[DataMesh] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """EndoNeRF's (total loss, metrics): masked MSE colour on the colour mask
    and masked Huber(0.2) depth on the mask; ``mesh`` as for EndoSurf."""
    color_mask = batch["color_mask"]
    terms = {
        "loss_color": masked_mse_ratio(render_out["color_map"] - batch["color"], color_mask),
        "loss_depth": masked_huber_ratio(render_out["depth_map"] - batch["depth"],
                                         batch["mask"]),
    }
    stats = {"mse_color": masked_colour_mse_ratio(render_out["color_map"], batch["color"],
                                                  color_mask)}
    return _resolve(terms, stats, weights, ENDONERF_TERMS, mesh)
