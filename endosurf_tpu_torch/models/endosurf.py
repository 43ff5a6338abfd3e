"""EndoSurf renderer, serving subset (port of ``endosurf_tpu/models/endosurf.py``).

Deterministic (``key=None``) rendering only: stratified z, SDF-guided
upsampling rounds at sharpness 64 * 2^i, one fused field evaluation at the
section midpoints, and NeuS compositing. ``render_rays_inference`` is the
serving entry: it hands the whole pipeline to ``kernels.fused_render``, whose
CUDA kernel runs it for tensors on the GPU.

Precision is explicit: ``precision`` for the final field evaluation and
``sampling_precision`` (None = same) for the upsampling sweeps, with the
meanings of ``ops.mlp``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from endosurf_tpu_torch.models.fields import (
    EndoSurfSpec,
    fused_point_eval,
    inv_s,
    sdf_observed,
)
from endosurf_tpu_torch.ops.geometry import ray_sphere_intersection
from endosurf_tpu_torch.ops.neus import (
    annealed_iter_cos,
    exclusive_cumprod_weights,
    merge_sorted_z,
    neus_alpha,
    upsample_weights_from_sdf,
)
from endosurf_tpu_torch.ops.pdf import sample_pdf

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class RenderSpec:
    """Static render configuration (reference YAML ``render`` section)."""
    n_samples: int = 32
    n_importance: int = 32
    up_sample_steps: int = 4
    anneal_end: float = 50000.0
    perturb: bool = True
    important_begin_iter: int = 0

    @staticmethod
    def from_config(render_cfg: Dict[str, Any]) -> "RenderSpec":
        return RenderSpec(
            n_samples=render_cfg.get("n_samples", 32),
            n_importance=render_cfg.get("n_importance", 32),
            up_sample_steps=render_cfg.get("up_sample_steps", 4),
            anneal_end=float(render_cfg.get("anneal_end", 50000)),
            perturb=render_cfg.get("perturb", True),
            important_begin_iter=render_cfg.get("important_begin_iter", 0),
        )


def _split_rays(rays: torch.Tensor):
    """Unpack [..., 9] rays into (o, d, d_z, t); d_z = d / (d_z + 1e-6) makes
    distances along the ray camera-z depths."""
    rays_o = rays[..., 0:3]
    rays_d = rays[..., 3:6]
    t = rays[..., 8:9]
    rays_d_z = rays_d / (rays_d[..., 2:3] + 1e-6)
    return rays_o, rays_d, rays_d_z, t


def cos_anneal_ratio(iter_step, anneal_end: float, device=None) -> torch.Tensor:
    """min(1, step / anneal_end) as a 0-d float32 tensor on ``device``.

    A Python step is filled on the device (no host-to-device copy, which
    would block the host until the stream drains)."""
    if anneal_end == 0.0:
        return torch.ones((), device=device)
    if torch.is_tensor(iter_step):
        step = iter_step.to(device=device, dtype=torch.float32)
    else:
        step = torch.full((), float(iter_step), dtype=torch.float32, device=device)
    return torch.clamp(step / anneal_end, max=1.0)


def _stratified_z(near: torch.Tensor, far: torch.Tensor, n_samples: int) -> torch.Tensor:
    t_vals = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype, device=near.device)
    return near + (far - near) * t_vals[None, :]


def upsample_z(spec: EndoSurfSpec, rspec: RenderSpec, params: Params,
               rays_o: torch.Tensor, rays_d_z: torch.Tensor, t: torch.Tensor,
               z_vals: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """SDF-guided importance upsampling; returns the sorted z [R, S]."""
    n_rays = z_vals.shape[0]
    n_per_step = rspec.n_importance // rspec.up_sample_steps

    def sdf_at(z):
        pts = rays_o[:, None, :] + rays_d_z[:, None, :] * z[..., None]
        tt = t[:, None, :].expand(n_rays, z.shape[1], 1)
        sdf = sdf_observed(spec, params, pts.reshape(-1, 3), tt.reshape(-1, 1),
                           precision)
        return pts, sdf.reshape(n_rays, z.shape[1])

    pts, sdf = sdf_at(z_vals)
    for i in range(rspec.up_sample_steps):
        radius = torch.linalg.norm(pts, dim=-1)
        weights = upsample_weights_from_sdf(z_vals, sdf, radius, 64.0 * 2 ** i)
        new_z = sample_pdf(z_vals, weights, n_per_step)
        if i + 1 == rspec.up_sample_steps:
            z_vals, _ = torch.sort(torch.cat([z_vals, new_z], dim=-1), dim=-1)
        else:
            _, new_sdf = sdf_at(new_z)
            z_vals, sdf = merge_sorted_z(z_vals, new_z, sdf, new_sdf)
            pts = rays_o[:, None, :] + rays_d_z[:, None, :] * z_vals[..., None]
    return z_vals


def render_core(spec: EndoSurfSpec, params: Params, rays: torch.Tensor,
                z_vals: torch.Tensor, sample_dist: float, anneal: torch.Tensor,
                precision: str = "highest") -> Dict[str, torch.Tensor]:
    """Evaluate the fields at section midpoints and composite."""
    rays_o, rays_d, rays_d_z, t = _split_rays(rays)
    n_rays, n_samples = z_vals.shape

    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], sample_dist)], dim=-1)
    mid_z = z_vals + dists * 0.5

    pts = rays_o[:, None, :] + rays_d_z[:, None, :] * mid_z[..., None]
    dirs = rays_d[:, None, :].expand(pts.shape)
    tt = t[:, None, :].expand(n_rays, n_samples, 1)
    out = fused_point_eval(spec, params, pts.reshape(-1, 3), dirs.reshape(-1, 3),
                           tt.reshape(-1, 1), precision)
    sdf = out["sdf"].reshape(n_rays, n_samples)
    color = out["color"].reshape(n_rays, n_samples, 3)
    grad_o = out["grad_o"].reshape(n_rays, n_samples, 3)

    s_inv = inv_s(params)
    true_cos = (dirs * grad_o).sum(-1)
    iter_cos = annealed_iter_cos(true_cos, anneal)
    alpha, prev_cdf = neus_alpha(sdf, iter_cos, dists, s_inv)
    weights = exclusive_cumprod_weights(alpha)
    return {
        "color_map": (weights[..., None] * color).sum(1),
        "depth_map": (weights * mid_z).sum(-1, keepdim=True),
        "gradients_o": grad_o,
        "weights": weights,
        "weight_max": weights.max(-1, keepdim=True).values,
        "cdf": prev_cdf,
        "s_val": (1.0 / s_inv).expand(n_rays, 1),
    }


def render_rays(spec: EndoSurfSpec, rspec: RenderSpec, params: Params,
                rays: torch.Tensor, iter_step, key: None = None,
                use_importance: bool = True, precision: str = "highest",
                sampling_precision: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Render rays [R, 9] deterministically (``key`` must be None: the
    perturbed training draws are not ported yet)."""
    if key is not None:
        raise NotImplementedError("perturbed sampling is not yet ported")
    rays_o, rays_d, rays_d_z, t = _split_rays(rays)
    near, far, _ = ray_sphere_intersection(rays_o, rays_d)
    sample_dist = 2.0 / rspec.n_samples
    anneal = cos_anneal_ratio(iter_step, rspec.anneal_end, rays.device)
    z_vals = _stratified_z(near, far, rspec.n_samples)
    if use_importance and rspec.n_importance > 0:
        with torch.no_grad():
            z_vals = upsample_z(spec, rspec, params, rays_o, rays_d_z, t, z_vals,
                                sampling_precision or precision)
    return render_core(spec, params, rays, z_vals, sample_dist, anneal, precision)


def render_rays_inference(spec: EndoSurfSpec, rspec: RenderSpec, params: Params,
                          rays: torch.Tensor, iter_step,
                          use_importance: bool = True, precision: str = "highest",
                          sampling_precision: Optional[str] = None
                          ) -> Dict[str, torch.Tensor]:
    """Forward-only render for the serving paths.

    Shapes the render kernel takes go to ``fused_render_rays`` (the CUDA
    kernel for GPU tensors, its plain twin for CPU tensors), which returns
    color/depth/normal/acc/weight_max maps; other shapes fall back to
    :func:`render_rays`.
    """
    from endosurf_tpu_torch.kernels.fused_render import (
        fused_render_rays,
        precision_dtype,
        render_shape_supported,
    )
    if (use_importance and rspec.n_importance > 0
            and render_shape_supported(rspec.n_samples, rspec.n_importance,
                                       rspec.up_sample_steps)):
        return fused_render_rays(
            spec, params, rays, iter_step, rspec.n_samples, rspec.n_importance,
            rspec.up_sample_steps, rspec.anneal_end,
            sampling_dtype=precision_dtype(sampling_precision or precision),
            main_dtype=precision_dtype(precision))
    return render_rays(spec, rspec, params, rays, iter_step,
                       use_importance=use_importance, precision=precision,
                       sampling_precision=sampling_precision)
