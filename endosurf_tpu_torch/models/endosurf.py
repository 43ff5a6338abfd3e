"""EndoSurf renderer (port of ``endosurf_tpu/models/endosurf.py``).

Stratified z (optionally jittered per ray), SDF-guided upsampling rounds at
sharpness 64 * 2^i, one fused field evaluation at the section midpoints, and
NeuS compositing with the Eikonal term; then the auxiliary queries of the
train step: SDF and angle error at the ground-truth depth points, and the
normal-consistency error around the surface found on the render's own
upsample samples (march reuse) or by the sphere trace. The queries' points
can ride the render's own field evaluation (``render_core``'s ``extra``:
``train.fold_aux_queries``). Their masked means come as
``ops.ratio.Ratio`` parts too (``error_on_depth_ratios``,
``surface_neighbour_ratio``, the render's ``eikonal_num`` / ``eikonal_den``)
so that a data-parallel step can take global means. ``render_on_depth``
renders colour and the SDF gradient at given depths (say, the sphere
trace's).

``render_rays`` is the differentiable training render. Its upsampling runs
without gradient through ``kernels.fused_sampler.fused_upsample_z`` (the
CUDA kernel for tensors on the GPU, the plain ``upsample_z`` for CPU
tensors). ``render_rays_inference``
is the serving entry and hands the whole pipeline to ``kernels.fused_render``.
The sampling-only SDF queries (``_sdf_sampling``: the 3D demo's mesh grid)
and the sphere trace (``ray_march``, the surface-neighbour loss with
``surf_march_reuse: false``) run ``kernels.fused_sdf.fused_sdf_observed``
and ``kernels.fused_sampler.fused_ray_march`` the same way.

Random draws (the z jitter, the neighbour offsets) come from an explicit
``torch.Generator`` or are passed in as tensors of uniforms.

Precision is explicit: ``precision`` for the field evaluations and the
auxiliary queries and ``sampling_precision`` (None = same) for the
upsampling, with the meanings of ``ops.mlp``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from endosurf_tpu_torch.models.fields import (
    EndoSurfSpec,
    fused_point_eval,
    inv_s,
    sdf_grad_observed,
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
from endosurf_tpu_torch.ops.ratio import Ratio, plus

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


def _stratified_z(near: torch.Tensor, far: torch.Tensor, n_samples: int,
                  z_uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Uniform z on [near, far], shifted per ray by (u - 0.5) * 2 / n_samples
    when ``z_uniform`` [R, 1] is given."""
    t_vals = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype, device=near.device)
    z_vals = near + (far - near) * t_vals[None, :]
    if z_uniform is not None:
        z_vals = z_vals + (z_uniform - 0.5) * (2.0 / n_samples)
    return z_vals


def _sdf_sampling(spec: EndoSurfSpec, params: Params, x: torch.Tensor, t: torch.Tensor,
                  precision: str = "highest") -> torch.Tensor:
    """SDF [N, 1] for sampling-only consumers (no gradient):
    ``fused_sdf_observed``, the CUDA kernel for CUDA tensors at every N and
    the plain ``sdf_observed`` for CPU tensors. The dots follow
    ``precision`` (bf16 operands for "default")."""
    from endosurf_tpu_torch.kernels.fused_render import precision_dtype
    from endosurf_tpu_torch.kernels.fused_sdf import fused_sdf_observed
    return fused_sdf_observed(spec, params, x, t, precision_dtype(precision))


def upsample_z(spec: EndoSurfSpec, rspec: RenderSpec, params: Params,
               rays_o: torch.Tensor, rays_d_z: torch.Tensor, t: torch.Tensor,
               z_vals: torch.Tensor, precision: str = "highest",
               return_sdf: bool = False):
    """SDF-guided importance upsampling; returns the sorted z [R, S], or
    (z, sdf) with ``return_sdf`` (the last round's new samples then get
    their SDF too)."""
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
        if i + 1 == rspec.up_sample_steps and not return_sdf:
            z_vals, _ = torch.sort(torch.cat([z_vals, new_z], dim=-1), dim=-1)
        else:
            _, new_sdf = sdf_at(new_z)
            z_vals, sdf = merge_sorted_z(z_vals, new_z, sdf, new_sdf)
            pts = rays_o[:, None, :] + rays_d_z[:, None, :] * z_vals[..., None]
    return (z_vals, sdf) if return_sdf else z_vals


def render_core(spec: EndoSurfSpec, params: Params, rays: torch.Tensor,
                z_vals: torch.Tensor, sample_dist: float, anneal: torch.Tensor,
                precision: str = "highest", megakernel: str = "auto",
                extra: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """Evaluate the fields at section midpoints (``fused_point_eval`` with
    ``megakernel``), composite, and take the Eikonal error inside the relaxed
    sphere |x| < 1.2.

    ``extra`` (points, dirs [E, 3], t [E, 1]) is appended to the sample
    points for the same field evaluation and comes back as ``extra_sdf``
    [E, 1] and ``extra_grad`` [E, 3], differentiable (second order through
    the gradient): the train step's folded auxiliary queries
    (``train.fold_aux_queries``)."""
    pts, dirs, tt, mid_z, dists = section_midpoints(rays, z_vals, sample_dist)
    x, d, t = pts.reshape(-1, 3), dirs.reshape(-1, 3), tt.reshape(-1, 1)
    n_core = x.shape[0]
    if extra is not None:
        x, d, t = (torch.cat([a, b], dim=0) for a, b in zip((x, d, t), extra))
    out = fused_point_eval(spec, params, x, d, t, precision, megakernel)
    if extra is None:
        return composite(params, out, pts, dirs, mid_z, dists, anneal)
    res = composite(params, {k: v[:n_core] for k, v in out.items()}, pts, dirs, mid_z, dists,
                    anneal)
    res["extra_sdf"] = out["sdf"][n_core:, None]
    res["extra_grad"] = out["grad_o"][n_core:]
    return res


def section_midpoints(rays: torch.Tensor, z_vals: torch.Tensor, sample_dist: float):
    """(pts, dirs [R, S, 3], t [R, S, 1], mid_z, dists [R, S]) at the
    midpoints of the sections that ``z_vals`` [R, S] bound; the last section
    is ``sample_dist`` long."""
    rays_o, rays_d, rays_d_z, t = _split_rays(rays)
    n_rays, n_samples = z_vals.shape
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], sample_dist)], dim=-1)
    mid_z = z_vals + dists * 0.5
    pts = rays_o[:, None, :] + rays_d_z[:, None, :] * mid_z[..., None]
    dirs = rays_d[:, None, :].expand(pts.shape)
    return pts, dirs, t[:, None, :].expand(n_rays, n_samples, 1), mid_z, dists


def composite(params: Params, out: Dict[str, torch.Tensor], pts: torch.Tensor,
              dirs: torch.Tensor, mid_z: torch.Tensor, dists: torch.Tensor,
              anneal: torch.Tensor) -> Dict[str, torch.Tensor]:
    """NeuS compositing of the field values ``out`` (``fused_point_eval``'s,
    flat over the [R, S] midpoints) and the Eikonal error."""
    n_rays, n_samples = mid_z.shape
    sdf = out["sdf"].reshape(n_rays, n_samples)
    color = out["color"].reshape(n_rays, n_samples, 3)
    grad_o = out["grad_o"].reshape(n_rays, n_samples, 3)

    s_inv = inv_s(params)
    true_cos = (dirs * grad_o).sum(-1)
    iter_cos = annealed_iter_cos(true_cos, anneal)
    alpha, prev_cdf = neus_alpha(sdf, iter_cos, dists, s_inv)
    weights = exclusive_cumprod_weights(alpha)

    relax_inside = (torch.linalg.norm(pts, dim=-1) < 1.2).to(sdf.dtype).detach()
    grad_err = (torch.linalg.norm(grad_o, dim=-1) - 1.0) ** 2
    eikonal_num, eikonal_den = (relax_inside * grad_err).sum(), relax_inside.sum()
    return {
        "color_map": (weights[..., None] * color).sum(1),
        "depth_map": (weights * mid_z).sum(-1, keepdim=True),
        "gradients_o": grad_o,
        "gradient_o_error": eikonal_num / (eikonal_den + 1e-6),
        "eikonal_num": eikonal_num,        # the Eikonal mean's parts (data parallel)
        "eikonal_den": eikonal_den,
        "weights": weights,
        "weight_max": weights.max(-1, keepdim=True).values,
        "cdf": prev_cdf,
        "s_val": (1.0 / s_inv).expand(n_rays, 1),
    }


def render_rays(spec: EndoSurfSpec, rspec: RenderSpec, params: Params,
                rays: torch.Tensor, iter_step,
                generator: Optional[torch.Generator] = None,
                z_uniform: Optional[torch.Tensor] = None,
                use_importance: bool = True, precision: str = "highest",
                sampling_precision: Optional[str] = None,
                return_upsample: bool = False, megakernel: str = "auto",
                extra: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """Render rays [R, 9].

    With ``rspec.perturb``, the per-ray z jitter is ``z_uniform`` [R, 1]
    when given, else drawn from ``generator``; with neither the render is
    deterministic. ``return_upsample`` adds the upsample stage's (z, sdf) as
    ``up_z`` / ``up_sdf`` [R, S]. The upsampling is ``fused_upsample_z``:
    on GPU tensors the CUDA kernel, which raises for sample counts it cannot
    take. ``megakernel`` picks the field evaluation's path
    (``fields.fused_point_eval``); ``extra`` points ride its evaluation
    (:func:`render_core`).
    """
    rays_o, rays_d, rays_d_z, t = _split_rays(rays)
    near, far, _ = ray_sphere_intersection(rays_o, rays_d)
    sample_dist = 2.0 / rspec.n_samples
    anneal = cos_anneal_ratio(iter_step, rspec.anneal_end, rays.device)
    if rspec.perturb and z_uniform is None and generator is not None:
        z_uniform = torch.rand(rays.shape[0], 1, generator=generator, device=rays.device,
                               dtype=rays.dtype)
    z_vals = _stratified_z(near, far, rspec.n_samples,
                           z_uniform if rspec.perturb else None)

    importance = use_importance and rspec.n_importance > 0
    if return_upsample and not importance:
        raise ValueError("return_upsample requires the importance stage")
    up_sdf = None
    if importance:
        from endosurf_tpu_torch.kernels.fused_render import precision_dtype
        from endosurf_tpu_torch.kernels.fused_sampler import fused_upsample_z
        res = fused_upsample_z(spec, params, rays_o, rays_d_z, t, z_vals,
                               rspec.n_importance, rspec.up_sample_steps,
                               precision_dtype(sampling_precision or precision),
                               return_upsample)
        z_vals, up_sdf = res if return_upsample else (res, None)

    out = render_core(spec, params, rays, z_vals, sample_dist, anneal, precision, megakernel,
                      extra)
    if return_upsample:
        out["up_z"] = z_vals
        out["up_sdf"] = up_sdf
    return out


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


# ---------------------------------------------------------------------------
# depth-supervision and surface-regularization queries
# ---------------------------------------------------------------------------

def depth_points(rays: torch.Tensor, depth_gt: torch.Tensor) -> torch.Tensor:
    """Ground-truth depth points along rays: o + d_z * depth."""
    rays_o, _, rays_d_z, _ = _split_rays(rays)
    return rays_o + rays_d_z * depth_gt


def error_on_depth_ratios(sdf: torch.Tensor, grad: torch.Tensor, pts: torch.Tensor,
                          rays: torch.Tensor, mask: torch.Tensor
                          ) -> Tuple[Ratio, Ratio, torch.Tensor]:
    """The SDF and angle error at the depth points as Ratios of these rays'
    sums (``parallel.mesh.global_means`` resolves them), and the valid
    region [R, 1].

    The angle error divides the UNMASKED relu-cos sum by the masked count,
    as the JAX package (and the reference it follows) does."""
    rays_d = rays[..., 3:6]
    relu_cos = torch.relu((rays_d * grad).sum(-1, keepdim=True))
    pts_norm = torch.linalg.norm(pts.detach(), dim=-1, keepdim=True)
    inside_masksphere = (pts_norm < 1.0).to(sdf.dtype) * mask
    count = inside_masksphere.sum()
    return (Ratio((inside_masksphere * sdf).abs().sum(), count, plus(1e-6)),
            Ratio(relu_cos.abs().sum(), count, plus(1e-6)), inside_masksphere)


def error_on_depth(spec: EndoSurfSpec, params: Params, rays: torch.Tensor,
                   depth_gt: torch.Tensor, mask: torch.Tensor,
                   precision: str = "highest"
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sdf_error, angle_error, valid_region [R, 1]) at the depth points."""
    t = rays[..., 8:9]
    pts = depth_points(rays, depth_gt)
    sdf = sdf_observed(spec, params, pts, t, precision)
    grad = sdf_grad_observed(spec, params, pts, t, precision)
    sdf_error, angle_error, inside = error_on_depth_ratios(sdf, grad, pts, rays, mask)
    return sdf_error.value(), angle_error.value(), inside


def _locate_crossing(spec: EndoSurfSpec, params: Params, rays_o: torch.Tensor,
                     rays_d_z: torch.Tensor, t: torch.Tensor, d_prop: torch.Tensor,
                     val: torch.Tensor, near: torch.Tensor, far: torch.Tensor,
                     tau: float, n_secant: int, precision: str = "highest", sdf_at=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """First + -> - crossing of ``val = -(sdf - tau)`` over the ascending
    depth proposals ``d_prop`` [R, S], refined by ``n_secant`` secant steps
    (0: the crossing pair's interpolation). Returns (depth [R, 1], valid
    [R, 1], bracket); invalid rays get the chord midpoint; the bracket holds
    the final d_low, d_high [R] and the crossing's index idx [R]. The secant
    steps' SDF: ``sdf_at(z)`` (depths [R, 1] -> [R, 1]) when given, else
    ``sdf_observed`` at o + z d_z at ``precision``."""
    n_rays, n_steps = d_prop.shape
    if sdf_at is None:
        def sdf_at(z):
            return sdf_observed(spec, params, rays_o + z * rays_d_z, t, precision)
    first_free = val[:, 0] < 0
    sign = torch.sign(val[:, :-1] * val[:, 1:])
    sign = torch.cat([sign, torch.ones_like(sign[:, :1])], dim=-1)
    cost = sign * torch.arange(n_steps, 0, -1, dtype=val.dtype, device=val.device)[None, :]
    idx = torch.argmin(cost, dim=-1, keepdim=True)
    cost_min = torch.gather(cost, -1, idx)[:, 0]
    val_at = torch.gather(val, -1, idx)[:, 0]
    valid = (cost_min < 0) & (val_at < 0) & first_free

    idx_hi = torch.clamp(idx + 1, max=n_steps - 1)
    d_low = torch.gather(d_prop, -1, idx)[:, 0]
    f_low = val_at
    d_high = torch.gather(d_prop, -1, idx_hi)[:, 0]
    f_high = torch.gather(val, -1, idx_hi)[:, 0]

    d_pred = -f_low * (d_high - d_low) / (f_high - f_low + 1e-12) + d_low
    for _ in range(n_secant):
        f_mid = -(sdf_at(d_pred[:, None])[:, 0] - tau)
        low = f_mid < 0
        d_low = torch.where(low, d_pred, d_low)
        f_low = torch.where(low, f_mid, f_low)
        d_high = torch.where(low, d_high, d_pred)
        f_high = torch.where(low, f_high, f_mid)
        d_pred = -f_low * (d_high - d_low) / (f_high - f_low + 1e-12) + d_low

    d_safe = torch.where(valid, d_pred, 0.5 * (near[:, 0] + far[:, 0]))
    return d_safe[:, None], valid[:, None], {"d_low": d_low, "d_high": d_high,
                                             "idx": idx[:, 0]}


def march_math(spec: EndoSurfSpec, params: Params, rays_o: torch.Tensor,
               rays_d_z: torch.Tensor, t: torch.Tensor, near: torch.Tensor,
               far: torch.Tensor, tau: float = 0.0, n_steps: int = 128, n_secant: int = 8,
               precision: str = "highest", sdf_at=None) -> Dict[str, torch.Tensor]:
    """The sphere trace in plain PyTorch (``fused_ray_march``'s plain
    version): the SDF at ``n_steps`` depths linspace(near, far), the first
    + -> - crossing and ``n_secant`` secant steps, every SDF at
    ``precision`` (or, given ``sdf_at``, ``sdf_at(z)``: depths [R, K] ->
    the SDF there [R, K]). Returns depth, valid [R, 1] and the final bracket
    d_low, d_high [R] with the crossing's index idx [R]."""
    n_rays = rays_o.shape[0]
    t_vals = torch.linspace(0.0, 1.0, n_steps, dtype=rays_o.dtype, device=rays_o.device)
    d_prop = near * (1.0 - t_vals)[None, :] + far * t_vals[None, :]
    if sdf_at is None:
        pts = rays_o[:, None, :] + d_prop[..., None] * rays_d_z[:, None, :]
        tt = t[:, None, :].expand(n_rays, n_steps, 1)
        sdf = sdf_observed(spec, params, pts.reshape(-1, 3), tt.reshape(-1, 1),
                           precision).reshape(n_rays, n_steps)
    else:
        sdf = sdf_at(d_prop)
    depth, valid, br = _locate_crossing(spec, params, rays_o, rays_d_z, t, d_prop,
                                        -(sdf - tau), near, far, tau, n_secant, precision,
                                        sdf_at)
    return {"depth": depth, "valid": valid, **br}


def ray_march(spec: EndoSurfSpec, params: Params, rays: torch.Tensor, tau: float = 0.0,
              n_steps: int = 128, n_secant: int = 8, precision: str = "highest"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sphere-traced surface depths along rays [R, 9]: (depth [R, 1], valid
    [R, 1]), without gradient. ``fused_ray_march``: the CUDA kernel for CUDA
    tensors, ``march_math`` for CPU tensors; every SDF at ``precision``."""
    from endosurf_tpu_torch.kernels.fused_render import precision_dtype
    from endosurf_tpu_torch.kernels.fused_sampler import fused_ray_march
    rays_o, rays_d, rays_d_z, t = _split_rays(rays)
    near, far, _ = ray_sphere_intersection(rays_o, rays_d)
    with torch.no_grad():
        out = fused_ray_march(spec, params, rays_o, rays_d_z, t, near, far, tau, n_steps,
                              n_secant, precision_dtype(precision))
    return out["depth"], out["valid"]


def surface_from_samples(spec: EndoSurfSpec, params: Params, rays: torch.Tensor,
                         z_vals: torch.Tensor, sdf: torch.Tensor, tau: float = 0.0,
                         n_secant: int = 0, precision: str = "highest"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Surface depth on the render's own upsample samples (march reuse):
    the same crossing rule and validity contract as the sphere trace."""
    rays_o, rays_d, rays_d_z, t = _split_rays(rays)
    near, far, _ = ray_sphere_intersection(rays_o, rays_d)
    depth, valid, _ = _locate_crossing(spec, params, rays_o, rays_d_z, t, z_vals,
                                       -(sdf - tau), near, far, tau, n_secant, precision)
    return depth, valid


def surface_neighbour_points(spec: EndoSurfSpec, params: Params, rays: torch.Tensor,
                             mask: torch.Tensor, neighbour_rad: float = 0.05,
                             samples: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                             n_secant_reuse: int = 0,
                             generator: Optional[torch.Generator] = None,
                             offset_uniform: Optional[torch.Tensor] = None,
                             precision: str = "highest"
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Surface points and their neighbours: (pts2 [2R, 3] -- surface points,
    then neighbours -- and valid [R, 1]).

    The surface comes from ``samples`` (the render's (up_z, up_sdf): march
    reuse) or, without them, from the sphere trace ``ray_march``; both run
    without gradient at ``precision``. The neighbour offsets are (u - 0.5) *
    neighbour_rad with u = ``offset_uniform`` [R, 3] or drawn from
    ``generator``."""
    rays_o, _, rays_d_z, _ = _split_rays(rays)
    with torch.no_grad():
        if samples is None:
            d_surf, valid = ray_march(spec, params, rays, precision=precision)
        else:
            up_z, up_sdf = samples
            d_surf, valid = surface_from_samples(spec, params, rays, up_z, up_sdf,
                                                 n_secant=n_secant_reuse,
                                                 precision=precision)
    valid = valid & (mask == 1)
    p_surf = rays_o + d_surf * rays_d_z
    if offset_uniform is None:
        if generator is None:
            raise ValueError("surface_neighbour_points needs a generator or offset_uniform")
        offset_uniform = torch.rand(p_surf.shape, generator=generator, device=p_surf.device,
                                    dtype=p_surf.dtype)
    p_neig = p_surf + (offset_uniform - 0.5) * neighbour_rad
    return torch.cat([p_surf, p_neig], dim=0), valid


def surface_neighbour_ratio(g2: torch.Tensor, valid: torch.Tensor) -> Ratio:
    """Mean |n(surface) - n(neighbour)| over valid rays and the 3 axes, as a
    Ratio of these rays' sums; the count's floor of 1 applies to the global
    count."""
    n_rays = g2.shape[0] // 2
    normal = g2 / (torch.linalg.norm(g2, dim=-1, keepdim=True) + 1e-10)
    diff = (normal[:n_rays] - normal[n_rays:]).abs()
    valid_f = valid.to(diff.dtype)
    return Ratio((diff * valid_f).sum(), valid_f.sum(),
                 lambda den: torch.clamp(den * 3.0, min=1.0))


def surface_neighbour_error(spec: EndoSurfSpec, params: Params, rays: torch.Tensor,
                            mask: torch.Tensor, neighbour_rad: float = 0.05,
                            samples: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                            n_secant_reuse: int = 0,
                            generator: Optional[torch.Generator] = None,
                            offset_uniform: Optional[torch.Tensor] = None,
                            precision: str = "highest",
                            sampling_precision: Optional[str] = None) -> torch.Tensor:
    """Normal-consistency regularizer near the surface, a masked mean. The
    surface search runs at ``sampling_precision``, the gradients at
    ``precision``."""
    t = rays[..., 8:9]
    pts2, valid = surface_neighbour_points(
        spec, params, rays, mask, neighbour_rad, samples, n_secant_reuse, generator,
        offset_uniform, sampling_precision or precision)
    g = sdf_grad_observed(spec, params, pts2, torch.cat([t, t], dim=0), precision)
    return surface_neighbour_ratio(g, valid).value()


def render_on_depth(spec: EndoSurfSpec, params: Params, rays: torch.Tensor,
                    depth: torch.Tensor, valid: torch.Tensor,
                    precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """Surface rendering at given depths [R, 1]: (colour [R, 3], observed SDF
    gradient grad_o [R, 3]), both zero where ``valid`` [R, 1] is false. The
    points o + d_z * depth go through ``fields.fused_point_eval`` (on CUDA
    tensors the segment forward kernels)."""
    rays_o, rays_d, rays_d_z, t = _split_rays(rays)
    pts = rays_o + rays_d_z * depth
    out = fused_point_eval(spec, params, pts, rays_d, t, precision)
    valid_f = valid.to(pts.dtype)
    return out["color"] * valid_f, out["grad_o"] * valid_f
