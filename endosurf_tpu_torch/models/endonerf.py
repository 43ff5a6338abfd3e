"""EndoNeRF: the D-NeRF density baseline (port of
``endosurf_tpu/models/endonerf.py``).

Deform + density + colour MLPs: plain ``{w, b}`` layers (no weight norm),
relu hidden layers, skips that concatenate the encoding unscaled. A density
net's output is 1 + geo_feat_dim wide: column 0 is the raw density (relu'd
by ``field_eval``), the rest the feature the colour net reads beside the
encoded view direction. Compositing is ``alpha = 1 - exp(-sigma * delta)``
with a disparity-normalised depth.

Depth-guided sampling: with ``use_depth_sampling`` ray slots 6/7 carry (gt
depth mean, sigma) instead of (near, far), and the initial depths are a
sorted normal draw (``kernels.fused_render_dnerf.init_z``).

``render_rays`` is the eval render (the JAX ``key=None`` path: no
perturbation, no density noise); ``render_rays_inference`` sends the shapes
the render kernel takes to ``fused_render_rays_dnerf`` (the CUDA kernel on
the card, its plain twin on the CPU); ``render_rays_train`` is the train
render (the JAX path with a key): every random draw comes from one
``torch.Generator`` or is passed in (``draws``). The field evaluation
(``field_eval``) runs the three D-NeRF segments, forward and backward, as
kernels on the card and as their plain versions on the CPU
(``fused_train_dnerf.megakernel_field_raw``); the sampling-only density
(``density_observed``) runs ``fused_density_raw`` and the deterministic
importance draws of both renders ``fused_sampler.fused_fine_resample``. The
surface queries -- ``density_grad_observed``, ``render_on_depth`` and
``render_rays(..., want_normals=True)`` -- take their normals from
``torch.autograd.grad`` of the plain chain (see ``density_grad_observed``).
Matmul precision is an explicit argument (``ops.mlp``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from endosurf_tpu_torch.ops.encoding import freq_encode, freq_encode_dim
from endosurf_tpu_torch.ops.mlp import init_skip_mlp, skip_mlp_apply

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DNeRFSpec:
    use_deform: bool = True
    bound: float = 1.5
    raw_noise_std: float = 1.0
    pos_density_freqs: int = 10
    dir_color_freqs: int = 4
    time_deform_freqs: int = 10
    pos_deform_freqs: int = 10
    deform_layers: Tuple[int, int, Tuple[int, ...]] = (9, 256, (5,))
    density_layers: Tuple[int, int, Tuple[int, ...]] = (9, 256, (5,))
    color_layers: Tuple[int, int, Tuple[int, ...]] = (2, 128, ())
    geo_feat_dim: int = 256

    @staticmethod
    def from_config(net_cfg: Dict[str, Any]) -> "DNeRFSpec":
        def layers(sec):
            return (sec.get("n_layers", 9), sec.get("hidden_dim", 256),
                    tuple(sec.get("skips", [])))
        return DNeRFSpec(
            use_deform=net_cfg.get("use_deform", True),
            bound=net_cfg.get("bound", 1.5),
            raw_noise_std=net_cfg.get("raw_noise_std", 1.0),
            pos_density_freqs=net_cfg.get("enc_pos_density_cfg", {}).get("multires", 10),
            dir_color_freqs=net_cfg.get("enc_dir_color_cfg", {}).get("multires", 4),
            time_deform_freqs=net_cfg.get("enc_time_deform_cfg", {}).get("multires", 10),
            pos_deform_freqs=net_cfg.get("enc_pos_deform_cfg", {}).get("multires", 10),
            deform_layers=layers(net_cfg.get("net_deform_cfg", {})),
            density_layers=layers(net_cfg.get("net_density_cfg", {})),
            color_layers=layers(net_cfg.get("net_color_cfg", {})),
            geo_feat_dim=net_cfg.get("geo_feat_dim", 256),
        )


@dataclasses.dataclass(frozen=True)
class DNeRFRenderSpec:
    n_samples: int = 64
    n_importance: int = 64
    perturb: bool = True
    use_depth_sampling: bool = True
    depth_sampling_sigma: float = 1.0

    @staticmethod
    def from_config(render_cfg: Dict[str, Any]) -> "DNeRFRenderSpec":
        return DNeRFRenderSpec(
            n_samples=render_cfg.get("n_samples", 64),
            n_importance=render_cfg.get("n_importance", 64),
            perturb=render_cfg.get("perturb", True),
            use_depth_sampling=render_cfg.get("use_depth_sampling", True),
            depth_sampling_sigma=render_cfg.get("depth_sampling_sigma", 1.0),
        )


def deform_in_dim(spec: DNeRFSpec) -> int:
    return freq_encode_dim(3, spec.pos_deform_freqs) + freq_encode_dim(1, spec.time_deform_freqs)


def init_dnerf_params(spec: DNeRFSpec, generator: Optional[torch.Generator] = None,
                      device: Any = "cpu") -> Params:
    """Plain torch-default Linears (the JAX init's distributions), drawn on
    the CPU ``generator`` (seed 0 without one) and moved to ``device``."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    params: Params = {}
    if spec.use_deform:
        n, h, s = spec.deform_layers
        params["deform"] = init_skip_mlp(n, h, deform_in_dim(spec), 3, s, style="nerf",
                                         weight_norm=False, generator=gen, device=device)
    n, h, s = spec.density_layers
    params["density"] = init_skip_mlp(n, h, freq_encode_dim(3, spec.pos_density_freqs),
                                      1 + spec.geo_feat_dim, s, style="nerf",
                                      weight_norm=False, generator=gen, device=device)
    n, h, s = spec.color_layers
    params["color"] = init_skip_mlp(n, h, freq_encode_dim(3, spec.dir_color_freqs)
                                    + spec.geo_feat_dim, 3, s, style="nerf",
                                    weight_norm=False, generator=gen, device=device)
    return params


def _warp(spec: DNeRFSpec, params: Params, x, t, precision: str):
    """x + deform(enc(x, t)) (x without the deform net): the sampling chain's
    warp, coordinates unrounded (``fused_density_raw``'s plain version)."""
    if not spec.use_deform:
        return x
    enc = torch.cat([freq_encode(x, spec.pos_deform_freqs),
                     freq_encode(t, spec.time_deform_freqs)], dim=-1)
    return x + skip_mlp_apply(params["deform"], enc, spec.deform_layers[2], "relu", 1.0,
                              precision)


def _density_feat(spec: DNeRFSpec, params: Params, x_c, precision: str):
    enc = freq_encode(x_c, spec.pos_density_freqs)
    return skip_mlp_apply(params["density"], enc, spec.density_layers[2], "relu", 1.0,
                          precision)


def field_eval(spec: DNeRFSpec, params: Params, x, d, t,
               generator: Optional[torch.Generator] = None, precision: str = "highest",
               noise: Optional[torch.Tensor] = None):
    """(x, d, t) -> (rgb [N, 3], sigma [N]): relu of the raw density, with
    Gaussian noise (``raw_noise_std`` times ``noise`` [N], or a draw from
    ``generator``) on the raw density before the relu when either is given
    (the train-time noise). The field is
    ``fused_train_dnerf.megakernel_field_raw``: the segment kernels for CUDA
    tensors, their plain versions for CPU tensors."""
    from endosurf_tpu_torch.kernels.fused_train_dnerf import megakernel_field_raw
    rgb, raw = megakernel_field_raw(spec, params, x, d, t, precision)
    if spec.raw_noise_std > 0 and (noise is not None or generator is not None):
        if noise is None:
            noise = torch.randn(raw.shape, generator=generator, device=raw.device,
                                dtype=raw.dtype)
        raw = raw + spec.raw_noise_std * noise
    return rgb, torch.relu(raw)


def density_observed(spec: DNeRFSpec, params: Params, x, t, precision: str = "highest"):
    """Raw (pre-relu) density [N, 1] for sampling-only consumers and the
    isosurface, without gradient: ``fused_density_raw``, the CUDA kernel for
    CUDA tensors at every N, the plain chain for CPU tensors."""
    from endosurf_tpu_torch.kernels.fused_render import precision_dtype
    from endosurf_tpu_torch.kernels.fused_sdf import fused_density_raw
    return fused_density_raw(spec, params, x, t, precision_dtype(precision))


def density_grad_observed(spec: DNeRFSpec, params: Params, x: torch.Tensor, t: torch.Tensor,
                          precision: str = "highest") -> torch.Tensor:
    """d raw sigma / d x [N, 3] at observed points, through the warp: (I + d
    deform / d x)^T d sigma / d x_c. Callers negate it for normals. Under
    grad mode the result is differentiable with respect to the parameters.

    It is ``torch.autograd.grad`` of the plain chain ``_warp`` +
    ``_density_feat``, on any device, as JAX takes ``jax.grad`` of its plain
    chain at one point. Not the segment Functions: ``fused_density_raw`` has
    no gradient, and the deform segment gives its input no cotangent
    (``fused_train_dnerf.SegDeform``), so autograd through
    ``megakernel_field_raw`` would drop the deform Jacobian without an
    error."""
    create_graph = torch.is_grad_enabled()
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        raw = _density_feat(spec, params, _warp(spec, params, xg, t, precision), precision)
        (grad,) = torch.autograd.grad(raw[:, 0].sum(), xg, create_graph=create_graph)
    return grad


def _normals(spec: DNeRFSpec, params: Params, x: torch.Tensor, t: torch.Tensor,
             precision: str) -> torch.Tensor:
    """-grad / (|grad| + 1e-10) of ``density_grad_observed``."""
    grad = -density_grad_observed(spec, params, x, t, precision)
    return grad / (torch.linalg.norm(grad, dim=-1, keepdim=True) + 1e-10)


def render_on_depth(spec: DNeRFSpec, params: Params, rays: torch.Tensor, depth: torch.Tensor,
                    valid: torch.Tensor, precision: str = "highest"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Surface rendering at given depths [R, 1]: (rgb [R, 3] from
    ``field_eval``, normal [R, 3] from -``density_grad_observed``), both zero
    where ``valid`` [R, 1] is false."""
    rays_o, rays_d, rays_d_z, _, _, t = split_rays(rays)
    pts = rays_o + rays_d_z * depth
    rgb, _ = field_eval(spec, params, pts, rays_d, t, precision=precision)
    valid_f = valid.to(pts.dtype)
    return rgb * valid_f, _normals(spec, params, pts, t, precision) * valid_f


def raw2outputs(rgb, sigma, z_vals, rays_d):
    """Density compositing with disparity-normalised depth: (rgb_map [R, 3],
    depth_map [R, 1], weights [R, K])."""
    from endosurf_tpu_torch.ops.neus import exclusive_cumprod_weights
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    d_norm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-sigma * (dists * d_norm))
    weights = exclusive_cumprod_weights(alpha, eps=1e-10)
    rgb_map = (weights[..., None] * rgb).sum(1)
    depth_raw = (weights * z_vals * d_norm).sum(-1)
    disp = 1.0 / torch.clamp(depth_raw / (weights.sum(-1) + 1e-6), min=1e-10)
    return rgb_map, (1.0 / (disp + 1e-6))[..., None], weights


def split_rays(rays: torch.Tensor):
    """rays [R, 9] -> (o, d, d_z = d / (d_z + 1e-5), slot 6, slot 7, t)."""
    rays_o, rays_d = rays[..., 0:3], rays[..., 3:6]
    return (rays_o, rays_d, rays_d / (rays_d[..., 2:3] + 1e-5), rays[..., 6:7],
            rays[..., 7:8], rays[..., 8:9])


def render_pipeline(rspec: DNeRFRenderSpec, rays: torch.Tensor, z_vals: torch.Tensor,
                    coarse_raw, field_raw, n_importance: int, resample=None
                    ) -> Dict[str, torch.Tensor]:
    """The eval render on given initial depths ``z_vals`` [R, n0]:
    ``coarse_raw(x, t) -> raw sigma [N, 1]`` at the initial depths, the
    importance resampling ``resample(z, sigma, |d|, n_importance)`` (default
    the plain ``fused_sampler.fine_resample_math``) when ``n_importance``,
    ``field_raw(x, d, t) -> (rgb, raw sigma [N])`` at all depths,
    raw2outputs. Returns color_map, depth_map, weights and the final depths
    z_vals [R, K]."""
    from endosurf_tpu_torch.kernels.fused_sampler import fine_resample_math
    resample = resample or fine_resample_math
    rays_o, rays_d, rays_d_z, _, _, t = split_rays(rays)
    n_rays = rays.shape[0]

    def points(z):
        pts = rays_o[:, None, :] + rays_d_z[:, None, :] * z[..., None]
        tt = t[:, None, :].expand(n_rays, z.shape[1], 1)
        return pts.reshape(-1, 3), tt.reshape(-1, 1)

    if n_importance > 0:
        raw_c = coarse_raw(*points(z_vals))[:, 0].reshape(n_rays, -1)
        z_vals = resample(z_vals, torch.relu(raw_c),
                          torch.linalg.norm(rays_d, dim=-1, keepdim=True), n_importance)
    pts, tt = points(z_vals)
    dirs = rays_d[:, None, :].expand(n_rays, z_vals.shape[1], 3).reshape(-1, 3)
    rgb, raw = field_raw(pts, dirs, tt)
    rgb_map, depth_map, weights = raw2outputs(
        rgb.reshape(n_rays, -1, 3), torch.relu(raw).reshape(n_rays, -1), z_vals, rays_d)
    return {"color_map": rgb_map, "depth_map": depth_map, "weights": weights, "z_vals": z_vals}


def render_rays(spec: DNeRFSpec, rspec: DNeRFRenderSpec, params: Params, rays: torch.Tensor,
                precision: str = "highest", sampling_precision: Optional[str] = None,
                use_importance: bool = True, eps: Optional[torch.Tensor] = None,
                want_normals: bool = False) -> Dict[str, torch.Tensor]:
    """The eval render of a ray batch [R, 9] (JAX ``render_rays`` with
    key=None: initial depths from ``init_z``, the coarse density at the
    sampling precision through ``density_observed``, the deterministic
    importance draws -- ``fused_sampler.fused_fine_resample`` where its
    kernel takes the shape, else ``fine_resample_math`` --, the fields
    through ``megakernel_field_raw``, no noise): color_map, depth_map,
    weights, z_vals. ``want_normals`` adds normal_map [R, 3], the weighted
    sum of -``density_grad_observed`` (normalised) at the fine points."""
    from endosurf_tpu_torch.kernels.fused_render_dnerf import init_z
    from endosurf_tpu_torch.kernels.fused_sampler import (
        fine_resample_math,
        fine_resample_shape_supported,
        fused_fine_resample,
    )
    from endosurf_tpu_torch.kernels.fused_train_dnerf import megakernel_field_raw
    sp = sampling_precision or precision
    n_importance = rspec.n_importance if use_importance else 0
    with torch.no_grad():
        z_vals = init_z(rspec, rays, eps)
    resample = (fused_fine_resample
                if fine_resample_shape_supported(z_vals.shape[1], n_importance)
                else fine_resample_math)
    out = render_pipeline(
        rspec, rays, z_vals,
        lambda x, t: density_observed(spec, params, x, t, sp),
        lambda x, d, t: megakernel_field_raw(spec, params, x, d, t, precision),
        n_importance, resample)
    if want_normals:
        rays_o, _, rays_d_z, _, _, t = split_rays(rays)
        z = out["z_vals"]
        pts = rays_o[:, None, :] + rays_d_z[:, None, :] * z[..., None]
        tt = t[:, None, :].expand(*z.shape, 1)
        normal = _normals(spec, params, pts.reshape(-1, 3), tt.reshape(-1, 1), precision)
        out["normal_map"] = (out["weights"][..., None] * normal.reshape(*z.shape, 3)).sum(1)
    return out


def _train_draw(name: str, shape, normal: bool, generator: Optional[torch.Generator],
                draws: Dict[str, torch.Tensor], device) -> torch.Tensor:
    """Draw ``name`` of the train render: given in ``draws``, else from
    ``generator`` (a normal or a uniform draw of ``shape``)."""
    if name in draws:
        out = draws[name].to(device=device, dtype=torch.float32)
        if tuple(out.shape) != tuple(shape):
            raise ValueError(f"draw {name}: expected shape {tuple(shape)}, got "
                             f"{tuple(out.shape)}")
        return out
    if generator is None:
        raise ValueError(f"the train render needs draw {name!r} or a generator")
    fn = torch.randn if normal else torch.rand
    return fn(shape, generator=generator, device=device)


def train_draws(spec: DNeRFSpec, rspec: DNeRFRenderSpec, n_rays: int,
                generator: Optional[torch.Generator], draws: Dict[str, torch.Tensor],
                device) -> Dict[str, torch.Tensor]:
    """``draws`` with every draw of the train render of ``n_rays`` rays added
    (:func:`render_rays_train` names them), each from ``generator`` unless
    given, in the order the render takes them: "z", "noise_c", "u_pdf",
    "noise_f"."""
    out = dict(draws)
    n0, n_imp = rspec.n_samples, rspec.n_importance

    def take(name, shape, normal):
        out[name] = _train_draw(name, shape, normal, generator, draws, device)

    if rspec.use_depth_sampling or rspec.perturb:
        take("z", (n_rays, n0), rspec.use_depth_sampling)
    if n_imp > 0 and spec.raw_noise_std > 0:
        take("noise_c", (n_rays * n0,), True)
    if n_imp > 0 and not rspec.perturb:
        take("u_pdf", (n_rays, n_imp), False)
    if spec.raw_noise_std > 0:
        take("noise_f", (n_rays * (n0 + n_imp),), True)
    return out


def render_rays_train(spec: DNeRFSpec, rspec: DNeRFRenderSpec, params: Params,
                      rays: torch.Tensor, precision: str = "highest",
                      sampling_precision: Optional[str] = None,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
    """The train render of a ray batch [R, 9] (JAX ``render_rays`` with a
    key): {color_map [R, 3], depth_map [R, 1], weights [R, K]}, differentiable
    in ``params`` through the fine pass.

    Its draws, each taken from ``draws`` when given there and else from
    ``generator``: "z", the depth-guided normal eps [R, n0] (``init_z``) or,
    without depth sampling and with ``perturb``, the stratified-jitter
    uniforms [R, n0]; "noise_c" [R * n0] and "noise_f" [R * K], the
    standard normal density noise of the coarse and the fine pass (with
    ``raw_noise_std`` > 0); "u_pdf" [R, n_importance], the importance
    uniforms when ``perturb`` is off. The coarse pass is
    ``density_observed`` at the sampling precision without gradient, then
    the noise and the relu. JAX's det=perturb quirk is kept: with
    ``perturb`` the importance depths are the deterministic midpoint draws
    of ``fused_sampler.fused_fine_resample``, without it the random draws
    of ``sample_pdf``."""
    from endosurf_tpu_torch.kernels.fused_render_dnerf import init_z
    from endosurf_tpu_torch.kernels.fused_sampler import fused_fine_resample
    from endosurf_tpu_torch.ops.pdf import sample_pdf
    sp = sampling_precision or precision
    n_rays, n0, dev = rays.shape[0], rspec.n_samples, rays.device
    draws = train_draws(spec, rspec, n_rays, generator, draws or {}, dev)
    rays_o, rays_d, rays_d_z, _, _, t = split_rays(rays)

    def take(name, shape, normal):
        return _train_draw(name, shape, normal, generator, draws, dev)

    def points(z):
        pts = rays_o[:, None, :] + rays_d_z[:, None, :] * z[..., None]
        tt = t[:, None, :].expand(n_rays, z.shape[1], 1)
        return pts.reshape(-1, 3), tt.reshape(-1, 1)

    with torch.no_grad():
        if rspec.use_depth_sampling:
            z_vals = init_z(rspec, rays, take("z", (n_rays, n0), True))
        else:
            z_vals = init_z(rspec, rays)
            if rspec.perturb:
                mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
                upper = torch.cat([mids, z_vals[..., -1:]], -1)
                lower = torch.cat([z_vals[..., :1], mids], -1)
                z_vals = lower + (upper - lower) * take("z", (n_rays, n0), False)
        if rspec.n_importance > 0:
            raw_c = density_observed(spec, params, *points(z_vals), sp)[:, 0]
            if spec.raw_noise_std > 0:
                raw_c = raw_c + spec.raw_noise_std * take("noise_c", (n_rays * n0,), True)
            sigma_c = torch.relu(raw_c).reshape(n_rays, n0)
            if rspec.perturb:
                z_vals = fused_fine_resample(z_vals, sigma_c,
                                             torch.linalg.norm(rays_d, dim=-1, keepdim=True),
                                             rspec.n_importance)
            else:
                _, _, weights_c = raw2outputs(torch.zeros(*sigma_c.shape, 3, device=dev),
                                              sigma_c, z_vals, rays_d)
                z_new = sample_pdf(0.5 * (z_vals[..., 1:] + z_vals[..., :-1]),
                                   weights_c[..., 1:-1], rspec.n_importance,
                                   u=take("u_pdf", (n_rays, rspec.n_importance), False))
                z_vals = torch.sort(torch.cat([z_vals, z_new], -1), dim=-1).values
    k = z_vals.shape[1]
    pts, tt = points(z_vals)
    dirs = rays_d[:, None, :].expand(n_rays, k, 3).reshape(-1, 3)
    noise = take("noise_f", (n_rays * k,), True) if spec.raw_noise_std > 0 else None
    rgb, sigma = field_eval(spec, params, pts, dirs, tt, precision=precision, noise=noise)
    rgb_map, depth_map, weights = raw2outputs(rgb.reshape(n_rays, k, 3),
                                              sigma.reshape(n_rays, k), z_vals, rays_d)
    return {"color_map": rgb_map, "depth_map": depth_map, "weights": weights}


def render_rays_inference(spec: DNeRFSpec, rspec: DNeRFRenderSpec, params: Params,
                          rays: torch.Tensor, use_importance: bool = True,
                          precision: str = "highest", sampling_precision: Optional[str] = None
                          ) -> Dict[str, torch.Tensor]:
    """Forward-only render for the serving paths: {color_map [R, 3],
    depth_map [R, 1], acc_map [R, 1]}. The shapes the render kernel takes go
    to ``fused_render_rays_dnerf`` (the CUDA kernel for CUDA tensors, its
    plain twin for CPU tensors); the rest to :func:`render_rays`."""
    from endosurf_tpu_torch.kernels.fused_render import precision_dtype
    from endosurf_tpu_torch.kernels.fused_render_dnerf import (
        fused_render_rays_dnerf,
        render_shape_supported,
    )
    sp = sampling_precision or precision
    with torch.no_grad():
        if use_importance and rspec.n_importance > 0 and render_shape_supported(spec, rspec):
            return fused_render_rays_dnerf(spec, rspec, params, rays,
                                           sampling_dtype=precision_dtype(sp),
                                           main_dtype=precision_dtype(precision))
        out = render_rays(spec, rspec, params, rays, precision, sp, use_importance)
    return {"color_map": out["color_map"], "depth_map": out["depth_map"],
            "acc_map": out["weights"].sum(-1, keepdim=True)}
