"""EndoNeRF whole-pipeline forward render: the CUDA kernel and its plain twin.

Port of ``endosurf_tpu/kernels/fused_render_dnerf.py``
(``fused_render_rays_dnerf``, a Pallas TPU kernel). For rays [R, 9] it
takes the initial depths from ``init_z`` (outside the kernel, as on the
TPU), then runs the coarse raw density at the sampling precision, the
importance resampling (``fused_sampler.fine_resample_math``), the full field
at all depths at the main precision (``fused_train_dnerf.forward_math``) and
raw2outputs, and returns

    color_map [R, 3], depth_map [R, 1] (disparity form), acc_map [R, 1]

(float32). EndoNeRF eval derives display normals from the depth map.

* ``fused_render_rays_dnerf_cuda``: the hand-written kernels in
  ``csrc/fused_render_dnerf.cu``; a bf16 pass runs on tensor cores
  (``dnerf_tc.cuh``: the coarse sweep and the field stage), a float32 pass
  on SIMT (``sdf_chain.cuh``'s sweep, ``dnerf_chain.cuh``'s fields). The
  pack (``fused_train_dnerf.pack_dnerf``) is cached a parameter set.
* ``fused_render_rays_dnerf_reference``: the same function in plain
  PyTorch. Tests and the CPU path use it; on a GPU it only serves as the
  comparison.
* ``fused_render_rays_dnerf_float64``: the bf16 render's float64 yardstick
  (the twin with the kernels' bf16 operand roundings, float64 arithmetic).
* ``fused_render_rays_dnerf``: the dispatching wrapper. A CUDA tensor always
  goes to the kernel (errors propagate); a CPU tensor takes the plain twin.

The depth-guided draws: JAX draws eps [R, n0] from a fixed ``PRNGKey(0)``
on every call, so every chunk of a frame gets the same eps and the draws
depend on the chunk size. The port draws eps from a ``torch.Generator``
seeded 0 on every call (``draw_eps``), with the same shape; an ``eps``
argument feeds given draws (the tests feed JAX's).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from endosurf_tpu_torch.kernels.fused_render import _dtype_precision, precision_dtype

# Launches of the CUDA kernel made by fused_render_rays_dnerf_cuda (one per call).
LAUNCHES = {"fused_render_rays_dnerf": 0}

# Kernel vs plain twin on one card, on the per-ray max-over-channels absolute
# error: per map, limits on its median, its 99th percentile and its max. The
# depth map is judged as depth x acc, the opacity-weighted depth (sum_j w_j
# z_j |d| up to the 1e-6 regularisers): the disparity-form depth of a faint
# ray is a ratio of two small sums and moves by up to ~0.35 with float32
# noise, while depth x acc moves with the weights. The fields are chaotic in
# their coordinates (10 octaves), so a resampled depth that moves by float
# noise moves its sample's field: the max holds the rays with moved samples,
# the p99 the bulk, and the median catches a fault that moves every ray a
# little. The seeded nets render almost nothing (a ray's acc is set by the
# sign of its far sample's density), so the checks also run them with
# ``with_density_bias``: rays opaque within their samples, where the
# resample and the composite decide the maps. Set from H100 readings
# (PERF.md) over chip_smoke's 8192 depth-guided and 2048 uniform rays and
# the card tests' cells (seeded and opaque nets, two seeds): sound medians
# float32 <= 1.8e-7 / 6.7e-6 / 3.0e-7 (colour / depth x acc / acc), bf16
# <= 4.2e-7 / 2.0e-4 / 3.0e-7 (a bf16 depth on a ray opaque only at its far
# sample is as noisy as the p99s); sound p99 float32 <= 1.1e-4 / 4.8e-4 /
# 2.0e-4, bf16 <= 6.1e-4 / 5.7e-3 / 1.2e-3; sound max float32 <= 1.1e-3 /
# 5.2e-3 / 2.1e-3, bf16 <= 4.3e-3 / 3.2e-2 / 8.5e-3. The limits sit at 3x
# to 10x those. Planted faults on the opaque nets, both modes: draws half a
# step early read a colour median >= 2.1e-5, coarse weights on distances
# without |d| >= 1.2e-5, a depth sum without |d| a depth p99 >= 0.064, all
# failing. The kernel with its main pass at the other precision fails on
# every net: on the seeded ones by its p99 and max, on the opaque ones by
# the colour median alone (>= 4.5e-5; its p99 is under the float32 limit).
# A sampling pass at the other precision moves the seeded renders by less
# than float noise: fused_sdf.DENSITY_PARITY_TOL holds that sweep.
# The tensor-core bf16 render (both passes on mma.sync, the resample and the
# composite in double) is no farther from the float64 yardstick
# (fused_render_rays_dnerf_float64) than the SIMT bf16 render in median and
# p99 on every map of every card cell
# (test_dnerf_render_tensor_cores_no_farther_from_float64) and of
# chip_smoke's rays (PERF.md §6; NVIDIA H100 80GB HBM3): on chip_smoke's
# seeded seed-0 depth-guided rays colour median 2.6e-8 against 8.4e-6, acc
# 1.3e-8 against 1.5e-5. The twin shares the SIMT render's float32 resample,
# so there the nearer kernel reads colour 3.6e-6 and acc 6.5e-6 from it, and
# the bf16 colour and acc median limits moved 3e-6 -> 6e-6 and 3e-6 ->
# 1.2e-5 on that evidence. The controls still fail (colour medians >=
# 7.6e-5), and so do the planted faults on the nets they name (bf16 colour
# medians >= 1.45e-5 on the opaque nets); two faults the old limits also
# caught on nets they do not name now pass there in bf16: draws_half_step
# on the seeded nets' depth-guided rays (colour 3.3e-6, acc 6.2e-6) and
# no_weight_floor on the opaque nets' (colour 4.1e-6).
PARITY_TOL = {
    torch.float32: {"color_map": (3e-6, 3e-4, 3e-3), "depth_map": (2e-5, 1.5e-3, 1.5e-2),
                    "acc_map": (3e-6, 6e-4, 6e-3)},
    torch.bfloat16: {"color_map": (6e-6, 2e-3, 1.5e-2), "depth_map": (6e-4, 1.5e-2, 0.1),
                     "acc_map": (1.2e-5, 4e-3, 2.5e-2)},
}

# The density bias of the opaque test nets (per unit of depth): over the
# samples of a depth-guided ray with sigma 0.08 the transmittance falls to
# ~e^-4, over a uniform ray's first third to ~e^-5.
DENSE_BIAS = 10.0


def parity_errors(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                  dtype: torch.dtype) -> Dict[str, Tuple[float, float, float, bool]]:
    """Per map: (median, p99, max) of the per-ray error and whether all three
    are within ``PARITY_TOL[dtype]``; depth_map as depth x acc."""
    out = {}
    for k, tol in PARITY_TOL[dtype].items():
        g, r = ((m[k] * m["acc_map"] if k == "depth_map" else m[k]) for m in (got, ref))
        per_ray = (g - r).abs().amax(dim=-1).float()
        q = torch.quantile(per_ray, torch.tensor([0.5, 0.99], device=per_ray.device))
        stats = (float(q[0]), float(q[1]), float(per_ray.max()))
        out[k] = (*stats, all(v <= t for v, t in zip(stats, tol)))
    return out


def with_density_bias(params: Dict[str, Any], bias: float = DENSE_BIAS) -> Dict[str, Any]:
    """``params`` with ``bias`` added to the raw density (the density net's
    output column 0), the other tensors shared: the parity checks' opaque
    nets."""
    layers = list(params["density"]["layers"])
    b = layers[-1]["b"].clone()
    b[0] += bias
    layers[-1] = {**layers[-1], "b": b}
    return {**params, "density": {**params["density"], "layers": layers}}


def render_shape_supported(spec, rspec) -> bool:
    """The configurations the CUDA kernel takes: the nets of
    ``fused_train_dnerf.cuda_dnerf_supported`` (with or without the deform
    net), 3 to 64 initial and 1 to 64 importance samples. (The TPU kernel
    takes only 64 + 64 with the deform net.)"""
    from endosurf_tpu_torch.kernels.fused_train_dnerf import cuda_dnerf_supported
    return (cuda_dnerf_supported(spec) and 3 <= rspec.n_samples <= 64
            and 1 <= rspec.n_importance <= 64)


def draw_eps(n_rays: int, n_samples: int, device) -> torch.Tensor:
    """The depth-guided normal draws eps [n_rays, n_samples]: a generator
    seeded 0 on every call (eval is deterministic)."""
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn(n_rays, n_samples, generator=gen, device=device)


def init_z(rspec, rays: torch.Tensor, eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Initial depths [R, n_samples]: sorted mean + std * eps with (mean,
    std) from ray slots 6/7 under ``use_depth_sampling``, else linspace
    between slots 6 and 7 (near, far)."""
    n_rays, n0 = rays.shape[0], rspec.n_samples
    a, b = rays[:, 6:7], rays[:, 7:8]
    if rspec.use_depth_sampling:
        if eps is None:
            eps = draw_eps(n_rays, n0, rays.device)
        return torch.sort(a + b * eps.to(rays.dtype), dim=-1).values
    # jnp.linspace's values: i * float32(1 / (n0 - 1)). A sample's high
    # octaves turn a float32 ulp of its depth into ~1e-4 of its density.
    step = torch.tensor(1.0 / (n0 - 1), dtype=rays.dtype, device=rays.device)
    t_vals = torch.arange(n0, dtype=rays.dtype, device=rays.device) * step
    return a * (1.0 - t_vals) + b * t_vals


def fused_render_rays_dnerf_reference(spec, rspec, params: Dict[str, Any], rays: torch.Tensor,
                                      eps: Optional[torch.Tensor] = None,
                                      sampling_dtype: torch.dtype = torch.float32,
                                      main_dtype: torch.dtype = torch.float32
                                      ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch twin of the kernel: ``init_z``, the plain raw density
    (``fused_density_raw_reference``), ``fine_resample_math``, the segment
    math ``forward_math``, raw2outputs."""
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    from endosurf_tpu_torch.kernels.fused_sdf import fused_density_raw_reference
    from endosurf_tpu_torch.models.endonerf import render_pipeline
    main = _dtype_precision(main_dtype)
    with torch.no_grad():
        eff = ftd.prepare_effective_dnerf(spec, params)

        def field_raw(x, d, t):
            out = ftd.forward_math(spec, eff, x, t, d, main)
            return out["rgb"], out["raw_sigma"][:, 0]
        out = render_pipeline(
            rspec, rays, init_z(rspec, rays, eps),
            lambda x, t: fused_density_raw_reference(spec, params, x, t, sampling_dtype),
            field_raw, rspec.n_importance)
    return {"color_map": out["color_map"], "depth_map": out["depth_map"],
            "acc_map": out["weights"].sum(-1, keepdim=True)}


def float64_distance(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
                     ) -> Dict[str, Tuple[float, float]]:
    """Per map: (median, p99) over the rays of the per-ray max-over-channels
    absolute error of ``got`` against the float64 yardstick ``ref`` (depth
    as depth x acc, as ``parity_errors``)."""
    out = {}
    for k in PARITY_TOL[torch.bfloat16]:
        g, r = ((m[k] * m["acc_map"] if k == "depth_map" else m[k]).double()
                for m in (got, ref))
        per_ray = (g - r).abs().amax(dim=-1)
        q = torch.quantile(per_ray, torch.tensor([0.5, 0.99], dtype=per_ray.dtype,
                                                 device=per_ray.device))
        out[k] = (float(q[0]), float(q[1]))
    return out


def fused_render_rays_dnerf_float64(spec, rspec, params: Dict[str, Any], rays: torch.Tensor,
                                    eps: Optional[torch.Tensor] = None,
                                    precision: str = "default", chunk: int = 1024
                                    ) -> Dict[str, torch.Tensor]:
    """The bf16 render's float64 yardstick, the maps in float64: the plain
    twin (``init_z``, the raw density, ``fine_resample_math``,
    ``forward_math``, raw2outputs) with ``precision``'s operand roundings
    ("default": the kernels' bf16 ones; "highest": none) and float64
    arithmetic between them, on the kernels' own weights (the float32
    parameters; "default" rounds them to the kernels' bf16 values). The
    initial depths are the kernel's float32 ones, and the sample points are
    formed in float32 as the kernels form them (``dn_coord``: the fields
    are chaotic in their coordinates), the resampled depths rounded to
    float32 first. Runs ``chunk`` rays at a time."""
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    from endosurf_tpu_torch.kernels.fused_sampler import fine_resample_math, to_float64
    from endosurf_tpu_torch.kernels.fused_sdf import fused_density_raw_reference
    from endosurf_tpu_torch.models.endonerf import raw2outputs, split_rays
    rays = rays.detach().to(torch.float32).contiguous()
    z_all = init_z(rspec, rays, eps)
    p64 = to_float64(params)
    eff = ftd.prepare_effective_dnerf(spec, p64)
    parts = []
    with torch.no_grad():
        for i in range(0, rays.shape[0], chunk):
            o, d, d_z, _, _, t = split_rays(rays[i:i + chunk])
            z = z_all[i:i + chunk]
            n, n0 = z.shape

            def points(zz):       # float32 zz, as dn_coord forms them
                return (o[:, None] + d_z[:, None] * zz[..., None]).reshape(-1, 3).double()
            d64 = d.double()
            raw = fused_density_raw_reference(spec, p64, points(z),
                                              t.double().repeat_interleave(n0, 0),
                                              precision_dtype(precision))
            z = fine_resample_math(z.double(), torch.relu(raw[:, 0].reshape(n, n0)),
                                   torch.linalg.norm(d64, dim=-1, keepdim=True),
                                   rspec.n_importance).float()
            k = z.shape[1]
            out = ftd.forward_math(spec, eff, points(z), t.double().repeat_interleave(k, 0),
                                   d64.repeat_interleave(k, 0), precision)
            rgb, depth, w = raw2outputs(out["rgb"].reshape(n, k, 3),
                                        torch.relu(out["raw_sigma"][:, 0]).reshape(n, k),
                                        z.double(), d64)
            parts.append({"color_map": rgb, "depth_map": depth,
                          "acc_map": w.sum(-1, keepdim=True)})
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def fused_render_rays_dnerf_cuda(spec, rspec, params: Dict[str, Any], rays: torch.Tensor,
                                 eps: Optional[torch.Tensor] = None,
                                 sampling_dtype: torch.dtype = torch.float32,
                                 main_dtype: torch.dtype = torch.float32, simt: bool = False
                                 ) -> Dict[str, torch.Tensor]:
    """Launch the CUDA kernels (``csrc/fused_render_dnerf.cu``) on the
    current stream; the initial depths (``init_z``) are formed here. A bf16
    pass runs on tensor cores; ``simt`` runs it on the SIMT code instead,
    which only the float64 comparison of the tests and chip_smoke.py asks
    for."""
    from endosurf_tpu_torch.kernels.build import load_library
    from endosurf_tpu_torch.kernels.fused_train_dnerf import check_tc_nets, pack_dnerf

    if rays.device.type != "cuda":
        raise ValueError(f"fused_render_rays_dnerf_cuda needs CUDA tensors, got {rays.device}")
    if rays.ndim != 2 or rays.shape[1] != 9:
        raise ValueError(f"rays must be [R, 9], got {tuple(rays.shape)}")
    if not render_shape_supported(spec, rspec):
        raise ValueError(f"the CUDA D-NeRF render kernel does not take {spec}, {rspec}")
    device = rays.device
    lib = load_library()
    rays = rays.detach().to(torch.float32).contiguous()
    n_rays = rays.shape[0]
    samp = pack_dnerf(spec, params, sampling_dtype)
    main = samp if main_dtype == sampling_dtype else pack_dnerf(spec, params, main_dtype)
    if samp.w.device != device:
        raise ValueError(f"params on {samp.w.device}, rays on {device}")
    meta = main.meta if main.rb else samp.meta    # the bf16 one: its extension, the same prefix
    tc = not simt and (samp.rb or main.rb)
    if tc:
        check_tc_nets(main if main.rb else samp, bwd=False)
    z0 = init_z(rspec, rays, eps).contiguous()
    scratch = torch.empty(lib.fused_render_dnerf_scratch_floats(n_rays), dtype=torch.float32,
                          device=device)
    out = torch.empty(n_rays, 5, dtype=torch.float32, device=device)
    with torch.cuda.device(device):   # the launch runs on the current device
        err = lib.fused_render_dnerf_launch(
            rays.data_ptr(), z0.data_ptr(), n_rays, rspec.n_samples, rspec.n_importance,
            samp.w.data_ptr(), main.w.data_ptr(), meta, int(samp.rb), int(main.rb), int(tc),
            scratch.data_ptr(), out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused_render_rays_dnerf CUDA launch failed: "
                           + lib.fused_render_error_string(err).decode())
    LAUNCHES["fused_render_rays_dnerf"] += 1
    return {"color_map": out[:, 0:3], "depth_map": out[:, 3:4], "acc_map": out[:, 4:5]}


def fused_render_rays_dnerf(spec, rspec, params: Dict[str, Any], rays: torch.Tensor,
                            eps: Optional[torch.Tensor] = None,
                            sampling_dtype: torch.dtype = torch.float32,
                            main_dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """CUDA tensors run the kernel; CPU tensors run the plain twin."""
    if rays.device.type == "cuda":
        fn = fused_render_rays_dnerf_cuda
    elif rays.device.type == "cpu":
        fn = fused_render_rays_dnerf_reference
    else:
        raise ValueError(f"no fused_render_rays_dnerf for device {rays.device}")
    return fn(spec, rspec, params, rays, eps, sampling_dtype, main_dtype)
