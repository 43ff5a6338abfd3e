"""Observed-space SDF query: the CUDA kernel and its plain PyTorch version.

Port of ``endosurf_tpu/kernels/fused_sdf.py::fused_sdf_observed`` (a Pallas
TPU kernel). For points x [N, 3] at times t [N, 1] it runs the forward chain
freq-encode(x, t) -> deform MLP -> x_c = x + dx -> freq-encode(x_c) -> SDF
MLP and returns sdf [N, 1] (float32), without gradient. It serves the
sampling-only SDF queries (``models.endosurf._sdf_sampling``): the 3D demo's
dense mesh grid and the ray march's scan.

* ``fused_sdf_observed_cuda``: the hand-written kernel in
  ``csrc/fused_sdf.cu``: in bf16 the tensor-core sweep of the bf16
  upsampling (``csrc/sweep_tc.cuh``'s ``sweep_tc_kernel`` over a point
  list; ``simt=True`` runs the SIMT sweep instead, for the float64
  comparison only), in float32 ``csrc/sdf_chain.cuh``'s SIMT sweep. Any N:
  the kernel masks the last block's tail. The weights are packed from the
  parameters as given (``fused_sampler.pack_sampling``: bf16-rounded, with
  the hidden layers' mma fragments, for ``compute_dtype`` bf16), cached a
  parameter set (``PACKS`` counts the packs built).
* ``fused_sdf_observed_float64``: the bf16 query's float64 yardstick.
* ``fused_sdf_observed_reference``: ``fields.sdf_observed`` at the matching
  precision under no_grad. The CPU path and the tests use it; on a GPU it
  only serves as the comparison.
* ``fused_sdf_observed``: the dispatching wrapper. A CUDA tensor always goes
  to the kernel (errors propagate); a CPU tensor takes the plain version.

The EndoNeRF counterpart is the port of ``fused_sdf.py::fused_density_raw``:
the same sweep with the D-NeRF chain (relu nets, skips unscaled) returning
the raw density [N, 1] (column 0 of the density net's output, before the
relu). ``fused_density_raw_cuda`` launches it (``csrc/fused_sdf.cu``, weights
from ``fused_train_dnerf.pack_dnerf``; in bf16 the tensor-core sweep of
``csrc/dnerf_tc.cuh``, ``simt=True`` the SIMT one for the float64
comparison, ``fused_density_raw_float64`` the yardstick),
``fused_density_raw_reference`` is the plain chain (``models.endonerf._warp``
-> ``_density_feat``[:, :1]) and ``fused_density_raw`` dispatches as above.
It serves the EndoNeRF train step's coarse pass and mesh grid
(``density_observed``); the render kernel runs the same sweep on its rays.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from endosurf_tpu_torch.kernels.fused_render import (
    NL,
    PackCache,
    _dtype_precision,
    cuda_spec_supported,
)
from endosurf_tpu_torch.kernels.fused_sampler import cached_sampling_pack, sampling_params_float64

# Launches of the CUDA kernels made by fused_sdf_observed_cuda and
# fused_density_raw_cuda (one per call).
LAUNCHES = {"fused_sdf_observed": 0, "fused_density_raw": 0}
# Packs built by fused_sdf_observed_cuda (a cached pack counts no new one).
PACKS = {"fused_sdf_observed": 0}
_SDF_PACKS: PackCache = {}

# Kernel vs plain version on one card, on the per-point absolute sdf error:
# (median, p99, max) per dot precision. Both sides run the same chain with
# float32 accumulation in different orders; in bf16 an operand that sits on
# a rounding edge rounds the other way on one side and moves that point's
# sdf by a bf16 step of one activation, so the bf16 max is wide and the
# median and p99 tell the precisions apart. Set from H100 readings (PERF.md,
# PR 4) on a 1,048,576-point grid slab and 8192 random points (use_deform
# false) and the card tests' cells (1000 to 1,048,576 points, three nets),
# two weight seeds: sound float32 median 1.5e-7, p99 9.5e-7, max 1.9e-6;
# sound bf16 median 0, p99 0, max 1.1e-2 (narrow net); the kernel at the
# other precision median >= 8.2e-4, p99 >= 3.8e-3. A 0.1 % scale planted on
# 1 point in 64 reads p99 2.2e-4 (float32) and 3.1e-4 (bf16) and fails.
# The bf16 query runs the tensor-core sweep of the bf16 upsampling (PERF.md
# §6; NVIDIA H100 80GB HBM3), nearer to exact between its bf16 roundings
# than the float32 sums that the plain version and the SIMT sweep share:
# against the float64 yardstick (fused_sdf_observed_float64; per point over
# its rms, test_sdf_query_tensor_cores_no_farther_from_float64 and chip_smoke
# phase 12) it reads median <= 1.3e-8 and p99 <= 2.9e-5 where the SIMT sweep
# reads up to 3.2e-7 and 1.1e-3. So against the plain version it now reads
# the plain version's own float32 tips: median <= 1.5e-7, p99 <= 5.3e-4
# (the SIMT sweep read 0 and 0), max <= 1.1e-2. Its p99 limit moved 1e-4 ->
# 2e-3 on that evidence; the median and max, the float32 limits and the
# controls (median >= 8.2e-4) stand. A planted 0.1 % scale on 1 point in 64
# now hides in that p99, so the bf16 query is also held to the float64
# yardstick (FLOAT64_TOL), where it fails.
PARITY_TOL = {
    torch.float32: (1e-6, 5e-6, 2e-5),
    torch.bfloat16: (1e-5, 2e-3, 2e-2),
}

# The bf16 query (tensor cores) against its float64 yardstick, the same
# statistics of the per-point |error| (the card tests' cells and chip_smoke's
# grid slabs, two seeds): sound median <= 7.3e-9, p99 <= 3.0e-6 (1.36e-5 on
# the 1000-point cell, whose p99 is its tenth-largest point), max <= 5.9e-3;
# the planted 0.1 % scale on 1 point in 64 reads p99 3.4e-4 and fails it.
FLOAT64_TOL = {torch.bfloat16: (1e-7, 5e-5, 2e-2)}


class Share(float):
    """A max limit given as a share of the reference's largest |value|."""

    def __repr__(self) -> str:
        return f"{float(self)!r} x max|ref|"


# The raw density query, the same statistics on the per-point |raw density
# error|. The seeded full nets' raw density lies within about [-0.06, 0.06],
# the narrow net's within [-0.65, 0.65]. Set from H100 readings (PERF.md) on
# a 1,048,576-point grid slab and 8192 random points (use_deform false), two
# weight seeds, and the card tests' cells (1000 to 1,048,576 points, three
# nets): sound float32 median <= 6.7e-8, p99 <= 2.8e-6, max <= 6.5e-6 (the
# 64-wide net); the kernel at the other precision median >= 4.0e-5.
# The bf16 query runs the tensor-core sweep (PERF.md §6; NVIDIA H100 80GB
# HBM3), which encodes x_c in double, unrounded, where the plain version
# encodes a float32 x_c. Ten octaves turn either side's error in x_c into a
# tipped bf16 rounding of an encoding now and then, and that moves the
# point's raw density by a share of the net's scale. So the bf16 max is a
# share of the reference's largest |raw| (Share), not a fixed value. Sound,
# against the plain version: median <= 9.3e-10, p99 <= 1.40e-4, max <= 0.055
# of max|raw| (3.55e-2 on the narrow net at 1,048,576 random points; full
# nets <= 0.017 of it, <= 6.8e-4). The float64 yardstick
# (fused_density_raw_float64) shows that both sides tip: the plain
# version is off it by up to 3.55e-2 and the sweep by up to 2.65e-2, and the
# sweep is no farther from it than the SIMT sweep in median and p99 on every
# card cell (test_density_raw_tensor_cores_no_farther_from_float64). A
# planted sparse fault, the last partial 64-point tile written as 0 (one
# point of 65,537, 40 of 1000), reads max 0.143 to 0.94 of max|raw| (full,
# full-static and narrow nets, two seeds), and one point in 64 zeroed reads
# >= 0.51: so the bf16 max is 0.1 of max|raw|. It was 5e-3 before the tensor-core sweep
# (sound SIMT bf16 max <= 1.2e-3), which the narrow net's tips exceed. The
# controls still fail on the median, the planted faults in both modes.
DENSITY_PARITY_TOL = {
    torch.float32: (1e-6, 1e-5, 5e-5),
    torch.bfloat16: (1e-5, 3e-4, Share(0.1)),
}


def parity_errors(got: torch.Tensor, ref: torch.Tensor, dtype: torch.dtype, tol=None
                  ) -> Tuple[float, float, float, bool]:
    """(median, p99, max) of the per-point |error| and whether all three
    are within ``tol[dtype]`` (default ``PARITY_TOL``; a ``Share`` max is
    that share of max |ref|)."""
    err = (got - ref).abs().reshape(-1).float()
    # torch.quantile takes at most 2^24 values: a strided subset above that
    sub = err[:: max(1, err.numel() // (1 << 24) + 1)]
    med, p99, mx = float(err.median()), float(torch.quantile(sub, 0.99)), float(err.max())
    t_med, t_p99, t_max = (PARITY_TOL if tol is None else tol)[dtype]
    if isinstance(t_max, Share):
        t_max = t_max * float(ref.abs().max())
    return med, p99, mx, med <= t_med and p99 <= t_p99 and mx <= t_max


def float64_errors(got: torch.Tensor, ref64: torch.Tensor) -> Tuple[float, float, float, bool]:
    """The bf16 query against its float64 yardstick: (median, p99, max) of
    the per-point |error| and whether all three are within ``FLOAT64_TOL``."""
    return parity_errors(got.double(), ref64, torch.bfloat16, FLOAT64_TOL)


def fused_sdf_observed_reference(spec, params: Dict[str, Any], x: torch.Tensor,
                                 t: torch.Tensor,
                                 compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version: ``sdf_observed`` under no_grad."""
    from endosurf_tpu_torch.models.fields import sdf_observed
    with torch.no_grad():
        return sdf_observed(spec, params, x, t, _dtype_precision(compute_dtype))


def fused_sdf_observed_cuda(spec, params: Dict[str, Any], x: torch.Tensor, t: torch.Tensor,
                            compute_dtype: torch.dtype = torch.float32,
                            simt: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel (``csrc/fused_sdf.cu``) on the current stream:
    in bf16 the tensor-core sweep (``simt`` runs the SIMT sweep instead, the
    float64 comparison only), in float32 the SIMT sweep. The pack is cached
    on the deform and SDF parameter tensors
    (``fused_sampler.cached_sampling_pack``): a frame's grid slabs share one."""
    from endosurf_tpu_torch.kernels.build import load_library

    if x.device.type != "cuda":
        raise ValueError(f"fused_sdf_observed_cuda needs CUDA tensors, got {x.device}")
    n = x.shape[0] if x.ndim == 2 else None
    if n is None or x.shape != (n, 3) or t.shape != (n, 1):
        raise ValueError(f"expected x [N, 3], t [N, 1]; got {tuple(x.shape)}, {tuple(t.shape)}")
    if not cuda_spec_supported(spec):
        raise ValueError(f"the CUDA sdf kernel does not take {spec}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {compute_dtype}")
    device = x.device
    lib = load_library()
    rb = compute_dtype == torch.bfloat16
    (w, meta_arr), built = cached_sampling_pack(_SDF_PACKS, spec, params, compute_dtype)
    PACKS["fused_sdf_observed"] += built
    if w.device != device or t.device != device:
        raise ValueError(f"params on {w.device}, t on {t.device}, x on {device}")
    xc = x.detach().to(torch.float32).contiguous()
    tc = t.detach().to(torch.float32).contiguous()
    out = torch.empty(n, 1, dtype=torch.float32, device=device)
    assert len(meta_arr) == lib.fused_render_meta_len() + (2 * NL if rb else 0)
    with torch.cuda.device(device):   # the launch runs on the current device
        err = lib.fused_sdf_observed_launch(
            xc.data_ptr(), tc.data_ptr(), n, w.data_ptr(), meta_arr, int(rb),
            int(rb and not simt), out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused_sdf_observed CUDA launch failed: "
                           + lib.fused_render_error_string(err).decode())
    LAUNCHES["fused_sdf_observed"] += 1
    return out


def fused_sdf_observed_float64(spec, params: Dict[str, Any], x: torch.Tensor,
                               t: torch.Tensor,
                               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The bf16 observed-SDF query's float64 yardstick: the plain version
    (``fused_sdf_observed_reference``) on float64 copies of the parameters
    (the deform and SDF weights as the kernel packs them, bf16-rounded for
    ``compute_dtype`` bf16: ``fused_sampler.sampling_params_float64``) and of
    the points, coordinates unrounded, with ``compute_dtype``'s operand
    roundings and float64 arithmetic between them. Returns sdf [N, 1] in
    float64."""
    return fused_sdf_observed_reference(
        spec, sampling_params_float64(params, _dtype_precision(compute_dtype)), x.double(),
        t.double(), compute_dtype)


def fused_sdf_observed(spec, params: Dict[str, Any], x: torch.Tensor, t: torch.Tensor,
                       compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """CUDA tensors run the kernel; CPU tensors run the plain version."""
    if x.device.type == "cuda":
        fn = fused_sdf_observed_cuda
    elif x.device.type == "cpu":
        fn = fused_sdf_observed_reference
    else:
        raise ValueError(f"no fused_sdf_observed for device {x.device}")
    return fn(spec, params, x, t, compute_dtype)


def fused_density_raw_reference(spec, params: Dict[str, Any], x: torch.Tensor,
                                t: torch.Tensor,
                                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version: the D-NeRF chain's raw density under no_grad."""
    from endosurf_tpu_torch.models.endonerf import _density_feat, _warp
    prec = _dtype_precision(compute_dtype)
    with torch.no_grad():
        return _density_feat(spec, params, _warp(spec, params, x, t, prec), prec)[..., :1]


def fused_density_raw_cuda(spec, params: Dict[str, Any], x: torch.Tensor, t: torch.Tensor,
                           compute_dtype: torch.dtype = torch.float32,
                           simt: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel (``csrc/fused_sdf.cu``) on the current stream:
    in bf16 the tensor-core sweep (its nets checked first, on any device;
    ``simt`` runs the SIMT sweep instead, the float64 comparison only), in
    float32 the SIMT sweep."""
    from endosurf_tpu_torch.kernels.build import load_library
    from endosurf_tpu_torch.kernels.fused_train_dnerf import _tc, pack_dnerf

    packed = pack_dnerf(spec, params, compute_dtype)
    use_tc = _tc(packed, simt, "fwd")
    if x.device.type != "cuda":
        raise ValueError(f"fused_density_raw_cuda needs CUDA tensors, got {x.device}")
    n = x.shape[0] if x.ndim == 2 else None
    if n is None or x.shape != (n, 3) or t.shape != (n, 1):
        raise ValueError(f"expected x [N, 3], t [N, 1]; got {tuple(x.shape)}, {tuple(t.shape)}")
    device = x.device
    lib = load_library()
    if packed.w.device != device or t.device != device:
        raise ValueError(f"params on {packed.w.device}, t on {t.device}, x on {device}")
    xc = x.detach().to(torch.float32).contiguous()
    tc = t.detach().to(torch.float32).contiguous()
    out = torch.empty(n, 1, dtype=torch.float32, device=device)
    with torch.cuda.device(device):   # the launch runs on the current device
        err = lib.fused_density_raw_launch(
            xc.data_ptr(), tc.data_ptr(), n, packed.w.data_ptr(), packed.meta, int(packed.rb),
            int(use_tc), out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused_density_raw CUDA launch failed: "
                           + lib.fused_render_error_string(err).decode())
    LAUNCHES["fused_density_raw"] += 1
    return out


def fused_density_raw_float64(spec, params: Dict[str, Any], x: torch.Tensor, t: torch.Tensor,
                              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The bf16 raw density query's float64 yardstick: the plain D-NeRF chain
    (``fused_density_raw_reference``) on float64 copies of the float32
    parameters and of the points, coordinates unrounded, with
    ``compute_dtype``'s operand roundings ("default" rounds the weights to
    the kernels' bf16 values) and float64 arithmetic between them. Returns
    the raw density [N, 1] in float64."""
    from endosurf_tpu_torch.kernels.fused_sampler import to_float64
    return fused_density_raw_reference(spec, to_float64(params), x.double(), t.double(),
                                       compute_dtype)


def fused_density_raw(spec, params: Dict[str, Any], x: torch.Tensor, t: torch.Tensor,
                      compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """CUDA tensors run the kernel; CPU tensors run the plain version."""
    if x.device.type == "cuda":
        fn = fused_density_raw_cuda
    elif x.device.type == "cpu":
        fn = fused_density_raw_reference
    else:
        raise ValueError(f"no fused_density_raw for device {x.device}")
    return fn(spec, params, x, t, compute_dtype)
