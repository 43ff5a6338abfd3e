"""SDF-guided importance upsampling and the sphere-traced ray march: the CUDA
kernels and their plain PyTorch twins.

Port of ``endosurf_tpu/kernels/fused_sampler.py::fused_upsample_z`` (a Pallas
TPU kernel). For rays (o, d_z [R, 3], t [R, 1]) and the caller's ascending
(perturbed) samples z0 [R, n0] it runs all upsampling rounds: the SDF at the
samples, NeuS importance weights at sharpness 64 * 2^i, k deterministic
inverse-CDF draws, the SDF at the new samples and a sorted merge. It returns
z [R, n0 + n_importance] ascending and, with ``return_sdf``, the SDF at every
sample (float32). The train step runs it without gradient.

* ``fused_upsample_z_cuda``: the hand-written kernel in
  ``csrc/fused_sampler.cu`` (with ``csrc/sdf_chain.cuh``'s draws, merges and
  float32 sweep, shared with the render kernel, and in bf16
  ``csrc/sweep_tc.cuh``'s sweep on tensor cores). The weights are packed
  from the parameters as given (the caller runs it under no_grad) by
  ``pack_sampling``, bf16-rounded for ``sampling_dtype`` bf16, cached a
  parameter set (``cached_sampling_pack``, shared with the march: a train
  step with ``surf_march_reuse: false`` packs once for both).
* ``fused_upsample_z_reference``: ``models.endosurf.upsample_z`` under
  no_grad. Tests and the CPU path use it; on a GPU it only serves as the
  comparison.
* ``fused_upsample_z``: the dispatching wrapper. A CUDA tensor always goes to
  the kernel (errors propagate); a CPU tensor takes the plain twin.

The ray march is the port of ``fused_sampler.py::fused_ray_march`` (a Pallas
TPU kernel), the train step's surface search with ``surf_march_reuse:
false``: per ray the SDF at 128 depths linspace(near, far), the first + -> -
crossing of -(sdf - tau) and 8 secant steps; invalid rays get the chord
midpoint. ``fused_ray_march_cuda`` launches ``csrc/fused_sampler.cu``'s
march (in bf16 every sweep on tensor cores, ``csrc/sweep_tc.cuh``'s, the
upsampling's; ``simt=True`` the SIMT sweep, for the float64 comparison
only), ``fused_ray_march_reference`` is ``models.endosurf.march_math``,
``fused_ray_march_float64`` the bf16 march's float64 yardstick and
``fused_ray_march`` dispatches as above. All return depth, valid [R, 1] and
the final bracket (d_low, d_high [R]) with the crossing's sample index idx
[R], which the parity and consistency checks read.

The EndoNeRF importance resampling is the port of
``fused_sampler.py::fused_fine_resample`` (a Pallas TPU kernel): the coarse
weights of raw2outputs, the deterministic inverse-CDF draws over the
midpoint bins and the sorted merge. ``fused_fine_resample_cuda`` launches
``csrc/fused_render_dnerf.cu``'s resample kernel (one warp a ray, the
kernel the EndoNeRF render's resample stage launches too),
``fine_resample_math`` is its plain version (``fused_fine_resample_reference``)
and ``fused_fine_resample`` dispatches as above: the train step's
deterministic draws on the card always run the kernel.
``resample_edge_inputs`` makes the inputs on which a parallel resample goes
wrong (a pdf of the weight floor alone, one opaque sample, alpha exactly 1,
duplicated depths and draws on a coarse depth).
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Tuple

import torch

from endosurf_tpu_torch.kernels.fused_render import (
    META_NET,
    NL,
    PackCache,
    _dtype_precision,
    cached_pack,
    cuda_spec_supported,
    pack_operands,
    spec_refusal,
)
from endosurf_tpu_torch.kernels.fused_train_cuda import mma_frags

KMAX = 64       # samples per ray the kernel holds
KNEW_MAX = 8    # new samples per round

# Launches of the CUDA kernels made by fused_upsample_z_cuda,
# fused_ray_march_cuda and fused_fine_resample_cuda (one per call).
LAUNCHES = {"fused_upsample_z": 0, "fused_ray_march": 0, "fused_fine_resample": 0}
# Packs built for the upsampling and the march (cached_sampling_pack: a
# cached pack counts no new one).
PACKS = {"sampling": 0}
_SAMPLING_PACKS: PackCache = {}
RESAMPLE_MAX = 64        # csrc/dnerf_chain.cuh's DN_N0: coarse depths, and draws, a ray
# the resample gate's corners (n0, n_new): its fewest and most of each
RESAMPLE_CORNERS = ((3, 1), (3, 64), (64, 1), (64, 64))
# the rows of resample_edge_inputs, in blocks of equal size, in this order
RESAMPLE_EDGE_KINDS = ("zero", "one_opaque", "huge", "duplicates", "on_depth", "random")

# The limits below were set from H100 readings of the sound pairs (kernel
# and twin at one dot precision), the wrong-precision controls and kernels
# with a planted fault on a minority of rays, on two weight seeds, over
# chip_smoke.py's 8192 train rays and the 1024-ray cells of
# tests/test_torch_cuda.py (PERF.md §6 and CHANGES.md, PRs 2 and 9).
#
# 1. Kernel vs plain twin, on the per-ray max-over-samples absolute error of
# z and of sdf: the median ray, the 99th percentile, the max per output, and
# the share of rays above a threshold. Both sides run the same math with
# float32 accumulation in different orders; a draw on a bin edge or in a
# floor-only bin moves one new sample, and the weights at sharpness up to
# 512 amplify a 1e-6 SDF difference, which moves every later round on that
# ray. So the tail is wide in sound pairs (f32 0.66 % of the train rays over
# 1e-3), and the median ray (f32 sound <= 1.2e-6, controls >= 3.2e-3) is what
# tells the precisions apart. The other limits sit at about 1.5-3x the
# largest sound reading.
# bf16, since the sweeps run on tensor cores (csrc/sweep_tc.cuh; PERF.md
# §6): the SIMT sweep summed in the plain version's k order and read a
# median ray <= 1.2e-6; the tensor-core sweep computes nearer to exact
# arithmetic between its bf16 roundings, so it now differs from the plain
# version by the plain version's own float32 tips. Against the float64
# yardstick (fused_upsample_z_float64) it is the nearer of the two kernels
# on every cell (test_upsample_tensor_cores_no_farther_from_float64: median
# and p99, narrow z p99 1.1e-4 against the SIMT sweep's 3.6e-3, train rays
# sdf p99 4.8e-3 / 7.5e-3 against 1.0e-2 / 2.2e-2). Readings on an H100
# (card cells: 1024 rays, five nets, two seeds): sound median <= 1.05e-3
# (sdf), p99 <= 8.6e-3, max z 0.020 / sdf 0.016, share over 1e-2 <= 0.4 %;
# chip_smoke's 8192 train rays in PERF.md §6; the wrong-precision controls
# median >= 3.19e-3; the skip scale applied after the dot (a planted fault)
# 3.5e-3. Old bf16 limits median 1e-5, p99 2e-2, share 3 %.
PARITY_TOL = {
    torch.float32: {"median": 1e-5, "p99": 2e-3, "max": {"z": 1e-1, "sdf": 6e-2},
                    "share": (1e-3, 0.015)},
    torch.bfloat16: {"median": 1.5e-3, "p99": 8e-2, "max": {"z": 4e-1, "sdf": 2e-1},
                     "share": (1e-2, 0.15)},
}

# 2. The kernel's (z, sdf) against the plain math on its own samples
# (consistency_errors), which has no such cascade, so a fault on a few rays
# shows: every ray keeps z0; the per-ray SDF error at the kernel's own z
# (median, (threshold, share of rays over it), max: sound f32 max 1.3e-6;
# sound bf16, the tensor-core sweep, median <= 2.7e-4, <= 9.2 % of rays over
# 1e-3, max <= 6.2e-3, where the plain version's float32 tips a rounding the
# kernel does not (the SIMT sweep read median 0, 2.0 % over 1e-3; old
# limits 1e-4 and 5 %); controls median >= 2.4e-3 and every ray over 1e-3,
# the skip scale after the dot 2.6e-3); and each round's draws replayed
# from the kernel's own list, where every judged ray must stay within the
# error model (sound <= 0.12, a planted draw fault ~1e2) with at least the
# judged share of the rays (sound >= 94.4 %) judged.
CDF_TOL = 1e-4
CONSISTENCY_TOL = {
    torch.float32: {"sdf_point": (1e-5, (1e-5, 0.0), 1e-5), "draw": 1.0, "judged": 0.9},
    torch.bfloat16: {"sdf_point": (6e-4, (1e-3, 0.15), 2e-2), "draw": 1.0, "judged": 0.9},
}


def parity_errors(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                  dtype: torch.dtype) -> Dict[str, Tuple[float, float, float, float, bool]]:
    """Per output (z, sdf): (median, p99, max, share over the threshold) of
    the per-ray error and whether all four are within ``PARITY_TOL[dtype]``."""
    tol = PARITY_TOL[dtype]
    thr, share_tol = tol["share"]
    out = {}
    for k, max_tol in tol["max"].items():
        if k not in got:
            continue
        per_ray = (got[k] - ref[k]).abs().amax(dim=-1).float()
        med = float(per_ray.median())
        p99 = float(torch.quantile(per_ray, 0.99))
        mx = float(per_ray.max())
        share = float((per_ray > thr).float().mean())
        out[k] = (med, p99, mx, share, med <= tol["median"] and p99 <= tol["p99"]
                  and mx <= max_tol and share <= share_tol)
    return out


def consistency_report(c: Dict[str, torch.Tensor], dtype: torch.dtype
                       ) -> Dict[str, Tuple[Tuple[float, ...], bool]]:
    """``consistency_errors`` read against ``CONSISTENCY_TOL[dtype]``:
    ``kept`` (share of rays), ``sdf_point`` (median, share over the
    threshold, max), ``draw`` (judged share, max over judged rays)."""
    tol = CONSISTENCY_TOL[dtype]
    kept = float(c["kept"].float().mean())
    sp = c["sdf_point"].float()
    med_tol, (thr, share_tol), max_tol = tol["sdf_point"]
    med, share, mx = float(sp.median()), float((sp > thr).float().mean()), float(sp.max())
    judged = ~torch.isnan(c["draw"])
    share_judged = float(judged.float().mean())
    worst = float(c["draw"][judged].max()) if bool(judged.any()) else float("nan")
    return {
        "kept": ((kept,), kept == 1.0),
        "sdf_point": ((med, share, mx), med <= med_tol and share <= share_tol and mx <= max_tol),
        "draw": ((share_judged, worst), share_judged >= tol["judged"] and worst <= tol["draw"]),
    }


def consistency_errors(spec, params: Dict[str, Any], rays_o: torch.Tensor,
                       rays_d_z: torch.Tensor, t: torch.Tensor, z0: torch.Tensor,
                       z: torch.Tensor, sdf: torch.Tensor, n_importance: int, n_rounds: int,
                       sampling_dtype: torch.dtype = torch.float32,
                       cdf_tol: float = CDF_TOL) -> Dict[str, torch.Tensor]:
    """Per-ray checks of an upsampling result (z, sdf) [R, n] against the
    plain math applied to its own samples, free of the twin comparison's
    cascade (a moved sample moves every later round):

    * ``kept``: z ascends and holds every given sample z0 exactly;
    * ``sdf_point``: max over samples of |sdf - the plain SDF chain at z|;
    * ``draw``: every round replayed from the result's own list (z0, then
      the samples matched in earlier rounds, with their sdf): the plain
      NeuS weights and midpoint draws, each matched to the nearest unused
      sample, as a multiple of what a cdf error of ``cdf_tol`` allows
      (1e-6 + bin width * cdf_tol / denominator). NaN where a ray is not
      judged: a draw within ``cdf_tol`` of a bin edge or of the 1e-5
      denominator floor, or a sample within 1e-5 of the unit sphere (the
      inside gate), where the two sides may pick differently.
    """
    from endosurf_tpu_torch.models.fields import sdf_observed
    from endosurf_tpu_torch.ops.neus import upsample_weights_from_sdf

    n_rays, n = z.shape
    n0, k = z0.shape[1], n_importance // n_rounds
    with torch.no_grad():
        pts = rays_o[:, None, :] + rays_d_z[:, None, :] * z[..., None]
        tt = t[:, None, :].expand(n_rays, n, 1)
        plain = sdf_observed(spec, params, pts.reshape(-1, 3), tt.reshape(-1, 1),
                             _dtype_precision(sampling_dtype)).reshape(n_rays, n)
        sdf_point = (sdf - plain).abs().amax(dim=-1)
        eq = z[:, None, :] == z0[:, :, None]                          # [R, n0, n]
        kept = eq.any(-1).all(-1) & (z.diff(dim=-1) >= 0).all(-1)
        # z0's columns: of equal values (a draw can land exactly on a
        # sample), the first as many as z0 holds
        first = torch.searchsorted(z.contiguous(), z.contiguous(), right=False)
        rank = torch.arange(n, device=z.device) - first
        listed = rank < eq.sum(1)                                     # [R, n]
        judged = kept.clone()
        draw = torch.zeros(n_rays, dtype=torch.float32, device=z.device)
        u = torch.linspace(0.5 / k, 1.0 - 0.5 / k, k, device=z.device)
        for i in range(n_rounds):
            s = n0 + i * k
            order = torch.sort((~listed).to(torch.int8), dim=-1, stable=True).indices[:, :s]
            zs, ss = torch.gather(z, 1, order), torch.gather(sdf, 1, order)
            radius = torch.linalg.norm(rays_o[:, None, :] + rays_d_z[:, None, :] * zs[..., None],
                                       dim=-1)
            w = upsample_weights_from_sdf(zs, ss, radius, 64.0 * 2 ** i) + 1e-5
            cdf = torch.cumsum(w / w.sum(-1, keepdim=True), dim=-1)
            cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)   # [R, s]
            gap = cdf[:, None, :] - u[None, :, None]                       # [R, k, s]
            inds = (gap <= 0).sum(-1)
            below, above = torch.clamp(inds - 1, min=0), torch.clamp(inds, max=s - 1)
            c_lo, c_hi = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
            z_lo, z_hi = torch.gather(zs, 1, below), torch.gather(zs, 1, above)
            denom_raw = c_hi - c_lo
            denom = torch.where(denom_raw < 1e-5, torch.ones_like(denom_raw), denom_raw)
            d = z_lo + (u - c_lo) / denom * (z_hi - z_lo)                  # [R, k]
            judged &= ~((gap.abs().amin(-1) < cdf_tol).any(-1)
                        | ((denom_raw - 1e-5).abs() < cdf_tol).any(-1)
                        | ((radius - 1.0).abs() < 1e-5).any(-1))
            got = torch.empty_like(d)
            for j in range(k):      # each draw takes the nearest sample not yet taken
                dist = (z - d[:, j:j + 1]).abs().masked_fill(listed, float("inf"))
                pick = dist.argmin(dim=-1, keepdim=True)
                got[:, j:j + 1] = torch.gather(z, 1, pick)
                listed = listed.scatter(1, pick, True)
            bound = 1e-6 + (z_hi - z_lo) * cdf_tol / denom
            draw = torch.maximum(draw, ((got - d).abs() / bound).amax(-1))
        draw = torch.where(judged, draw, torch.full_like(draw, float("nan")))
    return {"kept": kept, "sdf_point": sdf_point, "draw": draw}


def fine_resample_math(z_vals: torch.Tensor, sigma: torch.Tensor, d_norm: torch.Tensor,
                       n_new: int = 64) -> torch.Tensor:
    """D-NeRF importance resampling: z_vals [R, n0] sorted, sigma [R, n0]
    the coarse density (after the relu), d_norm [R, 1] = |rays_d| -> z
    [R, n0 + n_new] sorted.

    The coarse weights of raw2outputs (``1 - exp(-sigma * dist * |d|)``,
    dists with a 1e10 tail, the exclusive cumprod with +1e-10), then
    ``sample_pdf`` of weights 1 .. n0-2 (+1e-5 each) over the n0 - 1
    midpoint bins with the deterministic draws u_j = (j + 0.5) / n_new
    (searchsorted right, ``denom < 1e-5 -> 1``), then the sorted merge."""
    from endosurf_tpu_torch.ops.neus import exclusive_cumprod_weights
    from endosurf_tpu_torch.ops.pdf import sample_pdf
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    alpha = 1.0 - torch.exp(-sigma * (dists * d_norm))
    weights = exclusive_cumprod_weights(alpha, eps=1e-10)
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_new = sample_pdf(z_mid, weights[..., 1:-1], n_new)
    return torch.sort(torch.cat([z_vals, z_new], dim=-1), dim=-1).values


# The resample kernel against fine_resample_math, on the per-ray max
# absolute error of the resampled depths: (median, p99, max). Both sides run
# the same arithmetic; the plain version sums the cdf and the transmittance
# in another order, so a draw that sits on a cdf step or in a bin holding
# only the 1e-5 weight floor moves by up to a fraction of a bin on a few
# rays in a thousand (the max), while the median and p99 hold the bulk. Set
# from H100 readings (PERF.md, PR 6; chip_smoke's 2048 train rays with
# sigma 1.0 around the depth, seeded and opaque nets; the card tests' 1024
# rays at 64 + 64, 32 + 16 and 8 + 8): sound median <= 1.8e-5, p99 <=
# 9.7e-4, max <= 7.9e-3; draws half a step early read medians >= 0.13 (train
# rays) and >= 1.3e-2 (card rays), coarse weights without |d| a median >=
# 3.1e-4 and a p99 >= 1.3e-2.
RESAMPLE_PARITY_TOL = (1e-4, 3e-3, 3e-2)


def resample_parity(got: torch.Tensor, ref: torch.Tensor
                    ) -> Tuple[float, float, float, bool]:
    """(median, p99, max) of the per-ray max |z_got - z_ref| and whether all
    three are within ``RESAMPLE_PARITY_TOL``."""
    per_ray = (got - ref).abs().amax(dim=-1).float()
    q = torch.quantile(per_ray, torch.tensor([0.5, 0.99], device=per_ray.device))
    stats = (float(q[0]), float(q[1]), float(per_ray.max()))
    return (*stats, all(v <= t for v, t in zip(stats, RESAMPLE_PARITY_TOL)))


def fine_resample_shape_supported(n0: int, n_new: int) -> bool:
    """The kernel's limits: 3 to 64 coarse depths and 1 to 64 draws (JAX's
    kernel takes only 64 + 64)."""
    return 3 <= n0 <= RESAMPLE_MAX and 1 <= n_new <= RESAMPLE_MAX


def resample_edge_inputs(n0: int, seed: int = 0, rays_per_kind: int = 8
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Seeded (z_vals [R, n0] sorted, sigma [R, n0], d_norm [R, 1]) float32 CPU
    tensors, ``rays_per_kind`` rays of each ``RESAMPLE_EDGE_KINDS`` kind in
    that order: "zero" all-zero sigma (a pdf of the 1e-5 weight floor
    alone); "one_opaque" sigma 0 but at one sample (the other bins' cdf steps
    fall under 1e-5, the ``denom < 1e-5 -> 1`` rule); "huge" sigma 1e30 at a
    few samples (alpha exactly 1, the transmittance down to 0); "duplicates"
    random sigma on depths rounded to multiples of 1/8, so repeated in runs,
    the middle two equal (zero distances, zero-width bins); "on_depth"
    all-zero sigma on such depths with the middle six equal, so that draws
    in zero-width bins (the middle one at any n_new) equal a coarse depth
    and each other (ties in the merge); "random" random sigma."""
    import numpy as np
    rng = np.random.default_rng(seed)
    kinds = len(RESAMPLE_EDGE_KINDS)
    n = kinds * rays_per_kind
    z = np.sort(rng.uniform(0.5, 3.0, (n, n0)), axis=-1).astype(np.float32)
    sigma = np.maximum(rng.normal(0.0, 3.0, (n, n0)), 0).astype(np.float32)
    rows = {k: slice(i * rays_per_kind, (i + 1) * rays_per_kind)
            for i, k in enumerate(RESAMPLE_EDGE_KINDS)}
    sigma[rows["zero"]] = 0.0
    sigma[rows["on_depth"]] = 0.0
    opaque = sigma[rows["one_opaque"]]
    opaque[:] = 0.0
    opaque[np.arange(rays_per_kind), rng.integers(0, n0, rays_per_kind)] = 50.0
    huge = sigma[rows["huge"]]
    huge[rng.uniform(size=huge.shape) < 0.1] = 1e30
    huge[:, n0 // 2] = 1e30
    for kind in ("duplicates", "on_depth"):
        z[rows[kind]] = np.round(z[rows[kind]] * 8.0) / 8.0
    z[rows["duplicates"], n0 // 2 - 1] = z[rows["duplicates"], n0 // 2]
    mid = slice(max(n0 // 2 - 3, 0), n0 // 2 + 3)
    z[rows["on_depth"], mid] = z[rows["on_depth"], n0 // 2, None]
    z = np.sort(z, axis=-1)
    dn = rng.uniform(0.9, 1.3, (n, 1)).astype(np.float32)
    return torch.from_numpy(z), torch.from_numpy(sigma), torch.from_numpy(dn)


def fused_fine_resample_reference(z_vals: torch.Tensor, sigma: torch.Tensor,
                                  d_norm: torch.Tensor, n_new: int = 64) -> torch.Tensor:
    """The plain version: ``fine_resample_math`` without gradient."""
    with torch.no_grad():
        return fine_resample_math(z_vals, sigma, d_norm, n_new)


def fused_fine_resample_cuda(z_vals: torch.Tensor, sigma: torch.Tensor, d_norm: torch.Tensor,
                             n_new: int = 64) -> torch.Tensor:
    """Launch the resample kernel (``csrc/fused_render_dnerf.cu``) on the
    current stream: z_vals [R, n0] sorted, sigma [R, n0] after the noise and the
    relu, d_norm [R, 1] -> z [R, n0 + n_new] sorted."""
    from endosurf_tpu_torch.kernels.build import load_library
    if z_vals.device.type != "cuda":
        raise ValueError(f"fused_fine_resample_cuda needs CUDA tensors, got {z_vals.device}")
    if z_vals.ndim != 2:
        raise ValueError(f"z_vals must be [R, n0], got {tuple(z_vals.shape)}")
    n_rays, n0 = z_vals.shape
    if tuple(sigma.shape) != (n_rays, n0) or tuple(d_norm.shape) != (n_rays, 1):
        raise ValueError(f"expected sigma [R, n0], d_norm [R, 1]; got {tuple(sigma.shape)}, "
                         f"{tuple(d_norm.shape)} for z {tuple(z_vals.shape)}")
    if not fine_resample_shape_supported(n0, n_new):
        raise ValueError(f"the resample kernel does not take {n0} + {n_new} samples")
    device = z_vals.device
    z, sig, dn = (a.detach().to(torch.float32).contiguous() for a in (z_vals, sigma, d_norm))
    if sig.device != device or dn.device != device:
        raise ValueError(f"z on {device}, sigma on {sig.device}, d_norm on {dn.device}")
    out = torch.empty(n_rays, n0 + n_new, dtype=torch.float32, device=device)
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.fused_fine_resample_launch(z.data_ptr(), sig.data_ptr(), dn.data_ptr(), n_rays,
                                             n0, n_new, out.data_ptr(),
                                             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused_fine_resample CUDA launch failed: "
                           + lib.fused_render_error_string(err).decode())
    LAUNCHES["fused_fine_resample"] += 1
    return out


def fused_fine_resample(z_vals: torch.Tensor, sigma: torch.Tensor, d_norm: torch.Tensor,
                        n_new: int = 64) -> torch.Tensor:
    """CUDA tensors run the kernel (a shape outside its limits raises); CPU
    tensors run the plain version."""
    if z_vals.device.type == "cuda":
        return fused_fine_resample_cuda(z_vals, sigma, d_norm, n_new)
    if z_vals.device.type != "cpu":
        raise ValueError(f"no fused_fine_resample for device {z_vals.device}")
    return fused_fine_resample_reference(z_vals, sigma, d_norm, n_new)


def upsample_shape_supported(n0: int, n_importance: int, n_rounds: int) -> bool:
    """<= 64 samples in all with <= 8 new per round (the JAX kernel's gate)."""
    if n_rounds <= 0 or n_importance % n_rounds != 0:
        return False
    k = n_importance // n_rounds
    return 0 < k <= KNEW_MAX and n0 + n_importance <= KMAX


def fused_upsample_z_reference(spec, params: Dict[str, Any], rays_o: torch.Tensor,
                               rays_d_z: torch.Tensor, t: torch.Tensor,
                               z_vals: torch.Tensor, n_importance: int, n_rounds: int,
                               sampling_dtype: torch.dtype = torch.float32,
                               return_sdf: bool = False):
    """Plain PyTorch twin: ``upsample_z`` under no_grad."""
    from endosurf_tpu_torch.models.endosurf import RenderSpec, upsample_z
    rspec = RenderSpec(n_samples=z_vals.shape[1], n_importance=n_importance,
                       up_sample_steps=n_rounds)
    with torch.no_grad():
        return upsample_z(spec, rspec, params, rays_o, rays_d_z, t, z_vals,
                          _dtype_precision(sampling_dtype), return_sdf)


def to_float64(tree):
    """A parameter tree with its floating-point tensors in float64."""
    if isinstance(tree, dict):
        return {k: to_float64(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_float64(v) for v in tree]
    return tree.double() if torch.is_tensor(tree) and tree.is_floating_point() else tree


def sampling_params_float64(params: Dict[str, Any], precision: str = "default"
                            ) -> Dict[str, Any]:
    """Float64 copies of ``params`` whose deform and SDF nets hold the
    weights the sampling kernels pack (``pack_operands``: the weight norm in
    float32, then, under ``precision`` "default", rounded to bf16) as plain
    ``{w, b}`` layers: the float64 yardsticks' parameters."""
    from endosurf_tpu_torch.ops.mlp import effective_weight, operand
    p64 = to_float64(params)
    for name in ("deform_network", "sdf_network"):
        if name in params:
            p64[name] = {**p64[name], "layers": [
                {"w": operand(effective_weight(layer), precision).double(),
                 "b": layer["b"].double()} for layer in params[name]["layers"]]}
    return p64


def fused_upsample_z_float64(spec, params: Dict[str, Any], rays_o: torch.Tensor,
                             rays_d_z: torch.Tensor, t: torch.Tensor, z_vals: torch.Tensor,
                             n_importance: int, n_rounds: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 upsampling's float64 yardstick, (z, sdf) in float64: the
    plain upsampling (``fused_upsample_z_reference`` with ``return_sdf``)
    with the kernels' bf16 operand roundings and float64 arithmetic between
    them. The deform and SDF weights are the bf16 values ``pack_operands``
    packs (``sampling_params_float64``); every activation and encoding
    operand is rounded to bf16 from its float64 value."""
    return fused_upsample_z_reference(spec, sampling_params_float64(params),
                                      *(a.double() for a in (rays_o, rays_d_z, t, z_vals)),
                                      n_importance, n_rounds, torch.bfloat16, True)


# (meta, buffer floats, device, nets) -> (gather index of the fragment
# extension, its float offsets): a fragment layout, built once per weight layout
_FRAG_INDEX: Dict[Tuple, Tuple[torch.Tensor, List[int]]] = {}
# pack_sampling's extension: the deform net's hidden-layer W, then the SDF's
SWEEP_FRAG_NETS = ((0, False, False), (1, False, False))


def frag_index(meta: List[int], n_w: int, device, nets=SWEEP_FRAG_NETS
               ) -> Tuple[torch.Tensor, List[int]]:
    """For a float32 pack of n_w floats described by ``meta`` (with one zero
    appended at index n_w): the index, per bf16 element of a fragment
    extension, into that buffer, and each layer's float offset in the whole
    pack (-1 for a layer it leaves out). ``nets`` lists the extension's
    blocks in order, each ``(net, transposed, output)``: net 0 deform, 1
    SDF (or the D-NeRF density), 2 colour; the W [in, out] (or W^T [out,
    in], from the meta's W^T offsets) of the layers its meta has, in mma
    fragment order (``fused_train_cuda.mma_frags``), the output layer only
    with ``output`` (True: whole; a slice: those of its columns, W[:, output]
    or W^T[output, :]), none for an absent net. Padding and the 16-byte
    alignment gaps point at the zero."""
    key = (tuple(meta), n_w, str(device), repr(nets))
    if key not in _FRAG_INDEX:
        parts, offs, size = [], [], n_w
        for q, transposed, output in nets:
            net = meta[8 + q * META_NET:8 + (q + 1) * META_NET]
            for l in range(NL):
                last = l == net[0] - 1
                if l >= net[0] or (last and not output):
                    offs.append(-1)
                    continue
                gap = -size % 4
                parts.append(torch.full((2 * gap,), n_w, dtype=torch.int64))
                size += gap
                k, n = net[2 + l], net[2 + NL + l]
                if transposed:
                    k, n = n, k
                off = net[2 + (4 if transposed else 2) * NL + l]
                idx = off + torch.arange(k * n).view(k, n)
                if last and output is not True:
                    idx = idx[output] if transposed else idx[:, output]
                frag = mma_frags(idx.contiguous(), fill=n_w)
                offs.append(size)
                parts.append(frag)
                size += frag.numel() // 2
        _FRAG_INDEX[key] = (torch.cat(parts).to(device), offs)
    return _FRAG_INDEX[key]


def frag_extension(w: torch.Tensor, meta: List[int], nets=SWEEP_FRAG_NETS
                   ) -> Tuple[torch.Tensor, List[int]]:
    """A float32 pack ``w`` (bf16-rounded weights) with the fragment
    extension ``frag_index`` lays out appended, and the extension's offsets."""
    idx, offs = frag_index(meta, w.numel(), w.device, nets)
    ext = torch.cat([w, w.new_zeros(1)])[idx].to(torch.bfloat16).view(torch.float32)
    return torch.cat([w, ext]), offs


def pack_sampling(spec, params: Dict[str, Any], dtype: torch.dtype
                  ) -> Tuple[torch.Tensor, List[int]]:
    """The upsampling kernel's pack: ``pack_operands``' buffer and meta and,
    in bf16, the deform and SDF nets' hidden-layer W [in, out] (the packed,
    bf16-rounded values) as bf16 mma fragments (``fused_train_cuda.
    mma_frags``), each 16-byte aligned after the float32 layout, their float
    offsets appended to the meta: the deform net's NL, then the SDF's NL, -1
    for the output layers and an absent deform net (``csrc/sweep_tc.cuh``
    reads them). The float32 layout is ``pack_operands``' byte for byte. The
    march and the grid query take this pack too; the render's
    ``fused_render.pack_render`` extends it."""
    w, meta = pack_operands(spec, params, dtype)
    if dtype != torch.bfloat16:
        return w, meta
    w, offs = frag_extension(w, meta)
    return w, meta + offs


def cached_sampling_pack(cache: PackCache, spec, params: Dict[str, Any], dtype: torch.dtype):
    """(``pack_sampling``'s (buffer, ctypes meta), whether it was built now),
    cached in ``cache`` on the deform and SDF parameter tensors
    (``fused_render.cached_pack``: an in-place update, an optimizer step,
    repacks)."""
    @torch.no_grad()
    def build():
        w, meta = pack_sampling(spec, params, dtype)
        return w, (ctypes.c_longlong * len(meta))(*meta)
    return cached_pack(cache, spec, params, ("deform_network", "sdf_network"), dtype, build)


def fused_upsample_z_cuda(spec, params: Dict[str, Any], rays_o: torch.Tensor,
                          rays_d_z: torch.Tensor, t: torch.Tensor, z_vals: torch.Tensor,
                          n_importance: int, n_rounds: int,
                          sampling_dtype: torch.dtype = torch.float32,
                          return_sdf: bool = False):
    """Launch the CUDA kernel (``csrc/fused_sampler.cu``) on the current stream."""
    from endosurf_tpu_torch.kernels.build import load_library

    if z_vals.device.type != "cuda":
        raise ValueError(f"fused_upsample_z_cuda needs CUDA tensors, got {z_vals.device}")
    n_rays, n0 = z_vals.shape if z_vals.ndim == 2 else (None, None)
    if n_rays is None or rays_o.shape != (n_rays, 3) or rays_d_z.shape != (n_rays, 3) \
            or t.shape != (n_rays, 1):
        raise ValueError(f"expected o, d_z [R, 3], t [R, 1], z [R, n0]; got "
                         f"{tuple(rays_o.shape)}, {tuple(rays_d_z.shape)}, "
                         f"{tuple(t.shape)}, {tuple(z_vals.shape)}")
    if n0 < 2 or not upsample_shape_supported(n0, n_importance, n_rounds):
        raise ValueError(f"unsupported sample counts {n0}+{n_importance}/{n_rounds}")
    if not cuda_spec_supported(spec):
        raise ValueError(f"the CUDA upsample kernel does not take {spec}: {spec_refusal(spec)}")
    if sampling_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {sampling_dtype}")
    device = z_vals.device
    lib = load_library()
    (w, meta_arr), built = cached_sampling_pack(_SAMPLING_PACKS, spec, params, sampling_dtype)
    PACKS["sampling"] += built
    with torch.no_grad():
        rays7 = torch.cat([rays_o, rays_d_z, t], dim=-1).to(torch.float32).contiguous()
    if w.device != device or rays7.device != device:
        raise ValueError(f"params on {w.device}, rays on {rays7.device}, z on {device}")
    z0 = z_vals.to(torch.float32).contiguous()
    scratch = torch.empty(lib.fused_upsample_scratch_floats(n_rays),
                          dtype=torch.float32, device=device)
    z_out = torch.empty(n_rays, KMAX, dtype=torch.float32, device=device)
    sdf_out = torch.empty(n_rays, KMAX, dtype=torch.float32, device=device)
    assert len(meta_arr) == lib.fused_render_meta_len() + (
        2 * NL if sampling_dtype == torch.bfloat16 else 0)
    with torch.cuda.device(device):   # the launch runs on the current device
        err = lib.fused_upsample_launch(
            rays7.data_ptr(), z0.data_ptr(), n_rays, n0, w.data_ptr(), meta_arr,
            int(sampling_dtype == torch.bfloat16), n_importance // n_rounds, n_rounds,
            int(return_sdf), scratch.data_ptr(), z_out.data_ptr(), sdf_out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused_upsample_z CUDA launch failed: "
                           + lib.fused_render_error_string(err).decode())
    LAUNCHES["fused_upsample_z"] += 1
    n = n0 + n_importance
    z = z_out[:, :n]
    return (z, sdf_out[:, :n]) if return_sdf else z


def fused_upsample_z(spec, params: Dict[str, Any], rays_o: torch.Tensor,
                     rays_d_z: torch.Tensor, t: torch.Tensor, z_vals: torch.Tensor,
                     n_importance: int, n_rounds: int,
                     sampling_dtype: torch.dtype = torch.float32, return_sdf: bool = False):
    """CUDA tensors run the kernel; CPU tensors run the plain twin."""
    if z_vals.device.type == "cuda":
        fn = fused_upsample_z_cuda
    elif z_vals.device.type == "cpu":
        fn = fused_upsample_z_reference
    else:
        raise ValueError(f"no fused_upsample_z for device {z_vals.device}")
    return fn(spec, params, rays_o, rays_d_z, t, z_vals, n_importance, n_rounds,
              sampling_dtype, return_sdf)


# ---------------------------------------------------------------------------
# the sphere-traced ray march
# ---------------------------------------------------------------------------

# The march judged per ray. A sign change within float noise of tau at one
# scan sample can move the chosen crossing by a bin (or make a ray valid on
# one side only), and then the depth jumps by about chord / 127; so
#  * "flip": the share of rays whose valid flag or, both valid, crossing
#    index differs from the twin's;
#  * "depth": the (median, p99) of |depth - twin| over rays valid on both
#    sides with the same index;
# and, on the kernel's own output against the plain SDF at the matching
# precision (march_consistency), free of the twin's flips:
#  * "bracket": the largest amount by which a valid ray's final bracket
#    ends sit on the wrong side of tau (sdf(d_low) > tau > sdf(d_high));
#  * "residual": the (median, p99, max) of |sdf(depth) - tau| over valid
#    rays, which a missing secant step raises.
# Set from H100 readings (PERF.md, PR 4): chip_smoke's 1024 train rays
# (31-50 % valid) and the card tests' cells (64 / 1024 / 4099 rays, three
# nets, 0-100 % valid), two weight seeds. Sound float32: flips <= 0.024 %
# (1 ray of 4099), depth median 2.4e-7 and p99 1.8e-6, bracket 7.2e-7,
# residual max 7.2e-7. Sound bf16: flips <= 0.098 % (1 ray of 1024), depth
# median 2.4e-7 but p99 up to 1.2e-3 (64 rays), bracket 2.7e-3, residual
# median 7.2e-4, p99 4.0e-3, max 6.3e-3: the bf16 SDF is noisy at ~1e-3
# along a ray, so the secant settles anywhere in a ~1e-3 band around the
# root and the plain SDF at the kernel's points moves by an operand
# rounding. The kernel at the other precision: flips >= 5.1 %, depth median
# >= 6.8e-4. Planted faults (tests/test_torch_cuda.py): a crossing one bin
# late on 1 ray in 64 turns those rays invalid (flips 0.59 %) in both modes;
# the secant steps skipped on 1 ray in 64 raise the float32 residual max to
# 2.0e-5, under bf16's noise.
MARCH_TOL = {
    torch.float32: {"flip": 0.003, "depth": (2e-6, 2e-5), "bracket": 1e-5,
                    "residual": (1e-6, 5e-6, 1e-5)},
    torch.bfloat16: {"flip": 0.003, "depth": (1e-5, 3e-3), "bracket": 5e-3,
                     "residual": (2e-3, 1e-2, 1e-2)},
}


# The bf16 march against its float64 yardstick (fused_ray_march_float64,
# march_float64_distance): the share of flipped crossings, the depth (median,
# p99) and the residual against the yardstick's (median, p99) over rays with
# the same crossing. The yardstick runs the kernel's float32 glue, so only
# the SDF's arithmetic differs: the tensor-core sweep, near exact between its
# bf16 roundings, equals it on the median ray and tips a rounding on 0-6 %
# of them, where the SIMT sweep's float32 sums move 20-32 % (the share off
# by more than 1e-6, printed, not limited). Set from H100 readings (PERF.md
# §6; the card cells at tau 0, -0.3 and -0.4 and chip_smoke's train rays,
# two seeds; NVIDIA H100 80GB HBM3): sound flips <= 1 ray (0.098 % of 1024),
# depth median 0, p99 <= 2.16e-4, residual median 0, p99 <= 2.24e-3 (the
# bf16 SDF jumps ~1e-3 across the root); the planted faults on 1 ray in 64:
# the crossing a bin late 0.59 % flips, the secant steps skipped depth p99
# 4.34e-4, the secant sweeps' SDF scaled by 0.1 % at tau -0.4 5.51e-4 (at
# -0.3 3.40e-4; at tau 0 a scale moves no root: 8.6e-5, under the sound
# tips).
MARCH_FLOAT64_TOL = {"flip": 0.003, "depth": (1e-6, 3e-4), "residual": (1e-6, 5e-3)}


def march_float64_ok(dist: Dict[str, Tuple[float, ...]]) -> bool:
    """Whether a march's ``march_float64_distance`` reading is within
    ``MARCH_FLOAT64_TOL``."""
    return all(all(v <= t for v, t in zip(dist[k], (tol if isinstance(tol, tuple) else (tol,))))
               for k, tol in MARCH_FLOAT64_TOL.items())


def march_parity(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                 dtype: torch.dtype) -> Dict[str, Tuple[Tuple[float, ...], bool]]:
    """Kernel vs twin: ``flip`` (share of rays) and ``depth`` (median, p99)
    against ``MARCH_TOL[dtype]``."""
    tol = MARCH_TOL[dtype]
    vg, vr = got["valid"][:, 0], ref["valid"][:, 0]
    both = vg & vr
    same = both & (got["idx"] == ref["idx"])
    flip = float(((vg != vr) | (both & (got["idx"] != ref["idx"]))).float().mean())
    d = (got["depth"][:, 0] - ref["depth"][:, 0]).abs()[same].float()
    med = float(d.median()) if d.numel() else 0.0
    p99 = float(torch.quantile(d, 0.99)) if d.numel() else 0.0
    return {"flip": ((flip,), flip <= tol["flip"]),
            "depth": ((med, p99), med <= tol["depth"][0] and p99 <= tol["depth"][1])}


def march_consistency(spec, params: Dict[str, Any], rays_o: torch.Tensor,
                      rays_d_z: torch.Tensor, t: torch.Tensor, out: Dict[str, torch.Tensor],
                      dtype: torch.dtype, tau: float = 0.0
                      ) -> Dict[str, Tuple[Tuple[float, ...], bool]]:
    """A march result on its own, against the plain SDF at ``dtype``'s
    precision on its valid rays: ``bracket`` (max over rays of how far
    sdf(d_low) - tau and tau - sdf(d_high) fall below 0) and ``residual``
    (median, p99, max of |sdf(depth) - tau|), against ``MARCH_TOL[dtype]``."""
    from endosurf_tpu_torch.models.fields import sdf_observed
    tol = MARCH_TOL[dtype]
    valid = out["valid"][:, 0]
    if not bool(valid.any()):
        return {"bracket": ((0.0,), True), "residual": ((0.0, 0.0, 0.0), True)}
    o, dz, tt = rays_o[valid], rays_d_z[valid], t[valid]
    prec = _dtype_precision(dtype)
    with torch.no_grad():
        def sdf_at(depth):
            return sdf_observed(spec, params, o + depth[:, None] * dz, tt, prec)[:, 0] - tau
        lo, hi = sdf_at(out["d_low"][valid]), sdf_at(out["d_high"][valid])
        res = sdf_at(out["depth"][valid, 0]).abs().float()
    wrong = float(torch.maximum(torch.relu(-lo), torch.relu(hi)).max())
    med, p99, mx = float(res.median()), float(torch.quantile(res, 0.99)), float(res.max())
    r_tol = tol["residual"]
    return {"bracket": ((wrong,), wrong <= tol["bracket"]),
            "residual": ((med, p99, mx), med <= r_tol[0] and p99 <= r_tol[1] and mx <= r_tol[2])}


def fused_ray_march_reference(spec, params: Dict[str, Any], rays_o: torch.Tensor,
                              rays_d_z: torch.Tensor, t: torch.Tensor, near: torch.Tensor,
                              far: torch.Tensor, tau: float = 0.0, n_steps: int = 128,
                              n_secant: int = 8, sampling_dtype: torch.dtype = torch.float32
                              ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch twin: ``models.endosurf.march_math`` under no_grad."""
    from endosurf_tpu_torch.models.endosurf import march_math
    with torch.no_grad():
        return march_math(spec, params, rays_o, rays_d_z, t, near, far, tau, n_steps,
                          n_secant, _dtype_precision(sampling_dtype))


def fused_ray_march_float64(spec, params: Dict[str, Any], rays_o: torch.Tensor,
                            rays_d_z: torch.Tensor, t: torch.Tensor, near: torch.Tensor,
                            far: torch.Tensor, tau: float = 0.0, n_steps: int = 128,
                            n_secant: int = 8, sampling_dtype: torch.dtype = torch.bfloat16
                            ) -> Dict[str, torch.Tensor]:
    """The bf16 march's float64 yardstick: ``march_math`` on the kernel's
    float32 glue -- the depths, the crossing rule, the validity and the
    secant steps in float32 as the kernel computes them, each sample point
    o + z d_z rounded once to float32 (the kernel's FMA) -- with every SDF in
    float64 on the kernel's weights (``sampling_params_float64``,
    bf16-rounded for ``sampling_dtype`` bf16) and ``sampling_dtype``'s
    operand roundings, rounded once to float32 as the kernel writes it. So
    only the SDF's arithmetic differs from the kernel's: a bf16 rounding
    that a float32 coordinate or a float32 secant step tips is the
    kernel's and the yardstick's alike. Returns depth, valid [R, 1], d_low,
    d_high and idx [R]."""
    from endosurf_tpu_torch.models.endosurf import march_math
    from endosurf_tpu_torch.models.fields import sdf_observed
    prec = _dtype_precision(sampling_dtype)
    p64 = sampling_params_float64(params, prec)
    f32 = torch.float32
    o, dz, tt, nr, fr_ = (a.to(f32) for a in (rays_o, rays_d_z, t, near, far))
    n_rays = o.shape[0]

    def sdf_at(z):
        pts = (o.double()[:, None, :] + z.double()[..., None] * dz.double()[:, None, :]).to(f32)
        tk = tt[:, None, :].expand(n_rays, z.shape[1], 1).reshape(-1, 1)
        return sdf_observed(spec, p64, pts.reshape(-1, 3).double(), tk.double(),
                            prec).reshape(n_rays, -1).to(f32)
    with torch.no_grad():
        return march_math(spec, params, o, dz, tt, nr, fr_, tau, n_steps, n_secant, prec,
                          sdf_at)


def march_float64_distance(spec, params: Dict[str, Any], rays_o: torch.Tensor,
                           rays_d_z: torch.Tensor, t: torch.Tensor, near: torch.Tensor,
                           far: torch.Tensor, outs: Dict[str, Dict[str, torch.Tensor]],
                           tau: float = 0.0) -> Dict[str, Dict[str, Tuple[float, ...]]]:
    """bf16 marches (``outs``: name -> a march result on these rays) against
    the float64 yardstick (``fused_ray_march_float64``): {name: {"flip":
    (share of rays whose valid flag or crossing index differs from the
    yardstick's,), "depth": (median, p99) of |depth - yardstick| and
    "residual": (median, p99) of |sdf64(depth) - sdf64(yardstick depth)|,
    both over rays valid on both with the same index, the SDF in float64 on
    the kernel's bf16 weights at the depth's point o + depth d_z in float64,
    "off": (share of those rays whose depth is off by more than 1e-6,)}}. The residual is held against the
    yardstick's own: along a ray the bf16-rounded SDF jumps by up to ~1e-3
    across its root, so the secant ends 4.6-7.8e-4 (median) off tau for the
    yardstick itself, and |sdf64(depth) - tau| cannot tell a nearer march
    from a farther one."""
    from endosurf_tpu_torch.models.fields import sdf_observed
    ins = (rays_o, rays_d_z, t, near, far)
    ref = fused_ray_march_float64(spec, params, *ins, tau)
    p64 = sampling_params_float64(params)

    def med_p99(v):
        return ((float(v.median()), float(torch.quantile(v, 0.99))) if v.numel()
                else (0.0, 0.0))

    def sdf_at(depth, rows):
        with torch.no_grad():
            pts = rays_o.double()[rows] + depth.double()[rows] * rays_d_z.double()[rows]
            return sdf_observed(spec, p64, pts, t.double()[rows], "default")[:, 0]
    res = {}
    for name, out in outs.items():
        vg, vr = out["valid"][:, 0], ref["valid"][:, 0]
        both = vg & vr
        same = both & (out["idx"] == ref["idx"])
        flip = float(((vg != vr) | (both & (out["idx"] != ref["idx"]))).double().mean())
        depth = (out["depth"][:, 0].double() - ref["depth"][:, 0])[same].abs()
        resid = (sdf_at(out["depth"], same) - sdf_at(ref["depth"], same)).abs()
        res[name] = {"flip": (flip,), "depth": med_p99(depth), "residual": med_p99(resid),
                     "off": (float((depth > 1e-6).double().mean()) if depth.numel() else 0.0,)}
    return res


def fused_ray_march_cuda(spec, params: Dict[str, Any], rays_o: torch.Tensor,
                         rays_d_z: torch.Tensor, t: torch.Tensor, near: torch.Tensor,
                         far: torch.Tensor, tau: float = 0.0, n_steps: int = 128,
                         n_secant: int = 8, sampling_dtype: torch.dtype = torch.float32,
                         simt: bool = False) -> Dict[str, torch.Tensor]:
    """Launch the CUDA march (``csrc/fused_sampler.cu``) on the current
    stream: in bf16 its sweeps on tensor cores (``simt`` runs the SIMT sweep
    instead, the float64 comparison only), in float32 the SIMT sweep. The
    pack (``pack_sampling``) is cached with the upsampling's
    (``cached_sampling_pack``)."""
    from endosurf_tpu_torch.kernels.build import load_library

    if rays_o.device.type != "cuda":
        raise ValueError(f"fused_ray_march_cuda needs CUDA tensors, got {rays_o.device}")
    n_rays = rays_o.shape[0] if rays_o.ndim == 2 else None
    if n_rays is None or any(a.shape != (n_rays, k) for a, k in (
            (rays_o, 3), (rays_d_z, 3), (t, 1), (near, 1), (far, 1))):
        raise ValueError(f"expected o, d_z [R, 3], t, near, far [R, 1]; got "
                         f"{[tuple(a.shape) for a in (rays_o, rays_d_z, t, near, far)]}")
    if n_steps < 2 or n_secant < 0:
        raise ValueError(f"unsupported march: {n_steps} steps, {n_secant} secant steps")
    if not cuda_spec_supported(spec):
        raise ValueError(f"the CUDA march kernel does not take {spec}: {spec_refusal(spec)}")
    if sampling_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {sampling_dtype}")
    device = rays_o.device
    lib = load_library()
    (w, meta_arr), built = cached_sampling_pack(_SAMPLING_PACKS, spec, params, sampling_dtype)
    PACKS["sampling"] += built
    rb = sampling_dtype == torch.bfloat16
    with torch.no_grad():
        f32 = torch.float32
        rays7 = torch.cat([rays_o, rays_d_z, t], dim=-1).to(f32).contiguous()
        nf = torch.cat([near, far], dim=-1).to(f32).contiguous()
    if w.device != device or rays7.device != device or nf.device != device:
        raise ValueError(f"params on {w.device}, rays on {rays7.device}, near/far on "
                         f"{nf.device}, o on {device}")
    tv = torch.linspace(0.0, 1.0, n_steps, dtype=torch.float32, device=device)
    scratch = torch.empty(lib.fused_march_scratch_floats(n_rays, n_steps),
                          dtype=torch.float32, device=device)
    out = torch.empty(n_rays, 4, dtype=torch.float32, device=device)
    idx = torch.empty(n_rays, dtype=torch.int32, device=device)
    assert len(meta_arr) == lib.fused_render_meta_len() + (2 * NL if rb else 0)
    with torch.cuda.device(device):   # the launch runs on the current device
        err = lib.fused_ray_march_launch(
            rays7.data_ptr(), nf.data_ptr(), tv.data_ptr(), n_rays, n_steps, n_secant,
            ctypes.c_float(tau), w.data_ptr(), meta_arr, int(rb), int(rb and not simt),
            scratch.data_ptr(), out.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused_ray_march CUDA launch failed: "
                           + lib.fused_render_error_string(err).decode())
    LAUNCHES["fused_ray_march"] += 1
    return {"depth": out[:, 0:1], "valid": out[:, 1:2] > 0.5, "d_low": out[:, 2],
            "d_high": out[:, 3], "idx": idx.long()}


def fused_ray_march(spec, params: Dict[str, Any], rays_o: torch.Tensor,
                    rays_d_z: torch.Tensor, t: torch.Tensor, near: torch.Tensor,
                    far: torch.Tensor, tau: float = 0.0, n_steps: int = 128, n_secant: int = 8,
                    sampling_dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """CUDA tensors run the kernel; CPU tensors run the plain twin."""
    if rays_o.device.type == "cuda":
        fn = fused_ray_march_cuda
    elif rays_o.device.type == "cpu":
        fn = fused_ray_march_reference
    else:
        raise ValueError(f"no fused_ray_march for device {rays_o.device}")
    return fn(spec, params, rays_o, rays_d_z, t, near, far, tau, n_steps, n_secant,
              sampling_dtype)
