"""Whole-pipeline forward render: the CUDA kernel and its plain PyTorch twin.

Port of ``endosurf_tpu/kernels/fused_render.py`` (``fused_render_rays``, a
Pallas TPU kernel). For a batch of rays [R, 9] it runs stratified z, the
SDF-guided upsampling rounds, the full field evaluation at the section
midpoints and the NeuS composite, and returns

    color_map [R,3], depth_map [R,1], normal_map [R,3], acc_map [R,1],
    weight_max [R,1]      (all float32)

where normal_map is the weights-weighted sum of the observed-space SDF
gradients.

* ``fused_render_rays_cuda``: the hand-written kernel in
  ``csrc/fused_render.cu`` (built by ``build.py``). Only the operand prep of
  the JAX wrapper runs in PyTorch around it: weight-norm denormalisation,
  bf16 rounding of the weights, inv_s and the anneal ratio.
* ``fused_render_rays_reference``: the same function in plain PyTorch,
  the deterministic ``render_rays`` (plain upsampling) plus the extra maps. Tests and the CPU path use
  it; on a GPU it only serves as the comparison.
* ``fused_render_rays``: the dispatching wrapper. A CUDA tensor always goes
  to the kernel (errors propagate); a CPU tensor takes the plain twin.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Tuple

import torch

from endosurf_tpu_torch.ops.encoding import freq_encode_dim
from endosurf_tpu_torch.ops.mlp import effective_weight

NL = 9            # layers per MLP the kernel is built for
HMAX = 256        # widest hidden layer / threads per block
META_NET = 47
EVAL_GROUP = 8    # the JAX kernel's sample group; kept in the shape gate

# Launches of the CUDA kernel made by fused_render_rays_cuda (one per call).
LAUNCHES = {"fused_render_rays": 0}

# Kernel vs plain twin on one card, on the per-ray max-over-channels absolute
# error: (limit on the 99th percentile, shared by the maps; per-map limit on
# the max). Both sides run the same math with float32 accumulation in
# different orders. A deterministic inverse-CDF draw that lands in a bin
# holding only the 1e-5 weight floor, or on a bin edge (cdf ~ u), turns a
# float32 ulp into a visible move of the new sample, so a few rays differ
# far more than the rest: the bulk is held by the p99, those rays by the max.
# Set from readings on an H100 (PERF.md, PR 1 Findings) over the chip_smoke
# rays and the test_torch_cuda cells. p99: the sound pairs reach 9.3e-5
# (float32) and 4.9e-4 (bf16) on their worst map; a kernel run at the other
# dot precision, in one pass or both, reaches at least 3.6e-3 / 3.5e-3 on
# some map, so the limits sit between the two. Max: about 3x the largest
# sound max of each map.
PARITY_TOL = {
    torch.float32: (5e-4, {"color_map": 1.5e-3, "depth_map": 4.5e-3, "normal_map": 3.5e-3,
                           "acc_map": 3e-3, "weight_max": 1e-2}),
    torch.bfloat16: (1e-3, {"color_map": 3.5e-3, "depth_map": 1e-2, "normal_map": 2e-2,
                            "acc_map": 7e-3, "weight_max": 1e-1}),
}


def parity_errors(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                  dtype: torch.dtype) -> Dict[str, Tuple[float, float, bool]]:
    """Per map: (p99, max) of the per-ray error and whether both are within
    ``PARITY_TOL[dtype]``."""
    bulk, max_tol = PARITY_TOL[dtype]
    out = {}
    for k, loose in max_tol.items():
        per_ray = (got[k] - ref[k]).abs().amax(dim=-1).float()
        p99 = float(torch.quantile(per_ray, 0.99))
        mx = float(per_ray.max())
        out[k] = (p99, mx, p99 <= bulk and mx <= loose)
    return out


def precision_dtype(precision: str) -> torch.dtype:
    """Matmul precision mode -> dot dtype ("high" runs float32)."""
    return torch.bfloat16 if precision == "default" else torch.float32


def _dtype_precision(dtype: torch.dtype) -> str:
    return "default" if dtype == torch.bfloat16 else "highest"


def render_shape_supported(n_samples: int, n_importance: int, n_rounds: int) -> bool:
    """<= 64 samples in all, <= 8 new per round, whole groups of 8 (the JAX
    kernel's gate, kept so both packages take the same configurations)."""
    if n_rounds <= 0 or n_importance % n_rounds != 0:
        return False
    k = n_importance // n_rounds
    if not (0 < k <= 8 and n_samples + n_importance <= 64):
        return False
    return (n_samples + n_importance) % EVAL_GROUP == 0


def cuda_spec_supported(spec) -> bool:
    """Architectures the CUDA kernel is built for: 9-layer MLPs no wider than
    256, 3-d deform/colour outputs, an SDF output of 1 + feat_dim, and SDF
    skip layers no wider than 512 inputs (the adjoint gives each thread two
    input columns)."""
    nets = [spec.sdf, spec.color] + ([spec.deform] if spec.use_deform else [])
    if any(n.n_layers != NL or n.hidden_dim > HMAX for n in nets):
        return False
    if spec.sdf.hidden_dim + freq_encode_dim(3, spec.sdf_pos_freqs) > 2 * HMAX:
        return False
    if spec.sdf.out_dim != 1 + spec.color_feat_dim or spec.color_feat_dim > HMAX:
        return False
    if spec.color.out_dim != 3 or (spec.use_deform and spec.deform.out_dim != 3):
        return False
    return True


def pack_nets(nets, dtype: torch.dtype) -> Tuple[List[torch.Tensor], List[int], Any]:
    """Pack three nets for the kernels' ``Model`` meta.

    ``nets``: per net ``(layers or None, skips, transpose)`` with layers of
    effective weights ``{"w" | "v, g", "b"}``. Returns (chunks of one float32
    buffer, the three nets' meta, ``put``: appends a tensor to the chunks and
    returns its offset). Per layer the meta holds the dims, the skip mask and
    the offsets of W [in, out], b and W^T (``transpose`` True: the hidden
    layers; "all": every layer), else -1. Under bf16 the weights are rounded
    to bf16 values; biases are not."""
    chunks: List[torch.Tensor] = []
    size = [0]

    def put(t: torch.Tensor) -> int:
        off = size[0]
        chunks.append(t.reshape(-1).to(torch.float32))
        size[0] += t.numel()
        return off

    def rnd(w):
        return w.to(torch.bfloat16).to(torch.float32) if dtype == torch.bfloat16 else w

    def net_meta(layers, skips, transpose):
        if layers is None:
            return [0] * META_NET
        ins, outs, w_off, b_off, wt_off = [], [], [], [], []
        for l, layer in enumerate(layers):
            w = rnd(effective_weight(layer))
            ins.append(w.shape[0])
            outs.append(w.shape[1])
            w_off.append(put(w))
            b_off.append(put(layer["b"]))
            hidden = transpose is True and l < len(layers) - 1
            wt_off.append(put(w.T.contiguous()) if hidden or transpose == "all" else -1)
        pad = NL - len(layers)
        mask = sum(1 << s for s in skips)
        return ([len(layers), mask] + ins + [0] * pad + outs + [0] * pad
                + w_off + [0] * pad + b_off + [0] * pad + wt_off + [-1] * pad)

    metas = [m for layers, skips, tr in nets for m in net_meta(layers, skips, tr)]
    return chunks, metas, put


def pack_operands(spec, params: Dict[str, Any], dtype: torch.dtype
                  ) -> Tuple[torch.Tensor, List[int]]:
    """Effective weights packed into one float32 buffer, plus the int64 meta
    the kernel decodes (``pack_nets``; the SDF hidden layers with W^T). Under
    bf16 the weights are rounded to bf16 values; biases and the adjoint's
    head column are not."""
    def layers(name):
        return params[name]["layers"] if name in params else None
    chunks, metas, put = pack_nets(
        [(layers("deform_network"), spec.deform.skips, False),
         (layers("sdf_network"), spec.sdf.skips, True),
         (layers("color_network"), spec.color.skips, False)], dtype)
    head_off = put(effective_weight(params["sdf_network"]["layers"][-1])[:, 0])
    header = [int(spec.use_deform), spec.deform_pos_freqs, spec.deform_time_freqs,
              spec.sdf_pos_freqs, spec.color_pos_freqs, spec.color_dir_freqs,
              spec.color_feat_dim, head_off]
    return torch.cat(chunks).contiguous(), header + metas


def fused_render_rays_reference(spec, params: Dict[str, Any], rays: torch.Tensor,
                                iter_step, n_samples: int, n_importance: int,
                                n_rounds: int, anneal_end: float,
                                sampling_dtype: torch.dtype = torch.float32,
                                main_dtype: torch.dtype = torch.float32
                                ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch twin of the kernel: the deterministic render_rays
    pipeline (stratified z, the plain ``upsample_z``, the plain field math
    ``plain_point_eval`` at the midpoints, compositing), plus the maps."""
    from endosurf_tpu_torch.models.endosurf import (
        RenderSpec,
        _split_rays,
        _stratified_z,
        composite,
        cos_anneal_ratio,
        section_midpoints,
        upsample_z,
    )
    from endosurf_tpu_torch.models.fields import plain_point_eval
    from endosurf_tpu_torch.ops.geometry import ray_sphere_intersection
    rspec = RenderSpec(n_samples=n_samples, n_importance=n_importance,
                       up_sample_steps=n_rounds, anneal_end=anneal_end)
    with torch.no_grad():
        rays_o, rays_d, rays_d_z, t = _split_rays(rays)
        near, far, _ = ray_sphere_intersection(rays_o, rays_d)
        z_vals = upsample_z(spec, rspec, params, rays_o, rays_d_z, t,
                            _stratified_z(near, far, n_samples),
                            _dtype_precision(sampling_dtype))
        pts, dirs, tt, mid_z, dists = section_midpoints(rays, z_vals, 2.0 / n_samples)
        fields = plain_point_eval(spec, params, pts.reshape(-1, 3), dirs.reshape(-1, 3),
                                  tt.reshape(-1, 1), _dtype_precision(main_dtype))
        out = composite(params, fields, pts, dirs, mid_z, dists,
                        cos_anneal_ratio(iter_step, anneal_end, rays.device))
    w = out["weights"]
    return {
        "color_map": out["color_map"],
        "depth_map": out["depth_map"],
        "normal_map": (out["gradients_o"] * w[..., None]).sum(1),
        "acc_map": w.sum(-1, keepdim=True),
        "weight_max": out["weight_max"],
    }


def fused_render_rays_cuda(spec, params: Dict[str, Any], rays: torch.Tensor,
                           iter_step, n_samples: int, n_importance: int,
                           n_rounds: int, anneal_end: float,
                           sampling_dtype: torch.dtype = torch.float32,
                           main_dtype: torch.dtype = torch.float32
                           ) -> Dict[str, torch.Tensor]:
    """Launch the CUDA kernel (``csrc/fused_render.cu``) on the current stream."""
    from endosurf_tpu_torch.kernels.build import load_library
    from endosurf_tpu_torch.models.endosurf import cos_anneal_ratio
    from endosurf_tpu_torch.models.fields import inv_s

    if rays.device.type != "cuda":
        raise ValueError(f"fused_render_rays_cuda needs CUDA tensors, got {rays.device}")
    if rays.ndim != 2 or rays.shape[1] != 9:
        raise ValueError(f"rays must be [R, 9], got {tuple(rays.shape)}")
    if n_samples < 2 or not render_shape_supported(n_samples, n_importance, n_rounds):
        raise ValueError(f"unsupported sample counts {n_samples}+{n_importance}/{n_rounds}")
    if not cuda_spec_supported(spec):
        raise ValueError(f"the CUDA render kernel does not take {spec}")
    for dt in (sampling_dtype, main_dtype):
        if dt not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported dtype {dt}")
    device = rays.device
    lib = load_library()
    rays = rays.to(torch.float32).contiguous()
    n_rays = rays.shape[0]

    w_samp, meta = pack_operands(spec, params, sampling_dtype)
    w_main = (w_samp if main_dtype == sampling_dtype
              else pack_operands(spec, params, main_dtype)[0])
    if w_samp.device != device:
        raise ValueError(f"params on {w_samp.device}, rays on {device}")
    scal = torch.stack([
        cos_anneal_ratio(iter_step, anneal_end, device).to(torch.float32).reshape(()),
        inv_s(params).to(torch.float32).reshape(())]).contiguous()
    scratch = torch.empty(lib.fused_render_scratch_floats(n_rays),
                          dtype=torch.float32, device=device)
    out = torch.empty(n_rays, 9, dtype=torch.float32, device=device)
    meta_arr = (ctypes.c_longlong * len(meta))(*meta)
    assert len(meta) == lib.fused_render_meta_len()
    with torch.cuda.device(device):   # the launch runs on the current device
        err = lib.fused_render_launch(
            rays.data_ptr(), n_rays, w_samp.data_ptr(), w_main.data_ptr(), meta_arr,
            int(sampling_dtype == torch.bfloat16), int(main_dtype == torch.bfloat16),
            n_samples, n_importance // n_rounds, n_rounds,
            ctypes.c_float(2.0 / n_samples), scal.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused_render_rays CUDA launch failed: "
                           + lib.fused_render_error_string(err).decode())
    LAUNCHES["fused_render_rays"] += 1
    return {"color_map": out[:, 0:3], "depth_map": out[:, 3:4],
            "normal_map": out[:, 4:7], "acc_map": out[:, 7:8],
            "weight_max": out[:, 8:9]}


def fused_render_rays(spec, params: Dict[str, Any], rays: torch.Tensor, iter_step,
                      n_samples: int, n_importance: int, n_rounds: int,
                      anneal_end: float, sampling_dtype: torch.dtype = torch.float32,
                      main_dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """CUDA tensors run the kernel; CPU tensors run the plain twin."""
    if rays.device.type == "cuda":
        fn = fused_render_rays_cuda
    elif rays.device.type == "cpu":
        fn = fused_render_rays_reference
    else:
        raise ValueError(f"no fused_render_rays for device {rays.device}")
    return fn(spec, params, rays, iter_step, n_samples, n_importance, n_rounds,
              anneal_end, sampling_dtype, main_dtype)
