"""Whole-pipeline forward render: the CUDA kernel and its plain PyTorch twin.

Port of ``endosurf_tpu/kernels/fused_render.py`` (``fused_render_rays``, a
Pallas TPU kernel). For a batch of rays [R, 9] it runs stratified z, the
SDF-guided upsampling rounds, the full field evaluation at the section
midpoints and the NeuS composite, and returns

    color_map [R,3], depth_map [R,1], normal_map [R,3], acc_map [R,1],
    weight_max [R,1]      (all float32)

where normal_map is the weights-weighted sum of the observed-space SDF
gradients.

* ``fused_render_rays_cuda``: the hand-written kernels in
  ``csrc/fused_render.cu`` (built by ``build.py``); in bf16 both passes run
  on tensor cores (the upsample's sweep and the train segments' forward
  kernels), in float32 on SIMT. Only the operand prep of the JAX wrapper
  runs in PyTorch around it (``pack_render``: weight-norm denormalisation,
  bf16 rounding and, in bf16, the mma fragments; cached per parameter set),
  with inv_s and the anneal ratio.
* ``fused_render_rays_reference``: the same function in plain PyTorch,
  the deterministic ``render_rays`` (plain upsampling) plus the extra maps. Tests and the CPU path use
  it; on a GPU it only serves as the comparison.
* ``fused_render_rays_float64``: the bf16 render's float64 yardstick (the
  twin with the kernels' bf16 operand roundings, float64 arithmetic).
* ``fused_render_rays``: the dispatching wrapper. A CUDA tensor always goes
  to the kernel (errors propagate); a CPU tensor takes the plain twin.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from endosurf_tpu_torch.ops.encoding import freq_encode_dim
from endosurf_tpu_torch.ops.mlp import effective_weight

NL = 9            # layers per MLP the kernel is built for
HMAX = 256        # widest hidden layer / threads per block
META_NET = 47
EVAL_GROUP = 8    # the JAX kernel's sample group; kept in the shape gate

# Launches of the CUDA kernel made by fused_render_rays_cuda (one per call).
LAUNCHES = {"fused_render_rays": 0}
# Packs built by pack_render (a cached pack counts no new one).
PACKS = {"render": 0}

# Kernel vs plain twin on one card, on the per-ray max-over-channels absolute
# error: per map (limit on the 99th percentile, limit on the max). Both sides
# run the same math with float32 accumulation in different orders. A
# deterministic inverse-CDF draw that lands in a bin holding only the 1e-5
# weight floor, or on a bin edge (cdf ~ u), turns a float32 ulp into a
# visible move of the new sample, so a few rays differ far more than the
# rest: the bulk is held by the p99, those rays by the max. Set from readings
# on an H100 (PERF.md §6, Findings) over the chip_smoke rays and the
# test_torch_cuda cells. p99: the sound pairs reach 9.3e-5 (float32) and
# 4.9e-4 (bf16) on their worst map; a kernel run at the other dot precision,
# in one pass or both, reaches at least 3.6e-3 / 3.5e-3 on some map, so the
# limits sat between the two, one p99 limit for all maps. Max: about 3x the
# largest sound max of each map.
# Re-read for the tensor-core bf16 render (PERF.md §6, Findings; chip_smoke's
# 8192 frame rays on two weight seeds and the card cells, NVIDIA H100 80GB
# HBM3): its sweeps and field stage sum in other orders than the float32
# twin, nearer to exact, so it tips bf16 roundings where the twin does not,
# and the moved samples carry them as in the tensor-core upsample. A bf16 p99
# limit moved only on a map where, against the float64 yardstick
# fused_render_rays_float64, the tensor-core render's median and p99 are no
# larger than the SIMT render's on every cell
# (test_render_tensor_cores_no_farther_from_float64): color, depth, normal
# and weight_max. On acc_map the tensor cores read farther on four of the
# 1024-ray cells' 24 readings (by up to 0.6 %, at about 5e-7 a ray: the
# float32 composite's own floor, tools/render_acc_floor.py), so its limit
# stays at 1e-3; now that the tensor-core render composites in double it
# reads nearer on acc_map too (about 2e-8 a ray). Sound p99: color 6.1e-4, depth 1.9e-3, normal
# 1.3e-3, acc 9.2e-4 (chip_smoke's rays), weight_max 7.0e-3 (the SIMT render
# read <= 7.3e-4, 4.9e-4 on its worst card map); max within the old limits
# (weight_max 3.1e-2). The controls do not all fail on one map (weight_max
# 5.7e-3 with float32 in the sampling pass, normal 2.3e-3 with float32 in
# the main pass, on the static net), so the bf16 p99 limits became per map:
# color stays 1e-3, acc 1e-3, depth 3e-3, normal 2e-3 (controls >= 2.25e-3
# where it decides), weight_max 1.5e-2 (controls >= 3.1e-2 where it
# decides). float32 unchanged.
PARITY_TOL = {
    torch.float32: {"color_map": (5e-4, 1.5e-3), "depth_map": (5e-4, 4.5e-3),
                    "normal_map": (5e-4, 3.5e-3), "acc_map": (5e-4, 3e-3),
                    "weight_max": (5e-4, 1e-2)},
    torch.bfloat16: {"color_map": (1e-3, 3.5e-3), "depth_map": (3e-3, 1e-2),
                     "normal_map": (2e-3, 2e-2), "acc_map": (1e-3, 7e-3),
                     "weight_max": (1.5e-2, 1e-1)},
}


def parity_errors(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                  dtype: torch.dtype) -> Dict[str, Tuple[float, float, bool]]:
    """Per map: (p99, max) of the per-ray error and whether both are within
    ``PARITY_TOL[dtype]``."""
    out = {}
    for k, (bulk, loose) in PARITY_TOL[dtype].items():
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


# A pack cache (cached_pack's): one entry per dtype, (key, weak references
# to the parameter tensors it was packed from, pack). The references tell the
# same tensors from new ones at reused ids, and the entry goes when any of
# its tensors is freed; a newer entry replaces it.
PackCache = Dict[torch.dtype, Tuple[Any, List[weakref.ref], Any]]
# pack_render's: packs (buffer, meta)
_RENDER_PACKS: PackCache = {}
# the render pack's fragment extension (csrc/fused_render.cu's
# decode_render_frags): deform W, SDF W (with its output layer), colour W,
# SDF W^T, each (net, transposed, output layer) as fused_sampler.frag_index
# takes them
RENDER_FRAG_NETS = ((0, False, False), (1, False, True), (2, False, False), (1, True, False))


def cached_pack(cache: PackCache, spec, params: Dict[str, Any], nets: Sequence[str],
                dtype: torch.dtype, build: Callable[[], Any]) -> Tuple[Any, bool]:
    """(the pack of ``params``' nets ``nets`` at ``dtype``, whether it was
    built now): ``cache``'s entry when it was packed from the same tensors
    (identity and ``_version``: an in-place update, an optimizer step,
    repacks) for the same ``spec``, else ``build()``, cached. The cache holds
    the tensors weakly: a pack does not outlive its parameter set."""
    tensors = [layer[k] for name in nets for layer in params.get(name, {}).get("layers", [])
               for k in sorted(layer)]
    key = (spec, tuple((id(t), t._version) for t in tensors))
    hit = cache.get(dtype)
    if hit is not None and hit[0] == key and all(r() is t for r, t in zip(hit[1], tensors)):
        return hit[2], False
    pack = build()

    def drop(_, dtype=dtype, key=key):
        if dtype in cache and cache[dtype][0] is key:
            del cache[dtype]
    cache[dtype] = (key, [weakref.ref(t, drop) for t in tensors], pack)
    return pack, True


def pack_render(spec, params: Dict[str, Any], dtype: torch.dtype
                ) -> Tuple[torch.Tensor, List[int]]:
    """The render kernel's pack: ``pack_operands``' buffer and meta and, in
    bf16, every layer's W as bf16 mma fragments that the tensor-core kernels
    read (``RENDER_FRAG_NETS``: the deform and colour nets' hidden layers, the
    SDF net's layers with its output layer, and its hidden layers' W^T), each
    16-byte aligned after the float32 layout, their float offsets appended to
    the meta (NL a block, -1 where a layer has none). The first 2 NL offsets
    are ``fused_sampler.pack_sampling``'s, so the sweeps read the same
    layout. The float32 layout is ``pack_operands``' byte for byte.

    A frame renders many chunks on one parameter set, so the pack is cached
    on the parameter tensors' identity and ``_version``: a call on the same
    tensors reuses it, an in-place update (an optimizer step) or new tensors
    repack. The cache holds the tensors weakly: a pack does not outlive its
    parameter set. ``PACKS["render"]`` counts the packs built."""
    from endosurf_tpu_torch.kernels.fused_sampler import frag_extension

    @torch.no_grad()
    def build():
        w, meta = pack_operands(spec, params, dtype)
        if dtype == torch.bfloat16:
            _check_tc_nets(meta)
            w, offs = frag_extension(w, meta, RENDER_FRAG_NETS)
            meta = meta + offs
        return w, meta
    pack, built = cached_pack(_RENDER_PACKS, spec, params,
                              ("deform_network", "sdf_network", "color_network"), dtype, build)
    PACKS["render"] += built
    return pack


def _net_meta(meta: List[int], q: int) -> Tuple[int, List[int]]:
    """(skip mask, out dims) of net q (0 deform, 1 SDF, 2 colour) of a render meta."""
    net = meta[8 + q * META_NET:8 + (q + 1) * META_NET]
    return net[1], net[2 + NL:2 + 2 * NL]


def _check_tc_nets(meta: List[int]) -> None:
    """The nets the tensor-core field stage takes (the train segments'
    bf16 gates, ``fused_train_cuda.pack_segment``): SDF hidden widths that
    are multiples of 16, no skip at an output layer, one colour skip layer
    at most."""
    outs = _net_meta(meta, 1)[1][:NL - 1]
    if any(o % 16 for o in outs):
        raise ValueError("the tensor-core render takes SDF hidden widths that are "
                         f"multiples of 16, got {outs}")
    masks = [_net_meta(meta, q)[0] for q in range(3)]
    if any(m >> (NL - 1) & 1 for m in masks) or bin(masks[2]).count("1") > 1:
        raise ValueError("the tensor-core render takes no skip at an output layer and one "
                         f"colour skip layer at most, got skip masks {masks}")


def render_work_floats(meta: List[int], n: int) -> int:
    """Floats of workspace the tensor-core field stage needs at n midpoints,
    as ``csrc/fused_render.cu``'s plan_render_work lays it out
    (``fused_render_work_floats``): float32 xt [n, 4], x_c [n, 3], the rows
    [n, 9], sdf [n], feat [n, F], grad_c and d_c [n, 3], then the SDF
    forward's pre-activations [n, out] of each hidden layer, each array
    256-byte aligned."""
    widths = [4, 3, 9, 1, meta[6], 3, 3] + _net_meta(meta, 1)[1][:NL - 1]
    used = 0
    for wd in widths:
        used = -(-used // 256) * 256 + 4 * n * wd
    return -(-used // 4)


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


def float64_distance(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
                     ) -> Dict[str, Tuple[float, float]]:
    """Per map: (median, p99) over the rays of the per-ray max-over-channels
    absolute error of ``got`` against the float64 yardstick ``ref``."""
    out = {}
    for k in PARITY_TOL[torch.bfloat16]:
        per_ray = (got[k].double() - ref[k]).abs().amax(dim=-1)
        q = torch.quantile(per_ray, torch.tensor([0.5, 0.99], dtype=per_ray.dtype,
                                                 device=per_ray.device))
        out[k] = (float(q[0]), float(q[1]))
    return out


def no_farther(got: Dict[str, Tuple[float, float]], other: Dict[str, Tuple[float, float]]
               ) -> Dict[str, bool]:
    """Per map: whether ``got``'s (median, p99) distance from the float64
    yardstick (``float64_distance``) is no larger than ``other``'s."""
    return {k: all(a <= b for a, b in zip(got[k], other[k])) for k in got}


def fused_render_rays_float64(spec, params: Dict[str, Any], rays: torch.Tensor, iter_step,
                              n_samples: int, n_importance: int, n_rounds: int,
                              anneal_end: float, chunk: int = 1024) -> Dict[str, torch.Tensor]:
    """The bf16 render's float64 yardstick, the maps in float64: the plain
    twin with the kernels' bf16 operand roundings and float64 arithmetic
    between them. z comes from ``fused_sampler.fused_upsample_z_float64``
    (stratified z, both in float64), the field from ``plain_point_eval``
    ("default" dots on float64 values) at the section midpoints, then the
    composite in float64. The weights are the kernels': each net's effective
    weight computed in float32 as ``pack_operands`` computes it, so that the
    dots round the same bf16 values and the SDF adjoint's head column is the
    kernels' unrounded one; inv_s and the anneal ratio are the kernels'
    float32 scalars. Runs ``chunk`` rays at a time (the float64 field
    evaluation holds a few GiB a 1024-ray chunk at base.yml's widths)."""
    if rays.shape[0] > chunk:
        parts = [fused_render_rays_float64(spec, params, rays[i:i + chunk], iter_step,
                                           n_samples, n_importance, n_rounds, anneal_end, chunk)
                 for i in range(0, rays.shape[0], chunk)]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    return float64_fields(spec, params, rays, iter_step, n_samples, n_importance, n_rounds,
                          anneal_end)["maps"]


def float64_fields(spec, params: Dict[str, Any], rays: torch.Tensor, iter_step,
                   n_samples: int, n_importance: int, n_rounds: int, anneal_end: float
                   ) -> Dict[str, Any]:
    """``fused_render_rays_float64`` on one chunk, with what its composite
    read: {"maps", "z" [R, K] (the sorted samples), "fields" (sdf, color,
    grad_o at the section midpoints, flat), "dirs" [R * K, 3], "anneal",
    "inv_s" (the kernels' float32 scalars)}; ``tools/render_acc_floor.py``
    runs the render's composite kernel on these."""
    from endosurf_tpu_torch.kernels.fused_sampler import fused_upsample_z_float64, to_float64
    from endosurf_tpu_torch.models.endosurf import (
        _split_rays,
        _stratified_z,
        composite,
        cos_anneal_ratio,
        section_midpoints,
    )
    from endosurf_tpu_torch.models.fields import plain_point_eval
    from endosurf_tpu_torch.ops.geometry import ray_sphere_intersection
    p64 = to_float64(params)
    for name in ("deform_network", "sdf_network", "color_network"):
        if name in params:
            p64[name] = {**p64[name], "layers": [
                {"w": effective_weight(layer).double(), "b": layer["b"].double()}
                for layer in params[name]["layers"]]}
    inv_s = inv_s_f32(params)
    p64["deviation_network"] = {"variance": torch.log(inv_s).double() / 10.0}
    with torch.no_grad():
        rays = rays.double()
        rays_o, rays_d, rays_d_z, t = _split_rays(rays)
        near, far, _ = ray_sphere_intersection(rays_o, rays_d)
        z_vals, _ = fused_upsample_z_float64(spec, params, rays_o, rays_d_z, t,
                                             _stratified_z(near, far, n_samples),
                                             n_importance, n_rounds)
        pts, dirs, tt, mid_z, dists = section_midpoints(rays, z_vals, 2.0 / n_samples)
        fields = plain_point_eval(spec, p64, pts.reshape(-1, 3), dirs.reshape(-1, 3),
                                  tt.reshape(-1, 1), "default")
        anneal = cos_anneal_ratio(iter_step, anneal_end, rays.device).to(torch.float32)
        out = composite(p64, fields, pts, dirs, mid_z, dists, anneal.double())
    w = out["weights"]
    maps = {
        "color_map": out["color_map"],
        "depth_map": out["depth_map"],
        "normal_map": (out["gradients_o"] * w[..., None]).sum(1),
        "acc_map": w.sum(-1, keepdim=True),
        "weight_max": out["weight_max"],
    }
    return {"maps": maps, "z": z_vals, "fields": fields, "dirs": dirs.reshape(-1, 3),
            "anneal": anneal, "inv_s": inv_s}


def inv_s_f32(params: Dict[str, Any]) -> torch.Tensor:
    """inv_s as the kernel gets it: float32."""
    from endosurf_tpu_torch.models.fields import inv_s
    return inv_s(params).to(torch.float32).reshape(())


def fused_render_rays_cuda(spec, params: Dict[str, Any], rays: torch.Tensor,
                           iter_step, n_samples: int, n_importance: int,
                           n_rounds: int, anneal_end: float,
                           sampling_dtype: torch.dtype = torch.float32,
                           main_dtype: torch.dtype = torch.float32,
                           simt: bool = False) -> Dict[str, torch.Tensor]:
    """Launch the CUDA kernels (``csrc/fused_render.cu``) on the current
    stream. A bf16 pass runs on tensor cores; ``simt`` runs it on the SIMT
    code instead, which only the float64 comparison of the tests and
    chip_smoke.py asks for."""
    from endosurf_tpu_torch.kernels.build import load_library
    from endosurf_tpu_torch.models.endosurf import cos_anneal_ratio

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

    w_samp, meta = pack_render(spec, params, sampling_dtype)
    if main_dtype != sampling_dtype:
        w_main, meta_main = pack_render(spec, params, main_dtype)
        meta = max(meta, meta_main, key=len)   # the bf16 one: its extension, the same prefix
    else:
        w_main = w_samp
    if w_samp.device != device:
        raise ValueError(f"params on {w_samp.device}, rays on {device}")
    scal = torch.stack([
        cos_anneal_ratio(iter_step, anneal_end, device).to(torch.float32).reshape(()),
        inv_s_f32(params)]).contiguous()
    scratch = torch.empty(lib.fused_render_scratch_floats(n_rays),
                          dtype=torch.float32, device=device)
    n_pts = n_rays * (n_samples + n_importance)
    tc_main = main_dtype == torch.bfloat16 and not simt
    work = torch.empty(render_work_floats(meta, n_pts) if tc_main else 1,
                       dtype=torch.float32, device=device)
    out = torch.empty(n_rays, 9, dtype=torch.float32, device=device)
    meta_arr = (ctypes.c_longlong * len(meta))(*meta)
    bf16_pass = torch.bfloat16 in (sampling_dtype, main_dtype)
    assert len(meta) == lib.fused_render_meta_len() + (4 * NL if bf16_pass else 0)
    with torch.cuda.device(device):   # the launch runs on the current device
        err = lib.fused_render_launch(
            rays.data_ptr(), n_rays, w_samp.data_ptr(), w_main.data_ptr(), meta_arr,
            int(sampling_dtype == torch.bfloat16), int(main_dtype == torch.bfloat16),
            int(not simt), n_samples, n_importance // n_rounds, n_rounds,
            ctypes.c_float(2.0 / n_samples), scal.data_ptr(), scratch.data_ptr(),
            work.data_ptr(), out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
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
