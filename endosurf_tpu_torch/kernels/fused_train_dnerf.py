"""The D-NeRF field chain as three segments: the plain math, the CUDA
kernels and ``megakernel_field_raw``, the field of the EndoNeRF train step.

Port of ``endosurf_tpu/kernels/fused_train_dnerf.py``:

    x_c          = seg_deform_math(eff_d, xt)                   warp
    (raw, feat)  = seg_density_math(eff_s, head, featw, x_c)    raw sigma, feature
    rgb          = seg_color_math(eff_c, d, feat)               sigmoid inside

``prepare_effective_dnerf`` splits the plain ``{w, b}`` layers: skip layers
into an h block and an encoding block (the nerf-style skip input is [h,
enc]), the density net's 1 + F output layer into ``sigma_head`` [H, 1] and
``geo_feat`` [H, F]. ``forward_math`` composes the segments (the render
kernel's plain twin). Under ``"default"`` the coordinates are rounded to
bf16 before they are encoded, as the TPU kernels' selector dots round them.
The JAX module's 128-lane padding and selector matmuls are layout and are
dropped.

``megakernel_field_raw`` runs the chain through ``SegDeform`` /
``SegDensity`` / ``SegColor``, autograd Functions with JAX's ``custom_vjp``
contract: the deform segment gives its weights a gradient and ``xt`` none,
the density segment its weights and ``x_c``, the colour segment its weights
and ``feat`` (``d`` none). ``prepare_effective_dnerf`` stays differentiable
torch outside them, so the ``{w, b}`` gradients follow by the chain rule.
CPU tensors run the plain math and ``plain_bwd`` (autograd through it);
CUDA tensors run the kernels of ``csrc/fused_train_dnerf.cu`` over
``csrc/dnerf_chain.cuh``: ``dnerf_*_fwd`` and ``dnerf_*_bwd``, each counted
in ``LAUNCHES``, on weights packed by ``pack_dnerf`` (the one layout every
D-NeRF kernel reads: ``fused_density_raw`` and the render kernel too;
cached a parameter set). The bf16 deform and density forwards and the
three backwards run on tensor cores (``csrc/dnerf_tc.cuh``'s tile);
``simt=True`` (``dnerf_deform_fwd``, ``dnerf_density_fwd``,
``dnerf_deform_bwd``, ``dnerf_density_bwd``, ``dnerf_color_bwd``) runs the
SIMT kernel, which only the float64 comparisons ask for (the yardsticks
``dnerf_deform_fwd_float64``, ``dnerf_density_fwd_float64``,
``dnerf_deform_bwd_float64``, ``dnerf_density_bwd_float64``,
``dnerf_color_bwd_float64``).
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from endosurf_tpu_torch.kernels.fused_render import (
    HMAX,
    META_NET,
    NL,
    PackCache,
    cached_pack,
    pack_nets,
)
from endosurf_tpu_torch.kernels.fused_sampler import frag_extension
from endosurf_tpu_torch.kernels.fused_train import (
    _build,
    _mlp_fwd,
    _no_grad_inputs,
    flatten_layers,
    unflatten_layers,
)
from endosurf_tpu_torch.ops.encoding import freq_encode, freq_encode_dim
from endosurf_tpu_torch.ops.mlp import dot, operand

SEGMENTS = ("deform", "density", "color")

# Launches of the segment kernels, one per call (a backward call runs its
# tile kernel and the weight-gradient product).
LAUNCHES = {f"dnerf_{s}_{d}": 0 for d in ("fwd", "bwd") for s in SEGMENTS}
# Packs built by pack_dnerf (a cached pack counts no new one).
PACKS = {"dnerf": 0}

# Kernel vs plain version on one card, per output: (median, p99, max) of the
# per-point error, the max over channels of |kernel - plain| / rms(plain)
# (fused_train_cuda's statistic). Both sides run the same math with float32
# accumulation in other orders; a relu pre-activation within that noise of
# 0 gates differently on the two sides and moves the point, and in bf16 an
# ulp of it tips an operand's rounding now and then: the max only catches
# gross faults, the median and p99 hold the bulk. Set from H100 readings
# (PERF.md; 65,531 and 65,536 points, three nets, two seeds): sound
# float32 median <= 4.6e-7, p99 <= 1.7e-6, max <= 3.2e-6; sound bf16
# median <= 1.2e-7, p99 <= 4.6e-7, max <= 8.7e-3 (raw sigma); the kernels at
# the other precision median >= 1.4e-4 (rgb) on every segment.
PARITY_TOL = {
    torch.float32: (2e-6, 2e-5, 1e-3),
    torch.bfloat16: (2e-6, 2e-5, 5e-2),
}

# Backward kernel vs plain version (``plain_bwd``) on one card: "cot" limits
# the (median, p99, max) of the per-point error of each input cotangent (d
# x_c, d feat; the statistic above), "leaf" the relative L2 norm of each
# weight gradient. Both sides run the same math with float32 sums in other
# orders; a relu gate within that noise of 0 flips and moves the cotangent
# of its point (through ten octaves for d x_c), and in bf16 an ulp of it
# tips a rounded cotangent now and then, so the max sits at about 3x the
# largest sound reading. Set from H100 readings (PERF.md, PR 6; chip_smoke's
# 262,144 fine points of a train batch and 65,536 of a second seed, the
# card tests' 65,531 random points over three nets, two seeds): sound
# float32 cot median <= 4.3e-7, p99 <= 1.5e-6, max <= 0.64, leaf <= 9.7e-4;
# sound bf16 cot median and p99 0, max <= 0.35, leaf <= 2.5e-3; the kernels
# at the other precision read cot medians >= 9.9e-3 (d feat) and leaves >=
# 4.4e-2, and the planted faults (a skip layer's encoding rows dropped from
# d x_c, the sigma head's cotangent through the wrong column) d x_c medians
# >= 6.6e-2.
# The tensor-core bf16 density backward's d x_c (PERF.md §6; NVIDIA H100
# 80GB HBM3) has its own p99 limit: its products are exact bf16 terms summed
# a k-tile at a time, and its d x_c equals the float64 yardstick's
# (dnerf_density_bwd_float64) on 99 % of points (p99 0), where the SIMT
# kernel and the float32 plain version, which share a float32 order, tip a
# bf16 rounding of d x_c on 1-3 % of them (p99 1.5e-3 to 2.9e-3). So against
# the plain version the kernel reads d x_c p99 2.4e-3 to 2.9e-3 (the card
# tests' cells and chip_smoke's 262,144 train points), where the kernels at
# the other precision read >= 2.09 and the planted faults >= 0.385. Its p99
# limit moved 1e-3 -> 5e-3 on that evidence
# (test_dnerf_density_bwd_tensor_cores_no_farther_from_float64: no farther
# on every card cell and chip_smoke's train batch); its median and max, and
# every other kernel's and cotangent's limits, stay ("cot").
BWD_PARITY_TOL = {
    torch.float32: {"cot": (1e-6, 1e-5, 2.0), "leaf": 3e-3},
    torch.bfloat16: {"cot": (1e-4, 1e-3, 2.0), "leaf": 1e-2,
                     ("dnerf_density_bwd", "x_c"): (1e-4, 5e-3, 2.0)},
}


def cot_tol(dtype: torch.dtype, kernel: str, name: str) -> Tuple[float, float, float]:
    """The (median, p99, max) limits of input cotangent ``name`` of backward
    kernel ``kernel`` (``BWD_PARITY_TOL``: its own entry, else "cot")."""
    tol = BWD_PARITY_TOL[dtype]
    return tol.get((kernel, name), tol["cot"])


# ---------------------------------------------------------------------------
# effective weights and the plain segment math
# ---------------------------------------------------------------------------

def _in_dims(spec) -> Tuple[int, int, int]:
    return (freq_encode_dim(3, spec.pos_deform_freqs) + freq_encode_dim(1, spec.time_deform_freqs),
            freq_encode_dim(3, spec.pos_density_freqs), freq_encode_dim(3, spec.dir_color_freqs))


def prepare_effective_dnerf(spec, params: Dict[str, Any]) -> Dict[str, Any]:
    """Plain ``{w, b}`` params -> split-skip layers (``fused_train._build``
    layout); the density output layer split into ``sigma_head`` [H, 1] and
    ``geo_feat`` [H, F]."""
    d_in, s_in, r_in = _in_dims(spec)
    eff: Dict[str, Any] = {}
    if spec.use_deform:
        eff["deform"] = _build(params["deform"]["layers"], spec.deform_layers[2], (d_in,))
    density = _build(params["density"]["layers"], spec.density_layers[2], (s_in,))
    last = density.pop()
    eff["density"] = density
    eff["sigma_head"] = {"w": last["w"][:, :1], "b": last["b"][:1]}
    eff["geo_feat"] = {"w": last["w"][:, 1:], "b": last["b"][1:]}
    eff["color"] = _build(params["color"]["layers"], spec.color_layers[2],
                          (r_in, spec.geo_feat_dim))
    return eff


def _mlp_nerf(layers, secs, precision):
    """Relu hidden layers, a linear last layer, unscaled skips."""
    return _mlp_fwd(layers, secs, torch.relu, precision, skip_scale=1.0)[0]


def seg_deform_math(spec, eff_d, xt: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """xt [N, 4] (x, t) -> x_c [N, 3] = x + deform(enc(x, t))."""
    xr = operand(xt, precision)
    enc = torch.cat([freq_encode(xr[:, :3], spec.pos_deform_freqs),
                     freq_encode(xr[:, 3:4], spec.time_deform_freqs)], dim=-1)
    return xt[:, :3] + _mlp_nerf(eff_d, [enc], precision)


def seg_density_math(spec, eff_s, head, featw, x_c: torch.Tensor, precision: str = "highest"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_c [N, 3] -> (raw sigma [N, 1] before noise and relu, feat [N, F]):
    the hidden chain (every layer relu'd), then the split output layer."""
    enc = freq_encode(operand(x_c, precision), spec.pos_density_freqs)
    h = torch.relu(_mlp_nerf(eff_s, [enc], precision))
    return (dot(h, head["w"], precision) + head["b"],
            dot(h, featw["w"], precision) + featw["b"])


def seg_color_math(spec, eff_c, d: torch.Tensor, feat: torch.Tensor,
                   precision: str = "highest") -> torch.Tensor:
    """(d [N, 3] the raw view direction, feat [N, F]) -> rgb [N, 3]."""
    enc = freq_encode(operand(d, precision), spec.dir_color_freqs)
    return torch.sigmoid(_mlp_nerf(eff_c, [enc, feat], precision))


def forward_math(spec, eff: Dict[str, Any], x: torch.Tensor, t: torch.Tensor, d: torch.Tensor,
                 precision: str = "highest") -> Dict[str, torch.Tensor]:
    """x, d [N, 3], t [N, 1] -> {rgb [N, 3], raw_sigma [N, 1]}: the segments
    composed."""
    x_c = (seg_deform_math(spec, eff["deform"], torch.cat([x, t], dim=-1), precision)
           if spec.use_deform else x)
    raw, feat = seg_density_math(spec, eff["density"], eff["sigma_head"], eff["geo_feat"],
                                 x_c, precision)
    return {"rgb": seg_color_math(spec, eff["color"], d, feat, precision), "raw_sigma": raw}


# ---------------------------------------------------------------------------
# the segments on flat weights, and their plain backward
# ---------------------------------------------------------------------------

# The segments' per-point inputs, in the order the Functions, the kernels and
# ``seg_math`` take them, and those that receive a cotangent (JAX's
# custom_vjp rules: xt and d get none).
SEGMENT_INPUTS = {"deform": ("xt",), "density": ("x_c",), "color": ("d", "feat")}
COTANGENT_INPUTS = {"deform": (), "density": ("x_c",), "color": ("feat",)}


def segment_weights(eff: Dict[str, Any], seg: str
                    ) -> Tuple[List[Dict[str, Any]], List[torch.Tensor]]:
    """(layer structure, flat effective weights) of one segment
    (``fused_train.flatten_layers`` order); the density segment's hidden
    layers are followed by head w, head b, feat w, feat b."""
    flat = flatten_layers(eff[seg])
    if seg == "density":
        flat += [eff["sigma_head"]["w"], eff["sigma_head"]["b"], eff["geo_feat"]["w"],
                 eff["geo_feat"]["b"]]
    return eff[seg], flat


def seg_math(spec, seg: str, like, flat: Sequence[torch.Tensor],
             inputs: Sequence[torch.Tensor], precision: str) -> Tuple[torch.Tensor, ...]:
    """The plain version of one segment's forward on flat weights: its
    outputs as a tuple."""
    if seg == "deform":
        return (seg_deform_math(spec, unflatten_layers(flat, like), *inputs, precision),)
    if seg == "density":
        n = len(flat) - 4
        return seg_density_math(spec, unflatten_layers(flat[:n], like),
                                {"w": flat[n], "b": flat[n + 1]},
                                {"w": flat[n + 2], "b": flat[n + 3]}, *inputs, precision)
    return (seg_color_math(spec, unflatten_layers(flat, like), *inputs, precision),)


def plain_bwd(spec, seg: str, like, flat: Sequence[torch.Tensor],
              inputs: Sequence[torch.Tensor], cots: Sequence[torch.Tensor], precision: str
              ) -> Tuple[List[torch.Tensor], Tuple[Optional[torch.Tensor], ...]]:
    """The plain version of one segment's backward: recompute ``seg_math`` on
    detached copies and pull ``cots`` with autograd, as JAX's jnp path takes
    ``jax.vjp``. Returns (gradients of the flat weights, cotangents of the
    inputs: None for those in no ``COTANGENT_INPUTS``)."""
    n = len(flat)
    wanted = [name in COTANGENT_INPUTS[seg] for name in SEGMENT_INPUTS[seg]]
    with torch.enable_grad():
        w_leaves = [t.detach().requires_grad_(True) for t in flat]
        ins = [t.detach().requires_grad_(True) if w else t for t, w in zip(inputs, wanted)]
        outs = seg_math(spec, seg, like, w_leaves, ins, precision)
        leaves = w_leaves + [t for t, w in zip(ins, wanted) if w]
        got = torch.autograd.grad(outs, leaves, cots, allow_unused=True)
    got = [torch.zeros_like(l) if g is None else g for l, g in zip(leaves, got)]
    it = iter(got[n:])
    return got[:n], tuple(next(it) if w else None for w in wanted)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def cuda_dnerf_supported(spec) -> bool:
    """Nets the D-NeRF kernels are built for: 2 to 9 layers no wider than
    256, skips after layer 0 (none in the colour net), a feature no wider
    than 256."""
    nets = [spec.density_layers, spec.color_layers] + (
        [spec.deform_layers] if spec.use_deform else [])
    if any(not 2 <= n <= NL or h > HMAX or 0 in s for n, h, s in nets):
        return False
    return not spec.color_layers[2] and 0 < spec.geo_feat_dim <= HMAX


SLOTS = {"deform": 0, "density": 1, "color": 2}     # the nets' places in the Model meta
META_LEN = 8 + 3 * META_NET                         # csrc/sdf_chain.cuh's Model meta
# The bf16 pack's fragment extension (csrc/dnerf_tc.cuh's decode_dn_frags):
# NL float offsets each of the deform, density and colour nets' W, of the
# density net's W^T, of the deform net's W^T and of the colour net's W^T,
# each (net slot, transposed, output layer) as fused_sampler.frag_index takes
# them: the hidden layers, and at the density net's output layer its feature
# columns W[:, 1:] (the raw column 0 stays SIMT); -1 where a layer has none.
FEATURE_COLS = slice(1, None)
DN_FRAG_BLOCKS = ((0, False, False), (1, False, FEATURE_COLS), (2, False, False),
                  (1, True, FEATURE_COLS), (0, True, False), (2, True, False))
# The largest dynamic shared memory a block may take on an H100 (227 KiB).
SMEM_LIMIT = 232448


class DnPacked:
    """The D-NeRF nets packed for the kernels: ``w`` (float32, on the
    device), ``meta`` (ctypes int64 array, ``csrc/sdf_chain.cuh``'s Model
    layout with the density net in the SDF slot; every layer with W^T for the
    backward kernels) and ``rb`` (bf16 operands)."""

    def __init__(self, w: torch.Tensor, meta: List[int], rb: bool):
        self.w, self.rb = w, rb
        self.meta = (ctypes.c_longlong * len(meta))(*meta)

    def layout(self, seg: str) -> List[Tuple[int, int, int, int]]:
        """(w_off, b_off, in, out) of each layer of a segment's net."""
        q = 8 + SLOTS[seg] * META_NET
        n = self.meta[q]
        return [(self.meta[q + 2 + 2 * NL + l], self.meta[q + 2 + 3 * NL + l],
                 self.meta[q + 2 + l], self.meta[q + 2 + NL + l]) for l in range(n)]


def _net_meta(meta: Sequence[int], q: int) -> List[int]:
    return list(meta[8 + q * META_NET:8 + (q + 1) * META_NET])


def _c16(x: int) -> int:
    return -(-x // 16) * 16


def _enc_widths(meta: Sequence[int]) -> Tuple[int, int, int]:
    """(deform, density, colour direction) encoding widths of a meta."""
    return (3 * (1 + 2 * meta[1]) + (1 + 2 * meta[2]), 3 * (1 + 2 * meta[3]),
            3 * (1 + 2 * meta[5]))


# The tensor-core tiles (csrc/dnerf_tc.cuh's DtKind): "fwd" the coarse sweep's
# (the render's and the raw density query's), the render's field stage's and
# the deform and density forwards'; "density_bwd", "deform_bwd" and
# "color_bwd" the backwards'.
TC_TILES = ("fwd", "density_bwd", "deform_bwd", "color_bwd")


def tc_smem_bytes(meta: Sequence[int], tile: str) -> int:
    """Shared memory of a tensor-core D-NeRF tile (``csrc/dnerf_tc.cuh``'s
    dt_smem): the weight ring, the points (x_c in double too), the operand
    rows (three terms in the density backward) at the pitch of the widest
    layer, the encoding; a backward's relu' bits, the density backward's
    cotangents on the raw column and the encoding (the deform and colour
    backwards' tiles are the same size)."""
    if tile not in TC_TILES:
        raise ValueError(f"no tensor-core tile {tile!r}")
    ed, es, cr = _enc_widths(meta)
    k = _c16(cr + meta[6])
    for q in range(0 if meta[0] else 1, 3):
        net = _net_meta(meta, q)
        for l in range(net[0]):
            k = max(k, _c16(net[2 + l]), _c16(net[2 + NL + l]))
    ring = 8 * 4 * 2 * 32 * 16
    terms = 3 if tile == "density_bwd" else 1
    size = (ring + 64 * 4 * 8 + 4 * 64 * 4 * 4 + terms * 64 * (k + 8) * 2
            + 64 * max(ed, es, cr) * 2)
    if tile != "fwd":
        size += (NL - 1) * 64 * (HMAX // 32) * 4
    if tile == "density_bwd":
        size += 64 * 4 + 64 * es * 4
    return size


def check_tc_nets(packed: DnPacked, tile: str) -> None:
    """The nets a tensor-core D-NeRF kernel takes: a bf16 pack whose tile
    (``TC_TILES``) fits in shared memory."""
    if not packed.rb or len(packed.meta) != META_LEN + len(DN_FRAG_BLOCKS) * NL:
        raise ValueError("the tensor-core D-NeRF kernels take a bf16 pack with fragments")
    need = tc_smem_bytes(packed.meta, tile)
    if need > SMEM_LIMIT:
        raise ValueError(f"the tensor-core D-NeRF kernels do not take these nets: a tile needs "
                         f"{need} bytes of shared memory, more than {SMEM_LIMIT}")


# pack_dnerf's cache (fused_render.cached_pack's): packs DnPacked
_DN_PACKS: PackCache = {}


def pack_dnerf(spec, params: Dict[str, Any], dtype: torch.dtype) -> DnPacked:
    """All three nets of ``params`` (the density output layer whole, [H, 1 +
    F]) in one buffer, bf16-rounded weights for ``dtype`` bf16 (biases not).
    In bf16 the fragment extension the tensor-core kernels read
    (``DN_FRAG_BLOCKS``) follows the float32 layout, its offsets appended to
    the meta; the float32 layout is the same in both.

    A frame renders many chunks on one parameter set, so the pack is cached
    on the parameter tensors' identity and ``_version``: a call on the same
    tensors reuses it, an in-place update (an optimizer step) or new tensors
    repack. The cache holds the tensors weakly: a pack does not outlive its
    parameter set. ``PACKS["dnerf"]`` counts the packs built."""
    if not cuda_dnerf_supported(spec):
        raise ValueError(f"the CUDA D-NeRF kernels do not take {spec}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {dtype}")

    @torch.no_grad()
    def build():
        chunks, metas, _ = pack_nets(
            [(params["deform"]["layers"] if spec.use_deform else None, spec.deform_layers[2],
              "all"),
             (params["density"]["layers"], spec.density_layers[2], "all"),
             (params["color"]["layers"], spec.color_layers[2], "all")], dtype)
        w = torch.cat(chunks).contiguous()
        header = [int(spec.use_deform), spec.pos_deform_freqs, spec.time_deform_freqs,
                  spec.pos_density_freqs, 0, spec.dir_color_freqs, spec.geo_feat_dim, 0]
        meta = header + metas
        if dtype == torch.bfloat16:
            w, offs = frag_extension(w, meta, DN_FRAG_BLOCKS)
            meta = meta + offs
        return DnPacked(w, meta, dtype == torch.bfloat16)
    pack, built = cached_pack(_DN_PACKS, spec, params, ("deform", "density", "color"), dtype,
                              build)
    PACKS["dnerf"] += built
    return pack


def unpack_grads(packed: DnPacked, seg: str, like, grad: torch.Tensor) -> List[torch.Tensor]:
    """A backward kernel's packed gradient (dW and db at the weights'
    offsets) -> gradients of the segment's flat weights."""
    layout = packed.layout(seg)
    out: List[torch.Tensor] = []
    for l, (wo, bo, n_in, n_out) in enumerate(layout):
        dw = grad[wo:wo + n_in * n_out].view(n_in, n_out)
        db = grad[bo:bo + n_out]
        if seg == "density" and l == len(layout) - 1:
            out += [dw[:, :1], db[:1], dw[:, 1:], db[1:]]
            continue
        lay = like[l]
        rows = ([lay["wh"]] if "wh" in lay else []) + list(lay.get("wsec", [])) + (
            [lay["w"]] if "w" in lay else [])
        out += list(torch.split(dw, [r.shape[0] for r in rows], dim=0)) + [db]
    return out


def _arg(t: torch.Tensor, shape, name: str) -> torch.Tensor:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    return t.detach().to(torch.float32).contiguous()


def _run(name: str, packed: DnPacked, n: int, *tensors: torch.Tensor,
         tc: Optional[bool] = None) -> None:
    """Launch kernel entry ``name``; ``tc`` (every entry but the colour
    forward's): the tensor-core kernel in bf16."""
    from endosurf_tpu_torch.kernels.build import load_library
    lib = load_library()
    device = tensors[0].device
    if packed.w.device != device:
        raise ValueError(f"weights on {packed.w.device}, points on {device}")
    modes = [int(packed.rb)] + ([] if tc is None else [int(tc)])
    with torch.cuda.device(device):
        err = getattr(lib, name)(packed.w.data_ptr(), packed.meta, *modes, n,
                                 *(t.data_ptr() for t in tensors),
                                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} CUDA launch failed: "
                           + lib.fused_render_error_string(err).decode())
    LAUNCHES[name] += 1


def _tc(packed: DnPacked, simt: bool, tile: str) -> bool:
    """Whether a call runs its tensor-core kernel: a bf16 pack, not ``simt``;
    the nets are checked against the kernel's tile."""
    tc = packed.rb and not simt
    if tc:
        check_tc_nets(packed, tile)
    return tc


def dnerf_deform_fwd(packed: DnPacked, xt: torch.Tensor, simt: bool = False) -> torch.Tensor:
    """xt [N, 4] (x, t) -> x_c [N, 3]. A bf16 pack runs the tensor-core
    kernel (its nets checked first, on any device); ``simt`` runs the SIMT
    one instead (the float64 comparison only)."""
    tc = _tc(packed, simt, "fwd")
    n = xt.shape[0]
    xt = _arg(xt, (n, 4), "xt")
    x_c = torch.empty(n, 3, dtype=torch.float32, device=xt.device)
    _run("dnerf_deform_fwd", packed, n, xt, x_c, tc=tc)
    return x_c


def dnerf_density_fwd(packed: DnPacked, x_c: torch.Tensor, simt: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_c [N, 3] -> (raw sigma [N, 1], feat [N, F]). A bf16 pack runs the
    tensor-core kernel; ``simt`` runs the SIMT one instead (the float64
    comparison only)."""
    n = x_c.shape[0]
    x_c = _arg(x_c, (n, 3), "x_c")
    f = packed.meta[6]
    tc = _tc(packed, simt, "fwd")
    raw = torch.empty(n, 1, dtype=torch.float32, device=x_c.device)
    feat = torch.empty(n, f, dtype=torch.float32, device=x_c.device)
    _run("dnerf_density_fwd", packed, n, x_c, raw, feat, tc=tc)
    return raw, feat


def dnerf_color_fwd(packed: DnPacked, d: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """(d [N, 3], feat [N, F]) -> rgb [N, 3]."""
    n = d.shape[0]
    d = _arg(d, (n, 3), "d")
    feat = _arg(feat, (n, packed.meta[6]), "feat")
    rgb = torch.empty(n, 3, dtype=torch.float32, device=d.device)
    _run("dnerf_color_fwd", packed, n, d, feat, rgb)
    return rgb


WG_KC = 4096          # points per chunk of the weight-gradient sums (csrc/wgrad.cuh)


def scratch_layout(meta: Sequence[int], seg: str, n: int, tc: bool = False
                   ) -> List[Tuple[Tuple[int, torch.dtype, int], Tuple[int, torch.dtype, int]]]:
    """Where a backward's scratch holds each layer's operand rows and
    pre-activation cotangents for n points, as ``csrc/fused_train_dnerf.cu``'s
    planners lay them out: per layer ((byte offset, dtype, row width) of the
    operands, (the same) of the cotangents). SIMT (dn_plan_bwd): float32
    [n, in] and [n, out], back to back. The tensor-core backwards (``tc``,
    plan_bwd_tc): bf16 operand rows [n, c16(in)] and cotangents [n,
    c16(out)], float32 from layer L-2 on in the density's, at layer L-1 in
    the deform's and the colour's, bf16 below, each array 256-byte
    aligned."""
    net = _net_meta(meta, SLOTS[seg])
    n_layers = net[0]
    ins, outs = net[2:2 + n_layers], net[2 + NL:2 + NL + n_layers]
    f32_from = n_layers - (2 if seg == "density" else 1)
    bf, f32 = torch.bfloat16, torch.float32
    layout, used = [], 0
    for l, (i, o) in enumerate(zip(ins, outs)):
        arrays = ([(bf, _c16(i)), (bf if l < f32_from else f32, _c16(o))] if tc
                  else [(f32, i), (f32, o)])
        pair = []
        for dtype, width in arrays:
            if tc:
                used = -(-used // 256) * 256
            pair.append((used, dtype, width))
            used += n * width * (2 if dtype == bf else 4)
        layout.append(tuple(pair))
    return layout


def bwd_sizes(meta: Sequence[int], seg: str, n: int, tc: bool = False) -> Tuple[int, int]:
    """Floats of (scratch, partial sums) a backward needs for n points
    (``csrc/fused_train_dnerf.cu``'s ``dnerf_bwd_sizes``): the scratch of
    ``scratch_layout``; partial sums: each weight and bias gradient's [chunks
    of WG_KC points][in or 1][out]."""
    net = _net_meta(meta, SLOTS[seg])
    n_layers = net[0]
    ins, outs = net[2:2 + n_layers], net[2 + NL:2 + NL + n_layers]
    partial = sum(-(-n // WG_KC) * (i + 1) * o for i, o in zip(ins, outs))
    off, dtype, width = scratch_layout(meta, seg, n, tc)[-1][1]
    return -(-(off + n * width * (2 if dtype == torch.bfloat16 else 4)) // 4), partial


def _bwd_buffers(packed: DnPacked, seg: str, n: int, device, tc: bool = False):
    """Scratch, partial sums and the packed gradient of one backward call."""
    scratch, partial = bwd_sizes(packed.meta, seg, n, tc)
    return (torch.empty(max(scratch, 1), dtype=torch.float32, device=device),
            torch.empty(max(partial, 1), dtype=torch.float32, device=device),
            torch.empty_like(packed.w))


def dnerf_deform_bwd(packed: DnPacked, like, xt: torch.Tensor, g_xc: torch.Tensor,
                     simt: bool = False) -> Tuple[List[torch.Tensor], Tuple[None]]:
    """Cotangent on x_c [N, 3] -> (flat weight gradients, (None,)): xt gets
    no cotangent. A bf16 pack runs the tensor-core kernel; ``simt`` runs the
    SIMT one instead (the float64 comparison only)."""
    n = xt.shape[0]
    args = (_arg(xt, (n, 4), "xt"), _arg(g_xc, (n, 3), "g_xc"))
    tc = _tc(packed, simt, "deform_bwd")
    bufs = _bwd_buffers(packed, "deform", n, xt.device, tc)
    _run("dnerf_deform_bwd", packed, n, *args, *bufs, tc=tc)
    return unpack_grads(packed, "deform", like, bufs[2]), (None,)


def dnerf_density_bwd(packed: DnPacked, like, x_c: torch.Tensor, g_raw: torch.Tensor,
                      g_feat: torch.Tensor, simt: bool = False
                      ) -> Tuple[List[torch.Tensor], Tuple[torch.Tensor]]:
    """Cotangents on raw sigma [N, 1] and feat [N, F] -> (flat weight
    gradients, (d x_c [N, 3],)). A bf16 pack runs the tensor-core kernel;
    ``simt`` runs the SIMT one instead (the float64 comparison only)."""
    n = x_c.shape[0]
    f = packed.meta[6]
    args = (_arg(x_c, (n, 3), "x_c"), _arg(g_raw, (n, 1), "g_raw"),
            _arg(g_feat, (n, f), "g_feat"))
    tc = _tc(packed, simt, "density_bwd")
    d_xc = torch.empty(n, 3, dtype=torch.float32, device=x_c.device)
    bufs = _bwd_buffers(packed, "density", n, x_c.device, tc)
    _run("dnerf_density_bwd", packed, n, *args, d_xc, *bufs, tc=tc)
    return unpack_grads(packed, "density", like, bufs[2]), (d_xc,)


def dnerf_color_bwd(packed: DnPacked, like, d: torch.Tensor, feat: torch.Tensor,
                    g_rgb: torch.Tensor, simt: bool = False
                    ) -> Tuple[List[torch.Tensor], Tuple[None, torch.Tensor]]:
    """Cotangent on rgb [N, 3] -> (flat weight gradients, (None, d feat [N,
    F])): d gets no cotangent. A bf16 pack runs the tensor-core kernel (its
    nets checked first, on any device); ``simt`` runs the SIMT one instead
    (the float64 comparison only)."""
    tc = _tc(packed, simt, "color_bwd")
    n = d.shape[0]
    f = packed.meta[6]
    args = (_arg(d, (n, 3), "d"), _arg(feat, (n, f), "feat"), _arg(g_rgb, (n, 3), "g_rgb"))
    d_feat = torch.empty(n, f, dtype=torch.float32, device=d.device)
    bufs = _bwd_buffers(packed, "color", n, d.device, tc)
    _run("dnerf_color_bwd", packed, n, *args, d_feat, *bufs, tc=tc)
    return unpack_grads(packed, "color", like, bufs[2]), (None, d_feat)


# by segment: forward (packed, *inputs) -> outputs; backward (packed, like,
# *inputs, *output cotangents) -> (flat weight gradients, input cotangents)
FWD = {"deform": dnerf_deform_fwd, "density": dnerf_density_fwd, "color": dnerf_color_fwd}
BWD = {"deform": dnerf_deform_bwd, "density": dnerf_density_bwd, "color": dnerf_color_bwd}


# ---------------------------------------------------------------------------
# the segments as autograd Functions (port of _build_segments)
# ---------------------------------------------------------------------------

def _segment_function(seg: str, name: str, doc: str):
    """The autograd Function of one segment: ``apply(spec, like, precision,
    packed, *inputs, *flat)`` (``SEGMENT_INPUTS`` order, then the flat
    effective weights) -> its outputs. With ``packed`` (CUDA tensors) the
    forward and backward kernels run; without it (CPU tensors) ``seg_math``
    and ``plain_bwd``."""
    n_in = len(SEGMENT_INPUTS[seg])

    class Segment(torch.autograd.Function):
        __doc__ = doc

        @staticmethod
        def forward(ctx, spec, like, precision, packed, *args):
            inputs, flat = args[:n_in], args[n_in:]
            ctx.spec, ctx.like, ctx.precision, ctx.packed = spec, like, precision, packed
            ctx.save_for_backward(*args)
            if packed is not None:
                outs = FWD[seg](packed, *inputs)
                return outs
            outs = seg_math(spec, seg, like, flat, inputs, precision)
            return outs if len(outs) > 1 else outs[0]

        @staticmethod
        @once_differentiable
        def backward(ctx, *cots):
            args = ctx.saved_tensors
            inputs, flat = args[:n_in], args[n_in:]
            if ctx.packed is not None:
                d_flat, d_in = BWD[seg](ctx.packed, ctx.like, *inputs, *cots)
            else:
                d_flat, d_in = plain_bwd(ctx.spec, seg, ctx.like, flat, inputs, cots,
                                         ctx.precision)
            return (None, None, None, None, *d_in, *d_flat)

    Segment.__name__ = Segment.__qualname__ = name
    return Segment


SegDeform = _segment_function(
    "deform", "SegDeform", "(xt, eff_d...) -> x_c [N, 3]; xt gets no cotangent. CUDA tensors "
    "run dnerf_deform_fwd / dnerf_deform_bwd.")
SegDensity = _segment_function(
    "density", "SegDensity", "(x_c, eff_s..., head, featw) -> (raw sigma [N, 1], feat [N, F]). "
    "CUDA tensors run dnerf_density_fwd / dnerf_density_bwd.")
SegColor = _segment_function(
    "color", "SegColor", "(d, feat, eff_c...) -> rgb [N, 3]; d gets no cotangent. CUDA "
    "tensors run dnerf_color_fwd / dnerf_color_bwd.")
SEGMENT_FUNCTIONS = {"deform": SegDeform, "density": SegDensity, "color": SegColor}


def megakernel_field_raw(spec, params: Dict[str, Any], x: torch.Tensor, d: torch.Tensor,
                         t: torch.Tensor, precision: str = "highest"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The D-NeRF field as its three segments (contract of JAX's
    ``megakernel_field_raw``): x, d [N, 3], t [N, 1] -> (rgb [N, 3] after the
    sigmoid, raw sigma [N] before noise and relu). x, d and t receive no
    cotangents (data rays and sample locations without grad). CUDA tensors
    run the segment kernels, forward and backward; CPU tensors the plain
    math."""
    from endosurf_tpu_torch.kernels.fused_render import precision_dtype
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no D-NeRF field segments for device {x.device}")
    _no_grad_inputs("megakernel_field_raw", x, d, t)
    eff = prepare_effective_dnerf(spec, params)
    packed = (pack_dnerf(spec, params, precision_dtype(precision))
              if x.device.type == "cuda" else None)

    def run(seg, *inputs):
        like, flat = segment_weights(eff, seg)
        return SEGMENT_FUNCTIONS[seg].apply(spec, like, precision, packed, *inputs, *flat)
    x_c = run("deform", torch.cat([x, t], dim=-1)) if spec.use_deform else x
    raw, feat = run("density", x_c)
    return run("color", d, feat), raw[:, 0]


def plain_field_raw(spec, params: Dict[str, Any], x: torch.Tensor, d: torch.Tensor,
                    t: torch.Tensor, precision: str = "highest"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of ``megakernel_field_raw`` on any device:
    ``forward_math`` under autograd."""
    out = forward_math(spec, prepare_effective_dnerf(spec, params), x, t, d, precision)
    return out["rgb"], out["raw_sigma"][:, 0]


# ---------------------------------------------------------------------------
# kernel vs plain version
# ---------------------------------------------------------------------------

def parity_errors(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                  dtype: torch.dtype) -> Dict[str, Tuple[float, float, float, bool]]:
    """Per output: (median, p99, max) of the per-point error and whether all
    three are within ``PARITY_TOL[dtype]``."""
    from endosurf_tpu_torch.kernels.fused_train_cuda import _point_err, _quantiles
    tol = PARITY_TOL[dtype]
    out = {}
    for k, r in ref.items():
        med, p99, mx = _quantiles(_point_err(got[k], r))
        out[k] = (med, p99, mx, med <= tol[0] and p99 <= tol[1] and mx <= tol[2])
    return out


def _plain_chain(spec, eff, x, d, t, precision):
    """The plain chain's per-segment inputs: {segment: inputs}."""
    with torch.no_grad():
        xt = torch.cat([x, t], dim=-1).contiguous()
        x_c = seg_deform_math(spec, eff["deform"], xt, precision) if spec.use_deform else x
        _, feat = seg_density_math(spec, eff["density"], eff["sigma_head"], eff["geo_feat"],
                                   x_c, precision)
    ins = {"density": (x_c,), "color": (d, feat)}
    return {"deform": (xt,), **ins} if spec.use_deform else ins


def segment_parity(spec, params: Dict[str, Any], x: torch.Tensor, d: torch.Tensor,
                   t: torch.Tensor, precision: str, kernel_precision: str = None
                   ) -> Tuple[Dict[str, Dict], Dict[str, float], Dict[str, Sequence]]:
    """Each forward kernel against its plain version on the same inputs (the
    plain chain's own values, so each segment is judged alone), at
    ``precision``'s limits; with ``kernel_precision`` the kernels run at that
    precision instead (the wrong-precision control). Returns ({kernel name:
    parity_errors}, {kernel name: max absolute error}, {kernel name: (packed,
    inputs)} for timing)."""
    from endosurf_tpu_torch.kernels.fused_render import precision_dtype
    dtype = precision_dtype(precision)
    packed = pack_dnerf(spec, params, precision_dtype(kernel_precision or precision))
    eff = prepare_effective_dnerf(spec, params)
    names = {"deform": ("x_c",), "density": ("raw_sigma", "feat"), "color": ("rgb",)}
    res, abs_err, cases = {}, {}, {}
    for seg, inputs in _plain_chain(spec, eff, x, d, t, precision).items():
        like, flat = segment_weights(eff, seg)
        with torch.no_grad():
            ref = dict(zip(names[seg], seg_math(spec, seg, like, flat, inputs, precision)))
        out = FWD[seg](packed, *inputs)
        got = dict(zip(ref, out if isinstance(out, tuple) else (out,)))
        name = f"dnerf_{seg}_fwd"
        res[name] = parity_errors(got, ref, dtype)
        abs_err[name] = max(float((got[k] - ref[k]).abs().max()) for k in ref)
        cases[name] = (packed, inputs)
    return res, abs_err, cases


def leaf_names(like: Sequence[Dict[str, Any]], seg: str) -> List[str]:
    """Names of a segment's flat weights, in ``segment_weights`` order."""
    from endosurf_tpu_torch.kernels.fused_train_cuda import leaf_names as layer_names
    return layer_names(like, "") + (["head.w", "head.b", "feat.w", "feat.b"]
                                    if seg == "density" else [])


def bwd_parity_errors(kernel: str, d_in: Dict[str, torch.Tensor],
                      ref_in: Dict[str, torch.Tensor], leaves: Dict[str, torch.Tensor],
                      ref_leaves: Dict[str, torch.Tensor], dtype: torch.dtype
                      ) -> Dict[str, Dict[str, Tuple]]:
    """Backward kernel ``kernel`` against its plain version: {"cot": {input:
    (median, p99, max, ok)}, "leaf": {weight: (relative L2, ok)}} within
    ``BWD_PARITY_TOL[dtype]`` (``cot_tol``; the per-point error of
    ``fused_train_cuda._point_err``)."""
    from endosurf_tpu_torch.kernels.fused_train_cuda import _point_err, _quantiles
    res: Dict[str, Dict[str, Tuple]] = {"cot": {}, "leaf": {}}
    for k, r in ref_in.items():
        vals = _quantiles(_point_err(d_in[k], r))
        res["cot"][k] = (*vals, all(v <= t for v, t in zip(vals, cot_tol(dtype, kernel, k))))
    leaf_tol = BWD_PARITY_TOL[dtype]["leaf"]
    for k, r in ref_leaves.items():
        rel = float((leaves[k].float() - r.float()).norm()
                    / max(float(r.float().norm()), 1e-30))
        res["leaf"][k] = (rel, rel <= leaf_tol)
    return res


def bwd_segment_parity(spec, params: Dict[str, Any], x: torch.Tensor, d: torch.Tensor,
                       t: torch.Tensor, precision: str, seed: int = 0,
                       kernel_precision: str = None):
    """Each backward kernel against its plain version (``plain_bwd``) on the
    plain chain's inputs with seeded random cotangents, at ``precision``'s
    ``BWD_PARITY_TOL``; with ``kernel_precision`` the kernels run at that
    precision (the control). Returns ({kernel name: bwd_parity_errors},
    {kernel name: max absolute error over gradients and cotangents},
    {kernel name: (packed, like, flat, inputs, cotangents)} for timing)."""
    from endosurf_tpu_torch.kernels.fused_render import precision_dtype
    dtype = precision_dtype(precision)
    packed = pack_dnerf(spec, params, precision_dtype(kernel_precision or precision))
    gen = torch.Generator(device=x.device).manual_seed(seed)
    eff = prepare_effective_dnerf(spec, params)
    res, abs_err, cases = {}, {}, {}
    for seg, inputs in _plain_chain(spec, eff, x, d, t, precision).items():
        like, flat = segment_weights(eff, seg)
        with torch.no_grad():
            outs = seg_math(spec, seg, like, flat, inputs, precision)
        cots = tuple(torch.randn(*o.shape, generator=gen, device=x.device) for o in outs)
        leaves, d_in = BWD[seg](packed, like, *inputs, *cots)
        ref_leaves, ref_in = plain_bwd(spec, seg, like, flat, inputs, cots, precision)
        names = leaf_names(like, seg)
        got_in = {k: v for k, v in zip(SEGMENT_INPUTS[seg], d_in) if v is not None}
        want_in = {k: v for k, v in zip(SEGMENT_INPUTS[seg], ref_in) if v is not None}
        name = f"dnerf_{seg}_bwd"
        res[name] = bwd_parity_errors(name, got_in, want_in, dict(zip(names, leaves)),
                                      dict(zip(names, ref_leaves)), dtype)
        abs_err[name] = max(float((g.float() - r.float()).abs().max()) for g, r in
                            zip([*leaves, *got_in.values()], [*ref_leaves, *want_in.values()]))
        cases[name] = (packed, like, flat, inputs, cots)
    return res, abs_err, cases


def bwd_parity_ok(res: Dict[str, Dict[str, Dict]]) -> bool:
    """Every reading of ``bwd_segment_parity`` within its limits."""
    return all(v[-1] for kinds in res.values() for vals in kinds.values() for v in vals.values())


# ---------------------------------------------------------------------------
# the tensor-core kernels' float64 yardsticks
# ---------------------------------------------------------------------------

def _float64_segment(spec, params: Dict[str, Any], seg: str):
    """(like, flat) of one segment on float64 copies of the float32
    parameters (the dots of "default" round them to the kernels' bf16
    values)."""
    from endosurf_tpu_torch.kernels.fused_sampler import to_float64
    return segment_weights(prepare_effective_dnerf(spec, to_float64(params)), seg)


def dnerf_deform_fwd_float64(spec, params: Dict[str, Any], xt: torch.Tensor,
                             precision: str = "default") -> torch.Tensor:
    """The bf16 deform forward's float64 yardstick: ``seg_math`` on float64
    copies of the kernels' own weights and of xt, with ``precision``'s
    operand roundings (the coordinates rounded before they are encoded, as
    the field rounds them) and float64 arithmetic between them. Returns x_c
    [N, 3] in float64, as ``dnerf_deform_fwd``."""
    like, flat = _float64_segment(spec, params, "deform")
    with torch.no_grad():
        return seg_math(spec, "deform", like, flat, (xt.double(),), precision)[0]


def dnerf_density_fwd_float64(spec, params: Dict[str, Any], x_c: torch.Tensor,
                              precision: str = "default") -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 density forward's float64 yardstick: ``seg_math`` on float64
    copies of the kernels' own weights and of x_c, with ``precision``'s
    operand roundings and float64 arithmetic between them. Returns (raw sigma
    [N, 1], feat [N, F]) in float64, as ``dnerf_density_fwd``."""
    like, flat = _float64_segment(spec, params, "density")
    with torch.no_grad():
        return seg_math(spec, "density", like, flat, (x_c.double(),), precision)


def dnerf_deform_bwd_float64(spec, params: Dict[str, Any], xt: torch.Tensor,
                             g_xc: torch.Tensor, precision: str = "default"
                             ) -> Tuple[List[torch.Tensor], Tuple[None]]:
    """The bf16 deform backward's float64 yardstick: ``plain_bwd`` on float64
    copies of the kernels' own weights, of xt and of the cotangent, with
    ``precision``'s operand and cotangent roundings and float64 arithmetic
    between them. Returns (flat weight gradients, (None,)) in float64, as
    ``dnerf_deform_bwd``."""
    like, flat = _float64_segment(spec, params, "deform")
    return plain_bwd(spec, "deform", like, flat, (xt.double(),), (g_xc.double(),), precision)


def dnerf_deform_walk_float64(spec, params: Dict[str, Any], xt: torch.Tensor,
                              g_xc: torch.Tensor, precision: str = "default"
                              ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The deform backward's recompute and walk in float64 on the float32
    parameters, with ``precision``'s operand and cotangent roundings (those
    of ``dnerf_deform_bwd_float64``): per layer its operand rows (op([h |
    enc])) and the cotangent on its pre-activation, as a backward's scratch
    holds them ([N, in_l], [N, out_l])."""
    from endosurf_tpu_torch.kernels.fused_sampler import to_float64
    layers = to_float64(params)["deform"]["layers"]
    skips = spec.deform_layers[2]
    xr = operand(xt.double(), precision)
    enc = torch.cat([freq_encode(xr[:, :3], spec.pos_deform_freqs),
                     freq_encode(xr[:, 3:4], spec.time_deform_freqs)], dim=-1)
    ins, zs, h = [], [], enc
    with torch.no_grad():
        for l, lay in enumerate(layers):
            ins.append(operand(torch.cat([h, enc], -1) if 0 < l and l in skips else h, precision))
            zs.append(ins[-1] @ operand(lay["w"], precision) + lay["b"])
            h = torch.relu(zs[-1])
        dzs, g = [], g_xc.double()
        for l in range(len(layers) - 1, -1, -1):
            dzs.insert(0, g)
            if l > 0:
                g_in = operand(g @ operand(layers[l]["w"], precision).T, precision)
                g = g_in[:, :zs[l - 1].shape[1]] * (zs[l - 1] > 0)
    return ins, dzs


def dnerf_density_bwd_float64(spec, params: Dict[str, Any], x_c: torch.Tensor,
                              g_raw: torch.Tensor, g_feat: torch.Tensor,
                              precision: str = "default"
                              ) -> Tuple[List[torch.Tensor], Tuple[torch.Tensor]]:
    """The bf16 density backward's float64 yardstick: ``plain_bwd`` on
    float64 copies of the kernels' own weights (the float32 parameters;
    "default" rounds them to the kernels' bf16 values), of x_c and of the
    cotangents, with ``precision``'s operand and cotangent roundings and
    float64 arithmetic between them. Returns (flat weight gradients, (d x_c
    [N, 3],)) in float64, as ``dnerf_density_bwd``."""
    like, flat = _float64_segment(spec, params, "density")
    return plain_bwd(spec, "density", like, flat, (x_c.double(),),
                     (g_raw.double(), g_feat.double()), precision)


def dnerf_color_bwd_float64(spec, params: Dict[str, Any], d: torch.Tensor, feat: torch.Tensor,
                            g_rgb: torch.Tensor, precision: str = "default"
                            ) -> Tuple[List[torch.Tensor], Tuple[None, torch.Tensor]]:
    """The bf16 colour backward's float64 yardstick: ``plain_bwd`` on float64
    copies of the kernels' own weights (the float32 parameters; "default"
    rounds them to the kernels' bf16 values), of d, of the feature and of the
    cotangent, with ``precision``'s operand and cotangent roundings and
    float64 arithmetic between them. Returns (flat weight gradients, (None, d
    feat [N, F])) in float64, as ``dnerf_color_bwd``."""
    like, flat = _float64_segment(spec, params, "color")
    return plain_bwd(spec, "color", like, flat, (d.double(), feat.double()), (g_rgb.double(),),
                     precision)


def _median_p99(err: torch.Tensor) -> Tuple[float, float]:
    q = torch.quantile(err, torch.tensor([0.5, 0.99], dtype=err.dtype, device=err.device))
    return float(q[0]), float(q[1])


def _point_dist(got: torch.Tensor, ref: torch.Tensor) -> Tuple[float, float]:
    """(median, p99) of the per-point error: the max over channels, over the
    yardstick's rms."""
    r = ref.double()
    return _median_p99((got.double() - r).abs().amax(dim=-1) / (r.pow(2).mean().sqrt() + 1e-300))


def fwd_float64_distance(outs: Dict[str, torch.Tensor], refs: Dict[str, torch.Tensor]
                         ) -> Dict[str, Tuple[float, float]]:
    """A forward against its float64 yardstick: per output, (median, p99) of
    the per-point error."""
    return {k: _point_dist(outs[k], r) for k, r in refs.items()}


def bwd_float64_distance(leaves: Sequence[torch.Tensor], d_xc: Optional[torch.Tensor],
                         ref_leaves: Sequence[torch.Tensor], ref_dxc: Optional[torch.Tensor],
                         cot: str = "d_xc") -> Dict[str, Tuple[float, float]]:
    """A backward against its float64 yardstick: (median, p99) of the weight
    gradients' per-element error (over the rms of the element's leaf in the
    yardstick) and, where the backward forms one (the density's d x_c, the
    colour's d feat: ``cot`` names it), of the input cotangent's per-point
    error."""
    dist = {} if ref_dxc is None else {cot: _point_dist(d_xc, ref_dxc)}
    e_w = torch.cat([((g.double() - rl).abs() / (rl.pow(2).mean().sqrt() + 1e-300)).reshape(-1)
                     for g, rl in zip(leaves, ref_leaves)])
    dist["weights"] = _median_p99(e_w)
    return dist


def _raw_density(spec, params: Dict[str, Any], x: torch.Tensor, t: torch.Tensor,
                 simt: bool = False) -> torch.Tensor:
    from endosurf_tpu_torch.kernels.fused_sdf import fused_density_raw_cuda
    return fused_density_raw_cuda(spec, params, x, t, torch.bfloat16, simt)


def _raw_density_float64(spec, params: Dict[str, Any], x: torch.Tensor, t: torch.Tensor
                         ) -> torch.Tensor:
    from endosurf_tpu_torch.kernels.fused_sdf import fused_density_raw_float64
    return fused_density_raw_float64(spec, params, x, t)


def _sdf_query(spec, params: Dict[str, Any], x: torch.Tensor, t: torch.Tensor,
               simt: bool = False) -> torch.Tensor:
    from endosurf_tpu_torch.kernels.fused_sdf import fused_sdf_observed_cuda
    return fused_sdf_observed_cuda(spec, params, x, t, torch.bfloat16, simt)


def _sdf_query_float64(spec, params: Dict[str, Any], x: torch.Tensor, t: torch.Tensor
                       ) -> torch.Tensor:
    from endosurf_tpu_torch.kernels.fused_sdf import fused_sdf_observed_float64
    return fused_sdf_observed_float64(spec, params, x, t)


# The kernels with a tensor-core bf16 version beside their SIMT one
# (simt=True), for tc_float64_distance: name -> (its outputs' names, None for
# a backward; its float64 yardstick (spec, params, *inputs, *cots); the
# kernel (spec, params, packed, like, *inputs, *cots, simt=)). The D-NeRF
# kernels and the EndoSurf grid query (fused_sdf_observed).
TC_KERNELS = {
    "dnerf_deform_fwd": (("x_c",), dnerf_deform_fwd_float64,
                         lambda spec, params, packed, like, xt, simt:
                         dnerf_deform_fwd(packed, xt, simt)),
    "dnerf_density_fwd": (("raw_sigma", "feat"), dnerf_density_fwd_float64,
                          lambda spec, params, packed, like, x_c, simt:
                          dnerf_density_fwd(packed, x_c, simt)),
    "dnerf_deform_bwd": (None, dnerf_deform_bwd_float64,
                         lambda spec, params, packed, like, *args, simt:
                         dnerf_deform_bwd(packed, like, *args, simt=simt)),
    "dnerf_density_bwd": (None, dnerf_density_bwd_float64,
                          lambda spec, params, packed, like, *args, simt:
                          dnerf_density_bwd(packed, like, *args, simt=simt)),
    "dnerf_color_bwd": (None, dnerf_color_bwd_float64,
                        lambda spec, params, packed, like, *args, simt:
                        dnerf_color_bwd(packed, like, *args, simt=simt)),
    "fused_density_raw": (("raw",), _raw_density_float64,
                          lambda spec, params, packed, like, x, t, simt:
                          _raw_density(spec, params, x, t, simt)),
    "fused_sdf_observed": (("sdf",), _sdf_query_float64,
                           lambda spec, params, packed, like, x, t, simt:
                           _sdf_query(spec, params, x, t, simt)),
}


def tc_float64_distance(spec, params: Dict[str, Any], kernel: str, packed: Optional[DnPacked],
                        like, inputs: Sequence[torch.Tensor], cots: Sequence[torch.Tensor] = ()
                        ) -> Dict[str, Dict[str, Tuple[float, float]]]:
    """A ``TC_KERNELS`` kernel in bf16 (a bf16 pack; the raw density and
    observed-SDF queries pack their own and take None) and its SIMT kernel,
    each against the float64 yardstick on the same inputs (and, for a
    backward, cotangents):
    {"tensor cores": distance, "SIMT": distance}, each
    ``fwd_float64_distance`` (per output) or ``bwd_float64_distance`` (its
    input cotangent named "d_" + the input's name without "_": d_xc,
    d_feat)."""
    if kernel not in TC_KERNELS:
        raise ValueError(f"{kernel} has no tensor-core kernel")
    names, yardstick, run = TC_KERNELS[kernel]
    if names is None:
        cot = "d_" + "".join(COTANGENT_INPUTS[kernel.split("_")[1]]).replace("_", "")

    def outs(v):
        return dict(zip(names, v if isinstance(v, tuple) else (v,)))

    def d_in(v):
        return next((c for c in v[1] if c is not None), None)
    ref = yardstick(spec, params, *inputs, *cots)
    out = {}
    for name, simt in (("tensor cores", False), ("SIMT", True)):
        got = run(spec, params, packed, like, *inputs, *cots, simt=simt)
        out[name] = (bwd_float64_distance(got[0], d_in(got), ref[0], d_in(ref), cot)
                     if names is None else fwd_float64_distance(outs(got), outs(ref)))
    return out


def dnerf_color_walk_float64(spec, params: Dict[str, Any], d: torch.Tensor, feat: torch.Tensor,
                             g_rgb: torch.Tensor, precision: str = "default"
                             ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The colour backward's recompute and walk in float64 on the float32
    parameters, with ``precision``'s operand and cotangent roundings (those
    of ``dnerf_color_bwd_float64``): per layer its operand rows (op([enc(d) |
    feat]), op(h)) and the cotangent on its pre-activation (the output
    layer's d rgb * rgb (1 - rgb)), as a backward's scratch holds them ([N,
    in_l], [N, out_l])."""
    from endosurf_tpu_torch.kernels.fused_sampler import to_float64
    layers = to_float64(params)["color"]["layers"]
    h = torch.cat([freq_encode(operand(d.double(), precision), spec.dir_color_freqs),
                   feat.double()], -1)
    ins, zs = [], []
    with torch.no_grad():
        for lay in layers:
            ins.append(operand(h, precision))
            zs.append(ins[-1] @ operand(lay["w"], precision) + lay["b"])
            h = torch.relu(zs[-1])
        rgb = torch.sigmoid(zs[-1])
        dzs, g = [], g_rgb.double() * rgb * (1 - rgb)
        for l in range(len(layers) - 1, -1, -1):
            dzs.insert(0, g)
            if l > 0:
                g = operand(g @ operand(layers[l]["w"], precision).T, precision) * (zs[l - 1] > 0)
    return ins, dzs


# the float64 walks of walk_distance: segment -> (yardstick (spec, params,
# *inputs, *cots), the kernel's inputs and outputs besides the scratch (packed,
# *inputs, *cots))
WALKS = {
    "deform": (dnerf_deform_walk_float64,
               lambda packed, xt, g_xc: (_arg(xt, (xt.shape[0], 4), "xt"),
                                         _arg(g_xc, (xt.shape[0], 3), "g_xc"))),
    "color": (dnerf_color_walk_float64,
              lambda packed, d, feat, g_rgb: (
                  _arg(d, (d.shape[0], 3), "d"), _arg(feat, (d.shape[0], packed.meta[6]), "feat"),
                  _arg(g_rgb, (d.shape[0], 3), "g_rgb"),
                  torch.empty(d.shape[0], packed.meta[6], dtype=torch.float32, device=d.device))),
}


def walk_distance(spec, params: Dict[str, Any], seg: str, packed: DnPacked,
                  inputs: Sequence[torch.Tensor], cots: Sequence[torch.Tensor]
                  ) -> Dict[str, Dict[str, float]]:
    """A backward's own arithmetic against float64, below its weight
    gradients (the deform's and the colour's, ``WALKS``): the tensor-core
    kernel and the SIMT one (a bf16 pack) run on (inputs, cots), each layer's
    operand rows and pre-activation cotangents read back from the scratch
    (``scratch_layout``) and held against the float64 walk, each value
    rounded to the scratch's float32 where it is float32. Returns {"tensor
    cores": {"points": share of the points with any element off, "x<l>" /
    "dz<l>": share of layer l's operand / cotangent elements off, "weights":
    share of the weight-gradient elements off float64 (the walk's exact
    product, rounded as the yardstick rounds), "product": share off the exact
    product of the kernel's own operands and cotangents}, "SIMT": the same}.
    A float32 sum that tips one bf16 rounding moves the later layers of its
    point through the chaotic deform net, and the weight gradients sum every
    point: at base.yml's widths a third of the deform's gradient elements
    sit an ulp or more off float64 for either kernel, and the colour's bias
    and output-layer gradients sit at one float32 summation floor for
    either, so their distance says little about which is nearer."""
    def rounded(w):
        return w.to(torch.float32).to(torch.bfloat16).double()
    walk, args = WALKS[seg]
    n = inputs[0].shape[0]
    ins, dzs = walk(spec, params, *inputs, *cots)
    ref_w = [rounded(a.T @ dz) for a, dz in zip(ins, dzs)]
    tensors = args(packed, *inputs, *cots)
    out = {}
    for name, simt in (("tensor cores", False), ("SIMT", True)):
        tc = _tc(packed, simt, f"{seg}_bwd")
        bufs = _bwd_buffers(packed, seg, n, inputs[0].device, tc)
        _run(f"dnerf_{seg}_bwd", packed, n, *tensors, *bufs, tc=tc)
        raw = bufs[0].view(torch.uint8)
        off = torch.zeros(n, dtype=torch.bool, device=inputs[0].device)
        shares, w_off, w_own, w_all = {}, 0, 0, 0
        for l, (pair, (wo, _, i, o)) in enumerate(zip(
                scratch_layout(packed.meta, seg, n, tc), packed.layout(seg))):
            got = []
            for (at, dtype, width), ref, key in zip(pair, (ins[l], dzs[l]), (f"x{l}", f"dz{l}")):
                item = 2 if dtype == torch.bfloat16 else 4
                got.append(raw[at:at + n * width * item].view(dtype).view(n, width)
                           [:, :ref.shape[1]].double())
                diff = got[-1] != ref.float().double()
                off |= diff.any(1)
                shares[key] = float(diff.double().mean())
            dw = bufs[2][wo:wo + i * o].view(i, o).double()
            w_off += int((dw != ref_w[l]).sum())
            w_own += int((dw != rounded(got[0].T @ got[1])).sum())
            w_all += i * o
        out[name] = {"points": float(off.double().mean()), "weights": w_off / w_all,
                     "product": w_own / w_all, **shares}
    return out