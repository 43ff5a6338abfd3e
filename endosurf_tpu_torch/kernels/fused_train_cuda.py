"""The train-step field segments on the card: bindings of ``csrc/fused_train.cu``.

Counterpart of ``endosurf_tpu/kernels/fused_train_pallas.py`` (the Pallas
``deform_fwd`` / ``deform_bwd``, ``sdf_fwd`` / ``sdf_bwd``, ``color_fwd`` /
``color_bwd``). ``fused_train.SegDeform`` / ``SegSdf`` / ``SegColor`` call
these for CUDA tensors; their plain versions are ``fused_train.seg_*_math``
and ``torch.autograd.grad`` of them.

* ``pack_segment``: the segment's *effective* weights (the output of
  ``fused_train.prepare_effective``, split skips and all) packed into one
  float32 buffer with the meta layout ``csrc/sdf_chain.cuh`` decodes: per
  layer W [in, out], b and W^T. Under ``"default"`` the weights are rounded to
  bf16 values; biases and the SDF adjoint's head column are not. The packs
  then also carry each layer's W and W^T as bf16 in mma fragment order
  (``mma_frags``), their offsets appended to the meta: the tensor-core
  kernels (``csrc/field_tc.cuh``) read them.
* ``*_fwd`` / ``*_bwd`` (by segment in ``FWD`` / ``BWD``): the launches. A
  forward returns its outputs as a tuple; a backward returns the gradients
  of the flat effective weights (``fused_train.segment_weights`` order),
  unpacked from the kernel's packed gradient (dW and db at their weights'
  offsets), and the cotangents of the segment's differentiable inputs.
* ``LAUNCHES``: one count per segment kernel call.

bf16 backward semantics. In ``"default"`` the plain version's autograd rounds
every cotangent that crosses a bf16 cast (``ops.mlp.dot`` rounds both
operands): the cotangent a dot sends to its input, and the dot's weight
gradient, summed over all points. JAX's ``_dot`` does the same. The kernels
reproduce this: each dot's input cotangent and each dot's weight-gradient sum
(over all points, after the fixed-order reduction) are rounded to bf16;
biases and the head column are not. What remains between kernel and plain
version is the order of float32 sums, and a bf16 rounding that an ulp of it
tips (PERF.md, PR 3 Findings, has the readings).

In ``"default"`` all six kernels run on tensor cores (``csrc/field_tc.cuh``;
each forward shares its tile function with its backward's recompute, so the
forward the loss sees is the one the backward differentiates, bit for bit);
every kernel in ``"highest"`` stays SIMT. A float32 operand of a product that is
not a bf16 value (the SDF's cotangents; the float32 cotangent on the deform
and colour nets' 3-wide outputs in their weight gradients) goes in as a sum
of bf16 terms, three in the tile walks and two in the weight-gradient product
(``split_bf16_terms``; ``split_product`` is the plain version of such a
product).
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Sequence, Tuple

import torch

from endosurf_tpu_torch.kernels.fused_render import (
    META_NET,
    NL,
    cuda_spec_supported,
    spec_refusal,
)

SEGMENTS = ("deform", "sdf", "color")
_SEG_ID = {name: i for i, name in enumerate(SEGMENTS)}
# segments whose bf16 kernels run on tensor cores (their packs carry mma fragments)
TC_SEGMENTS = ("deform", "sdf", "color")
META_LEN = 8 + 3 * META_NET      # csrc/sdf_chain.cuh; the fragment offsets follow

# Launches made through this module, one per segment kernel call (a backward
# call runs its tile kernel and the weight-gradient product).
LAUNCHES = {f"{s}_{d}": 0 for s in SEGMENTS for d in ("fwd", "bwd")}

# Kernel vs plain version on one card. Per point the error is the max over
# channels of |kernel - plain| / rms(plain) (the output's or cotangent's RMS
# over all points); "out" limits its (median, p99, max) over the points of
# every forward output, "cot" its (p99, max) over the points of every input
# cotangent of a backward, "leaf" the relative L2 norm of every parameter
# gradient. Both sides run the same math with float32 accumulation in other
# orders. Where a relu pre-activation sits within that rounding noise of 0,
# the two sides gate it differently: the primal barely moves, but the
# Jacobian tangent or the cotangent through that neuron jumps, by up to the
# size of the point's whole row or cotangent (a float32 plain version does
# the same against a float64 one: tests/test_torch_cuda.py
# test_segment_f32_tails_are_float32_noise). In bf16 an
# ulp of that order also tips an operand's rounding now and then. So the max
# only catches gross faults, the median and p99 hold the bulk, and the leaf
# limits sit where a few such points land. Set from readings on an H100
# (PERF.md, PR 3 Findings): the limits sit between the sound pairs and the
# wrong-precision controls, about 2x from each where they are closest (the
# leaves: sound <= 2.4e-3 f32 / 4.4e-3 bf16, the SDF control ~1.9e-2).
# Re-read for the tensor-core bf16 deform and SDF backward (PERF.md, PR 7;
# chip_smoke phase 9 both seeds, the card tests, 65,531 ragged points): its
# float32 sums no longer follow the plain version's k order, as the SIMT FMA
# chains did (most bf16 readings were exactly 0), so bf16 roundings tip as
# between any two float32 orders. Sound: SDF d x_c p99 <= 8.0e-3 (the
# float32 plain version reads 7.6e-3 against a float64 one), max <= 3.9e-2;
# leaves <= 3.9e-3 deform, 3.3e-3 SDF. Controls: the kernels at the other
# precision, SDF d x_c p99 >= 1.7e-2, leaves >= 1.8e-2; the planted
# tensor-core faults, SDF leaf >= 1.15e-2 or d x_c p99 >= 1.5e-2 or the
# order check >= 7e-2. The limits stay.
# Re-read for the tensor-core bf16 deform forward and colour backward
# (PERF.md; the card tests on an H100, 3 nets x 2 seeds and 65,531 ragged points):
# sound deform out median and p99 0 (max <= 2.3e-2 on the rows), colour leaf
# <= 4.6e-3, cot p99 <= 5.3e-3; controls (the other precision) colour leaf
# >= 0.52, cot >= 2.4. The limits stay. Added then: "bias".
# Added with the tensor-core SDF forward: "sdf_out", the SDF forward's
# outputs (sdf, feat, grad_c), "out"'s limits but a bf16 p99 of 1.5e-2 (was
# "out"'s 2e-4). Its SIMT kernel summed in the plain version's k order and
# read p99 0 on feat and grad_c; the tensor-core forward sums in the mma's
# order, so its bf16 roundings tip as the backward's do, and grad_c (the
# adjoint through all eight hidden layers) carries them like the backward's
# d x_c. Readings on an H100 (PERF.md §6; phase 9, 65,536 midpoints,
# seeds 0 / 1): sound median <= 6.9e-7, p99 sdf 2.22e-3 / 1.80e-3, feat
# 2.22e-3 / 1.81e-3, grad_c 7.41e-3 / 7.46e-3, max <= 1.7e-2. Against a
# float64 plain version the kernel reads p99 6.3e-4 / 3.7e-3 (sdf, grad_c),
# the float32 plain version and the SIMT kernel 2.1e-3 / 7.4e-3: the
# kernel is the closer. The medians stay what tells the precisions apart.
PARITY_TOL = {
    torch.float32: {"out": (1e-5, 1e-4, 0.1), "cot": (1e-4, 5.0), "leaf": 1e-2, "bias": 2e-4},
    torch.bfloat16: {"out": (2e-5, 2e-4, 0.1), "sdf_out": (2e-5, 1.5e-2, 0.1),
                     "cot": (1e-2, 5.0), "leaf": 9e-3, "bias": 2e-4},
}
# "bias": the relative L2 of the gradients of each net's output-layer bias,
# the sum over the points of the caller's float32 cotangent (the colour's
# through its sigmoid), rounded nowhere in either version: only the float32
# sums' order and a rare tipped rounding in the forward tell the two apart,
# while the other leaves sit on whole-ulp tips of their final bf16 rounding
# (a weight-gradient fault of 2^-9 on the output layer hides in those). Sound
# <= 2.6e-5 f32, <= 4.2e-5 bf16 (the SDF's scalar head.b; the colour's
# <= 3.7e-6); the planted faults in the weight-gradient product read >=
# 1.34e-3 (the colour's output cotangent without its lo term 1.37e-3). The
# other-precision controls read <= 3.5e-5 here (no rounding on this path in
# either mode) and fail the other kinds.
def out_biases(seg: str, n_layers: int) -> Tuple[str, ...]:
    """The leaves "bias" judges: the output-layer biases of a segment whose
    net has ``n_layers`` layers (the SDF's head and feature columns)."""
    return ("head.b", "feat.b") if seg == "sdf" else (f"{n_layers - 1}.b",)


def _point_err(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    ref2 = ref.reshape(ref.shape[0], -1).float()
    err = (got.reshape(ref2.shape).float() - ref2).abs().amax(dim=-1)
    return err / (ref2.pow(2).mean().sqrt() + 1e-30)


def _quantiles(err: torch.Tensor) -> Tuple[float, float, float]:
    q = torch.quantile(err, torch.tensor([0.5, 0.99], device=err.device))
    return float(q[0]), float(q[1]), float(err.max())


def parity_tol(dtype: torch.dtype, kind: str):
    """``PARITY_TOL``'s limits of a kind; "sdf_out" has its own in bf16 only
    and is "out" in float32."""
    tols = PARITY_TOL[dtype]
    return tols["out"] if kind == "sdf_out" and kind not in tols else tols[kind]


def parity_errors(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                  dtype: torch.dtype, kind: str) -> Dict[str, Tuple]:
    """Per entry its readings and whether they are within ``parity_tol``:
    kind "out" or "sdf_out" (forward outputs) -> (median, p99, max, ok);
    "cot" (input cotangents) -> (p99, max, ok); "leaf" and "bias" (parameter
    gradients) -> (rel L2, ok)."""
    tol = parity_tol(dtype, kind)
    res = {}
    for k, r in ref.items():
        g = got[k]
        if kind in ("leaf", "bias"):
            rel = float((g.float() - r.float()).norm() / max(float(r.float().norm()), 1e-30))
            res[k] = (rel, rel <= tol)
            continue
        med, p99, mx = _quantiles(_point_err(g, r))
        if kind in ("out", "sdf_out"):
            res[k] = (med, p99, mx, med <= tol[0] and p99 <= tol[1] and mx <= tol[2])
        else:
            res[k] = (p99, mx, p99 <= tol[0] and mx <= tol[1])
    return res


def _c16(v: int) -> int:
    return -(-v // 16) * 16


def mma_frags(b: torch.Tensor, fill=0) -> torch.Tensor:
    """B [K, N] (bf16 values) as the tensor-core kernels load an mma B operand
    (``csrc/mma_tile.cuh``): K and N padded with ``fill`` to multiples of 16;
    per k-tile kt and per pair np of n-tiles, 32 lanes x 8 bf16, lane 4 g + t
    holding at element 4 q + 2 h + e the value B[16 kt + 8 h + 2 t + e,
    16 np + 8 q + g]. Returns a flat tensor of b's dtype (the same order
    applies to an index matrix)."""
    k, n = b.shape
    kp, np_ = _c16(k), _c16(n)
    pad = b.new_full((kp, np_), fill)
    pad[:k, :n] = b
    # (kt, h, t, e, np, q, g) -> (kt, np, g, t, q, h, e)
    return pad.view(kp // 16, 2, 4, 2, np_ // 16, 2, 8).permute(0, 4, 6, 2, 5, 1, 3).reshape(-1)


def split_bf16_terms(x: torch.Tensor, terms: int) -> List[torch.Tensor]:
    """x (float32) as ``terms`` bf16 values, each the bf16 rounding of what
    the previous ones left: |x - sum| <= 2^(-8 terms) |x|."""
    out, rest = [], x
    for _ in range(terms):
        out.append(rest.to(torch.bfloat16).to(torch.float32))
        rest = rest - out[-1]
    return out


def split_product(a: torch.Tensor, b: torch.Tensor, terms: int = 2) -> torch.Tensor:
    """The plain version of the kernels' product of a float32 operand a
    [M, K] that is not a bf16 value with bf16 values b [K, N]: the sum of
    a_i b over the bf16 terms a_i of a (two in the weight-gradient product,
    three in the tile walks), in float32. Against the exact product each
    element errs by at most (2^(-8 terms) + terms K 2^-24) (|a| |b|): the
    split's remainder and the float32 sums."""
    parts = split_bf16_terms(a, terms)
    out = parts[0] @ b
    for p in parts[1:]:
        out = out + p @ b
    return out


class Packed:
    """A segment's packed weights: ``w`` (float32, on the device), ``meta``
    (ctypes int64 array), ``rb`` (bf16 operands), and per layer (w_off, b_off,
    in, out, row-block widths) for unpacking gradients."""

    def __init__(self, seg, w, meta, rb, layers, n_flat):
        self.seg, self.w, self.meta, self.rb = seg, w, meta, rb
        self.layers, self.n_flat = layers, n_flat


def _check_spec(spec, seg: str) -> None:
    if not cuda_spec_supported(spec):
        raise ValueError(f"the CUDA segment kernels do not take {spec}: {spec_refusal(spec)}")
    if seg == "deform" and not spec.use_deform:
        raise ValueError("the deform segment needs use_deform")


def pack_segment(spec, seg: str, flat: Sequence[torch.Tensor],
                 like: Sequence[Dict[str, Any]], precision: str) -> Packed:
    """Pack one segment's flat effective weights (``flatten_layers`` order;
    the SDF segment's hidden layers followed by head w, head b, feat w, feat
    b) for the kernels."""
    _check_spec(spec, seg)
    rb = precision == "default"
    flat = [t.detach() for t in flat]
    chunks: List[torch.Tensor] = []
    size = [0]

    def put(t: torch.Tensor) -> int:
        off = size[0]
        chunks.append(t.reshape(-1).to(torch.float32))
        size[0] += t.numel()
        return off

    def rnd(w):
        return w.to(torch.bfloat16).to(torch.float32) if rb else w

    # per layer: its row blocks and bias, from the flat list
    blocks: List[Tuple[List[torch.Tensor], torch.Tensor]] = []
    i = 0
    for lay in like:
        n_rows = int("wh" in lay) + len(lay.get("wsec", [])) + int("w" in lay)
        blocks.append((flat[i:i + n_rows], flat[i + n_rows]))
        i += n_rows + 1
    head_w = None
    if seg == "sdf":
        head_w, head_b, feat_w, feat_b = flat[i:i + 4]
        blocks.append(([torch.cat([head_w, feat_w], dim=1)], torch.cat([head_b, feat_b])))
        i += 4
    n_layers = len(blocks)
    if i != len(flat) or not 2 <= n_layers <= NL:
        raise ValueError(f"the CUDA segment kernels take nets of 2 to {NL} layers, "
                         f"got {n_layers}")
    mask = sum(1 << s for s in getattr(spec, seg).skips)

    layers, ins, outs, w_off, b_off, wt_off, mats = [], [], [], [], [], [], []
    for rows, b in blocks:
        w = rnd(torch.cat(rows, dim=0))
        mats.append(w)
        ins.append(w.shape[0])
        outs.append(w.shape[1])
        w_off.append(put(w))
        b_off.append(put(b))
        wt_off.append(put(w.T.contiguous()))
        layers.append((w_off[-1], b_off[-1], w.shape[0], w.shape[1], [r.shape[0] for r in rows]))
    pad = [0] * (NL - n_layers)            # the meta's layout: NL entries a field
    net_meta = ([n_layers, mask] + ins + pad + outs + pad + w_off + pad + b_off + pad
                + wt_off + [-1] * (NL - n_layers))
    metas = [net_meta if name == seg else [0] * META_NET for name in SEGMENTS]
    head_off = put(head_w[:, 0]) if head_w is not None else 0
    header = [int(spec.use_deform), spec.deform_pos_freqs, spec.deform_time_freqs,
              spec.sdf_pos_freqs, spec.color_pos_freqs, spec.color_dir_freqs,
              spec.color_feat_dim, head_off]
    meta = header + metas[0] + metas[1] + metas[2]
    if rb and seg in TC_SEGMENTS:
        offs = {"w": [], "wt": []}
        for kind in offs:
            for w in mats:
                if size[0] % 4:                  # 16-byte aligned fragments
                    put(torch.zeros(4 - size[0] % 4, device=w.device))
                f = mma_frags((w if kind == "w" else w.T).to(torch.bfloat16))
                offs[kind].append(put(f.view(torch.float32)))
            offs[kind] += [-1] * (NL - n_layers)
        meta += offs["w"] + offs["wt"]
    buf = torch.cat(chunks).contiguous()
    return Packed(seg, buf, (ctypes.c_longlong * len(meta))(*meta), rb, layers, len(flat))


def unpack_grads(packed: Packed, grad: torch.Tensor) -> List[torch.Tensor]:
    """The kernel's packed gradient -> gradients of the flat weights."""
    out: List[torch.Tensor] = []
    for l, (wo, bo, n_in, n_out, rows) in enumerate(packed.layers):
        dw = grad[wo:wo + n_in * n_out].view(n_in, n_out)
        db = grad[bo:bo + n_out]
        if packed.seg == "sdf" and l == len(packed.layers) - 1:
            out += [dw[:, :1], db[:1], dw[:, 1:], db[1:]]
            continue
        out += list(torch.split(dw, rows, dim=0)) + [db]
    assert len(out) == packed.n_flat
    return out


def _arg(t: torch.Tensor, shape, name: str) -> torch.Tensor:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    return t.to(torch.float32).contiguous()


def _run(fn_name: str, packed: Packed, device, *args) -> None:
    from endosurf_tpu_torch.kernels.build import load_library
    lib = load_library()
    if packed.w.device != device:
        raise ValueError(f"weights on {packed.w.device}, points on {device}")
    ptrs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    with torch.cuda.device(device):
        err = getattr(lib, fn_name)(packed.w.data_ptr(), packed.meta, int(packed.rb), *ptrs,
                                    torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} CUDA launch failed: "
                           + lib.fused_render_error_string(err).decode())


WG_KC = 4096          # points per chunk of the weight-gradient sums (csrc/wgrad.cuh)


def tc_scratch_layout(packed: Packed, n: int) -> Tuple[List[Tuple], int]:
    """The bf16-mode backward's scratch as field_tc.cuh's plan_bwd_tc lays
    it out: ([(array, layer, byte offset, shape, dtype)] in planner order,
    bytes used). bf16 where the values are bf16 (operands, the deform and
    colour hidden layers' cotangents, the SDF's adjoint operands), rows
    padded to multiples of 16, each array 256-byte aligned; the deform net's
    arrays hold its 4 streams stacked on the point axis. A net of L layers
    has these for its layers 0 .. L-1."""
    seg = packed.seg
    ins = [lay[2] for lay in packed.layers]
    outs = [lay[3] for lay in packed.layers]
    n_layers = len(packed.layers)
    c16, bf, f32 = _c16, torch.bfloat16, torch.float32
    arrays = []
    for l in range(n_layers):
        if seg != "sdf":
            s = 4 if seg == "deform" else 1
            arrays.append(("xin", l, (s * n, c16(ins[l])), bf))
            arrays.append(("dzb", l, (s * n, c16(outs[l])), bf) if l < n_layers - 1
                          else ("dz", l, (s * n, 4), f32))
        else:
            arrays += [("xin", l, (n, c16(ins[l])), bf), ("dz", l, (n, c16(outs[l])), f32)]
            if l < n_layers - 1:
                arrays += [("z", l, (n, c16(outs[l])), f32), ("ag", l, (n, c16(outs[l])), bf),
                           ("da", l, (n, c16(ins[l])), f32)]
                if l < n_layers - 2:
                    arrays.append(("a", l, (n, c16(outs[l])), f32))
    if seg == "sdf":
        arrays.append(("dhead", n_layers - 1, (n, c16(ins[-1])), f32))
    layout, used = [], 0
    for name, l, shape, dt in arrays:
        used = -(-used // 256) * 256
        layout.append((name, l, used, shape, dt))
        used += shape[0] * shape[1] * (2 if dt == bf else 4)
    return layout, used


def bwd_sizes(packed: Packed, n: int) -> Tuple[int, int]:
    """(scratch floats, partial-sum floats) of a segment's backward at n
    points, as csrc's planners lay them out (``train_bwd_sizes``): in the
    float32 mode (fused_train.cu's plan_bwd) every array float32; in the
    bf16 mode ``tc_scratch_layout``. The partial sums are the same in both:
    chunks x M x N a product."""
    seg = packed.seg
    ins = [lay[2] for lay in packed.layers]
    outs = [lay[3] for lay in packed.layers]
    n_layers = len(packed.layers)
    chunks = lambda k: -(-k // WG_KC)           # noqa: E731
    part = 0
    for l in range(n_layers):
        part += chunks(n) * (ins[l] * outs[l] + outs[l])
        if seg == "deform":
            part += chunks(3 * n) * ins[l] * outs[l]
        elif seg == "sdf":
            part += chunks(n) * ins[l] * (outs[l] if l < n_layers - 1 else 1)
    if not (packed.rb and seg in TC_SEGMENTS):
        streams = 4 if seg == "deform" else 1
        floats = sum(streams * n * (ins[l] + outs[l]) for l in range(n_layers))
        if seg == "sdf":
            floats += (sum(n * (3 * outs[l] + ins[l]) for l in range(n_layers - 1))
                       + n * ins[-1])
        return floats, part
    return -(-tc_scratch_layout(packed, n)[1] // 4), part


def _bwd_buffers(packed: Packed, n: int, device):
    from endosurf_tpu_torch.kernels.build import load_library
    sizes = (ctypes.c_longlong * 2)()
    load_library().train_bwd_sizes(packed.meta, _SEG_ID[packed.seg], int(packed.rb), n, sizes)
    scratch = torch.empty(max(sizes[0], 1), dtype=torch.float32, device=device)
    partial = torch.empty(max(sizes[1], 1), dtype=torch.float32, device=device)
    return scratch, partial, torch.empty_like(packed.w)


def deform_fwd(packed: Packed, xt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """xt [N, 4] -> (x_c [N, 3], jrows [N, 3, 3])."""
    n = xt.shape[0]
    xt = _arg(xt, (n, 4), "xt")
    x_c = torch.empty(n, 3, dtype=torch.float32, device=xt.device)
    jrows = torch.empty(n, 3, 3, dtype=torch.float32, device=xt.device)
    _run("train_deform_fwd", packed, xt.device, n, xt, x_c, jrows)
    LAUNCHES["deform_fwd"] += 1
    return x_c, jrows


def fwd_work_floats(packed: Packed, n: int) -> int:
    """Floats of workspace the SDF forward needs at n points, as csrc's
    planner lays it out (``train_sdf_fwd_work_floats``): in the bf16 mode
    (field_tc.cuh's plan_sdf_fwd_tc) each hidden layer's pre-activations
    [n, c16(out)] in float32, each array 256-byte aligned, which the
    tensor-core forward's adjoint reads back for its gates; none in the
    float32 mode."""
    if not (packed.rb and packed.seg == "sdf"):
        return 0
    used = 0
    for lay in packed.layers[:-1]:
        used = -(-used // 256) * 256 + n * _c16(lay[3]) * 4
    return -(-used // 4)


def sdf_fwd(packed: Packed, x_c: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x_c [N, 3] -> (sdf [N, 1], feat [N, F], grad_c [N, 3])."""
    n = x_c.shape[0]
    x_c = _arg(x_c, (n, 3), "x_c")
    f = packed.layers[-1][3] - 1
    sdf = torch.empty(n, 1, dtype=torch.float32, device=x_c.device)
    feat = torch.empty(n, f, dtype=torch.float32, device=x_c.device)
    grad_c = torch.empty(n, 3, dtype=torch.float32, device=x_c.device)
    work = torch.empty(max(fwd_work_floats(packed, n), 1), dtype=torch.float32,
                       device=x_c.device)
    _run("train_sdf_fwd", packed, x_c.device, n, x_c, sdf, feat, grad_c, work)
    LAUNCHES["sdf_fwd"] += 1
    return sdf, feat, grad_c


def _color_inputs(packed, x_c, grad_c, d_c, feat):
    n = x_c.shape[0]
    f = packed.layers[0][4][-1]          # the first layer's last row block: feat
    return (_arg(x_c, (n, 3), "x_c"), _arg(grad_c, (n, 3), "grad_c"),
            _arg(d_c, (n, 3), "d_c"), _arg(feat, (n, f), "feat"))


def color_fwd(packed: Packed, x_c: torch.Tensor, grad_c: torch.Tensor, d_c: torch.Tensor,
              feat: torch.Tensor) -> Tuple[torch.Tensor]:
    """(x_c, grad_c, d_c [N, 3], feat [N, F]) -> (color [N, 3],)."""
    ins = _color_inputs(packed, x_c, grad_c, d_c, feat)
    color = torch.empty(x_c.shape[0], 3, dtype=torch.float32, device=x_c.device)
    _run("train_color_fwd", packed, x_c.device, x_c.shape[0], *ins, color)
    LAUNCHES["color_fwd"] += 1
    return (color,)


def deform_bwd(packed: Packed, xt: torch.Tensor, g_xc: torch.Tensor, g_j: torch.Tensor
               ) -> Tuple[List[torch.Tensor], Tuple[()]]:
    """Cotangents on x_c [N, 3] and jrows [N, 3, 3] -> (flat weight
    gradients, ()): xt gets no cotangent."""
    n = xt.shape[0]
    args = (_arg(xt, (n, 4), "xt"), _arg(g_xc, (n, 3), "g_xc"), _arg(g_j, (n, 3, 3), "g_j"))
    scratch, partial, grad = _bwd_buffers(packed, n, xt.device)
    _run("train_deform_bwd", packed, xt.device, n, *args, scratch, partial, grad)
    LAUNCHES["deform_bwd"] += 1
    return unpack_grads(packed, grad), ()


def sdf_bwd(packed: Packed, x_c: torch.Tensor, g_sdf: torch.Tensor, g_feat: torch.Tensor,
            g_gc: torch.Tensor) -> Tuple[List[torch.Tensor], Tuple[torch.Tensor]]:
    """Cotangents on sdf [N, 1], feat [N, F], grad_c [N, 3] -> (flat weight
    gradients, (d x_c [N, 3],))."""
    n = x_c.shape[0]
    f = packed.layers[-1][3] - 1
    args = (_arg(x_c, (n, 3), "x_c"), _arg(g_sdf, (n, 1), "g_sdf"),
            _arg(g_feat, (n, f), "g_feat"), _arg(g_gc, (n, 3), "g_gc"))
    d_xc = torch.empty(n, 3, dtype=torch.float32, device=x_c.device)
    scratch, partial, grad = _bwd_buffers(packed, n, x_c.device)
    _run("train_sdf_bwd", packed, x_c.device, n, *args, d_xc, scratch, partial, grad)
    LAUNCHES["sdf_bwd"] += 1
    return unpack_grads(packed, grad), (d_xc,)


def color_bwd(packed: Packed, x_c: torch.Tensor, grad_c: torch.Tensor, d_c: torch.Tensor,
              feat: torch.Tensor, g_color: torch.Tensor
              ) -> Tuple[List[torch.Tensor], Tuple[torch.Tensor, ...]]:
    """Cotangent on color [N, 3] -> (flat weight gradients, (d x_c, d grad_c,
    d d_c, d feat))."""
    n = x_c.shape[0]
    ins = _color_inputs(packed, x_c, grad_c, d_c, feat)
    g = _arg(g_color, (n, 3), "g_color")
    outs = tuple(torch.empty_like(t) for t in ins)
    scratch, partial, grad = _bwd_buffers(packed, n, x_c.device)
    _run("train_color_bwd", packed, x_c.device, n, *ins, g, *outs, scratch, partial, grad)
    LAUNCHES["color_bwd"] += 1
    return unpack_grads(packed, grad), outs


# per segment: forward (packed, *inputs) -> outputs; backward (packed,
# *inputs, *output cotangents) -> (flat weight gradients, input cotangents)
FWD = {"deform": deform_fwd, "sdf": sdf_fwd, "color": color_fwd}
BWD = {"deform": deform_bwd, "sdf": sdf_bwd, "color": color_bwd}


def leaf_names(like: Sequence[Dict[str, Any]], seg: str) -> List[str]:
    """Names of a segment's flat weights, in ``flatten_layers`` order."""
    names = []
    for l, lay in enumerate(like):
        names += [f"{l}.wh"] if "wh" in lay else []
        names += [f"{l}.wsec{k}" for k in range(len(lay.get("wsec", [])))]
        names += [f"{l}.w"] if "w" in lay else []
        names.append(f"{l}.b")
    return names + (["head.w", "head.b", "feat.w", "feat.b"] if seg == "sdf" else [])


def segment_parity(spec, params: Dict[str, Any], x: torch.Tensor, d: torch.Tensor,
                   t: torch.Tensor, precision: str, seed: int = 0,
                   kernel_precision: str = None):
    """Each segment kernel against its plain version on the same inputs (the
    plain chain's own values, so each segment is judged alone): forward
    outputs, and for seeded random cotangents the parameter gradients and
    input cotangents, judged at ``precision``'s PARITY_TOL. With
    ``kernel_precision`` the kernels run at that precision instead (the
    wrong-precision control). Returns ({segment: {"out"|"cot"|"leaf"|"bias":
    parity_errors(...)}}, {kernel name: max absolute error}, {segment:
    (layers, flat weights, packed, inputs, cotangents)}); the max absolute
    error is over a forward's outputs and over a backward's gradients and
    input cotangents. The SDF forward's outputs are judged as kind
    "sdf_out"."""
    from endosurf_tpu_torch.kernels import fused_train as ft
    from endosurf_tpu_torch.kernels.fused_render import precision_dtype
    kp = kernel_precision or precision
    dtype = precision_dtype(precision)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    with torch.no_grad():
        eff = ft.prepare_effective(spec, params)
    res, abs_err, cases = {}, {}, {}

    def max_abs(got, ref):
        return max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))

    def judge(seg, out_names, inputs):
        like, flat = ft.segment_weights(eff, seg)
        packed = pack_segment(spec, seg, flat, like, kp)
        got = FWD[seg](packed, *inputs)
        with torch.no_grad():
            ref = ft.seg_math(spec, seg, like, flat, inputs, precision)
        cots = tuple(torch.randn(*r.shape, generator=gen, device=x.device) for r in ref)
        leaves, d_in = BWD[seg](packed, *inputs, *cots)
        ref_leaves, ref_in = ft.plain_bwd(spec, seg, like, flat, inputs, cots, precision)
        names = leaf_names(like, seg)
        abs_err[f"{seg}_fwd"] = max_abs(got, ref)
        abs_err[f"{seg}_bwd"] = max_abs([*leaves, *d_in], [*ref_leaves, *ref_in])
        bias = [names.index(k) for k in out_biases(seg, len(packed.layers))]
        out = "sdf_out" if seg == "sdf" else "out"
        res[seg] = {out: parity_errors(dict(zip(out_names, got)), dict(zip(out_names, ref)),
                                       dtype, out),
                    "leaf": parity_errors(dict(zip(names, leaves)),
                                          dict(zip(names, ref_leaves)), dtype, "leaf"),
                    "bias": parity_errors({names[i]: leaves[i] for i in bias},
                                          {names[i]: ref_leaves[i] for i in bias}, dtype, "bias")}
        if ref_in:
            in_names = ft.SEGMENT_INPUTS[seg]
            res[seg]["cot"] = parity_errors(dict(zip(in_names, d_in)),
                                            dict(zip(in_names, ref_in)), dtype, "cot")
        cases[seg] = (like, flat, packed, inputs, cots)
        return ref

    if spec.use_deform:
        x_c, jrows = judge("deform", ("x_c", "jrows"), (torch.cat([x, t], dim=-1).contiguous(),))
    else:
        x_c, jrows = x, ft._static_jrows(x)
    _, feat, grad_c = judge("sdf", ("sdf", "feat", "grad_c"), (x_c,))
    _, d_c = ft.coupling_math(jrows, grad_c, d)
    judge("color", ("color",), (x_c, grad_c, d_c, feat))
    return res, abs_err, cases


def parity_ok(res: Dict[str, Dict[str, Dict]]) -> bool:
    """Every reading of ``segment_parity`` within its limits."""
    return all(v[-1] for seg in res.values() for kind in seg.values() for v in kind.values())
