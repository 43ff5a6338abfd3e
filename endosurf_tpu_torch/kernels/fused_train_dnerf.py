"""The D-NeRF field chain as three segments: the plain math, the CUDA forward
kernels and the forward-only ``megakernel_field_raw``.

Port of the serving half of ``endosurf_tpu/kernels/fused_train_dnerf.py``:

    x_c          = seg_deform_math(eff_d, xt)                   warp
    (raw, feat)  = seg_density_math(eff_s, head, featw, x_c)    raw sigma, feature
    rgb          = seg_color_math(eff_c, d, feat)               sigmoid inside

``prepare_effective_dnerf`` splits the plain ``{w, b}`` layers: skip layers
into an h block and an encoding block (the nerf-style skip input is [h,
enc]), the density net's 1 + F output layer into ``sigma_head`` [H, 1] and
``geo_feat`` [H, F]. ``forward_math`` composes the segments (the render
kernel's fine evaluation and its plain twin). Under ``"default"`` the
coordinates are rounded to bf16 before they are encoded, as the TPU kernels'
selector dots round them. The JAX module's 128-lane padding and selector
matmuls are layout and are dropped.

On the card (``csrc/fused_train_dnerf.cu`` over ``csrc/dnerf_chain.cuh``):
``dnerf_deform_fwd`` / ``dnerf_density_fwd`` / ``dnerf_color_fwd``, each
counted in ``LAUNCHES``, on weights packed by ``pack_dnerf`` (the one
layout every D-NeRF kernel reads: ``fused_density_raw`` and the render
kernel too). ``megakernel_field_raw`` chains them under no_grad; the
backward halves come with the EndoNeRF train step, so a gradient through
the field on CUDA tensors raises.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Sequence, Tuple

import torch

from endosurf_tpu_torch.kernels.fused_render import HMAX, NL, pack_nets
from endosurf_tpu_torch.kernels.fused_train import _build, _mlp_fwd
from endosurf_tpu_torch.ops.encoding import freq_encode, freq_encode_dim
from endosurf_tpu_torch.ops.mlp import dot, operand

SEGMENTS = ("deform", "density", "color")

# Launches of the forward segment kernels (one per call).
LAUNCHES = {f"dnerf_{s}_fwd": 0 for s in SEGMENTS}

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


class DnPacked:
    """The D-NeRF nets packed for the kernels: ``w`` (float32, on the
    device), ``meta`` (ctypes int64 array, ``csrc/sdf_chain.cuh``'s Model
    layout with the density net in the SDF slot) and ``rb`` (bf16
    operands)."""

    def __init__(self, w: torch.Tensor, meta: List[int], rb: bool):
        self.w, self.rb = w, rb
        self.meta = (ctypes.c_longlong * len(meta))(*meta)


def pack_dnerf(spec, params: Dict[str, Any], dtype: torch.dtype) -> DnPacked:
    """All three nets of ``params`` (the density output layer whole, [H, 1 +
    F]) in one buffer, bf16-rounded weights for ``dtype`` bf16 (biases not)."""
    if not cuda_dnerf_supported(spec):
        raise ValueError(f"the CUDA D-NeRF kernels do not take {spec}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {dtype}")
    with torch.no_grad():
        chunks, metas, _ = pack_nets(
            [(params["deform"]["layers"] if spec.use_deform else None, spec.deform_layers[2],
              False),
             (params["density"]["layers"], spec.density_layers[2], False),
             (params["color"]["layers"], spec.color_layers[2], False)], dtype)
        w = torch.cat(chunks).contiguous()
    header = [int(spec.use_deform), spec.pos_deform_freqs, spec.time_deform_freqs,
              spec.pos_density_freqs, 0, spec.dir_color_freqs, spec.geo_feat_dim, 0]
    return DnPacked(w, header + metas, dtype == torch.bfloat16)


def _arg(t: torch.Tensor, shape, name: str) -> torch.Tensor:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    return t.detach().to(torch.float32).contiguous()


def _run(name: str, packed: DnPacked, n: int, *tensors: torch.Tensor) -> None:
    from endosurf_tpu_torch.kernels.build import load_library
    lib = load_library()
    device = tensors[0].device
    if packed.w.device != device:
        raise ValueError(f"weights on {packed.w.device}, points on {device}")
    with torch.cuda.device(device):
        err = getattr(lib, name)(packed.w.data_ptr(), packed.meta, int(packed.rb), n,
                                 *(t.data_ptr() for t in tensors),
                                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} CUDA launch failed: "
                           + lib.fused_render_error_string(err).decode())
    LAUNCHES[name] += 1


def dnerf_deform_fwd(packed: DnPacked, xt: torch.Tensor) -> torch.Tensor:
    """xt [N, 4] (x, t) -> x_c [N, 3]."""
    n = xt.shape[0]
    xt = _arg(xt, (n, 4), "xt")
    x_c = torch.empty(n, 3, dtype=torch.float32, device=xt.device)
    _run("dnerf_deform_fwd", packed, n, xt, x_c)
    return x_c


def dnerf_density_fwd(packed: DnPacked, x_c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_c [N, 3] -> (raw sigma [N, 1], feat [N, F])."""
    n = x_c.shape[0]
    x_c = _arg(x_c, (n, 3), "x_c")
    f = packed.meta[6]
    raw = torch.empty(n, 1, dtype=torch.float32, device=x_c.device)
    feat = torch.empty(n, f, dtype=torch.float32, device=x_c.device)
    _run("dnerf_density_fwd", packed, n, x_c, raw, feat)
    return raw, feat


def dnerf_color_fwd(packed: DnPacked, d: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """(d [N, 3], feat [N, F]) -> rgb [N, 3]."""
    n = d.shape[0]
    d = _arg(d, (n, 3), "d")
    feat = _arg(feat, (n, packed.meta[6]), "feat")
    rgb = torch.empty(n, 3, dtype=torch.float32, device=d.device)
    _run("dnerf_color_fwd", packed, n, d, feat, rgb)
    return rgb


# the forward kernels by LAUNCHES name: (packed, *inputs) -> outputs
FWD = {"dnerf_deform_fwd": dnerf_deform_fwd, "dnerf_density_fwd": dnerf_density_fwd,
       "dnerf_color_fwd": dnerf_color_fwd}


def _needs_grad(params: Dict[str, Any], *data: torch.Tensor) -> bool:
    from endosurf_tpu_torch.bridge import flatten
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in (*flatten(params).values(), *data) if torch.is_tensor(t))


def megakernel_field_raw(spec, params: Dict[str, Any], x: torch.Tensor, d: torch.Tensor,
                         t: torch.Tensor, precision: str = "highest"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The D-NeRF field as its three segments: x, d [N, 3], t [N, 1] ->
    (rgb [N, 3] after the sigmoid, raw sigma [N] before noise and relu).
    CUDA tensors run the forward kernels (a gradient through them raises:
    EndoNeRF training is not ported); CPU tensors run ``forward_math``."""
    if x.device.type == "cuda":
        if _needs_grad(params, x, d, t):
            raise NotImplementedError("EndoNeRF training is not ported yet: the D-NeRF "
                                      "segment kernels are forward only")
        from endosurf_tpu_torch.kernels.fused_render import precision_dtype
        packed = pack_dnerf(spec, params, precision_dtype(precision))
        x_c = dnerf_deform_fwd(packed, torch.cat([x, t], dim=-1)) if spec.use_deform else x
        raw, feat = dnerf_density_fwd(packed, x_c)
        return dnerf_color_fwd(packed, d, feat), raw[:, 0]
    if x.device.type != "cpu":
        raise ValueError(f"no D-NeRF field segments for device {x.device}")
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


def segment_parity(spec, params: Dict[str, Any], x: torch.Tensor, d: torch.Tensor,
                   t: torch.Tensor, precision: str, kernel_precision: str = None
                   ) -> Tuple[Dict[str, Dict], Dict[str, float], Dict[str, Sequence]]:
    """Each forward kernel against its plain version on the same inputs (the
    plain chain's own values, so each segment is judged alone), at
    ``precision``'s limits; with ``kernel_precision`` the kernels run at that
    precision instead (the wrong-precision control). Returns ({segment:
    parity_errors}, {kernel name: max absolute error}, {kernel name: (packed,
    inputs)} for timing)."""
    from endosurf_tpu_torch.kernels.fused_render import precision_dtype
    dtype = precision_dtype(precision)
    packed = pack_dnerf(spec, params, precision_dtype(kernel_precision or precision))
    with torch.no_grad():
        eff = prepare_effective_dnerf(spec, params)
        xt = torch.cat([x, t], dim=-1).contiguous()
        x_c = seg_deform_math(spec, eff["deform"], xt, precision) if spec.use_deform else x
        raw, feat = seg_density_math(spec, eff["density"], eff["sigma_head"], eff["geo_feat"],
                                     x_c, precision)
        rgb = seg_color_math(spec, eff["color"], d, feat, precision)
    runs = {"dnerf_density_fwd": ((x_c,), {"raw_sigma": raw, "feat": feat}),
            "dnerf_color_fwd": ((d, feat), {"rgb": rgb})}
    if spec.use_deform:
        runs = {"dnerf_deform_fwd": ((xt,), {"x_c": x_c}), **runs}
    res, abs_err, cases = {}, {}, {}
    for name, (inputs, ref) in runs.items():
        out = FWD[name](packed, *inputs)
        got = dict(zip(ref, out if isinstance(out, tuple) else (out,)))
        res[name] = parity_errors(got, ref, dtype)
        abs_err[name] = max(float((got[k] - ref[k]).abs().max()) for k in ref)
        cases[name] = (packed, inputs)
    return res, abs_err, cases
