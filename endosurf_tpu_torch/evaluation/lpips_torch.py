"""LPIPS (VGG16) perceptual metric in PyTorch (port of
``endosurf_tpu/evaluation/lpips_jax.py``).

Inputs in [0, 1] are scaled to [-1, 1] and shifted / scaled per channel,
run through the VGG16 conv stack with taps after relu1_2 / 2_2 / 3_3 / 4_3
/ 5_3, unit-normalised over channels, weighted by the non-negative 1x1
heads, averaged over space and summed over the five layers.

The weights are an npz in the schema ``tools/convert_lpips_weights.py``
writes from the public ``lpips`` package's VGG weights (HWIO convs
``conv{i}_w`` / ``conv{i}_b``, heads ``lin{i}_w``); none is downloaded. The
default file is ``endosurf_tpu_torch/weights/lpips_vgg16.npz`` (or
``$ESN_LPIPS_WEIGHTS``): an absent file gives ``None``, so callers report no
LPIPS; a present file that fails ``validate_weights`` raises. The
convolutions are ``F.conv2d`` (JAX computes them with ``lax.conv``, outside
any Pallas kernel) on the device of the inputs, with TF32 off.
"""

from __future__ import annotations

import functools
import os
import os.path as osp
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

WEIGHTS_PATH = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "weights",
                        "lpips_vgg16.npz")

# VGG16 conv layout: (out_channels, n_convs) per block
_VGG_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def validate_weights(raw) -> None:
    """Raise ValueError unless ``raw`` is a weights map of the schema: 13
    convs conv{i}_w / _b in the 2-2-3-3-3 block grouping, HWIO 3x3 kernels
    chaining from 3 input channels, and 5 heads lin{i}_w, one per block tap,
    each [C_block] and non-negative. The channel widths are read from the
    arrays, so narrow test weights pass too."""
    n_convs_total = sum(n for _, n in _VGG_BLOCKS)
    expected = {f"conv{i}_{s}" for i in range(n_convs_total) for s in ("w", "b")}
    expected |= {f"lin{i}_w" for i in range(len(_VGG_BLOCKS))}
    missing, extra = sorted(expected - set(raw)), sorted(set(raw) - expected)
    if missing or extra:
        raise ValueError(f"lpips weights schema mismatch: missing={missing} extra={extra}")
    idx, c_in = 0, 3
    for bi, (_, n_convs) in enumerate(_VGG_BLOCKS):
        for _ in range(n_convs):
            w, b = raw[f"conv{idx}_w"], raw[f"conv{idx}_b"]
            if w.ndim != 4 or w.shape[:3] != (3, 3, c_in):
                raise ValueError(
                    f"lpips weights: conv{idx}_w has shape {tuple(w.shape)}, expected "
                    f"(3, 3, {c_in}, C_out) -- convs must be HWIO "
                    "(see tools/convert_lpips_weights.py)")
            if b.shape != (w.shape[3],):
                raise ValueError(f"lpips weights: conv{idx}_b shape {tuple(b.shape)} does not "
                                 f"match conv{idx}_w out-channels {w.shape[3]}")
            c_in = w.shape[3]
            idx += 1
        lin = np.asarray(raw[f"lin{bi}_w"])
        if lin.shape != (c_in,):
            raise ValueError(f"lpips weights: lin{bi}_w shape {lin.shape} does not match "
                             f"block-{bi} tap width ({c_in},)")
        if lin.min() < 0:
            raise ValueError(f"lpips weights: lin{bi}_w has negative entries; lpips linear "
                             "heads are non-negative -- wrong tensor extracted?")


class LPIPS:
    """lpips(a, b) over [B, H, W, 3] images in [0, 1] -> [B], on the device of
    ``a``; the weights (OIHW, float32) are copied there once per device."""

    def __init__(self, raw: Dict[str, np.ndarray]):
        validate_weights(raw)
        self._host = {k: torch.from_numpy(np.ascontiguousarray(
            np.transpose(v, (3, 2, 0, 1)) if k.endswith("_w") and v.ndim == 4 else v,
            np.float32)) for k, v in raw.items()}
        self._on: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def weights(self, device: torch.device) -> Dict[str, torch.Tensor]:
        if device not in self._on:
            self._on[device] = {k: v.to(device) for k, v in self._host.items()}
        return self._on[device]

    def _features(self, w: Dict[str, torch.Tensor], x: torch.Tensor) -> List[torch.Tensor]:
        feats, idx = [], 0
        for bi, (_, n_convs) in enumerate(_VGG_BLOCKS):
            for _ in range(n_convs):
                x = F.relu(F.conv2d(x, w[f"conv{idx}_w"], w[f"conv{idx}_b"], padding=1))
                idx += 1
            feats.append(x)
            if bi != len(_VGG_BLOCKS) - 1:
                x = F.max_pool2d(x, 2)
        return feats

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        device = a.device
        w = self.weights(device)
        shift = torch.tensor(_SHIFT, device=device).view(1, 3, 1, 1)
        scale = torch.tensor(_SCALE, device=device).view(1, 3, 1, 1)

        def prep(img):
            x = torch.as_tensor(img, dtype=torch.float32, device=device).permute(0, 3, 1, 2)
            return (x * 2.0 - 1.0 - shift) / scale

        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                total = torch.zeros(a.shape[0], device=device)
                for li, (xa, xb) in enumerate(zip(self._features(w, prep(a)),
                                                  self._features(w, prep(b)))):
                    na = xa / (torch.sqrt((xa ** 2).sum(1, keepdim=True)) + 1e-10)
                    nb = xb / (torch.sqrt((xb ** 2).sum(1, keepdim=True)) + 1e-10)
                    diff = ((na - nb) ** 2 * w[f"lin{li}_w"].view(1, -1, 1, 1)).sum(1)
                    total = total + diff.mean(dim=(1, 2))
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        return total


def lpips_fn(path: Optional[str] = None) -> Optional[Callable]:
    """An ``LPIPS`` for the weights at ``path`` (default ``$ESN_LPIPS_WEIGHTS``
    or ``WEIGHTS_PATH``, resolved at every call), or None when that file is
    absent. A present file that fails ``validate_weights`` raises."""
    if path is None:
        path = os.environ.get("ESN_LPIPS_WEIGHTS") or WEIGHTS_PATH
    if not osp.exists(path):
        return None
    return _build_lpips(path)


@functools.lru_cache(maxsize=2)
def _build_lpips(path: str) -> LPIPS:
    with np.load(path) as raw:
        return LPIPS({k: raw[k] for k in raw.files})


lpips_fn.cache_clear = _build_lpips.cache_clear
