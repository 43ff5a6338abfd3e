"""Masked image metrics: PSNR / RMSE / SSIM / LPIPS (port of
``endosurf_tpu/evaluation/metrics.py``).

PSNR and RMSE normalise by the mask sum; SSIM is the 11x11, sigma 1.5
Gaussian-window variant on mask-multiplied images with valid convolution;
LPIPS (``lpips_torch``) runs on mask-multiplied images when the converted
VGG weights are present, and ``cal_lpips`` returns None without them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def cal_psnr(a, b, mask) -> float:
    a, b, mask = _np(a), _np(b), _np(mask)
    if mask.ndim == a.ndim - 1:
        mask = mask[..., None]
    mask_sum = mask.sum() + 1e-10
    mse = ((a - b) ** 2 * mask).sum() / (mask_sum * 3.0)
    return float(20.0 * np.log10(1.0 / np.sqrt(mse)))


def cal_rmse(a, b, mask) -> float:
    a, b, mask = _np(a), _np(b), _np(mask)
    if mask.ndim == a.ndim - 1:
        mask = mask[..., None]
    mask_sum = mask.sum() + 1e-10
    return float((((a - b) ** 2 * mask).sum() / mask_sum) ** 0.5)


def _gaussian_window(w_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(w_size) - w_size // 2) ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def cal_ssim(a, b, mask) -> float:
    """Masked windowed SSIM on [B, H, W, C] images (computed on the CPU in
    float32)."""
    a = torch.as_tensor(_np(a), dtype=torch.float32)
    b = torch.as_tensor(_np(b), dtype=torch.float32)
    m = torch.as_tensor(_np(mask), dtype=torch.float32)
    if m.ndim == a.ndim - 1:
        m = m[..., None]
    a = (a * m).permute(0, 3, 1, 2)
    b = (b * m).permute(0, 3, 1, 2)
    c = a.shape[1]
    kern = torch.as_tensor(_gaussian_window())[None, None].expand(c, 1, 11, 11)

    def conv(x):
        return F.conv2d(x, kern, groups=c)

    mu1, mu2 = conv(a), conv(b)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = conv(a * a) - mu1_sq
    sigma2_sq = conv(b * b) - mu2_sq
    sigma12 = conv(a * b) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    v1 = 2.0 * sigma12 + C2
    v2 = sigma1_sq + sigma2_sq + C2
    ssim_map = ((2 * mu1_mu2 + C1) * v1) / ((mu1_sq + mu2_sq + C1) * v2)
    return float(ssim_map.mean())


def cal_lpips(a, b, mask, batch: int = 2, device=None) -> Optional[float]:
    """Masked LPIPS (VGG16, ``lpips_torch``) of [B, H, W, 3] images: both
    images times the mask, ``batch`` images a call, the mean of the calls'
    means. Runs on ``device`` (default: ``a``'s device for a tensor, else
    the CPU). None when the weights file is absent."""
    from endosurf_tpu_torch.evaluation.lpips_torch import lpips_fn
    fn = lpips_fn()
    if fn is None:
        return None
    if device is None:
        device = a.device if torch.is_tensor(a) else torch.device("cpu")
    a, b, mask = _np(a), _np(b), _np(mask)
    if mask.ndim == a.ndim - 1:
        mask = mask[..., None]
    a = torch.as_tensor(a * mask, dtype=torch.float32, device=device)
    b = torch.as_tensor(b * mask, dtype=torch.float32, device=device)
    vals = [float(fn(a[i:i + batch], b[i:i + batch]).mean())
            for i in range(0, a.shape[0], batch)]
    return float(np.mean(vals))
