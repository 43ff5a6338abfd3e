"""Ray geometry (port of ``endosurf_tpu/ops/geometry.py``).

A ray is 9 floats [o_x, o_y, o_z, d_x, d_y, d_z, near, far, t] with d unit
length. The 3x3 products are written as elementwise sums so they stay exact
float32 whatever the TF32 settings.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rays_from_pixels(px: torch.Tensor, py: torch.Tensor,
                     intrinsic_inv: torch.Tensor, pose: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-space (rays_o, unit rays_d) [..., 3] for pixel coordinates."""
    p = torch.stack([px, py, torch.ones_like(px)], dim=-1)
    d_cam = (intrinsic_inv * p[..., None, :]).sum(-1)
    d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    rays_d = (pose[:3, :3] * d_cam[..., None, :]).sum(-1)
    rays_o = pose[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def ray_sphere_intersection(rays_o: torch.Tensor, rays_d: torch.Tensor,
                            radius: float = 1.0
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(near, far, hit) [..., 1] of rays with an origin-centred sphere.

    ``near`` clamps at 0; directions need not be unit length.
    """
    d_dot_d = (rays_d * rays_d).sum(-1)
    mid = -(rays_d * rays_o).sum(-1) / d_dot_d
    p = rays_o + mid[..., None] * rays_d
    tmp = radius * radius - (p * p).sum(-1)
    hit = tmp > 0.0
    half_chord = torch.sqrt(torch.clamp(tmp, min=0.0)) / torch.sqrt(d_dot_d)
    near = torch.clamp(mid - half_chord, min=0.0)
    far = mid + half_chord
    return near[..., None], far[..., None], hit[..., None]
