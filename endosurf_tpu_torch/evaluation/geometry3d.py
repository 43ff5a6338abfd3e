"""3D geometry extraction and metrics (port of
``endosurf_tpu/evaluation/geometry3d.py``).

* ``eval_field_grid``: the scalar field on a dense grid, one fixed-shape
  [block, res, res] slab a call, each slab built on the field's device (only
  the scalar field comes back to the host);
* ``extract_mesh``: marching tetrahedra and mesh cleaning (``native``, host
  C++) in world coordinates;
* ``rgbd_to_pointcloud`` and ``geometric_error``: the ground-truth point
  cloud and the one-sided KD-tree distance to the mesh vertices, in mm;
* ``colored_meshes``: vertex colours from the radiance field in 65,536-point
  chunks, and normal colours.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch

from endosurf_tpu_torch.native import (
    clean_mesh,
    marching_tetrahedra,
    point_cloud_distance,
    vertex_normals,
)


def grid_axes(bound_min, bound_max, resolution: int):
    """The grid's coordinates along each axis (float32 linspace)."""
    return [np.linspace(bound_min[i], bound_max[i], resolution, dtype=np.float32)
            for i in range(3)]


def grid_slab(lin, x0: int, n_block: int, device: Union[str, torch.device]) -> torch.Tensor:
    """Points [n_block * res * res, 3] of the x-planes x0 .. x0 + n_block - 1
    (the last plane repeated past the grid's end), x slowest, built on
    ``device``."""
    xs = lin[0][x0:x0 + n_block]
    xs = np.pad(xs, (0, n_block - len(xs)), mode="edge")
    ax = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (xs, lin[1], lin[2])]
    shape = (len(ax[0]), len(ax[1]), len(ax[2]))
    return torch.stack([ax[0][:, None, None].expand(shape), ax[1][None, :, None].expand(shape),
                        ax[2][None, None, :].expand(shape)], -1).reshape(-1, 3)


def eval_field_grid(field_fn: Callable, t: float, bound_min: np.ndarray,
                    bound_max: np.ndarray, resolution: int, block: int = 64,
                    device: Union[str, torch.device] = "cpu") -> np.ndarray:
    """``field_fn(pts [N, 3], t [N, 1]) -> [N, 1]`` on a dense grid
    [res, res, res] (x, y, z index order), in [block, res, res] slabs of one
    shape (the last slab padded)."""
    lin = grid_axes(bound_min, bound_max, resolution)
    out = np.empty((resolution,) * 3, np.float32)
    n_block = min(block, resolution)
    t_full = torch.full((n_block * resolution * resolution, 1), float(t), dtype=torch.float32,
                        device=device)
    for x0 in range(0, resolution, n_block):
        n = min(n_block, resolution - x0)
        val = field_fn(grid_slab(lin, x0, n_block, device), t_full)
        out[x0:x0 + n] = val.reshape(n_block, resolution, resolution)[:n].cpu().numpy()
    return out


def extract_mesh(field_fn: Callable, t: float, bound_min, bound_max,
                 resolution: int = 128, threshold: float = 0.0, keep_ratio: float = 0.9,
                 block: int = 64, device: Union[str, torch.device] = "cpu"
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Dense field eval -> isosurface -> cleaned mesh in world coordinates."""
    bound_min = np.asarray(bound_min, np.float32)
    bound_max = np.asarray(bound_max, np.float32)
    grid = eval_field_grid(field_fn, t, bound_min, bound_max, resolution, block, device)
    verts, tris = marching_tetrahedra(grid, threshold)
    if len(verts) == 0:
        return verts, tris
    verts = (verts / (resolution - 1.0) * (bound_max - bound_min)[None, :]
             + bound_min[None, :])
    return clean_mesh(verts, tris, keep_ratio)


def rgbd_to_pointcloud(rgb: np.ndarray, depth: np.ndarray, K: np.ndarray,
                       c2w: np.ndarray, depth_trunc: float
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Unproject an RGBD frame to a world-space coloured point cloud.

    Returns (points [N, 3], colours [N, 3] in [0, 1]) for the valid depth
    pixels (0 < depth < depth_trunc)."""
    depth = np.asarray(depth)
    if depth.ndim == 3:
        depth = depth[..., 0]
    valid = (depth > 0) & (depth < depth_trunc)
    ys, xs = np.nonzero(valid)
    z = depth[ys, xs]
    K = np.asarray(K)
    x_cam = (xs - K[0, 2]) / K[0, 0] * z
    y_cam = (ys - K[1, 2]) / K[1, 1] * z
    pts_cam = np.stack([x_cam, y_cam, z], -1)
    R, t = np.asarray(c2w)[:3, :3], np.asarray(c2w)[:3, 3]
    pts = pts_cam @ R.T + t
    colors = np.asarray(rgb)[ys, xs][:, :3]
    if colors.dtype == np.uint8:
        colors = colors.astype(np.float32) / 255.0
    return pts.astype(np.float32), colors.astype(np.float32)


def geometric_error(gt_points: np.ndarray, mesh_verts: np.ndarray,
                    depth_scale: float = 1.0) -> float:
    """Mean one-sided distance ground-truth points -> mesh vertices, scaled
    to mm (inf for an empty side)."""
    if len(mesh_verts) == 0 or len(gt_points) == 0:
        return float("inf")
    d = point_cloud_distance(gt_points, mesh_verts)
    return float(d.mean() * depth_scale)


def colored_meshes(render_pts_fn: Callable, verts: np.ndarray, tris: np.ndarray,
                   view_point: np.ndarray, t: float, chunk: int = 65536
                   ) -> Dict[str, np.ndarray]:
    """Vertex colours from the radiance field and a normal colour map.

    ``render_pts_fn(pts [N, 3], dirs [N, 3], t [N, 1]) -> colours [N, 3]``
    (numpy in, numpy out) sees ``chunk`` points a call, the last chunk padded
    with the last vertex."""
    dirs = verts - view_point[None, :]
    dirs = dirs / (np.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-10)
    colors = np.empty((len(verts), 3), np.float32)
    n = len(verts)
    n_pad = (-n) % chunk if n > chunk else chunk - n
    v_p = np.concatenate([verts, np.repeat(verts[-1:], n_pad, 0)], 0)
    d_p = np.concatenate([dirs, np.repeat(dirs[-1:], n_pad, 0)], 0)
    t_arr = np.full((chunk, 1), t, np.float32)
    for i in range(0, len(v_p), chunk):
        c = np.asarray(render_pts_fn(v_p[i:i + chunk], d_p[i:i + chunk], t_arr))
        end = min(i + chunk, n)
        if end > i:
            colors[i:end] = c[: end - i]
    normals = vertex_normals(verts, tris)
    normal_colors = np.clip(-normals * 0.5 + 0.5, 0, 1)
    return {"color": np.clip(colors, 0, 1), "normal_color": normal_colors,
            "normals": normals}
