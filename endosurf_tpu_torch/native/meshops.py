"""NumPy-facing wrappers over the native geometry library (host C++)."""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from endosurf_tpu_torch.native.build import load_library


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _collect(lib, handle) -> Tuple[np.ndarray, np.ndarray]:
    n_v = lib.esn_result_n_verts(handle)
    n_t = lib.esn_result_n_tris(handle)
    verts = np.empty((n_v, 3), np.float32)
    tris = np.empty((n_t, 3), np.int32)
    if n_v:
        lib.esn_result_copy(handle, _f32p(verts), _i32p(tris))
    lib.esn_result_free(handle)
    return verts, tris


def marching_tetrahedra(grid: np.ndarray, threshold: float = 0.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the ``grid == threshold`` isosurface.

    Args:
      grid: [nx, ny, nz] float values (SDF convention: negative inside).
      threshold: iso level.

    Returns:
      (verts [N,3] float32 in grid-index coordinates, tris [M,3] int32).
      Rescale vertices with ``verts/(res-1)*(bmax-bmin)+bmin`` like the
      reference (renderer/utils.py:133-136).
    """
    lib = load_library()
    grid = np.ascontiguousarray(grid, np.float32)
    handle = lib.esn_marching_tetrahedra(
        _f32p(grid), grid.shape[0], grid.shape[1], grid.shape[2],
        float(threshold))
    return _collect(lib, handle)


def clean_mesh(verts: np.ndarray, tris: np.ndarray,
               keep_ratio: float = 0.9) -> Tuple[np.ndarray, np.ndarray]:
    """Remove degenerate/duplicate triangles and small connected components
    (reference trainer_endosurf.py:437-446 semantics)."""
    lib = load_library()
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    handle = lib.esn_clean_mesh(_f32p(verts), len(verts), _i32p(tris),
                                len(tris), float(keep_ratio))
    return _collect(lib, handle)


def laplacian_smooth(verts: np.ndarray, tris: np.ndarray,
                     iterations: int = 1, lam: float = 0.5) -> np.ndarray:
    """Umbrella-operator smoothing (Open3D filter_smooth_simple equivalent,
    reference trainer_endonerf.py:386-387)."""
    lib = load_library()
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    out = np.empty_like(verts)
    lib.esn_laplacian_smooth(_f32p(verts), len(verts), _i32p(tris), len(tris),
                             int(iterations), float(lam), _f32p(out))
    return out


def vertex_normals(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals."""
    lib = load_library()
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    out = np.empty_like(verts)
    lib.esn_vertex_normals(_f32p(verts), len(verts), _i32p(tris), len(tris),
                           _f32p(out))
    return out


def point_cloud_distance(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """One-sided nearest-neighbor distances src -> dst (Open3D
    compute_point_cloud_distance equivalent; reference geometric error at
    trainer_endosurf.py:472)."""
    lib = load_library()
    src = np.ascontiguousarray(src, np.float32)
    dst = np.ascontiguousarray(dst, np.float32)
    out = np.empty(len(src), np.float32)
    lib.esn_point_cloud_distance(_f32p(src), len(src), _f32p(dst), len(dst),
                                 _f32p(out))
    return out


def rasterize_mesh(verts_screen: np.ndarray, colors: np.ndarray,
                   tris: np.ndarray, width: int, height: int,
                   background: float = 1.0) -> np.ndarray:
    """Z-buffer rasterize a mesh given screen-space vertices.

    Args:
      verts_screen: [N,3] (x_pixel, y_pixel, depth>0).
      colors: [N,3] in [0,1].
      tris: [M,3] int.

    Returns: [height, width, 3] float image (background where no triangle).
    """
    lib = load_library()
    verts_screen = np.ascontiguousarray(verts_screen, np.float32)
    colors = np.ascontiguousarray(colors, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    rgb = np.full((height, width, 3), background, np.float32)
    zbuf = np.full((height, width), np.inf, np.float32)
    lib.esn_rasterize_mesh(_f32p(verts_screen), len(verts_screen),
                           _f32p(colors), _i32p(tris), len(tris),
                           int(width), int(height), _f32p(rgb), _f32p(zbuf))
    return rgb


def nn_distance_excl_self(pts: np.ndarray) -> np.ndarray:
    """Distance from each point to its nearest other point (Open3D
    compute_nearest_neighbor_distance equivalent)."""
    lib = load_library()
    pts = np.ascontiguousarray(pts, np.float32)
    out = np.empty(len(pts), np.float32)
    lib.esn_nn_distance_excl_self(_f32p(pts), len(pts), _f32p(out))
    return out


def radius_outlier_mask(pts: np.ndarray, min_neighbors: int,
                        radius: float) -> np.ndarray:
    """Keep-mask [N] bool of radius outlier removal: a point stays when at
    least ``min_neighbors`` other points lie within ``radius`` (Open3D
    remove_radius_outlier equivalent; used by the preprocessing)."""
    lib = load_library()
    pts = np.ascontiguousarray(pts, np.float32)
    out = np.empty(len(pts), np.uint8)
    lib.esn_radius_outlier_mask(_f32p(pts), len(pts), int(min_neighbors), float(radius),
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)


def alias_table(weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Walker/Vose alias table(s) of non-negative ``weights`` [n] or [..., n]
    (accumulated in double): (prob float32, alias int32) of the same shape,
    for ``ops.pdf.sample_from_alias``. All-zero weights give the uniform
    table."""
    lib = load_library()
    w = np.ascontiguousarray(weights, np.float32)
    flat = w.reshape(-1, w.shape[-1])
    prob = np.empty_like(flat)
    alias = np.empty(flat.shape, np.int32)
    for i in range(flat.shape[0]):
        lib.esn_alias_table(_f32p(flat[i]), flat.shape[-1], _f32p(prob[i]), _i32p(alias[i]))
    return prob.reshape(w.shape), alias.reshape(w.shape)
