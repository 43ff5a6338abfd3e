"""Minimal binary PLY writer/reader (replaces Open3D mesh/pcd IO).

Writes binary-little-endian PLY with optional per-vertex colors and faces;
reads back the same subset (enough for round-tripping our own outputs and for
standard viewers like MeshLab to open them).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def write_ply(path: str, verts: np.ndarray,
              tris: Optional[np.ndarray] = None,
              colors: Optional[np.ndarray] = None) -> None:
    verts = np.asarray(verts, np.float32)
    n_v = len(verts)
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
    n_f = 0 if tris is None else len(tris)

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n_v}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    if n_f:
        header += [f"element face {n_f}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if has_color:
            rec = np.zeros(n_v, dtype=[("xyz", np.float32, 3),
                                       ("rgb", np.uint8, 3)])
            rec["xyz"] = verts
            rec["rgb"] = colors
            f.write(rec.tobytes())
        else:
            f.write(verts.tobytes())
        if n_f:
            tris = np.asarray(tris, np.int32)
            rec = np.zeros(n_f, dtype=[("n", np.uint8), ("idx", np.int32, 3)])
            rec["n"] = 3
            rec["idx"] = tris
            f.write(rec.tobytes())


def read_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray],
                                 Optional[np.ndarray]]:
    """Read a PLY written by :func:`write_ply`. Returns (verts, tris, colors)."""
    with open(path, "rb") as f:
        n_v = n_f = 0
        has_color = False
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith("element face"):
                n_f = int(line.split()[-1])
            elif line == "property uchar red":
                has_color = True
            elif line == "end_header":
                break
        if has_color:
            rec = np.frombuffer(
                f.read(n_v * 15), dtype=[("xyz", np.float32, 3),
                                         ("rgb", np.uint8, 3)], count=n_v)
            verts, colors = rec["xyz"].copy(), rec["rgb"].copy()
        else:
            verts = np.frombuffer(f.read(n_v * 12), np.float32,
                                  count=n_v * 3).reshape(n_v, 3).copy()
            colors = None
        tris = None
        if n_f:
            rec = np.frombuffer(
                f.read(n_f * 13), dtype=[("n", np.uint8),
                                         ("idx", np.int32, 3)], count=n_f)
            tris = rec["idx"].copy()
    return verts, tris, colors
