"""Build and load the native geometry library (host C++, not a GPU kernel).

``g++ -O3 -std=c++17 -shared -fPIC`` compiles ``geometry.cpp`` at first use
into ``native/_build/`` (git-ignored), named by a hash of the source and the
flags, so a fresh checkout builds its own and an edited source builds anew.
The build writes a temporary file and renames it into place, so concurrent
processes never load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "geometry.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None


def build_library() -> Path:
    """Compile the source if this hash has no library yet; return its path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"_geometry_{h}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SRC)], check=True,
                       capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        os.unlink(tmp)
        raise RuntimeError(f"native build failed:\n{e.stderr}") from e
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The bound library (built on first call)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))

    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i32, f32, vp = ctypes.c_int, ctypes.c_float, ctypes.c_void_p

    lib.esn_marching_tetrahedra.restype = vp
    lib.esn_marching_tetrahedra.argtypes = [f32p, i32, i32, i32, f32]
    lib.esn_clean_mesh.restype = vp
    lib.esn_clean_mesh.argtypes = [f32p, i32, i32p, i32, f32]
    lib.esn_result_n_verts.restype = i32
    lib.esn_result_n_verts.argtypes = [vp]
    lib.esn_result_n_tris.restype = i32
    lib.esn_result_n_tris.argtypes = [vp]
    lib.esn_result_copy.argtypes = [vp, f32p, i32p]
    lib.esn_result_free.argtypes = [vp]
    lib.esn_laplacian_smooth.argtypes = [f32p, i32, i32p, i32, i32, f32, f32p]
    lib.esn_vertex_normals.argtypes = [f32p, i32, i32p, i32, f32p]
    lib.esn_point_cloud_distance.argtypes = [f32p, i32, f32p, i32, f32p]
    lib.esn_rasterize_mesh.argtypes = [f32p, i32, f32p, i32p, i32, i32, i32, f32p, f32p]
    lib.esn_nn_distance_excl_self.argtypes = [f32p, i32, f32p]
    lib.esn_radius_outlier_mask.argtypes = [f32p, i32, i32, f32, ctypes.POINTER(ctypes.c_uint8)]
    lib.esn_alias_table.argtypes = [f32p, i32, f32p, i32p]
    lib.esn_alias_table.restype = None
    _lib = lib
    return lib
