"""ctypes bindings for the first-party C++ geometry code: marching
tetrahedra, mesh cleaning, smoothing, vertex normals, KD-tree distances and a
z-buffer rasterizer for the 3D demo, the nearest-neighbour distance and
radius-outlier mask of the preprocessing, and the alias tables of the
``alias`` pixel sampler (host code, as in the JAX package, which
keeps its own copy of ``geometry.cpp``).

The shared library builds on first use (``build.py``: g++ -O3 into the
git-ignored ``native/_build/``).
"""

from endosurf_tpu_torch.native.build import load_library  # noqa: F401
from endosurf_tpu_torch.native.meshops import (  # noqa: F401
    alias_table,
    clean_mesh,
    laplacian_smooth,
    marching_tetrahedra,
    nn_distance_excl_self,
    point_cloud_distance,
    radius_outlier_mask,
    rasterize_mesh,
    vertex_normals,
)
