"""EndoSurf in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``endosurf_tpu`` (which stays the numerical
reference). Module names mirror the JAX package so each counterpart is easy to
find. Importing this package has no side effects and never imports JAX.

Ported so far: the serving path (``python -m endosurf_tpu_torch --mode
test_2d``), whose whole forward render runs in one CUDA kernel
(``kernels/fused_render.py``).
"""

__all__ = ["__version__"]

__version__ = "0.1.0"
