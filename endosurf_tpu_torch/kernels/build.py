"""Build the CUDA sources in ``csrc/`` at first use and bind them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes) under
``kernels/_build/``, named by a hash of the sources and flags: a checkout
builds its own library on first call, and an edited source builds anew. The
sources compile in parallel, one nvcc process each, and are then linked. A
failed compile raises with nvcc's output. ``torch.utils.cpp_extension`` is not
used: it needs ``ninja``, which the GPU machines may lack.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile the sources if this hash has no library yet; return its path.

    nvcc's output (ptxas registers, shared memory and spills per kernel)
    is kept beside the library as ``<name>.log``."""
    out = BUILD_DIR / f"libendosurf_kernels_{source_hash()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        jobs = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = os.path.join(work, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], None
        for cmd, _, proc in jobs:
            log = proc.communicate()[0]
            logs.append(log)
            if proc.returncode != 0 and failed is None:
                failed = (proc.returncode, cmd, log)
        if failed is not None:
            code, cmd, log = failed
            raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{log}")
        tmp = os.path.join(work, out.name)
        cmd = [nvcc, "-shared", "-o", tmp, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text("".join(logs))
        os.replace(tmp, out)      # atomic: concurrent builds agree
    return out


def load_library() -> ctypes.CDLL:
    """The bound kernel library (built on first call)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_library()))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_render_launch.argtypes = [
        vp, i32, vp, vp, ctypes.POINTER(i64), i32, i32, i32, i32, i32, i32,
        ctypes.c_float, vp, vp, vp, vp, vp]
    lib.fused_render_launch.restype = i32
    lib.fused_render_scratch_floats.argtypes = [i32]
    lib.fused_render_scratch_floats.restype = i64
    lib.fused_render_work_floats.argtypes = [ctypes.POINTER(i64), i64]
    lib.fused_render_work_floats.restype = i64
    lib.fused_render_meta_len.argtypes = []
    lib.fused_render_meta_len.restype = i32
    lib.fused_render_error_string.argtypes = [i32]
    lib.fused_render_error_string.restype = ctypes.c_char_p
    lib.fused_upsample_launch.argtypes = [
        vp, vp, i32, i32, vp, ctypes.POINTER(i64), i32, i32, i32, i32, vp, vp, vp, vp]
    lib.fused_upsample_launch.restype = i32
    lib.fused_upsample_scratch_floats.argtypes = [i32]
    lib.fused_upsample_scratch_floats.restype = i64
    lib.fused_sdf_observed_launch.argtypes = [vp, vp, i64, vp, ctypes.POINTER(i64), i32, i32, vp,
                                              vp]
    lib.fused_sdf_observed_launch.restype = i32
    lib.fused_ray_march_launch.argtypes = [
        vp, vp, vp, i32, i32, i32, ctypes.c_float, vp, ctypes.POINTER(i64), i32, i32, vp, vp, vp,
        vp]
    lib.fused_ray_march_launch.restype = i32
    lib.fused_march_scratch_floats.argtypes = [i32, i32]
    lib.fused_march_scratch_floats.restype = i64
    # the train segments (fused_train.cu): w, meta, rb, n, then tensors, stream
    head = [vp, ctypes.POINTER(i64), i32, i32]
    for name, n_ptrs in (("train_deform_fwd", 3), ("train_sdf_fwd", 5),
                         ("train_color_fwd", 5), ("train_deform_bwd", 6),
                         ("train_sdf_bwd", 8), ("train_color_bwd", 12)):
        fn = getattr(lib, name)
        fn.argtypes = head + [vp] * (n_ptrs + 1)
        fn.restype = i32
    lib.train_bwd_sizes.argtypes = [ctypes.POINTER(i64), i32, i32, i32, ctypes.POINTER(i64)]
    lib.train_bwd_sizes.restype = None
    lib.train_sdf_fwd_work_floats.argtypes = [ctypes.POINTER(i64), i32, i32]
    lib.train_sdf_fwd_work_floats.restype = i64
    # the EndoNeRF kernels (fused_sdf.cu, fused_render_dnerf.cu, fused_train_dnerf.cu)
    lib.fused_density_raw_launch.argtypes = [vp, vp, i64, vp, ctypes.POINTER(i64), i32, i32, vp,
                                             vp]
    lib.fused_density_raw_launch.restype = i32
    lib.fused_render_dnerf_scratch_floats.argtypes = [i32]
    lib.fused_render_dnerf_scratch_floats.restype = i64
    lib.fused_render_dnerf_launch.argtypes = [
        vp, vp, i32, i32, i32, vp, vp, ctypes.POINTER(i64), i32, i32, i32, vp, vp, vp]
    lib.fused_render_dnerf_launch.restype = i32
    # the D-NeRF segments: w, meta, rb, tc, n, then tensors (a backward's
    # last three: scratch, partial sums, packed gradient), stream
    for name, n_ptrs in (("dnerf_deform_fwd", 2), ("dnerf_density_fwd", 3),
                         ("dnerf_color_fwd", 3), ("dnerf_deform_bwd", 5),
                         ("dnerf_density_bwd", 7), ("dnerf_color_bwd", 7)):
        fn = getattr(lib, name)
        fn.argtypes = [vp, ctypes.POINTER(i64), i32, i32, i64] + [vp] * (n_ptrs + 1)
        fn.restype = i32
    lib.dnerf_bwd_sizes.argtypes = [ctypes.POINTER(i64), i32, i32, i64, ctypes.POINTER(i64)]
    lib.dnerf_bwd_sizes.restype = None
    lib.fused_fine_resample_launch.argtypes = [vp, vp, vp, i32, i32, i32, vp, vp]
    lib.fused_fine_resample_launch.restype = i32
    _LIB = lib
    return lib
