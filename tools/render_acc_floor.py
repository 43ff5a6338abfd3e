#!/usr/bin/env python
"""Where the bf16 EndoSurf render's acc_map error against float64 comes from.

For the cells of tests/test_torch_cuda.py's
``test_render_tensor_cores_no_farther_from_float64`` (the narrow, full and
full-static nets on 1024 rays, and 8192 rays of chip_smoke.py's frame, each
on weight seeds 0 and 1) it prints, per cell, the median and p99 of the
per-ray acc_map error against the float64 yardstick
(``fused_render.fused_render_rays_float64``) of:

* the render's composite kernel alone (``composite_kernel`` of
  ``csrc/fused_render.cu``, built here into a probe library of its own
  beside the kernel library) run on the yardstick's own field values and
  samples (rounded to float32), in float32 (the SIMT render's composite) and
  in double (the tensor-core render's): the floor each composite puts under
  acc_map;
* the tensor-core bf16 render and the SIMT one (``simt=True``), whose
  sweeps and field stage add to their composite's floor.

Needs a CUDA device:

    python tools/render_acc_floor.py
"""

from __future__ import annotations

import os.path as osp
import subprocess
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

RENDER_ARGS = (30000.0, 32, 32, 4, 50000.0)   # iter step, samples, importance, rounds, anneal


def test_rays(n: int, dev, seed: int = 1):
    """tests/test_torch_cuda.py's _rays."""
    import torch
    g = torch.Generator().manual_seed(seed)
    o = torch.cat([torch.rand(n, 2, generator=g) * 0.6 - 0.3, torch.full((n, 1), -1.5)], -1)
    d = torch.rand(n, 3, generator=g) * 0.4 - 0.2 - o
    d = d / d.norm(dim=-1, keepdim=True)
    return torch.cat([o, d, torch.zeros(n, 2), torch.rand(n, 1, generator=g)], -1).to(dev)


def frame_rays(n: int, dev):
    """n rays spread over chip_smoke.py's synthetic 512 x 640 frame."""
    from endosurf_tpu_torch.data.scene_data import frame_rays as rays_of, make_synthetic_arrays
    scene = make_synthetic_arrays(n_frames=4, h=512, w=640, seed=0, device=dev)
    rays = rays_of(scene.device_arrays, 512, 640, 3).reshape(-1, 9)
    return rays[::rays.shape[0] // n][:n].contiguous()


# The probe: csrc/fused_render.cu with one more entry that runs its
# composite kernel alone.
PROBE = r"""
#include "fused_render.cu"
// zl [R][64] the sorted depths (the first K of each row), pt [R * K][8]
// (sdf, rgb, grad_o, d . grad_o), scal [2] (anneal, inv_s) on the device ->
// out [R, 9]; exact: the double composite, else the float32 one.
extern "C" int composite_probe(int R, int K, float sample_dist, const float* zl,
                               const float* pt, const float* scal, int exact, float* out,
                               void* stream) {
  if (K < 1 || K > KMAX) return (int)cudaErrorInvalidValue;
  const int tpb = 128, rblocks = (R + tpb - 1) / tpb;
  cudaStream_t st = (cudaStream_t)stream;
  if (exact)
    composite_kernel<double><<<rblocks, tpb, 0, st>>>(R, K, sample_dist, zl, pt, scal, out);
  else
    composite_kernel<float><<<rblocks, tpb, 0, st>>>(R, K, sample_dist, zl, pt, scal, out);
  return (int)cudaGetLastError();
}
"""


def probe_library():
    """Build (once per source hash) and bind the composite probe."""
    import ctypes
    from endosurf_tpu_torch.kernels import build
    out = build.BUILD_DIR / f"libcomposite_probe_{build.source_hash()}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = out.with_suffix(".cu")
        src.write_text(PROBE)
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(build.CSRC), "-o",
               str(out), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.composite_probe.argtypes = [i32, i32, ctypes.c_float, vp, vp, vp, i32, vp, vp]
    lib.composite_probe.restype = i32
    return lib


def composite_alone(ex, sample_dist: float, exact: bool):
    """The render's composite kernel on a float64 chunk's fields -> acc [R, 1]."""
    import torch
    z = ex["z"]
    n_rays, k = z.shape
    dev = z.device
    f = ex["fields"]
    tc = (ex["dirs"] * f["grad_o"]).sum(-1, keepdim=True)
    pt = torch.cat([f["sdf"][:, None], f["color"], f["grad_o"], tc], -1).float().contiguous()
    zl = torch.zeros(n_rays, 64, dtype=torch.float32, device=dev)
    zl[:, :k] = z.float()
    scal = torch.stack([ex["anneal"].reshape(()), ex["inv_s"].reshape(())]).float().contiguous()
    out = torch.empty(n_rays, 9, dtype=torch.float32, device=dev)
    err = probe_library().composite_probe(n_rays, k, sample_dist, zl.data_ptr(), pt.data_ptr(),
                                          scal.data_ptr(), int(exact), out.data_ptr(),
                                          torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"composite_probe failed: CUDA error {err}")
    return out[:, 7:8]


def main():
    import torch
    from endosurf_tpu_torch.kernels import fused_render as fr
    from endosurf_tpu_torch.models.fields import EndoSurfSpec, MLPSpec, init_endosurf_params
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    narrow = EndoSurfSpec(deform=MLPSpec(9, 64, (4,), 3), sdf=MLPSpec(9, 64, (4,), 65),
                          color=MLPSpec(9, 64, (4,), 3), color_feat_dim=64)
    cells = [(sid, spec, seed, 1024) for sid, spec in
             (("narrow", narrow), ("full", EndoSurfSpec()),
              ("full-static", EndoSurfSpec(use_deform=False))) for seed in (0, 1)]
    cells += [("frame", EndoSurfSpec(), seed, 8192) for seed in (0, 1)]
    bf = torch.bfloat16
    sample_dist = 2.0 / RENDER_ARGS[1]

    def dist(acc, ref):
        return fr.float64_distance({k: (acc if k == "acc_map" else ref[k]) for k in ref},
                                   ref)["acc_map"]
    for sid, spec, seed, n in cells:
        params = init_endosurf_params(spec, torch.Generator().manual_seed(seed), dev)
        rays = test_rays(n, dev) if n == 1024 else frame_rays(n, dev)
        chunks = [fr.float64_fields(spec, params, rays[i:i + 1024], *RENDER_ARGS)
                  for i in range(0, n, 1024)]
        ref = {k: torch.cat([c["maps"][k] for c in chunks]) for k in chunks[0]["maps"]}
        comp = {exact: torch.cat([composite_alone(c, sample_dist, exact) for c in chunks])
                for exact in (False, True)}
        renders = {name: fr.fused_render_rays_cuda(spec, params, rays, *RENDER_ARGS, bf, bf,
                                                   simt=flag)["acc_map"]
                   for name, flag in (("tensor cores", False), ("SIMT", True))}
        parts = {"composite alone, float32": dist(comp[False], ref),
                 "composite alone, double": dist(comp[True], ref),
                 **{f"{k} render": dist(v, ref) for k, v in renders.items()}}
        print(f"acc_map vs float64, {sid} seed {seed} ({n} rays), (median, p99): " + "; ".join(
            f"{k} {m:.4e}, {p:.4e}" for k, (m, p) in parts.items()), flush=True)


if __name__ == "__main__":
    main()
