#!/usr/bin/env python
"""How precisely does mma.sync m16n8k16 (bf16 operands, float32 accumulators)
add on this card?

    python tools/probe_mma_accumulation.py

Builds one small CUDA kernel with nvcc (sm_90a) and, for random bf16 A [16, K]
and B [K, 8] (K = 256, the train backward's layer width), computes A B three
ways on one warp: (1) one accumulator chained through the K / 16 mma, as
csrc/mma_tile.cuh's tile product does; (2) each mma from a zero accumulator,
its result added to a float32 register sum (promotion every k-tile); (3) a
float32 FMA chain over k, as the SIMT kernels sum. Prints, for each, the
median and max over the outputs of |D - exact| / sum_k |a_k b_k| (exact:
float64), in units of 2^-24. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SRC = r"""
#include <cuda_bf16.h>
#include <stdint.h>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
// one block (one warp) per trial: A [16][K], B [K][8] row-major bf16; D [3][16][8]
__global__ void probe(const __nv_bfloat16* A, const __nv_bfloat16* B, int K, float* D) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  A += (size_t)blockIdx.x * 16 * K; B += (size_t)blockIdx.x * K * 8; D += (size_t)blockIdx.x * 3 * 128;
  float c[4] = {0, 0, 0, 0}, s[4] = {0, 0, 0, 0};
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4] = {pack(A[g * K + k0 + 2 * t], A[g * K + k0 + 2 * t + 1]),
                     pack(A[(g + 8) * K + k0 + 2 * t], A[(g + 8) * K + k0 + 2 * t + 1]),
                     pack(A[g * K + k0 + 2 * t + 8], A[g * K + k0 + 2 * t + 9]),
                     pack(A[(g + 8) * K + k0 + 2 * t + 8], A[(g + 8) * K + k0 + 2 * t + 9])};
    const uint32_t b0 = pack(B[(k0 + 2 * t) * 8 + g], B[(k0 + 2 * t + 1) * 8 + g]);
    const uint32_t b1 = pack(B[(k0 + 2 * t + 8) * 8 + g], B[(k0 + 2 * t + 9) * 8 + g]);
    mma16816(c, a, b0, b1);
    float f[4] = {0, 0, 0, 0};
    mma16816(f, a, b0, b1);
    for (int e = 0; e < 4; ++e) s[e] += f[e];
  }
  for (int e = 0; e < 4; ++e) {
    const int r = g + (e >> 1) * 8, col = 2 * t + (e & 1);
    D[r * 8 + col] = c[e];
    D[128 + r * 8 + col] = s[e];
    float acc = 0.f;
    for (int k = 0; k < K; ++k)
      acc = fmaf(__bfloat162float(A[r * K + k]), __bfloat162float(B[k * 8 + col]), acc);
    D[256 + r * 8 + col] = acc;
  }
}
extern "C" int run_probe(const void* A, const void* B, int K, int trials, void* D) {
  probe<<<trials, 32>>>((const __nv_bfloat16*)A, (const __nv_bfloat16*)B, K, (float*)D);
  return (int)cudaDeviceSynchronize();
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_mma_accumulation: needs a CUDA card", file=sys.stderr)
        return 2
    from endosurf_tpu_torch.kernels.build import find_nvcc
    k, trials = 256, 512
    with tempfile.TemporaryDirectory() as work:
        src, lib = os.path.join(work, "probe.cu"), os.path.join(work, "probe.so")
        with open(src, "w") as f:
            f.write(SRC)
        subprocess.run([find_nvcc(), "-O3", "-gencode", "arch=compute_90a,code=sm_90a",
                        "-Xcompiler", "-fPIC", "-shared", "-o", lib, src], check=True)
        so = ctypes.CDLL(lib)
        so.run_probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
        gen = torch.Generator().manual_seed(0)
        a = torch.randn(trials, 16, k, generator=gen).to(torch.bfloat16)
        b = torch.randn(trials, k, 8, generator=gen).to(torch.bfloat16)
        out = torch.empty(trials, 3, 16, 8, dtype=torch.float32, device="cuda")
        ac, bc = a.cuda(), b.cuda()
        err = so.run_probe(ac.data_ptr(), bc.data_ptr(), k, trials, out.data_ptr())
        if err:
            raise RuntimeError(f"probe failed: cudaError {err}")
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    name = torch.cuda.get_device_name(0)
    for i, what in enumerate(("mma chained", "mma per k-tile + FADD", "float32 FMA chain")):
        rel = ((out[:, i].cpu().double() - exact).abs() / scale / 2.0 ** -24).flatten()
        print(f"{what} (K {k}, {trials * 128} outputs, {name}): |err| / sum|ab| median "
              f"{float(rel.median()):.2f}, p99 {float(torch.quantile(rel, 0.99)):.2f}, max "
              f"{float(rel.max()):.2f} x 2^-24", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
