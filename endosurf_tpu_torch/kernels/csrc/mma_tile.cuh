// Tensor-core building blocks of the bf16 ("default" dot mode) kernels
// (field_tc.cuh, sweep_tc.cuh, dnerf_tc.cuh, wgrad_tc.cuh): mma.sync m16n8k16
// bf16 x bf16 -> float32, ldmatrix, cp.async, the hi/lo split of a float32
// operand, the tile product of a block's rows with one layer's weights, and
// the tile kernels' shared helpers (saving operand rows, the scratch planner,
// the launch's shared-memory opt-in).
//
// Tile product. A block of TC_WARPS warps owns a tile of MT x 16 rows (points,
// or points x streams). The rows' operand A sits in shared memory as bf16,
// row-major, with a row pitch of 8 x an odd number of elements (16 bytes x
// odd: ldmatrix's eight row addresses then fall in eight bank groups). The
// weights B come from global memory in mma fragment order
// (fused_train_cuda.mma_frags): per k-tile of 16 rows and per pair of n-tiles
// (16 columns) 32 lanes x 8 bf16, lane (g, t) holding B[2t, 2t+1, 2t+8, 2t+9]
// of column 16 np + g and the same of column 16 np + 8 + g, so one 16-byte
// copy gives a lane both n-tiles' B fragments. Each warp owns up to TC_NPW
// n-tile pairs (32 columns) of the output for all rows: its fragments stream
// through a ring of TC_STAGES slots of its own with cp.async, and a lane reads
// back only the 16 bytes it copied, so the ring needs no barrier. The float32
// accumulators stay in registers in mma's C layout: acc[mt][nt] holds rows
// 16 mt + g (elements 0, 1) and 16 mt + g + 8 (elements 2, 3), columns
// 8 nt + 2t and 8 nt + 2t + 1 of the warp's 32.
//
// A float32 operand that is not a bf16 value goes in as a sum of bf16 terms,
// one mma each: hi + lo (split_bf16: x to within 2^-16 |x|) in the EndoSurf
// SDF's weight-gradient product, whose sums over 65,536 points average the
// remainder away (the D-NeRF density's takes three: with two, its output
// layer's bias and feature gradients read 1.7-6x the SIMT product's distance
// from float64, PERF.md §6); hi + mid + lo (split3_bf16: to within 2^-24 |x|) in the
// tile walks, whose every dot is rounded to bf16 again, so that a remainder
// above float32's own tips those roundings more often than the plain
// version's float32 sums do. Each k-tile's mma start from zero and are
// promoted into the float32 accumulators (promote): chained through the
// k-tiles, the mma add the small terms' products too coarsely to keep them.
// Readings on an H100 (PERF.md, PR 7; the SDF's d x_c p99 against the plain
// version, phase 9 of chip_smoke.py): two terms chained 1.47e-2, three
// chained 1.47e-2, two promoted 1.47e-2, three promoted 7.3e-3; the float32
// plain version reads 7.6e-3 against a float64 one.
//
// Anonymous namespace: one copy per .cu, as sdf_chain.cuh.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define TC_WARPS 8       // warps per block of the tile kernels (NT threads)
#define TC_THREADS (TC_WARPS * 32)
#define TC_STAGES 4      // cp.async ring depth of a warp's weight fragments
#define TC_NPW 2         // n-tile pairs (16 columns each) a warp owns
#define TC_RING_BYTES (TC_WARPS * TC_STAGES * TC_NPW * 32 * 16)

namespace {

typedef __nv_bfloat16 bf16;

__host__ __device__ inline int c16(int x) { return (x + 15) & ~15; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The same, each matrix transposed as it is distributed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b: a 16x16 (row), b 16x8 (col), bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ bf16 bzero() { return __float2bfloat16_rn(0.f); }

// The encoding e [rows][ew] into columns [c0, c0 + ew) of the operand, zeros
// up to the next multiple of 16.
__device__ __forceinline__ void put_enc(bf16* h, int ldh, int c0, const bf16* e, int ew, int rows,
                                        int tid) {
  const int w = c16(c0 + ew) - c0;
  for (int idx = tid; idx < rows * w; idx += TC_THREADS) {
    const int r = idx / w, c = idx - r * w;
    h[r * ldh + c0 + c] = c < ew ? e[r * ew + c] : bzero();
  }
}

// The warp's accumulator pairs: f(row, col, v0, v1) for columns col, col + 1.
template <int MT, class F>
__device__ __forceinline__ void for_pairs(const float (&acc)[MT][2 * TC_NPW][4], int np0, int npw,
                                          int lane, F&& f) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2 * TC_NPW; ++nt) {
      if (nt >= 2 * npw) continue;
      const int col = np0 * 16 + nt * 8 + 2 * t;
      f(mt * 16 + g, col, acc[mt][nt][0], acc[mt][nt][1]);
      f(mt * 16 + g + 8, col, acc[mt][nt][2], acc[mt][nt][3]);
    }
}

__device__ __forceinline__ int clampw(int x) { return x < 0 ? 0 : (x > TC_NPW ? TC_NPW : x); }

// x -> (hi, lo) = (bf16(x), bf16(x - hi)); x - hi is exact in float32, so
// |x - hi - lo| <= 2^-8 |x - hi| <= 2^-16 |x|.
__device__ __forceinline__ void split_bf16(float x, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

// x -> (hi, mid, lo), each the bf16 rounding of what the previous left:
// |x - hi - mid - lo| <= 2^-24 |x|.
__device__ __forceinline__ void split3_bf16(float x, bf16& hi, bf16& mid, bf16& lo) {
  hi = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}

// acc += part, float32 adds (round to nearest). An mma chained through many
// k-tiles adds each tile's products into the running sum more coarsely than
// float32 FMA does (tools/probe_mma_accumulation.py on an H100, K = 256:
// |error| / sum |a b| median 0.19 x 2^-24, p99 1.21, against 0.08 / 0.63 for
// an FMA chain); each k-tile from zero, promoted into a register sum, reads
// 0.06 / 0.42.
template <int NT2>
__device__ __forceinline__ void promote(float (&acc)[NT2][4], const float (&part)[NT2][4]) {
#pragma unroll
  for (int nt = 0; nt < NT2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] += part[nt][e];
}

// acc + lo += part, float32 adds, with each add's rounding error kept in lo
// (Knuth's TwoSum: acc + lo is the exact float sum of the promoted parts, up
// to lo's own roundings), for the sweep's near-exact sums (sweep_tc.cuh).
template <int NT2>
__device__ __forceinline__ void promote_2sum(float (&acc)[NT2][4], float (&lo)[NT2][4],
                                             const float (&part)[NT2][4]) {
#pragma unroll
  for (int nt = 0; nt < NT2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = acc[nt][e], p = part[nt][e], s = a + p, bp = s - a;
      lo[nt][e] += (a - (s - bp)) + (p - bp);
      acc[nt][e] = s;
    }
}

template <int MT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][2 * TC_NPW][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2 * TC_NPW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// acc += A[:, 16 kt0 : 16 kt1] B[16 kt0 : 16 kt1, the warp's columns]: the
// warp's n-tile pairs np0 .. np0 + npw - 1 (npw <= TC_NPW, uniform in the
// warp) of B's np_row pairs. A: the TERMS bf16 terms a[0] (hi), a[1], ..
// of the operand, each [MT * 16][lda] in shared memory (one term: a bf16
// operand; three: a split float32 one), their products added in that order
// into the same accumulators. ring: the warp's TC_STAGES * TC_NPW * 32 slots.
// With SPLIT the terms' products share no mma (each term's k-tile from zero,
// the terms' parts added in float32) and each k-tile's sum goes in by
// promote_2sum, its rounding errors into lo; else lo is unused.
template <int MT, int TERMS, bool SPLIT>
__device__ __forceinline__ void tile_mma_impl(float (&acc)[MT][2 * TC_NPW][4],
                                              float (&lo)[MT][2 * TC_NPW][4],
                                              const bf16* const (&a)[TERMS], int lda,
                                              const uint4* __restrict__ bfrag, int np_row,
                                              int np0, int npw, int kt0, int kt1, uint4* ring,
                                              int lane) {
  if (npw <= 0 || kt0 >= kt1) return;
  auto issue = [&](int kt, int stage) {
#pragma unroll
    for (int q = 0; q < TC_NPW; ++q)
      if (q < npw)
        cp_async16(ring + (stage * TC_NPW + q) * 32 + lane,
                   bfrag + ((size_t)kt * np_row + np0 + q) * 32 + lane);
  };
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (kt0 + s < kt1) issue(kt0 + s, s);
    cp_async_commit();
  }
  const int la = (lane & 15) * lda + (lane >> 4) * 8;
  for (int kt = kt0, st = 0; kt < kt1; ++kt, st = st + 1 == TC_STAGES ? 0 : st + 1) {
    cp_async_wait<TC_STAGES - 2>();        // this k-tile's copies have landed
    uint4 b[TC_NPW];
#pragma unroll
    for (int q = 0; q < TC_NPW; ++q)
      if (q < npw) b[q] = ring[(st * TC_NPW + q) * 32 + lane];
    // refill the slot read one k-tile ago
    if (kt + TC_STAGES - 1 < kt1) issue(kt + TC_STAGES - 1, st == 0 ? TC_STAGES - 1 : st - 1);
    cp_async_commit();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float sum[2 * TC_NPW][4] = {};           // this k-tile's sum, promoted below
#pragma unroll
      for (int term = 0; term < TERMS; ++term) {
        float part[2 * TC_NPW][4] = {};
        float (&dst)[2 * TC_NPW][4] = SPLIT ? part : sum;
        uint32_t af[4];
        ldsm_x4(af, a[term] + la + mt * 16 * lda + kt * 16);
#pragma unroll
        for (int q = 0; q < TC_NPW; ++q)
          if (q < npw) {
            mma16816(dst[2 * q], af, b[q].x, b[q].y);
            mma16816(dst[2 * q + 1], af, b[q].z, b[q].w);
          }
        if (SPLIT)
#pragma unroll
          for (int nt = 0; nt < 2 * TC_NPW; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) sum[nt][e] += part[nt][e];
      }
      if constexpr (SPLIT) promote_2sum(acc[mt], lo[mt], sum);
      else promote(acc[mt], sum);
    }
  }
  cp_async_wait<0>();
}

template <int MT, int TERMS>
__device__ __forceinline__ void tile_mma(float (&acc)[MT][2 * TC_NPW][4],
                                         const bf16* const (&a)[TERMS], int lda,
                                         const uint4* __restrict__ bfrag, int np_row, int np0,
                                         int npw, int kt0, int kt1, uint4* ring, int lane) {
  tile_mma_impl<MT, TERMS, false>(acc, acc, a, lda, bfrag, np_row, np0, npw, kt0, kt1, ring,
                                  lane);
}

// The terms' products kept apart and the k-tiles promoted exactly
// (tile_mma_impl with SPLIT).
template <int MT, int TERMS>
__device__ __forceinline__ void tile_mma_split(float (&acc)[MT][2 * TC_NPW][4],
                                               float (&lo)[MT][2 * TC_NPW][4],
                                               const bf16* const (&a)[TERMS], int lda,
                                               const uint4* __restrict__ bfrag, int np_row,
                                               int np0, int npw, int kt0, int kt1, uint4* ring,
                                               int lane) {
  tile_mma_impl<MT, TERMS, true>(acc, lo, a, lda, bfrag, np_row, np0, npw, kt0, kt1, ring, lane);
}

// Operand rows -> dst [S][n][w] (w the padded width, a multiple of 16;
// rows past n skipped), r = s * P + p.
template <int S, int P>
__device__ __forceinline__ void save_rows(bf16* __restrict__ dst, const bf16* h, int ldh, int w,
                                          long long base, long long n, int tid) {
  const int vec = w / 8;
  for (int idx = tid; idx < S * P * vec; idx += TC_THREADS) {
    const int r = idx / vec, v = idx - r * vec;
    const int s = r / P, p = r - s * P;
    if (base + p >= n) continue;
    *(uint4*)(dst + ((size_t)s * n + base + p) * w + v * 8) = *(const uint4*)(h + r * ldh + v * 8);
  }
}

// ---------------------------------------------------------------------------
// host side of the tile kernels
// ---------------------------------------------------------------------------

// Hands out 256-byte aligned slices of one scratch buffer (null base: only counts).
struct BytePlanner {
  char* base;
  long long used = 0;
  template <class T>
  T* take(long long count) {
    used = (used + 255) & ~255LL;
    T* p = base ? (T*)(base + used) : nullptr;
    used += count * (long long)sizeof(T);
    return p;
  }
};

template <class K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// blocks of p points that cover n
unsigned n_tiles(long long n, int p) { return (unsigned)((n + p - 1) / p); }

}  // namespace
