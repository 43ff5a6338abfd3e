// The weight-gradient product of the bf16 deform and SDF backward
// (field_tc.cuh) on tensor cores: dW = scale * A^T B over the point axis for
// a list of (operand, cotangent) pairs, as wgrad.cuh's SIMT product, with
// bf16 operands and float32 accumulation (mma.sync m16n8k16).
//
// wgrad_tc_partial_kernel: a block sums one TC_TILE x TC_TILE tile of one
// product over one chunk of WG_KC points, in slabs of TC_KS points: each slab
// of A and B goes global -> registers (the next slab's loads in flight while
// the current one computes) -> shared memory [point][column] bf16, read as
// transposed ldmatrix fragments. An operand is bf16 (the scratch's
// bf16-exact arrays), float32 (split into hi + lo, two mma into one
// accumulator: the SDF's cotangents) or a column of ones (a bias gradient, or
// the SDF head column's). Blocks of one chunk are adjacent in the grid, so the
// chunk's slabs are read from device memory about once and from L2 by the
// other tiles. The chunk sums land in wgrad.cuh's partial layout and
// wgrad_reduce_kernel adds them in a fixed order, scales, rounds each dot's
// gradient to bf16 once, and writes (pass 0) or adds (pass 1): no float
// atomics, so two calls give the same bits.
//
// Anonymous namespace: one copy per .cu, as sdf_chain.cuh.

#pragma once

#include "mma_tile.cuh"
#include "wgrad.cuh"

#define TC_TILE 128              // output tile (rows of A^T x columns of B)
#define TC_KS 32                 // points per slab
#define TC_LD (TC_TILE + 8)      // slab row pitch in bf16 (16 bytes x odd)

namespace {

enum { OP_ONES = 0, OP_BF16 = 1, OP_F32 = 2 };

struct TcJobs {
  WgJobs w;                          // shapes, chunks, partial offsets (the reduce reads these)
  signed char kind_a[WG_MAXJOBS], kind_b[WG_MAXJOBS];
  int tiles_m[WG_MAXJOBS], tiles_n[WG_MAXJOBS], block0[WG_MAXJOBS];
  int n_blocks;
};

// One operand's slab [TC_KS points][TC_TILE columns from c0] in registers:
// bf16 rows as 2 x 8 values a thread, float32 as 4 x 4.
struct Slab {
  uint4 v[4];
};

__device__ __forceinline__ void slab_load(Slab& s, int kind, const void* src, int ld, int c0,
                                          long long k, long long k1, int tid) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  if (kind == OP_BF16) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int idx = tid + q * 256, r = idx >> 4, c = c0 + (idx & 15) * 8;
      s.v[q] = k + r < k1 && c < ld
                   ? __ldg((const uint4*)((const bf16*)src + (size_t)(k + r) * ld + c))
                   : zero;
    }
  } else if (kind == OP_F32) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = tid + q * 256, r = idx >> 5, c = c0 + (idx & 31) * 4;
      s.v[q] = k + r < k1 && c < ld
                   ? __ldg((const uint4*)((const float*)src + (size_t)(k + r) * ld + c))
                   : zero;
    }
  }
}

// The slab into shared memory [TC_KS][TC_LD]: hi (and lo for a float32
// operand); the ones operand writes 1 in global column 0 of points below k1.
__device__ __forceinline__ void slab_store(const Slab& s, int kind, bf16* hi, bf16* lo, int c0,
                                           long long k, long long k1, int tid) {
  if (kind == OP_BF16) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int idx = tid + q * 256;
      *(uint4*)(hi + (idx >> 4) * TC_LD + (idx & 15) * 8) = s.v[q];
    }
  } else if (kind == OP_F32) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = tid + q * 256, off = (idx >> 5) * TC_LD + (idx & 31) * 4;
      const float* f = (const float*)&s.v[q];
      __align__(8) bf16 h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_bf16(f[e], h[e], l[e]);
      *(uint2*)(hi + off) = *(const uint2*)h;
      *(uint2*)(lo + off) = *(const uint2*)l;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int idx = tid + q * 256, r = idx >> 4, c = (idx & 15) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (c0 == 0 && c == 0 && k + r < k1) v.x = 0x3f80u;   // bf16 1.0 in element 0
      *(uint4*)(hi + r * TC_LD + c) = v;
    }
  }
}

__global__ void __launch_bounds__(256)
wgrad_tc_partial_kernel(const __grid_constant__ TcJobs jobs, float* __restrict__ partial) {
  __shared__ __align__(16) uint16_t sAr[2][TC_KS * TC_LD];   // hi, lo (bf16)
  __shared__ __align__(16) uint16_t sBr[2][TC_KS * TC_LD];
  bf16* sA[2] = {(bf16*)sAr[0], (bf16*)sAr[1]};
  bf16* sB[2] = {(bf16*)sBr[0], (bf16*)sBr[1]};
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int jid = 0;
  while (jid + 1 < jobs.w.n_jobs && b >= jobs.block0[jid + 1]) ++jid;
  const WgJob& J = jobs.w.j[jid];
  const int ka = jobs.kind_a[jid], kb = jobs.kind_b[jid];
  const int tiles = jobs.tiles_m[jid] * jobs.tiles_n[jid];
  const int local = b - jobs.block0[jid];
  const int chunk = local / tiles, tile = local - chunk * tiles;
  const int i0 = (tile / jobs.tiles_n[jid]) * TC_TILE, j0 = (tile % jobs.tiles_n[jid]) * TC_TILE;
  const long long k0 = (long long)chunk * WG_KC;
  const long long k1 = min((long long)J.K, k0 + WG_KC);
  const int wm = warp >> 2, wn = warp & 3;      // warp tile: 64 rows x 32 columns
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  Slab ra, rb;
  slab_load(ra, ka, J.A, J.lda, i0, k0, k1, tid);
  slab_load(rb, kb, J.B, J.ldb, j0, k0, k1, tid);
  // A^T fragments: matrix q of ldmatrix.x4 is rows (points) 8 (q / 2), columns 8 (q % 2)
  const int a_off = ((lane & 7) + ((lane >> 4) & 1) * 8) * TC_LD + wm * 64 + ((lane >> 3) & 1) * 8;
  // B fragments: matrix q is rows 8 (q % 2), columns 8 (q / 2)
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * TC_LD + wn * 32 + ((lane >> 4) & 1) * 8;
  for (long long k = k0; k < k1; k += TC_KS) {
    __syncthreads();
    slab_store(ra, ka, sA[0], sA[1], i0, k, k1, tid);
    slab_store(rb, kb, sB[0], sB[1], j0, k, k1, tid);
    __syncthreads();
    if (k + TC_KS < k1) {
      slab_load(ra, ka, J.A, J.lda, i0, k + TC_KS, k1, tid);
      slab_load(rb, kb, J.B, J.ldb, j0, k + TC_KS, k1, tid);
    }
#pragma unroll
    for (int ks = 0; ks < TC_KS / 16; ++ks) {
      // fragments: A^T (hi, and lo when A is split) and B (hi, and lo when B is)
      uint32_t a[2][4][4], bq[2][4][2], r[4];
      const int na = ka == OP_F32 ? 2 : 1, nb = kb == OP_F32 ? 2 : 1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h < na)
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
            ldsm_x4_t(a[h][mt], sA[h] + ks * 16 * TC_LD + a_off + mt * 16);
        if (h < nb)
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            ldsm_x4_t(r, sB[h] + ks * 16 * TC_LD + b_off + np * 16);
            bq[h][2 * np][0] = r[0]; bq[h][2 * np][1] = r[1];
            bq[h][2 * np + 1][0] = r[2]; bq[h][2 * np + 1][1] = r[3];
          }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        float part[4][4] = {};                   // this k-tile's products, promoted
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma16816(part[nt], a[0][mt], bq[0][nt][0], bq[0][nt][1]);
          if (na == 2) mma16816(part[nt], a[1][mt], bq[0][nt][0], bq[0][nt][1]);   // A_lo B
          if (nb == 2) mma16816(part[nt], a[0][mt], bq[1][nt][0], bq[1][nt][1]);   // A B_lo
        }
        promote(acc[mt], part);
      }
    }
  }
  float* P = partial + J.partial + (size_t)chunk * J.M * J.N;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + wm * 64 + mt * 16 + g + (e >> 1) * 8;
        const int j = j0 + wn * 32 + nt * 8 + 2 * t + (e & 1);
        if (i < J.M && j < J.N) P[(size_t)i * J.N + j] = acc[mt][nt][e];
      }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A product out = scale * A^T B over K points; A [K][lda] of kind ka (null
// for OP_ONES), B likewise; lda, ldb multiples of 8 (bf16) or 4 (float32)
// and 16-byte aligned rows.
void add_tc_job(TcJobs& jobs, long long& partial_used, const void* A, int ka, int lda,
                const void* B, int kb, int ldb, long long K, int M, int N, float scale, int rnd,
                float* out, int ldo, int pass) {
  const int i = jobs.w.n_jobs;
  add_job(jobs.w, partial_used, (const float*)A, lda, (const float*)B, ldb, K, M, N, scale, rnd,
          out, ldo, pass);
  jobs.kind_a[i] = (signed char)ka;
  jobs.kind_b[i] = (signed char)kb;
  jobs.tiles_m[i] = (M + TC_TILE - 1) / TC_TILE;
  jobs.tiles_n[i] = (N + TC_TILE - 1) / TC_TILE;
  jobs.block0[i] = jobs.n_blocks;
  jobs.n_blocks += jobs.tiles_m[i] * jobs.tiles_n[i] * jobs.w.j[i].chunks;
}

cudaError_t run_wgrad_tc(const TcJobs& jobs, float* partial, cudaStream_t st) {
  if (jobs.n_blocks == 0) return cudaSuccess;
  wgrad_tc_partial_kernel<<<jobs.n_blocks, 256, 0, st>>>(jobs, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  long long mn = 0;
  for (int i = 0; i < jobs.w.n_jobs; ++i)
    mn = mn > (long long)jobs.w.j[i].M * jobs.w.j[i].N ? mn
                                                        : (long long)jobs.w.j[i].M * jobs.w.j[i].N;
  dim3 grid((unsigned)((mn + 255) / 256), (unsigned)jobs.w.n_jobs);
  for (int pass = 0; pass < 2; ++pass) {
    wgrad_reduce_kernel<<<grid, 256, 0, st>>>(jobs.w, partial, pass);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace
