// The fixed-order weight-gradient product of the train backward kernels
// (fused_train.cu, fused_train_dnerf.cu): dW = scale * A^T B over the point
// axis for a list of (operand, cotangent) pairs. wgrad_partial_kernel sums
// 64x64 tiles of each product over chunks of WG_KC points (SIMT float32),
// wgrad_reduce_kernel adds the chunks in a fixed order (two calls give the
// same bits), scales, rounds to bf16 where asked and writes (pass 0) or adds
// (pass 1) the result at the gradient's place in the packed buffer.
//
// Anonymous namespace: one copy per .cu, as sdf_chain.cuh.

#pragma once

#include "sdf_chain.cuh"

#define WG_TILE 64       // weight-gradient tile (rows of A^T x columns of B)
#define WG_KC 4096       // points per chunk of the weight-gradient sum
#define WG_MAXJOBS 32

namespace {

// One weight-gradient product out = scale * A^T B over K rows, A [K][M]
// (null: a column of ones), B [K][N] (null: a column of ones).
struct WgJob {
  const float* A;
  const float* B;
  float* out;             // [M][ldo]
  long long partial;      // offset of this job's [chunks][M][N] partial sums
  int lda, ldb, ldo, K, M, N;
  int tiles_m, tiles_n, chunks, block0;
  int rnd;                // round the sum to bf16
  int pass;               // 0: write, 1: add to what pass 0 wrote
  float scale;
};

struct WgJobs {
  int n_jobs;
  int n_blocks;
  WgJob j[WG_MAXJOBS];
};

// ---------------------------------------------------------------------------
// weight-gradient product
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
wgrad_partial_kernel(const __grid_constant__ WgJobs jobs, float* __restrict__ partial) {
  __shared__ float sA[16][WG_TILE];
  __shared__ float sB[16][WG_TILE];
  const int b = blockIdx.x;
  int jid = 0;
  while (jid + 1 < jobs.n_jobs && b >= jobs.j[jid + 1].block0) ++jid;
  const WgJob& J = jobs.j[jid];
  const int local = b - J.block0;
  const int chunk = local % J.chunks;
  const int tile = local / J.chunks;
  const int i0 = (tile / J.tiles_n) * WG_TILE, j0 = (tile % J.tiles_n) * WG_TILE;
  const int k0 = chunk * WG_KC;
  const int k1 = min(J.K, k0 + WG_KC);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int w = 0; w < 4; ++w) acc[q][w] = 0.f;
  for (int k = k0; k < k1; k += 16) {
    for (int e = threadIdx.x; e < 16 * WG_TILE; e += 256) {
      const int r = e / WG_TILE, c = e - r * WG_TILE;
      const int kk = k + r;
      float av = 0.f, bv = 0.f;
      if (kk < k1) {
        if (i0 + c < J.M) av = J.A ? J.A[(size_t)kk * J.lda + i0 + c] : 1.f;
        if (j0 + c < J.N) bv = J.B ? J.B[(size_t)kk * J.ldb + j0 + c] : 1.f;
      }
      sA[r][c] = av;
      sB[r][c] = bv;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float a[4], bb[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) { a[q] = sA[r][ty * 4 + q]; bb[q] = sB[r][tx * 4 + q]; }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[q][w] = fmaf(a[q], bb[w], acc[q][w]);
    }
    __syncthreads();
  }
  float* P = partial + J.partial + (size_t)chunk * J.M * J.N;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int i = i0 + ty * 4 + q, j = j0 + tx * 4 + w;
      if (i < J.M && j < J.N) P[(size_t)i * J.N + j] = acc[q][w];
    }
}

// Chunks summed in order, scaled, rounded, written (pass 0) or added (pass 1).
__global__ void __launch_bounds__(256)
wgrad_reduce_kernel(const __grid_constant__ WgJobs jobs, const float* __restrict__ partial, int pass) {
  const WgJob& J = jobs.j[blockIdx.y];
  if (J.pass != pass) return;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long mn = (long long)J.M * J.N;
  if (e >= mn) return;
  const float* P = partial + J.partial + e;
  float s = 0.f;
  for (int c = 0; c < J.chunks; ++c) s += P[(size_t)c * mn];
  s *= J.scale;
  if (J.rnd) s = bf16r(s);
  const int i = (int)(e / J.N), j = (int)(e - (long long)i * J.N);
  float* o = J.out + (size_t)i * J.ldo + j;
  *o = pass == 0 ? s : *o + s;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Hands out consecutive slices of one scratch buffer (null base: only counts).
struct Planner {
  float* base;          // null: only count
  long long used = 0;
  float* take(long long floats) {
    float* p = base ? base + used : nullptr;
    used += floats;
    return p;
  }
};

void add_job(WgJobs& jobs, long long& partial_used, const float* A, int lda, const float* B,
             int ldb, long long K, int M, int N, float scale, int rnd, float* out, int ldo,
             int pass) {
  WgJob& J = jobs.j[jobs.n_jobs++];
  J.A = A; J.B = B; J.out = out;
  J.lda = lda; J.ldb = ldb; J.ldo = ldo;
  J.K = (int)K; J.M = M; J.N = N;
  J.tiles_m = (M + WG_TILE - 1) / WG_TILE;
  J.tiles_n = (N + WG_TILE - 1) / WG_TILE;
  J.chunks = (int)((K + WG_KC - 1) / WG_KC);
  J.block0 = jobs.n_blocks;
  J.rnd = rnd; J.pass = pass; J.scale = scale;
  J.partial = partial_used;
  partial_used += (long long)J.chunks * M * N;
  jobs.n_blocks += J.tiles_m * J.tiles_n * J.chunks;
}

cudaError_t run_wgrad(const WgJobs& jobs, float* partial, cudaStream_t st) {
  if (jobs.n_blocks == 0) return cudaSuccess;
  wgrad_partial_kernel<<<jobs.n_blocks, 256, 0, st>>>(jobs, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  long long mn = 0;
  for (int i = 0; i < jobs.n_jobs; ++i)
    mn = mn > (long long)jobs.j[i].M * jobs.j[i].N ? mn : (long long)jobs.j[i].M * jobs.j[i].N;
  dim3 grid((unsigned)((mn + 255) / 256), (unsigned)jobs.n_jobs);
  for (int pass = 0; pass < 2; ++pass) {
    wgrad_reduce_kernel<<<grid, 256, 0, st>>>(jobs, partial, pass);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace
