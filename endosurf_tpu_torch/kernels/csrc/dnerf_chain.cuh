// The per-point D-NeRF field evaluation (kernels/fused_train_dnerf.py's
// forward_math), shared by the EndoNeRF render kernel's fine evaluation
// (fused_render_dnerf.cu) and the six segment kernels (fused_train_dnerf.cu:
// the forwards, and the backwards' recompute):
//
//   x_c         = x + deform(enc(x, t))                     dn_deform
//   (sigma, f)  = density(enc(x_c)): column 0 of the output
//                 layer (raw, before the relu) and columns 1..F   dn_density
//   rgb         = sigmoid(color([enc(d), f]))                dn_color
//
// All three are nerf-style MLPs: plain (W, b) layers, relu hidden layers, a
// linear output layer, and skip layers that read [h | enc] unscaled. There
// are no Jacobian tangents and no adjoint (the chain is first-order), so a
// block of NT threads owns P_DN points, as the sampling sweep does: thread j
// computes output neuron j for every point of the tile from activations in
// shared memory (warp broadcasts), the weights stream from L2 and each
// weight load feeds P_DN points. The hidden activations are overwritten in
// place (read, sync, write); after the density net the tile's h holds the
// feature, which the colour net's first layer reads beside enc(d).
//
// Precision (RB): every dot operand is rounded to bf16 -- the coordinates
// before they are encoded (the TPU kernels feed them to a selector dot), the
// encodings, the activations, the feature -- and the weights arrive rounded;
// products accumulate in float32. The raw density and the feature a
// segment kernel writes out are float32.
//
// SAVE (the backward kernels) copies every layer's dot operands, as the
// forward forms them, to the global scratch DnScratch::xin as it goes; with
// SAVE off the code is the render kernel's, operation for operation.
//
// Anonymous namespace: one copy per .cu, as sdf_chain.cuh.

#pragma once

#include "sdf_chain.cuh"

#define P_DN 32         // points per block, D-NeRF field evaluation
#define DN_N0 64        // coarse depths per ray, and draws, at most (resampling)
#define DN_K 128        // samples per ray after resampling, at most

namespace {

// Global scratch of a backward kernel, rows indexed by point.
struct DnScratch {
  float* xin[NL];   // layer l's dot operands [n][in_l]: [enc | feat], [h | enc] or [h]
  float* dz[NL];    // cotangent on layer l's pre-activation [n][out_l]
};

// Shared-memory tile of P_DN points.
struct DnTile {
  float* x;     // [P][4] observed point, t
  float* xc;    // [P][4] canonical point
  float* d;     // [P][4] view direction
  float* out;   // [P][4] raw sigma, rgb
  float* h;     // [P][HMAX] hidden activations (operands); after the density net, the feature
  float* e;     // [P][emax] encoding (operands)
};

__host__ __device__ inline int dn_emax(const Model& m) {
  int e = m.ed > m.es ? m.ed : m.es;
  return e > m.cr ? e : m.cr;
}

__host__ __device__ inline size_t dn_smem_floats(const Model& m) {
  return (size_t)P_DN * (4 * 4 + HMAX + dn_emax(m));
}

__device__ __forceinline__ DnTile dn_tile(float* smem, const Model& m) {
  DnTile s;
  s.x = smem;
  s.xc = s.x + 4 * P_DN;
  s.d = s.xc + 4 * P_DN;
  s.out = s.d + 4 * P_DN;
  s.h = s.out + 4 * P_DN;
  s.e = s.h + P_DN * HMAX;
  return s;
}

// Frequency encoding of the tile's rows src [P][4] into e [P][ew]: columns
// 0 .. enc(3, f3) encode src[0..2], the rest (ew wider) src[3] (the time).
template <bool RB>
__device__ __forceinline__ void dn_encode(const float* src, int f3, float* e, int ew, int tid) {
  const int ex = enc_width(3, f3);
  for (int idx = tid; idx < P_DN * ew; idx += NT) {
    int p = idx / ew, c = idx - p * ew;
    int dim, kind; float sc;
    if (c < ex) enc_col(c, 3, dim, kind, sc);
    else { enc_col(c - ex, 1, dim, kind, sc); dim = 3; }
    float v = opnd<RB>(src[p * 4 + dim]) * sc;
    float en = kind == 0 ? v : (kind == 1 ? sinf(v) : cosf(v));
    e[p * ew + c] = opnd<RB>(en);
  }
}

// Rows [a (na) | b (nb)] of the tile's points to dst [n][na + nb] (rows past
// n skipped).
__device__ __forceinline__ void dn_save(float* __restrict__ dst, long long base, long long n,
                                        const float* a, int lda, int na, const float* b,
                                        int ldb, int nb, int tid) {
  const int w = na + nb;
  for (int idx = tid; idx < P_DN * w; idx += NT) {
    const int p = idx / w, c = idx - p * w;
    if (base + p < n) dst[(size_t)(base + p) * w + c] = c < na ? a[p * lda + c] : b[p * ldb + c - na];
  }
}

// Hidden layers 0 .. n-2 of a nerf-style net, relu'd into s.h in place.
// Layer 0 reads [enc (ew) | s.h (n_feat)]; a skip layer reads [h | enc].
template <bool RB, bool SAVE = false>
__device__ void dn_hidden(const Net& N, const float* __restrict__ wts, const DnTile& s, int ew,
                          int n_feat, int tid, const DnScratch& sv = DnScratch{},
                          long long base = 0, long long n = 0) {
  for (int l = 0; l < N.n_layers - 1; ++l) {
    const int n_out = N.out_dim[l];
    const bool skip = (N.skip_mask >> l) & 1;
    const float* W = wts + N.w_off[l];
    if (SAVE) {
      if (l == 0) dn_save(sv.xin[0], base, n, s.e, ew, ew, s.h, HMAX, n_feat, tid);
      else if (skip) dn_save(sv.xin[l], base, n, s.h, HMAX, N.in_dim[l] - ew, s.e, ew, ew, tid);
      else dn_save(sv.xin[l], base, n, s.h, HMAX, N.in_dim[l], nullptr, 0, 0, tid);
    }
    float acc[P_DN];
#pragma unroll
    for (int p = 0; p < P_DN; ++p) acc[p] = 0.f;
    if (tid < n_out) {
      if (l == 0) {
        acc_seg<P_DN>(acc, W, n_out, tid, 0, s.e, ew, ew);
        if (n_feat) acc_seg<P_DN>(acc, W, n_out, tid, ew, s.h, HMAX, n_feat);
      } else {
        const int n_h = skip ? N.in_dim[l] - ew : N.in_dim[l];
        acc_seg<P_DN>(acc, W, n_out, tid, 0, s.h, HMAX, n_h);
        if (skip) acc_seg<P_DN>(acc, W, n_out, tid, n_h, s.e, ew, ew);
      }
    }
    __syncthreads();
    if (tid < n_out) {
      const float b = wts[N.b_off[l] + tid];
#pragma unroll
      for (int p = 0; p < P_DN; ++p) s.h[p * HMAX + tid] = opnd<RB>(fmaxf(acc[p] + b, 0.f));
    }
    __syncthreads();
  }
}

// One output column of a net's last layer for one point: h . W[:, col] + b[col].
__device__ __forceinline__ float dn_out_col(const Net& N, const float* __restrict__ wts,
                                            const float* h, int col) {
  const int l = N.n_layers - 1;
  const int n_out = N.out_dim[l];
  const float* W = wts + N.w_off[l] + col;
  float a = 0.f;
  for (int k = 0; k < N.in_dim[l]; ++k) a = fmaf(h[k], __ldg(W + (size_t)k * n_out), a);
  return a + wts[N.b_off[l] + col];
}

// The operand of a net's last layer (s.h) to the scratch.
template <bool SAVE>
__device__ __forceinline__ void dn_save_last(const Net& N, const DnTile& s, const DnScratch& sv,
                                             long long base, long long n, int tid) {
  if (SAVE) {
    const int l = N.n_layers - 1;
    dn_save(sv.xin[l], base, n, s.h, HMAX, N.in_dim[l], nullptr, 0, 0, tid);
  }
}

// s.x -> s.xc = x + deform(enc(x, t)).
template <bool RB, bool SAVE = false>
__device__ void dn_deform(const float* __restrict__ wts, const Model& m, const DnTile& s,
                          int tid, const DnScratch& sv = DnScratch{}, long long base = 0,
                          long long n = 0) {
  dn_encode<RB>(s.x, m.f_dpos, s.e, m.ed, tid);
  __syncthreads();
  dn_hidden<RB, SAVE>(m.deform, wts, s, m.ed, 0, tid, sv, base, n);
  dn_save_last<SAVE>(m.deform, s, sv, base, n, tid);
  if (tid < 3 * P_DN) {
    const int p = tid / 3, col = tid - p * 3;
    s.xc[p * 4 + col] = s.x[p * 4 + col] + dn_out_col(m.deform, wts, s.h + p * HMAX, col);
  }
  __syncthreads();
}

// s.xc -> raw sigma in s.out[p * 4] and the feature in s.h (operands); with
// feat_out, also the float32 feature of points base .. base + P - 1 (< n) to
// feat_out [n][F].
template <bool RB, bool SAVE = false>
__device__ void dn_density(const float* __restrict__ wts, const Model& m, const DnTile& s,
                           int tid, long long base, long long n, float* __restrict__ feat_out,
                           const DnScratch& sv = DnScratch{}) {
  dn_encode<RB>(s.xc, m.f_spos, s.e, m.es, tid);
  __syncthreads();
  const Net& N = m.sdf;
  dn_hidden<RB, SAVE>(N, wts, s, m.es, 0, tid, sv, base, n);
  dn_save_last<SAVE>(N, s, sv, base, n, tid);
  const int l = N.n_layers - 1;
  const int n_out = N.out_dim[l];
  const int F = n_out - 1;
  const float* W = wts + N.w_off[l];
  float acc[P_DN];
#pragma unroll
  for (int p = 0; p < P_DN; ++p) acc[p] = 0.f;
  if (tid < F) acc_seg<P_DN>(acc, W, n_out, 1 + tid, 0, s.h, HMAX, N.in_dim[l]);
  float sigma = 0.f;
  if (tid < P_DN) {
    const float* Wh = W;                 // the sigma head: column 0 of the output layer
    for (int k = 0; k < N.in_dim[l]; ++k)
      sigma = fmaf(s.h[tid * HMAX + k], __ldg(Wh + (size_t)k * n_out), sigma);
    sigma += wts[N.b_off[l]];
  }
  __syncthreads();
  if (tid < F) {
    const float b = wts[N.b_off[l] + 1 + tid];
#pragma unroll
    for (int p = 0; p < P_DN; ++p) {
      const float v = acc[p] + b;
      s.h[p * HMAX + tid] = opnd<RB>(v);
      if (feat_out != nullptr && base + p < n) feat_out[(size_t)(base + p) * F + tid] = v;
    }
  }
  if (tid < P_DN) s.out[tid * 4] = sigma;
  __syncthreads();
}

// s.d and the feature in s.h -> rgb = sigmoid(color([enc(d), f])) in s.out[p * 4 + 1..3].
template <bool RB, bool SAVE = false>
__device__ void dn_color(const float* __restrict__ wts, const Model& m, const DnTile& s,
                         int tid, const DnScratch& sv = DnScratch{}, long long base = 0,
                         long long n = 0) {
  dn_encode<RB>(s.d, m.f_cdir, s.e, m.cr, tid);
  __syncthreads();
  dn_hidden<RB, SAVE>(m.color, wts, s, m.cr, m.feat_dim, tid, sv, base, n);
  dn_save_last<SAVE>(m.color, s, sv, base, n, tid);
  if (tid < 3 * P_DN) {
    const int p = tid / 3, col = tid - p * 3;
    s.out[p * 4 + 1 + col] = sigmoidf_(dn_out_col(m.color, wts, s.h + p * HMAX, col));
  }
  __syncthreads();
}

template <class K>
cudaError_t dn_prepare(K kernel, const Model& m, size_t& smem) {
  smem = dn_smem_floats(m) * sizeof(float);
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
