// The per-point D-NeRF field evaluation (kernels/fused_train_dnerf.py's
// forward_math), shared by the EndoNeRF render kernel's fine evaluation
// (fused_render_dnerf.cu) and the three forward segment kernels
// (fused_train_dnerf.cu):
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
// Anonymous namespace: one copy per .cu, as sdf_chain.cuh.

#pragma once

#include "sdf_chain.cuh"

#define P_DN 32         // points per block, D-NeRF field evaluation

namespace {

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

// Hidden layers 0 .. n-2 of a nerf-style net, relu'd into s.h in place.
// Layer 0 reads [enc (ew) | s.h (n_feat)]; a skip layer reads [h | enc].
template <bool RB>
__device__ void dn_hidden(const Net& N, const float* __restrict__ wts, const DnTile& s, int ew,
                          int n_feat, int tid) {
  for (int l = 0; l < N.n_layers - 1; ++l) {
    const int n_out = N.out_dim[l];
    const bool skip = (N.skip_mask >> l) & 1;
    const float* W = wts + N.w_off[l];
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

// s.x -> s.xc = x + deform(enc(x, t)).
template <bool RB>
__device__ void dn_deform(const float* __restrict__ wts, const Model& m, const DnTile& s,
                          int tid) {
  dn_encode<RB>(s.x, m.f_dpos, s.e, m.ed, tid);
  __syncthreads();
  dn_hidden<RB>(m.deform, wts, s, m.ed, 0, tid);
  if (tid < 3 * P_DN) {
    const int p = tid / 3, col = tid - p * 3;
    s.xc[p * 4 + col] = s.x[p * 4 + col] + dn_out_col(m.deform, wts, s.h + p * HMAX, col);
  }
  __syncthreads();
}

// s.xc -> raw sigma in s.out[p * 4] and the feature in s.h (operands); with
// feat_out, also the float32 feature of points base .. base + P - 1 (< n) to
// feat_out [n][F].
template <bool RB>
__device__ void dn_density(const float* __restrict__ wts, const Model& m, const DnTile& s,
                           int tid, long long base, long long n, float* __restrict__ feat_out) {
  dn_encode<RB>(s.xc, m.f_spos, s.e, m.es, tid);
  __syncthreads();
  const Net& N = m.sdf;
  dn_hidden<RB>(N, wts, s, m.es, 0, tid);
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
template <bool RB>
__device__ void dn_color(const float* __restrict__ wts, const Model& m, const DnTile& s,
                         int tid) {
  dn_encode<RB>(s.d, m.f_cdir, s.e, m.cr, tid);
  __syncthreads();
  dn_hidden<RB>(m.color, wts, s, m.cr, m.feat_dim, tid);
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
