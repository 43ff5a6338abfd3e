// The per-point field evaluation shared by the render kernel (fused_render.cu)
// and the train segment kernels (fused_train.cu): deform MLP + 3 Jacobian
// tangent streams, SDF MLP + in-forward adjoint (grad_c), colour MLP
// (fused_train.forward_math; skips scale after the dot).
//
// A block of NT threads owns a tile of P_FIELD points: thread j computes
// output neuron j for every point of the tile, the tile's activations live in
// shared memory (read as warp broadcasts) and the weights stream from L2.
//
// SAVE (the train backward kernels) writes what their backward walk and the
// weight-gradient product need to the global scratch of FieldScratch as the
// forward goes: each layer's input operands, the SDF pre-activations and the
// adjoint. With SAVE off the code is the render kernel's, operation for
// operation.
//
// Anonymous namespace: one copy per .cu, as sdf_chain.cuh.

#pragma once

#include "sdf_chain.cuh"

#define P_FIELD 8       // points per block, full field evaluation

namespace {

// The train segments, in the order of the packed meta's nets.
enum Seg { SEG_DEFORM = 0, SEG_SDF = 1, SEG_COLOR = 2 };

// Shared-memory tile of P_FIELD points.
struct FieldTile {
  float* x;     // [P][4] x, t
  float* d;     // [P][4] raw view direction; after the coupling d_c
  float* xc;    // [P][4] canonical point
  float* gc;    // [P][4] grad_c
  float* J;     // [P][9] J[k][m] = d x_c[m] / d x[k]
  float* hu;    // [4][P][HMAX] primal + tangents / adjoint / colour h
  float* e4;    // [4][P][ed] deform encoding + tangent seeds
  float* es;    // [P][es] sdf encoding (operand)
  float* g1;    // [P][es] encoding derivative
  float* aE;    // [P][es] adjoint on the encoding
  float* cin;   // [P][ci] colour input
  float* sdf;   // [P]
};

// Global scratch of a train backward kernel (rows indexed by point; the
// deform net's arrays hold 4 streams, stream-major: [4][n][width]).
struct FieldScratch {
  float* xin[NL];   // layer l's dot operands [h_{l-1} | encoding] [n][in_l]
  float* dz[NL];    // cotangent on layer l's pre-activation [n][out_l]
  float* z[NL];     // sdf: pre-activations [n][H]
  float* a[NL];     // sdf: the adjoint reaching layer l's output, ungated [n][H]
  float* ag[NL];    // sdf: adjoint dot operand op(a_l * sigma_l) [n][H]
  float* da[NL];    // sdf: cotangent on the adjoint dot's output [n][in_l]
  float* dhead;     // sdf: cotangent on the adjoint seed (the head column) [n][H]
};

__host__ __device__ inline size_t field_smem_floats(const Model& m) {
  return (size_t)P_FIELD * (4 * 4 + 9 + 4 * HMAX + 4 * m.ed + 3 * m.es + m.ci + 1);
}

__device__ __forceinline__ FieldTile field_tile(float* smem, const Model& m) {
  const int P = P_FIELD;
  FieldTile s;
  s.x = smem;
  s.d = s.x + 4 * P;
  s.xc = s.d + 4 * P;
  s.gc = s.xc + 4 * P;
  s.J = s.gc + 4 * P;
  s.hu = s.J + 9 * P;
  s.e4 = s.hu + 4 * P * HMAX;
  s.es = s.e4 + 4 * P * m.ed;
  s.g1 = s.es + P * m.es;
  s.aE = s.g1 + P * m.es;
  s.cin = s.aE + P * m.es;
  s.sdf = s.cin + P * m.ci;
  return s;
}

// Copy the tile's operands of one layer, [h (n_h) | sec (n_sec)] for S
// streams, to dst [S][n][n_h + n_sec] (rows of points past n are skipped).
template <int S>
__device__ __forceinline__ void save_operands(float* __restrict__ dst, long long base, long long n,
                                              const float* h, int n_h, const float* sec,
                                              int ld_sec, int n_sec, int tid) {
  const int P = P_FIELD;
  const int w = n_h + n_sec;
  for (int idx = tid; idx < S * P * w; idx += NT) {
    const int s = idx / (P * w);
    const int rem = idx - s * P * w;
    const int p = rem / w, c = rem - p * w;
    if (base + p >= n) continue;
    const float v = c < n_h ? h[s * P * HMAX + p * HMAX + c]
                            : sec[s * P * ld_sec + p * ld_sec + (c - n_h)];
    dst[((size_t)s * n + base + p) * w + c] = v;
  }
}

// ---- deform + Jacobian tangents: s.x -> s.xc, s.J --------------------------
template <bool RB, bool SAVE>
__device__ __forceinline__ void field_deform(const float* __restrict__ wts, const Model& m,
                                             const FieldTile& s, int tid, long long base,
                                             long long n, const FieldScratch& sv) {
  const int P = P_FIELD;
  if (m.use_deform) {
    const int ed = m.ed;
    const int ex = enc_width(3, m.f_dpos);
    for (int idx = tid; idx < P * ed; idx += NT) {
      int p = idx / ed, c = idx - p * ed;
      int dim, kind; float sc;
      if (c < ex) enc_col(c, 3, dim, kind, sc);
      else { enc_col(c - ex, 1, dim, kind, sc); dim = 3; }
      float v = opnd<RB>(s.x[p * 4 + dim]) * sc;
      float sv_ = sinf(v), cv = cosf(v);
      float e = kind == 0 ? v : (kind == 1 ? sv_ : cv);
      float g1 = kind == 0 ? 1.f : (kind == 1 ? cv : -sv_);
      s.e4[p * ed + c] = opnd<RB>(e);
      for (int k = 0; k < 3; ++k)
        s.e4[(k + 1) * P * ed + p * ed + c] = opnd<RB>(dim == k ? sc * g1 : 0.f);
    }
    __syncthreads();
    const Net& N = m.deform;
    const int L = N.n_layers;
    for (int l = 0; l < NL; ++l) {
      if (l >= L) break;
      const int n_out = N.out_dim[l];
      const bool skip = (N.skip_mask >> l) & 1;
      const bool last = (l == L - 1);
      const float* W = wts + N.w_off[l];
      if (SAVE) {
        const int n_h = l == 0 ? 0 : (skip ? N.in_dim[l] - ed : N.in_dim[l]);
        save_operands<4>(sv.xin[l], base, n, s.hu, n_h, s.e4, ed,
                         (l == 0 || skip) ? ed : 0, tid);
      }
      float acc[4][P];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < P; ++p) acc[q][p] = 0.f;
      if (tid < n_out) {
        if (l == 0) {
          acc_seg_s<P, 4>(acc, W, n_out, tid, 0, s.e4, ed, P * ed, ed);
        } else {
          int n_h = skip ? N.in_dim[l] - ed : N.in_dim[l];
          acc_seg_s<P, 4>(acc, W, n_out, tid, 0, s.hu, HMAX, P * HMAX, n_h);
          if (skip) acc_seg_s<P, 4>(acc, W, n_out, tid, n_h, s.e4, ed, P * ed, ed);
        }
      }
      __syncthreads();
      if (tid < n_out) {
        const float b = wts[N.b_off[l] + tid];
        const float sc = skip ? kInvSqrt2 : 1.f;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          float z = acc[0][p] * sc + b;
          if (!last) {
            float gate = z > 0.f ? 1.f : 0.f;
            s.hu[p * HMAX + tid] = opnd<RB>(fmaxf(z, 0.f));
            for (int k = 0; k < 3; ++k)
              s.hu[(k + 1) * P * HMAX + p * HMAX + tid] = opnd<RB>(acc[k + 1][p] * sc * gate);
          } else if (tid < 3) {
            s.xc[p * 4 + tid] = s.x[p * 4 + tid] + z;
            for (int k = 0; k < 3; ++k)
              s.J[p * 9 + k * 3 + tid] = (k == tid ? 1.f : 0.f) + acc[k + 1][p] * sc;
          }
        }
      }
      __syncthreads();
    }
  } else {
    if (tid < P * 9) {
      int p = tid / 9, q = tid - p * 9;
      s.J[p * 9 + q] = (q / 3 == q % 3) ? 1.f : 0.f;
    }
    if (tid < P * 3) {
      int p = tid / 3, c = tid - p * 3;
      s.xc[p * 4 + c] = s.x[p * 4 + c];
    }
    __syncthreads();
  }
}

// ---- SDF forward + head/feature + adjoint + grad_c: s.xc -> s.sdf, feat,
// s.aE, s.gc. The feature goes to the colour input (opnd-rounded) or, with
// FEAT_OUT, unrounded to feat_out [n][F]. -------------------------------------
template <bool RB, bool SAVE, bool FEAT_OUT>
__device__ __forceinline__ void field_sdf(const float* __restrict__ wts, const Model& m,
                                          const FieldTile& s, int tid, long long base,
                                          long long n, const FieldScratch& sv,
                                          float* __restrict__ feat_out) {
  const int P = P_FIELD;
  const int es = m.es;
  for (int idx = tid; idx < P * es; idx += NT) {
    int p = idx / es, c = idx - p * es;
    int dim, kind; float sc;
    enc_col(c, 3, dim, kind, sc);
    float v = opnd<RB>(s.xc[p * 4 + dim]) * sc;
    float sv_ = sinf(v), cv = cosf(v);
    s.es[p * es + c] = opnd<RB>(kind == 0 ? v : (kind == 1 ? sv_ : cv));
    s.g1[p * es + c] = kind == 0 ? 1.f : (kind == 1 ? cv : -sv_);
    s.aE[p * es + c] = 0.f;
  }
  __syncthreads();

  const Net& S = m.sdf;
  const int L = S.n_layers;      // hidden layers 0 .. L-2, the output layer L-1
  float gate[NL - 1][P];
#pragma unroll
  for (int l = 0; l < NL - 1; ++l) {
    if (l >= L - 1) break;
    const int n_out = S.out_dim[l];
    const bool skip = (S.skip_mask >> l) & 1;
    const float* W = wts + S.w_off[l];
    if (SAVE) {
      const int n_h = l == 0 ? 0 : (skip ? S.in_dim[l] - es : S.in_dim[l]);
      save_operands<1>(sv.xin[l], base, n, s.hu, n_h, s.es, es, (l == 0 || skip) ? es : 0, tid);
    }
    float acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = 0.f;
    if (tid < n_out) {
      if (l == 0) {
        acc_seg<P>(acc, W, n_out, tid, 0, s.es, es, es);
      } else {
        int n_h = skip ? S.in_dim[l] - es : S.in_dim[l];
        acc_seg<P>(acc, W, n_out, tid, 0, s.hu, HMAX, n_h);
        if (skip) acc_seg<P>(acc, W, n_out, tid, n_h, s.es, es, es);
      }
    }
    __syncthreads();
    const float b = (tid < n_out) ? wts[S.b_off[l] + tid] : 0.f;
    const float sc = skip ? kInvSqrt2 : 1.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float z = acc[p] * sc + b;
      gate[l][p] = sigmoidf_(100.f * z);
      if (tid < n_out) s.hu[p * HMAX + tid] = opnd<RB>(softplus100(z));
      if (SAVE && tid < n_out && base + p < n) sv.z[l][(size_t)(base + p) * n_out + tid] = z;
    }
    __syncthreads();
  }

  // output layer: head (column 0) and feature (columns 1..F)
  {
    const int l = L - 1;
    const int n_out = S.out_dim[l];
    const int n_in = S.in_dim[l];
    const float* W = wts + S.w_off[l];
    const int off_feat = m.cp + 3 + m.cr;
    if (SAVE) save_operands<1>(sv.xin[l], base, n, s.hu, n_in, s.hu, HMAX, 0, tid);
    if (tid < m.feat_dim) {
      float acc[P];
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] = 0.f;
      acc_seg<P>(acc, W, n_out, 1 + tid, 0, s.hu, HMAX, n_in);
      const float b = wts[S.b_off[l] + 1 + tid];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (FEAT_OUT) {
          if (base + p < n) feat_out[(size_t)(base + p) * m.feat_dim + tid] = acc[p] + b;
        } else {
          s.cin[p * m.ci + off_feat + tid] = opnd<RB>(acc[p] + b);
        }
      }
    }
    if (tid < P) {
      float a = 0.f;
      for (int k = 0; k < n_in; ++k)
        a = fmaf(s.hu[tid * HMAX + k], __ldg(W + (size_t)k * n_out), a);
      s.sdf[tid] = a + wts[S.b_off[l]];
    }
    __syncthreads();
    // adjoint seed: head column gated by the last hidden layer, L-2 (picked
    // from the unrolled gates by constant indices: nothing spills)
    if (tid < n_in) {
      const float hw = wts[m.head_off + tid];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float gl = gate[0][p];
#pragma unroll
        for (int k = 1; k < NL - 1; ++k) gl = k == L - 2 ? gate[k][p] : gl;
        s.hu[p * HMAX + tid] = opnd<RB>(hw * gl);
        if (SAVE && base + p < n) {
          sv.a[L - 2][(size_t)(base + p) * n_in + tid] = hw;
          sv.ag[L - 2][(size_t)(base + p) * n_in + tid] = opnd<RB>(hw * gl);
        }
      }
    }
    __syncthreads();
  }

  // ---- SDF adjoint: walk layers L-2 .. 0 -----------------------------------
#pragma unroll
  for (int l = NL - 2; l >= 0; --l) {
    if (l > L - 2) continue;
    const int in_l = S.in_dim[l];
    const int out_l = S.out_dim[l];
    const bool skip = (S.skip_mask >> l) & 1;
    const float* WT = wts + S.wt_off[l];
    float acc0[P], acc1[P];
#pragma unroll
    for (int p = 0; p < P; ++p) { acc0[p] = 0.f; acc1[p] = 0.f; }
    const int i0 = tid, i1 = tid + NT;
    if (i0 < in_l) acc_seg<P>(acc0, WT, in_l, i0, 0, s.hu, HMAX, out_l);
    if (i1 < in_l) acc_seg<P>(acc1, WT, in_l, i1, 0, s.hu, HMAX, out_l);
    __syncthreads();
    const int n_h = (l == 0) ? 0 : (skip ? in_l - es : in_l);
    const float sc = skip ? kInvSqrt2 : 1.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = h == 0 ? i0 : i1;
      if (i < in_l) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          float v = (h == 0 ? acc0[p] : acc1[p]) * sc;
          if (i < n_h) {
            float g = (l > 0) ? gate[l > 0 ? l - 1 : 0][p] : 1.f;
            s.hu[p * HMAX + i] = opnd<RB>(v * g);
            if (SAVE && base + p < n) {
              sv.a[l > 0 ? l - 1 : 0][(size_t)(base + p) * n_h + i] = v;
              sv.ag[l > 0 ? l - 1 : 0][(size_t)(base + p) * n_h + i] = opnd<RB>(v * g);
            }
          } else {
            s.aE[p * es + (i - n_h)] += v;
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- grad_c ---------------------------------------------------------------
  if (tid < P * 3) {
    int p = tid / 3, mm = tid - p * 3;
    float g = 0.f;
    for (int c = 0; c < es; ++c) {
      int dim, kind; float sc;
      enc_col(c, 3, dim, kind, sc);
      if (dim == mm) g += opnd<RB>(s.aE[p * es + c] * s.g1[p * es + c]) * sc;
    }
    s.gc[p * 4 + mm] = g;
  }
  __syncthreads();
}

// ---- colour: [enc(x_c), grad_c, enc(d_c), feat] -> rgb in s.aE[p * 4 + c] --
// Reads s.xc, s.gc, s.d (d_c) and the feature section of s.cin.
template <bool RB, bool SAVE>
__device__ __forceinline__ void field_color(const float* __restrict__ wts, const Model& m,
                                            const FieldTile& s, int tid, long long base,
                                            long long n, const FieldScratch& sv) {
  const int P = P_FIELD;
  {
    const int ci = m.ci, cp = m.cp, cr = m.cr;
    for (int idx = tid; idx < P * (cp + 3 + cr); idx += NT) {
      int p = idx / (cp + 3 + cr), c = idx - p * (cp + 3 + cr);
      float val;
      if (c < cp) {
        int dim, kind; float sc;
        enc_col(c, 3, dim, kind, sc);
        float v = opnd<RB>(s.xc[p * 4 + dim]) * sc;
        val = kind == 0 ? v : (kind == 1 ? sinf(v) : cosf(v));
      } else if (c < cp + 3) {
        val = s.gc[p * 4 + (c - cp)];
      } else {
        int dim, kind; float sc;
        enc_col(c - cp - 3, 3, dim, kind, sc);
        float v = opnd<RB>(s.d[p * 4 + dim]) * sc;
        val = kind == 0 ? v : (kind == 1 ? sinf(v) : cosf(v));
      }
      s.cin[p * ci + c] = opnd<RB>(val);
    }
  }
  __syncthreads();

  const Net& C = m.color;
  const int L = C.n_layers;
  float rgb_acc[P];
  for (int l = 0; l < NL; ++l) {
    if (l >= L) break;
    const int n_out = C.out_dim[l];
    const bool skip = (C.skip_mask >> l) & 1;
    const bool last = (l == L - 1);
    const float* W = wts + C.w_off[l];
    if (SAVE) {
      const int n_h = l == 0 ? 0 : (skip ? C.in_dim[l] - m.ci : C.in_dim[l]);
      save_operands<1>(sv.xin[l], base, n, s.hu, n_h, s.cin, m.ci,
                       (l == 0 || skip) ? m.ci : 0, tid);
    }
    float acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = 0.f;
    if (tid < n_out) {
      if (l == 0) {
        acc_seg<P>(acc, W, n_out, tid, 0, s.cin, m.ci, m.ci);
      } else {
        int n_h = skip ? C.in_dim[l] - m.ci : C.in_dim[l];
        acc_seg<P>(acc, W, n_out, tid, 0, s.hu, HMAX, n_h);
        if (skip) acc_seg<P>(acc, W, n_out, tid, n_h, s.cin, m.ci, m.ci);
      }
    }
    __syncthreads();
    if (tid < n_out) {
      const float b = wts[C.b_off[l] + tid];
      const float sc = skip ? kInvSqrt2 : 1.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float z = acc[p] * sc + b;
        if (!last) s.hu[p * HMAX + tid] = opnd<RB>(fmaxf(z, 0.f));
        else rgb_acc[p] = sigmoidf_(z);
      }
    }
    __syncthreads();
  }
  // rgb lives in threads 0..2; stage through shared memory (s.aE is free)
  if (tid < 3) {
#pragma unroll
    for (int p = 0; p < P; ++p) s.aE[p * 4 + tid] = rgb_acc[p];
  }
  __syncthreads();
}

}  // namespace
