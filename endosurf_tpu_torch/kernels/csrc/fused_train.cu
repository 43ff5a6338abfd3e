// EndoSurf train-step field segments for NVIDIA Hopper (sm_90a), CUDA C++:
// forward and backward of the three segments of the field megakernel.
//
// Replaces the Pallas TPU kernels of endosurf_tpu/kernels/fused_train_pallas.py
// (deform_fwd / deform_bwd, sdf_fwd / sdf_bwd, color_fwd / color_bwd, all run
// through _seg_pallas), which evaluate kernels/fused_train.py's segment math:
//
//   (x_c, jrows)        = deform(xt)              deform MLP + 3 Jacobian rows
//   (sdf, feat, grad_c) = sdf(x_c)                SDF MLP + in-forward adjoint
//   color               = color(x_c, grad_c, d_c, feat)
//
// Forward kernels: one block of NT threads per tile of P_FIELD points runs the
// per-point code of field_chain.cuh (the render kernel's) and writes the
// segment's outputs to global memory.
//
// Backward kernels: per tile, recompute the forward (field_chain.cuh with
// SAVE: every layer's dot operands, the SDF pre-activations and adjoint go to
// a global scratch), walk the layers backward and write the per-point input
// cotangents plus, per layer, the cotangent on its pre-activation. A weight
// gradient is then dW_l = A_l^T B_l over the point axis for each (operand,
// cotangent) pair: wgrad.cuh's fixed-order product (shared with the D-NeRF
// backward kernels) writes the packed gradient.
//   deform: four streams share each weight (primal + three tangents, no bias
//     on the tangents, gated by the primal's relu'); the cotangents arrive on
//     x_c and on the three rows; x gets none.
//   sdf: cotangents on sdf, feat and grad_c. grad_c = (aE * g'(v)) S^T, so
//     x_c gets a g'' term; the adjoint a <- (a W^T) * sigma is linear in the
//     weights, so its reverse adds a second product per hidden weight and,
//     through the gates, the second-order term dz += (da * a) * 100 s (1 - s).
//   color: relu MLP, sigmoid output; cotangents to x_c, grad_c, d_c, feat.
//
// Precision: with RB (the "default" mode) every dot operand is rounded to
// bf16 and products accumulate in float32, as the forward. The backward keeps
// the rounding PyTorch's autograd gives the plain version (ops/mlp.py dot:
// x.to(bf16).to(f32)): the cotangent leaving each dot for its input is
// rounded to bf16, and so is each dot's weight gradient, summed over all
// points before it is rounded (one rounding per dot; a weight used by two
// dots, as the deform primal and tangents or the SDF primal and adjoint, gets
// the sum of two rounded gradients). Biases and the adjoint seed's head
// column are never rounded.
//
// What bounds it: the MLP products, about 1.9 TFLOP per 65,536-point train
// step with the recompute (chip_smoke.py counts them from the shapes). The
// kernels below are SIMT float32 FMA, far below the bf16 tensor-core rate;
// the scratch (the per-layer operands and cotangents, 4.0 GiB float32 for the
// deform net at 65,536 points) is written once and read once by the product.
// In the bf16 mode all six kernels run on tensor cores instead (field_tc.cuh:
// tile products on mma.sync, a bf16 scratch where the values are bf16,
// wgrad_tc.cuh's weight-gradient product); the float32 mode stays SIMT.
// The backward recomputes the forward rather than reading a scratch the
// forward stored: on an H100 the forward kernels are 30 of the segments'
// 160 ms a step, and storing would hold 8.3 GiB from forward to backward.

#include "field_chain.cuh"
#include "field_tc.cuh"
#include "wgrad.cuh"

namespace {

// ---------------------------------------------------------------------------
// forward kernels
// ---------------------------------------------------------------------------

// rows [n][w] of src -> dst[p * ld + c] for the tile (zeros past n)
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* __restrict__ src,
                                          int w, long long base, long long n, int tid) {
  for (int idx = tid; idx < P_FIELD * w; idx += NT) {
    const int p = idx / w, c = idx - p * w;
    dst[p * ld + c] = base + p < n ? src[(size_t)(base + p) * w + c] : 0.f;
  }
}

// tile -> rows [n][w] of dst (rows past n skipped)
__device__ __forceinline__ void store_rows(float* __restrict__ dst, int w, const float* src,
                                           int ld, long long base, long long n, int tid) {
  for (int idx = tid; idx < P_FIELD * w; idx += NT) {
    const int p = idx / w, c = idx - p * w;
    if (base + p < n) dst[(size_t)(base + p) * w + c] = src[p * ld + c];
  }
}

// xt [n][4] -> x_c [n][3], jrows [n][3][3] (row k = d x_c / d x_k)
template <bool RB>
__global__ void __launch_bounds__(NT, 2)
deform_fwd_kernel(const float* __restrict__ wts, Model m, long long n,
                  const float* __restrict__ xt, float* __restrict__ xc,
                  float* __restrict__ jrows) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const FieldTile s = field_tile(smem, m);
  const long long base = (long long)blockIdx.x * P_FIELD;
  load_rows(s.x, 4, xt, 4, base, n, tid);
  __syncthreads();
  field_deform<RB, false>(wts, m, s, tid, base, n, FieldScratch{});
  store_rows(xc, 3, s.xc, 4, base, n, tid);
  store_rows(jrows, 9, s.J, 9, base, n, tid);
}

// x_c [n][3] -> sdf [n], feat [n][F], grad_c [n][3]
template <bool RB>
__global__ void __launch_bounds__(NT, 2)
sdf_fwd_kernel(const float* __restrict__ wts, Model m, long long n,
               const float* __restrict__ xc, float* __restrict__ sdf,
               float* __restrict__ feat, float* __restrict__ gc) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const FieldTile s = field_tile(smem, m);
  const long long base = (long long)blockIdx.x * P_FIELD;
  load_rows(s.xc, 4, xc, 3, base, n, tid);
  __syncthreads();
  field_sdf<RB, false, true>(wts, m, s, tid, base, n, FieldScratch{}, feat);
  store_rows(sdf, 1, s.sdf, 1, base, n, tid);
  store_rows(gc, 3, s.gc, 4, base, n, tid);
}

// the colour input of one tile: x_c, grad_c, d_c into the tile, feat into
// its section of the colour input (a dot operand)
template <bool RB>
__device__ __forceinline__ void load_color_inputs(const FieldTile& s, const Model& m,
                                                  const float* __restrict__ xc,
                                                  const float* __restrict__ gc,
                                                  const float* __restrict__ dc,
                                                  const float* __restrict__ feat,
                                                  long long base, long long n, int tid) {
  load_rows(s.xc, 4, xc, 3, base, n, tid);
  load_rows(s.gc, 4, gc, 3, base, n, tid);
  load_rows(s.d, 4, dc, 3, base, n, tid);
  const int off = m.cp + 3 + m.cr, F = m.feat_dim;
  for (int idx = tid; idx < P_FIELD * F; idx += NT) {
    const int p = idx / F, f = idx - p * F;
    s.cin[p * m.ci + off + f] = base + p < n ? opnd<RB>(feat[(size_t)(base + p) * F + f]) : 0.f;
  }
}

// (x_c, grad_c, d_c [n][3], feat [n][F]) -> color [n][3]
template <bool RB>
__global__ void __launch_bounds__(NT, 2)
color_fwd_kernel(const float* __restrict__ wts, Model m, long long n,
                 const float* __restrict__ xc, const float* __restrict__ gc,
                 const float* __restrict__ dc, const float* __restrict__ feat,
                 float* __restrict__ color) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const FieldTile s = field_tile(smem, m);
  const long long base = (long long)blockIdx.x * P_FIELD;
  load_color_inputs<RB>(s, m, xc, gc, dc, feat, base, n, tid);
  __syncthreads();
  field_color<RB, false>(wts, m, s, tid, base, n, FieldScratch{});
  store_rows(color, 3, s.aE, 4, base, n, tid);
}

// ---------------------------------------------------------------------------
// backward kernels
// ---------------------------------------------------------------------------

// Cotangents on x_c [n][3] and the rows [n][3][3] -> the deform net's
// pre-activation cotangents (sv.dz, 4 streams) for the weight gradients.
template <bool RB>
__global__ void __launch_bounds__(NT, 2)
deform_bwd_kernel(const float* __restrict__ wts, Model m, long long n,
                  const float* __restrict__ xt, const float* __restrict__ g_xc,
                  const float* __restrict__ g_j, const __grid_constant__ FieldScratch sv) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int P = P_FIELD;
  const FieldTile s = field_tile(smem, m);
  const long long base = (long long)blockIdx.x * P;
  load_rows(s.x, 4, xt, 4, base, n, tid);
  __syncthreads();
  field_deform<RB, true>(wts, m, s, tid, base, n, sv);

  float* dz = s.hu;   // [4][P][HMAX]: primal, then the three tangent streams
  load_rows(dz, HMAX, g_xc, 3, base, n, tid);
  for (int k = 0; k < 3; ++k) {
    for (int idx = tid; idx < P * 3; idx += NT) {
      const int p = idx / 3, c = idx - p * 3;
      dz[(k + 1) * P * HMAX + p * HMAX + c] =
          base + p < n ? g_j[(size_t)(base + p) * 9 + k * 3 + c] : 0.f;
    }
  }
  __syncthreads();
  const Net& N = m.deform;
  for (int l = N.n_layers - 1; l >= 0; --l) {
    const int out_l = N.out_dim[l], in_l = N.in_dim[l];
    const bool skip = (N.skip_mask >> l) & 1;
    save_operands<4>(sv.dz[l], base, n, dz, out_l, dz, HMAX, 0, tid);
    if (l == 0) break;
    const int n_h = skip ? in_l - m.ed : in_l;
    const float sc = skip ? kInvSqrt2 : 1.f;
    const float* WT = wts + N.wt_off[l];
    float acc[4][P];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int p = 0; p < P; ++p) acc[q][p] = 0.f;
    if (tid < n_h) acc_seg_s<P, 4>(acc, WT, in_l, tid, 0, dz, HMAX, P * HMAX, out_l);
    __syncthreads();
    if (tid < n_h) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        // relu' of layer l-1 from its saved (primal) output, the h part of xin[l]
        const bool on = base + p < n && sv.xin[l][(size_t)(base + p) * in_l + tid] > 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dz[q * P * HMAX + p * HMAX + tid] = on ? opnd<RB>(acc[q][p] * sc) : 0.f;
      }
    }
    __syncthreads();
  }
}

__host__ __device__ inline size_t sdf_bwd_extra_floats(const Model& m) {
  return (size_t)P_FIELD * (3 * m.es + 1 + m.feat_dim);
}

// Cotangents on sdf [n], feat [n][F], grad_c [n][3] -> d x_c [n][3] and the
// SDF net's pre-activation / adjoint cotangents for the weight gradients.
template <bool RB>
__global__ void __launch_bounds__(NT, 2)
sdf_bwd_kernel(const float* __restrict__ wts, Model m, long long n,
               const float* __restrict__ xc, const float* __restrict__ g_sdf,
               const float* __restrict__ g_feat, const float* __restrict__ g_gc,
               float* __restrict__ dxc, const __grid_constant__ FieldScratch sv) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int P = P_FIELD;
  const int es = m.es, F = m.feat_dim, G = 1 + F;
  const FieldTile s = field_tile(smem, m);
  const long long base = (long long)blockIdx.x * P;
  load_rows(s.xc, 4, xc, 3, base, n, tid);
  __syncthreads();
  field_sdf<RB, true, false>(wts, m, s, tid, base, n, sv, nullptr);

  float* cur = s.hu;                   // [P][HMAX] cotangent on z_l (primal walk)
  float* s_da = s.hu + P * HMAX;       // [P][HMAX] cotangent on a_l (adjoint walk)
  float* nxt = s.hu + 2 * P * HMAX;    // [P][HMAX]
  float* s_daE = smem + field_smem_floats(m);   // [P][es] cotangent on aE
  float* s_dv2 = s_daE + P * es;       // [P][es] d v through g'(v) (the g'' term)
  float* s_de = s_dv2 + P * es;        // [P][es] cotangent on the encoding
  float* s_gout = s_de + P * es;       // [P][1 + F] cotangents on sdf, feat

  // grad_c = sum_c op(aE_c g'(v_c)) scale_c over the columns of each dim
  for (int idx = tid; idx < P * es; idx += NT) {
    const int p = idx / es, c = idx - p * es;
    int dim, kind; float sc;
    enc_col(c, 3, dim, kind, sc);
    const float dP = base + p < n ? opnd<RB>(g_gc[(size_t)(base + p) * 3 + dim] * sc) : 0.f;
    s_daE[p * es + c] = dP * s.g1[p * es + c];
    const float v = opnd<RB>(s.xc[p * 4 + dim]) * sc;
    const float g2 = kind == 0 ? 0.f : (kind == 1 ? -sinf(v) : -cosf(v));
    s_dv2[p * es + c] = dP * s.aE[p * es + c] * g2;
    s_de[p * es + c] = 0.f;
  }
  for (int idx = tid; idx < P * G; idx += NT) {
    const int p = idx / G, f = idx - p * G;
    float g = 0.f;
    if (base + p < n) g = f == 0 ? g_sdf[base + p] : g_feat[(size_t)(base + p) * F + f - 1];
    s_gout[p * G + f] = g;
  }
  __syncthreads();
  const Net& S = m.sdf;
  const int L = S.n_layers;
  save_operands<1>(sv.dz[L - 1], base, n, s_gout, 0, s_gout, G, G, tid);

  // ---- adjoint walk reversed: layers 0 .. L-2 ------------------------------
  for (int l = 0; l < L - 1; ++l) {
    const int in_l = S.in_dim[l], out_l = S.out_dim[l];
    const bool skip = (S.skip_mask >> l) & 1;
    const bool sec = l == 0 || skip;
    const int n_h = l == 0 ? 0 : (skip ? in_l - es : in_l);
    const float sc = skip ? kInvSqrt2 : 1.f;
    const float* W = wts + S.w_off[l];
    save_operands<1>(sv.da[l], base, n, s_da, n_h, s_daE, es, sec ? es : 0, tid);
    float acc[P], acc2[P];
#pragma unroll
    for (int p = 0; p < P; ++p) { acc[p] = 0.f; acc2[p] = 0.f; }
    if (tid < out_l) {
      if (n_h) acc_seg<P>(acc, W, out_l, tid, 0, s_da, HMAX, n_h);
      if (sec) acc_seg<P>(acc2, W, out_l, tid, n_h, s_daE, es, es);
    }
    __syncthreads();
    if (tid < out_l) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (base + p >= n) { s_da[p * HMAX + tid] = 0.f; continue; }
        const size_t row = (size_t)(base + p) * out_l + tid;
        const float dag = (n_h ? opnd<RB>(acc[p] * sc) : 0.f)
                          + (sec ? opnd<RB>(acc2[p] * sc) : 0.f);
        const float sig = sigmoidf_(100.f * sv.z[l][row]);
        s_da[p * HMAX + tid] = dag * sig;
        sv.dz[l][row] = dag * sv.a[l][row] * 100.f * sig * (1.f - sig);
        if (l == L - 2) sv.dhead[row] = dag * sig;
      }
    }
    __syncthreads();
  }

  // ---- primal walk: head + feature, then layers L-2 .. 0 -------------------
  {
    const int l = L - 1;
    const int n_in = S.in_dim[l];
    const float* WT = wts + S.wt_off[l];     // [1 + F][n_in]
    if (tid < n_in) {
      float acc_h[P], acc_f[P];
#pragma unroll
      for (int p = 0; p < P; ++p) { acc_h[p] = 0.f; acc_f[p] = 0.f; }
      acc_seg<P>(acc_h, WT, n_in, tid, 0, s_gout, G, 1);
      acc_seg<P>(acc_f, WT, n_in, tid, 1, s_gout + 1, G, F);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float dz = 0.f;
        if (base + p < n) {
          const size_t row = (size_t)(base + p) * n_in + tid;
          const float sig = sigmoidf_(100.f * sv.z[l - 1][row]);
          dz = (opnd<RB>(acc_h[p]) + opnd<RB>(acc_f[p])) * sig + sv.dz[l - 1][row];
          sv.dz[l - 1][row] = dz;
        }
        cur[p * HMAX + tid] = dz;
      }
    }
    __syncthreads();
  }
  for (int l = L - 2; l >= 0; --l) {
    const int in_l = S.in_dim[l], out_l = S.out_dim[l];
    const bool skip = (S.skip_mask >> l) & 1;
    const int n_h = l == 0 ? 0 : (skip ? in_l - es : in_l);
    const float sc = skip ? kInvSqrt2 : 1.f;
    const float* WT = wts + S.wt_off[l];
    for (int i = tid; i < in_l; i += NT) {
      float acc[P];
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] = 0.f;
      acc_seg<P>(acc, WT, in_l, i, 0, cur, HMAX, out_l);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float v = opnd<RB>(acc[p] * sc);
        if (i < n_h) {
          float dz = 0.f;
          if (base + p < n) {
            const size_t row = (size_t)(base + p) * n_h + i;
            const float sig = sigmoidf_(100.f * sv.z[l - 1][row]);
            dz = v * sig + sv.dz[l - 1][row];
            sv.dz[l - 1][row] = dz;
          }
          nxt[p * HMAX + i] = dz;
        } else {
          s_de[p * es + (i - n_h)] += v;
        }
      }
    }
    __syncthreads();
    float* t = cur; cur = nxt; nxt = t;
  }

  // ---- d x_c: through the encoding (g') and grad_c's g'' term --------------
  if (tid < P * 3) {
    const int p = tid / 3, mm = tid - p * 3;
    float g = 0.f;
    for (int c = 0; c < es; ++c) {
      int dim, kind; float sc;
      enc_col(c, 3, dim, kind, sc);
      if (dim == mm) g += (s_de[p * es + c] * s.g1[p * es + c] + s_dv2[p * es + c]) * sc;
    }
    if (base + p < n) dxc[(size_t)(base + p) * 3 + mm] = opnd<RB>(g);
  }
}

// Cotangent on color [n][3] -> d x_c, d grad_c, d d_c [n][3], d feat [n][F]
// and the colour net's pre-activation cotangents for the weight gradients.
template <bool RB>
__global__ void __launch_bounds__(NT, 2)
color_bwd_kernel(const float* __restrict__ wts, Model m, long long n,
                 const float* __restrict__ xc, const float* __restrict__ gc,
                 const float* __restrict__ dc, const float* __restrict__ feat,
                 const float* __restrict__ g_color, float* __restrict__ dxc,
                 float* __restrict__ dgc, float* __restrict__ ddc,
                 float* __restrict__ dfeat, const __grid_constant__ FieldScratch sv) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int P = P_FIELD;
  const int ci = m.ci, cp = m.cp, cr = m.cr, F = m.feat_dim;
  const FieldTile s = field_tile(smem, m);
  const long long base = (long long)blockIdx.x * P;
  load_color_inputs<RB>(s, m, xc, gc, dc, feat, base, n, tid);
  __syncthreads();
  field_color<RB, true>(wts, m, s, tid, base, n, sv);

  float* cur = s.hu;                // [P][HMAX] cotangent on z_l
  float* nxt = s.hu + P * HMAX;
  float* s_dcin = s.cin;            // [P][ci] cotangent on the colour input
  for (int idx = tid; idx < P * 3; idx += NT) {
    const int p = idx / 3, c = idx - p * 3;
    const float rgb = s.aE[p * 4 + c];
    cur[p * HMAX + c] = base + p < n ? g_color[(size_t)(base + p) * 3 + c] * rgb * (1.f - rgb)
                                     : 0.f;
  }
  for (int idx = tid; idx < P * ci; idx += NT) s_dcin[idx] = 0.f;
  __syncthreads();
  const Net& C = m.color;
#pragma unroll
  for (int l = NL - 1; l >= 0; --l) {   // unrolled to the ceiling, guarded by the depth
    if (l >= C.n_layers) continue;
    const int in_l = C.in_dim[l], out_l = C.out_dim[l];
    const bool skip = (C.skip_mask >> l) & 1;
    const int n_h = l == 0 ? 0 : (skip ? in_l - ci : in_l);
    const float sc = skip ? kInvSqrt2 : 1.f;
    const float* WT = wts + C.wt_off[l];
    save_operands<1>(sv.dz[l], base, n, cur, out_l, cur, HMAX, 0, tid);
    for (int i = tid; i < in_l; i += NT) {
      float acc[P];
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] = 0.f;
      acc_seg<P>(acc, WT, in_l, i, 0, cur, HMAX, out_l);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float v = opnd<RB>(acc[p] * sc);
        if (i < n_h) {
          const bool on = base + p < n && sv.xin[l][(size_t)(base + p) * in_l + i] > 0.f;
          nxt[p * HMAX + i] = on ? v : 0.f;
        } else {
          s_dcin[p * ci + (i - n_h)] += v;
        }
      }
    }
    __syncthreads();
    float* t = cur; cur = nxt; nxt = t;
  }

  // the sections of the colour input: [enc(x_c), grad_c, enc(d_c), feat]
  if (tid < P * 3) {
    const int p = tid / 3, mm = tid - p * 3;
    float gx = 0.f, gd = 0.f;
    for (int c = 0; c < cp; ++c) {
      int dim, kind; float sc;
      enc_col(c, 3, dim, kind, sc);
      if (dim != mm) continue;
      const float v = opnd<RB>(s.xc[p * 4 + mm]) * sc;
      gx += s_dcin[p * ci + c] * (kind == 0 ? 1.f : (kind == 1 ? cosf(v) : -sinf(v))) * sc;
    }
    for (int c = 0; c < cr; ++c) {
      int dim, kind; float sc;
      enc_col(c, 3, dim, kind, sc);
      if (dim != mm) continue;
      const float v = opnd<RB>(s.d[p * 4 + mm]) * sc;
      gd += s_dcin[p * ci + cp + 3 + c] * (kind == 0 ? 1.f : (kind == 1 ? cosf(v) : -sinf(v))) * sc;
    }
    if (base + p < n) {
      dxc[(size_t)(base + p) * 3 + mm] = opnd<RB>(gx);
      ddc[(size_t)(base + p) * 3 + mm] = opnd<RB>(gd);
      dgc[(size_t)(base + p) * 3 + mm] = s_dcin[p * ci + cp + mm];
    }
  }
  store_rows(dfeat, F, s_dcin + cp + 3 + cr, ci, base, n, tid);
}

// ---------------------------------------------------------------------------
// host side: scratch layout, weight-gradient jobs, launches
// ---------------------------------------------------------------------------

// Lays out the scratch of a segment's backward and its weight-gradient jobs
// (writing into grad at the packed weights' offsets). With null pointers it
// only counts: *scratch_floats, *partial_floats.
void plan_bwd(const Model& m, int seg, long long n, int rb, float* scratch, float* grad,
              FieldScratch& sv, WgJobs& jobs, long long* scratch_floats,
              long long* partial_floats) {
  Planner pl{scratch};
  sv = FieldScratch{};
  jobs.n_jobs = 0;
  jobs.n_blocks = 0;
  long long part = 0;
  const Net& N = seg == SEG_DEFORM ? m.deform : (seg == SEG_SDF ? m.sdf : m.color);
  const int streams = seg == SEG_DEFORM ? 4 : 1;
  const int L = N.n_layers;
  const int n_hidden = seg == SEG_SDF ? L - 1 : L;
  float* g = grad;
  for (int l = 0; l < L; ++l) {
    const int in_l = N.in_dim[l], out_l = N.out_dim[l];
    sv.xin[l] = pl.take(streams * n * in_l);
    sv.dz[l] = pl.take(streams * n * out_l);
    if (seg == SEG_SDF && l < n_hidden) {
      sv.z[l] = pl.take(n * out_l);
      sv.a[l] = pl.take(n * out_l);
      sv.ag[l] = pl.take(n * out_l);
      sv.da[l] = pl.take(n * in_l);
    }
  }
  if (seg == SEG_SDF) sv.dhead = pl.take(n * N.in_dim[L - 1]);
  for (int l = 0; l < L; ++l) {
    const int in_l = N.in_dim[l], out_l = N.out_dim[l];
    const float sc = ((N.skip_mask >> l) & 1) ? kInvSqrt2 : 1.f;
    float* dw = g ? g + N.w_off[l] : nullptr;
    float* db = g ? g + N.b_off[l] : nullptr;
    add_job(jobs, part, sv.xin[l], in_l, sv.dz[l], out_l, n, in_l, out_l, sc, rb, dw, out_l, 0);
    add_job(jobs, part, nullptr, 1, sv.dz[l], out_l, n, 1, out_l, 1.f, 0, db, out_l, 0);
    if (seg == SEG_DEFORM) {   // the three tangent streams, stacked on the point axis
      add_job(jobs, part, sv.xin[l] ? sv.xin[l] + n * in_l : nullptr, in_l,
              sv.dz[l] ? sv.dz[l] + n * out_l : nullptr, out_l, 3 * n, in_l, out_l, sc, rb, dw,
              out_l, 1);
    } else if (seg == SEG_SDF && l < n_hidden) {   // the adjoint's product W^T
      add_job(jobs, part, sv.da[l], in_l, sv.ag[l], out_l, n, in_l, out_l, sc, rb, dw, out_l, 1);
    } else if (seg == SEG_SDF) {                   // the adjoint seed: head column
      add_job(jobs, part, sv.dhead, in_l, nullptr, 1, n, in_l, 1, 1.f, 0, dw, out_l, 1);
    }
  }
  if (scratch_floats) *scratch_floats = pl.used;
  if (partial_floats) *partial_floats = part;
}

template <typename K>
cudaError_t prep_smem(K kernel, size_t floats) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(floats * sizeof(float)));
}

int tiles(long long n) { return (int)((n + P_FIELD - 1) / P_FIELD); }

}  // namespace

extern "C" {

// The floats of scratch and of partial sums a segment's backward needs for n
// points at the dot precision rb: out[0] scratch, out[1] partial.
void train_bwd_sizes(const long long* meta, int seg, int rb, int n, long long* out) {
  const Model m = decode_model(meta);
  if (rb) {
    TcScratch sv;
    TcJobs jobs;
    plan_bwd_tc(m, seg, n, nullptr, nullptr, sv, jobs, out, out + 1);
    return;
  }
  FieldScratch sv;
  WgJobs jobs;
  plan_bwd(m, seg, n, 0, nullptr, nullptr, sv, jobs, out, out + 1);
}

// Every entry: w packed weights (fused_train_cuda.pack_segment), meta its
// layout, rb 1 for the bf16-operand mode (then the packs carry the bf16
// fragment copies field_tc.cuh reads, and every forward and backward
// launches its tensor-core kernel); tensors float32, contiguous, on
// the current device; launches on stream. Returns a cudaError_t (0 on
// success).

int train_deform_fwd(const float* w, const long long* meta, int rb, int n, const float* xt,
                     float* xc, float* jrows, void* stream) {
  if (n <= 0) return 0;
  const Model m = decode_model(meta);
  cudaStream_t st = (cudaStream_t)stream;
  if (rb) return (int)launch_deform_fwd_tc(w, decode_frags(meta), m, n, xt, xc, jrows, st);
  const size_t smem = field_smem_floats(m);
  cudaError_t e;
  if ((e = prep_smem(deform_fwd_kernel<false>, smem)) != cudaSuccess) return (int)e;
  deform_fwd_kernel<false><<<tiles(n), NT, smem * 4, st>>>(w, m, n, xt, xc, jrows);
  return (int)cudaGetLastError();
}

// The floats of workspace train_sdf_fwd needs for n points at the dot
// precision rb (the tensor-core forward's pre-activations; none in float32).
long long train_sdf_fwd_work_floats(const long long* meta, int rb, int n) {
  if (!rb) return 0;
  TcScratch sv;
  return plan_sdf_fwd_tc(decode_model(meta), n, nullptr, sv);
}

// work: train_sdf_fwd_work_floats floats.
int train_sdf_fwd(const float* w, const long long* meta, int rb, int n, const float* xc,
                  float* sdf, float* feat, float* gc, float* work, void* stream) {
  if (n <= 0) return 0;
  const Model m = decode_model(meta);
  cudaStream_t st = (cudaStream_t)stream;
  if (rb) return (int)launch_sdf_fwd_tc(w, decode_frags(meta), m, n, xc, sdf, feat, gc, work, st);
  const size_t smem = field_smem_floats(m);
  cudaError_t e;
  if ((e = prep_smem(sdf_fwd_kernel<false>, smem)) != cudaSuccess) return (int)e;
  sdf_fwd_kernel<false><<<tiles(n), NT, smem * 4, st>>>(w, m, n, xc, sdf, feat, gc);
  return (int)cudaGetLastError();
}

int train_color_fwd(const float* w, const long long* meta, int rb, int n, const float* xc,
                    const float* gc, const float* dc, const float* feat, float* color,
                    void* stream) {
  if (n <= 0) return 0;
  const Model m = decode_model(meta);
  cudaStream_t st = (cudaStream_t)stream;
  if (rb)
    return (int)launch_color_fwd_tc(w, decode_frags(meta), m, n, xc, gc, dc, feat, color, 3, st);
  const size_t smem = field_smem_floats(m);
  cudaError_t e;
  if ((e = prep_smem(color_fwd_kernel<false>, smem)) != cudaSuccess) return (int)e;
  color_fwd_kernel<false><<<tiles(n), NT, smem * 4, st>>>(w, m, n, xc, gc, dc, feat, color);
  return (int)cudaGetLastError();
}

// scratch / partial of train_bwd_sizes floats; grad of the packed weights'
// size (dW and db land at their weights' offsets).
int train_deform_bwd(const float* w, const long long* meta, int rb, int n, const float* xt,
                     const float* g_xc, const float* g_j, float* scratch, float* partial,
                     float* grad, void* stream) {
  if (n <= 0) return 0;
  const Model m = decode_model(meta);
  cudaStream_t st = (cudaStream_t)stream;
  if (rb)
    return (int)launch_deform_bwd_tc(w, meta, m, n, xt, g_xc, g_j, scratch, partial, grad, st);
  FieldScratch sv;
  WgJobs jobs;
  plan_bwd(m, SEG_DEFORM, n, rb, scratch, grad, sv, jobs, nullptr, nullptr);
  const size_t smem = field_smem_floats(m);
  cudaError_t e;
  if ((e = prep_smem(deform_bwd_kernel<false>, smem)) != cudaSuccess) return (int)e;
  deform_bwd_kernel<false><<<tiles(n), NT, smem * 4, st>>>(w, m, n, xt, g_xc, g_j, sv);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return (int)run_wgrad(jobs, partial, st);
}

int train_sdf_bwd(const float* w, const long long* meta, int rb, int n, const float* xc,
                  const float* g_sdf, const float* g_feat, const float* g_gc, float* dxc,
                  float* scratch, float* partial, float* grad, void* stream) {
  if (n <= 0) return 0;
  const Model m = decode_model(meta);
  cudaStream_t st = (cudaStream_t)stream;
  if (rb)
    return (int)launch_sdf_bwd_tc(w, meta, m, n, xc, g_sdf, g_feat, g_gc, dxc, scratch, partial,
                                  grad, st);
  FieldScratch sv;
  WgJobs jobs;
  plan_bwd(m, SEG_SDF, n, rb, scratch, grad, sv, jobs, nullptr, nullptr);
  const size_t smem = field_smem_floats(m) + sdf_bwd_extra_floats(m);
  cudaError_t e;
  if ((e = prep_smem(sdf_bwd_kernel<false>, smem)) != cudaSuccess) return (int)e;
  sdf_bwd_kernel<false><<<tiles(n), NT, smem * 4, st>>>(w, m, n, xc, g_sdf, g_feat, g_gc, dxc,
                                                         sv);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return (int)run_wgrad(jobs, partial, st);
}

int train_color_bwd(const float* w, const long long* meta, int rb, int n, const float* xc,
                    const float* gc, const float* dc, const float* feat, const float* g_color,
                    float* dxc, float* dgc, float* ddc, float* dfeat, float* scratch,
                    float* partial, float* grad, void* stream) {
  if (n <= 0) return 0;
  const Model m = decode_model(meta);
  cudaStream_t st = (cudaStream_t)stream;
  if (rb)
    return (int)launch_color_bwd_tc(w, meta, m, n, xc, gc, dc, feat, g_color, dxc, dgc, ddc,
                                    dfeat, scratch, partial, grad, st);
  FieldScratch sv;
  WgJobs jobs;
  plan_bwd(m, SEG_COLOR, n, rb, scratch, grad, sv, jobs, nullptr, nullptr);
  const size_t smem = field_smem_floats(m);
  cudaError_t e;
  if ((e = prep_smem(color_bwd_kernel<false>, smem)) != cudaSuccess) return (int)e;
  color_bwd_kernel<false><<<tiles(n), NT, smem * 4, st>>>(w, m, n, xc, gc, dc, feat, g_color,
                                                           dxc, dgc, ddc, dfeat, sv);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return (int)run_wgrad(jobs, partial, st);
}

}  // extern "C"
