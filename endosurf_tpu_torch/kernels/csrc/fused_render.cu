// EndoSurf forward render for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel endosurf_tpu/kernels/fused_render.py
// (fused_render_rays, body _render_kernel): for every ray, stratified z on
// [near, far], SDF-guided upsampling rounds (fused_sampler._upsample_round),
// the full field evaluation at the section midpoints (fused_train.forward_math:
// deform MLP + 3 Jacobian tangent rows, SDF MLP + in-forward adjoint, colour
// MLP) and the NeuS composite.
//
// One host entry (fused_render_launch) launches a fixed sequence of kernels on
// the caller's stream; nothing else runs between them:
//   prep -> sdf sweep (n0 samples) -> [draw -> sdf sweep (k new) -> merge] x
//   (rounds - 1) -> draw -> merge -> field eval (all midpoints) -> composite.
// The sweep, draw and merge kernels and the rounds' host loop are in
// sdf_chain.cuh, shared with the upsample entry (fused_sampler.cu).
//
// What bounds it: the three 9x256 MLPs (about 0.6 GFLOP per ray). This first
// version is plain SIMT float32 FMA: a block of 256 threads owns a tile of
// points, thread j computes output neuron j for every point of the tile, the
// tile's activations live in shared memory (read as warp broadcasts) and the
// weights stream from L2 (each weight load feeds P points, 4P in the deform
// layers, which carry the three tangent streams beside the primal). The SDF
// adjoint needs every hidden layer's softplus' gate; thread j only ever
// needs the gates of its own neuron, so they stay in registers. Tensor cores
// (wgmma), TMA and bf16 storage are later work.
//
// Precision: with RB (round to bf16) every dot operand -- activations,
// encodings, tangent seeds, the adjoint -- is rounded to bf16 when it is
// written to shared memory, and the weights arrive pre-rounded; products
// accumulate in float32. This is the "default" mode of the JAX kernels. The
// upsampling sweeps and the final field evaluation take their modes
// separately, as render_rays_inference sets them.

#include "sdf_chain.cuh"

#define P_FIELD 8       // points per block, full field evaluation
#define OUT_STRIDE 8    // floats per point in the field output

namespace {

// rays [R, 9] -> ray buffer (o, d_z, d, t, near, far, a, b, c) + stratified z.
__global__ void prep_kernel(const float* __restrict__ rays, int R, int n0,
                            float* __restrict__ rb, float* __restrict__ zl) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float* ry = rays + (size_t)r * 9;
  float o[3] = {ry[0], ry[1], ry[2]};
  float d[3] = {ry[3], ry[4], ry[5]};
  float t = ry[8];
  float dz[3];
  float inv = d[2] + 1e-6f;
  for (int k = 0; k < 3; ++k) dz[k] = d[k] / inv;
  // ray_sphere_intersection(o, d) with radius 1
  float dd = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  float mid = -(d[0] * o[0] + d[1] * o[1] + d[2] * o[2]) / dd;
  float p0 = o[0] + mid * d[0], p1 = o[1] + mid * d[1], p2 = o[2] + mid * d[2];
  float tmp = 1.f - (p0 * p0 + p1 * p1 + p2 * p2);
  float half = sqrtf(fmaxf(tmp, 0.f)) / sqrtf(dd);
  float near = fmaxf(mid - half, 0.f);
  float far = mid + half;
  float* b = rb + (size_t)r * RB_STRIDE;
  for (int k = 0; k < 3; ++k) { b[k] = o[k]; b[3 + k] = dz[k]; b[6 + k] = d[k]; }
  b[9] = t; b[10] = near; b[11] = far;
  b[12] = o[0] * o[0] + o[1] * o[1] + o[2] * o[2];
  b[13] = o[0] * dz[0] + o[1] * dz[1] + o[2] * dz[2];
  b[14] = dz[0] * dz[0] + dz[1] * dz[1] + dz[2] * dz[2];
  b[15] = 0.f;
  float* z = zl + (size_t)r * KMAX;
  for (int j = 0; j < n0; ++j) {
    float frac = (float)j / (float)(n0 - 1);
    z[j] = near * (1.f - frac) + far * frac;
  }
}

// NeuS composite over the K midpoints -> out [R, 9]: rgb, depth, normal, acc, max w.
__global__ void composite_kernel(int R, int K, float sample_dist,
                                 const float* __restrict__ zl,
                                 const float* __restrict__ pt, const float* __restrict__ scal,
                                 float* __restrict__ out) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float anneal = scal[0], s_inv = scal[1];
  const float* z = zl + (size_t)r * KMAX;
  float T = 1.f;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, dep = 0.f, n0 = 0.f, n1 = 0.f, n2 = 0.f;
  float acc = 0.f, wmax = 0.f;
  for (int j = 0; j < K; ++j) {
    float dist = (j < K - 1) ? z[j + 1] - z[j] : sample_dist;
    float mid = z[j] + dist * 0.5f;
    const float* q = pt + ((size_t)r * K + j) * OUT_STRIDE;
    float sdf = q[0], tc = q[7];
    float ic = -(fmaxf(-tc * 0.5f + 0.5f, 0.f) * (1.f - anneal) + fmaxf(-tc, 0.f) * anneal);
    float en = sdf + ic * dist * 0.5f;
    float ep = sdf - ic * dist * 0.5f;
    float pc = sigmoidf_(ep * s_inv);
    float nc = sigmoidf_(en * s_inv);
    float alpha = fminf(fmaxf((pc - nc + 1e-6f) / (pc + 1e-6f), 0.f), 1.f);
    float w = alpha * T;
    T *= (1.f - alpha + 1e-7f);
    c0 += w * q[1]; c1 += w * q[2]; c2 += w * q[3];
    dep += w * mid;
    n0 += w * q[4]; n1 += w * q[5]; n2 += w * q[6];
    acc += w;
    wmax = fmaxf(wmax, w);
  }
  float* o = out + (size_t)r * 9;
  o[0] = c0; o[1] = c1; o[2] = c2; o[3] = dep;
  o[4] = n0; o[5] = n1; o[6] = n2; o[7] = acc; o[8] = wmax;
}

// ---------------------------------------------------------------------------
// Full field evaluation at the section midpoints (fused_train.forward_math).
// Skips scale after the dot. Output per point: sdf, rgb, grad_o, d . grad_o.
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t field_smem_floats(const Model& m) {
  return (size_t)P_FIELD * (4 * 4 + 9 + 4 * HMAX + 4 * m.ed + 3 * m.es + m.ci + 1);
}

template <bool RB>
__global__ void __launch_bounds__(NT, 2)
field_kernel(const float* __restrict__ wts, Model m, int R, int K, float sample_dist,
             const float* __restrict__ rb, const float* __restrict__ zl,
             float* __restrict__ pt) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int P = P_FIELD;
  float* s_x = smem;                  // [P][4] x, t
  float* s_d = s_x + 4 * P;           // [P][4] raw view direction
  float* s_xc = s_d + 4 * P;          // [P][4] canonical point
  float* s_gc = s_xc + 4 * P;         // [P][4] grad_c
  float* s_J = s_gc + 4 * P;          // [P][9] J[k][m] = d x_c[m] / d x[k]
  float* s_hu = s_J + 9 * P;          // [4][P][HMAX] primal + tangents / adjoint / colour h
  float* s_e4 = s_hu + 4 * P * HMAX;  // [4][P][ed] deform encoding + tangent seeds
  float* s_es = s_e4 + 4 * P * m.ed;  // [P][es] sdf encoding (operand)
  float* s_g1 = s_es + P * m.es;      // [P][es] encoding derivative
  float* s_aE = s_g1 + P * m.es;      // [P][es] adjoint on the encoding
  float* s_cin = s_aE + P * m.es;     // [P][ci] colour input
  float* s_sdf = s_cin + P * m.ci;    // [P]

  const long long base = (long long)blockIdx.x * P;
  const long long n_pts = (long long)R * K;
  if (tid < P) {
    long long i = base + tid;
    float x[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f}, t = 0.f;
    if (i < n_pts) {
      int r = (int)(i / K), j = (int)(i % K);
      const float* b = rb + (size_t)r * RB_STRIDE;
      const float* z = zl + (size_t)r * KMAX;
      float dist = (j < K - 1) ? z[j + 1] - z[j] : sample_dist;
      float mid = z[j] + dist * 0.5f;
      for (int k = 0; k < 3; ++k) { x[k] = b[k] + mid * b[3 + k]; d[k] = b[6 + k]; }
      t = b[9];
    }
    for (int k = 0; k < 3; ++k) { s_x[tid * 4 + k] = x[k]; s_d[tid * 4 + k] = d[k]; }
    s_x[tid * 4 + 3] = t;
  }
  __syncthreads();

  // ---- deform + Jacobian tangents --------------------------------------
  if (m.use_deform) {
    const int ed = m.ed;
    const int ex = enc_width(3, m.f_dpos);
    for (int idx = tid; idx < P * ed; idx += NT) {
      int p = idx / ed, c = idx - p * ed;
      int dim, kind; float sc;
      if (c < ex) enc_col(c, 3, dim, kind, sc);
      else { enc_col(c - ex, 1, dim, kind, sc); dim = 3; }
      float v = opnd<RB>(s_x[p * 4 + dim]) * sc;
      float sv = sinf(v), cv = cosf(v);
      float e = kind == 0 ? v : (kind == 1 ? sv : cv);
      float g1 = kind == 0 ? 1.f : (kind == 1 ? cv : -sv);
      s_e4[p * ed + c] = opnd<RB>(e);
      for (int k = 0; k < 3; ++k)
        s_e4[(k + 1) * P * ed + p * ed + c] = opnd<RB>(dim == k ? sc * g1 : 0.f);
    }
    __syncthreads();
    const Net& N = m.deform;
    for (int l = 0; l < NL; ++l) {
      const int n_out = N.out_dim[l];
      const bool skip = (N.skip_mask >> l) & 1;
      const bool last = (l == NL - 1);
      const float* W = wts + N.w_off[l];
      float acc[4][P];
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int p = 0; p < P; ++p) acc[s][p] = 0.f;
      if (tid < n_out) {
        if (l == 0) {
          acc_seg_s<P, 4>(acc, W, n_out, tid, 0, s_e4, ed, P * ed, ed);
        } else {
          int n_h = skip ? N.in_dim[l] - ed : N.in_dim[l];
          acc_seg_s<P, 4>(acc, W, n_out, tid, 0, s_hu, HMAX, P * HMAX, n_h);
          if (skip) acc_seg_s<P, 4>(acc, W, n_out, tid, n_h, s_e4, ed, P * ed, ed);
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
            s_hu[p * HMAX + tid] = opnd<RB>(fmaxf(z, 0.f));
            for (int k = 0; k < 3; ++k)
              s_hu[(k + 1) * P * HMAX + p * HMAX + tid] = opnd<RB>(acc[k + 1][p] * sc * gate);
          } else if (tid < 3) {
            s_xc[p * 4 + tid] = s_x[p * 4 + tid] + z;
            for (int k = 0; k < 3; ++k)
              s_J[p * 9 + k * 3 + tid] = (k == tid ? 1.f : 0.f) + acc[k + 1][p] * sc;
          }
        }
      }
      __syncthreads();
    }
  } else {
    if (tid < P * 9) {
      int p = tid / 9, q = tid - p * 9;
      s_J[p * 9 + q] = (q / 3 == q % 3) ? 1.f : 0.f;
    }
    if (tid < P * 3) {
      int p = tid / 3, c = tid - p * 3;
      s_xc[p * 4 + c] = s_x[p * 4 + c];
    }
    __syncthreads();
  }

  // ---- SDF forward, gates kept in registers -----------------------------
  const int es = m.es;
  for (int idx = tid; idx < P * es; idx += NT) {
    int p = idx / es, c = idx - p * es;
    int dim, kind; float sc;
    enc_col(c, 3, dim, kind, sc);
    float v = opnd<RB>(s_xc[p * 4 + dim]) * sc;
    float sv = sinf(v), cv = cosf(v);
    s_es[p * es + c] = opnd<RB>(kind == 0 ? v : (kind == 1 ? sv : cv));
    s_g1[p * es + c] = kind == 0 ? 1.f : (kind == 1 ? cv : -sv);
    s_aE[p * es + c] = 0.f;
  }
  __syncthreads();

  const Net& S = m.sdf;
  float gate[NL - 1][P];
#pragma unroll
  for (int l = 0; l < NL - 1; ++l) {
    const int n_out = S.out_dim[l];
    const bool skip = (S.skip_mask >> l) & 1;
    const float* W = wts + S.w_off[l];
    float acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = 0.f;
    if (tid < n_out) {
      if (l == 0) {
        acc_seg<P>(acc, W, n_out, tid, 0, s_es, es, es);
      } else {
        int n_h = skip ? S.in_dim[l] - es : S.in_dim[l];
        acc_seg<P>(acc, W, n_out, tid, 0, s_hu, HMAX, n_h);
        if (skip) acc_seg<P>(acc, W, n_out, tid, n_h, s_es, es, es);
      }
    }
    __syncthreads();
    const float b = (tid < n_out) ? wts[S.b_off[l] + tid] : 0.f;
    const float sc = skip ? kInvSqrt2 : 1.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float z = acc[p] * sc + b;
      gate[l][p] = sigmoidf_(100.f * z);
      if (tid < n_out) s_hu[p * HMAX + tid] = opnd<RB>(softplus100(z));
    }
    __syncthreads();
  }

  // output layer: head (column 0) and feature (columns 1..F)
  {
    const int l = NL - 1;
    const int n_out = S.out_dim[l];
    const int n_in = S.in_dim[l];
    const float* W = wts + S.w_off[l];
    const int off_feat = m.cp + 3 + m.cr;
    if (tid < m.feat_dim) {
      float acc[P];
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] = 0.f;
      acc_seg<P>(acc, W, n_out, 1 + tid, 0, s_hu, HMAX, n_in);
      const float b = wts[S.b_off[l] + 1 + tid];
#pragma unroll
      for (int p = 0; p < P; ++p) s_cin[p * m.ci + off_feat + tid] = opnd<RB>(acc[p] + b);
    }
    if (tid < P) {
      float a = 0.f;
      for (int k = 0; k < n_in; ++k)
        a = fmaf(s_hu[tid * HMAX + k], __ldg(W + (size_t)k * n_out), a);
      s_sdf[tid] = a + wts[S.b_off[l]];
    }
    __syncthreads();
    // adjoint seed: head column gated by the last hidden layer
    if (tid < n_in) {
      const float hw = wts[m.head_off + tid];
#pragma unroll
      for (int p = 0; p < P; ++p) s_hu[p * HMAX + tid] = opnd<RB>(hw * gate[NL - 2][p]);
    }
    __syncthreads();
  }

  // ---- SDF adjoint: walk layers NL-2 .. 0 --------------------------------
#pragma unroll
  for (int l = NL - 2; l >= 0; --l) {
    const int in_l = S.in_dim[l];
    const int out_l = S.out_dim[l];
    const bool skip = (S.skip_mask >> l) & 1;
    const float* WT = wts + S.wt_off[l];
    float acc0[P], acc1[P];
#pragma unroll
    for (int p = 0; p < P; ++p) { acc0[p] = 0.f; acc1[p] = 0.f; }
    const int i0 = tid, i1 = tid + NT;
    if (i0 < in_l) acc_seg<P>(acc0, WT, in_l, i0, 0, s_hu, HMAX, out_l);
    if (i1 < in_l) acc_seg<P>(acc1, WT, in_l, i1, 0, s_hu, HMAX, out_l);
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
            s_hu[p * HMAX + i] = opnd<RB>(v * g);
          } else {
            s_aE[p * es + (i - n_h)] += v;
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- grad_c, coupling ---------------------------------------------------
  if (tid < P * 3) {
    int p = tid / 3, mm = tid - p * 3;
    float g = 0.f;
    for (int c = 0; c < es; ++c) {
      int dim, kind; float sc;
      enc_col(c, 3, dim, kind, sc);
      if (dim == mm) g += opnd<RB>(s_aE[p * es + c] * s_g1[p * es + c]) * sc;
    }
    s_gc[p * 4 + mm] = g;
  }
  __syncthreads();
  float go[3] = {0.f, 0.f, 0.f}, tc = 0.f;
  if (tid < P) {
    const int p = tid;
    const float* J = s_J + p * 9;
    const float* gc = s_gc + p * 4;
    const float* d = s_d + p * 4;
    float rv[3];
    for (int k = 0; k < 3; ++k) go[k] = J[k * 3 + 0] * gc[0] + J[k * 3 + 1] * gc[1] + J[k * 3 + 2] * gc[2];
    for (int c = 0; c < 3; ++c) rv[c] = d[0] * J[0 * 3 + c] + d[1] * J[1 * 3 + c] + d[2] * J[2 * 3 + c];
    float nr = sqrtf(rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2]);
    // d_c kept in s_d (the raw direction is no longer needed after tc)
    tc = d[0] * go[0] + d[1] * go[1] + d[2] * go[2];
    for (int c = 0; c < 3; ++c) s_d[p * 4 + c] = rv[c] / (nr + 1e-10f);
  }
  __syncthreads();

  // ---- colour input: [enc(x_c), grad_c, enc(d_c), feat] -------------------
  {
    const int ci = m.ci, cp = m.cp, cr = m.cr;
    for (int idx = tid; idx < P * (cp + 3 + cr); idx += NT) {
      int p = idx / (cp + 3 + cr), c = idx - p * (cp + 3 + cr);
      float val;
      if (c < cp) {
        int dim, kind; float sc;
        enc_col(c, 3, dim, kind, sc);
        float v = opnd<RB>(s_xc[p * 4 + dim]) * sc;
        val = kind == 0 ? v : (kind == 1 ? sinf(v) : cosf(v));
      } else if (c < cp + 3) {
        val = s_gc[p * 4 + (c - cp)];
      } else {
        int dim, kind; float sc;
        enc_col(c - cp - 3, 3, dim, kind, sc);
        float v = opnd<RB>(s_d[p * 4 + dim]) * sc;
        val = kind == 0 ? v : (kind == 1 ? sinf(v) : cosf(v));
      }
      s_cin[p * ci + c] = opnd<RB>(val);
    }
  }
  __syncthreads();

  // ---- colour MLP ---------------------------------------------------------
  const Net& C = m.color;
  float rgb_acc[P];
  for (int l = 0; l < NL; ++l) {
    const int n_out = C.out_dim[l];
    const bool skip = (C.skip_mask >> l) & 1;
    const bool last = (l == NL - 1);
    const float* W = wts + C.w_off[l];
    float acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = 0.f;
    if (tid < n_out) {
      if (l == 0) {
        acc_seg<P>(acc, W, n_out, tid, 0, s_cin, m.ci, m.ci);
      } else {
        int n_h = skip ? C.in_dim[l] - m.ci : C.in_dim[l];
        acc_seg<P>(acc, W, n_out, tid, 0, s_hu, HMAX, n_h);
        if (skip) acc_seg<P>(acc, W, n_out, tid, n_h, s_cin, m.ci, m.ci);
      }
    }
    __syncthreads();
    if (tid < n_out) {
      const float b = wts[C.b_off[l] + tid];
      const float sc = skip ? kInvSqrt2 : 1.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float z = acc[p] * sc + b;
        if (!last) s_hu[p * HMAX + tid] = opnd<RB>(fmaxf(z, 0.f));
        else rgb_acc[p] = sigmoidf_(z);
      }
    }
    __syncthreads();
  }
  // rgb lives in threads 0..2; stage through shared memory (s_aE is free)
  if (tid < 3) {
#pragma unroll
    for (int p = 0; p < P; ++p) s_aE[p * 4 + tid] = rgb_acc[p];
  }
  __syncthreads();
  if (tid < P) {
    long long i = base + tid;
    if (i < n_pts) {
      float* q = pt + (size_t)i * OUT_STRIDE;
      q[0] = s_sdf[tid];
      q[1] = s_aE[tid * 4 + 0]; q[2] = s_aE[tid * 4 + 1]; q[3] = s_aE[tid * 4 + 2];
      q[4] = go[0]; q[5] = go[1]; q[6] = go[2];
      q[7] = tc;
    }
  }
}

template <bool RB>
cudaError_t launch_field(const float* w, const Model& m, int R, int K, float sample_dist,
                         const float* rb, const float* zl, float* pt, cudaStream_t st) {
  size_t smem = field_smem_floats(m) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(field_kernel<RB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  long long n = (long long)R * K;
  int blocks = (int)((n + P_FIELD - 1) / P_FIELD);
  field_kernel<RB><<<blocks, NT, smem, st>>>(w, m, R, K, sample_dist, rb, zl, pt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch the caller must allocate for R rays.
long long fused_render_scratch_floats(int R) {
  return (long long)R * (RB_STRIDE + 2 * KMAX + 2 * KNEW_MAX + KMAX * OUT_STRIDE);
}

int fused_render_meta_len() { return META_LEN; }

const char* fused_render_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// rays [R, 9]; w_samp / w_main packed weights for the sampling / main
// precision (same layout, described by meta); scal [2] = (anneal, inv_s) on
// the device; out [R, 9]. Runs on the calling thread's current device, which
// the caller sets to the tensors' device. Returns a cudaError_t (0 on success).
int fused_render_launch(const float* rays, int R, const float* w_samp,
                        const float* w_main, const long long* meta, int rb_samp,
                        int rb_main, int n0, int k_new, int n_rounds, float sample_dist,
                        const float* scal, float* scratch, float* out, void* stream) {
  if (R <= 0) return 0;
  cudaError_t e;
  cudaStream_t st = (cudaStream_t)stream;
  const Model m = decode_model(meta);
  float* rb = scratch;
  float* zl = rb + (size_t)R * RB_STRIDE;
  float* sl = zl + (size_t)R * KMAX;
  float* zn = sl + (size_t)R * KMAX;
  float* sn = zn + (size_t)R * KNEW_MAX;
  float* pt = sn + (size_t)R * KNEW_MAX;
  const int n_final = n0 + k_new * n_rounds;
  const int tpb = 128;
  const int rblocks = (R + tpb - 1) / tpb;

  prep_kernel<<<rblocks, tpb, 0, st>>>(rays, R, n0, rb, zl);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  e = run_upsample_rounds(w_samp, m, rb_samp != 0, R, n0, k_new, n_rounds, false, rb, zl, sl,
                          zn, sn, st);
  if (e != cudaSuccess) return (int)e;
  e = rb_main ? launch_field<true>(w_main, m, R, n_final, sample_dist, rb, zl, pt, st)
              : launch_field<false>(w_main, m, R, n_final, sample_dist, rb, zl, pt, st);
  if (e != cudaSuccess) return (int)e;
  composite_kernel<<<rblocks, tpb, 0, st>>>(R, n_final, sample_dist, zl, pt, scal, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
