// The sampling chain observed point -> deform MLP -> x_c -> SDF MLP -> sdf
// (kernels/fused_sdf.py's chain: skips scale their input before the dot) as
// one sweep kernel over a point source, shared by the render, upsample, ray
// march (fused_render.cu, fused_sampler.cu) and observed-SDF query
// (fused_sdf.cu) entry points. A chain type picks the two nets' skip scale
// and the second net's activation: EndoSurfChain (1/sqrt(2), softplus100)
// or DNeRFChain (1, relu: deform -> density, whose head is the raw density;
// fused_density_raw and the D-NeRF render's coarse sweep). And the
// SDF-guided upsampling: NeuS
// importance weights with k deterministic inverse-CDF draws
// (fused_sampler._upsample_round), the stable sorted merge, and the host loop
// that runs the rounds on one stream.
//
// Everything sits in an anonymous namespace: each translation unit that
// includes this header gets its own copy, so the shared library that
// build.py links from all csrc/*.cu has no duplicate symbols.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define NL 9            // the most layers per MLP (a net has 2 .. NL: Net::n_layers)
#define HMAX 256        // widest hidden layer
#define NT 256          // threads per block of the MLP kernels
#define P_SWEEP 32      // points per block, sdf sweep
#define KMAX 64         // samples per ray after upsampling
#define KNEW_MAX 8      // new samples per upsampling round
#define RB_STRIDE 16    // floats per ray in the ray buffer
#define META_NET 47
#define META_LEN (8 + 3 * META_NET)

namespace {

const float kInvSqrt2 = 0.70710678118654752440f;

// The sampling chain of each field family: the skip scale of both nets and
// whether the second net's hidden activation is relu (else softplus100).
struct EndoSurfChain {
  static constexpr float kSkip = 0.70710678118654752440f;
  static constexpr bool kRelu2 = false;
};
struct DNeRFChain {
  static constexpr float kSkip = 1.f;
  static constexpr bool kRelu2 = true;
};

struct Net {
  int n_layers;
  int skip_mask;
  int in_dim[NL];
  int out_dim[NL];
  long long w_off[NL];    // W [in, out], row-major
  long long b_off[NL];
  long long wt_off[NL];   // W^T [out, in] (SDF hidden layers), else -1
};

struct Model {
  Net deform, sdf, color;
  int use_deform;
  int f_dpos, f_dtime, f_spos, f_cpos, f_cdir;
  int feat_dim;
  long long head_off;      // float32 (never rounded) SDF head column, the adjoint seed
  int ed, es, cp, cr, ci;  // encoding widths: deform, sdf, colour pos/dir, colour input
};

__host__ __device__ inline int enc_width(int d, int f) { return d * (1 + 2 * f); }

// Column c of a D-input frequency encoding: input dim, kind (0 id, 1 sin,
// 2 cos) and scale 2^f, in the order [x, sin(2^0 x), cos(2^0 x), ...].
__device__ __forceinline__ void enc_col(int c, int d, int& dim, int& kind, float& scale) {
  if (c < d) { dim = c; kind = 0; scale = 1.f; return; }
  int cc = c - d;
  int f = cc / (2 * d);
  int rem = cc - f * 2 * d;
  kind = rem < d ? 1 : 2;
  dim = rem < d ? rem : rem - d;
  scale = ldexpf(1.f, f);
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool RB>
__device__ __forceinline__ float opnd(float v) { return RB ? bf16r(v) : v; }

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float softplus100(float z) {
  float x = 100.f * z;
  return (fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)))) / 100.f;
}

// acc[p] += sum_k in[p*ld + k] * W[(row0 + k)*ldw + col]
template <int P>
__device__ __forceinline__ void acc_seg(float (&acc)[P], const float* __restrict__ W,
                                        int ldw, int col, int row0,
                                        const float* in, int ld, int n) {
  const float* wp = W + (size_t)row0 * ldw + col;
  for (int k = 0; k < n; ++k) {
    float w = __ldg(wp + (size_t)k * ldw);
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = fmaf(in[p * ld + k], w, acc[p]);
  }
}

// S streams that share the weights: stream s reads in + s*sstride.
template <int P, int S>
__device__ __forceinline__ void acc_seg_s(float (&acc)[S][P], const float* __restrict__ W,
                                          int ldw, int col, int row0,
                                          const float* in, int ld, int sstride, int n) {
  const float* wp = W + (size_t)row0 * ldw + col;
  for (int k = 0; k < n; ++k) {
    float w = __ldg(wp + (size_t)k * ldw);
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int p = 0; p < P; ++p)
        acc[s][p] = fmaf(in[s * sstride + p * ld + k], w, acc[s][p]);
  }
}

// ---------------------------------------------------------------------------
// per-ray kernels (one thread per ray)
// ---------------------------------------------------------------------------

// NeuS importance weights on the s current samples, then k deterministic
// inverse-CDF draws at u = (j + 0.5) / k.
__global__ void draw_kernel(int R, const float* __restrict__ rb,
                            const float* __restrict__ zl, const float* __restrict__ sl,
                            int s, int k, float inv_s, float* __restrict__ znew) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float* b = rb + (size_t)r * RB_STRIDE;
  const float* z = zl + (size_t)r * KMAX;
  const float* sd = sl + (size_t)r * KMAX;
  float ca = b[12], cb = b[13], cc = b[14];
  float cdf[KMAX];
  float T = 1.f, wsum = 0.f, prev_raw = 0.f;
  float z0 = z[0], s0 = sd[0];
  float r0 = sqrtf(fmaxf(ca + 2.f * cb * z0 + cc * z0 * z0, 0.f));
  for (int j = 0; j < s - 1; ++j) {
    float z1 = z[j + 1], s1 = sd[j + 1];
    float r1 = sqrtf(fmaxf(ca + 2.f * cb * z1 + cc * z1 * z1, 0.f));
    float mid = 0.5f * (s0 + s1);
    float cosv = (s1 - s0) / (z1 - z0 + 1e-6f);
    float pc = (j == 0) ? 0.f : prev_raw;
    prev_raw = cosv;
    cosv = fminf(cosv, pc);
    float inside = (r0 < 1.f || r1 < 1.f) ? 1.f : 0.f;
    cosv = fminf(fmaxf(cosv, -1e3f), 0.f) * inside;
    float dist = z1 - z0;
    float pe = mid - cosv * dist * 0.5f;
    float ne = mid + cosv * dist * 0.5f;
    float pcdf = sigmoidf_(pe * inv_s);
    float ncdf = sigmoidf_(ne * inv_s);
    float alpha = (pcdf - ncdf + 1e-6f) / (pcdf + 1e-6f);
    float w = alpha * T + 1e-5f;
    T *= (1.f - alpha + 1e-7f);
    cdf[j + 1] = w;      // pdf numerators for now
    wsum += w;
    z0 = z1; s0 = s1; r0 = r1;
  }
  cdf[0] = 0.f;
  float run = 0.f;
  for (int j = 1; j < s; ++j) { run += cdf[j] / wsum; cdf[j] = run; }
  float* out = znew + (size_t)r * KNEW_MAX;
  for (int n = 0; n < k; ++n) {
    float u = ((float)n + 0.5f) / (float)k;
    int inds = 0;
    for (int m = 0; m < s; ++m) inds += (cdf[m] <= u) ? 1 : 0;
    int below = max(inds - 1, 0);
    int above = min(inds, s - 1);
    float denom = cdf[above] - cdf[below];
    if (denom < 1e-5f) denom = 1.f;
    float tt = (u - cdf[below]) / denom;
    out[n] = z[below] + tt * (z[above] - z[below]);
  }
}

// Stable insertion of k new (z, sdf) into the sorted list of length s.
__global__ void merge_kernel(int R, float* __restrict__ zl, float* __restrict__ sl, int s,
                             const float* __restrict__ znew, const float* __restrict__ snew,
                             int k) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float* z = zl + (size_t)r * KMAX;
  float* sd = sl + (size_t)r * KMAX;
  for (int n = 0; n < k; ++n) {
    float zn = znew[(size_t)r * KNEW_MAX + n];
    float sn = snew ? snew[(size_t)r * KNEW_MAX + n] : 0.f;
    int pos = s + n;
    while (pos > 0 && z[pos - 1] > zn) {
      z[pos] = z[pos - 1];
      sd[pos] = sd[pos - 1];
      --pos;
    }
    z[pos] = zn;
    sd[pos] = sn;
  }
}

// ---------------------------------------------------------------------------
// SDF sweep: observed point -> sdf (deform -> x_c -> SDF head), the sampling
// chain of kernels/fused_sdf.py. Skips scale their input before the dot.
// The points come from a source type (Src::n, load, store): samples along
// rays (RaySamples: the upsampling rounds and the ray march) or an explicit
// point list (PointList: the observed-SDF query).
// ---------------------------------------------------------------------------

// Point i = (ray i / K, sample i % K) at depth z[r * ldz + j] along the ray
// buffer's o + z d_z, time rb t; the sdf goes to dst[r * ldd + j].
struct RaySamples {
  const float* rb;
  const float* z;
  int ldz, K;
  float* dst;
  int ldd;
  long long n;
  __device__ void load(long long i, float& x0, float& x1, float& x2, float& t) const {
    int r = (int)(i / K), j = (int)(i % K);
    const float* b = rb + (size_t)r * RB_STRIDE;
    float zz = z[(size_t)r * ldz + j];
    x0 = b[0] + zz * b[3]; x1 = b[1] + zz * b[4]; x2 = b[2] + zz * b[5];
    t = b[9];
  }
  __device__ void store(long long i, float v) const {
    int r = (int)(i / K), j = (int)(i % K);
    dst[(size_t)r * ldd + j] = v;
  }
};

// Point i = x [n, 3], t [n, 1] (contiguous); the sdf goes to dst [n].
struct PointList {
  const float* x;
  const float* t;
  float* dst;
  long long n;
  __device__ void load(long long i, float& x0, float& x1, float& x2, float& tt) const {
    x0 = x[i * 3]; x1 = x[i * 3 + 1]; x2 = x[i * 3 + 2];
    tt = t[i];
  }
  __device__ void store(long long i, float v) const { dst[i] = v; }
};

__host__ __device__ inline size_t sweep_smem_floats(const Model& m) {
  int emax = m.ed > m.es ? m.ed : m.es;
  return (size_t)P_SWEEP * (4 + 4 + HMAX + 2 * emax);
}

template <bool RB, class C>
__device__ void sweep_mlp(const Net& N, const float* __restrict__ wts, bool relu_act,
                          float* s_h, const float* s_e0, const float* s_es, int ew,
                          int tid) {
  // layers 0 .. n-2 hidden; the output layer is handled by the caller
  for (int l = 0; l < N.n_layers - 1; ++l) {
    int n_out = N.out_dim[l];
    bool skip = (N.skip_mask >> l) & 1;
    bool next_skip = (N.skip_mask >> (l + 1)) & 1;
    const float* W = wts + N.w_off[l];
    float acc[P_SWEEP];
#pragma unroll
    for (int p = 0; p < P_SWEEP; ++p) acc[p] = 0.f;
    if (tid < n_out) {
      if (l == 0) {
        acc_seg<P_SWEEP>(acc, W, n_out, tid, 0, s_e0, ew, ew);
      } else {
        int n_h = skip ? N.in_dim[l] - ew : N.in_dim[l];
        acc_seg<P_SWEEP>(acc, W, n_out, tid, 0, s_h, HMAX, n_h);
        if (skip) acc_seg<P_SWEEP>(acc, W, n_out, tid, n_h, s_es, ew, ew);
      }
    }
    __syncthreads();
    if (tid < n_out) {
      float b = wts[N.b_off[l] + tid];
      float post = next_skip ? C::kSkip : 1.f;
#pragma unroll
      for (int p = 0; p < P_SWEEP; ++p) {
        float z = acc[p] + b;
        float h = relu_act ? fmaxf(z, 0.f) : softplus100(z);
        s_h[p * HMAX + tid] = opnd<RB>(h * post);
      }
    }
    __syncthreads();
  }
}

template <bool RB, class C, class Src>
__global__ void __launch_bounds__(NT, 2)
sweep_kernel(const float* __restrict__ wts, Model m, Src src) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int emax = m.ed > m.es ? m.ed : m.es;
  float* s_x = smem;                          // [P][4] x, t
  float* s_xc = s_x + 4 * P_SWEEP;            // [P][4]
  float* s_h = s_xc + 4 * P_SWEEP;            // [P][HMAX]
  float* s_e0 = s_h + P_SWEEP * HMAX;         // [P][emax] encoding (operand)
  float* s_es = s_e0 + P_SWEEP * emax;        // [P][emax] encoding * skip scale

  const long long base = (long long)blockIdx.x * P_SWEEP;
  if (tid < P_SWEEP) {
    long long i = base + tid;
    float x0 = 0.f, x1 = 0.f, x2 = 0.f, t = 0.f;
    if (i < src.n) src.load(i, x0, x1, x2, t);
    s_x[tid * 4 + 0] = x0; s_x[tid * 4 + 1] = x1; s_x[tid * 4 + 2] = x2;
    s_x[tid * 4 + 3] = t;
  }
  __syncthreads();

  if (m.use_deform) {
    const int ex = enc_width(3, m.f_dpos);
    for (int idx = tid; idx < P_SWEEP * m.ed; idx += NT) {
      int p = idx / m.ed, c = idx - p * m.ed;
      int dim, kind; float sc;
      if (c < ex) enc_col(c, 3, dim, kind, sc);
      else { enc_col(c - ex, 1, dim, kind, sc); dim = 3; }
      float v = s_x[p * 4 + dim] * sc;
      float e = kind == 0 ? v : (kind == 1 ? sinf(v) : cosf(v));
      s_e0[p * m.ed + c] = opnd<RB>(e);
      s_es[p * m.ed + c] = opnd<RB>(e * C::kSkip);
    }
    __syncthreads();
    sweep_mlp<RB, C>(m.deform, wts, true, s_h, s_e0, s_es, m.ed, tid);
    // output layer: dx (3 columns)
    const Net& N = m.deform;
    int l = N.n_layers - 1;
    if (tid < 3 * P_SWEEP) {
      int p = tid / 3, col = tid - p * 3;
      const float* W = wts + N.w_off[l];
      int n_out = N.out_dim[l];
      float a = 0.f;
      for (int k = 0; k < N.in_dim[l]; ++k)
        a = fmaf(s_h[p * HMAX + k], __ldg(W + (size_t)k * n_out + col), a);
      s_xc[p * 4 + col] = s_x[p * 4 + col] + a + wts[N.b_off[l] + col];
    }
  } else if (tid < 3 * P_SWEEP) {
    int p = tid / 3, col = tid - p * 3;
    s_xc[p * 4 + col] = s_x[p * 4 + col];
  }
  __syncthreads();

  for (int idx = tid; idx < P_SWEEP * m.es; idx += NT) {
    int p = idx / m.es, c = idx - p * m.es;
    int dim, kind; float sc;
    enc_col(c, 3, dim, kind, sc);
    float v = s_xc[p * 4 + dim] * sc;
    float e = kind == 0 ? v : (kind == 1 ? sinf(v) : cosf(v));
    s_e0[p * m.es + c] = opnd<RB>(e);
    s_es[p * m.es + c] = opnd<RB>(e * C::kSkip);
  }
  __syncthreads();
  sweep_mlp<RB, C>(m.sdf, wts, C::kRelu2, s_h, s_e0, s_es, m.es, tid);
  // head: column 0 of the SDF (D-NeRF: density) output layer
  if (tid < P_SWEEP) {
    const Net& N = m.sdf;
    int l = N.n_layers - 1;
    const float* W = wts + N.w_off[l];
    int n_out = N.out_dim[l];
    float a = 0.f;
    for (int k = 0; k < N.in_dim[l]; ++k)
      a = fmaf(s_h[tid * HMAX + k], __ldg(W + (size_t)k * n_out), a);
    long long i = base + tid;
    if (i < src.n) src.store(i, a + wts[N.b_off[l]]);
  }
}

void decode_net(const long long* q, Net& n) {
  n.n_layers = (int)q[0];
  n.skip_mask = (int)q[1];
  for (int l = 0; l < NL; ++l) {
    n.in_dim[l] = (int)q[2 + l];
    n.out_dim[l] = (int)q[2 + NL + l];
    n.w_off[l] = q[2 + 2 * NL + l];
    n.b_off[l] = q[2 + 3 * NL + l];
    n.wt_off[l] = q[2 + 4 * NL + l];
  }
}

Model decode_model(const long long* meta) {
  Model m;
  m.use_deform = (int)meta[0];
  m.f_dpos = (int)meta[1];
  m.f_dtime = (int)meta[2];
  m.f_spos = (int)meta[3];
  m.f_cpos = (int)meta[4];
  m.f_cdir = (int)meta[5];
  m.feat_dim = (int)meta[6];
  m.head_off = meta[7];
  decode_net(meta + 8, m.deform);
  decode_net(meta + 8 + META_NET, m.sdf);
  decode_net(meta + 8 + 2 * META_NET, m.color);
  m.ed = enc_width(3, m.f_dpos) + enc_width(1, m.f_dtime);
  m.es = enc_width(3, m.f_spos);
  m.cp = enc_width(3, m.f_cpos);
  m.cr = enc_width(3, m.f_cdir);
  m.ci = m.cp + 3 + m.cr + m.feat_dim;
  return m;
}

template <bool RB, class C, class Src>
cudaError_t launch_sweep_t(const float* w, const Model& m, const Src& src, cudaStream_t st) {
  if (src.n <= 0) return cudaSuccess;
  size_t smem = sweep_smem_floats(m) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(sweep_kernel<RB, C, Src>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  long long blocks = (src.n + P_SWEEP - 1) / P_SWEEP;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  sweep_kernel<RB, C, Src><<<(unsigned)blocks, NT, smem, st>>>(w, m, src);
  return cudaGetLastError();
}

// The sweep of chain C at the bf16 (rb) or float32 dot precision.
template <class C = EndoSurfChain, class Src>
cudaError_t launch_sweep(const float* w, const Model& m, bool rb, const Src& src,
                         cudaStream_t st) {
  return rb ? launch_sweep_t<true, C>(w, m, src, st) : launch_sweep_t<false, C>(w, m, src, st);
}

// K samples per ray: z[r * ldz + j] -> dst[r * ldd + j], j < K.
template <class C = EndoSurfChain>
cudaError_t sweep_rays(const float* w, const Model& m, bool rb, int R, int K, const float* b,
                       const float* z, int ldz, float* dst, int ldd, cudaStream_t st) {
  RaySamples src{b, z, ldz, K, dst, ldd, (long long)R * K};
  return launch_sweep<C>(w, m, rb, src, st);
}

// The SDF at the n0 samples in zl, then n_rounds rounds at sharpness 64 * 2^i:
// NeuS weights and k_new draws, the SDF at the new samples (when a later round
// needs it, or every round with sdf_last), and the sorted merge. zl / sl hold
// [R][KMAX], zn / sn [R][KNEW_MAX]; rb is the ray buffer (o, d_z, .., t, ..,
// a, b, c). sweep(K, z, ldz, dst, ldd) launches the SDF at K samples a ray,
// z[r * ldz + j] -> dst[r * ldd + j], and returns its error (the render's is
// sweep_rays; the upsampling's bf16 one runs on tensor cores, sweep_tc.cuh).
// Returns the first launch error.
template <class Sweep>
cudaError_t run_upsample_rounds(Sweep sweep, int R, int n0, int k_new, int n_rounds,
                                bool sdf_last, const float* rb, float* zl, float* sl, float* zn,
                                float* sn, cudaStream_t st) {
  cudaError_t e;
  const int tpb = 128;
  const int rblocks = (R + tpb - 1) / tpb;
  e = sweep(n0, zl, KMAX, sl, KMAX);
  if (e != cudaSuccess) return e;
  float sharpness = 64.f;  // 64 * 2^i in round i
  for (int i = 0; i < n_rounds; ++i, sharpness *= 2.f) {
    const int s = n0 + i * k_new;
    const bool need_sdf = i + 1 < n_rounds || sdf_last;
    draw_kernel<<<rblocks, tpb, 0, st>>>(R, rb, zl, sl, s, k_new, sharpness, zn);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if (need_sdf) {
      e = sweep(k_new, zn, KNEW_MAX, sn, KNEW_MAX);
      if (e != cudaSuccess) return e;
    }
    merge_kernel<<<rblocks, tpb, 0, st>>>(R, zl, sl, s, zn, need_sdf ? sn : nullptr, k_new);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace
