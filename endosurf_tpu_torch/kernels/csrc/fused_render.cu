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
//   (rounds - 1) -> draw -> merge -> field evaluation (all midpoints) ->
//   composite.
// The draw and merge kernels and the rounds' host loop are in sdf_chain.cuh,
// shared with the upsample entry (fused_sampler.cu).
//
// What bounds it: the three 9x256 MLPs (about 0.55 GFLOP per ray, 1.13 TFLOP
// a 2048-ray chunk: 1.1 ms at the bf16 tensor-core rate). In the bf16 mode
// (the serving default) both passes run on tensor cores: the sweeps are
// sweep_tc.cuh's (as the upsample's), and the field evaluation is the train
// segments' tensor-core forward kernels (field_tc.cuh) over the chunk's
// midpoints:
//   midpoint_kernel (x, t, d) -> deform_fwd_tc_kernel (x_c, rows) ->
//   sdf_fwd_tc_kernel (sdf, feat, grad_c) -> coupling_kernel (grad_o,
//   d . grad_o, d_c) -> color_fwd_tc_kernel (rgb) -> composite_kernel (in
//   double),
// their per-point arrays in a workspace the caller sizes
// (fused_render_work_floats; the SDF forward's pre-activations are most of
// it, about 1 GiB a 2048-ray chunk). The weights come as bf16 mma fragments
// in the pack's extension (kernels/fused_render.pack_render). The float32
// mode, and the bf16 mode with tc = 0 (a comparison only), run the SIMT
// code: sdf_chain.cuh's sweep and field_kernel, the per-point code of
// field_chain.cuh on a tile of P_FIELD points (thread j computes neuron j for
// every point, the weights streaming from L2).
//
// Precision: with RB (round to bf16) every dot operand -- activations,
// encodings, tangent seeds, the adjoint -- is rounded to bf16 and the weights
// arrive pre-rounded; the SIMT products accumulate in float32, the
// tensor-core ones as their kernels' headers say. This is the "default" mode
// of the JAX kernels. The upsampling sweeps and the final field evaluation
// take their modes separately, as render_rays_inference sets them.

#include "field_chain.cuh"
#include "field_tc.cuh"
#include "sweep_tc.cuh"

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

__device__ __forceinline__ float sigmoid_r(float x) { return sigmoidf_(x); }
__device__ __forceinline__ double sigmoid_r(double x) { return 1.0 / (1.0 + exp(-x)); }

// NeuS composite over the K midpoints -> out [R, 9]: rgb, depth, normal, acc,
// max w, in Real arithmetic on the float32 field values. float: the SIMT
// render's and the float32 render's. double: the bf16 tensor-core render's;
// in float32 the transmittance's running product (T *= 1 - alpha + 1e-7,
// whose 1e-7 sits at half an ulp of 1) and the sums put acc_map about 5e-7
// a ray from the float64 yardstick whatever the field stage does
// (tools/render_acc_floor.py), where the tensor-core field stage is nearer.
template <class Real>
__global__ void composite_kernel(int R, int K, float sample_dist,
                                 const float* __restrict__ zl,
                                 const float* __restrict__ pt, const float* __restrict__ scal,
                                 float* __restrict__ out) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const Real anneal = scal[0], s_inv = scal[1], half = 0.5f, one = 1.f, zero = 0.f;
  const Real e6 = (Real)1e-6, e7 = (Real)1e-7;
  const float* z = zl + (size_t)r * KMAX;
  Real T = one;
  Real c0 = zero, c1 = zero, c2 = zero, dep = zero, n0 = zero, n1 = zero, n2 = zero;
  Real acc = zero, wmax = zero;
  for (int j = 0; j < K; ++j) {
    Real dist = (j < K - 1) ? (Real)z[j + 1] - (Real)z[j] : (Real)sample_dist;
    Real mid = z[j] + dist * half;
    const float* q = pt + ((size_t)r * K + j) * OUT_STRIDE;
    Real sdf = q[0], tc = q[7];
    Real ic = -(fmax(-tc * half + half, zero) * (one - anneal) + fmax(-tc, zero) * anneal);
    Real en = sdf + ic * dist * half;
    Real ep = sdf - ic * dist * half;
    Real pc = sigmoid_r(ep * s_inv);
    Real nc = sigmoid_r(en * s_inv);
    Real alpha = fmin(fmax((pc - nc + e6) / (pc + e6), zero), one);
    Real w = alpha * T;
    T *= (one - alpha + e7);
    c0 += w * q[1]; c1 += w * q[2]; c2 += w * q[3];
    dep += w * mid;
    n0 += w * q[4]; n1 += w * q[5]; n2 += w * q[6];
    acc += w;
    wmax = fmax(wmax, w);
  }
  float* o = out + (size_t)r * 9;
  o[0] = c0; o[1] = c1; o[2] = c2; o[3] = dep;
  o[4] = n0; o[5] = n1; o[6] = n2; o[7] = acc; o[8] = wmax;
}

// ---------------------------------------------------------------------------
// The tensor-core field stage's per-point kernels (field_kernel's prologue and
// coupling, one thread a point, each operation as there)
// ---------------------------------------------------------------------------

// The section midpoint of sample j of ray r (i = r K + j): xt [n][4] (x, t)
// and d [n][3] (the raw direction); without a deform net x_c [n][3] = x and
// the rows [n][9] the identity.
__global__ void midpoint_kernel(int R, int K, float sample_dist, bool use_deform,
                                const float* __restrict__ rb, const float* __restrict__ zl,
                                float* __restrict__ xt, float* __restrict__ xc,
                                float* __restrict__ J, float* __restrict__ d) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)R * K) return;
  const int r = (int)(i / K), j = (int)(i % K);
  const float* b = rb + (size_t)r * RB_STRIDE;
  const float* z = zl + (size_t)r * KMAX;
  const float dist = (j < K - 1) ? z[j + 1] - z[j] : sample_dist;
  const float mid = z[j] + dist * 0.5f;
  float x[3];
  for (int k = 0; k < 3; ++k) {
    x[k] = b[k] + mid * b[3 + k];
    d[(size_t)i * 3 + k] = b[6 + k];
  }
  if (use_deform) {
    for (int k = 0; k < 3; ++k) xt[(size_t)i * 4 + k] = x[k];
    xt[(size_t)i * 4 + 3] = b[9];
  } else {
    for (int k = 0; k < 3; ++k) xc[(size_t)i * 3 + k] = x[k];
    for (int q = 0; q < 9; ++q) J[(size_t)i * 9 + q] = (q / 3 == q % 3) ? 1.f : 0.f;
  }
}

// grad_o = J^T grad_c, tc = d . grad_o, d_c = J d / |J d| (in place of d);
// pt [n][OUT_STRIDE] gets sdf, grad_o and tc (the colour kernel fills rgb).
__global__ void coupling_kernel(long long n, const float* __restrict__ J,
                                const float* __restrict__ gc, const float* __restrict__ sdf,
                                float* __restrict__ d, float* __restrict__ pt) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float Jl[9], g[3], dd[3], go[3], rv[3];
  for (int q = 0; q < 9; ++q) Jl[q] = J[(size_t)i * 9 + q];
  for (int k = 0; k < 3; ++k) { g[k] = gc[(size_t)i * 3 + k]; dd[k] = d[(size_t)i * 3 + k]; }
  for (int k = 0; k < 3; ++k)
    go[k] = Jl[k * 3 + 0] * g[0] + Jl[k * 3 + 1] * g[1] + Jl[k * 3 + 2] * g[2];
  for (int c = 0; c < 3; ++c)
    rv[c] = dd[0] * Jl[0 * 3 + c] + dd[1] * Jl[1 * 3 + c] + dd[2] * Jl[2 * 3 + c];
  const float nr = sqrtf(rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2]);
  const float tc = dd[0] * go[0] + dd[1] * go[1] + dd[2] * go[2];
  for (int c = 0; c < 3; ++c) d[(size_t)i * 3 + c] = rv[c] / (nr + 1e-10f);
  float* q = pt + (size_t)i * OUT_STRIDE;
  q[0] = sdf[i];
  q[4] = go[0]; q[5] = go[1]; q[6] = go[2];
  q[7] = tc;
}

// The render pack's fragment extension (kernels/fused_render.pack_render, the
// bf16 mode): after the meta's first META_LEN entries, NL float offsets each
// of the deform net's W, the SDF net's W (the upsample's sweep layout so
// far: decode_sweep_frags reads it), the colour net's W and the SDF net's
// W^T, -1 where a layer has none (the deform and colour output layers, the
// SDF's W^T output layer, an absent deform net).
struct RenderFrags {
  TcFrags deform, sdf, color;
};

RenderFrags decode_render_frags(const long long* meta) {
  RenderFrags f;
  const long long* x = meta + META_LEN;
  for (int l = 0; l < NL; ++l) {
    f.deform.w[l] = x[l];
    f.sdf.w[l] = x[NL + l];
    f.color.w[l] = x[2 * NL + l];
    f.sdf.wt[l] = x[3 * NL + l];
    f.deform.wt[l] = f.color.wt[l] = -1;
  }
  return f;
}

// The tensor-core field stage's workspace for n points: xt [n][4], x_c
// [n][3], the rows [n][9], sdf [n], feat [n][F], grad_c [n][3], d / d_c
// [n][3], then the SDF forward's (plan_sdf_fwd_tc), each 256-byte aligned;
// with a null base it only counts. Returns its floats.
struct RenderWork {
  float *xt, *xc, *J, *sdf, *feat, *gc, *d, *sdf_work;
};

long long plan_render_work(const Model& m, long long n, void* base, RenderWork& w) {
  BytePlanner pl{(char*)base};
  w.xt = pl.take<float>(n * 4);
  w.xc = pl.take<float>(n * 3);
  w.J = pl.take<float>(n * 9);
  w.sdf = pl.take<float>(n);
  w.feat = pl.take<float>(n * m.feat_dim);
  w.gc = pl.take<float>(n * 3);
  w.d = pl.take<float>(n * 3);
  w.sdf_work = pl.take<float>(0);
  TcScratch sv;
  return (pl.used + 3) / 4 + plan_sdf_fwd_tc(m, n, nullptr, sv);
}

cudaError_t launch_field_tc(const float* w, const Model& m, const RenderFrags& fr, int R, int K,
                            float sample_dist, const float* rb, const float* zl, float* work,
                            float* pt, cudaStream_t st) {
  const long long n = (long long)R * K;
  RenderWork wk;
  plan_render_work(m, n, work, wk);
  const int tpb = 256;
  const unsigned blocks = (unsigned)((n + tpb - 1) / tpb);
  cudaError_t e;
  midpoint_kernel<<<blocks, tpb, 0, st>>>(R, K, sample_dist, m.use_deform != 0, rb, zl, wk.xt,
                                          wk.xc, wk.J, wk.d);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (m.use_deform &&
      (e = launch_deform_fwd_tc(w, fr.deform, m, n, wk.xt, wk.xc, wk.J, st)) != cudaSuccess)
    return e;
  e = launch_sdf_fwd_tc(w, fr.sdf, m, n, wk.xc, wk.sdf, wk.feat, wk.gc, wk.sdf_work, st);
  if (e != cudaSuccess) return e;
  coupling_kernel<<<blocks, tpb, 0, st>>>(n, wk.J, wk.gc, wk.sdf, wk.d, pt);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return launch_color_fwd_tc(w, fr.color, m, n, wk.xc, wk.gc, wk.d, wk.feat, pt + 1, OUT_STRIDE,
                             st);
}

// ---------------------------------------------------------------------------
// Full field evaluation at the section midpoints (fused_train.forward_math),
// the per-point code of field_chain.cuh. Output per point: sdf, rgb, grad_o,
// d . grad_o.
// ---------------------------------------------------------------------------

template <bool RB>
__global__ void __launch_bounds__(NT, 2)
field_kernel(const float* __restrict__ wts, Model m, int R, int K, float sample_dist,
             const float* __restrict__ rb, const float* __restrict__ zl,
             float* __restrict__ pt) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int P = P_FIELD;
  const FieldTile s = field_tile(smem, m);
  const FieldScratch none{};

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
    for (int k = 0; k < 3; ++k) { s.x[tid * 4 + k] = x[k]; s.d[tid * 4 + k] = d[k]; }
    s.x[tid * 4 + 3] = t;
  }
  __syncthreads();

  field_deform<RB, false>(wts, m, s, tid, base, n_pts, none);
  field_sdf<RB, false, false>(wts, m, s, tid, base, n_pts, none, nullptr);

  // ---- coupling: grad_o = J^T grad_c, d_c = J d / |J d| -------------------
  float go[3] = {0.f, 0.f, 0.f}, tc = 0.f;
  if (tid < P) {
    const int p = tid;
    const float* J = s.J + p * 9;
    const float* gc = s.gc + p * 4;
    const float* d = s.d + p * 4;
    float rv[3];
    for (int k = 0; k < 3; ++k) go[k] = J[k * 3 + 0] * gc[0] + J[k * 3 + 1] * gc[1] + J[k * 3 + 2] * gc[2];
    for (int c = 0; c < 3; ++c) rv[c] = d[0] * J[0 * 3 + c] + d[1] * J[1 * 3 + c] + d[2] * J[2 * 3 + c];
    float nr = sqrtf(rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2]);
    // d_c kept in s.d (the raw direction is no longer needed after tc)
    tc = d[0] * go[0] + d[1] * go[1] + d[2] * go[2];
    for (int c = 0; c < 3; ++c) s.d[p * 4 + c] = rv[c] / (nr + 1e-10f);
  }
  __syncthreads();

  field_color<RB, false>(wts, m, s, tid, base, n_pts, none);
  if (tid < P) {
    long long i = base + tid;
    if (i < n_pts) {
      float* q = pt + (size_t)i * OUT_STRIDE;
      q[0] = s.sdf[tid];
      q[1] = s.aE[tid * 4 + 0]; q[2] = s.aE[tid * 4 + 1]; q[3] = s.aE[tid * 4 + 2];
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

// Floats of workspace the tensor-core field stage needs for n midpoints
// (plan_render_work; kernels/fused_render.render_work_floats mirrors it).
long long fused_render_work_floats(const long long* meta, long long n) {
  RenderWork w;
  return plan_render_work(decode_model(meta), n, nullptr, w);
}

int fused_render_meta_len() { return META_LEN; }

const char* fused_render_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// rays [R, 9]; w_samp / w_main packed weights for the sampling / main
// precision (same layout, described by meta); scal [2] = (anneal, inv_s) on
// the device; out [R, 9]. With tc a bf16 pass runs on tensor cores: meta
// then carries the render pack's fragment extension (decode_render_frags),
// and the bf16 pack holds the fragments; work holds
// fused_render_work_floats(meta, R * (n0 + k_new * n_rounds)) floats when
// the main pass is bf16. With tc = 0 both passes run the SIMT code. Runs on
// the calling thread's current device, which the caller sets to the tensors'
// device. Returns a cudaError_t (0 on success).
int fused_render_launch(const float* rays, int R, const float* w_samp,
                        const float* w_main, const long long* meta, int rb_samp,
                        int rb_main, int tc, int n0, int k_new, int n_rounds, float sample_dist,
                        const float* scal, float* scratch, float* work, float* out,
                        void* stream) {
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
  const bool tc_samp = tc && rb_samp, tc_main = tc && rb_main;

  prep_kernel<<<rblocks, tpb, 0, st>>>(rays, R, n0, rb, zl);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const SweepFrags sf = tc_samp ? decode_sweep_frags(meta) : SweepFrags{};
  auto sweep = [&](int K, const float* z, int ldz, float* dst, int ldd) {
    return tc_samp ? sweep_rays_tc(w_samp, m, sf, R, K, rb, z, ldz, dst, ldd, st)
                   : sweep_rays(w_samp, m, rb_samp != 0, R, K, rb, z, ldz, dst, ldd, st);
  };
  e = run_upsample_rounds(sweep, R, n0, k_new, n_rounds, false, rb, zl, sl, zn, sn, st);
  if (e != cudaSuccess) return (int)e;
  if (tc_main)
    e = launch_field_tc(w_main, m, decode_render_frags(meta), R, n_final, sample_dist, rb, zl,
                        work, pt, st);
  else if (rb_main)
    e = launch_field<true>(w_main, m, R, n_final, sample_dist, rb, zl, pt, st);
  else
    e = launch_field<false>(w_main, m, R, n_final, sample_dist, rb, zl, pt, st);
  if (e != cudaSuccess) return (int)e;
  if (tc_main)
    composite_kernel<double><<<rblocks, tpb, 0, st>>>(R, n_final, sample_dist, zl, pt, scal, out);
  else
    composite_kernel<float><<<rblocks, tpb, 0, st>>>(R, n_final, sample_dist, zl, pt, scal, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
