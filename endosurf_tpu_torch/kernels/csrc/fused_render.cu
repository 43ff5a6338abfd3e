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
// sdf_chain.cuh, shared with the upsample entry (fused_sampler.cu); the
// field evaluation's per-point code is in field_chain.cuh, shared with the
// train segment kernels (fused_train.cu).
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

#include "field_chain.cuh"

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
  auto sweep = [&](int K, const float* z, int ldz, float* dst, int ldd) {
    return sweep_rays(w_samp, m, rb_samp != 0, R, K, rb, z, ldz, dst, ldd, st);
  };
  e = run_upsample_rounds(sweep, R, n0, k_new, n_rounds, false, rb, zl, sl, zn, sn, st);
  if (e != cudaSuccess) return (int)e;
  e = rb_main ? launch_field<true>(w_main, m, R, n_final, sample_dist, rb, zl, pt, st)
              : launch_field<false>(w_main, m, R, n_final, sample_dist, rb, zl, pt, st);
  if (e != cudaSuccess) return (int)e;
  composite_kernel<<<rblocks, tpb, 0, st>>>(R, n_final, sample_dist, zl, pt, scal, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
