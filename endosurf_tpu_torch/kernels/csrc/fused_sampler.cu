// EndoSurf importance upsampling and sphere-traced ray march for NVIDIA
// Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel endosurf_tpu/kernels/fused_sampler.py
// (fused_upsample_z, body _upsample_kernel / _upsample_round): for every ray,
// the SDF at the caller's n0 (perturbed) samples, then n_rounds rounds at
// sharpness 64 * 2^i of NeuS importance weights, k deterministic inverse-CDF
// draws, the SDF at the new samples and a sorted merge. Output: z [R, n]
// ascending and, with return_sdf, the SDF at every one of those samples (the
// last round's new columns are evaluated too), n = n0 + k * n_rounds <= 64.
// It runs without gradient: the train step only picks sample locations here.
//
// One host entry (fused_upsample_launch) launches on the caller's stream:
//   prep (ray buffer, copy z0) -> sdf sweep (n0 samples) ->
//   [draw -> sdf sweep (k new) -> merge] x n_rounds
// with the kernels of sdf_chain.cuh, which the render entry runs too.
//
// What bounds it: the deform and SDF 9x256 MLPs at n0 + k * n_rounds points
// per ray (1.877 MFLOP a point). In the float32 mode the sweep is plain SIMT
// float32 FMA: a block of 256 threads owns 32 points, thread j computes
// neuron j for all of them from activations in shared memory, the weights
// stream from L2. In the bf16 mode it runs on tensor cores (sweep_tc.cuh:
// tile products on mma.sync, one tile of SW_P points a block). The per-ray
// draw / merge kernels are a few microseconds.
//
// Precision: with rb_samp every dot operand is rounded to bf16 and the
// weights arrive rounded (fused_sampler.pack_sampling, which also appends
// the hidden layers' bf16 mma fragments) -- the sampling "default" mode of
// the JAX kernels; the SIMT sweep sums in float32, the tensor-core one
// nearer to exact (sweep_tc.cuh).
//
// The ray march (fused_ray_march_launch) replaces the Pallas TPU kernel
// endosurf_tpu/kernels/fused_sampler.py (fused_ray_march, body _march_kernel)
// that serves the train step's surface-neighbour loss with
// surf_march_reuse: false: per ray, the SDF at S = 128 depths
// linspace(near, far), the first sign change of val = -(sdf - tau) (the
// lowest index j with val_j * val_{j+1} < 0, which is where the JAX cost
// argmin lands), valid when it goes + -> - and the first sample is free space,
// then n_secant = 8 false-position steps, each one chain evaluation per ray.
// Invalid rays get the chord midpoint. Launches:
//   prep (ray buffer, depths) -> sdf sweep (R x S) -> crossing ->
//   [sdf sweep (R x 1) -> secant update] x n_secant -> finish
// The sweeps are sdf_chain.cuh's; the per-ray kernels keep a small state
// (MS_STRIDE floats a ray) in global memory between launches. What bounds
// it: the R x (S + n_secant) chain evaluations (about 0.26 TFLOP for 1024
// rays); the secant sweeps fill only R / 32 blocks.

#include "sdf_chain.cuh"
#include "sweep_tc.cuh"

#define MS_STRIDE 8     // march state a ray: d_low f_low d_high f_high d_pred sdf valid idx

namespace {

// rays7 [R, 7] = (o, d_z, t) and z0 [R, n0] -> ray buffer (o, d_z, -, t, -,
// a = |o|^2, b = o . d_z, c = |d_z|^2) and the sample list.
__global__ void upsample_prep_kernel(const float* __restrict__ rays7,
                                     const float* __restrict__ z0, int R, int n0,
                                     float* __restrict__ rb, float* __restrict__ zl) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float* ry = rays7 + (size_t)r * 7;
  float o[3] = {ry[0], ry[1], ry[2]};
  float dz[3] = {ry[3], ry[4], ry[5]};
  float* b = rb + (size_t)r * RB_STRIDE;
  for (int k = 0; k < 3; ++k) { b[k] = o[k]; b[3 + k] = dz[k]; b[6 + k] = 0.f; }
  b[9] = ry[6]; b[10] = 0.f; b[11] = 0.f;
  b[12] = o[0] * o[0] + o[1] * o[1] + o[2] * o[2];
  b[13] = o[0] * dz[0] + o[1] * dz[1] + o[2] * dz[2];
  b[14] = dz[0] * dz[0] + dz[1] * dz[1] + dz[2] * dz[2];
  b[15] = 0.f;
  float* z = zl + (size_t)r * KMAX;
  for (int j = 0; j < n0; ++j) z[j] = z0[(size_t)r * n0 + j];
}

// rays7 [R, 7] = (o, d_z, t), nf [R, 2] = (near, far) and tv [S] (linspace
// 0..1) -> ray buffer and the depths near * (1 - tv) + far * tv, each product
// and the sum rounded on its own, as the plain version computes them.
__global__ void march_prep_kernel(const float* __restrict__ rays7,
                                  const float* __restrict__ nf, const float* __restrict__ tv,
                                  int R, int S, float* __restrict__ rb, float* __restrict__ zl) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float* ry = rays7 + (size_t)r * 7;
  float* b = rb + (size_t)r * RB_STRIDE;
  for (int k = 0; k < 6; ++k) b[k] = ry[k];
  for (int k = 6; k < RB_STRIDE; ++k) b[k] = 0.f;
  b[9] = ry[6];
  const float near = nf[(size_t)r * 2], far = nf[(size_t)r * 2 + 1];
  b[10] = near; b[11] = far;
  float* z = zl + (size_t)r * S;
  for (int j = 0; j < S; ++j)
    z[j] = __fadd_rn(__fmul_rn(near, 1.f - tv[j]), __fmul_rn(far, tv[j]));
}

__device__ __forceinline__ float secant_point(float d_low, float f_low, float d_high,
                                              float f_high) {
  return -f_low * (d_high - d_low) / (f_high - f_low + 1e-12f) + d_low;
}

// The first sign change of val = -(sdf - tau) over the S samples, the
// validity rule and the crossing pair; d_pred is the pair's interpolation.
__global__ void march_crossing_kernel(int R, int S, float tau, const float* __restrict__ zl,
                                      const float* __restrict__ sl, float* __restrict__ ms) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float* z = zl + (size_t)r * S;
  const float* sd = sl + (size_t)r * S;
  const float v0 = -(sd[0] - tau);
  int idx = S - 1;          // no crossing: a degenerate pair at the last sample
  float vj = v0;
  for (int j = 0; j < S - 1; ++j) {
    float vn = -(sd[j + 1] - tau);
    if (vj * vn < 0.f) { idx = j; break; }
    vj = vn;
  }
  const bool crossing = idx < S - 1;
  const int hi = crossing ? idx + 1 : idx;
  const float f_low = -(sd[idx] - tau), f_high = -(sd[hi] - tau);
  const float d_low = z[idx], d_high = z[hi];
  float* st = ms + (size_t)r * MS_STRIDE;
  st[0] = d_low; st[1] = f_low; st[2] = d_high; st[3] = f_high;
  st[4] = secant_point(d_low, f_low, d_high, f_high);
  st[5] = 0.f;
  st[6] = (crossing && f_low < 0.f && v0 < 0.f) ? 1.f : 0.f;
  st[7] = (float)idx;
}

// One false-position step from the SDF at d_pred (in st[5]).
__global__ void march_secant_kernel(int R, float tau, float* __restrict__ ms) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float* st = ms + (size_t)r * MS_STRIDE;
  const float f_mid = -(st[5] - tau);
  const bool low = f_mid < 0.f;
  float d_low = st[0], f_low = st[1], d_high = st[2], f_high = st[3];
  const float d_pred = st[4];
  if (low) { d_low = d_pred; f_low = f_mid; } else { d_high = d_pred; f_high = f_mid; }
  st[0] = d_low; st[1] = f_low; st[2] = d_high; st[3] = f_high;
  st[4] = secant_point(d_low, f_low, d_high, f_high);
}

// out [R, 4] = (depth, valid, d_low, d_high), idx [R].
__global__ void march_finish_kernel(int R, const float* __restrict__ rb,
                                    const float* __restrict__ ms, float* __restrict__ out,
                                    int* __restrict__ idx_out) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float* st = ms + (size_t)r * MS_STRIDE;
  const float* b = rb + (size_t)r * RB_STRIDE;
  const bool valid = st[6] > 0.5f;
  float* o = out + (size_t)r * 4;
  o[0] = valid ? st[4] : 0.5f * (b[10] + b[11]);
  o[1] = valid ? 1.f : 0.f;
  o[2] = st[0];
  o[3] = st[2];
  idx_out[r] = (int)st[7];
}

}  // namespace

extern "C" {

// Floats of scratch the caller must allocate for R rays.
long long fused_upsample_scratch_floats(int R) {
  return (long long)R * (RB_STRIDE + 2 * KNEW_MAX);
}

// rays7 [R, 7] (o, d_z, t); z0 [R, n0] ascending; w packed weights described
// by meta (kernels/fused_sampler.pack_sampling: with rb_samp the meta carries
// the fragment offsets after its first META_LEN entries); z_out / sdf_out [R, 64]
// (row stride 64; columns 0 .. n0 + k_new * n_rounds - 1 are written, sdf_out
// in full only with return_sdf, else it is work space). Runs on the calling
// thread's current device. Returns a cudaError_t (0 on success).
int fused_upsample_launch(const float* rays7, const float* z0, int R, int n0,
                          const float* w, const long long* meta, int rb_samp, int k_new,
                          int n_rounds, int return_sdf, float* scratch, float* z_out,
                          float* sdf_out, void* stream) {
  if (R <= 0) return 0;
  cudaError_t e;
  cudaStream_t st = (cudaStream_t)stream;
  const Model m = decode_model(meta);
  float* rb = scratch;
  float* zn = rb + (size_t)R * RB_STRIDE;
  float* sn = zn + (size_t)R * KNEW_MAX;
  const int tpb = 128;
  upsample_prep_kernel<<<(R + tpb - 1) / tpb, tpb, 0, st>>>(rays7, z0, R, n0, rb, z_out);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // bf16: the tensor-core sweep, its fragments in the meta's extension
  const SweepFrags fr = rb_samp ? decode_sweep_frags(meta) : SweepFrags{};
  auto sweep = [&](int K, const float* z, int ldz, float* dst, int ldd) {
    return rb_samp ? sweep_rays_tc(w, m, fr, R, K, rb, z, ldz, dst, ldd, st)
                   : sweep_rays(w, m, false, R, K, rb, z, ldz, dst, ldd, st);
  };
  e = run_upsample_rounds(sweep, R, n0, k_new, n_rounds, return_sdf != 0, rb, z_out, sdf_out, zn,
                          sn, st);
  return (int)e;
}


// Floats of scratch the ray march needs for R rays of S samples.
long long fused_march_scratch_floats(int R, int S) {
  return (long long)R * (RB_STRIDE + 2 * S + MS_STRIDE);
}

// rays7 [R, 7] (o, d_z, t); nf [R, 2] (near, far); tv [S] the scan's
// fractions (linspace 0..1); w / meta packed weights
// (kernels/fused_render.pack_operands); out [R, 4] (depth, valid, d_low,
// d_high after the secant steps); idx_out [R] the crossing's sample index.
// Returns a cudaError_t (0 on success).
int fused_ray_march_launch(const float* rays7, const float* nf, const float* tv, int R, int S,
                           int n_secant, float tau, const float* w, const long long* meta,
                           int rb_samp, float* scratch, float* out, int* idx_out,
                           void* stream) {
  if (R <= 0) return 0;
  if (S < 2) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  cudaStream_t st = (cudaStream_t)stream;
  const Model m = decode_model(meta);
  const bool rbf = rb_samp != 0;
  float* rb = scratch;
  float* zl = rb + (size_t)R * RB_STRIDE;
  float* sl = zl + (size_t)R * S;
  float* ms = sl + (size_t)R * S;
  const int tpb = 128, blocks = (R + tpb - 1) / tpb;
  march_prep_kernel<<<blocks, tpb, 0, st>>>(rays7, nf, tv, R, S, rb, zl);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((e = sweep_rays(w, m, rbf, R, S, rb, zl, S, sl, S, st)) != cudaSuccess) return (int)e;
  march_crossing_kernel<<<blocks, tpb, 0, st>>>(R, S, tau, zl, sl, ms);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  for (int i = 0; i < n_secant; ++i) {
    // the SDF at d_pred (state column 4) into state column 5
    e = sweep_rays(w, m, rbf, R, 1, rb, ms + 4, MS_STRIDE, ms + 5, MS_STRIDE, st);
    if (e != cudaSuccess) return (int)e;
    march_secant_kernel<<<blocks, tpb, 0, st>>>(R, tau, ms);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  march_finish_kernel<<<blocks, tpb, 0, st>>>(R, rb, ms, out, idx_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
