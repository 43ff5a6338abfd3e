// EndoSurf importance upsampling for NVIDIA Hopper (sm_90a), CUDA C++.
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
// per ray (about 2.0 MFLOP a point). The sweep is plain SIMT float32 FMA: a
// block of 256 threads owns 32 points, thread j computes neuron j for all of
// them from activations in shared memory, the weights stream from L2. The
// per-ray draw / merge kernels are a few microseconds. Tensor cores are later
// work.
//
// Precision: with rb_samp every dot operand is rounded to bf16 and the
// weights arrive rounded (pack_operands); products accumulate in float32 --
// the sampling "default" mode of the JAX kernels.

#include "sdf_chain.cuh"

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

}  // namespace

extern "C" {

// Floats of scratch the caller must allocate for R rays.
long long fused_upsample_scratch_floats(int R) {
  return (long long)R * (RB_STRIDE + 2 * KNEW_MAX);
}

// rays7 [R, 7] (o, d_z, t); z0 [R, n0] ascending; w packed weights described
// by meta (kernels/fused_render.pack_operands); z_out / sdf_out [R, 64]
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
  e = run_upsample_rounds(w, m, rb_samp != 0, R, n0, k_new, n_rounds, return_sdf != 0, rb,
                          z_out, sdf_out, zn, sn, st);
  return (int)e;
}

}  // extern "C"
