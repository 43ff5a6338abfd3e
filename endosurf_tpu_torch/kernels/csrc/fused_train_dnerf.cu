// The forward D-NeRF field segments for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replace the Pallas TPU kernels of endosurf_tpu/kernels/fused_train_dnerf.py
// _deform_fwd_pl, _density_fwd_pl and _color_fwd_pl (through
// fused_train_pallas._seg_pallas), the three forward segments of
// megakernel_field_raw:
//
//   dnerf_deform_fwd   xt [N, 4] (x, t)        -> x_c [N, 3] = x + deform
//   dnerf_density_fwd  x_c [N, 3]              -> raw sigma [N, 1], feat [N, F]
//   dnerf_color_fwd    d [N, 3], feat [N, F]   -> rgb [N, 3] (sigmoid)
//
// Each is a thin entry over dnerf_chain.cuh's per-point code (the EndoNeRF
// render kernel's fine evaluation runs the same functions in one kernel).
// The TPU kernels' 128-lane padding of the 3-vectors, selector matmuls and
// lane rolls are layout, not math, and are not carried over. They serve the
// EndoNeRF 3D demo's vertex colours (render_points_fn -> field_eval ->
// megakernel_field_raw, ~10^5 points a frame); their backward halves come
// with the EndoNeRF train step.
//
// What bounds them: the MLPs (deform 0.99 MFLOP a point, density 1.13,
// colour 0.07 with the 9x256 / 9x256 / 2x128 nets); per-point inputs and
// outputs are at most 262 floats. Plain SIMT float32 FMA with bf16-rounded
// operands under rb, as dnerf_chain.cuh says.

#include "dnerf_chain.cuh"

namespace {

template <bool RB>
__global__ void __launch_bounds__(NT, 2)
dnerf_deform_fwd_kernel(const float* __restrict__ wts, Model m, long long n,
                        const float* __restrict__ xt, float* __restrict__ xc) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const DnTile s = dn_tile(smem, m);
  const long long base = (long long)blockIdx.x * P_DN;
  if (tid < 4 * P_DN) {
    const long long i = base + tid / 4;
    s.x[tid] = i < n ? xt[(size_t)i * 4 + (tid & 3)] : 0.f;
  }
  __syncthreads();
  dn_deform<RB>(wts, m, s, tid);
  if (tid < 3 * P_DN) {
    const int p = tid / 3, c = tid - p * 3;
    if (base + p < n) xc[(size_t)(base + p) * 3 + c] = s.xc[p * 4 + c];
  }
}

template <bool RB>
__global__ void __launch_bounds__(NT, 2)
dnerf_density_fwd_kernel(const float* __restrict__ wts, Model m, long long n,
                         const float* __restrict__ xc, float* __restrict__ sigma,
                         float* __restrict__ feat) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const DnTile s = dn_tile(smem, m);
  const long long base = (long long)blockIdx.x * P_DN;
  if (tid < 3 * P_DN) {
    const int p = tid / 3, c = tid - p * 3;
    s.xc[p * 4 + c] = base + p < n ? xc[(size_t)(base + p) * 3 + c] : 0.f;
  }
  __syncthreads();
  dn_density<RB>(wts, m, s, tid, base, n, feat);
  if (tid < P_DN && base + tid < n) sigma[base + tid] = s.out[tid * 4];
}

template <bool RB>
__global__ void __launch_bounds__(NT, 2)
dnerf_color_fwd_kernel(const float* __restrict__ wts, Model m, long long n,
                       const float* __restrict__ d, const float* __restrict__ feat,
                       float* __restrict__ rgb) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const DnTile s = dn_tile(smem, m);
  const long long base = (long long)blockIdx.x * P_DN;
  const int F = m.feat_dim;
  if (tid < 3 * P_DN) {
    const int p = tid / 3, c = tid - p * 3;
    s.d[p * 4 + c] = base + p < n ? d[(size_t)(base + p) * 3 + c] : 0.f;
  }
  for (int idx = tid; idx < P_DN * F; idx += NT) {
    const int p = idx / F, c = idx - p * F;
    s.h[p * HMAX + c] = base + p < n ? opnd<RB>(feat[(size_t)(base + p) * F + c]) : 0.f;
  }
  __syncthreads();
  dn_color<RB>(wts, m, s, tid);
  if (tid < 3 * P_DN) {
    const int p = tid / 3, c = tid - p * 3;
    if (base + p < n) rgb[(size_t)(base + p) * 3 + c] = s.out[p * 4 + 1 + c];
  }
}

template <class K, class... Args>
int launch_seg(K k_rb, K k_f32, bool rb, const Model& m, long long n, cudaStream_t st,
               Args... args) {
  if (n <= 0) return 0;
  K kernel = rb ? k_rb : k_f32;
  size_t smem;
  cudaError_t e = dn_prepare(kernel, m, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (n + P_DN - 1) / P_DN;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, NT, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// w / meta packed by kernels/fused_train_dnerf.pack_dnerf; every tensor float32
// contiguous on the current device. Each returns a cudaError_t (0 on success).

int dnerf_deform_fwd(const float* w, const long long* meta, int rb, long long n,
                     const float* xt, float* xc, void* stream) {
  const Model m = decode_model(meta);
  return launch_seg(dnerf_deform_fwd_kernel<true>, dnerf_deform_fwd_kernel<false>, rb != 0, m,
                    n, (cudaStream_t)stream, w, m, n, xt, xc);
}

int dnerf_density_fwd(const float* w, const long long* meta, int rb, long long n,
                      const float* xc, float* sigma, float* feat, void* stream) {
  const Model m = decode_model(meta);
  return launch_seg(dnerf_density_fwd_kernel<true>, dnerf_density_fwd_kernel<false>, rb != 0,
                    m, n, (cudaStream_t)stream, w, m, n, xc, sigma, feat);
}

int dnerf_color_fwd(const float* w, const long long* meta, int rb, long long n,
                    const float* d, const float* feat, float* rgb, void* stream) {
  const Model m = decode_model(meta);
  return launch_seg(dnerf_color_fwd_kernel<true>, dnerf_color_fwd_kernel<false>, rb != 0, m,
                    n, (cudaStream_t)stream, w, m, n, d, feat, rgb);
}

}  // extern "C"
