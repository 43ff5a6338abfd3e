// EndoNeRF (D-NeRF) forward render for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel endosurf_tpu/kernels/fused_render_dnerf.py
// (fused_render_rays_dnerf, body _render_dnerf_kernel): for every ray, the
// coarse raw density at its n0 initial depths (the deform -> density chain at
// the sampling precision), the importance resampling of
// fused_sampler._fine_resample_math (coarse 1 - exp(-sigma dist) weights,
// n_new deterministic inverse-CDF draws, the sorted merge), the full field
// at all n0 + n_new depths (fused_train_dnerf.forward_math at the main
// precision) and raw2outputs (density compositing, disparity-form depth).
// The initial depths come from the caller (the Gaussian depth-guided draws,
// sorted, or a linspace), as the TPU kernel takes them from XLA.
//
// The standalone resampling of the EndoNeRF train step
// (fused_fine_resample_launch) replaces the Pallas TPU kernel
// endosurf_tpu/kernels/fused_sampler.py (fused_fine_resample, body
// _fine_resample_kernel): the render's resample kernel
// (dn_resample_warp_kernel, one warp a ray) on the caller's z, sigma (after
// the train noise and the relu) and |d|. What bounds it: bytes, 129 floats
// in and 128 out a ray at 64 + 64; its floor in practice is the three
// dependent chains of 63 steps a ray.
//
// One host entry (fused_render_dnerf_launch) launches a fixed sequence on
// the caller's stream:
//   prep -> coarse sweep (R x n0 points over DnRaySamples) -> resample (one
//   warp a ray) -> field (R x (n0 + n_new) points) -> composite (one
//   thread a ray).
// A bf16 pass runs on tensor cores (dnerf_tc.cuh): the coarse sweep is
// dn_sweep_tc_kernel, the field dn_field_tc_kernel (deform, density and
// colour on one 64-point tile, nothing written between them), and with a
// bf16 main pass the resample and the composite run in double; the float32
// mode, and the bf16 mode with tc = 0 (a comparison only), run the SIMT code:
// sdf_chain.cuh's sweep with the D-NeRF chain and dn_field_kernel
// (dnerf_chain.cuh).
//
// What bounds it: the MLPs, about 0.41 GFLOP a ray at 64 + 64 samples with
// the 9x256 / 9x256 / 2x128 nets (2 MFLOP a coarse point, 2.2 a fine one);
// a ray's inputs and outputs are 73 floats. The per-ray resample and
// composite are a few hundred operations a ray.
//
// Precision: rb_samp / rb_main round every dot operand of the coarse sweep /
// of the field evaluation to bf16 (the weights arrive rounded); products
// accumulate in float32 (the tensor-core ones as dnerf_tc.cuh says). The
// sweep does not round coordinates, the field evaluation does (as the TPU
// kernels' two chains do).

#include "dnerf_tc.cuh"

#define DN_OUT 5        // floats per ray of the output: rgb, depth, acc

namespace {

// Sample j of ray r at o + z d_z, formed with separately rounded products and
// sums (no FMA contraction), as the plain twin forms it: the density's high
// octaves turn a float32 ulp of a coordinate into ~1e-4 of the density.
__device__ __forceinline__ float dn_coord(const float* b, int k, float z) {
  return __fadd_rn(b[k], __fmul_rn(z, b[3 + k]));
}

// RaySamples (sdf_chain.cuh) with dn_coord's points: the coarse sweep's source.
struct DnRaySamples {
  const float* rb;
  const float* z;
  int K;
  float* dst;
  long long n;
  __device__ void load(long long i, float& x0, float& x1, float& x2, float& t) const {
    int r = (int)(i / K);
    const float* b = rb + (size_t)r * RB_STRIDE;
    float zz = z[i];
    x0 = dn_coord(b, 0, zz); x1 = dn_coord(b, 1, zz); x2 = dn_coord(b, 2, zz);
    t = b[9];
  }
  __device__ void store(long long i, float v) const { dst[i] = v; }
};

// rays [R, 9] -> ray buffer (o, d_z, d, t, |d|), d_z = d / (d_z + 1e-5).
__global__ void dn_prep_kernel(const float* __restrict__ rays, int R, float* __restrict__ rb) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float* ry = rays + (size_t)r * 9;
  float* b = rb + (size_t)r * RB_STRIDE;
  const float inv = ry[5] + 1e-5f;
  for (int k = 0; k < 3; ++k) {
    b[k] = ry[k];
    b[3 + k] = ry[3 + k] / inv;
    b[6 + k] = ry[3 + k];
  }
  b[9] = ry[8];
  b[10] = sqrtf(ry[3] * ry[3] + ry[4] * ry[4] + ry[5] * ry[5]);
  for (int k = 11; k < RB_STRIDE; ++k) b[k] = 0.f;
}

__device__ __forceinline__ float exp_r(float x) { return expf(x); }
__device__ __forceinline__ double exp_r(double x) { return exp(x); }

#define RS_WARPS 8      // rays per block of the resampling, one warp each

// One ray's resampling state, a warp's own slice of shared memory.
template <class Real>
struct RsRay {
  Real alpha[DN_N0];           // 1 - exp(-relu(sigma_j) dist_j), j < n0 - 1
  Real keep[DN_N0];            // 1 - alpha_j + 1e-10, the transmittance's factor
  Real cdf[DN_N0];             // n0 - 1 entries: 0, then the running sum of the pdf
  float v[DN_K];               // the n0 depths, then the n_new draws
  unsigned long long key[DN_K];  // (rs_key(v[i]), i): the sort's key
  float sorted[DN_K];
};

// v's place in the order of floats as an unsigned integer: -0 as +0, a NaN
// above +inf (or, with its sign bit, below -inf). With the index beside it
// the sort's keys are distinct, so the ranks are a permutation on any data.
__device__ __forceinline__ unsigned rs_key(float v) {
  const unsigned b = __float_as_uint(v == 0.f ? 0.f : v);
  return (b & 0x80000000u) ? ~b : b | 0x80000000u;
}

// Importance resampling (fused_sampler.fine_resample_math), one warp a ray:
// the coarse weights of raw2outputs on relu(sigma) at the ray's n0 sorted
// depths z, scaled by its |d| (dn[r * dn_stride]), the sample_pdf of weights
// 1 .. n0-2 (+ 1e-5) over the n0 - 1 midpoint bins with n_new draws at
// u = (j + 0.5) / n_new, then the n0 depths and the draws sorted into
// out[r * out_stride ..][n0 + n_new]. The standalone fused_fine_resample
// (dn = |d| [R], out [R][n0 + n_new]) and the render's resample stage (dn in
// the ray buffer, out the chunk's zl [R][DN_K]) both launch it.
//
// There is no matrix product here, so tensor cores, wgmma and TMA do not
// apply; what the card offers is occupancy, shared memory and warp
// synchronisation. A block holds RS_WARPS rays (2048 rays: 256 blocks on the
// 132 SMs) and a ray's arrays sit in shared memory: the lanes load z and
// sigma coalesced and form every alpha and transmittance factor, lane 0 runs
// the three dependent chains (the transmittance T, the weight sum, the cdf's
// running sum) in order, the lanes divide the cdf by the sum, each lane
// finds its draws' bins by binary search (the running sums never decrease,
// so it gives the compare count's integer) and interpolates them, and each
// value is placed by its rank in (key, index) order: the coarse depths
// before equal draws, equal draws in draw order. The stores are coalesced.
// Every sum and product runs in the order of a serial loop over the ray, as
// the one-thread-a-ray kernel before this one did, so the bits are its bits
// (tests/test_torch_cuda.py's F32_DN_RESAMPLE_DIGEST, BF16_DN_RENDER_DIGEST).
//
// Real: the arithmetic, each draw rounded to float32 once. float: the
// standalone resample's and the float32 and SIMT renders'. double: the bf16
// tensor-core render's: in float32 the cdf's running sums and the draw's
// interpolation put each draw a few ulps from the float64 yardstick's, and
// an ulp of a depth tips the bf16 rounding of a sample coordinate now and
// then, so on faint rays the float32 resample set the acc_map p99 of both
// renders against float64 (PERF.md §6).
template <class Real>
__global__ void __launch_bounds__(32 * RS_WARPS)
dn_resample_warp_kernel(int R, int n0, int n_new, const float* __restrict__ z,
                        const float* __restrict__ sig, const float* __restrict__ dn,
                        int dn_stride, float* __restrict__ out, int out_stride) {
  __shared__ RsRay<Real> rays[RS_WARPS];
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * RS_WARPS + (threadIdx.x >> 5);
  if (r >= R) return;                  // the whole warp: below, only warp syncs
  RsRay<Real>& s = rays[threadIdx.x >> 5];
  const float* zr = z + (size_t)r * n0;
  const float* sr = sig + (size_t)r * n0;
  const Real dnv = dn[(size_t)r * dn_stride], one = 1.f, zero = 0.f, half = 0.5f,
             tiny = 1e-10f, floor_w = 1e-5f;
  const int nb = n0 - 1, K = n0 + n_new;   // bins, outputs
  for (int k = lane; k < n0; k += 32) s.v[k] = zr[k];
  __syncwarp();
  for (int j = lane; j < nb; j += 32) {
    const Real dist = ((Real)s.v[j + 1] - (Real)s.v[j]) * dnv;
    const Real alpha = one - exp_r(-fmax((Real)sr[j], zero) * dist);
    s.alpha[j] = alpha;
    s.keep[j] = one - alpha + tiny;
  }
  __syncwarp();
  Real wsum = zero;
  if (lane == 0) {
    Real T = one;
    for (int j = 0; j < nb; ++j) {
      const Real w = s.alpha[j] * T;
      T *= s.keep[j];
      if (j >= 1) {
        const Real wf = w + floor_w;       // the pdf's weight floor
        s.cdf[j] = wf;
        wsum += wf;
      }
    }
    s.cdf[0] = zero;
  }
  __syncwarp();
  wsum = __shfl_sync(0xffffffffu, wsum, 0);
  for (int k = 1 + lane; k < nb; k += 32) s.cdf[k] = s.cdf[k] / wsum;
  __syncwarp();
  if (lane == 0) {
    Real run = zero;
    for (int k = 1; k < nb; ++k) { run += s.cdf[k]; s.cdf[k] = run; }
  }
  __syncwarp();
  for (int jn = lane; jn < n_new; jn += 32) {
    const Real u = ((Real)jn + half) / (Real)n_new;
    int lo = 0, hi = nb;                 // inds: the entries of cdf <= u
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s.cdf[mid] <= u) lo = mid + 1;
      else hi = mid;
    }
    const int below = max(lo - 1, 0);
    const int above = min(lo, nb - 1);
    const Real zb = half * ((Real)s.v[below] + (Real)s.v[below + 1]);
    const Real za = half * ((Real)s.v[above] + (Real)s.v[above + 1]);
    Real denom = s.cdf[above] - s.cdf[below];
    if (denom < floor_w) denom = one;
    s.v[n0 + jn] = (float)(zb + (u - s.cdf[below]) / denom * (za - zb));
  }
  __syncwarp();
  for (int k = lane; k < K; k += 32)
    s.key[k] = (unsigned long long)rs_key(s.v[k]) << 32 | (unsigned)k;
  __syncwarp();
  constexpr int E = DN_K / 32;           // values a lane places
  unsigned long long mine[E];
  int rank[E];
#pragma unroll
  for (int t = 0; t < E; ++t) {
    mine[t] = lane + 32 * t < K ? s.key[lane + 32 * t] : ~0ull;
    rank[t] = 0;
  }
  for (int i = 0; i < K; ++i) {
    const unsigned long long ki = s.key[i];
#pragma unroll
    for (int t = 0; t < E; ++t) rank[t] += ki < mine[t] ? 1 : 0;
  }
#pragma unroll
  for (int t = 0; t < E; ++t)
    if (lane + 32 * t < K) s.sorted[rank[t]] = s.v[lane + 32 * t];
  __syncwarp();
  float* o = out + (size_t)r * out_stride;
  for (int k = lane; k < K; k += 32) o[k] = s.sorted[k];
}

template <class Real>
cudaError_t launch_dn_resample(int R, int n0, int n_new, const float* z, const float* sig,
                               const float* dn, int dn_stride, float* out, int out_stride,
                               cudaStream_t st) {
  dn_resample_warp_kernel<Real><<<(R + RS_WARPS - 1) / RS_WARPS, 32 * RS_WARPS, 0, st>>>(
      R, n0, n_new, z, sig, dn, dn_stride, out, out_stride);
  return cudaGetLastError();
}

// The full field at the K sorted depths of each ray -> pt [R * K][4]: raw
// sigma, rgb.
template <bool RB>
__global__ void __launch_bounds__(NT, 2)
dn_field_kernel(const float* __restrict__ wts, Model m, int R, int K,
                const float* __restrict__ rb, const float* __restrict__ zl,
                float* __restrict__ pt) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const DnTile s = dn_tile(smem, m);
  const long long base = (long long)blockIdx.x * P_DN;
  const long long n_pts = (long long)R * K;
  if (tid < P_DN) {
    const long long i = base + tid;
    float x[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f}, t = 0.f;
    if (i < n_pts) {
      const int r = (int)(i / K), j = (int)(i % K);
      const float* b = rb + (size_t)r * RB_STRIDE;
      const float z = zl[(size_t)r * DN_K + j];
      for (int k = 0; k < 3; ++k) { x[k] = dn_coord(b, k, z); d[k] = b[6 + k]; }
      t = b[9];
    }
    for (int k = 0; k < 3; ++k) {
      s.x[tid * 4 + k] = x[k];
      s.xc[tid * 4 + k] = x[k];
      s.d[tid * 4 + k] = d[k];
    }
    s.x[tid * 4 + 3] = t;
  }
  __syncthreads();
  if (m.use_deform) dn_deform<RB>(wts, m, s, tid);
  dn_density<RB>(wts, m, s, tid, base, n_pts, nullptr);
  dn_color<RB>(wts, m, s, tid);
  if (tid < P_DN) {
    const long long i = base + tid;
    if (i < n_pts) {
      float* q = pt + (size_t)i * 4;
      for (int k = 0; k < 4; ++k) q[k] = s.out[tid * 4 + k];
    }
  }
}

// The composite's constants in its arithmetic type.
template <class Real> struct DnConst;
template <> struct DnConst<float> {
  static constexpr float tiny = 1e-10f, eps = 1e-6f, far = 1e10f;
};
template <> struct DnConst<double> {
  static constexpr double tiny = 1e-10, eps = 1e-6, far = 1e10;
};

// raw2outputs of one ray over its K depths -> out [R][DN_OUT], in Real
// arithmetic on the float32 depths and field values. float: the SIMT
// render's and the float32 render's. double: the bf16 tensor-core render's:
// in float32 the faint rays' alpha = 1 - exp(-sigma dist) is a difference of
// two numbers near 1, quantised to float32's ulp there, and the running
// transmittance and sums add their own roundings, a floor both renders
// shared under their distance from the float64 yardstick (PERF.md §6;
// csrc/fused_render.cu's composite_kernel, the EndoSurf render's, likewise).
template <class Real>
__global__ void dn_composite_kernel(int R, int K, const float* __restrict__ rb,
                                    const float* __restrict__ zl, const float* __restrict__ pt,
                                    float* __restrict__ out) {
  using C = DnConst<Real>;
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const Real dn = rb[(size_t)r * RB_STRIDE + 10], one = 1.f, zero = 0.f;
  const float* z = zl + (size_t)r * DN_K;
  Real T = one, c0 = zero, c1 = zero, c2 = zero, acc = zero, dsum = zero;
  for (int j = 0; j < K; ++j) {
    const float* q = pt + ((size_t)r * K + j) * 4;
    const Real dist = (j < K - 1 ? (Real)z[j + 1] - (Real)z[j] : (Real)C::far) * dn;
    const Real alpha = one - exp_r(-fmax((Real)q[0], zero) * dist);
    const Real w = alpha * T;
    T *= one - alpha + C::tiny;
    c0 += w * q[1]; c1 += w * q[2]; c2 += w * q[3];
    acc += w;
    dsum += w * z[j] * dn;
  }
  const Real disp = one / fmax(C::tiny, dsum / (acc + C::eps));
  float* o = out + (size_t)r * DN_OUT;
  o[0] = c0; o[1] = c1; o[2] = c2;
  o[3] = one / (disp + C::eps);
  o[4] = acc;
}

// The field at the K sorted depths of each ray on tensor cores (bf16) ->
// pt [R * K][4]: dn_field_kernel<true>'s maths, the products on
// dnerf_tc.cuh's tile (the encodings, x_c, the raw column and rgb in
// double); the colour input's feature goes from the density's output
// product straight into the colour net's operand rows.
__global__ void __launch_bounds__(NT, 2)
dn_field_tc_kernel(const float* __restrict__ wts, const __grid_constant__ Model m,
                   const __grid_constant__ DnFrags fr, int R, int K,
                   const float* __restrict__ rb, const float* __restrict__ zl,
                   float* __restrict__ pt) {
  constexpr int MT = DT_MT;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ldh = dt_ldh(m);
  uint4* ring = (uint4*)tc_smem + warp * (TC_STAGES * TC_NPW * 32);
  const DtTile s = dt_tile(tc_smem, m, DT_FWD);
  bf16* H = s.H;
  const bf16* const A1[1] = {H};
  const long long base = (long long)blockIdx.x * DT_P;
  const long long n_pts = (long long)R * K;
  for (int idx = tid; idx < DT_P * ldh; idx += NT) H[idx] = bzero();
  if (tid < DT_P) {
    const long long i = base + tid;
    float x[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f}, t = 0.f;
    if (i < n_pts) {
      const int r = (int)(i / K), j = (int)(i % K);
      const float* b = rb + (size_t)r * RB_STRIDE;
      const float z = zl[(size_t)r * DN_K + j];
      for (int k = 0; k < 3; ++k) { x[k] = dn_coord(b, k, z); d[k] = b[6 + k]; }
      t = b[9];
    }
    for (int k = 0; k < 3; ++k) { s.x[tid * 4 + k] = x[k]; s.d[tid * 4 + k] = d[k]; }
    s.x[tid * 4 + 3] = t;
  }
  __syncthreads();
  dt_deform<true>(wts, m, fr, s, ldh, ring);
  dt_density<true>(wts, m, fr, s, ldh, ring);

  // the feature: columns 1 .. F of the density's output layer, a tile product
  // from op(h_{L-2}), + the bias, rounded: the colour input's columns cr ..
  const Net& S = m.sdf;
  const int lo = S.n_layers - 1, F = m.feat_dim, cr = m.cr;
  const int np_me = warp * TC_NPW, np_f = c16(F) / 16, npw = clampw(np_f - np_me);
  float acc[MT][2 * TC_NPW][4];
  zero_acc(acc);
  tile_mma<MT, 1>(acc, A1, ldh, (const uint4*)(wts + fr.density[lo]), np_f, np_me, npw, 0,
                  c16(S.in_dim[lo]) / 16, ring, lane);
  __syncthreads();                               // h_{L-2} read: H takes the colour input
  dt_encode<true>(s.d, m.f_cdir, s.E, cr, tid);
  const float* bf = wts + S.b_off[lo] + 1;
  for_pairs(acc, np_me, npw, lane, [&](int row, int c, float a0, float a1) {
    const float a[2] = {a0, a1};
    for (int e = 0; e < 2; ++e)
      if (c + e < F) H[row * ldh + cr + c + e] = __float2bfloat16_rn(a[e] + bf[c + e]);
  });
  __syncthreads();
  const int pad = c16(cr + F) - cr - F;
  for (int idx = tid; idx < DT_P * (cr + pad); idx += NT) {   // [enc(d) | feat | 0 ..]
    const int p = idx / (cr + pad), c = idx - p * (cr + pad);
    if (c < cr) H[p * ldh + c] = s.E[p * cr + c];
    else H[p * ldh + F + c] = bzero();
  }
  __syncthreads();
  const Net& C = m.color;
  dt_hidden<false>(C, wts, fr.color, H, ldh, s.E, cr, ring, 0, 0, nullptr, nullptr);
  for (int idx = tid; idx < 3 * DT_P; idx += NT) {
    const int p = idx / 3, col = idx - p * 3;
    s.out[p * 4 + 1 + col] = (float)(1.0 / (1.0 + exp(-dt_out_col(C, wts, H, ldh, p, col))));
  }
  __syncthreads();
  if (tid < DT_P && base + tid < n_pts)
    for (int k = 0; k < 4; ++k) pt[(size_t)(base + tid) * 4 + k] = s.out[tid * 4 + k];
}

cudaError_t launch_dn_field_tc(const float* w, const Model& m, const DnFrags& fr, int R, int K,
                               const float* rb, const float* zl, float* pt, cudaStream_t st) {
  const size_t smem = dt_smem(m, DT_FWD);
  cudaError_t e = set_smem(dn_field_tc_kernel, smem);
  if (e != cudaSuccess) return e;
  dn_field_tc_kernel<<<n_tiles((long long)R * K, DT_P), NT, smem, st>>>(w, m, fr, R, K, rb, zl,
                                                                        pt);
  return cudaGetLastError();
}

template <bool RB>
cudaError_t launch_dn_field(const float* w, const Model& m, int R, int K, const float* rb,
                            const float* zl, float* pt, cudaStream_t st) {
  size_t smem;
  cudaError_t e = dn_prepare(dn_field_kernel<RB>, m, smem);
  if (e != cudaSuccess) return e;
  const long long n = (long long)R * K;
  dn_field_kernel<RB><<<(unsigned)((n + P_DN - 1) / P_DN), NT, smem, st>>>(w, m, R, K, rb, zl,
                                                                            pt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch the caller must allocate for R rays.
long long fused_render_dnerf_scratch_floats(int R) {
  return (long long)R * (RB_STRIDE + DN_N0 + DN_K + DN_K * 4);
}

// rays [R, 9]; z0 [R, n0] the sorted initial depths; w_samp / w_main packed
// weights for the sampling / main precision (same layout, described by meta;
// kernels/fused_train_dnerf.pack_dnerf); out [R, 5] (rgb, depth, acc). With
// tc a bf16 pass runs on tensor cores: meta then carries the bf16 pack's
// fragment extension (decode_dn_frags). With tc = 0 both passes run the SIMT
// code. Runs on the calling thread's current device, which the caller sets
// to the tensors' device. Returns a cudaError_t (0 on success).
int fused_render_dnerf_launch(const float* rays, const float* z0, int R, int n0, int n_new,
                              const float* w_samp, const float* w_main, const long long* meta,
                              int rb_samp, int rb_main, int tc, float* scratch, float* out,
                              void* stream) {
  if (R <= 0) return 0;
  if (n0 < 3 || n0 > DN_N0 || n_new < 1 || n_new > DN_N0 || n0 + n_new > DN_K)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  cudaStream_t st = (cudaStream_t)stream;
  const Model m = decode_model(meta);
  float* rb = scratch;
  float* sig = rb + (size_t)R * RB_STRIDE;
  float* zl = sig + (size_t)R * DN_N0;
  float* pt = zl + (size_t)R * DN_K;
  const int K = n0 + n_new;
  const int tpb = 128;
  const int rblocks = (R + tpb - 1) / tpb;

  const DnFrags fr = tc && (rb_samp || rb_main) ? decode_dn_frags(meta) : DnFrags{};
  dn_prep_kernel<<<rblocks, tpb, 0, st>>>(rays, R, rb);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const DnRaySamples coarse{rb, z0, n0, sig, (long long)R * n0};
  e = tc && rb_samp ? launch_dn_sweep_tc(w_samp, m, fr, coarse, st)
                    : launch_sweep<DNeRFChain>(w_samp, m, rb_samp != 0, coarse, st);
  if (e != cudaSuccess) return (int)e;
  e = tc && rb_main
          ? launch_dn_resample<double>(R, n0, n_new, z0, sig, rb + 10, RB_STRIDE, zl, DN_K, st)
          : launch_dn_resample<float>(R, n0, n_new, z0, sig, rb + 10, RB_STRIDE, zl, DN_K, st);
  if (e != cudaSuccess) return (int)e;
  if (tc && rb_main) e = launch_dn_field_tc(w_main, m, fr, R, K, rb, zl, pt, st);
  else if (rb_main) e = launch_dn_field<true>(w_main, m, R, K, rb, zl, pt, st);
  else e = launch_dn_field<false>(w_main, m, R, K, rb, zl, pt, st);
  if (e != cudaSuccess) return (int)e;
  if (tc && rb_main) dn_composite_kernel<double><<<rblocks, tpb, 0, st>>>(R, K, rb, zl, pt, out);
  else dn_composite_kernel<float><<<rblocks, tpb, 0, st>>>(R, K, rb, zl, pt, out);
  return (int)cudaGetLastError();
}

// z [R, n0] sorted, sigma [R, n0] (after the noise and the relu), dn [R, 1]
// |rays_d| -> out [R, n0 + n_new] sorted. Returns a cudaError_t (0 on
// success).
int fused_fine_resample_launch(const float* z, const float* sigma, const float* dn, int R, int n0,
                               int n_new, float* out, void* stream) {
  if (R <= 0) return 0;
  if (n0 < 3 || n0 > DN_N0 || n_new < 1 || n_new > DN_N0) return (int)cudaErrorInvalidValue;
  return (int)launch_dn_resample<float>(R, n0, n_new, z, sigma, dn, 1, out, n0 + n_new,
                                        (cudaStream_t)stream);
}

}  // extern "C"
