// The bf16 ("default" dot mode) sampling sweep of the EndoSurf chain on
// Hopper's tensor cores: observed point -> deform MLP (relu) -> x_c -> SDF
// MLP (softplus100) -> head column -> sdf, the arithmetic of sdf_chain.cuh's
// sweep_kernel and sweep_mlp for EndoSurfChain over a point source
// (RaySamples, PointList), with each hidden layer's product on mma.sync
// (mma_tile.cuh). fused_sampler.cu's upsampling and ray march, the render's
// sweeps (fused_render.cu) and the observed-SDF grid query (fused_sdf.cu)
// run it in bf16; the float32 mode keeps the SIMT sweep.
//
// Replaces, for the bf16 mode, the SIMT sweep inside the ports of the Pallas
// TPU kernels endosurf_tpu/kernels/fused_sampler.py (fused_upsample_z,
// fused_ray_march): there
// the weights stay in VMEM and the sample groups stream through the MXU.
// Here a block of NT threads owns a tile of 16 MT points: the layer's operand
// rows sit in shared memory as bf16, the weights stream from L2 in fragment
// order through each warp's cp.async ring, and each warp owns 32 output
// columns of every row (hidden layers are at most 256 wide: one pass).
//
// The order of rounding is the sampling chain's, not the train segments':
// a skip scales its operand before the dot. Layer l's operand is layer 0's
// encoding E0 = op(enc), or [op(h_{l-1} * post) | Es = op(enc * kSkip)] at a
// skip layer, where post = kSkip on the layer before a skip and 1 elsewhere;
// z = dot + b, h = act(z), stored op(h * post). The coordinates go into the
// encodings unrounded. The deform net's 3-wide output layer and the SDF
// head stay SIMT, each an FMA chain in k order from the bf16 rows, as
// sweep_kernel's.
//
// Between those bf16 roundings the kernel computes closer to exact than the
// SIMT sweep's float32 FMA chains (PERF.md §6, PR 9): a float32 sum in any
// order tips a rounding now and then, and the sharpness carries a tipped SDF
// into every later round, so a kernel only as precise as the SIMT sweep,
// summed in another order, lands nearer to or farther from exact ray by ray.
// The mma adds a k-tile's products aligned to the largest of them and
// truncated within 2^-23 of it, which loses much of the small ones (the
// softplus tails): so each row's operands go in as two terms, those under
// 1/16 of the row's largest apart from the rest, each term's k-tile from
// zero, and each k-tile's sum is promoted with its rounding error kept
// (tile_mma_split: hi + lo). The epilogue rounds act(hi + lo + b) * post in
// float32 and redoes it in double where that value lies within its error
// bound of a bf16 tie (sweep_round); the encodings (sin, cos), the deform
// output layer, x_c and the head run in double. A double goes to bf16
// through float32, as the float64 plain version rounds (bf16_rn_d).
//
// What bounds it: the two 9x256 MLPs at every point, 1.877 MFLOP a point
// (0.123 TFLOP for the train step's 65,536 sweep points; 0.12 ms at the bf16
// tensor-core rate); the bytes (a point's 7 floats in, 1 out, the 1.2 MB of
// bf16 weights) are far below. The weights are read from L2 once per tile.
//
// Anonymous namespace: one copy per .cu, as sdf_chain.cuh.

#pragma once

#include "sdf_chain.cuh"
#include "mma_tile.cuh"

#define SW_MT 2                  // m-tiles (16 points each) of a sweep tile (hi + lo
                                 // accumulators: 64 registers a thread): the kernel's
                                 // template argument MT, 1 for the march's secant
                                 // sweeps (R x 1 points: twice the blocks)

static_assert(TC_WARPS * 32 == NT, "a warp owns 32 of the tile's 256 output columns");

namespace {

// Float offsets (in the packed weights) of each hidden layer's W [in][out]
// as bf16 mma B operands in fragment order: the meta's extension that
// fused_sampler.pack_sampling writes in the bf16 mode (-1: no fragments, the
// output layers and an absent deform net).
struct SweepFrags {
  long long deform[NL], sdf[NL];
};

SweepFrags decode_sweep_frags(const long long* meta) {
  SweepFrags f;
  for (int l = 0; l < NL; ++l) {
    f.deform[l] = meta[META_LEN + l];
    f.sdf[l] = meta[META_LEN + NL + l];
  }
  return f;
}

// Row pitch (bf16) of the operand rows: the widest padded hidden-layer input
// or output of either net, + 8 (16 bytes x odd).
__host__ __device__ inline int sweep_ldh(const Model& m) {
  int k = 16;
  for (int l = 0; l < NL - 1; ++l) {
    const Net* nets[2] = {&m.deform, &m.sdf};
    for (int q = m.use_deform ? 0 : 1; q < 2; ++q) {
      if (l >= nets[q]->n_layers - 1) continue;
      const int w = c16(nets[q]->in_dim[l]) > c16(nets[q]->out_dim[l]) ? c16(nets[q]->in_dim[l])
                                                                       : c16(nets[q]->out_dim[l]);
      k = w > k ? w : k;
    }
  }
  return k + 8;
}

// A tile's shared memory after the weight ring, for P points: x_c [P][4]
// (double), x and t [P][4], each row's largest operand [P] (float32), the
// operand rows' large and small terms H and Hs [P][ldh], the encoding E0 and
// its skip-scaled copy Es [P][emax] (bf16).
struct SweepTile {
  double* xc;
  float *xs, *rmax;
  bf16 *H, *Hs, *E0, *Es;
};

inline size_t sweep_tc_smem(const Model& m, int P) {
  const int emax = m.ed > m.es ? m.ed : m.es;
  return TC_RING_BYTES + (size_t)P * 4 * 8 + (size_t)P * 5 * 4
         + (size_t)2 * P * sweep_ldh(m) * 2 + (size_t)2 * P * emax * 2;
}

__device__ __forceinline__ SweepTile sweep_tile(unsigned char* smem, const Model& m, int P) {
  const int emax = m.ed > m.es ? m.ed : m.es;
  SweepTile t;
  t.xc = (double*)(smem + TC_RING_BYTES);
  t.xs = (float*)(t.xc + P * 4);
  t.rmax = t.xs + P * 4;
  t.H = (bf16*)(t.rmax + P);                      // 16-byte aligned: the sizes above are
  t.Hs = t.H + P * sweep_ldh(m);
  t.E0 = t.Hs + P * sweep_ldh(m);
  t.Es = t.E0 + P * emax;
  return t;
}

constexpr double kSkipD = 0.70710678118654752440;   // EndoSurfChain::kSkip in double

// A double rounded to bf16 as the float64 plain version rounds its operands
// (PyTorch's conversion): to float32, then to bf16, each to nearest even.
__device__ __forceinline__ bf16 bf16_rn_d(double x) { return __float2bfloat16_rn((float)x); }

// E0 / Es [P][ew] of the encoding of s[p * 4 + 0 .. 2] (and, for the deform
// net, the time s[p * 4 + 3]) at the coordinates as they are, in double.
template <class T>
__device__ __forceinline__ void sweep_encode(bf16* E0, bf16* Es, const T* s, int ew, int ex,
                                             int P, int tid) {
  for (int idx = tid; idx < P * ew; idx += NT) {
    const int p = idx / ew, c = idx - p * ew;
    int dim, kind; float sc;
    if (c < ex) enc_col(c, 3, dim, kind, sc);
    else { enc_col(c - ex, 1, dim, kind, sc); dim = 3; }
    const double v = (double)s[p * 4 + dim] * sc;
    const double e = kind == 0 ? v : (kind == 1 ? sin(v) : cos(v));
    E0[idx] = bf16_rn_d(e);
    Es[idx] = bf16_rn_d(e * kSkipD);
  }
}

// op(act(z) * post) for z = hi + lo + b: in float32, and in double where the
// float32 value lies within its error bound of a bf16 tie (or of 0 for a
// relu). The bound: the float32 z within 2^-23 (|z| + |b| + |lo|) of
// hi + lo + b, times act's slope (relu 1; softplus100 sigma(100 z) <=
// exp(100 z) below 0) and post; act, the product and post's float32
// rounding within 2^-19 |v|.
__device__ __forceinline__ bf16 sweep_round(float hi, float lo, float b, bool relu, float post,
                                            double post_d) {
  const float z = hi + (lo + b);
  const float v = (relu ? fmaxf(z, 0.f) : softplus100(z)) * post;
  const float dz = 0x1p-23f * (fabsf(z) + fabsf(b) + fabsf(lo));
  bool redo;
  if (relu && z <= 0.f) {
    redo = z > -dz;
  } else {
    const float slope = relu || z >= 0.f ? 1.f : fminf(1.f, 2.f * __expf(100.f * z));
    const float band = dz * slope * post + 0x1p-19f * v;
    const float tie = __uint_as_float((__float_as_uint(v) & 0xFFFF0000u) | 0x8000u);
    redo = fabsf(v - tie) <= band || band >= 0x1p-10f * v;
  }
  if (!redo) return __float2bfloat16_rn(v);
  const double zd = (double)hi + (double)lo + (double)b;
  double h;
  if (relu) {
    h = fmax(zd, 0.0);
  } else {
    const double x = 100.0 * zd;
    h = (fmax(x, 0.0) + log1p(exp(-fabs(x)))) / 100.0;
  }
  return bf16_rn_d(h * post_d);
}

// Hidden layers 0 .. L-2 of net N (L = N.n_layers) on a tile of MT m-tiles (sweep_mlp's
// arithmetic, the products as split tile products with hi + lo sums, the
// epilogue sweep_round); leaves the output layer's operand rows in t.H. A
// row's arithmetic does not depend on MT.
template <int MT>
__device__ __forceinline__ void sweep_tc_mlp(const Net& N, const float* __restrict__ wts,
                                             const long long* frag, bool relu,
                                             const SweepTile& t, int ldh, const bf16* E0,
                                             const bf16* Es, int ew, uint4* ring) {
  constexpr int P = 16 * MT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, tq = lane & 3;
  bf16* H = t.H;
  const bf16* const A2[2] = {H, t.Hs};
  const int np_me = warp * TC_NPW;               // the warp's columns: 32 warp ..
  put_enc(H, ldh, 0, E0, ew, P, tid);
  __syncthreads();
  float acc[MT][2 * TC_NPW][4], lo[MT][2 * TC_NPW][4];
  for (int l = 0; l < N.n_layers - 1; ++l) {
    const int in_l = N.in_dim[l], out_l = N.out_dim[l], kp = c16(in_l);
    if (l > 0 && ((N.skip_mask >> l) & 1)) {
      put_enc(H, ldh, in_l - ew, Es, ew, P, tid);
      __syncthreads();
    }
    for (int r = warp; r < P; r += TC_WARPS) {     // each row's largest operand
      float mx = 0.f;
      for (int k = lane; k < in_l; k += 32) mx = fmaxf(mx, fabsf(__bfloat162float(H[r * ldh + k])));
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) t.rmax[r] = mx;
    }
    __syncthreads();
    for (int idx = tid; idx < P * kp; idx += NT) {      // the small operands apart
      const int r = idx / kp, k = idx - r * kp;
      const bf16 h = H[r * ldh + k];
      const bool small = fabsf(__bfloat162float(h)) < 0.0625f * t.rmax[r];
      t.Hs[r * ldh + k] = small ? h : bzero();
      if (small) H[r * ldh + k] = bzero();
    }
    __syncthreads();
    const int np_out = c16(out_l) / 16, npw = clampw(np_out - np_me);
    zero_acc(acc);
    zero_acc(lo);
    tile_mma_split<MT, 2>(acc, lo, A2, ldh, (const uint4*)(wts + frag[l]), np_out, np_me, npw, 0,
                          kp / 16, ring, lane);
    __syncthreads();
    const bool skip_next = (N.skip_mask >> (l + 1)) & 1;
    const float post = skip_next ? EndoSurfChain::kSkip : 1.f;
    const double post_d = skip_next ? kSkipD : 1.0;
    const float* b = wts + N.b_off[l];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2 * TC_NPW; ++nt) {
        if (nt >= 2 * npw) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = mt * 16 + g + (e >> 1) * 8, c = np_me * 16 + nt * 8 + 2 * tq + (e & 1);
          // the padding to c16(out_l) stays zero
          H[row * ldh + c] = c < out_l
              ? sweep_round(acc[mt][nt][e], lo[mt][nt][e], b[c], relu, post, post_d) : bzero();
        }
      }
    __syncthreads();
  }
}

// The sdf of 16 MT points of src a block; points past src.n load zeros and
// store nothing.
template <class Src, int MT>
__global__ void __launch_bounds__(NT, 2)
sweep_tc_kernel(const float* __restrict__ wts, const __grid_constant__ Model m,
                const __grid_constant__ SweepFrags fr, const __grid_constant__ Src src) {
  constexpr int P = 16 * MT;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int ldh = sweep_ldh(m);
  uint4* ring = (uint4*)tc_smem + warp * (TC_STAGES * TC_NPW * 32);
  const SweepTile t = sweep_tile(tc_smem, m, P);
  const long long base = (long long)blockIdx.x * P;

  for (int idx = tid; idx < P * ldh; idx += NT) t.H[idx] = bzero();
  if (tid < P) {
    float x0 = 0.f, x1 = 0.f, x2 = 0.f, tt = 0.f;
    if (base + tid < src.n) src.load(base + tid, x0, x1, x2, tt);
    t.xs[tid * 4 + 0] = x0; t.xs[tid * 4 + 1] = x1; t.xs[tid * 4 + 2] = x2; t.xs[tid * 4 + 3] = tt;
  }
  __syncthreads();

  if (m.use_deform) {
    const Net& N = m.deform;
    sweep_encode(t.E0, t.Es, t.xs, m.ed, enc_width(3, m.f_dpos), P, tid);
    __syncthreads();
    sweep_tc_mlp<MT>(N, wts, fr.deform, true, t, ldh, t.E0, t.Es, m.ed, ring);
    // output layer: dx (3 columns), x_c = x + dx
    const int l = N.n_layers - 1, n_out = N.out_dim[l];
    const float* W = wts + N.w_off[l];
    for (int idx = tid; idx < 3 * P; idx += NT) {
      const int p = idx / 3, col = idx - p * 3;
      double a = 0.0;
      for (int k = 0; k < N.in_dim[l]; ++k)
        a = fma((double)__bfloat162float(t.H[p * ldh + k]),
                (double)__ldg(W + (size_t)k * n_out + col), a);
      t.xc[p * 4 + col] = (double)t.xs[p * 4 + col] + (a + (double)wts[N.b_off[l] + col]);
    }
  } else {
    for (int idx = tid; idx < 3 * P; idx += NT) {
      const int p = idx / 3, col = idx - p * 3;
      t.xc[p * 4 + col] = (double)t.xs[p * 4 + col];
    }
  }
  __syncthreads();

  const Net& S = m.sdf;
  sweep_encode(t.E0, t.Es, t.xc, m.es, m.es, P, tid);
  __syncthreads();
  sweep_tc_mlp<MT>(S, wts, fr.sdf, false, t, ldh, t.E0, t.Es, m.es, ring);
  // head: column 0 of the SDF output layer
  if (tid < P) {
    const int l = S.n_layers - 1, n_out = S.out_dim[l];
    const float* W = wts + S.w_off[l];
    double a = 0.0;
    for (int k = 0; k < S.in_dim[l]; ++k)
      a = fma((double)__bfloat162float(t.H[tid * ldh + k]), (double)__ldg(W + (size_t)k * n_out),
              a);
    if (base + tid < src.n) src.store(base + tid, (float)(a + (double)wts[S.b_off[l]]));
  }
}

template <class Src, int MT = SW_MT>
cudaError_t launch_sweep_tc(const float* w, const Model& m, const SweepFrags& fr, const Src& src,
                            cudaStream_t st) {
  if (src.n <= 0) return cudaSuccess;
  constexpr int P = 16 * MT;
  const size_t smem = sweep_tc_smem(m, P);
  cudaError_t e = cudaFuncSetAttribute(sweep_tc_kernel<Src, MT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (src.n + P - 1) / P;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  sweep_tc_kernel<Src, MT><<<(unsigned)blocks, NT, smem, st>>>(w, m, fr, src);
  return cudaGetLastError();
}

// K samples per ray: z[r * ldz + j] -> dst[r * ldd + j], j < K; tiles of
// 16 MT points.
template <int MT = SW_MT>
cudaError_t sweep_rays_tc(const float* w, const Model& m, const SweepFrags& fr, int R, int K,
                          const float* b, const float* z, int ldz, float* dst, int ldd,
                          cudaStream_t st) {
  RaySamples src{b, z, ldz, K, dst, ldd, (long long)R * K};
  return launch_sweep_tc<RaySamples, MT>(w, m, fr, src, st);
}

}  // namespace
