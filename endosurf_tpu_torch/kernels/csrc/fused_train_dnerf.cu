// The D-NeRF field segments for NVIDIA Hopper (sm_90a), CUDA C++: forward
// and backward of the three segments of the EndoNeRF field.
//
// Replace the Pallas TPU kernels of endosurf_tpu/kernels/fused_train_dnerf.py
// (through fused_train_pallas._seg_pallas), the segments of
// megakernel_field_raw:
//
//   dnerf_deform_fwd   xt [N, 4] (x, t)        -> x_c [N, 3] = x + deform
//   dnerf_density_fwd  x_c [N, 3]              -> raw sigma [N, 1], feat [N, F]
//   dnerf_color_fwd    d [N, 3], feat [N, F]   -> rgb [N, 3] (sigmoid)
//     (_deform_fwd_pl, _density_fwd_pl, _color_fwd_pl)
//   dnerf_deform_bwd   d x_c                   -> deform weight gradients
//   dnerf_density_bwd  d raw sigma, d feat     -> density weight gradients, d x_c
//   dnerf_color_bwd    d rgb                   -> colour weight gradients, d feat
//     (_deform_bwd_pl, _density_bwd_pl, _color_bwd_pl; xt and d get no
//     cotangent, JAX's custom_vjp rules)
//
// The forwards are thin entries over dnerf_chain.cuh's per-point code (the
// EndoNeRF render kernel's fine evaluation runs the same functions). The
// TPU kernels' 128-lane padding of the 3-vectors, selector matmuls and lane
// rolls are layout, not math, and are not carried over.
//
// Backward kernels (the design of fused_train.cu's): per tile of P_DN
// points, recompute the forward with dnerf_chain.cuh's SAVE (every layer's
// dot operands to a global scratch), walk the layers backward from the
// output cotangent -- each layer's input cotangent is the sum over its
// outputs of the pre-activation cotangent times W^T (packed beside W),
// relu-gated by the saved operand -- and save each layer's pre-activation
// cotangent. The weight gradients are then dW_l = xin_l^T dz_l and db_l =
// 1^T dz_l over the point axis, wgrad.cuh's fixed-order product (two calls
// give the same bits). The skips are unscaled (nerf-style concat); the
// density head's cotangent reaches h as two separately rounded dots (sigma
// column, feature columns), as the plain version's two dots; d x_c goes back
// through the encoding's derivative.
//
// Precision: with RB every dot operand is rounded to bf16, as the forward;
// the backward keeps the rounding PyTorch's autograd gives the plain version
// (ops/mlp.py dot: x.to(bf16).to(f32)): the cotangent leaving each dot for
// its input and each dot's weight gradient (summed over all points) are
// rounded to bf16, and d x_c leaving the rounded coordinate; biases are not.
//
// What bounds them: the MLPs (deform 0.99 MFLOP a point forward, density
// 1.13, colour 0.07 with the 9x256 / 9x256 / 2x128 nets; a backward about
// 3x its forward: recompute, input cotangents, weight gradients); per-point
// inputs and outputs are at most 262 floats. Plain SIMT float32 FMA with
// bf16-rounded operands under rb; tensor cores are later work. The scratch
// (every layer's operands and cotangents: 4,267 floats a point for the
// deform net, 4,479 for the density net) is written once and read once by
// the product: 4.5-4.7 GB at the train step's 262,144 points.

#include "dnerf_chain.cuh"
#include "wgrad.cuh"

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

// ---------------------------------------------------------------------------
// backward kernels
// ---------------------------------------------------------------------------

// Walks layers l0 .. 0 of net N backward. cur [P][HMAX] holds the cotangent
// on layer l0's pre-activation. Per layer: save it to sv.dz[l], then form the
// cotangent on the layer's input rows, each rounded under RB: the h rows,
// relu-gated by the saved operand, become the next layer's cotangent (in
// nxt); the section rows -- [sec0, in_0) of layer 0 and, with skip_sec, the
// encoding rows of a skip layer -- add into dsec [P][ldsec].
template <bool RB>
__device__ void dn_bwd_walk(const Net& N, const float* __restrict__ wts, int l0, float* cur,
                            float* nxt, int ew, int sec0, bool skip_sec, float* dsec,
                            int ldsec, const DnScratch& sv, long long base, long long n,
                            int tid) {
  const int P = P_DN;
  for (int l = l0; l >= 0; --l) {
    const int in_l = N.in_dim[l], out_l = N.out_dim[l];
    const bool skip = (N.skip_mask >> l) & 1;
    const int n_h = l == 0 ? 0 : (skip ? in_l - ew : in_l);
    const int lo = l == 0 ? sec0 : (skip && skip_sec ? n_h : in_l);
    dn_save(sv.dz[l], base, n, cur, HMAX, out_l, nullptr, 0, 0, tid);
    const float* WT = wts + N.wt_off[l];
    for (int i = tid; i < in_l; i += NT) {
      if (i >= n_h && i < lo) continue;
      float acc[P];
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] = 0.f;
      acc_seg<P>(acc, WT, in_l, i, 0, cur, HMAX, out_l);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float v = opnd<RB>(acc[p]);
        if (i < n_h) {
          const bool on = base + p < n && sv.xin[l][(size_t)(base + p) * in_l + i] > 0.f;
          nxt[p * HMAX + i] = on ? v : 0.f;
        } else {
          dsec[p * ldsec + i - lo] += v;
        }
      }
    }
    __syncthreads();
    float* t = cur; cur = nxt; nxt = t;
  }
}

// Shared memory beyond the forward tile: a second [P][HMAX] cotangent buffer
// and the section cotangent (density: d enc [P][es]; colour: d feat [P][F]).
__host__ __device__ inline size_t dn_bwd_smem_floats(const Model& m, int seg) {
  const int sec = seg == 1 ? m.es : (seg == 2 ? m.feat_dim : 0);
  return dn_smem_floats(m) + (size_t)P_DN * (HMAX + sec);
}

// Cotangent on x_c [n][3] -> the deform net's pre-activation cotangents and
// operands in sv (x_c = x + z_last: d z_last = d x_c; xt gets none).
template <bool RB>
__global__ void __launch_bounds__(NT, 2)
dnerf_deform_bwd_kernel(const float* __restrict__ wts, Model m, long long n,
                        const float* __restrict__ xt, const float* __restrict__ g_xc,
                        const __grid_constant__ DnScratch sv) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const DnTile s = dn_tile(smem, m);
  float* extra = smem + dn_smem_floats(m);
  const long long base = (long long)blockIdx.x * P_DN;
  if (tid < 4 * P_DN) {
    const long long i = base + tid / 4;
    s.x[tid] = i < n ? xt[(size_t)i * 4 + (tid & 3)] : 0.f;
  }
  __syncthreads();
  dn_deform<RB, true>(wts, m, s, tid, sv, base, n);
  float* cur = s.h;                     // free after the recompute: its operands are saved
  if (tid < 3 * P_DN) {
    const int p = tid / 3, c = tid - p * 3;
    cur[p * HMAX + c] = base + p < n ? g_xc[(size_t)(base + p) * 3 + c] : 0.f;
  }
  __syncthreads();
  const Net& N = m.deform;
  dn_bwd_walk<RB>(N, wts, N.n_layers - 1, cur, extra, m.ed, N.in_dim[0], false, nullptr, 0, sv,
                  base, n, tid);
}

// Cotangents on raw sigma [n] and feat [n][F] -> d x_c [n][3] and the density
// net's cotangents and operands in sv.
template <bool RB>
__global__ void __launch_bounds__(NT, 2)
dnerf_density_bwd_kernel(const float* __restrict__ wts, Model m, long long n,
                         const float* __restrict__ xc, const float* __restrict__ g_raw,
                         const float* __restrict__ g_feat, float* __restrict__ dxc,
                         const __grid_constant__ DnScratch sv) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int P = P_DN;
  const DnTile s = dn_tile(smem, m);
  float* nxt = smem + dn_smem_floats(m);        // [P][HMAX]
  float* d_enc = nxt + P * HMAX;                // [P][es]
  const int es = m.es, F = m.feat_dim, G = 1 + F;
  const long long base = (long long)blockIdx.x * P;
  if (tid < 3 * P) {
    const int p = tid / 3, c = tid - p * 3;
    s.xc[p * 4 + c] = base + p < n ? xc[(size_t)(base + p) * 3 + c] : 0.f;
  }
  for (int idx = tid; idx < P * es; idx += NT) d_enc[idx] = 0.f;
  __syncthreads();
  dn_density<RB, true>(wts, m, s, tid, base, n, nullptr, sv);

  // the output layer [sigma | feat]: its cotangent [P][G] in s.h and s.e (free now)
  float* gout = s.h;
  for (int idx = tid; idx < P * G; idx += NT) {
    const int p = idx / G, f = idx - p * G;
    float g = 0.f;
    if (base + p < n) g = f == 0 ? g_raw[base + p] : g_feat[(size_t)(base + p) * F + f - 1];
    gout[idx] = g;
  }
  __syncthreads();
  const Net& N = m.sdf;
  const int L = N.n_layers;
  dn_save(sv.dz[L - 1], base, n, gout, G, G, nullptr, 0, 0, tid);
  {
    const int n_in = N.in_dim[L - 1];
    const float* WT = wts + N.wt_off[L - 1];    // [G][n_in]
    for (int i = tid; i < n_in; i += NT) {
      float acc_h[P], acc_f[P];
#pragma unroll
      for (int p = 0; p < P; ++p) { acc_h[p] = 0.f; acc_f[p] = 0.f; }
      acc_seg<P>(acc_h, WT, n_in, i, 0, gout, G, 1);
      acc_seg<P>(acc_f, WT, n_in, i, 1, gout + 1, G, F);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const bool on = base + p < n && sv.xin[L - 1][(size_t)(base + p) * n_in + i] > 0.f;
        nxt[p * HMAX + i] = on ? opnd<RB>(acc_h[p]) + opnd<RB>(acc_f[p]) : 0.f;
      }
    }
  }
  __syncthreads();
  dn_bwd_walk<RB>(N, wts, L - 2, nxt, s.h, es, 0, true, d_enc, es, sv, base, n, tid);

  // d x_c through the encoding: column c of dim mm is v = op(x_c) 2^f, its
  // value v, sin v or cos v
  if (tid < P * 3) {
    const int p = tid / 3, mm = tid - p * 3;
    const float x = opnd<RB>(s.xc[p * 4 + mm]);
    float g = 0.f;
    for (int c = 0; c < es; ++c) {
      int dim, kind; float sc;
      enc_col(c, 3, dim, kind, sc);
      if (dim != mm) continue;
      const float v = x * sc;
      g += d_enc[p * es + c] * (kind == 0 ? 1.f : (kind == 1 ? cosf(v) : -sinf(v))) * sc;
    }
    if (base + p < n) dxc[(size_t)(base + p) * 3 + mm] = opnd<RB>(g);
  }
}

// Cotangent on rgb [n][3] -> d feat [n][F] and the colour net's cotangents
// and operands in sv (d gets none).
template <bool RB>
__global__ void __launch_bounds__(NT, 2)
dnerf_color_bwd_kernel(const float* __restrict__ wts, Model m, long long n,
                       const float* __restrict__ d, const float* __restrict__ feat,
                       const float* __restrict__ g_rgb, float* __restrict__ dfeat,
                       const __grid_constant__ DnScratch sv) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int P = P_DN;
  const DnTile s = dn_tile(smem, m);
  float* extra = smem + dn_smem_floats(m);      // [P][HMAX]
  const int F = m.feat_dim;
  float* d_feat = extra + P * HMAX;             // [P][F]
  const long long base = (long long)blockIdx.x * P;
  if (tid < 3 * P) {
    const int p = tid / 3, c = tid - p * 3;
    s.d[p * 4 + c] = base + p < n ? d[(size_t)(base + p) * 3 + c] : 0.f;
  }
  for (int idx = tid; idx < P * F; idx += NT) {
    const int p = idx / F, c = idx - p * F;
    s.h[p * HMAX + c] = base + p < n ? opnd<RB>(feat[(size_t)(base + p) * F + c]) : 0.f;
    d_feat[idx] = 0.f;
  }
  __syncthreads();
  dn_color<RB, true>(wts, m, s, tid, sv, base, n);
  // rgb = sigmoid(z): d z = d rgb * rgb (1 - rgb)
  if (tid < 3 * P) {
    const int p = tid / 3, c = tid - p * 3;
    const float rgb = s.out[p * 4 + 1 + c];
    extra[p * HMAX + c] = base + p < n ? g_rgb[(size_t)(base + p) * 3 + c] * rgb * (1.f - rgb)
                                       : 0.f;
  }
  __syncthreads();
  const Net& N = m.color;
  dn_bwd_walk<RB>(N, wts, N.n_layers - 1, extra, s.h, m.cr, m.cr, false, d_feat, F, sv, base,
                  n, tid);
  for (int idx = tid; idx < P * F; idx += NT) {
    const int p = idx / F, c = idx - p * F;
    if (base + p < n) dfeat[(size_t)(base + p) * F + c] = d_feat[idx];
  }
}

// Lays out the scratch of a segment's backward (seg: 0 deform, 1 density, 2
// colour) and its weight-gradient jobs, dW and db written into grad at the
// packed weights' offsets. With null pointers it only counts:
// *scratch_floats, *partial_floats.
void dn_plan_bwd(const Model& m, int seg, long long n, int rb, float* scratch, float* grad,
                 DnScratch& sv, WgJobs& jobs, long long* scratch_floats,
                 long long* partial_floats) {
  Planner pl{scratch};
  sv = DnScratch{};
  jobs.n_jobs = 0;
  jobs.n_blocks = 0;
  long long part = 0;
  const Net& N = seg == 0 ? m.deform : (seg == 1 ? m.sdf : m.color);
  for (int l = 0; l < N.n_layers; ++l) {
    sv.xin[l] = pl.take(n * N.in_dim[l]);
    sv.dz[l] = pl.take(n * N.out_dim[l]);
  }
  for (int l = 0; l < N.n_layers; ++l) {
    const int in_l = N.in_dim[l], out_l = N.out_dim[l];
    float* dw = grad ? grad + N.w_off[l] : nullptr;
    float* db = grad ? grad + N.b_off[l] : nullptr;
    add_job(jobs, part, sv.xin[l], in_l, sv.dz[l], out_l, n, in_l, out_l, 1.f, rb, dw, out_l, 0);
    add_job(jobs, part, nullptr, 1, sv.dz[l], out_l, n, 1, out_l, 1.f, 0, db, out_l, 0);
  }
  if (scratch_floats) *scratch_floats = pl.used;
  if (partial_floats) *partial_floats = part;
}

// One backward: the tile kernel, then the weight-gradient product.
template <class K, class... Args>
int launch_bwd(K k_rb, K k_f32, bool rb, const Model& m, int seg, long long n, float* scratch,
               float* partial, float* grad, cudaStream_t st, Args... args) {
  if (n <= 0) return 0;
  const long long blocks = (n + P_DN - 1) / P_DN;
  if (blocks > 0x7fffffffLL || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  DnScratch sv;
  WgJobs jobs;
  dn_plan_bwd(m, seg, n, rb, scratch, grad, sv, jobs, nullptr, nullptr);
  K kernel = rb ? k_rb : k_f32;
  const size_t smem = dn_bwd_smem_floats(m, seg) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, NT, smem, st>>>(args..., sv);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return (int)run_wgrad(jobs, partial, st);
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

// The floats of scratch and of partial sums a backward needs for n points
// (seg: 0 deform, 1 density, 2 colour): out[0] scratch, out[1] partial.
void dnerf_bwd_sizes(const long long* meta, int seg, long long n, long long* out) {
  const Model m = decode_model(meta);
  DnScratch sv;
  WgJobs jobs;
  dn_plan_bwd(m, seg, n, 0, nullptr, nullptr, sv, jobs, out, out + 1);
}

// The backwards: scratch / partial of dnerf_bwd_sizes floats; grad of the
// packed weights' size (dW and db land at their weights' offsets).
int dnerf_deform_bwd(const float* w, const long long* meta, int rb, long long n,
                     const float* xt, const float* g_xc, float* scratch, float* partial,
                     float* grad, void* stream) {
  const Model m = decode_model(meta);
  return launch_bwd(dnerf_deform_bwd_kernel<true>, dnerf_deform_bwd_kernel<false>, rb != 0, m,
                    0, n, scratch, partial, grad, (cudaStream_t)stream, w, m, n, xt, g_xc);
}

int dnerf_density_bwd(const float* w, const long long* meta, int rb, long long n,
                      const float* xc, const float* g_raw, const float* g_feat, float* dxc,
                      float* scratch, float* partial, float* grad, void* stream) {
  const Model m = decode_model(meta);
  return launch_bwd(dnerf_density_bwd_kernel<true>, dnerf_density_bwd_kernel<false>, rb != 0,
                    m, 1, n, scratch, partial, grad, (cudaStream_t)stream, w, m, n, xc, g_raw,
                    g_feat, dxc);
}

int dnerf_color_bwd(const float* w, const long long* meta, int rb, long long n, const float* d,
                    const float* feat, const float* g_rgb, float* dfeat, float* scratch,
                    float* partial, float* grad, void* stream) {
  const Model m = decode_model(meta);
  return launch_bwd(dnerf_color_bwd_kernel<true>, dnerf_color_bwd_kernel<false>, rb != 0, m, 2,
                    n, scratch, partial, grad, (cudaStream_t)stream, w, m, n, d, feat, g_rgb,
                    dfeat);
}

}  // extern "C"
