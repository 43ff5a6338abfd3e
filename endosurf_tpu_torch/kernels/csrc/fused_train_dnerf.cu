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
// bf16-rounded operands under rb. The scratch (every layer's operands and
// cotangents: 4,267 floats a point for the deform net, 4,479 for the density
// net) is written once and read once by the product: 4.5-4.7 GB at the train
// step's 262,144 points.
//
// In bf16 all three forwards and all three backwards run on tensor cores,
// each on dnerf_tc.cuh's tile of DT_P points (the forward's hidden layers as
// tile products, the relu' as bits in shared memory).
//
// dnerf_deform_fwd_tc_kernel: dt_deform<true> (the code the deform backward
// recomputes with), x_c = x + the 3-wide output layer in double, rounded
// once. 0.263 TFLOP at the train step's 262,144 points.
//
// dnerf_density_fwd_tc_kernel: dt_density<true> (the same code the density
// backward recomputes with, so both gate every relu alike), the raw column in
// double, the feature columns W[:, 1:] a tile product from op(h_{L-2}) plus
// the bias, written as float32 unrounded (the colour segments round it
// themselves). 0.296 TFLOP at the train step's 262,144 points.
//
// dnerf_color_fwd_tc_kernel: the colour backward's recompute (below), the
// render field stage's colour tail on the feature read from global memory,
// rgb rounded once. What bounds it: reading feat, 1 KB a point at base.yml's
// F = 256 (0.082 ms at 262,144 points); its 0.019 TFLOP take 0.02 ms on
// tensor cores.
//
// dnerf_density_bwd_tc_kernel (field_tc.cuh's deform_bwd_tc_kernel design):
// per tile the forward recomputed (each layer's bf16 operand rows to the
// scratch), the output layer's cotangent [g_raw | g_feat] reaching h as two
// separately rounded dots -- the raw column's rank-1 term in SIMT, the
// feature's a tile product on W_feat^T with the float32 g_feat split in three
// bf16 terms (mma_tile.cuh's split3_bf16) -- then the hidden layers walked
// back through W^T on mma, gated by the bits (the first with its float32
// cotangent, a sum of the two rounded dots, split in three terms, the others
// bf16 values), d x_c through the encoding's derivative in SIMT.
//
// dnerf_deform_bwd_tc_kernel: the recompute likewise; the output layer's
// cotangent g_xc (3 wide, float32) reaches h_{L-2} as one rank-3 dot in
// double, rounded once, so every hidden cotangent of its walk is a bf16
// value (one operand term, a smaller tile: two blocks an SM); the walk forms
// only the h rows (xt gets no cotangent: no encoding rows, nothing below
// layer 0).
//
// dnerf_color_bwd_tc_kernel: the recompute on the render field stage's
// colour operand [enc(d) | op(feat)] (dt_hidden, each layer's operand rows
// saved), the 3-wide output layer and the sigmoid in double (as the render
// field stage computes them), d z = d rgb * rgb (1 - rgb) in double, rounded
// once to float32; its cotangent reaches h_{L-2} as one rank-3 dot in
// double, rounded once, gated (the deform backward's design: every hidden
// cotangent a bf16 value, one term, two blocks an SM); a deeper net's hidden
// layers walked back on mma; d feat the feature columns of layer 0's input
// cotangent d z_0 W_0^T, a tile product on the colour net's W^T fragments,
// each value rounded to bf16 as it leaves the dot and written float32. What
// bounds it: the bytes, feat in and d feat out (2 KB a point, 0.16 ms at
// 262,144 points; its 0.056 TFLOP take 0.06 ms on tensor cores), then its
// bf16 scratch (1,152 bytes a point with base.yml's 2x128 net, written once
// and read once by the product: 0.6 GB).
//
// The three backwards then take the weight gradients by wgrad_tc.cuh's product on
// the bf16 scratch (float32 where a cotangent is not a bf16 value, split in
// three bf16 terms: in two, hi + lo, its remainder of up to 2^-16 put the
// density output layer's bias and feature gradients farther from float64
// than the SIMT product's, PERF.md §6). Scratch a point at base.yml's nets:
// about 2,500 floats' worth for the density (2.6 GB at 262,144 points), 8,640
// bytes for the deform (2.3 GB; the SIMT kernel's 4.5 GB).

#include "dnerf_tc.cuh"
#include "wgrad_tc.cuh"

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

// ---------------------------------------------------------------------------
// the bf16 density forward and density and deform backwards on tensor cores
// ---------------------------------------------------------------------------

// Global scratch of a tensor-core backward, rows indexed by point.
struct DtScratch {
  bf16* xin[NL];   // layer l's operand rows [n][c16(in_l)]
  bf16* dzb[NL];   // cotangent on layer l's pre-activation [n][c16(out_l)] (a bf16 value)
  float* dz[NL];   // the same where it is not: the density's layers L-2 (a sum of two
                   //   rounded dots) and L-1 ([g_raw | g_feat]), the deform's L-1 (g_xc)
};

// The scratch of a tensor-core backward of net N and its weight-gradient
// jobs (dW and db into grad at the packed weights' offsets); the
// cotangents of layers f32_from .. L-1 are float32, those below bf16. With
// null pointers it only counts: *scratch_floats, *partial_floats
// (kernels/fused_train_dnerf.bwd_sizes mirrors it).
void plan_bwd_tc(const Net& N, int f32_from, long long n, void* scratch, float* grad,
                 DtScratch& sv, TcJobs& jobs, long long* scratch_floats,
                 long long* partial_floats) {
  BytePlanner pl{(char*)scratch};
  sv = DtScratch{};
  jobs.w.n_jobs = 0;
  jobs.w.n_blocks = 0;
  jobs.n_blocks = 0;
  long long part = 0;
  const int L = N.n_layers;
  for (int l = 0; l < L; ++l) {
    sv.xin[l] = pl.take<bf16>(n * c16(N.in_dim[l]));
    if (l < f32_from) sv.dzb[l] = pl.take<bf16>(n * c16(N.out_dim[l]));
    else sv.dz[l] = pl.take<float>(n * c16(N.out_dim[l]));
  }
  for (int l = 0; l < L; ++l) {
    const int in_l = N.in_dim[l], out_l = N.out_dim[l];
    const bool f32 = l >= f32_from;
    const void* B = f32 ? (const void*)sv.dz[l] : (const void*)sv.dzb[l];
    const int kb = f32 ? OP_F32X3 : OP_BF16;   // float32 cotangents in three bf16 terms
    float* dw = grad ? grad + N.w_off[l] : nullptr;
    float* db = grad ? grad + N.b_off[l] : nullptr;
    add_tc_job(jobs, part, sv.xin[l], OP_BF16, c16(in_l), B, kb, c16(out_l), n, in_l, out_l, 1.f,
               1, dw, out_l, 0);
    add_tc_job(jobs, part, nullptr, OP_ONES, 1, B, kb, c16(out_l), n, 1, out_l, 1.f, 0, db, out_l,
               0);
  }
  if (scratch_floats) *scratch_floats = (pl.used + 3) / 4;
  if (partial_floats) *partial_floats = part;
}

// The float32 cotangents of the density backward: layers L-2 and L-1; of the
// deform backward: L-1.
inline int density_f32_from(const Model& m) { return m.sdf.n_layers - 2; }
inline int deform_f32_from(const Model& m) { return m.deform.n_layers - 1; }

// x_c [n][3] -> raw sigma [n] and feat [n][F] (dnerf_density_fwd_kernel<true>'s
// maths on tensor cores; the feature float32, unrounded).
__global__ void __launch_bounds__(NT, 2)
dnerf_density_fwd_tc_kernel(const float* __restrict__ wts, const __grid_constant__ Model m,
                            const __grid_constant__ DnFrags fr, long long n,
                            const float* __restrict__ xc, float* __restrict__ sigma,
                            float* __restrict__ feat) {
  constexpr int MT = DT_MT;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ldh = dt_ldh(m);
  uint4* ring = (uint4*)tc_smem + warp * (TC_STAGES * TC_NPW * 32);
  const DtTile s = dt_tile(tc_smem, m, DT_FWD);
  const long long base = (long long)blockIdx.x * DT_P;
  for (int idx = tid; idx < DT_P * ldh; idx += NT) s.H[idx] = bzero();
  for (int idx = tid; idx < DT_P * 4; idx += NT) {
    const int p = idx >> 2, c = idx & 3;
    s.xc[idx] = c < 3 && base + p < n ? xc[(size_t)(base + p) * 3 + c] : 0.f;
  }
  __syncthreads();
  dt_density<true>(wts, m, fr, s, ldh, ring);
  // the feature: columns 1 .. F of the output layer, a tile product from
  // op(h_{L-2}), + the bias
  const Net& S = m.sdf;
  const int lo = S.n_layers - 1, F = m.feat_dim;
  const int np_me = warp * TC_NPW, np_f = c16(F) / 16, npw = clampw(np_f - np_me);
  const bf16* const A1[1] = {s.H};
  float acc[MT][2 * TC_NPW][4];
  zero_acc(acc);
  tile_mma<MT, 1>(acc, A1, ldh, (const uint4*)(wts + fr.density[lo]), np_f, np_me, npw, 0,
                  c16(S.in_dim[lo]) / 16, ring, lane);
  const float* bf = wts + S.b_off[lo] + 1;
  for_pairs(acc, np_me, npw, lane, [&](int row, int c, float a0, float a1) {
    if (base + row >= n) return;
    float* o = feat + (size_t)(base + row) * F + c;
    if (c < F) o[0] = a0 + bf[c];
    if (c + 1 < F) o[1] = a1 + bf[c + 1];
  });
  if (tid < DT_P && base + tid < n) sigma[base + tid] = s.out[tid * 4];
}

cudaError_t launch_density_fwd_tc(const float* w, const long long* meta, const Model& m,
                                  long long n, const float* xc, float* sigma, float* feat,
                                  cudaStream_t st) {
  if (n <= 0) return cudaSuccess;
  const size_t smem = dt_smem(m, DT_FWD);
  cudaError_t e = set_smem(dnerf_density_fwd_tc_kernel, smem);
  if (e != cudaSuccess) return e;
  dnerf_density_fwd_tc_kernel<<<n_tiles(n, DT_P), NT, smem, st>>>(w, m, decode_dn_frags(meta), n,
                                                                  xc, sigma, feat);
  return cudaGetLastError();
}

// xt [n][4] -> x_c [n][3] (dnerf_deform_fwd_kernel<true>'s maths on tensor
// cores): dt_deform<true>, the code the deform backward recomputes with, so
// both gate every relu alike; x_c = x + the 3-wide output layer in double,
// rounded once.
__global__ void __launch_bounds__(NT, 2)
dnerf_deform_fwd_tc_kernel(const float* __restrict__ wts, const __grid_constant__ Model m,
                           const __grid_constant__ DnFrags fr, long long n,
                           const float* __restrict__ xt, float* __restrict__ xc) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int ldh = dt_ldh(m);
  uint4* ring = (uint4*)tc_smem + warp * (TC_STAGES * TC_NPW * 32);
  const DtTile s = dt_tile(tc_smem, m, DT_FWD);
  const long long base = (long long)blockIdx.x * DT_P;
  for (int idx = tid; idx < DT_P * ldh; idx += NT) s.H[idx] = bzero();
  for (int idx = tid; idx < DT_P * 4; idx += NT)
    s.x[idx] = base + (idx >> 2) < n ? xt[(size_t)base * 4 + idx] : 0.f;
  __syncthreads();
  dt_deform<true>(wts, m, fr, s, ldh, ring);
  for (int idx = tid; idx < DT_P * 3; idx += NT) {
    const int p = idx / 3, c = idx - p * 3;
    if (base + p < n) xc[(size_t)(base + p) * 3 + c] = s.xc[p * 4 + c];
  }
}

cudaError_t launch_deform_fwd_tc(const float* w, const long long* meta, const Model& m,
                                 long long n, const float* xt, float* xc, cudaStream_t st) {
  if (n <= 0) return cudaSuccess;
  const size_t smem = dt_smem(m, DT_FWD);
  cudaError_t e = set_smem(dnerf_deform_fwd_tc_kernel, smem);
  if (e != cudaSuccess) return e;
  dnerf_deform_fwd_tc_kernel<<<n_tiles(n, DT_P), NT, smem, st>>>(w, m, decode_dn_frags(meta), n,
                                                                 xt, xc);
  return cudaGetLastError();
}

// (d [n][3], feat [n][F]) -> rgb [n][3] (dnerf_color_fwd_kernel<true>'s
// maths on tensor cores): the colour backward's recompute, which is the
// render field stage's colour tail -- the operand [enc(d) | op(feat) | 0 ..],
// dt_hidden, the 3-wide output layer and the sigmoid in double -- rounded
// once to float32, so the rgb the loss sees is the one the backward
// differentiates. The feature rows arrive by 16-byte loads where the rows
// allow them; the hidden layers split by rows too (HALVES: the 128-wide
// colour layers leave no warp idle).
__global__ void __launch_bounds__(NT, 2)
dnerf_color_fwd_tc_kernel(const float* __restrict__ wts, const __grid_constant__ Model m,
                          const __grid_constant__ DnFrags fr, long long n,
                          const float* __restrict__ d, const float* __restrict__ feat,
                          float* __restrict__ rgb) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int ldh = dt_ldh(m);
  uint4* ring = (uint4*)tc_smem + warp * (TC_STAGES * TC_NPW * 32);
  const DtTile s = dt_tile(tc_smem, m, DT_FWD);
  const Net& C = m.color;
  const int cr = m.cr, F = m.feat_dim;
  const long long base = (long long)blockIdx.x * DT_P;
  const int rows = n - base < DT_P ? (int)(n - base) : DT_P;
  for (int idx = tid; idx < DT_P * ldh; idx += NT) s.H[idx] = bzero();
  for (int idx = tid; idx < DT_P * 4; idx += NT) {
    const int p = idx >> 2, c = idx & 3;
    s.d[idx] = p < rows && c < 3 ? d[(size_t)(base + p) * 3 + c] : 0.f;
  }
  __syncthreads();
  dt_encode<true>(s.d, m.f_cdir, s.E, cr, tid);
  const float* src = feat + (size_t)base * F;
  if ((F & 3) == 0 && ((size_t)feat & 15) == 0) {
    const int q = F / 4;
    for (int idx = tid; idx < rows * q; idx += NT) {
      const int p = idx / q, c = (idx - p * q) * 4;
      const float4 v = __ldg((const float4*)src + idx);
      bf16* h = s.H + p * ldh + cr + c;
      h[0] = __float2bfloat16_rn(v.x);
      h[1] = __float2bfloat16_rn(v.y);
      h[2] = __float2bfloat16_rn(v.z);
      h[3] = __float2bfloat16_rn(v.w);
    }
  } else {
    for (int idx = tid; idx < rows * F; idx += NT) {
      const int p = idx / F, c = idx - p * F;
      s.H[p * ldh + cr + c] = __float2bfloat16_rn(src[idx]);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < DT_P * cr; idx += NT) {
    const int p = idx / cr, c = idx - p * cr;
    s.H[p * ldh + c] = s.E[idx];
  }
  __syncthreads();
  dt_hidden<false, true>(C, wts, fr.color, s.H, ldh, s.E, cr, ring, 0, 0, nullptr, nullptr);
  for (int idx = tid; idx < 3 * DT_P; idx += NT) {
    const int p = idx / 3, col = idx - p * 3;
    if (p < rows)
      rgb[(size_t)(base + p) * 3 + col] =
          (float)(1.0 / (1.0 + exp(-dt_out_col(C, wts, s.H, ldh, p, col))));
  }
}

cudaError_t launch_color_fwd_tc(const float* w, const long long* meta, const Model& m,
                                long long n, const float* d, const float* feat, float* rgb,
                                cudaStream_t st) {
  if (n <= 0) return cudaSuccess;
  const size_t smem = dt_smem(m, DT_FWD);
  cudaError_t e = set_smem(dnerf_color_fwd_tc_kernel, smem);
  if (e != cudaSuccess) return e;
  dnerf_color_fwd_tc_kernel<<<n_tiles(n, DT_P), NT, smem, st>>>(w, m, decode_dn_frags(meta), n, d,
                                                                feat, rgb);
  return cudaGetLastError();
}

// One hidden layer l (> 0, or 0 with den) of a backward's walk through
// W_l^T (frag: its fragments; TERMS bf16 terms of the cotangent in H, Hm,
// Hl): each input column's cotangent op(acc) goes to the h part (gated by
// the relu' of layer l - 1's output, in place in H) or, with den (the
// density's), for the encoding columns of layer 0 and of a skip layer, is
// added to den [DT_P][ew]; without den only the h part is formed (the
// deform's: its encoding gets no cotangent). An input wider than the 256
// columns the warps own takes one pass per group of 256: those past the h
// part first (they touch den only), the group with the h part last, written
// after a barrier.
template <int TERMS>
__device__ __forceinline__ void dt_walk_layer(const Net& N, int l, const float* __restrict__ wts,
                                              long long frag, const DtTile& s, int ldh, int ew,
                                              float* den, uint4* ring) {
  constexpr int MT = DT_MT, WB = HMAX / 32, NPG = HMAX / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bf16* AT[TERMS];
  AT[0] = s.H;
  if constexpr (TERMS == 3) {
    AT[1] = s.Hm;
    AT[2] = s.Hl;
  }
  const int in_l = N.in_dim[l], out_l = N.out_dim[l];
  const bool skip = (N.skip_mask >> l) & 1;
  const int n_h = l == 0 ? 0 : (skip ? in_l - ew : in_l);
  const int np_in = c16(in_l) / 16, kt1 = c16(out_l) / 16, np_me = warp * TC_NPW;
  const int np_do = den ? np_in : c16(n_h) / 16;   // the column pairs formed
  const uint4* B = (const uint4*)(wts + frag);
  auto epi = [&](int row, int c, float a0, float a1) {
    const float a[2] = {a0, a1};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = c + e;
      const float v = bf16r(a[e]);
      if (l > 0 && i < HMAX) {
        const uint32_t word = s.gbit[((l - 1) * DT_P + row) * WB + (i >> 5)];
        const bool on = i < n_h && ((word >> (i & 31)) & 1);
        s.H[row * ldh + i] = on ? __float2bfloat16_rn(v) : bzero();
      }
      if (den && i >= n_h && i < in_l) den[row * ew + i - n_h] += v;
    }
  };
  float acc[MT][2 * TC_NPW][4];
  for (int gr = (np_do - 1) / NPG; gr >= 1; --gr) {
    const int np0 = gr * NPG + np_me, npw = clampw(np_do - np0);
    zero_acc(acc);
    tile_mma<MT, TERMS>(acc, AT, ldh, B, np_in, np0, npw, 0, kt1, ring, lane);
    for_pairs(acc, np0, npw, lane, epi);
  }
  const int npw = clampw(min(np_do, NPG) - np_me);
  zero_acc(acc);
  tile_mma<MT, TERMS>(acc, AT, ldh, B, np_in, np_me, npw, 0, kt1, ring, lane);
  __syncthreads();
  for_pairs(acc, np_me, npw, lane, epi);
  __syncthreads();
}

// Cotangents on raw sigma [n] and feat [n][F] -> d x_c [n][3] and the
// scratch (dnerf_density_bwd_kernel<true>'s maths on tensor cores).
__global__ void __launch_bounds__(NT, 1)
dnerf_density_bwd_tc_kernel(const float* __restrict__ wts, const __grid_constant__ Model m,
                            const __grid_constant__ DnFrags fr, long long n,
                            const float* __restrict__ xc, const float* __restrict__ g_raw,
                            const float* __restrict__ g_feat, float* __restrict__ dxc,
                            const __grid_constant__ DtScratch sv) {
  constexpr int MT = DT_MT, WB = HMAX / 32;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ldh = dt_ldh(m);
  uint4* ring = (uint4*)tc_smem + warp * (TC_STAGES * TC_NPW * 32);
  const DtTile s = dt_tile(tc_smem, m, DT_DENSITY_BWD);
  const Net& S = m.sdf;
  const int L = S.n_layers, es = m.es, F = m.feat_dim, G = 1 + F;
  const long long base = (long long)blockIdx.x * DT_P;
  const int np_me = warp * TC_NPW;

  for (int idx = tid; idx < 3 * DT_P * ldh; idx += NT) s.H[idx] = bzero();   // H, Hm, Hl
  for (int idx = tid; idx < DT_P * 4; idx += NT) {
    const int p = idx >> 2, c = idx & 3;
    s.xc[idx] = c < 3 && base + p < n ? xc[(size_t)(base + p) * 3 + c] : 0.f;
  }
  for (int idx = tid; idx < DT_P; idx += NT) s.gs[idx] = base + idx < n ? g_raw[base + idx] : 0.f;
  for (int idx = tid; idx < DT_P * es; idx += NT) s.den[idx] = 0.f;
  __syncthreads();

  // ---- forward recompute: hidden layers, each layer's operand rows saved
  dt_density<true, true>(wts, m, fr, s, ldh, ring, base, n, sv.xin);
  const int n_in = S.in_dim[L - 1];
  save_rows<1, DT_P>(sv.xin[L - 1], s.H, ldh, c16(n_in), base, n, tid);
  {   // the output layer's cotangent [g_raw | g_feat] (float32, the weight gradient's operand)
    const int w = c16(G);
    for (int idx = tid; idx < DT_P * w; idx += NT) {
      const int p = idx / w, f = idx - p * w;
      if (base + p >= n) continue;
      sv.dz[L - 1][(size_t)(base + p) * w + f] =
          f == 0 ? s.gs[p] : (f < G ? g_feat[(size_t)(base + p) * F + f - 1] : 0.f);
    }
  }
  __syncthreads();
  auto put_split = [&](int row, int c, float v) {
    split3_bf16(v, s.H[row * ldh + c], s.Hm[row * ldh + c], s.Hl[row * ldh + c]);
  };
  for (int idx = tid; idx < DT_P * c16(F); idx += NT) {   // g_feat in three bf16 terms
    const int p = idx / c16(F), f = idx - p * c16(F);
    put_split(p, f, f < F && base + p < n ? g_feat[(size_t)(base + p) * F + f] : 0.f);
  }
  __syncthreads();

  // ---- the output layer: the cotangent on h_{L-2} as two separately rounded
  // dots, op(g_raw W[:, 0]) + op(g_feat W[:, 1:]^T), gated: layer L-2's
  // pre-activation cotangent (float32), then split for its walk
  float acc[MT][2 * TC_NPW][4];
  {
    const int npw = clampw(c16(n_in) / 16 - np_me);
    zero_acc(acc);
    const bf16* const A3[3] = {s.H, s.Hm, s.Hl};
    tile_mma<MT, 3>(acc, A3, ldh, (const uint4*)(wts + fr.density_t[L - 1]), c16(n_in) / 16,
                    np_me, npw, 0, c16(F) / 16, ring, lane);
    __syncthreads();
    const float* head = wts + S.wt_off[L - 1];   // W^T row 0: the raw column
    const int kz = c16(n_in);
    for_pairs(acc, np_me, npw, lane, [&](int row, int c, float a0, float a1) {
      const float af[2] = {a0, a1};
      for (int e = 0; e < 2; ++e) {
        const int i = c + e;
        float o = 0.f;
        if (i < n_in && base + row < n &&
            ((s.gbit[((L - 2) * DT_P + row) * WB + (i >> 5)] >> (i & 31)) & 1))
          o = bf16r(fmaf(s.gs[row], head[i], 0.f)) + bf16r(af[e]);
        if (base + row < n) sv.dz[L - 2][(size_t)(base + row) * kz + i] = o;
        put_split(row, i, o);
      }
    });
    __syncthreads();
  }

  // ---- the hidden layers L-2 .. 0 through W^T
  for (int l = L - 2; l >= 0; --l) {
    if (l == L - 2) {
      dt_walk_layer<3>(S, l, wts, fr.density_t[l], s, ldh, es, s.den, ring);
    } else {
      save_rows<1, DT_P>(sv.dzb[l], s.H, ldh, c16(S.out_dim[l]), base, n, tid);
      dt_walk_layer<1>(S, l, wts, fr.density_t[l], s, ldh, es, s.den, ring);
    }
  }

  // ---- d x_c through the encoding: column c of dim mm is v = op(x_c) 2^f,
  // its value v, sin v or cos v
  for (int idx = tid; idx < DT_P * 3; idx += NT) {
    const int p = idx / 3, mm = idx - p * 3;
    const float x = bf16r(s.xc[p * 4 + mm]);
    float g = 0.f;
    for (int c = 0; c < es; ++c) {
      int dim, kind; float sc;
      enc_col(c, 3, dim, kind, sc);
      if (dim != mm) continue;
      const float v = x * sc;
      g += s.den[p * es + c] * (kind == 0 ? 1.f : (kind == 1 ? cosf(v) : -sinf(v))) * sc;
    }
    if (base + p < n) dxc[(size_t)(base + p) * 3 + mm] = bf16r(g);
  }
}

cudaError_t launch_density_bwd_tc(const float* w, const long long* meta, const Model& m,
                                  long long n, const float* xc, const float* g_raw,
                                  const float* g_feat, float* dxc, float* scratch, float* partial,
                                  float* grad, cudaStream_t st) {
  if (n <= 0) return cudaSuccess;
  DtScratch sv;
  TcJobs jobs;
  plan_bwd_tc(m.sdf, density_f32_from(m), n, scratch, grad, sv, jobs, nullptr, nullptr);
  const size_t smem = dt_smem(m, DT_DENSITY_BWD);
  cudaError_t e = set_smem(dnerf_density_bwd_tc_kernel, smem);
  if (e != cudaSuccess) return e;
  dnerf_density_bwd_tc_kernel<<<n_tiles(n, DT_P), NT, smem, st>>>(
      w, m, decode_dn_frags(meta), n, xc, g_raw, g_feat, dxc, sv);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return run_wgrad_tc(jobs, partial, st);
}

// Cotangent on x_c [n][3] -> the deform net's scratch
// (dnerf_deform_bwd_kernel<true>'s maths on tensor cores; x_c = x + z_last:
// d z_last = g_xc, xt gets none).
__global__ void __launch_bounds__(NT, 2)
dnerf_deform_bwd_tc_kernel(const float* __restrict__ wts, const __grid_constant__ Model m,
                           const __grid_constant__ DnFrags fr, long long n,
                           const float* __restrict__ xt, const float* __restrict__ g_xc,
                           const __grid_constant__ DtScratch sv) {
  constexpr int WB = HMAX / 32;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int ldh = dt_ldh(m);
  uint4* ring = (uint4*)tc_smem + warp * (TC_STAGES * TC_NPW * 32);
  const DtTile s = dt_tile(tc_smem, m, DT_DEFORM_BWD);
  const Net& N = m.deform;
  const int L = N.n_layers, ed = m.ed;
  const long long base = (long long)blockIdx.x * DT_P;
  for (int idx = tid; idx < DT_P * ldh; idx += NT) s.H[idx] = bzero();
  for (int idx = tid; idx < DT_P * 4; idx += NT) {
    const int p = idx >> 2, c = idx & 3;
    const bool in = base + p < n;
    s.x[idx] = in ? xt[(size_t)(base + p) * 4 + c] : 0.f;
    s.out[idx] = in && c < 3 ? g_xc[(size_t)(base + p) * 3 + c] : 0.f;   // g_xc
  }
  __syncthreads();

  // ---- forward recompute: hidden layers, each layer's operand rows saved
  dt_deform<true, true>(wts, m, fr, s, ldh, ring, base, n, sv.xin);
  const int n_in = N.in_dim[L - 1];
  save_rows<1, DT_P>(sv.xin[L - 1], s.H, ldh, c16(n_in), base, n, tid);
  {   // the output layer's cotangent g_xc (float32, the weight gradient's operand)
    const int w = c16(N.out_dim[L - 1]);
    for (int idx = tid; idx < DT_P * w; idx += NT) {
      const int p = idx / w, f = idx - p * w;
      if (base + p < n) sv.dz[L - 1][(size_t)(base + p) * w + f] = f < 3 ? s.out[p * 4 + f] : 0.f;
    }
  }
  __syncthreads();

  // ---- the output layer: the cotangent on h_{L-2}, g_xc W^T (rank 3) in
  // double, rounded once, gated: layer L-2's pre-activation cotangent
  {
    const bool skip = (N.skip_mask >> (L - 1)) & 1;
    const int n_h = skip ? n_in - ed : n_in, w = c16(n_h);
    const float* W = wts + N.w_off[L - 1];      // [n_in][3]
    for (int idx = tid; idx < DT_P * w; idx += NT) {
      const int p = idx / w, i = idx - p * w;
      bf16 v = bzero();
      if (i < n_h && ((s.gbit[((L - 2) * DT_P + p) * WB + (i >> 5)] >> (i & 31)) & 1)) {
        double o = 0.0;
        for (int c = 0; c < 3; ++c)
          o = fma((double)s.out[p * 4 + c], (double)W[(size_t)i * 3 + c], o);
        v = dt_bf16(o);
      }
      s.H[p * ldh + i] = v;
    }
    __syncthreads();
  }

  // ---- the hidden layers L-2 .. 1 through W^T (the h rows only); layer 0's
  // cotangent is saved, its input (the encoding) gets none
  for (int l = L - 2; l >= 0; --l) {
    save_rows<1, DT_P>(sv.dzb[l], s.H, ldh, c16(N.out_dim[l]), base, n, tid);
    if (l > 0) dt_walk_layer<1>(N, l, wts, fr.deform_t[l], s, ldh, ed, nullptr, ring);
  }
}

cudaError_t launch_deform_bwd_tc(const float* w, const long long* meta, const Model& m,
                                 long long n, const float* xt, const float* g_xc, float* scratch,
                                 float* partial, float* grad, cudaStream_t st) {
  if (n <= 0) return cudaSuccess;
  DtScratch sv;
  TcJobs jobs;
  plan_bwd_tc(m.deform, deform_f32_from(m), n, scratch, grad, sv, jobs, nullptr, nullptr);
  const size_t smem = dt_smem(m, DT_DEFORM_BWD);
  cudaError_t e = set_smem(dnerf_deform_bwd_tc_kernel, smem);
  if (e != cudaSuccess) return e;
  dnerf_deform_bwd_tc_kernel<<<n_tiles(n, DT_P), NT, smem, st>>>(w, m, decode_dn_frags(meta), n,
                                                                 xt, g_xc, sv);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return run_wgrad_tc(jobs, partial, st);
}

// The float32 cotangent of the colour backward: its output layer's (d z =
// d rgb * rgb (1 - rgb)).
inline int color_f32_from(const Model& m) { return m.color.n_layers - 1; }

// Cotangent on rgb [n][3] -> d feat [n][F] and the colour net's scratch
// (dnerf_color_bwd_kernel<true>'s maths on tensor cores; d gets none).
__global__ void __launch_bounds__(NT, 2)
dnerf_color_bwd_tc_kernel(const float* __restrict__ wts, const __grid_constant__ Model m,
                          const __grid_constant__ DnFrags fr, long long n,
                          const float* __restrict__ d, const float* __restrict__ feat,
                          const float* __restrict__ g_rgb, float* __restrict__ dfeat,
                          const __grid_constant__ DtScratch sv) {
  constexpr int MT = DT_MT, WB = HMAX / 32, NPG = HMAX / 16;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ldh = dt_ldh(m);
  uint4* ring = (uint4*)tc_smem + warp * (TC_STAGES * TC_NPW * 32);
  const DtTile s = dt_tile(tc_smem, m, DT_COLOR_BWD);
  const Net& C = m.color;
  const int L = C.n_layers, cr = m.cr, F = m.feat_dim;
  const long long base = (long long)blockIdx.x * DT_P;
  for (int idx = tid; idx < DT_P * ldh; idx += NT) s.H[idx] = bzero();
  for (int idx = tid; idx < DT_P * 4; idx += NT) {
    const int p = idx >> 2, c = idx & 3;
    const bool in = base + p < n && c < 3;
    s.d[idx] = in ? d[(size_t)(base + p) * 3 + c] : 0.f;
    s.x[idx] = in ? g_rgb[(size_t)(base + p) * 3 + c] : 0.f;   // g_rgb
  }
  __syncthreads();

  // ---- forward recompute: the operand [enc(d) | op(feat) | 0 ..] (the render
  // field stage's), the hidden layers, each layer's operand rows saved
  dt_encode<true>(s.d, m.f_cdir, s.E, cr, tid);
  for (int idx = tid; idx < DT_P * F; idx += NT) {
    const int p = idx / F, c = idx - p * F;
    if (base + p < n) s.H[p * ldh + cr + c] = __float2bfloat16_rn(feat[(size_t)(base + p) * F + c]);
  }
  __syncthreads();
  for (int idx = tid; idx < DT_P * cr; idx += NT) {
    const int p = idx / cr, c = idx - p * cr;
    s.H[p * ldh + c] = s.E[idx];
  }
  __syncthreads();
  dt_hidden<true>(C, wts, fr.color, s.H, ldh, s.E, cr, ring, base, n, sv.xin, s.gbit);
  const int n_in = C.in_dim[L - 1];
  save_rows<1, DT_P>(sv.xin[L - 1], s.H, ldh, c16(n_in), base, n, tid);

  // ---- the output layer and the sigmoid in double (the render field
  // stage's): d z = d rgb * rgb (1 - rgb), rounded once to float32 (the
  // weight gradient's operand)
  for (int idx = tid; idx < 3 * DT_P; idx += NT) {
    const int p = idx / 3, col = idx - p * 3;
    const double rgb = 1.0 / (1.0 + exp(-dt_out_col(C, wts, s.H, ldh, p, col)));
    s.out[p * 4 + col] = (float)((double)s.x[p * 4 + col] * rgb * (1.0 - rgb));
  }
  __syncthreads();
  {
    const int w = c16(C.out_dim[L - 1]);
    for (int idx = tid; idx < DT_P * w; idx += NT) {
      const int p = idx / w, f = idx - p * w;
      if (base + p < n) sv.dz[L - 1][(size_t)(base + p) * w + f] = f < 3 ? s.out[p * 4 + f] : 0.f;
    }
  }

  // ---- the cotangent on h_{L-2}: d z W^T (rank 3) in double, rounded once,
  // gated: layer L-2's pre-activation cotangent
  {
    const int w = c16(n_in);
    const float* W = wts + C.w_off[L - 1];      // [n_in][3]
    for (int idx = tid; idx < DT_P * w; idx += NT) {
      const int p = idx / w, i = idx - p * w;
      bf16 v = bzero();
      if (i < n_in && ((s.gbit[((L - 2) * DT_P + p) * WB + (i >> 5)] >> (i & 31)) & 1)) {
        double o = 0.0;
        for (int c = 0; c < 3; ++c)
          o = fma((double)s.out[p * 4 + c], (double)W[(size_t)i * 3 + c], o);
        v = dt_bf16(o);
      }
      s.H[p * ldh + i] = v;
    }
    __syncthreads();
  }

  // ---- the hidden layers L-2 .. 1 through W^T (the h rows); each layer's
  // cotangent saved
  for (int l = L - 2; l >= 0; --l) {
    save_rows<1, DT_P>(sv.dzb[l], s.H, ldh, c16(C.out_dim[l]), base, n, tid);
    if (l > 0) dt_walk_layer<1>(C, l, wts, fr.color_t[l], s, ldh, cr, nullptr, ring);
  }

  // ---- d feat: the feature columns cr .. cr + F of layer 0's input
  // cotangent d z_0 W_0^T, a tile product rounded to bf16 as it leaves the
  // dot, one pass per 256 columns
  const int np_in = c16(C.in_dim[0]) / 16, kt1 = c16(C.out_dim[0]) / 16;
  const bf16* const A1[1] = {s.H};
  float acc[MT][2 * TC_NPW][4];
  for (int gr = (np_in - 1) / NPG; gr >= 0; --gr) {
    const int np0 = gr * NPG + warp * TC_NPW, npw = clampw(np_in - np0);
    zero_acc(acc);
    tile_mma<MT, 1>(acc, A1, ldh, (const uint4*)(wts + fr.color_t[0]), np_in, np0, npw, 0, kt1,
                    ring, lane);
    for_pairs(acc, np0, npw, lane, [&](int row, int c, float a0, float a1) {
      if (base + row >= n) return;
      float* o = dfeat + (size_t)(base + row) * F;
      if (c >= cr && c < cr + F) o[c - cr] = bf16r(a0);
      if (c + 1 >= cr && c + 1 < cr + F) o[c + 1 - cr] = bf16r(a1);
    });
  }
}

cudaError_t launch_color_bwd_tc(const float* w, const long long* meta, const Model& m,
                                long long n, const float* d, const float* feat,
                                const float* g_rgb, float* dfeat, float* scratch, float* partial,
                                float* grad, cudaStream_t st) {
  if (n <= 0) return cudaSuccess;
  DtScratch sv;
  TcJobs jobs;
  plan_bwd_tc(m.color, color_f32_from(m), n, scratch, grad, sv, jobs, nullptr, nullptr);
  const size_t smem = dt_smem(m, DT_COLOR_BWD);
  cudaError_t e = set_smem(dnerf_color_bwd_tc_kernel, smem);
  if (e != cudaSuccess) return e;
  dnerf_color_bwd_tc_kernel<<<n_tiles(n, DT_P), NT, smem, st>>>(w, m, decode_dn_frags(meta), n, d,
                                                                feat, g_rgb, dfeat, sv);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return run_wgrad_tc(jobs, partial, st);
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

// The forwards: with rb and tc the tensor-core kernel (meta then carries the
// bf16 pack's fragment extension); rb without tc runs the SIMT one (a
// comparison only).
int dnerf_deform_fwd(const float* w, const long long* meta, int rb, int tc, long long n,
                     const float* xt, float* xc, void* stream) {
  const Model m = decode_model(meta);
  if (rb && tc) return (int)launch_deform_fwd_tc(w, meta, m, n, xt, xc, (cudaStream_t)stream);
  return launch_seg(dnerf_deform_fwd_kernel<true>, dnerf_deform_fwd_kernel<false>, rb != 0, m,
                    n, (cudaStream_t)stream, w, m, n, xt, xc);
}

int dnerf_density_fwd(const float* w, const long long* meta, int rb, int tc, long long n,
                      const float* xc, float* sigma, float* feat, void* stream) {
  const Model m = decode_model(meta);
  if (rb && tc)
    return (int)launch_density_fwd_tc(w, meta, m, n, xc, sigma, feat, (cudaStream_t)stream);
  return launch_seg(dnerf_density_fwd_kernel<true>, dnerf_density_fwd_kernel<false>, rb != 0,
                    m, n, (cudaStream_t)stream, w, m, n, xc, sigma, feat);
}

int dnerf_color_fwd(const float* w, const long long* meta, int rb, int tc, long long n,
                    const float* d, const float* feat, float* rgb, void* stream) {
  const Model m = decode_model(meta);
  if (rb && tc)
    return (int)launch_color_fwd_tc(w, meta, m, n, d, feat, rgb, (cudaStream_t)stream);
  return launch_seg(dnerf_color_fwd_kernel<true>, dnerf_color_fwd_kernel<false>, rb != 0, m,
                    n, (cudaStream_t)stream, w, m, n, d, feat, rgb);
}

// The floats of scratch and of partial sums a backward needs for n points
// (seg: 0 deform, 1 density, 2 colour; tc: the bf16 backward on tensor
// cores): out[0] scratch, out[1] partial.
void dnerf_bwd_sizes(const long long* meta, int seg, int tc, long long n, long long* out) {
  const Model m = decode_model(meta);
  if (tc) {
    DtScratch sv;
    TcJobs jobs;
    const Net& N = seg == 0 ? m.deform : (seg == 1 ? m.sdf : m.color);
    const int f32_from = seg == 0 ? deform_f32_from(m)
                                  : (seg == 1 ? density_f32_from(m) : color_f32_from(m));
    plan_bwd_tc(N, f32_from, n, nullptr, nullptr, sv, jobs, out, out + 1);
    return;
  }
  DnScratch sv;
  WgJobs jobs;
  dn_plan_bwd(m, seg, n, 0, nullptr, nullptr, sv, jobs, out, out + 1);
}

// The backwards: scratch / partial of dnerf_bwd_sizes floats; grad of the
// packed weights' size (dW and db land at their weights' offsets). With rb
// and tc they run their tensor-core kernels (meta then carries the bf16
// pack's fragment extension); rb without tc the SIMT ones (a comparison
// only).
int dnerf_deform_bwd(const float* w, const long long* meta, int rb, int tc, long long n,
                     const float* xt, const float* g_xc, float* scratch, float* partial,
                     float* grad, void* stream) {
  const Model m = decode_model(meta);
  if (rb && tc)
    return (int)launch_deform_bwd_tc(w, meta, m, n, xt, g_xc, scratch, partial, grad,
                                     (cudaStream_t)stream);
  return launch_bwd(dnerf_deform_bwd_kernel<true>, dnerf_deform_bwd_kernel<false>, rb != 0, m,
                    0, n, scratch, partial, grad, (cudaStream_t)stream, w, m, n, xt, g_xc);
}

int dnerf_density_bwd(const float* w, const long long* meta, int rb, int tc, long long n,
                      const float* xc, const float* g_raw, const float* g_feat, float* dxc,
                      float* scratch, float* partial, float* grad, void* stream) {
  const Model m = decode_model(meta);
  if (rb && tc)
    return (int)launch_density_bwd_tc(w, meta, m, n, xc, g_raw, g_feat, dxc, scratch, partial,
                                      grad, (cudaStream_t)stream);
  return launch_bwd(dnerf_density_bwd_kernel<true>, dnerf_density_bwd_kernel<false>, rb != 0,
                    m, 1, n, scratch, partial, grad, (cudaStream_t)stream, w, m, n, xc, g_raw,
                    g_feat, dxc);
}

int dnerf_color_bwd(const float* w, const long long* meta, int rb, int tc, long long n,
                    const float* d, const float* feat, const float* g_rgb, float* dfeat,
                    float* scratch, float* partial, float* grad, void* stream) {
  const Model m = decode_model(meta);
  if (rb && tc)
    return (int)launch_color_bwd_tc(w, meta, m, n, d, feat, g_rgb, dfeat, scratch, partial, grad,
                                    (cudaStream_t)stream);
  return launch_bwd(dnerf_color_bwd_kernel<true>, dnerf_color_bwd_kernel<false>, rb != 0, m, 2,
                    n, scratch, partial, grad, (cudaStream_t)stream, w, m, n, d, feat, g_rgb,
                    dfeat);
}

}  // extern "C"
