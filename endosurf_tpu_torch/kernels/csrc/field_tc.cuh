// The bf16 ("default" dot mode, rb) train segments on Hopper's tensor cores:
// the three forward kernels (deform_fwd_tc_kernel, sdf_fwd_tc_kernel,
// color_fwd_tc_kernel) and the three backward kernels (deform_bwd_tc_kernel,
// sdf_bwd_tc_kernel, color_bwd_tc_kernel), launched by fused_train.cu's
// train_*_fwd / train_*_bwd for rb = 1 in place of the SIMT kernels (which
// the float32 mode keeps), and the weight-gradient product of wgrad_tc.cuh.
// The bf16 render's field stage (fused_render.cu) runs the three forward
// kernels too, on the render's pack.
//
// Replaces, with fused_train.cu, the Pallas kernels deform_fwd, deform_bwd,
// sdf_fwd, sdf_bwd, color_fwd and color_bwd of
// endosurf_tpu/kernels/fused_train_pallas.py (_seg_pallas): there the
// weights stay in VMEM and blocks of >= 128 points stream through the MXU.
// Here a block of NT threads owns a tile of rows (deform: 16 points x the
// primal and three tangent streams, row 16 s + p; SDF and colour: 64
// points), runs the forward and walks the layers back as tile products on mma.sync
// (mma_tile.cuh): the rows' operand in shared memory as bf16, the weights
// streaming from L2 in fragment order through a per-warp cp.async ring, each
// warp owning 32 output columns for all the rows; a product wider than the
// 256 columns the warps own (the colour's 352-wide input layer and 608-wide
// skip layer, the SDF's 295-wide skip layer) takes one pass per group of 256
// columns. What is not a 256-wide product stays SIMT in the same kernel: the
// encodings, the 3-wide output layers of the deform and colour nets and their
// cotangents, the head column, the gates, the softplus' second-order term and the
// input-cotangent tails. A forward kernel and its backward's recompute run
// one tile function (deform_tc_forward, sdf_tc_forward, color_tc_forward).
// Each layer's (operand, cotangent) pairs go to a global scratch and
// wgrad_tc.cuh's product sums them over the points.
//
// The same maths as the SIMT kernels, operation for operation, except that
// the float32 sums of the products run in the mma's order. bf16-exactness of
// each product's operands (every weight is a bf16 value, packed by
// pack_segment):
//   deform and colour: every operand (layer inputs op(h), op(encoding), the
//     tangent seeds, the colour input; the cotangents op(acc * sc) leaving
//     each dot) is a bf16 value. The cotangents on the 3-wide output (x_c
//     and the rows; g_color rgb (1 - rgb)) are float32, but they only meet
//     the output layer, which stays SIMT; its weight gradient takes them as
//     float32 (split) operands.
//   SDF: the forward's operands (op(softplus), op(encoding)) and the adjoint's
//     op(a sigma) are bf16 values. Float32 and not bf16 values, so split
//     (mma_tile.cuh): the adjoint walk's cotangent dag * sigma (a sum of two
//     rounded dots times a float32 gate) and d aE = op(g_c sc) g'; the primal
//     walk's dz = v sigma + dz_2nd and the top layer's incoming cotangents
//     (g_sdf, g_feat), as hi + mid + lo (<= 2^-24 left); in the
//     weight-gradient product the pre-activation cotangents dz and the
//     adjoint-dot cotangents da, as hi + lo (<= 2^-16), against the bf16
//     xin / ag.
//
// What bounds it: the products, 0.241 (deform forward), 0.709 (deform
// backward), 0.134 (SDF forward), 0.403 (SDF backward), 0.084 (colour
// forward) and 0.251 (colour backward) TFLOP at 65,536 points with the weight
// gradients (chip_smoke.py counts them), 0.24, 0.72, 0.14, 0.41, 0.085 and
// 0.25 ms at the bf16 tensor-core rate; the SDF's split operands take three
// mma for each of its walks' products and two for its weight gradients.
// Bytes: the backward scratch, bf16 where exact (2.0 GiB for the deform
// and 0.6 GiB for the colour at 65,536 points, half their float32 size), written once and read about once
// by the weight-gradient product; the deform forward stores none, the SDF
// forward only its pre-activations (0.5 GiB), read back by its own adjoint.
// mma.sync, one block per SM where the shared memory is large (SDF and
// colour ~200 KB) and the L2-fed weight fragments leave the kernels far from
// the bound (PERF.md has the times on an H100).
//
// Anonymous namespace: one copy per .cu, as sdf_chain.cuh.

#pragma once

#include "field_chain.cuh"
#include "wgrad_tc.cuh"

#define TC_P_DEFORM 16   // points per deform tile (x 4 streams = 64 rows)
#define TC_P_SDF 64      // points per SDF tile
#define TC_P_COLOR 64    // points per colour tile

static_assert(TC_WARPS * 32 == NT, "a warp owns 32 of the tile's 256 output columns");

namespace {

// Global scratch of a tensor-core backward (rows indexed by point; the deform
// net's arrays hold S = 4 streams, stream-major: [S][n][width], the others
// S = 1); widths padded to c16 where the row is a product operand.
struct TcScratch {
  bf16* xin[NL];    // layer l's dot operands [h_{l-1} | encoding] [S][n][c16(in_l)]
  bf16* dzb[NL];    // deform, colour: cotangent on layer l's pre-activation
                    //   [S][n][c16(out_l)], l < NL-1
  bf16* ag[NL];     // sdf: adjoint dot operand op(a_l sigma_l) [n][c16(out_l)], l < NL-1
  float* dz[NL];    // deform, colour: layer NL-1's [S][n][4]; sdf: every layer's [n][c16(out_l)]
  float* z[NL];     // sdf: pre-activations [n][out_l], l < NL-1
  float* a[NL];     // sdf: ungated adjoint reaching layer l's output [n][out_l], l < NL-2
                    //   (layer NL-2's is the head column)
  float* da[NL];    // sdf: cotangent on the adjoint dot's output [n][c16(in_l)], l < NL-1
  float* dhead;     // sdf: cotangent on the adjoint seed [n][in_{NL-1}]
};

// Float offsets (in the packed weights) of each layer's W [in][out] and W^T
// [out][in] as bf16 mma B operands in fragment order: the meta's extension
// that pack_segment writes in the bf16 mode.
struct TcFrags {
  long long w[NL], wt[NL];
};

TcFrags decode_frags(const long long* meta) {
  TcFrags f;
  for (int l = 0; l < NL; ++l) {
    f.w[l] = meta[META_LEN + l];
    f.wt[l] = meta[META_LEN + NL + l];
  }
  return f;
}

// Row pitch (bf16) of the tile's operand buffer: the widest padded layer
// input or output + 8 (16 bytes x odd).
__host__ __device__ inline int tc_ldh(const Net& N) {
  int k = 16;
  for (int l = 0; l < NL; ++l) {
    const int w = c16(N.in_dim[l]) > c16(N.out_dim[l]) ? c16(N.in_dim[l]) : c16(N.out_dim[l]);
    k = w > k ? w : k;
  }
  return k + 8;
}

// Whether row p of the tile at base is a point (the last tile is partial):
// input rows that are not load zeros.
__device__ __forceinline__ bool in_tile(long long base, int p, long long n) {
  return base + p < n;
}


// ---------------------------------------------------------------------------
// deform: the tile's forward (shared by the forward kernel and the backward's
// recompute), the forward kernel (x_c and the rows), the backward
// ---------------------------------------------------------------------------

// Shared memory of a deform tile of P points x 4 streams (row s P + p), after
// the weight ring: the layer's operand H [4P][ldh] and the encoding and
// tangent seeds E [4P][ed] (bf16), x [P][4]; the backward adds the relu' of
// each hidden output as bits [NL-1][P][HMAX / 32] and the output layer's
// cotangent [4P][3] (float32).
struct DeformTile {
  bf16* H;
  bf16* E;
  float* xs;
  uint32_t* gbit;
  float* dz8;
};

inline size_t deform_tc_smem(const Model& m, bool bwd) {
  constexpr int P = TC_P_DEFORM, R = 4 * P;
  size_t b = TC_RING_BYTES + (size_t)R * tc_ldh(m.deform) * 2 + (size_t)R * m.ed * 2
             + (size_t)P * 4 * 4;
  if (bwd) b += (size_t)(NL - 1) * P * (HMAX / 32) * 4 + (size_t)R * 3 * 4;
  return b;
}

__device__ __forceinline__ DeformTile deform_tile(unsigned char* smem, const Model& m) {
  constexpr int P = TC_P_DEFORM;
  DeformTile s;
  s.H = (bf16*)(smem + TC_RING_BYTES);
  s.E = s.H + 4 * P * tc_ldh(m.deform);
  s.xs = (float*)(s.E + 4 * P * m.ed);
  s.gbit = (uint32_t*)(s.xs + P * 4);
  s.dz8 = (float*)(s.gbit + (NL - 1) * P * (HMAX / 32));
  return s;
}

// The deform net's forward on the tile of P points at base, primal and three
// tangent streams (field_deform's arithmetic, the products on tensor cores):
// the encoding and tangent seeds, layers 0 .. NL-2 as tile products, the bf16
// primal and the tangents gated by its relu'. Leaves in s.H the output
// layer's operand rows (h_{NL-2} of each stream). With SAVE each layer's
// operand rows go to sv.xin and the relu' of each hidden output to s.gbit.
// The forward kernel and the backward's recompute both run it, so the forward
// the loss sees is the one the backward differentiates, bit for bit.
template <bool SAVE>
__device__ __forceinline__ void deform_tc_forward(const float* __restrict__ wts, const Model& m,
                                                  const TcFrags& fr, long long n, long long base,
                                                  const float* __restrict__ xt,
                                                  const DeformTile& s, uint4* ring,
                                                  const TcScratch& sv) {
  constexpr int P = TC_P_DEFORM, R = 4 * P, MT = R / 16, WB = HMAX / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Net& N = m.deform;
  const int ed = m.ed, ldh = tc_ldh(N);
  bf16* H = s.H;
  bf16* E = s.E;
  const bf16* const A1[1] = {H};
  const int np_me = warp * TC_NPW;               // the warp's columns: 32 warp ..

  for (int idx = tid; idx < R * ldh; idx += NT) H[idx] = bzero();
  for (int idx = tid; idx < P * 4; idx += NT)
    s.xs[idx] = in_tile(base, idx >> 2, n) ? xt[(size_t)base * 4 + idx] : 0.f;
  __syncthreads();
  const int ex = enc_width(3, m.f_dpos);
  for (int idx = tid; idx < P * ed; idx += NT) {   // field_deform's encoding
    const int p = idx / ed, c = idx - p * ed;
    int dim, kind; float sc;
    if (c < ex) enc_col(c, 3, dim, kind, sc);
    else { enc_col(c - ex, 1, dim, kind, sc); dim = 3; }
    const float v = bf16r(s.xs[p * 4 + dim]) * sc;
    const float sv_ = sinf(v), cv = cosf(v);
    const float e = kind == 0 ? v : (kind == 1 ? sv_ : cv);
    const float g1 = kind == 0 ? 1.f : (kind == 1 ? cv : -sv_);
    E[p * ed + c] = __float2bfloat16_rn(e);
    for (int k = 0; k < 3; ++k)
      E[((k + 1) * P + p) * ed + c] = __float2bfloat16_rn(dim == k ? sc * g1 : 0.f);
  }
  __syncthreads();
  put_enc(H, ldh, 0, E, ed, R, tid);
  __syncthreads();

  float acc[MT][2 * TC_NPW][4];
  for (int l = 0; l < NL - 1; ++l) {
    const int in_l = N.in_dim[l], out_l = N.out_dim[l];
    const bool skip = (N.skip_mask >> l) & 1;
    if (l > 0 && skip) {
      put_enc(H, ldh, in_l - ed, E, ed, R, tid);
      __syncthreads();
    }
    if (SAVE) save_rows<4, P>(sv.xin[l], H, ldh, c16(in_l), base, n, tid);
    const int np_out = c16(out_l) / 16, npw = clampw(np_out - np_me);
    zero_acc(acc);
    tile_mma<MT, 1>(acc, A1, ldh, (const uint4*)(wts + fr.w[l]), np_out, np_me, npw, 0,
                    c16(in_l) / 16, ring, lane);
    __syncthreads();
    // m-tile s holds stream s, so a thread holds the primal and the three
    // tangents of the same (point, neuron)
    const float sc = skip ? kInvSqrt2 : 1.f;
    uint32_t bits[2] = {0u, 0u};                 // points g, g + 8
#pragma unroll
    for (int nt = 0; nt < 2 * TC_NPW; ++nt) {
      if (nt >= 2 * npw) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = g + (e >> 1) * 8, cl = nt * 8 + 2 * t + (e & 1);
        const int c = np_me * 16 + cl;
        if (c >= out_l) {
          for (int st = 0; st < 4; ++st) H[(st * P + p) * ldh + c] = bzero();
          continue;
        }
        const float z = acc[0][nt][e] * sc + wts[N.b_off[l] + c];
        const float gate = z > 0.f ? 1.f : 0.f;
        const bf16 hv = __float2bfloat16_rn(fmaxf(z, 0.f));
        H[p * ldh + c] = hv;
#pragma unroll
        for (int k = 1; k < 4; ++k)
          H[(k * P + p) * ldh + c] = __float2bfloat16_rn(acc[k][nt][e] * sc * gate);
        if (SAVE && __bfloat162float(hv) > 0.f) bits[e >> 1] |= 1u << cl;
      }
    }
    if (SAVE) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        bits[0] |= __shfl_xor_sync(0xffffffffu, bits[0], o);
        bits[1] |= __shfl_xor_sync(0xffffffffu, bits[1], o);
      }
      if (t == 0 && warp < WB) {
        s.gbit[(l * P + g) * WB + warp] = bits[0];
        s.gbit[(l * P + g + 8) * WB + warp] = bits[1];
      }
    }
    __syncthreads();
  }
  if (SAVE) save_rows<4, P>(sv.xin[NL - 1], H, ldh, c16(N.in_dim[NL - 1]), base, n, tid);
}

// xt [n][4] -> x_c [n][3], jrows [n][3][3]: the tile's forward, then the
// 3-wide output layer in SIMT from the bf16 last hidden rows, each output an
// FMA chain in k order as field_deform's (x_c = x + z, row k = e_k + the
// tangent's output).
__global__ void __launch_bounds__(NT, 2)
deform_fwd_tc_kernel(const float* __restrict__ wts, Model m, TcFrags fr, long long n,
                     const float* __restrict__ xt, float* __restrict__ xc,
                     float* __restrict__ jrows) {
  constexpr int P = TC_P_DEFORM;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const Net& N = m.deform;
  const int ldh = tc_ldh(N);
  uint4* ring = (uint4*)tc_smem + warp * (TC_STAGES * TC_NPW * 32);
  const DeformTile s = deform_tile(tc_smem, m);
  const long long base = (long long)blockIdx.x * P;
  deform_tc_forward<false>(wts, m, fr, n, base, xt, s, ring, TcScratch{});

  const int l = NL - 1, in_l = N.in_dim[l], out_l = N.out_dim[l];   // out_l == 3
  const float sc = ((N.skip_mask >> l) & 1) ? kInvSqrt2 : 1.f;
  const float* W = wts + N.w_off[l];             // [in][out]
  for (int idx = tid; idx < 4 * P * 3; idx += NT) {
    const int r = idx / 3, c = idx - r * 3, st = r / P, p = r - st * P;
    if (base + p >= n) continue;
    float a = 0.f;
    for (int k = 0; k < in_l; ++k)
      a = fmaf(__bfloat162float(s.H[r * ldh + k]), __ldg(W + (size_t)k * out_l + c), a);
    if (st == 0)
      xc[(size_t)(base + p) * 3 + c] = s.xs[p * 4 + c] + (a * sc + wts[N.b_off[l] + c]);
    else
      jrows[(size_t)(base + p) * 9 + (st - 1) * 3 + c] = (st - 1 == c ? 1.f : 0.f) + a * sc;
  }
}

// Cotangents on x_c [n][3] and the rows [n][3][3] -> the scratch.
__global__ void __launch_bounds__(NT, 2)
deform_bwd_tc_kernel(const float* __restrict__ wts, Model m, TcFrags fr, long long n,
                     const float* __restrict__ xt, const float* __restrict__ g_xc,
                     const float* __restrict__ g_j, const __grid_constant__ TcScratch sv) {
  constexpr int P = TC_P_DEFORM, R = 4 * P, MT = R / 16, WB = HMAX / 32;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Net& N = m.deform;
  const int ed = m.ed, ldh = tc_ldh(N);
  uint4* ring = (uint4*)tc_smem + warp * (TC_STAGES * TC_NPW * 32);
  const DeformTile tile = deform_tile(tc_smem, m);
  bf16* H = tile.H;                              // [R][ldh] the layer's operand
  const bf16* const A1[1] = {H};
  uint32_t* gbit = tile.gbit;                    // [NL-1][P][WB] relu' of each hidden output
  float* dz8 = tile.dz8;                         // [R][3] the output layer's cotangent
  const long long base = (long long)blockIdx.x * P;
  const int np_me = warp * TC_NPW;

  // ---- forward recompute, layers 0 .. NL-2 (the output layer needs only its input)
  deform_tc_forward<true>(wts, m, fr, n, base, xt, tile, ring, sv);
  float acc[MT][2 * TC_NPW][4];

  // ---- backward: the output layer (3 wide, SIMT), float32 cotangents
  for (int idx = tid; idx < R * 4; idx += NT) {
    const int r = idx >> 2, c = idx & 3, s = r / P, p = r - s * P;
    float v = 0.f;
    if (c < 3 && in_tile(base, p, n))
      v = s == 0 ? g_xc[(size_t)(base + p) * 3 + c]
                 : g_j[(size_t)(base + p) * 9 + (s - 1) * 3 + c];
    if (c < 3) dz8[r * 3 + c] = v;
    if (base + p < n) sv.dz[NL - 1][((size_t)s * n + base + p) * 4 + c] = v;
  }
  __syncthreads();
  {
    const int l = NL - 1, in_l = N.in_dim[l], out_l = N.out_dim[l];
    const bool skip = (N.skip_mask >> l) & 1;
    const int n_h = skip ? in_l - ed : in_l, w = c16(n_h);
    const float sc = skip ? kInvSqrt2 : 1.f;
    const float* W = wts + N.w_off[l];           // [in][out]
    for (int idx = tid; idx < R * w; idx += NT) {
      const int r = idx / w, i = idx - r * w, p = r % P;
      bf16 v = bzero();
      if (i < n_h && ((gbit[((l - 1) * P + p) * WB + (i >> 5)] >> (i & 31)) & 1)) {
        float a = 0.f;
        for (int j = 0; j < out_l; ++j) a = fmaf(dz8[r * 3 + j], W[(size_t)i * out_l + j], a);
        v = __float2bfloat16_rn(a * sc);
      }
      H[r * ldh + i] = v;
    }
  }
  __syncthreads();

  // ---- hidden layers NL-2 .. 1 through W^T, gated by the primal's relu'
  for (int l = NL - 2; l >= 1; --l) {
    const int in_l = N.in_dim[l], out_l = N.out_dim[l];
    const bool skip = (N.skip_mask >> l) & 1;
    const int n_h = skip ? in_l - ed : in_l;
    save_rows<4, P>(sv.dzb[l], H, ldh, c16(out_l), base, n, tid);
    const int npw = clampw(c16(n_h) / 16 - np_me);
    zero_acc(acc);
    tile_mma<MT, 1>(acc, A1, ldh, (const uint4*)(wts + fr.wt[l]), c16(in_l) / 16, np_me, npw,
                    0, c16(out_l) / 16, ring, lane);
    __syncthreads();
    const float sc = skip ? kInvSqrt2 : 1.f;
#pragma unroll
    for (int nt = 0; nt < 2 * TC_NPW; ++nt) {
      if (nt >= 2 * npw) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = g + (e >> 1) * 8, c = np_me * 16 + nt * 8 + 2 * t + (e & 1);
        const bool on = c < n_h && ((gbit[((l - 1) * P + p) * WB + (c >> 5)] >> (c & 31)) & 1);
#pragma unroll
        for (int s = 0; s < 4; ++s)
          H[(s * P + p) * ldh + c] = on ? __float2bfloat16_rn(acc[s][nt][e] * sc) : bzero();
      }
    }
    __syncthreads();
  }
  save_rows<4, P>(sv.dzb[0], H, ldh, c16(N.out_dim[0]), base, n, tid);
}

// ---------------------------------------------------------------------------
// SDF: the tile's forward (shared by the forward kernel and the backward's
// recompute), the forward kernel (sdf, feat, grad_c), the backward
// (cotangents on sdf [n], feat [n][F], grad_c [n][3] -> d x_c [n][3] and the
// scratch)
// ---------------------------------------------------------------------------

// The shared arrays the SDF tile's forward uses (after the weight ring): the
// layer's operand Hh [P][ldh] and the encoding E [P][es] (bf16), the
// encoding derivative g1 and the adjoint on the encoding aE [P][es], x_c xs
// [P][4] (float32).
struct SdfTile {
  bf16* Hh;
  bf16* E;
  float* g1;
  float* aE;
  float* xs;
};

// The forward kernel's shared memory: the ring and SdfTile.
inline size_t sdf_fwd_tc_smem(const Model& m) {
  const int P = TC_P_SDF;
  return TC_RING_BYTES + (size_t)P * tc_ldh(m.sdf) * 2 + (size_t)P * m.es * 2
         + (size_t)2 * P * m.es * 4 + (size_t)P * 4 * 4;
}

// The backward's: the forward's with the mid and lo terms of a split operand
// (Hm, Hl) between Hh and E, and, after aE, the cotangents on aE and on the
// encoding [P][es] each before xs, and the cotangent on sdf [P] after it.
inline size_t sdf_tc_smem(const Model& m) {
  const int P = TC_P_SDF;
  return sdf_fwd_tc_smem(m) + (size_t)2 * P * tc_ldh(m.sdf) * 2 + (size_t)2 * P * m.es * 4
         + (size_t)P * 4;
}

// The SDF net's forward on the tile of P points at base (field_sdf's
// arithmetic, the products on tensor cores): the encoding and its derivative;
// hidden layers 0 .. NL-2 as tile products (softplus100), each
// pre-activation to sv.z, where the adjoint's gates read it back; then the
// adjoint: the head column gated by the last hidden layer, walked back
// through W^T (one pass per 256 input columns) to the encoding, whose part
// accumulates unrounded in t.aE. Without SAVE the output layer runs between
// the two, from the bf16 rows h_{NL-2}, as a tile product: sdf_out [n]
// (column 0, the head) and feat_out [n][F] (unrounded), each plus the bias,
// as field_sdf's. With SAVE each layer's operand rows go to
// sv.xin, the adjoint's operand rows to sv.ag and its ungated values to sv.a.
// The forward kernel and the backward's recompute both run it, so the
// forward the loss sees is the one the backward differentiates, bit for bit.
template <bool SAVE>
__device__ __forceinline__ void sdf_tc_forward(const float* __restrict__ wts, const Model& m,
                                               const TcFrags& fr, long long n, long long base,
                                               const float* __restrict__ xc, const SdfTile& t,
                                               uint4* ring, const TcScratch& sv,
                                               float* __restrict__ sdf_out,
                                               float* __restrict__ feat_out) {
  constexpr int P = TC_P_SDF, MT = P / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Net& S = m.sdf;
  const int es = m.es, ldh = tc_ldh(S);
  bf16* Hh = t.Hh;
  const bf16* const A1[1] = {Hh};
  const int np_me = warp * TC_NPW;
  const int np_hmax = HMAX / 16;                 // pairs in place: the h columns

  for (int idx = tid; idx < P * ldh; idx += NT) Hh[idx] = bzero();
  for (int idx = tid; idx < P * 4; idx += NT) {
    const int p = idx >> 2, c = idx & 3;
    t.xs[idx] = c < 3 && in_tile(base, p, n) ? xc[(size_t)(base + p) * 3 + c] : 0.f;
  }
  __syncthreads();
  for (int idx = tid; idx < P * es; idx += NT) {   // field_sdf's encoding
    const int p = idx / es, c = idx - p * es;
    int dim, kind; float sc;
    enc_col(c, 3, dim, kind, sc);
    const float v = bf16r(t.xs[p * 4 + dim]) * sc;
    const float sv_ = sinf(v), cv = cosf(v);
    t.E[idx] = __float2bfloat16_rn(kind == 0 ? v : (kind == 1 ? sv_ : cv));
    t.g1[idx] = kind == 0 ? 1.f : (kind == 1 ? cv : -sv_);
    t.aE[idx] = 0.f;
  }
  __syncthreads();
  put_enc(Hh, ldh, 0, t.E, es, P, tid);
  __syncthreads();

  // ---- hidden layers
  float acc[MT][2 * TC_NPW][4];
  for (int l = 0; l < NL - 1; ++l) {
    const int in_l = S.in_dim[l], out_l = S.out_dim[l];
    const bool skip = (S.skip_mask >> l) & 1;
    if (l > 0 && skip) {
      put_enc(Hh, ldh, in_l - es, t.E, es, P, tid);
      __syncthreads();
    }
    if (SAVE) save_rows<1, P>(sv.xin[l], Hh, ldh, c16(in_l), base, n, tid);
    const int npw = clampw(c16(out_l) / 16 - np_me);
    zero_acc(acc);
    tile_mma<MT, 1>(acc, A1, ldh, (const uint4*)(wts + fr.w[l]), c16(out_l) / 16, np_me, npw, 0,
                    c16(in_l) / 16, ring, lane);
    __syncthreads();
    const float sc = skip ? kInvSqrt2 : 1.f;
    const float* b = wts + S.b_off[l];
    for_pairs(acc, np_me, npw, lane, [&](int row, int c, float a0, float a1) {
      const float z0 = a0 * sc + b[c], z1 = a1 * sc + b[c + 1];   // out_l: a multiple of 16
      Hh[row * ldh + c] = __float2bfloat16_rn(softplus100(z0));
      Hh[row * ldh + c + 1] = __float2bfloat16_rn(softplus100(z1));
      if (base + row < n) *(float2*)(sv.z[l] + (size_t)(base + row) * out_l + c) = make_float2(z0, z1);
    });
    __syncthreads();
  }
  {
    const int l = NL - 1, n_in = S.in_dim[l];
    if (SAVE) save_rows<1, P>(sv.xin[l], Hh, ldh, c16(n_in), base, n, tid);
    if (!SAVE) {
      // the output layer (column 0 the head, 1 .. F the feature) as tile
      // products, one pass per 256 columns, + the bias
      const int n_out = S.out_dim[l], F = n_out - 1, np_o = c16(n_out) / 16;
      const uint4* B = (const uint4*)(wts + fr.w[l]);
      const float* b = wts + S.b_off[l];
      auto out = [&](int row, int c, float a0, float a1) {
        const long long i = base + row;
        const float a[2] = {a0, a1};
        for (int e = 0; e < 2; ++e) {
          const int j = c + e;
          if (i >= n || j >= n_out) continue;
          if (j == 0) sdf_out[i] = a[e] + b[0];
          else feat_out[(size_t)i * F + j - 1] = a[e] + b[j];
        }
      };
      for (int np0 = np_me; np0 < np_o; np0 += np_hmax) {
        const int npw = clampw(np_o - np0);
        zero_acc(acc);
        tile_mma<MT, 1>(acc, A1, ldh, B, np_o, np0, npw, 0, c16(n_in) / 16, ring, lane);
        for_pairs(acc, np0, npw, lane, out);
      }
    }
    __syncthreads();
    // adjoint seed: the head column gated by the last hidden layer
    for (int idx = tid; idx < P * n_in; idx += NT) {
      const int p = idx / n_in, i = idx - p * n_in;
      float v = 0.f;
      if (base + p < n)
        v = wts[m.head_off + i] * sigmoidf_(100.f * sv.z[l - 1][(size_t)(base + p) * n_in + i]);
      Hh[p * ldh + i] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    if (SAVE) save_rows<1, P>(sv.ag[l - 1], Hh, ldh, c16(n_in), base, n, tid);
  }

  // ---- the SDF adjoint: layers NL-2 .. 0 through W^T; the encoding part of
  // a layer's input goes to aE, unrounded
  for (int l = NL - 2; l >= 0; --l) {
    const int in_l = S.in_dim[l], out_l = S.out_dim[l];
    const bool skip = (S.skip_mask >> l) & 1;
    const int n_h = l == 0 ? 0 : (skip ? in_l - es : in_l);
    const float sc = skip ? kInvSqrt2 : 1.f;
    const int np_in = c16(in_l) / 16;
    const uint4* B = (const uint4*)(wts + fr.wt[l]);
    auto epi = [&](int row, int c, float a0, float a1) {
      const float v[2] = {a0 * sc, a1 * sc};
      for (int e = 0; e < 2; ++e) {
        const int i = c + e;
        if (i >= in_l) continue;
        if (i < n_h) {
          float o = 0.f;
          if (base + row < n) {
            const size_t q = (size_t)(base + row) * n_h + i;
            if (SAVE) sv.a[l - 1][q] = v[e];
            o = v[e] * sigmoidf_(100.f * sv.z[l - 1][q]);
          }
          Hh[row * ldh + i] = __float2bfloat16_rn(o);
        } else {
          t.aE[row * es + (i - n_h)] += v[e];
        }
      }
    };
    // columns past the h part's HMAX (a wide skip input's encoding) first:
    // they touch only aE, so they need no barrier before the in-place rest
    const int npx = clampw(np_in - np_hmax - np_me);
    if (npx > 0) {
      zero_acc(acc);
      tile_mma<MT, 1>(acc, A1, ldh, B, np_in, np_hmax + np_me, npx, 0, c16(out_l) / 16, ring,
                      lane);
      for_pairs(acc, np_hmax + np_me, npx, lane, epi);
    }
    const int npw = clampw(min(np_in, np_hmax) - np_me);
    zero_acc(acc);
    tile_mma<MT, 1>(acc, A1, ldh, B, np_in, np_me, npw, 0, c16(out_l) / 16, ring, lane);
    __syncthreads();
    for_pairs(acc, np_me, npw, lane, epi);
    __syncthreads();
    if (SAVE && l > 0) save_rows<1, P>(sv.ag[l - 1], Hh, ldh, c16(n_h), base, n, tid);
  }
}

// grad_c [n][3] from the tile's adjoint on the encoding, as field_sdf's: per
// dimension the sum over its encoding columns c, in order, of op(aE_c g'_c)
// times the column's scale.
__device__ __forceinline__ void sdf_tc_grad_c(const Model& m, const SdfTile& t, long long base,
                                              long long n, float* __restrict__ gc) {
  const int P = TC_P_SDF, es = m.es;
  for (int idx = threadIdx.x; idx < P * 3; idx += NT) {
    const int p = idx / 3, mm = idx - p * 3;
    float g = 0.f;
    for (int c = 0; c < es; ++c) {
      int dim, kind; float sc;
      enc_col(c, 3, dim, kind, sc);
      if (dim == mm) g += bf16r(t.aE[p * es + c] * t.g1[p * es + c]) * sc;
    }
    if (base + p < n) gc[(size_t)(base + p) * 3 + mm] = g;
  }
}

// x_c [n][3] -> sdf [n], feat [n][F], grad_c [n][3]; sv holds only the
// pre-activations (the workspace plan_sdf_fwd_tc lays out).
__global__ void __launch_bounds__(NT, 2)
sdf_fwd_tc_kernel(const float* __restrict__ wts, const __grid_constant__ Model m,
                  const __grid_constant__ TcFrags fr, long long n,
                  const float* __restrict__ xc, float* __restrict__ sdf,
                  float* __restrict__ feat, float* __restrict__ gc,
                  const __grid_constant__ TcScratch sv) {
  constexpr int P = TC_P_SDF;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int warp = threadIdx.x >> 5;
  uint4* ring = (uint4*)tc_smem + warp * (TC_STAGES * TC_NPW * 32);
  SdfTile t;
  t.Hh = (bf16*)(tc_smem + TC_RING_BYTES);
  t.E = t.Hh + P * tc_ldh(m.sdf);
  t.g1 = (float*)(t.E + P * m.es);
  t.aE = t.g1 + P * m.es;
  t.xs = t.aE + P * m.es;
  const long long base = (long long)blockIdx.x * P;
  sdf_tc_forward<false>(wts, m, fr, n, base, xc, t, ring, sv, sdf, feat);
  sdf_tc_grad_c(m, t, base, n, gc);
}

__global__ void __launch_bounds__(NT, 1)
sdf_bwd_tc_kernel(const float* __restrict__ wts, Model m, TcFrags fr, long long n,
                  const float* __restrict__ xc, const float* __restrict__ g_sdf,
                  const float* __restrict__ g_feat, const float* __restrict__ g_gc,
                  float* __restrict__ dxc, const __grid_constant__ TcScratch sv) {
  constexpr int P = TC_P_SDF, MT = P / 16;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Net& S = m.sdf;
  const int es = m.es, F = m.feat_dim, G = 1 + F, ldh = tc_ldh(S);
  uint4* ring = (uint4*)tc_smem + warp * (TC_STAGES * TC_NPW * 32);
  bf16* Hh = (bf16*)(tc_smem + TC_RING_BYTES);      // [P][ldh] the operand (hi)
  bf16* Hm = Hh + P * ldh;                       // [P][ldh] mid and lo terms of a split
  bf16* Hl = Hm + P * ldh;                       //   float32 operand
  bf16* E = Hl + P * ldh;                        // [P][es] encoding
  const bf16* const A3[3] = {Hh, Hm, Hl};
  float* g1 = (float*)(E + P * es);              // [P][es] encoding derivative
  float* aE = g1 + P * es;                       // [P][es] adjoint on the encoding, then
                                                 //   d v through g'' (the SIMT's s_dv2)
  float* daE = aE + P * es;                      // [P][es] cotangent on aE
  float* de = daE + P * es;                      // [P][es] cotangent on the encoding
  float* xs = de + P * es;                       // [P][4]
  float* gs = xs + P * 4;                        // [P] cotangent on sdf
  const long long base = (long long)blockIdx.x * P;
  const int np_me = warp * TC_NPW;
  const int np_hmax = HMAX / 16;                 // pairs in place: the h columns

  // ---- forward recompute: hidden layers and the adjoint, with the saves
  for (int idx = tid; idx < 2 * P * ldh; idx += NT) Hm[idx] = bzero();
  sdf_tc_forward<true>(wts, m, fr, n, base, xc, SdfTile{Hh, E, g1, aE, xs}, ring, sv, nullptr,
                       nullptr);

  // The split of a float32 operand value into the three terms.
  auto put_split = [&](int row, int c, float v) {
    split3_bf16(v, Hh[row * ldh + c], Hm[row * ldh + c], Hl[row * ldh + c]);
  };
  float acc[MT][2 * TC_NPW][4];

  // ---- cotangents in: on aE (through grad_c), the g'' term, sdf and feat
  for (int idx = tid; idx < P * es; idx += NT) {
    const int p = idx / es, c = idx - p * es;
    int dim, kind; float sc;
    enc_col(c, 3, dim, kind, sc);
    const float dP = in_tile(base, p, n) ? bf16r(g_gc[(size_t)(base + p) * 3 + dim] * sc) : 0.f;
    daE[idx] = dP * g1[idx];
    const float v = bf16r(xs[p * 4 + dim]) * sc;
    const float g2 = kind == 0 ? 0.f : (kind == 1 ? -sinf(v) : -cosf(v));
    aE[idx] = dP * aE[idx] * g2;
    de[idx] = 0.f;
  }
  for (int idx = tid; idx < P; idx += NT) gs[idx] = in_tile(base, idx, n) ? g_sdf[base + idx] : 0.f;
  {
    const int w = c16(G);
    for (int idx = tid; idx < P * w; idx += NT) {   // the output layer's cotangent [g_sdf | g_feat]
      const int p = idx / w, f = idx - p * w;
      if (base + p >= n) continue;
      float v = 0.f;
      if (in_tile(base, p, n) && f < G)
        v = f == 0 ? g_sdf[base + p] : g_feat[(size_t)(base + p) * F + f - 1];
      sv.dz[NL - 1][(size_t)(base + p) * w + f] = v;
    }
  }
  __syncthreads();

  // ---- the adjoint walk reversed: layers 0 .. NL-2. Layer l's adjoint dot
  // a_l <- [da (n_h) | daE (es, at l = 0 and the skips)] W_l: two separately
  // rounded dots; its output's cotangent dag gives the softplus' second-order
  // term of dz_l and, gated, the operand of layer l + 1's dot
  for (int l = 0; l < NL - 1; ++l) {
    const int in_l = S.in_dim[l], out_l = S.out_dim[l];
    const bool skip = (S.skip_mask >> l) & 1;
    const bool sec = l == 0 || skip;
    const int n_h = l == 0 ? 0 : (skip ? in_l - es : in_l);   // a multiple of 16
    const int kin = c16(in_l);
    const float sc = skip ? kInvSqrt2 : 1.f;
    if (sec) {
      for (int idx = tid; idx < P * (kin - n_h); idx += NT) {
        const int p = idx / (kin - n_h), c = idx - p * (kin - n_h);
        const float v = c < es ? daE[p * es + c] : 0.f;
        put_split(p, n_h + c, v);
        if (c < es && base + p < n) sv.da[l][(size_t)(base + p) * kin + n_h + c] = v;
      }
      __syncthreads();
    }
    const uint4* B = (const uint4*)(wts + fr.w[l]);
    const int np_out = c16(out_l) / 16, npw = clampw(np_out - np_me);
    uint32_t r2[MT][2 * TC_NPW][2] = {};       // the encoding dot, rounded (bf16 pairs)
    if (sec) {
      zero_acc(acc);
      tile_mma<MT, 3>(acc, A3, ldh, B, np_out, np_me, npw, n_h / 16, kin / 16, ring, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2 * TC_NPW; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(acc[mt][nt][2 * h] * sc,
                                                           acc[mt][nt][2 * h + 1] * sc);
            r2[mt][nt][h] = *(const uint32_t*)&v;
          }
    }
    zero_acc(acc);
    if (n_h) tile_mma<MT, 3>(acc, A3, ldh, B, np_out, np_me, npw, 0, n_h / 16, ring, lane);
    __syncthreads();
    const bool top = l == NL - 2;
    const int kn = c16(S.in_dim[l + 1]), kz = c16(out_l);
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2 * TC_NPW; ++nt) {
        if (nt >= 2 * npw) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = mt * 16 + g + h * 8, c = np_me * 16 + nt * 8 + 2 * t;
          const __nv_bfloat162 sec2 = *(const __nv_bfloat162*)&r2[mt][nt][h];
          float dag[2], val[2] = {0.f, 0.f};
          dag[0] = (n_h ? bf16r(acc[mt][nt][2 * h] * sc) : 0.f)
                   + (sec ? __low2float(sec2) : 0.f);
          dag[1] = (n_h ? bf16r(acc[mt][nt][2 * h + 1] * sc) : 0.f)
                   + (sec ? __high2float(sec2) : 0.f);
          if (base + row < n) {
            const size_t rz = (size_t)(base + row) * out_l + c;
            const float2 z = *(const float2*)(sv.z[l] + rz);
            const float sig[2] = {sigmoidf_(100.f * z.x), sigmoidf_(100.f * z.y)};
            float a[2];
            if (top) {
              a[0] = wts[m.head_off + c];
              a[1] = wts[m.head_off + c + 1];
            } else {
              const float2 av = *(const float2*)(sv.a[l] + rz);
              a[0] = av.x; a[1] = av.y;
            }
            for (int e = 0; e < 2; ++e) {
              sv.dz[l][(size_t)(base + row) * kz + c + e] =
                  dag[e] * a[e] * 100.f * sig[e] * (1.f - sig[e]);
              val[e] = dag[e] * sig[e];
            }
            float* dst = top ? sv.dhead + (size_t)(base + row) * out_l + c
                             : sv.da[l + 1] + (size_t)(base + row) * kn + c;
            *(float2*)dst = make_float2(val[0], val[1]);
          }
          put_split(row, c, val[0]);
          put_split(row, c + 1, val[1]);
        }
      }
    __syncthreads();
  }

  // ---- the primal walk: the output layer (head + feature), then layers
  // NL-2 .. 0 through W^T
  {
    const int l = NL - 1, n_in = S.in_dim[l], kh = c16(G);
    for (int idx = tid; idx < P * kh; idx += NT) {   // [0 | g_feat]: the feature block's operand
      const int p = idx / kh, f = idx - p * kh;
      put_split(p, f, f >= 1 && f < G && in_tile(base, p, n)
                          ? g_feat[(size_t)(base + p) * F + f - 1] : 0.f);
    }
    __syncthreads();
    const int npw = clampw(c16(n_in) / 16 - np_me);
    zero_acc(acc);
    tile_mma<MT, 3>(acc, A3, ldh, (const uint4*)(wts + fr.wt[l]), c16(n_in) / 16, np_me, npw, 0,
                    kh / 16, ring, lane);
    __syncthreads();
    const float* head = wts + S.wt_off[l];       // W^T row 0: the head column
    const int kz = c16(S.out_dim[l - 1]);
    for_pairs(acc, np_me, npw, lane, [&](int row, int c, float a0, float a1) {
      float o[2] = {0.f, 0.f};
      if (base + row < n) {
        const float2 z = *(const float2*)(sv.z[l - 1] + (size_t)(base + row) * n_in + c);
        const float zz[2] = {z.x, z.y}, af[2] = {a0, a1};
        for (int e = 0; e < 2; ++e) {
          const float acc_h = fmaf(gs[row], head[c + e], 0.f);
          float* q = sv.dz[l - 1] + (size_t)(base + row) * kz + c + e;
          o[e] = (bf16r(acc_h) + bf16r(af[e])) * sigmoidf_(100.f * zz[e]) + *q;
          *q = o[e];
        }
      }
      put_split(row, c, o[0]);
      put_split(row, c + 1, o[1]);
    });
    __syncthreads();
  }
  for (int l = NL - 2; l >= 0; --l) {
    const int in_l = S.in_dim[l], out_l = S.out_dim[l];
    const bool skip = (S.skip_mask >> l) & 1;
    const int n_h = l == 0 ? 0 : (skip ? in_l - es : in_l);
    const float sc = skip ? kInvSqrt2 : 1.f;
    const int np_in = c16(in_l) / 16, kz = l > 0 ? c16(S.out_dim[l - 1]) : 0;
    const uint4* B = (const uint4*)(wts + fr.wt[l]);
    auto epi = [&](int row, int c, float a0, float a1) {
      const float v[2] = {bf16r(a0 * sc), bf16r(a1 * sc)};
      if (c < n_h) {                              // n_h is a multiple of 16: both columns
        float o[2] = {0.f, 0.f};
        if (base + row < n) {
          const size_t q = (size_t)(base + row) * n_h + c;
          const float2 z = *(const float2*)(sv.z[l - 1] + q);
          const float zz[2] = {z.x, z.y};
          for (int e = 0; e < 2; ++e) {
            float* d = sv.dz[l - 1] + (size_t)(base + row) * kz + c + e;
            o[e] = v[e] * sigmoidf_(100.f * zz[e]) + *d;
            *d = o[e];
          }
        }
        put_split(row, c, o[0]);
        put_split(row, c + 1, o[1]);
      } else {
        for (int e = 0; e < 2; ++e)
          if (c + e < in_l) de[row * es + (c + e - n_h)] += v[e];
      }
    };
    const int npx = clampw(np_in - np_hmax - np_me);
    if (npx > 0) {
      zero_acc(acc);
      tile_mma<MT, 3>(acc, A3, ldh, B, np_in, np_hmax + np_me, npx, 0, c16(out_l) / 16, ring,
                      lane);
      for_pairs(acc, np_hmax + np_me, npx, lane, epi);
    }
    const int npw = clampw(min(np_in, np_hmax) - np_me);
    zero_acc(acc);
    tile_mma<MT, 3>(acc, A3, ldh, B, np_in, np_me, npw, 0, c16(out_l) / 16, ring, lane);
    __syncthreads();
    for_pairs(acc, np_me, npw, lane, epi);
    __syncthreads();
  }

  // ---- d x_c: through the encoding (g') and grad_c's g'' term
  for (int idx = tid; idx < P * 3; idx += NT) {
    const int p = idx / 3, mm = idx - p * 3;
    float gsum = 0.f;
    for (int c = 0; c < es; ++c) {
      int dim, kind; float sc;
      enc_col(c, 3, dim, kind, sc);
      if (dim == mm) gsum += (de[p * es + c] * g1[p * es + c] + aE[p * es + c]) * sc;
    }
    if (base + p < n) dxc[(size_t)(base + p) * 3 + mm] = bf16r(gsum);
  }
}

// ---------------------------------------------------------------------------
// colour: the tile's forward (shared by the forward kernel and the backward's
// recompute), the forward kernel (color), the backward (cotangent on color
// [n][3] -> d x_c, d grad_c, d d_c [n][3], d feat [n][F] and the scratch)
// ---------------------------------------------------------------------------

// Shared memory after the weight ring: the layer's operand H [P][ldh] and the
// colour input E [P][ci] (bf16), x_c and d_c [P][4] each (float32); the
// backward adds the relu' bits [NL-1][P][HMAX / 32], the output layer's
// cotangent [P][4] and the cotangent on the colour input's first three
// sections [P][cp + 3 + cr] (float32).
struct ColorTile {
  bf16* H;
  bf16* E;
  float* xs;
  float* ds;
  uint32_t* gbit;
};

inline size_t color_fwd_tc_smem(const Model& m) {
  const int P = TC_P_COLOR;
  return TC_RING_BYTES + (size_t)P * tc_ldh(m.color) * 2 + (size_t)P * m.ci * 2
         + (size_t)2 * P * 4 * 4;
}

inline size_t color_tc_smem(const Model& m) {
  const int P = TC_P_COLOR;
  return color_fwd_tc_smem(m) + (size_t)(NL - 1) * P * (HMAX / 32) * 4 + (size_t)P * 4 * 4
         + (size_t)P * (m.cp + 3 + m.cr) * 4;
}

__device__ __forceinline__ ColorTile color_tile(unsigned char* smem, const Model& m) {
  constexpr int P = TC_P_COLOR;
  ColorTile s;
  s.H = (bf16*)(smem + TC_RING_BYTES);
  s.E = s.H + P * tc_ldh(m.color);
  s.xs = (float*)(s.E + P * m.ci);
  s.ds = s.xs + P * 4;
  s.gbit = (uint32_t*)(s.ds + P * 4);
  return s;
}

// The colour net's forward on the tile of P points at base (field_color's
// arithmetic, the products on tensor cores): the colour input [enc(x_c),
// grad_c, enc(d_c), feat] (feat as loaded), each value rounded to bf16, then
// hidden layers 0 .. NL-2 as tile products (relu). Leaves in s.H the output
// layer's operand rows h_{NL-2}. With SAVE each layer's operand rows go to
// sv.xin and the relu' of each hidden output to s.gbit. The forward kernel
// and the backward's recompute both run it, so the forward the loss sees is
// the one the backward differentiates, bit for bit.
template <bool SAVE>
__device__ __forceinline__ void color_tc_forward(const float* __restrict__ wts, const Model& m,
                                                 const TcFrags& fr, long long n, long long base,
                                                 const float* __restrict__ xc,
                                                 const float* __restrict__ gc,
                                                 const float* __restrict__ dc,
                                                 const float* __restrict__ feat,
                                                 const ColorTile& s, uint4* ring,
                                                 const TcScratch& sv) {
  constexpr int P = TC_P_COLOR, MT = P / 16, WB = HMAX / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Net& C = m.color;
  const int ci = m.ci, cp = m.cp, cr = m.cr, F = m.feat_dim, nd = cp + 3 + cr;
  const int ldh = tc_ldh(C);
  bf16* H = s.H;
  bf16* E = s.E;
  const bf16* const A1[1] = {H};
  const int np_me = warp * TC_NPW;

  for (int idx = tid; idx < P * ldh; idx += NT) H[idx] = bzero();
  for (int idx = tid; idx < P * 4; idx += NT) {
    const int p = idx >> 2, c = idx & 3;
    const bool in = c < 3 && in_tile(base, p, n);
    s.xs[idx] = in ? xc[(size_t)(base + p) * 3 + c] : 0.f;
    s.ds[idx] = in ? dc[(size_t)(base + p) * 3 + c] : 0.f;
  }
  __syncthreads();
  for (int idx = tid; idx < P * ci; idx += NT) {   // field_color's input, feat as loaded
    const int p = idx / ci, c = idx - p * ci;
    float val;
    if (c < cp || (c >= cp + 3 && c < nd)) {
      const bool pos = c < cp;
      int dim, kind; float sc;
      enc_col(pos ? c : c - cp - 3, 3, dim, kind, sc);
      const float v = bf16r((pos ? s.xs : s.ds)[p * 4 + dim]) * sc;
      val = kind == 0 ? v : (kind == 1 ? sinf(v) : cosf(v));
    } else if (c < cp + 3) {
      val = in_tile(base, p, n) ? gc[(size_t)(base + p) * 3 + c - cp] : 0.f;
    } else {
      val = in_tile(base, p, n) ? feat[(size_t)(base + p) * F + c - nd] : 0.f;
    }
    E[idx] = __float2bfloat16_rn(val);
  }
  __syncthreads();
  put_enc(H, ldh, 0, E, ci, P, tid);
  __syncthreads();

  float acc[MT][2 * TC_NPW][4];
  for (int l = 0; l < NL - 1; ++l) {
    const int in_l = C.in_dim[l], out_l = C.out_dim[l];
    const bool skip = (C.skip_mask >> l) & 1;
    if (l > 0 && skip) {
      put_enc(H, ldh, in_l - ci, E, ci, P, tid);
      __syncthreads();
    }
    if (SAVE) save_rows<1, P>(sv.xin[l], H, ldh, c16(in_l), base, n, tid);
    const int np_out = c16(out_l) / 16, npw = clampw(np_out - np_me);
    zero_acc(acc);
    tile_mma<MT, 1>(acc, A1, ldh, (const uint4*)(wts + fr.w[l]), np_out, np_me, npw, 0,
                    c16(in_l) / 16, ring, lane);
    __syncthreads();
    const float sc = skip ? kInvSqrt2 : 1.f;
    const float* b = wts + C.b_off[l];
    uint32_t bits[MT][2] = {};                   // rows 16 mt + g, 16 mt + g + 8
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2 * TC_NPW; ++nt) {
        if (nt >= 2 * npw) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = mt * 16 + g + (e >> 1) * 8, cl = nt * 8 + 2 * t + (e & 1);
          const int c = np_me * 16 + cl;
          bf16 hv = bzero();
          if (c < out_l) {
            hv = __float2bfloat16_rn(fmaxf(acc[mt][nt][e] * sc + b[c], 0.f));
            if (SAVE && __bfloat162float(hv) > 0.f) bits[mt][e >> 1] |= 1u << cl;
          }
          H[row * ldh + c] = hv;
        }
      }
    if (SAVE) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          bits[mt][0] |= __shfl_xor_sync(0xffffffffu, bits[mt][0], o);
          bits[mt][1] |= __shfl_xor_sync(0xffffffffu, bits[mt][1], o);
        }
        if (t == 0 && warp < WB) {
          s.gbit[(l * P + mt * 16 + g) * WB + warp] = bits[mt][0];
          s.gbit[(l * P + mt * 16 + g + 8) * WB + warp] = bits[mt][1];
        }
      }
    }
    __syncthreads();
  }
  if (SAVE) save_rows<1, P>(sv.xin[NL - 1], H, ldh, c16(C.in_dim[NL - 1]), base, n, tid);
}

// rgb channel c of tile row p from the output layer's bf16 operand rows (3
// wide, SIMT): an FMA chain in k order, as field_color's, then the sigmoid.
__device__ __forceinline__ float color_tc_rgb(const float* __restrict__ wts, const Net& C,
                                              const bf16* H, int ldh, int p, int c) {
  const int l = NL - 1, in_l = C.in_dim[l], out_l = C.out_dim[l];   // out_l == 3
  const float sc = ((C.skip_mask >> l) & 1) ? kInvSqrt2 : 1.f;
  const float* W = wts + C.w_off[l];             // [in][out]
  float a = 0.f;
  for (int k = 0; k < in_l; ++k)
    a = fmaf(__bfloat162float(H[p * ldh + k]), __ldg(W + (size_t)k * out_l + c), a);
  return sigmoidf_(a * sc + wts[C.b_off[l] + c]);
}

// (x_c, grad_c, d_c [n][3], feat [n][F]) -> color, row i at color + i * ldc.
__global__ void __launch_bounds__(NT, 1)
color_fwd_tc_kernel(const float* __restrict__ wts, const __grid_constant__ Model m,
                    const __grid_constant__ TcFrags fr, long long n,
                    const float* __restrict__ xc, const float* __restrict__ gc,
                    const float* __restrict__ dc, const float* __restrict__ feat,
                    float* __restrict__ color, int ldc) {
  constexpr int P = TC_P_COLOR;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int warp = threadIdx.x >> 5;
  uint4* ring = (uint4*)tc_smem + warp * (TC_STAGES * TC_NPW * 32);
  const ColorTile s = color_tile(tc_smem, m);
  const long long base = (long long)blockIdx.x * P;
  color_tc_forward<false>(wts, m, fr, n, base, xc, gc, dc, feat, s, ring, TcScratch{});
  const int ldh = tc_ldh(m.color);
  for (int idx = threadIdx.x; idx < P * 3; idx += NT) {
    const int p = idx / 3, c = idx - p * 3;
    if (in_tile(base, p, n))
      color[(size_t)(base + p) * ldc + c] = color_tc_rgb(wts, m.color, s.H, ldh, p, c);
  }
}

__global__ void __launch_bounds__(NT, 1)
color_bwd_tc_kernel(const float* __restrict__ wts, Model m, TcFrags fr, long long n,
                    const float* __restrict__ xc, const float* __restrict__ gc,
                    const float* __restrict__ dc, const float* __restrict__ feat,
                    const float* __restrict__ g_color, float* __restrict__ dxc,
                    float* __restrict__ dgc, float* __restrict__ ddc,
                    float* __restrict__ dfeat, const __grid_constant__ TcScratch sv) {
  constexpr int P = TC_P_COLOR, MT = P / 16, WB = HMAX / 32, NPG = HMAX / 16;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Net& C = m.color;
  const int ci = m.ci, cp = m.cp, cr = m.cr, F = m.feat_dim, nd = cp + 3 + cr;
  const int ldh = tc_ldh(C);
  uint4* ring = (uint4*)tc_smem + warp * (TC_STAGES * TC_NPW * 32);
  const ColorTile tile = color_tile(tc_smem, m);
  bf16* H = tile.H;                              // [P][ldh] the layer's operand / cotangent
  const bf16* const A1[1] = {H};
  bf16* E = tile.E;                              // [P][ci] the colour input; in the walk the
                                                 //   cotangent the skip layer sends it
  float* xs = tile.xs;                           // [P][4] x_c
  float* ds = tile.ds;                           // [P][4] d_c
  uint32_t* gbit = tile.gbit;                    // [NL-1][P][WB] relu' of each hidden output
  float* dz8 = (float*)(gbit + (NL - 1) * P * WB);   // [P][4] the output layer's cotangent
  float* Dc = dz8 + P * 4;                       // [P][nd] cotangent on enc(x_c), grad_c, enc(d_c)
  const long long base = (long long)blockIdx.x * P;
  const int np_me = warp * TC_NPW;
  auto gate = [&](int l, int p, int i) {        // relu' of layer l's output i at point p
    return (gbit[(l * P + p) * WB + (i >> 5)] >> (i & 31)) & 1u;
  };

  // ---- forward recompute, hidden layers, with the saves
  color_tc_forward<true>(wts, m, fr, n, base, xc, gc, dc, feat, tile, ring, sv);
  float acc[MT][2 * TC_NPW][4];

  // ---- the output layer (3 wide, SIMT): rgb, an FMA chain in k order as
  // field_color's; its float32 cotangent g_color rgb (1 - rgb)
  {
    for (int idx = tid; idx < P * 4; idx += NT) {
      const int p = idx >> 2, c = idx & 3;
      float v = 0.f;
      if (c < C.out_dim[NL - 1] && in_tile(base, p, n)) {
        const float rgb = color_tc_rgb(wts, C, H, ldh, p, c);
        v = g_color[(size_t)(base + p) * 3 + c] * rgb * (1.f - rgb);
      }
      dz8[idx] = v;
      if (base + p < n) sv.dz[NL - 1][(size_t)(base + p) * 4 + c] = v;
    }
    // E now carries the skip layer's cotangent on the colour input (zero
    // where the net has no skip layer)
    for (int idx = tid; idx < P * ci; idx += NT) E[idx] = bzero();
  }
  __syncthreads();
  // its product through W^T (3 -> in), gated by the last hidden layer's relu'
  {
    const int l = NL - 1, in_l = C.in_dim[l], out_l = C.out_dim[l], w = c16(in_l);
    const float sc = ((C.skip_mask >> l) & 1) ? kInvSqrt2 : 1.f;
    const float* W = wts + C.w_off[l];
    for (int idx = tid; idx < P * w; idx += NT) {
      const int p = idx / w, i = idx - p * w;
      bf16 v = bzero();
      if (i < in_l && gate(l - 1, p, i)) {
        float a = 0.f;
        for (int j = 0; j < out_l; ++j) a = fmaf(dz8[p * 4 + j], W[(size_t)i * out_l + j], a);
        v = __float2bfloat16_rn(a * sc);
      }
      H[p * ldh + i] = v;
    }
  }
  __syncthreads();

  // ---- hidden layers NL-2 .. 0 through W^T. Each input column's cotangent
  // op(acc sc) goes to the h part (gated, in place) or to the colour input:
  // the skip layer's into E, then layer 0's added to it in float32, as the
  // SIMT kernel's s_dcin. Columns past in_l are the padding to c16(in_l). The inputs wider than the 256 columns the warps own
  // in one pass take more passes, one per group of 16 column pairs: those
  // past the h part first (they never touch H, so they need no barrier), the
  // group with the h part last, written in place after a barrier.
  for (int l = NL - 2; l >= 0; --l) {
    const int in_l = C.in_dim[l], out_l = C.out_dim[l];
    const bool skip = (C.skip_mask >> l) & 1;
    const int n_h = l == 0 ? 0 : (skip ? in_l - ci : in_l);
    const float sc = skip ? kInvSqrt2 : 1.f;
    const int np_in = c16(in_l) / 16, kt1 = c16(out_l) / 16;
    const uint4* B = (const uint4*)(wts + fr.wt[l]);
    save_rows<1, P>(sv.dzb[l], H, ldh, c16(out_l), base, n, tid);
    auto epi = [&](int row, int c, float a0, float a1) {
      const float a[2] = {a0, a1};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = c + e;
        const float v = bf16r(a[e] * sc);
        if (l > 0 && i < HMAX)
          H[row * ldh + i] = i < n_h && gate(l - 1, row, i) ? __float2bfloat16_rn(v) : bzero();
        if (i < n_h || i >= in_l) continue;
        const int j = i - n_h;                   // the colour input's column
        if (l > 0) E[row * ci + j] = __float2bfloat16_rn(v);
        else if (j < nd) Dc[row * nd + j] = __bfloat162float(E[row * ci + j]) + v;
        else if (base + row < n)
          dfeat[(size_t)(base + row) * F + j - nd] = __bfloat162float(E[row * ci + j]) + v;
      }
    };
    for (int gr = (np_in - 1) / NPG; gr >= 1; --gr) {
      const int np0 = gr * NPG + np_me, npw = clampw(np_in - np0);
      zero_acc(acc);
      tile_mma<MT, 1>(acc, A1, ldh, B, np_in, np0, npw, 0, kt1, ring, lane);
      for_pairs(acc, np0, npw, lane, epi);
    }
    const int npw = clampw(min(np_in, NPG) - np_me);
    zero_acc(acc);
    tile_mma<MT, 1>(acc, A1, ldh, B, np_in, np_me, npw, 0, kt1, ring, lane);
    __syncthreads();
    for_pairs(acc, np_me, npw, lane, epi);
    __syncthreads();
  }

  // ---- the sections of the colour input: [enc(x_c), grad_c, enc(d_c), feat]
  for (int idx = tid; idx < P * 3; idx += NT) {
    const int p = idx / 3, mm = idx - p * 3;
    float gx = 0.f, gd = 0.f;
    for (int c = 0; c < cp; ++c) {
      int dim, kind; float sc;
      enc_col(c, 3, dim, kind, sc);
      if (dim != mm) continue;
      const float v = bf16r(xs[p * 4 + mm]) * sc;
      gx += Dc[p * nd + c] * (kind == 0 ? 1.f : (kind == 1 ? cosf(v) : -sinf(v))) * sc;
    }
    for (int c = 0; c < cr; ++c) {
      int dim, kind; float sc;
      enc_col(c, 3, dim, kind, sc);
      if (dim != mm) continue;
      const float v = bf16r(ds[p * 4 + mm]) * sc;
      gd += Dc[p * nd + cp + 3 + c] * (kind == 0 ? 1.f : (kind == 1 ? cosf(v) : -sinf(v))) * sc;
    }
    if (base + p < n) {
      dxc[(size_t)(base + p) * 3 + mm] = bf16r(gx);
      ddc[(size_t)(base + p) * 3 + mm] = bf16r(gd);
      dgc[(size_t)(base + p) * 3 + mm] = Dc[p * nd + cp + mm];
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <class T>
const T* offset(const T* p, long long k) { return p ? p + k : nullptr; }

// The scratch of a segment's bf16 backward and its weight-gradient jobs
// (writing into grad at the packed weights' offsets); with null pointers it
// only counts: *scratch_floats, *partial_floats.
void plan_bwd_tc(const Model& m, int seg, long long n, void* scratch, float* grad,
                 TcScratch& sv, TcJobs& jobs, long long* scratch_floats,
                 long long* partial_floats) {
  BytePlanner pl{(char*)scratch};
  sv = TcScratch{};
  jobs.w.n_jobs = 0;
  jobs.w.n_blocks = 0;
  jobs.n_blocks = 0;
  long long part = 0;
  const Net& N = seg == SEG_DEFORM ? m.deform : (seg == SEG_SDF ? m.sdf : m.color);
  const long long S = seg == SEG_DEFORM ? 4 : 1;     // streams, stacked on the point axis
  for (int l = 0; l < NL; ++l) {
    const int in_l = N.in_dim[l], out_l = N.out_dim[l];
    if (seg != SEG_SDF) {
      sv.xin[l] = pl.take<bf16>(S * n * c16(in_l));
      if (l < NL - 1) sv.dzb[l] = pl.take<bf16>(S * n * c16(out_l));
      else sv.dz[l] = pl.take<float>(S * n * 4);
    } else {
      sv.xin[l] = pl.take<bf16>(n * c16(in_l));
      sv.dz[l] = pl.take<float>(n * c16(out_l));
      if (l < NL - 1) {
        sv.z[l] = pl.take<float>(n * out_l);
        sv.ag[l] = pl.take<bf16>(n * c16(out_l));
        sv.da[l] = pl.take<float>(n * c16(in_l));
        if (l < NL - 2) sv.a[l] = pl.take<float>(n * out_l);
      }
    }
  }
  if (seg == SEG_SDF) sv.dhead = pl.take<float>(n * N.in_dim[NL - 1]);
  for (int l = 0; l < NL; ++l) {
    const int in_l = N.in_dim[l], out_l = N.out_dim[l];
    const int lda = c16(in_l);
    const float sc = ((N.skip_mask >> l) & 1) ? kInvSqrt2 : 1.f;
    float* dw = grad ? grad + N.w_off[l] : nullptr;
    float* db = grad ? grad + N.b_off[l] : nullptr;
    if (seg != SEG_SDF) {
      // the output layer's cotangent is float32 (split in the product), the others bf16
      const bool top = l == NL - 1;
      const void* B = top ? (const void*)sv.dz[l] : (const void*)sv.dzb[l];
      const int kb = top ? OP_F32 : OP_BF16, ldb = top ? 4 : c16(out_l);
      const long long sb = n * ldb;
      add_tc_job(jobs, part, sv.xin[l], OP_BF16, lda, B, kb, ldb, n, in_l, out_l, sc, 1, dw,
                 out_l, 0);
      add_tc_job(jobs, part, nullptr, OP_ONES, 1, B, kb, ldb, n, 1, out_l, 1.f, 0, db, out_l, 0);
      if (seg == SEG_DEFORM)   // the three tangent streams, stacked on the point axis
        add_tc_job(jobs, part, offset(sv.xin[l], n * lda), OP_BF16, lda,
                   top ? (const void*)offset(sv.dz[l], sb) : (const void*)offset(sv.dzb[l], sb),
                   kb, ldb, 3 * n, in_l, out_l, sc, 1, dw, out_l, 1);
    } else {
      const int ldz = c16(out_l);
      add_tc_job(jobs, part, sv.xin[l], OP_BF16, lda, sv.dz[l], OP_F32, ldz, n, in_l, out_l, sc,
                 1, dw, out_l, 0);
      add_tc_job(jobs, part, nullptr, OP_ONES, 1, sv.dz[l], OP_F32, ldz, n, 1, out_l, 1.f, 0, db,
                 out_l, 0);
      if (l < NL - 1)      // the adjoint's product W^T
        add_tc_job(jobs, part, sv.da[l], OP_F32, lda, sv.ag[l], OP_BF16, ldz, n, in_l, out_l, sc,
                   1, dw, out_l, 1);
      else                 // the adjoint seed: head column
        add_tc_job(jobs, part, sv.dhead, OP_F32, in_l, nullptr, OP_ONES, 1, n, in_l, 1, 1.f, 0,
                   dw, out_l, 1);
    }
  }
  if (scratch_floats) *scratch_floats = (pl.used + 3) / 4;
  if (partial_floats) *partial_floats = part;
}

// The SDF forward's workspace: each hidden layer's pre-activations
// [n][out_l], which the adjoint's gates read back (a 64-point tile's are 512
// KB at base.yml's widths, past shared memory); with a null base it only
// counts. Returns its floats.
long long plan_sdf_fwd_tc(const Model& m, long long n, void* work, TcScratch& sv) {
  BytePlanner pl{(char*)work};
  sv = TcScratch{};
  for (int l = 0; l < NL - 1; ++l) sv.z[l] = pl.take<float>(n * m.sdf.out_dim[l]);
  return (pl.used + 3) / 4;
}

cudaError_t launch_deform_fwd_tc(const float* w, const TcFrags& fr, const Model& m,
                                 long long n, const float* xt, float* xc, float* jrows,
                                 cudaStream_t st) {
  const size_t smem = deform_tc_smem(m, false);
  cudaError_t e = set_smem(deform_fwd_tc_kernel, smem);
  if (e != cudaSuccess) return e;
  deform_fwd_tc_kernel<<<n_tiles(n, TC_P_DEFORM), NT, smem, st>>>(w, m, fr, n, xt, xc, jrows);
  return cudaGetLastError();
}

cudaError_t launch_deform_bwd_tc(const float* w, const long long* meta, const Model& m,
                                 long long n, const float* xt, const float* g_xc,
                                 const float* g_j, float* scratch, float* partial, float* grad,
                                 cudaStream_t st) {
  TcScratch sv;
  TcJobs jobs;
  plan_bwd_tc(m, SEG_DEFORM, n, scratch, grad, sv, jobs, nullptr, nullptr);
  const size_t smem = deform_tc_smem(m, true);
  cudaError_t e = set_smem(deform_bwd_tc_kernel, smem);
  if (e != cudaSuccess) return e;
  deform_bwd_tc_kernel<<<n_tiles(n, TC_P_DEFORM), NT, smem, st>>>(w, m, decode_frags(meta), n,
                                                                   xt, g_xc, g_j, sv);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return run_wgrad_tc(jobs, partial, st);
}

cudaError_t launch_sdf_fwd_tc(const float* w, const TcFrags& fr, const Model& m, long long n,
                              const float* xc, float* sdf, float* feat, float* gc, float* work,
                              cudaStream_t st) {
  TcScratch sv;
  plan_sdf_fwd_tc(m, n, work, sv);
  const size_t smem = sdf_fwd_tc_smem(m);
  cudaError_t e = set_smem(sdf_fwd_tc_kernel, smem);
  if (e != cudaSuccess) return e;
  sdf_fwd_tc_kernel<<<n_tiles(n, TC_P_SDF), NT, smem, st>>>(w, m, fr, n, xc, sdf, feat, gc, sv);
  return cudaGetLastError();
}

cudaError_t launch_sdf_bwd_tc(const float* w, const long long* meta, const Model& m, long long n,
                              const float* xc, const float* g_sdf, const float* g_feat,
                              const float* g_gc, float* dxc, float* scratch, float* partial,
                              float* grad, cudaStream_t st) {
  TcScratch sv;
  TcJobs jobs;
  plan_bwd_tc(m, SEG_SDF, n, scratch, grad, sv, jobs, nullptr, nullptr);
  const size_t smem = sdf_tc_smem(m);
  cudaError_t e = set_smem(sdf_bwd_tc_kernel, smem);
  if (e != cudaSuccess) return e;
  sdf_bwd_tc_kernel<<<n_tiles(n, TC_P_SDF), NT, smem, st>>>(w, m, decode_frags(meta), n, xc,
                                                             g_sdf, g_feat, g_gc, dxc, sv);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return run_wgrad_tc(jobs, partial, st);
}

// color [n][ldc]: rgb in columns 0 .. 2 of each row.
cudaError_t launch_color_fwd_tc(const float* w, const TcFrags& fr, const Model& m, long long n,
                                const float* xc, const float* gc, const float* dc,
                                const float* feat, float* color, int ldc, cudaStream_t st) {
  const size_t smem = color_fwd_tc_smem(m);
  cudaError_t e = set_smem(color_fwd_tc_kernel, smem);
  if (e != cudaSuccess) return e;
  color_fwd_tc_kernel<<<n_tiles(n, TC_P_COLOR), NT, smem, st>>>(w, m, fr, n, xc, gc, dc, feat,
                                                                 color, ldc);
  return cudaGetLastError();
}

cudaError_t launch_color_bwd_tc(const float* w, const long long* meta, const Model& m,
                                long long n, const float* xc, const float* gc, const float* dc,
                                const float* feat, const float* g_color, float* dxc, float* dgc,
                                float* ddc, float* dfeat, float* scratch, float* partial,
                                float* grad, cudaStream_t st) {
  TcScratch sv;
  TcJobs jobs;
  plan_bwd_tc(m, SEG_COLOR, n, scratch, grad, sv, jobs, nullptr, nullptr);
  const size_t smem = color_tc_smem(m);
  cudaError_t e = set_smem(color_bwd_tc_kernel, smem);
  if (e != cudaSuccess) return e;
  color_bwd_tc_kernel<<<n_tiles(n, TC_P_COLOR), NT, smem, st>>>(
      w, m, decode_frags(meta), n, xc, gc, dc, feat, g_color, dxc, dgc, ddc, dfeat, sv);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return run_wgrad_tc(jobs, partial, st);
}

}  // namespace
