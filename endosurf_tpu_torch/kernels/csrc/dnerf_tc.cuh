// The D-NeRF nets (deform, density, colour: nerf-style relu MLPs whose skip
// layers read [h | enc] unscaled) on Hopper's tensor cores, for the bf16
// ("default" dot mode) kernels: a tile of DT_P points, the forward of a net's
// hidden layers as tile products on mma.sync (mma_tile.cuh), and the coarse
// sweep kernel (deform -> density -> the raw density column) over a point
// source: the EndoNeRF render's rays (fused_render_dnerf.cu) and the raw
// density query's point list (fused_sdf.cu). The render's field stage, the
// three forwards and the density, deform and colour backwards' recompute
// (fused_train_dnerf.cu) run the same tile.
//
// Replaces, for the bf16 mode, the SIMT code of dnerf_chain.cuh and
// sdf_chain.cuh's D-NeRF sweep inside the ports of the Pallas TPU kernels
// endosurf_tpu/kernels/fused_render_dnerf.py (fused_render_rays_dnerf),
// fused_sdf.py (fused_density_raw) and fused_train_dnerf.py
// (_deform_fwd_pl, _density_fwd_pl, _color_fwd_pl, _deform_bwd_pl,
// _density_bwd_pl, _color_bwd_pl):
// there the weights stay in VMEM and
// the samples stream through the MXU. Here a block of NT threads owns DT_P
// points: the layer's operand rows sit in shared memory as bf16, the weights
// stream from L2 in fragment order through each warp's cp.async ring, each
// warp owns 32 of the 256 output columns for all the rows, and each k-tile's
// sum is promoted into float32 registers. A skip layer's operand is [h | E]
// with the encoding E put back beside h. What is not a product stays SIMT in
// the same kernel: the encodings, the deform net's 3-wide output layer, the
// density's raw column (column 0 of its output layer), the colour net's
// 3-wide output layer and sigmoid. The relu' of each hidden output is kept
// as bits in shared memory (the backward's gates); nothing else leaves the
// tile but what a caller saves.
//
// The same maths as dnerf_chain.cuh's (and the D-NeRF sweep's) between the
// bf16 roundings, computed nearer to exact: every operand (op(coordinates) or
// the sweep's raw coordinates encoded, op(relu), op(feature)) is a bf16 value
// and every weight is one (packed by fused_train_dnerf.pack_dnerf), so a
// product's terms are exact, and the sums run in the mma's order, each
// k-tile's promoted into float32; the encodings (sin, cos of the exact
// scaled coordinate), the 3-wide output layers, x_c and the raw column run in
// double, each rounded once (a double goes to bf16 through float32, as the
// float64 plain version rounds). The fields are chaotic in their
// coordinates (ten octaves), and a raw density near 0 decides a sample's
// opacity through the relu, so those SIMT parts are where float32 sums would
// put the kernel as far from exact as the SIMT kernels (PERF.md §6).
// Coordinates: the field evaluation rounds them before it encodes them, the
// sweep does not (RX).
//
// What bounds it: the products, 2 MFLOP a coarse point and 2.2 a fine one
// with base.yml's nets (the render chunk 0.835 TFLOP, 0.84 ms at the bf16
// tensor-core rate); a point's inputs and outputs are a few floats, the bf16
// weights 2.2 MB, read from L2 once a tile.
//
// Anonymous namespace: one copy per .cu, as sdf_chain.cuh.

#pragma once

#include "dnerf_chain.cuh"
#include "mma_tile.cuh"

#define DT_P 64                 // points per tile
#define DT_MT (DT_P / 16)       // m-tiles of a tile

static_assert(TC_WARPS * 32 == NT, "a warp owns 32 of the tile's 256 output columns");

namespace {

// Float offsets (in the packed weights) of each layer's W [in][out] as bf16
// mma B operands in fragment order: the meta's extension that
// fused_train_dnerf.pack_dnerf writes in the bf16 mode, NL entries a net
// (-1: no fragments). The hidden layers of the deform, density and colour
// nets; at the density net's output layer its feature columns W[:, 1:]
// [in][F] (column 0, the raw density, stays SIMT); then the density net's
// W^T [out][in] of the same layers (the backward's walk), the output layer's
// as [F][in]; then the deform net's hidden W^T (its backward's walk); then the
// colour net's hidden W^T (its backward's walk and input cotangent).
struct DnFrags {
  long long deform[NL], density[NL], color[NL], density_t[NL], deform_t[NL], color_t[NL];
};

DnFrags decode_dn_frags(const long long* meta) {
  DnFrags f;
  const long long* x = meta + META_LEN;
  for (int l = 0; l < NL; ++l) {
    f.deform[l] = x[l];
    f.density[l] = x[NL + l];
    f.color[l] = x[2 * NL + l];
    f.density_t[l] = x[3 * NL + l];
    f.deform_t[l] = x[4 * NL + l];
    f.color_t[l] = x[5 * NL + l];
  }
  return f;
}

// Row pitch (bf16) of the operand rows: the widest padded layer input or
// output of the nets, the colour input [enc(d) | feat] and the feature
// included, + 8 (16 bytes x odd).
__host__ __device__ inline int dt_ldh(const Model& m) {
  int k = c16(m.cr + m.feat_dim);
  const Net* nets[3] = {&m.deform, &m.sdf, &m.color};
  for (int q = m.use_deform ? 0 : 1; q < 3; ++q)
    for (int l = 0; l < nets[q]->n_layers; ++l) {
      const int a = c16(nets[q]->in_dim[l]), b = c16(nets[q]->out_dim[l]);
      k = a > k ? a : k;
      k = b > k ? b : k;
    }
  return k + 8;
}

// The tiles: the forward's (the sweep, the render's field stage, the
// density forward), the density backward's (relu' bits, the cotangents on
// the raw column and on the encoding, a float32 operand split in three bf16
// terms) and the deform and colour backwards' (relu' bits; their walks'
// cotangents are bf16 values, one term).
enum DtKind { DT_FWD = 0, DT_DENSITY_BWD = 1, DT_DEFORM_BWD = 2, DT_COLOR_BWD = 3 };

// Shared memory of a tile after the weight ring: x_c [DT_P][4] (double), the
// points x (and t), x_c, d and the outputs (raw sigma, rgb) [DT_P][4]
// (float32); in the density backward the cotangent on raw sigma [DT_P] and on
// the density encoding [DT_P][es] (float32); in a backward the relu' bits
// [NL-1][DT_P][HMAX / 32]; the operand rows H [DT_P][ldh] (in the density
// backward the mid and lo terms of a split operand Hm, Hl beside it) and the
// encoding E [DT_P][emax] (bf16).
struct DtTile {
  double* xcd;
  float *x, *xc, *d, *out;
  float *gs, *den;
  uint32_t* gbit;
  bf16 *H, *Hm, *Hl, *E;
};

inline size_t dt_smem(const Model& m, int kind) {
  size_t b = TC_RING_BYTES + (size_t)DT_P * 4 * 8 + (size_t)4 * DT_P * 4 * 4;
  if (kind == DT_DENSITY_BWD) b += (size_t)DT_P * 4 + (size_t)DT_P * m.es * 4;
  if (kind != DT_FWD) b += (size_t)(NL - 1) * DT_P * (HMAX / 32) * 4;
  const int terms = kind == DT_DENSITY_BWD ? 3 : 1;
  return b + (size_t)terms * DT_P * dt_ldh(m) * 2 + (size_t)DT_P * dn_emax(m) * 2;
}

__device__ __forceinline__ DtTile dt_tile(unsigned char* smem, const Model& m, int kind) {
  DtTile s;
  s.xcd = (double*)(smem + TC_RING_BYTES);
  s.x = (float*)(s.xcd + DT_P * 4);
  s.xc = s.x + DT_P * 4;
  s.d = s.xc + DT_P * 4;
  s.out = s.d + DT_P * 4;
  float* f = s.out + DT_P * 4;
  s.gs = s.den = nullptr;
  s.gbit = nullptr;
  if (kind == DT_DENSITY_BWD) {
    s.gs = f;
    s.den = s.gs + DT_P;
    f = s.den + DT_P * m.es;
  }
  if (kind != DT_FWD) {
    s.gbit = (uint32_t*)f;
    f = (float*)(s.gbit + (NL - 1) * DT_P * (HMAX / 32));
  }
  const int ldh = dt_ldh(m);
  const bool three = kind == DT_DENSITY_BWD;
  s.H = (bf16*)f;                                  // 16-byte aligned: the sizes above are
  s.Hm = three ? s.H + DT_P * ldh : nullptr;
  s.Hl = three ? s.Hm + DT_P * ldh : nullptr;
  s.E = s.H + (three ? 3 : 1) * DT_P * ldh;
  return s;
}

// A double rounded to bf16 as the float64 plain version rounds its operands
// (PyTorch's conversion): to float32, then to bf16, each to nearest even.
__device__ __forceinline__ bf16 dt_bf16(double x) { return __float2bfloat16_rn((float)x); }

// The frequency encoding of the tile's rows src [DT_P][4] into E [DT_P][ew]
// (bf16), dnerf_chain.cuh's dn_encode (RX: the coordinates rounded to bf16
// first) or the D-NeRF sweep's (unrounded), the scaled coordinate and its
// sine and cosine in double: columns 0 .. enc(3, f3) encode src[0..2], the
// rest (ew wider) src[3] (the time).
template <bool RX, class T>
__device__ __forceinline__ void dt_encode(const T* src, int f3, bf16* E, int ew, int tid) {
  const int ex = enc_width(3, f3);
  for (int idx = tid; idx < DT_P * ew; idx += NT) {
    const int p = idx / ew, c = idx - p * ew;
    int dim, kind; float sc;
    if (c < ex) enc_col(c, 3, dim, kind, sc);
    else { enc_col(c - ex, 1, dim, kind, sc); dim = 3; }
    const double x = RX ? (double)bf16r((float)src[p * 4 + dim]) : (double)src[p * 4 + dim];
    const double v = x * sc;
    E[idx] = dt_bf16(kind == 0 ? v : (kind == 1 ? sin(v) : cos(v)));
  }
}

// Hidden layers 0 .. L-2 of the nerf net N on the tile, relu, as tile
// products on the fragments frag[l]. H holds layer 0's operand rows on entry;
// a skip layer's operand is [h | E (ew)]. Leaves op(h_{L-2}) in H. With SAVE
// each layer's operand rows go to xin[l] and the relu' of each hidden output
// to gbit [NL-1][DT_P][HMAX / 32] (1: op(relu) > 0). With HALVES (not with
// SAVE) a layer at most half as wide as the warps' columns (the colour net's
// 128) is split by rows as well: warp w owns the columns of warp w % 4 for
// the tile's rows 32 (w / 4) .. + 31, so no warp idles; each output keeps
// its products and k order, so its bits do not change.
template <bool SAVE, bool HALVES = false>
__device__ void dt_hidden(const Net& N, const float* __restrict__ wts, const long long* frag,
                          bf16* H, int ldh, const bf16* E, int ew, uint4* ring, long long base,
                          long long n, bf16* const* xin, uint32_t* gbit) {
  constexpr int MT = DT_MT, WB = HMAX / 32, HW = TC_WARPS / 2;
  static_assert(!(SAVE && HALVES), "the relu' bits follow the whole-tile column layout");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bf16* const A1[1] = {H};
  const int np_me = warp * TC_NPW;               // the warp's columns: 32 warp ..
  float acc[MT][2 * TC_NPW][4];
  for (int l = 0; l < N.n_layers - 1; ++l) {
    const int in_l = N.in_dim[l], out_l = N.out_dim[l];
    if (l > 0 && ((N.skip_mask >> l) & 1)) {
      put_enc(H, ldh, in_l - ew, E, ew, DT_P, tid);
      __syncthreads();
    }
    if (SAVE) save_rows<1, DT_P>(xin[l], H, ldh, c16(in_l), base, n, tid);
    const int np_out = c16(out_l) / 16, npw = clampw(np_out - np_me);
    if (HALVES && np_out <= HW * TC_NPW) {
      const int np_h = (warp % HW) * TC_NPW, npw_h = clampw(np_out - np_h);
      const int r0 = (warp / HW) * (DT_P / 2);
      const bf16* const Ah[1] = {H + r0 * ldh};
      float acc_h[MT / 2][2 * TC_NPW][4];
      zero_acc(acc_h);
      tile_mma<MT / 2, 1>(acc_h, Ah, ldh, (const uint4*)(wts + frag[l]), np_out, np_h, npw_h, 0,
                          c16(in_l) / 16, ring, lane);
      __syncthreads();
      const float* b = wts + N.b_off[l];
      for_pairs(acc_h, np_h, npw_h, lane, [&](int row, int c, float a0, float a1) {
        const float a[2] = {a0, a1};
        for (int e = 0; e < 2; ++e)              // the padding to c16(out_l) stays zero
          H[(r0 + row) * ldh + c + e] =
              c + e < out_l ? __float2bfloat16_rn(fmaxf(a[e] + b[c + e], 0.f)) : bzero();
      });
      __syncthreads();
      continue;
    }
    zero_acc(acc);
    tile_mma<MT, 1>(acc, A1, ldh, (const uint4*)(wts + frag[l]), np_out, np_me, npw, 0,
                    c16(in_l) / 16, ring, lane);
    __syncthreads();
    const float* b = wts + N.b_off[l];
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
          bf16 hv = bzero();                     // the padding to c16(out_l) stays zero
          if (c < out_l) {
            hv = __float2bfloat16_rn(fmaxf(acc[mt][nt][e] + b[c], 0.f));
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
          gbit[(l * DT_P + mt * 16 + g) * WB + warp] = bits[mt][0];
          gbit[(l * DT_P + mt * 16 + g + 8) * WB + warp] = bits[mt][1];
        }
      }
    }
    __syncthreads();
  }
}

// Output column col of net N's last layer for tile row p from the bf16 rows
// H, plus its bias, in double (dnerf_chain.cuh's dn_out_col and the sweep's
// heads, exactly).
__device__ __forceinline__ double dt_out_col(const Net& N, const float* __restrict__ wts,
                                             const bf16* H, int ldh, int p, int col) {
  const int l = N.n_layers - 1, n_out = N.out_dim[l];
  const float* W = wts + N.w_off[l] + col;
  double a = 0.0;
  for (int k = 0; k < N.in_dim[l]; ++k)
    a = fma((double)__bfloat162float(H[p * ldh + k]), (double)__ldg(W + (size_t)k * n_out), a);
  return a + (double)wts[N.b_off[l] + col];
}

// The deform net on the tile's rows s.x: x_c = x + the output layer, in
// double to s.xcd and rounded once to s.xc. RX: the field's encoding
// (coordinates rounded), else the sweep's (unrounded). SAVE (the deform
// backward's recompute): the hidden layers only, each layer's operand rows of
// tile rows base .. (< n) to xin[l], the relu' bits to gbit; op(h_{L-2}) is
// left in s.H.
template <bool RX, bool SAVE = false>
__device__ __forceinline__ void dt_deform(const float* __restrict__ wts, const Model& m,
                                          const DnFrags& fr, const DtTile& s, int ldh,
                                          uint4* ring, long long base = 0, long long n = 0,
                                          bf16* const* xin = nullptr) {
  const int tid = threadIdx.x;
  const Net& N = m.deform;
  if (m.use_deform) {
    dt_encode<RX>(s.x, m.f_dpos, s.E, m.ed, tid);
    __syncthreads();
    put_enc(s.H, ldh, 0, s.E, m.ed, DT_P, tid);
    __syncthreads();
    dt_hidden<SAVE>(N, wts, fr.deform, s.H, ldh, s.E, m.ed, ring, base, n, xin, s.gbit);
  }
  if (SAVE) return;
  for (int idx = tid; idx < 3 * DT_P; idx += NT) {
    const int p = idx / 3, col = idx - p * 3;
    const double xc = (double)s.x[p * 4 + col]
                      + (m.use_deform ? dt_out_col(N, wts, s.H, ldh, p, col) : 0.0);
    s.xcd[p * 4 + col] = xc;
    s.xc[p * 4 + col] = (float)xc;
  }
  __syncthreads();
}

// The density net's hidden layers on x_c (encoded with RX: s.xc rounded,
// else s.xcd) and its raw density column: raw sigma to s.out[p * 4]; leaves
// op(h_{L-2}) in s.H. SAVE (the density backward's recompute): the hidden
// layers only, saved as dt_deform's.
template <bool RX, bool SAVE = false>
__device__ __forceinline__ void dt_density(const float* __restrict__ wts, const Model& m,
                                           const DnFrags& fr, const DtTile& s, int ldh,
                                           uint4* ring, long long base = 0, long long n = 0,
                                           bf16* const* xin = nullptr) {
  const int tid = threadIdx.x;
  const Net& S = m.sdf;
  if (RX) dt_encode<true>(s.xc, m.f_spos, s.E, m.es, tid);
  else dt_encode<false>(s.xcd, m.f_spos, s.E, m.es, tid);
  __syncthreads();
  put_enc(s.H, ldh, 0, s.E, m.es, DT_P, tid);
  __syncthreads();
  dt_hidden<SAVE>(S, wts, fr.density, s.H, ldh, s.E, m.es, ring, base, n, xin, s.gbit);
  if (SAVE) return;
  if (tid < DT_P) s.out[tid * 4] = (float)dt_out_col(S, wts, s.H, ldh, tid, 0);
}

// The raw density of DT_P points of src a block, the D-NeRF sweep's
// arithmetic (coordinates unrounded); points past src.n load zeros and
// store nothing.
template <class Src>
__global__ void __launch_bounds__(NT, 2)
dn_sweep_tc_kernel(const float* __restrict__ wts, const __grid_constant__ Model m,
                   const __grid_constant__ DnFrags fr, const __grid_constant__ Src src) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int ldh = dt_ldh(m);
  uint4* ring = (uint4*)tc_smem + warp * (TC_STAGES * TC_NPW * 32);
  const DtTile s = dt_tile(tc_smem, m, DT_FWD);
  const long long base = (long long)blockIdx.x * DT_P;
  for (int idx = tid; idx < DT_P * ldh; idx += NT) s.H[idx] = bzero();
  if (tid < DT_P) {
    float x0 = 0.f, x1 = 0.f, x2 = 0.f, tt = 0.f;
    if (base + tid < src.n) src.load(base + tid, x0, x1, x2, tt);
    s.x[tid * 4 + 0] = x0; s.x[tid * 4 + 1] = x1; s.x[tid * 4 + 2] = x2; s.x[tid * 4 + 3] = tt;
  }
  __syncthreads();
  dt_deform<false>(wts, m, fr, s, ldh, ring);
  dt_density<false>(wts, m, fr, s, ldh, ring);
  if (tid < DT_P && base + tid < src.n) src.store(base + tid, s.out[tid * 4]);
}

template <class Src>
cudaError_t launch_dn_sweep_tc(const float* w, const Model& m, const DnFrags& fr, const Src& src,
                               cudaStream_t st) {
  if (src.n <= 0) return cudaSuccess;
  const size_t smem = dt_smem(m, DT_FWD);
  cudaError_t e = set_smem(dn_sweep_tc_kernel<Src>, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (src.n + DT_P - 1) / DT_P;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dn_sweep_tc_kernel<Src><<<(unsigned)blocks, NT, smem, st>>>(w, m, fr, src);
  return cudaGetLastError();
}

}  // namespace
