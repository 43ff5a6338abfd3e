// EndoSurf observed-space SDF query and EndoNeRF raw density query for
// NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel endosurf_tpu/kernels/fused_sdf.py
// (fused_sdf_observed, body _kernel via _head_query): for every point
// (x [N, 3], t [N, 1]) the forward chain freq-encode(x, t) -> deform MLP ->
// x_c = x + dx -> freq-encode(x_c) -> SDF MLP -> sdf [N] (column 0 of the SDF
// output layer), without gradient. It serves the dense mesh grid of the 3D
// demo (two 64x128x128 slabs a frame at 128^3) and every other forward-only
// SDF query of the sampling paths.
//
// The kernel is sdf_chain.cuh's sweep over a PointList source, the same
// per-point code the upsampling and the ray march run over ray samples: a
// block of 256 threads owns 32 points, thread j computes neuron j for all of
// them from activations in shared memory, the weights stream from L2. Any N:
// the last block masks its tail (the TPU kernel padded to 1024). The TPU
// kernel's selector-matmul encoding is not carried over: each encoded column
// is one sin / cos / copy written to shared memory.
//
// What bounds it: the deform and SDF 9x256 MLPs, about 1.88 MFLOP a point
// (1.97 TFLOP a 1,048,576-point slab, 3.94 for a 128^3 grid); the inputs are
// 16 bytes a point.
//
// With rb (bf16 dots) and tc the query runs on tensor cores: sweep_tc.cuh's
// sweep_tc_kernel, the bf16 upsampling's, over the same point list (32
// points a block, each hidden layer a split mma.sync tile product with
// TwoSum-promoted k-tiles, the epilogue redone in double near a bf16 tie,
// the encodings of the unrounded coordinates, the deform output layer, x_c
// and the head in double). meta then carries fused_sampler.pack_sampling's
// fragment extension. rb without tc runs the SIMT sweep (a comparison only);
// float32 always does.
//
// fused_density_raw_launch replaces the Pallas TPU kernel
// endosurf_tpu/kernels/fused_sdf.py (fused_density_raw, the same body with the
// D-NeRF chain of chain_from_spec): freq-encode(x, t) -> deform MLP (relu,
// skips unscaled) -> x_c -> freq-encode(x_c) -> density MLP (relu, skips
// unscaled) -> raw density [N] (column 0 of the 1 + feat_dim output layer,
// before the relu), without gradient. It serves the 3D demo's grid of the
// EndoNeRF vertical (two 1,048,576-point slabs a 128^3 frame). Same sweep
// (DNeRFChain), same bound: about 1.99 MFLOP a point with the 9x256 nets.
//
// Precision: with rb every dot operand is rounded to bf16 and the weights
// arrive rounded (pack_operands); products accumulate in float32. Without it
// every dot is float32. Coordinates are not rounded (the CPU-interpreted JAX
// kernel's semantics, ROADMAP section C).
//
// With rb the raw density query runs on tensor cores: dnerf_tc.cuh's coarse
// sweep kernel (dn_sweep_tc_kernel, the EndoNeRF render's) over the same
// point list, 64 points a block, the hidden layers as mma.sync tile products
// (bf16 operands, each k-tile's sum promoted into float32), the encodings of
// the unrounded coordinates, x_c and the raw column in double. 0.262 TFLOP
// at the train step's 131,072 coarse points. rb without tc runs the SIMT
// sweep (a comparison only); float32 always does.

#include "sdf_chain.cuh"
#include "dnerf_tc.cuh"
#include "sweep_tc.cuh"

extern "C" {

// x [n, 3], t [n, 1] float32 contiguous; out [n]; w / meta packed by
// kernels/fused_sampler.pack_sampling (with rb and tc its bf16 fragment
// extension follows the Model meta). Returns a cudaError_t (0 on success).
int fused_sdf_observed_launch(const float* x, const float* t, long long n, const float* w,
                              const long long* meta, int rb, int tc, float* out, void* stream) {
  if (n <= 0) return 0;
  const Model m = decode_model(meta);
  PointList src{x, t, out, n};
  if (rb && tc)
    return (int)launch_sweep_tc(w, m, decode_sweep_frags(meta), src, (cudaStream_t)stream);
  return (int)launch_sweep(w, m, rb != 0, src, (cudaStream_t)stream);
}

// The D-NeRF chain over the same point list; w / meta packed by
// kernels/fused_train_dnerf.pack_dnerf. With rb and tc the tensor-core sweep
// (meta then carries the bf16 pack's fragment extension).
int fused_density_raw_launch(const float* x, const float* t, long long n, const float* w,
                             const long long* meta, int rb, int tc, float* out, void* stream) {
  if (n <= 0) return 0;
  const Model m = decode_model(meta);
  PointList src{x, t, out, n};
  if (rb && tc)
    return (int)launch_dn_sweep_tc(w, m, decode_dn_frags(meta), src, (cudaStream_t)stream);
  return (int)launch_sweep<DNeRFChain>(w, m, rb != 0, src, (cudaStream_t)stream);
}

}  // extern "C"
