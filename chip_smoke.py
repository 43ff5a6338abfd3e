#!/usr/bin/env python
"""GPU smoke test of the PyTorch/CUDA port (endosurf_tpu_torch) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --train-only   # phases 1, 2 and 7's timed run, split and trace
    python3 chip_smoke.py --segments-only   # phases 1, 2, 9's bf16 seed-0 parity, 11, and
                                            # the upsample's float64 readings and timing
    python3 chip_smoke.py --dnerf-train-only   # phases 1, 2 and 26's timed EndoNeRF run,
                                               # split and trace
    python3 chip_smoke.py --dnerf-segments-only   # phases 1, 2, 23's bf16 seed-0 parity
                                                  # and 27's segment and coarse timing
    python3 chip_smoke.py --march-only   # phases 1, 2, 14 and 16
    python3 chip_smoke.py --march-train-only   # phases 1, 2 and 15 (run, split, trace)

Phases (any failure raises and exits non-zero):
  1. a CUDA card must be present; prints its name and power limit;
  2. builds the CUDA kernels from the sources in this checkout (one nvcc per
     source, in parallel) and the host geometry library (g++);
  3. render parity: the CUDA fused_render_rays against its plain PyTorch twin
     on 8192 rays of a synthetic 512x640 frame, full-width seeded model
     (three 9x256 MLPs, 32+32 samples, 4 rounds), float32 and bf16 dot modes
     (bf16: both passes on tensor cores), at fused_render.PARITY_TOL, with
     the wrong-precision controls failing; then, on two weight seeds, the
     distance of the tensor-core and of the SIMT bf16 render from the float64
     yardstick (fused_render.fused_render_rays_float64), side by side;
  4. serving end to end: eval_frames with an EndoSurfRenderer on a synthetic
     512x640 scene with the base.yml settings (bf16 dots, 2048-ray chunks);
     checks that the render kernel served every chunk on one pack and that
     maps and metrics are finite; prints the frame's time and peak memory;
  5. render timing: kernel vs plain twin on one chunk in each mode (CUDA
     events), the bf16 chunk's device time by family (sweep / deform / sdf /
     coupling / colour / composite; torch.profiler), its TFLOP/s and bound,
     and the host time of a chunk's call with its pack cached and of packing
     (fused_render.pack_render);
  6. upsample parity: the CUDA fused_upsample_z against its plain twin on
     8192 rays from sample_train_batch on the synthetic scene with perturbed
     z0, return_sdf, both dot modes, two weight seeds, at
     fused_sampler.PARITY_TOL and, on the kernel's own samples, at
     fused_sampler.CONSISTENCY_TOL, with the wrong-precision controls
     failing; prints every reading the limits were set from, and the bf16
     kernel's and the float32 plain twin's distance from the float64
     yardstick (fused_sampler.fused_upsample_z_float64: the same bf16
     operand roundings, float64 arithmetic);
  7. training end to end: EndoSurfTrainer on the in-memory base.yml config
     and scene (1024 rays, all six losses, march reuse, bf16 dots), 12 steps
     through Trainer.start (2 warm-up steps, then 10), checkpoints in a
     temporary directory read back; checks one upsample launch per step,
     finite losses (logged at steps 1 and 12), the checkpoint round trip;
     reports train rays/s and peak memory; then splits a step into forward /
     backward / Adam (CUDA events) and traces the device's busy and idle
     time (torch.profiler);
  8. upsample timing: kernel vs plain twin on one train batch, both modes:
     the call's time (CUDA events, as every kernel's; in bf16 the sweeps
     run on tensor cores, csrc/sweep_tc.cuh) and beside it the call's
     device time (torch.profiler), all its kernels and the upsample's own;
  9. field segment parity: the six CUDA segment kernels (deform / sdf /
     color, forward and backward, csrc/fused_train.cu) against their plain
     versions on the 65,536 midpoints of a real train batch
     (sample_train_batch, then fused_upsample_z), both dot modes, two weight
     seeds (the second on the first 16,384 points): per-point median, p99
     and max of every output and input cotangent, relative L2 of every
     parameter gradient and, apart, of the output layers' bias gradients,
     with seeded random cotangents, at
     fused_train_cuda.PARITY_TOL, the wrong-precision controls failing;
 10. the whole train step with the segment kernels against one with the
     plain field path (fields.plain_point_eval put in place of
     fused_train.megakernel_point_eval), same params and draws, both modes:
     metrics and per-network gradients, with the kernels at the other dot
     precision as the control that must fail;
 11. segment timing: each kernel vs its plain version at 65,536 points in
     bf16, beside its bound from the parameter shapes, with its TFLOP/s (in
     bf16 all six run on tensor cores, csrc/field_tc.cuh);
 12. grid-query parity: the CUDA fused_sdf_observed against its plain
     version (fields.sdf_observed) on one 64x128x128 slab (1,048,576 points)
     of the synthetic scene's frame-0 grid (its bbox x 1.2) and on 8192
     random points with use_deform false, both dot modes (bf16: the
     tensor-core sweep, csrc/sweep_tc.cuh), two weight seeds, median / p99 /
     max at fused_sdf.PARITY_TOL, the wrong-precision controls failing; the
     bf16 query against its float64 yardstick
     (fused_sdf.fused_sdf_observed_float64) at fused_sdf.FLOAT64_TOL, and the
     tensor-core and SIMT bf16 sweeps' distances from it side by side;
 13. the 3D demo end to end: EndoSurfRenderer.demo(demo_2d=False,
     demo_3d=True, visualize=False) on the in-memory base.yml config and
     scene, one test frame at 128^3: checks that the grid ran on the kernel
     (two launches on one pack), the vertex colours on the segment forward
     kernels, a
     non-empty mesh, the four PLYs and a finite geo_err_mean; prints the
     frame's grid / mesh / colour / metrics split;
 14. march parity: the CUDA fused_ray_march against its plain twin
     (models.endosurf.march_math) on a 1024-ray train batch, both dot modes
     (bf16: every sweep on tensor cores, csrc/sweep_tc.cuh), two weight
     seeds, at fused_sampler.MARCH_TOL (flipped crossings, depth median /
     p99, and on its own output the bracket signs and the residual
     |sdf(depth) - tau|), the wrong-precision controls failing; then, on
     each seed, the tensor-core and the SIMT bf16 march against the float64
     yardstick (fused_sampler.march_float64_distance: flips, depth, residual
     against the float64 SDF) side by side, the tensor-core one within
     fused_sampler.MARCH_FLOAT64_TOL;
 15. the march train path: EndoSurfTrainer with surf_march_reuse: false,
     4 steps through Trainer.start at full width: one march launch per
     step, finite losses, rays/s; the step's forward / backward / Adam
     split and its busy / idle trace; one sampling pack a step, shared by
     the upsampling and the march (fused_sampler.PACKS);
 16. timing of the two kernels against their plain versions at the main
     paths' shapes (1,048,576 points; 1024 rays), bf16, with their bounds
     and TFLOP/s (the grid query also against its SIMT bf16 sweep); the
     march on tensor cores and with simt=True, its scan and secant phase
     apart (the march with no secant step; the difference), and its device
     time by kernel.
 17-22. the EndoNeRF vertical, on configs/endonerf/base.yml's keys in memory
     (three 9x256 / 9x256 / 2x128 nets, 64 + 64 samples, bf16 dots, seeded
     weights) and the synthetic 512x640 scene, with visualize / save_images
     off and demo.depth_filter unset (the card machine has no OpenCV):
 17. raw-density parity: the CUDA fused_density_raw against its plain
     version on phase 12's grid slab and 8192 random points with use_deform
     false, both dot modes (bf16: the sweep on tensor cores,
     csrc/dnerf_tc.cuh), two weight seeds, median / p99 / max at
     fused_sdf.DENSITY_PARITY_TOL, the wrong-precision controls failing;
     then the distance of the tensor-core and of the SIMT bf16 sweep from
     the float64 yardstick (fused_sdf.fused_density_raw_float64), side by
     side;
 18. render parity: the CUDA fused_render_rays_dnerf against its plain twin
     on 8192 depth-guided rays of a frame (slots 6/7 from the renderer's
     eval_ray_transform) and 2048 uniform-z rays, the same draws, both modes
     (bf16: both passes on tensor cores, csrc/dnerf_tc.cuh), two seeds of
     the seeded nets and one of the opaque nets
     (fused_render_dnerf.with_density_bias), per-map median, p99 and max
     (depth as depth x acc) at fused_render_dnerf.PARITY_TOL beside the
     maps' median size, the controls failing; then the distance of the
     tensor-core and of the SIMT bf16 render from the float64 yardstick
     (fused_render_dnerf.fused_render_rays_dnerf_float64), side by side;
 19. segment parity: the three forward D-NeRF segment kernels against
     their plain versions on the 65,536 fine samples of 512 rays (the
     render's resampled depths), both modes, two seeds, per output median /
     p99 / max at fused_train_dnerf.PARITY_TOL, the controls failing (bf16:
     all three on tensor cores); then, on each seed, the distance of the
     tensor-core and of the SIMT bf16 forwards from their float64
     yardsticks (fused_train_dnerf.dnerf_deform_fwd_float64,
     dnerf_density_fwd_float64, dnerf_color_fwd_float64), side by side;
 20. EndoNeRF serving end to end: eval_frames with an EndoNeRFRenderer on one
     512x640 frame in 2048-ray chunks: 160 render launches on one pack,
     finite maps and metrics, normals from depth; rays/s, the frame time and
     its peak memory;
 21. one EndoNeRF 3D frame: EndoNeRFRenderer.demo(demo_2d=False,
     demo_3d=True, visualize=False) at 128^3, the iso-threshold the median
     raw density of a 32^3 probe of the frame's grid box (the seeded nets
     have no surface at base.yml's 5): 2 raw-density launches, the vertex
     colours on the three forward segment kernels, a non-empty mesh, the
     four PLYs and a finite geo_err_mean; the grid / mesh / colour / metrics
     split;
 22. timing of the five EndoNeRF kernels against their plain versions at
     the paths' shapes (2048 rays; 1,048,576 points; 65,536 points), bf16,
     beside their bounds with TFLOP/s and GB/s (the render, the raw density
     query and the three forwards also against their SIMT bf16 kernels),
     and a render chunk's device time by kernel family.
 23-28. EndoNeRF training, on the same config with base.yml's train keys
     (2048 rays, depth-guided sampling with sigma 1.0, perturb, raw noise
     1.0, bf16 dots, Adam at the exponential rate):
 23. backward segment parity: the three D-NeRF backward kernels against
     their plain versions (autograd through the segment maths) on the
     262,144 fine points of a real train batch (sample_train_batch, slots
     6/7, init_z with drawn eps, fused_density_raw, noise, relu,
     fused_fine_resample), seeded random cotangents, both dot modes, two
     weight seeds (the second on the first 65,536 points): median / p99 /
     max of d x_c and d feat, relative L2 of every weight gradient, at
     fused_train_dnerf.BWD_PARITY_TOL, the wrong-precision controls failing
     (bf16: the three backwards on tensor cores); then, on each seed, the
     distance of the tensor-core and of the SIMT bf16 backwards and the
     three forwards from their float64 yardsticks
     (fused_train_dnerf.dnerf_deform_bwd_float64,
     dnerf_density_bwd_float64, dnerf_color_bwd_float64,
     dnerf_deform_fwd_float64, dnerf_density_fwd_float64,
     dnerf_color_fwd_float64), side by side; and
     the raw density query on
     the batch's 131,072 coarse points (the train step's coarse pass)
     against its plain version at fused_sdf.DENSITY_PARITY_TOL (the kernel
     in float32 failing) and, side by side with the SIMT sweep, against its
     float64 yardstick;
 24. resample parity: fused_fine_resample against fine_resample_math on
     2048 train rays, the seeded nets (two seeds) and the opaque ones
     (fused_render_dnerf.with_density_bias): per-ray depth median / p99 /
     max at fused_sampler.RESAMPLE_PARITY_TOL; the control, the plain
     resample with its draws half a step early, fails;
 25. the whole train step with the kernels against one with the plain
     segments and resample patched in (fused_train_dnerf.plain_field_raw,
     fused_fine_resample_reference), same params and draws, both modes:
     metrics and per-network gradients; the kernels at the other precision
     fail;
 26. training end to end: EndoNeRFTrainer.start for 12 steps (2 warm-up,
     then 10): one launch a step of fused_density_raw, fused_fine_resample
     and each D-NeRF forward and backward segment kernel, finite losses at
     steps 1 and 12, the checkpoint read back; train rays/s, peak memory, a
     forward / backward / Adam split and a busy / idle trace (where it
     records device kernels: the bf16 colour forward on tensor cores); then
     trainer.eval on the test frame (the render kernel);
 27. timing of the three backward kernels, the three forward ones, the
     coarse pass's raw density query and the resample against their plain
     versions at the train shape (262,144 points; 131,072 coarse points;
     2048 rays), bf16, beside their bounds (the three backwards, the three
     forwards and the raw density query also against their SIMT bf16
     kernels, with TFLOP/s; the forwards with GB/s);
 28. bf16 render quality: the port trains its own checkpoint for 300 steps
     on a smooth 64x80 synthetic scene, then renders the test frame in bf16
     and in float32: PSNR and depth RMSE of each against the scene;
 29. the device kernels each tensor-core kernel's call launches
     (fused_train_dnerf.TC_KERNELS: the D-NeRF kernels, the raw density and
     grid queries; and the march) in bf16 and with simt=True, by
     torch.profiler in a fresh process a kernel: the bf16 calls launch
     tensor-core kernels (sweep_tc_kernel<PointList>,
     dnerf_color_bwd_tc_kernel and wgrad_tc_partial_kernel, ...; the march
     sweep_tc_kernel<RaySamples> 9 times, no SIMT sweep), the simt=True
     calls none; the D-NeRF field of a train step (forward and backward) in
     bf16 launches dnerf_color_fwd_tc_kernel and no SIMT segment kernel.
Phase 7 also checks one launch of each segment kernel per step, and its
trace counts the segment kernels (the weight-gradient product included) as
their own family. The third-to-last line is the card, the second-to-last
the kernel record (JSON), the last the device record (JSON).

``--train-only`` uses only what every slice with a train step has, so a
copy of this file placed beside an older checkout's package measures that
checkout's step with the same trace filter (``--dnerf-train-only`` likewise
the EndoNeRF step); ``--dnerf-segments-only`` runs the D-NeRF segment
kernels as phase 27 times them, on phase 23's bf16 seed-0 train points after
their parity, the SIMT kernels and the float64 readings beside them (it
needs a checkout with every backward on tensor cores); ``--segments-only``
holds the six segment kernels against their plain versions on phase 9's
bf16 seed-0 midpoints and times them as phase 11 does (with TFLOP/s), then
reads phase 6's float64 distances of the bf16 upsample on both weight seeds
and times the upsample as phase 8 does. ``--march-train-only`` likewise
measures an older checkout's sphere-trace step beside this one's.
"""

from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

N_PARITY = 8192
H, W = 512, 640
CHUNK = 2048
RAY_BATCH = 1024
N_STEPS, N_WARM = 12, 2
N_SPLIT = 3                                    # steps of the time split and trace
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
UPSAMPLE_KERNELS = ("sweep_kernel", "sweep_tc_kernel", "draw_kernel", "merge_kernel",
                    "upsample_prep_kernel")
SEGMENT_KERNELS = ("deform_fwd_kernel", "sdf_fwd_kernel", "color_fwd_kernel", "deform_bwd_kernel",
                   "sdf_bwd_kernel", "color_bwd_kernel", "wgrad_partial_kernel",
                   "wgrad_reduce_kernel", "deform_fwd_tc_kernel", "sdf_fwd_tc_kernel",
                   "deform_bwd_tc_kernel", "sdf_bwd_tc_kernel", "color_bwd_tc_kernel",
                   "wgrad_tc_partial_kernel", "color_fwd_tc_kernel")
# a render chunk's kernels by family (phase 5); field_kernel is the SIMT
# field evaluation (float32, and bf16 with simt=True)
RENDER_FAMILIES = {"sweep": ("sweep_kernel", "sweep_tc_kernel", "draw_kernel", "merge_kernel",
                             "prep_kernel"),
                   "deform": ("deform_fwd_tc_kernel",), "sdf": ("sdf_fwd_tc_kernel",),
                   "coupling": ("midpoint_kernel", "coupling_kernel"),
                   "colour": ("color_fwd_tc_kernel",), "field (SIMT)": ("field_kernel",),
                   "composite": ("composite_kernel",)}
N_PARITY_SEED1 = 16384                         # points of the second weight seed's parity
# train step with the segment kernels vs the plain field path (phase 10):
# (metric relative difference, per-network gradient relative L2) per dot
# mode. Both sides run the same upsample kernel on the same draws, so only
# the field evaluation differs. Set from H100 readings (PERF.md, PR 3): sound
# 2.3e-7 / 1.5e-5 (f32) and 3.3e-5 / 3.7e-4 (bf16); the control, the kernels
# at the other precision, must fail.
WHOLE_STEP_TOL = {"highest": (1e-6, 1e-4), "default": (3e-4, 3e-3)}
GRID_RES, GRID_SLAB = 128, 64                  # the demo grid and one slab of it
N_STATIC = 8192                                # random points of the use_deform-false check
MARCH_STEPS, MARCH_WARM = 4, 1                 # phase 15's train steps
# the march's own kernels (its sweeps are the upsampling's sweep kernels)
MARCH_KERNELS = ("march_prep_kernel", "march_crossing_kernel", "march_secant_kernel",
                 "march_finish_kernel")
GEMM_KERNELS = ("gemm", "xmma", "cutlass", "cublas", "sm90_", "sm80_")
N_DN_UNIFORM = 2048                            # uniform-z rays of phase 18
N_DN_SEG_RAYS = 512                            # rays whose 128 fine samples phase 19 takes
DN_PROBE = 32                                  # probe grid of phase 21's threshold
DN_RAY_BATCH = 2048                            # EndoNeRF train rays a step (base.yml)
N_DN_BWD_SEED1 = 65536                         # points of phase 23's second weight seed
DN_QUALITY = (64, 80, 300)                     # phase 28: scene height, width, train steps
# EndoNeRF train step with the kernels vs the plain segments and resample
# (phase 25): (metric relative difference, {network: gradient relative
# L2}) per dot mode. Set from H100 readings (PERF.md, PR 6): sound metrics
# <= 1.8e-6 (f32) / 1.3e-5 (bf16), gradients deform <= 1.9e-2 (it carries
# the density's spatial derivative), density <= 8.0e-4, colour <= 3.3e-4;
# the kernels at the other precision read metrics up to >= 4.9e-4 and
# gradients deform >= 0.81, density >= 5.0e-2, colour >= 6.4e-3.
DN_STEP_GRAD_TOL = {"deform": 5e-2, "density": 5e-3, "color": 2e-3}
DN_WHOLE_STEP_TOL = {"highest": (1e-5, DN_STEP_GRAD_TOL),
                     "default": (5e-5, DN_STEP_GRAD_TOL)}


def base_cfg() -> dict:
    """configs/endosurf/base.yml's keys for serving and training, in memory."""
    net = {
        "bound": 1.0, "use_deform": True,
        "deform_network": {"enc_pos_cfg": {"multires": 6}, "enc_time_cfg": {"multires": 6},
                           "n_layers": 9, "hidden_dim": 256, "skips": [4], "out_dim": 3},
        "sdf_network": {"enc_pos_cfg": {"multires": 6}, "n_layers": 9, "hidden_dim": 256,
                        "skips": [4], "out_dim": 257, "geometric_init": True,
                        "geometric_init_bias": 0.8},
        "color_network": {"enc_pos_cfg": {"multires": 10}, "enc_dir_cfg": {"multires": 4},
                          "n_layers": 9, "hidden_dim": 256, "skips": [4], "feat_dim": 256,
                          "out_dim": 3},
        "deviation_network": {"init_val": 0.3},
    }
    return {
        "exp": {"project_name": "endosurf", "exp_name": "chip_smoke",
                "exp_dir": "logs", "seed": 0},
        "render": {"type": "endosurf", "anneal_end": 50000, "n_samples": 32,
                   "n_importance": 32, "important_begin_iter": 0, "up_sample_steps": 4,
                   "perturb": True},
        "train": {"n_iter": N_STEPS, "matmul_precision": "default",
                  "sampling_precision": "default", "ray_batch": RAY_BATCH,
                  "mask_guided_ray_sampling": True,
                  "color_loss_weight": 1.0, "depth_loss_weight": 1.0, "sdf_loss_weight": 1.0,
                  "angle_loss_weight": 0.1, "eikonal_loss_weight": 0.1,
                  "surf_neig_loss_weight": 0.1, "surf_neig_rad": 0.1, "resume": False,
                  "optim": {"lr": 0.0005, "lr_alpha": 0.05, "warm_up_end": 5000},
                  "eval": {"ray_chunk": CHUNK}},
        "net": net,
        "log": {"i_eval": 0, "i_save": N_STEPS},
        "demo": {"ray_batch": 1024, "marching_cubes_resolution": GRID_RES,
                 "marching_cubes_thresh": 0},
    }


def endonerf_cfg() -> dict:
    """configs/endonerf/base.yml's keys for serving, in memory (no
    depth_filter: it needs OpenCV)."""
    enc = {"enc_type": "frequency"}
    return {
        "exp": {"project_name": "endonerf", "exp_name": "chip_smoke", "exp_dir": "logs",
                "seed": 0},
        "render": {"type": "endonerf", "n_samples": 64, "n_importance": 64, "perturb": True,
                   "use_depth_sampling": True, "depth_sampling_sigma": 1.0},
        "train": {"matmul_precision": "default", "sampling_precision": "default",
                  "eval": {"ray_batch": CHUNK}},
        "net": {"net_type": "dnerf", "use_deform": True, "raw_noise_std": 1.0,
                "enc_pos_density_cfg": {**enc, "input_dim": 3, "multires": 10},
                "enc_dir_color_cfg": {**enc, "input_dim": 3, "multires": 4},
                "enc_time_deform_cfg": {**enc, "input_dim": 1, "multires": 10},
                "enc_pos_deform_cfg": {**enc, "input_dim": 3, "multires": 10},
                "net_deform_cfg": {"n_layers": 9, "hidden_dim": 256, "skips": [5]},
                "net_density_cfg": {"n_layers": 9, "hidden_dim": 256, "skips": [5]},
                "net_color_cfg": {"n_layers": 2, "hidden_dim": 128, "skips": []},
                "geo_feat_dim": 256},
        "demo": {"ray_batch": CHUNK, "marching_cubes_resolution": GRID_RES,
                 "marching_cubes_thresh": 5, "marching_cubes_filter": 100},
    }


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call (CUDA events, after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_events(prof, reps: int):
    """(kernel name, launches, device ms a rep) of each device event of a
    torch.profiler trace over ``reps`` repetitions. Device events only: a
    host op's "self" device time repeats the kernels it launched outside an
    aten op (the ctypes launches)."""
    from torch.autograd import DeviceType
    for evt in prof.key_averages():
        dev_us = (getattr(evt, "self_device_time_total", None)
                  or getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0 and evt.device_type == DeviceType.CUDA:
            yield evt.key, evt.count, dev_us / reps / 1e3


def kernel_device_ms(fn, reps: int) -> dict:
    """Device milliseconds a call by kernel name (torch.profiler over
    ``reps`` calls after one warm-up): a call's kernels without the host
    time between them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for key, _, ms in device_events(prof, reps):
        out[key] = out.get(key, 0.0) + ms
    return out


def net_macs(params, name, head_cols=None):
    """Multiply-adds per point of a net's layers (the last layer with only
    ``head_cols`` outputs when given)."""
    layers = params[name]["layers"]
    out = 0
    for l, layer in enumerate(layers):
        d_in, d_out = layer["v" if "v" in layer else "w"].shape
        out += d_in * (head_cols if head_cols is not None and l == len(layers) - 1 else d_out)
    return out


def _param_bytes(params, names, dtype) -> int:
    width = 2 if dtype == torch.bfloat16 else 4
    return sum(t.numel() * width for n in names
               for layer in params[n]["layers"] for t in layer.values())


def bound_ms(flops: float, bytes_moved: float, dtype):
    """(least time in ms, what bounds it) for the work on one H100 SXM."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], bytes_moved / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def train_step_split(trainer, loss_step, families, step_ms: float, smi: str,
                     label: str = "train step", detail=()) -> set:
    """Where a train step's time goes, after the counted run: forward
    (``loss_step(s)`` -> the loss) / backward / Adam by CUDA events, then
    device time by kernel family in a torch.profiler trace of
    ``trainer.train_step`` (``families``: (name, key substrings); then
    matrix products and the rest; ``detail``: kernels also listed one by
    one), and the device's idle share of ``step_ms`` (the untraced step).
    Returns the names of the traced device kernels (none where the trace
    recorded no device time)."""
    from torch.profiler import ProfilerActivity, profile

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    split = [0.0, 0.0, 0.0]
    for s in range(N_SPLIT):
        trainer.optimizer.zero_grad(set_to_none=True)
        ev[0].record()
        total = loss_step(s)
        ev[1].record()
        total.backward()
        ev[2].record()
        trainer.optimizer.step()
        ev[3].record()
        torch.cuda.synchronize()
        for i in range(3):
            split[i] += ev[i].elapsed_time(ev[i + 1]) / N_SPLIT
    whole = sum(split)
    print(f"{label} split ({smi}, CUDA events, {N_SPLIT} steps, a sync per step): "
          f"{whole:.2f} ms = forward {split[0]:.2f} ({100 * split[0] / whole:.1f} %), "
          f"backward {split[1]:.2f} ({100 * split[1] / whole:.1f} %), "
          f"Adam {split[2]:.2f} ({100 * split[2] / whole:.1f} %)", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for s in range(N_SPLIT):
            trainer.train_step(N_STEPS + N_SPLIT + 1 + s)
        torch.cuda.synchronize()
    fam = {name: 0.0 for name, _ in families}
    fam.update({"matrix products": 0.0, "other kernels": 0.0})
    launches, per_kernel, names = 0, {k: 0.0 for k in detail}, set()
    for key, count, ms in device_events(prof, N_SPLIT):
        launches += count
        names.add(key)
        name = next((f for f, keys in families if any(k in key for k in keys)), None)
        if name is None:
            name = ("matrix products" if any(k in key.lower() for k in GEMM_KERNELS)
                    else "other kernels")
        fam[name] += ms
        for k in detail:
            if k in key:
                per_kernel[k] += ms
    busy = sum(fam.values())
    if busy == 0:
        print(f"{label} trace: the profiler recorded no device time", flush=True)
        return names
    print(f"{label} trace ({N_SPLIT} steps): device busy {busy:.2f} ms of the "
          f"{step_ms:.1f} ms step (idle {100 * (1 - busy / step_ms):.1f} %), "
          f"{launches // N_SPLIT} kernel launches a step; "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in fam.items())
          + ("; segment kernels: " + ", ".join(f"{k} {v:.2f}" for k, v in per_kernel.items())
             if detail else ""), flush=True)
    return names


def endosurf_step_split(trainer, step_ms: float, smi: str, march_reuse: bool = True) -> None:
    """Phase 7's split and trace of the EndoSurf step; with ``march_reuse``
    false phase 15's, the sphere trace's step (its march kernels a family
    of their own; the march's sweeps are the upsampling's sweep kernel and
    count with the upsample)."""
    from endosurf_tpu_torch.train.trainer_endosurf import make_loss_fn
    tc = trainer.train_cfg
    loss_fn = make_loss_fn(trainer.spec, trainer.rspec, H, W, RAY_BATCH, trainer.loss_weights,
                           tc["surf_neig_rad"], march_reuse=march_reuse,
                           precision=trainer.precision,
                           sampling_precision=trainer.sampling_precision)

    def loss_step(s):
        return loss_fn(trainer.params, trainer.scene.device_arrays, N_STEPS + 1 + s,
                       trainer.generator)[0]
    families = (("field segment kernels", SEGMENT_KERNELS),
                ("upsample kernel", UPSAMPLE_KERNELS))
    if not march_reuse:
        families += (("march kernels", MARCH_KERNELS),)
    train_step_split(trainer, loss_step, families, step_ms, smi,
                     "train step" if march_reuse else "march train step", SEGMENT_KERNELS)


def upsample_inputs(arrays, rspec, n, gen, dev):
    """o, d_z, t and perturbed z0 [n, n_samples] of n train rays
    (sample_train_batch), as phases 6 and 8 take them."""
    from endosurf_tpu_torch.data.scene_data import sample_train_batch
    from endosurf_tpu_torch.models.endosurf import _split_rays, _stratified_z
    from endosurf_tpu_torch.ops.geometry import ray_sphere_intersection
    rays_b = sample_train_batch(arrays, H, W, n, generator=gen)["rays"]
    rays_o, rays_d, rays_d_z, t = _split_rays(rays_b)
    near, far, _ = ray_sphere_intersection(rays_o, rays_d)
    z0 = _stratified_z(near, far, rspec.n_samples, torch.rand(n, 1, generator=gen, device=dev))
    return rays_o, rays_d_z, t, z0


def upsample_f64_readings(spec, rspec, params, up_in, what: str) -> None:
    """The bf16 upsample kernel's and the float32 plain twin's distance from
    the float64 yardstick (fused_sampler.fused_upsample_z_float64: the same
    bf16 operand roundings, float64 arithmetic), per output:
    fused_sampler.parity_errors' (median, p99, max, share)."""
    from endosurf_tpu_torch.kernels import fused_sampler as fs
    bf, args = torch.bfloat16, (rspec.n_importance, rspec.up_sample_steps)
    got = {"kernel": fs.fused_upsample_z_cuda(spec, params, *up_in, *args, bf, True),
           "float32 plain": fs.fused_upsample_z_reference(spec, params, *up_in, *args, bf, True)}
    z, sdf = fs.fused_upsample_z_float64(spec, params, *up_in, *args)
    for name, (gz, gs) in got.items():
        e = fs.parity_errors({"z": gz.double(), "sdf": gs.double()}, {"z": z, "sdf": sdf}, bf)
        print(f"upsample bf16 vs float64 {what} {name}: " + "; ".join(
            f"{k} median {v[0]:.3e} p99 {v[1]:.3e} max {v[2]:.3e} over "
            f"{fs.PARITY_TOL[bf]['share'][0]:g} {100 * v[3]:.2f} %" for k, v in e.items()),
            flush=True)


def upsample_timing(spec, rspec, params, tb_in, smi: str, root: str = "") -> dict:
    """Phase 8: per dot mode (the kernel call's ms, the plain twin's call
    ms), CUDA events, on one train batch; beside them the call's device time
    by torch.profiler, all its kernels (the pack's gathers and casts too) and
    the upsample kernels alone."""
    from endosurf_tpu_torch.kernels import fused_sampler as fs
    args = (rspec.n_importance, rspec.up_sample_steps)
    out = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        def kern():
            return fs.fused_upsample_z_cuda(spec, params, *tb_in, *args, dt, True)
        call_ms = cuda_ms(kern, 10)
        dev = kernel_device_ms(kern, 10)
        up_ms = sum(v for k, v in dev.items() if any(u in k for u in UPSAMPLE_KERNELS))
        p_ms = cuda_ms(lambda: fs.fused_upsample_z_reference(spec, params, *tb_in, *args, dt, True),
                       10)
        out[name] = (call_ms, p_ms)
        print(f"upsample timing {name} ({RAY_BATCH} rays, {smi}{root}): kernel call "
              f"{call_ms:.3f} ms, plain {p_ms:.3f} ms; device time a call {sum(dev.values()):.3f} "
              f"ms, of it the upsample kernels {up_ms:.3f} ms", flush=True)
    return out


def train_midpoints(spec, rspec, params, arrays, gen, dev):
    """The section midpoints of one train batch ([R * 64] x, d, t), as the
    train step's field evaluation gets them: sample_train_batch, jittered
    stratified z, fused_upsample_z."""
    from endosurf_tpu_torch.data.scene_data import sample_train_batch
    from endosurf_tpu_torch.kernels import fused_sampler as fs
    from endosurf_tpu_torch.models.endosurf import _split_rays, _stratified_z
    from endosurf_tpu_torch.ops.geometry import ray_sphere_intersection
    rays_b = sample_train_batch(arrays, H, W, RAY_BATCH, generator=gen)["rays"]
    o, dvec, d_z, t = _split_rays(rays_b)
    near, far, _ = ray_sphere_intersection(o, dvec)
    z0 = _stratified_z(near, far, rspec.n_samples,
                       torch.rand(RAY_BATCH, 1, generator=gen, device=dev))
    z = fs.fused_upsample_z_cuda(spec, params, o, d_z, t, z0, rspec.n_importance,
                                 rspec.up_sample_steps, torch.bfloat16, False)
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 2.0 / rspec.n_samples)], -1)
    mid = z + dists * 0.5
    k = z.shape[1]
    x = (o[:, None] + d_z[:, None] * mid[..., None]).reshape(-1, 3)
    return (x.contiguous(), dvec[:, None].expand(-1, k, 3).reshape(-1, 3).contiguous(),
            t[:, None].expand(-1, k, 1).reshape(-1, 1).contiguous())


def print_segment_readings(res, what: str, dtype) -> None:
    """One line per segment and kind: the worst reading of each statistic
    over the entries, and the limits."""
    from endosurf_tpu_torch.kernels import fused_train_cuda as ftc
    for seg, kinds in res.items():
        for kind, vals in kinds.items():
            tol = ftc.parity_tol(dtype, kind)
            n_bad = sum(not v[-1] for v in vals.values())
            stats = list(zip(*[v[:-1] for v in vals.values()]))
            worst = [max(zip(col, vals), key=lambda cv: cv[0]) for col in stats]
            label = {"out": ("median", "p99", "max"), "sdf_out": ("median", "p99", "max"),
                     "cot": ("p99", "max"),
                     "leaf": ("rel L2",), "bias": ("rel L2",)}[kind]
            tols = tol if isinstance(tol, tuple) else (tol,)
            print(f"segment {what} {seg} {kind}: " + ", ".join(
                f"{lab} {v:.3e} ({name}; tol {t:g})"
                for lab, (v, name), t in zip(label, worst, tols))
                + f"; {n_bad}/{len(vals)} over", flush=True)


def segment_parity_phase(spec, x, d, t, dev):
    """Phase 9; returns the max absolute error of each kernel and the
    segments' (layers, weights, packed, inputs, cotangents) of the bf16 seed-0
    sound run (phase 11 times them)."""
    from endosurf_tpu_torch.kernels import fused_train_cuda as ftc
    from endosurf_tpu_torch.models.fields import init_endosurf_params
    abs_err, cases = {}, {}
    for seed in (0, 1):
        params = init_endosurf_params(spec, torch.Generator().manual_seed(seed), dev)
        n = x.shape[0] if seed == 0 else N_PARITY_SEED1
        for prec, other in (("highest", "default"), ("default", "highest")):
            dtype = torch.bfloat16 if prec == "default" else torch.float32
            for kp in (prec, other):
                res, ae, seg_cases = ftc.segment_parity(spec, params, x[:n], d[:n], t[:n], prec,
                                                        seed, kp)
                torch.cuda.synchronize()
                what = (f"{'sound' if kp == prec else 'control'} seed {seed} kernel {kp} "
                        f"plain {prec} ({n} points)")
                print_segment_readings(res, what, dtype)
                if kp == prec:
                    check(ftc.parity_ok(res), f"segment kernels vs plain out of tolerance ({what})")
                    if seed == 0 and prec == "default":
                        abs_err, cases = ae, seg_cases
                else:       # each segment's limits must tell the precisions apart
                    for seg, kinds in res.items():
                        check(not ftc.parity_ok({seg: kinds}),
                              f"segment {seg} kernel {kp} passes the {prec} limits")
    return abs_err, cases


def whole_step_vs_plain(spec, rspec, scene, dev) -> None:
    """Phase 10: one train step (render, auxiliary queries, six losses,
    backward) with the segment kernels against one with the plain field path
    (``fields.plain_point_eval`` put in place of
    ``fused_train.megakernel_point_eval``, which the card's field evaluation
    calls), same params and draws, in each dot mode; the control runs the
    kernels at the other precision and must fail the limits."""
    from endosurf_tpu_torch.bridge import flatten
    from endosurf_tpu_torch.kernels import fused_train as ft
    from endosurf_tpu_torch.models.fields import init_endosurf_params, plain_point_eval
    from endosurf_tpu_torch.train.trainer_endosurf import LOSS_WEIGHT_KEYS, make_loss_fn
    tc = base_cfg()["train"]
    weights = {k: float(tc[k]) for k in LOSS_WEIGHT_KEYS}
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    draws = {"frame": torch.tensor(1, device=dev),
             "u_pix": torch.rand(RAY_BATCH, generator=gen, device=dev),
             "z": torch.rand(RAY_BATCH, 1, generator=gen, device=dev),
             "neig": torch.rand(RAY_BATCH, 3, generator=gen, device=dev)}
    kernel_eval = ft.megakernel_point_eval

    def step(prec, field_eval):
        ft.megakernel_point_eval = field_eval
        try:
            fn = make_loss_fn(spec, rspec, H, W, RAY_BATCH, weights, tc["surf_neig_rad"],
                              precision=prec, sampling_precision=prec)
            for v in flatten(params).values():
                v.requires_grad_(True)
                v.grad = None
            total, metrics = fn(params, scene.device_arrays, 100.0, None, draws)
            total.backward()
        finally:
            ft.megakernel_point_eval = kernel_eval
        return ({k: float(v.detach()) for k, v in metrics.items()},
                {k: v.grad.clone() for k, v in flatten(params).items()})

    for prec, other in (("highest", "default"), ("default", "highest")):
        mp, gp = step(prec, plain_point_eval)
        runs = {"sound": step(prec, kernel_eval),
                f"control (kernels {other})": step(prec, lambda s_, p_, x, d, t, _prec:
                                                   kernel_eval(s_, p_, x, d, t, other))}
        m_tol, g_tol = WHOLE_STEP_TOL[prec]
        for what, (mk, gk) in runs.items():
            m_rel = {k: abs(mk[k] - mp[k]) / (abs(mp[k]) + 1e-6) for k in mp}
            g_rel = {}
            for net in ("deform_network", "sdf_network", "color_network", "deviation_network"):
                keys = [k for k in gk if k.startswith(net)]
                diff = sum(float(((gk[k] - gp[k]) ** 2).sum()) for k in keys) ** 0.5
                norm = sum(float((gp[k] ** 2).sum()) for k in keys) ** 0.5
                g_rel[net] = diff / max(norm, 1e-30)
            print(f"train step kernels vs plain field path ({prec}, {what}): metrics "
                  + ", ".join(f"{k[5:]} {v:.3e}" for k, v in m_rel.items())
                  + f" (tol {m_tol:g}); gradients " + ", ".join(
                      f"{k.split('_')[0]} {v:.3e}" for k, v in g_rel.items())
                  + f" (tol {g_tol:g})", flush=True)
            ok = (all(v <= m_tol for v in m_rel.values())
                  and all(v <= g_tol for v in g_rel.values()))
            if what == "sound":
                check(ok, f"step {prec} kernels vs plain: {m_rel} {g_rel}")
            else:       # the limits must tell the precisions apart
                check(not ok, f"step {prec}: the kernels at {other} pass the limits")


def grid_slab_inputs(scene, dev):
    """Phase 12's grid points: the first 64 x-planes of frame 0's 128^3 grid
    over its bbox x 1.2 (as the demo builds them), at frame 0's time."""
    from endosurf_tpu_torch.evaluation.geometry3d import grid_axes, grid_slab
    lin = grid_axes(scene.bbox_minmax[0, :, 0] * 1.2, scene.bbox_minmax[0, :, 1] * 1.2, GRID_RES)
    x = grid_slab(lin, 0, GRID_SLAB, dev)
    t = scene.device_arrays["ts"][0].reshape(1, 1).expand(x.shape[0], 1).contiguous()
    return x, t


def sdf_query_parity(spec, scene, dev) -> float:
    """Phase 12; returns the largest bf16 sound max error on the grid. The
    bf16 query (tensor cores) is held to its plain version and to its float64
    yardstick (fused_sdf.FLOAT64_TOL); the tensor-core and SIMT sweeps'
    distances from float64 are printed side by side."""
    import dataclasses

    from endosurf_tpu_torch.kernels import fused_sdf as fsd
    from endosurf_tpu_torch.models.fields import init_endosurf_params
    grid = grid_slab_inputs(scene, dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    static_pts = (torch.rand(N_STATIC, 3, generator=gen, device=dev) * 2.4 - 1.2,
                  torch.rand(N_STATIC, 1, generator=gen, device=dev))
    static = dataclasses.replace(spec, use_deform=False)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    worst = 0.0
    for seed in (0, 1):
        for what, s_spec, (x, t) in (("grid slab", spec, grid),
                                     ("static random", static, static_pts)):
            params = init_endosurf_params(s_spec, torch.Generator().manual_seed(seed), dev)
            got = {k: fsd.fused_sdf_observed_cuda(s_spec, params, x, t, dt)
                   for k, dt in dtypes.items()}
            ref = {k: fsd.fused_sdf_observed_reference(s_spec, params, x, t, dt)
                   for k, dt in dtypes.items()}
            torch.cuda.synchronize()
            for k_name in dtypes:
                for r_name, r_dt in dtypes.items():
                    med, p99, mx, ok = fsd.parity_errors(got[k_name], ref[r_name], r_dt)
                    sound = k_name == r_name
                    print(f"sdf query {'sound' if sound else 'control'} seed {seed} {what} "
                          f"({x.shape[0]} points) kernel {k_name} plain {r_name}: median "
                          f"{med:.3e}, p99 {p99:.3e}, max {mx:.3e} (tol "
                          f"{fsd.PARITY_TOL[r_dt]})", flush=True)
                    if sound:
                        check(ok, f"sdf query kernel vs plain ({what}, {k_name}, seed {seed})")
                        if k_name == "bfloat16" and what == "grid slab":
                            worst = max(worst, mx)
                    else:   # the limits must tell the precisions apart
                        check(not ok, f"sdf query kernel {k_name} passes the {r_name} limits")
            med, p99, mx, ok = fsd.float64_errors(got["bfloat16"], fsd.fused_sdf_observed_float64(
                s_spec, params, x, t))
            print(f"sdf query sound seed {seed} {what} ({x.shape[0]} points) kernel bfloat16 vs "
                  f"float64: median {med:.3e}, p99 {p99:.3e}, max {mx:.3e} (tol "
                  f"{fsd.FLOAT64_TOL[torch.bfloat16]})", flush=True)
            check(ok, f"sdf query kernel vs float64 ({what}, bfloat16, seed {seed})")
            tc_f64_readings(s_spec, params, "fused_sdf_observed", (None, None, (x, t)),
                            f"seed {seed} {what} ({x.shape[0]} points)")
    return worst


def demo_3d_phase(cfg, scene, dev) -> int:
    """Phase 13; returns the grid kernel's launches."""
    from endosurf_tpu_torch.kernels import fused_sdf as fsd
    from endosurf_tpu_torch.kernels import fused_train_cuda as ftc
    from endosurf_tpu_torch.serve import EndoSurfRenderer
    with tempfile.TemporaryDirectory() as exp_root:
        dcfg = json.loads(json.dumps(cfg))
        dcfg["exp"]["exp_dir"] = exp_root
        renderer = EndoSurfRenderer(dcfg, scene=scene, step=0, device=dev)
        fsd.LAUNCHES["fused_sdf_observed"] = 0
        packs = fsd.PACKS["fused_sdf_observed"]
        for k in ftc.LAUNCHES:
            ftc.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = renderer.demo(0, test_mode=True, visualize=False, demo_2d=False, demo_3d=True)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = fsd.LAUNCHES["fused_sdf_observed"]
        seg = dict(ftc.LAUNCHES)
        tim = stats["timing_3d"][0]
        n_chunks = math.ceil(tim["n_verts"] / 65536)
        d3 = os.path.join(renderer.exp_dir, "demo", "iter_00000000",
                          f"test_3d_thresh_0_res_{GRID_RES}")
        plys = sorted(f for f in os.listdir(d3) if f.endswith(".ply"))
        print(f"demo 3d: 1 frame at {GRID_RES}^3 in {total_s:.2f} s: grid "
              f"{1e3 * tim['grid']:.1f} ms ({launches} kernel launches), mesh "
              f"{1e3 * tim['mesh']:.1f} ms, colour {1e3 * tim['color']:.1f} ms (segment "
              f"launches {seg}), metrics {1e3 * tim['metrics']:.1f} ms; {tim['n_verts']} "
              f"vertices, {tim['n_tris']} triangles; geo_err_mean "
              f"{stats['geo_err_mean']:.4f} mm; {plys}", flush=True)
        check(launches == GRID_RES // GRID_SLAB,
              f"{launches} grid kernel launches for {GRID_RES // GRID_SLAB} slabs")
        packs = fsd.PACKS["fused_sdf_observed"] - packs
        check(packs == 1, f"{packs} grid query packs for one frame on one parameter set")
        check(all(seg[k] == (n_chunks if k.endswith("fwd") else 0) for k in seg),
              f"segment launches {seg} for {n_chunks} colour chunks")
        check(tim["n_verts"] > 0 and tim["n_tris"] > 0, "empty mesh")
        check(plys == ["000_color.ply", "000_geometry.ply", "000_gt.ply", "000_normal.ply"],
              f"PLYs written: {plys}")
        check(math.isfinite(stats["geo_err_mean"]), f"geo_err_mean {stats['geo_err_mean']}")
    return launches


def march_inputs(scene, n, gen, dev):
    """o, d_z, t, near, far of n train rays (sample_train_batch)."""
    from endosurf_tpu_torch.data.scene_data import sample_train_batch
    from endosurf_tpu_torch.models.endosurf import _split_rays
    from endosurf_tpu_torch.ops.geometry import ray_sphere_intersection
    rays_b = sample_train_batch(scene.device_arrays, H, W, n, generator=gen)["rays"]
    rays_o, rays_d, rays_d_z, t = _split_rays(rays_b)
    near, far, _ = ray_sphere_intersection(rays_o, rays_d)
    return rays_o, rays_d_z, t, near, far


def march_parity(spec, scene, dev) -> float:
    """Phase 14; returns the largest bf16 sound depth error."""
    from endosurf_tpu_torch.kernels import fused_sampler as fs
    from endosurf_tpu_torch.models.fields import init_endosurf_params
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    worst = 0.0
    for seed in (0, 1):
        params = init_endosurf_params(spec, torch.Generator().manual_seed(seed), dev)
        ins = march_inputs(scene, RAY_BATCH, torch.Generator(device=dev).manual_seed(10 + seed),
                           dev)
        got = {k: fs.fused_ray_march_cuda(spec, params, *ins, sampling_dtype=dt)
               for k, dt in dtypes.items()}
        ref = {k: fs.fused_ray_march_reference(spec, params, *ins, sampling_dtype=dt)
               for k, dt in dtypes.items()}
        torch.cuda.synchronize()
        for k_name in dtypes:
            for r_name, r_dt in dtypes.items():
                par = fs.march_parity(got[k_name], ref[r_name], r_dt)
                own = fs.march_consistency(spec, params, *ins[:3], got[k_name], r_dt)
                sound = k_name == r_name
                (flip,), _ = par["flip"]
                (med, p99), _ = par["depth"]
                (brk,), _ = own["bracket"]
                (r_med, r_p99, r_max), _ = own["residual"]
                valid = float(got[k_name]["valid"].float().mean())
                print(f"march {'sound' if sound else 'control'} seed {seed} kernel {k_name} "
                      f"twin {r_name} ({RAY_BATCH} rays, {100 * valid:.1f} % valid): flipped "
                      f"{100 * flip:.2f} %, depth median {med:.3e} p99 {p99:.3e}; own output: "
                      f"bracket {brk:.3e}, residual median {r_med:.3e} p99 {r_p99:.3e} max "
                      f"{r_max:.3e} (tol {fs.MARCH_TOL[r_dt]})", flush=True)
                ok = all(v[1] for v in par.values()) and all(v[1] for v in own.values())
                if sound:
                    check(ok, f"march kernel vs plain ({k_name}, seed {seed}): {par} {own}")
                    if k_name == "bfloat16":
                        d = (got[k_name]["depth"] - ref[r_name]["depth"]).abs()
                        both = got[k_name]["valid"] & ref[r_name]["valid"]
                        worst = max(worst, float(d[both].max()) if bool(both.any()) else 0.0)
                else:   # the limits must tell the precisions apart
                    check(not ok, f"march kernel {k_name} passes the {r_name} limits")
        march_f64_readings(spec, params, ins, got["bfloat16"], f"seed {seed} ({RAY_BATCH} rays)")
    return worst


def march_f64_readings(spec, params, ins, tc_out, what: str) -> None:
    """Phase 14: the bf16 march on tensor cores (``tc_out``) and the SIMT
    bf16 march against the float64 yardstick (fused_sampler.
    march_float64_distance), side by side; the tensor-core march must be
    within fused_sampler.MARCH_FLOAT64_TOL."""
    from endosurf_tpu_torch.kernels import fused_render as fr
    from endosurf_tpu_torch.kernels import fused_sampler as fs
    simt = fs.fused_ray_march_cuda(spec, params, *ins, sampling_dtype=torch.bfloat16, simt=True)
    dist = fs.march_float64_distance(spec, params, *ins, {"tensor cores": tc_out, "SIMT": simt})
    near = fr.no_farther(dist["tensor cores"], dist["SIMT"])
    print(f"march bf16 vs float64 {what}: " + "; ".join(
        f"{nm} flipped {100 * v['flip'][0]:.3f} %, depth median {v['depth'][0]:.3e} p99 "
        f"{v['depth'][1]:.3e}, residual median {v['residual'][0]:.3e} p99 "
        f"{v['residual'][1]:.3e}, {100 * v['off'][0]:.2f} % off by more than 1e-6"
        for nm, v in dist.items())
          + f" (tol {fs.MARCH_FLOAT64_TOL})"
          + ("" if all(near.values()) else f"  FARTHER {near}"), flush=True)
    check(fs.march_float64_ok(dist["tensor cores"]),
          f"bf16 march vs float64 ({what}): {dist['tensor cores']}")


def march_train_phase(cfg, scene, dev, smi: str) -> int:
    """Phase 15; returns the march kernel's launches."""
    from endosurf_tpu_torch.kernels import fused_sampler as fs
    from endosurf_tpu_torch.train.trainer_endosurf import EndoSurfTrainer
    with tempfile.TemporaryDirectory() as exp_root:
        mcfg = json.loads(json.dumps(cfg))
        mcfg["exp"]["exp_dir"] = exp_root
        mcfg["exp"]["exp_name"] = "chip_smoke_march"
        mcfg["train"]["surf_march_reuse"] = False
        mcfg["train"]["n_iter"] = MARCH_STEPS
        mcfg["log"] = {"i_eval": 0, "i_save": MARCH_STEPS}
        trainer = EndoSurfTrainer(mcfg, mode="train", scene=scene, device=dev)
        fs.LAUNCHES["fused_ray_march"] = 0
        fs.LAUNCHES["fused_upsample_z"] = 0
        torch.cuda.synchronize()
        trainer.start(log_every=MARCH_STEPS, stop_after=MARCH_WARM)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.start(log_every=MARCH_STEPS)
        torch.cuda.synchronize()
        timed_s = time.perf_counter() - t0
        launches = fs.LAUNCHES["fused_ray_march"]
        losses = {}
        with open(os.path.join(trainer.exp_dir, "logs", "metrics.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                if rec["tag"].startswith("train/loss"):
                    losses.setdefault(rec["step"], {})[rec["tag"]] = rec["value"]
        step_ms = timed_s / (MARCH_STEPS - MARCH_WARM) * 1e3
        print(f"march train: {MARCH_STEPS} steps x {RAY_BATCH} rays (surf_march_reuse false), "
              f"{step_ms:.1f} ms/step after {MARCH_WARM} warm-up, "
              f"{RAY_BATCH / step_ms * 1e3:.0f} rays/s ({smi}); {launches} march launches, "
              f"{fs.LAUNCHES['fused_upsample_z']} upsample launches; step {MARCH_STEPS}: "
              + ", ".join(f"{k[6:]} {v:.4f}" for k, v in losses.get(MARCH_STEPS, {}).items()),
              flush=True)
        check(launches == MARCH_STEPS, f"{launches} march launches for {MARCH_STEPS} steps")
        check(sorted(losses) == [1, MARCH_STEPS]
              and all(len(m) == 7 and all(math.isfinite(v) for v in m.values())
                      for m in losses.values()), f"losses {losses}")
        endosurf_step_split(trainer, step_ms, smi, march_reuse=False)
    return launches


def chain_macs(params) -> int:
    """Multiply-adds a point of the sampling chain (deform -> sdf head)."""
    return net_macs(params, "deform_network") + net_macs(params, "sdf_network", 1)


def new_kernel_timing(spec, scene, dev, smi: str) -> dict:
    """Phase 16: device ms of fused_sdf_observed (one grid slab) and
    fused_ray_march (1024 train rays) against their plain versions, bf16,
    with the bound of each from the shapes and TFLOP/s; beside the query
    (tensor cores) its SIMT bf16 sweep."""
    from endosurf_tpu_torch.kernels import fused_sampler as fs
    from endosurf_tpu_torch.kernels import fused_sdf as fsd
    from endosurf_tpu_torch.models.fields import init_endosurf_params
    bf = torch.bfloat16
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    x, t = grid_slab_inputs(scene, dev)
    ins = march_inputs(scene, RAY_BATCH, torch.Generator(device=dev).manual_seed(12), dev)
    chain = chain_macs(params)
    w_bytes = _param_bytes(params, ("deform_network", "sdf_network"), bf)
    n = x.shape[0]
    n_march = RAY_BATCH * (128 + 8)
    work = {"fused_sdf_observed": (2.0 * n * chain, n * (3 + 1 + 1) * 4 + w_bytes),
            "fused_ray_march": (2.0 * n_march * chain,
                                RAY_BATCH * (3 + 3 + 1 + 1 + 1 + 4) * 4 + RAY_BATCH * 4
                                + w_bytes)}
    calls = {"fused_sdf_observed": (fsd.fused_sdf_observed_cuda,
                                    fsd.fused_sdf_observed_reference, (x, t, bf), 3),
             "fused_ray_march": (fs.fused_ray_march_cuda, fs.fused_ray_march_reference,
                                 (*ins, 0.0, 128, 8, bf), 10)}
    times = {k: tuple(cuda_ms(lambda f=f: f(spec, params, *args), reps) for f in (kern, plain))
             for k, (kern, plain, args, reps) in calls.items()}
    out = {}
    for k, (k_ms, p_ms) in times.items():
        b_ms, b_by = bound_ms(*work[k], bf)
        out[k] = (k_ms, p_ms, b_ms, b_by)
        simt = simt_note(k, work[k][0], k_ms, functools.partial(calls[k][0], spec, params,
                                                                *calls[k][2]))
        print(f"{k} timing (bf16, {smi}): kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms; "
              f"{work[k][0] / 1e12:.4f} TFLOP -> bound {b_ms:.4f} ms ({b_by}); "
              f"{work[k][0] / k_ms / 1e9:.2f} TFLOP/s{simt}", flush=True)
    march_phases(spec, params, ins, chain, smi)
    return out


def march_phases(spec, params, ins, chain: int, smi: str) -> None:
    """Phase 16: the bf16 march (1024 train rays) on tensor cores and with
    simt=True, whole and with no secant step (the scan: prep, the 131,072-point
    sweep, the crossing, the finish), by CUDA events; the secant phase (8
    sweeps of 1024 points and 8 updates) is the difference. Each with its
    TFLOP/s; then the tensor-core march's device time by kernel
    (torch.profiler: its 9 sweeps under one name)."""
    from endosurf_tpu_torch.kernels import fused_sampler as fs
    bf = torch.bfloat16
    flops = {"scan": 2.0 * RAY_BATCH * 128 * chain, "secant": 2.0 * RAY_BATCH * 8 * chain}
    for name, simt in (("tensor cores", False), ("SIMT", True)):
        def march(n_secant, simt=simt):
            return fs.fused_ray_march_cuda(spec, params, *ins, 0.0, 128, n_secant, bf, simt=simt)
        whole, scan = cuda_ms(lambda: march(8), 10), cuda_ms(lambda: march(0), 10)
        secant = whole - scan
        print(f"fused_ray_march phases (bf16, {name}, {smi}): march {whole:.3f} ms = scan "
              f"{scan:.3f} ms ({flops['scan'] / scan / 1e9:.2f} TFLOP/s) + secant phase "
              f"{secant:.3f} ms ({100 * secant / whole:.1f} %, "
              f"{flops['secant'] / max(secant, 1e-9) / 1e9:.2f} TFLOP/s, "
              f"{secant / 8 * 1e3:.1f} us a step)", flush=True)
    per_kernel = kernel_device_ms(lambda: fs.fused_ray_march_cuda(
        spec, params, *ins, 0.0, 128, 8, bf), 5)
    print("fused_ray_march device time by kernel (bf16, tensor cores, torch.profiler): " + ", ".join(
        f"{k.replace('(anonymous namespace)::', '').split('(')[0]} {v:.3f} ms"
        for k, v in sorted(per_kernel.items(), key=lambda kv: -kv[1])), flush=True)


def segment_work(params, n: int) -> dict:
    """(flops, bytes) of each segment kernel at n points, from the parameter
    shapes: the forwards' products (deform: primal + 3 tangents; sdf: hidden,
    head + feature, the adjoint), the backwards' recompute, input-cotangent
    and weight-gradient products (sdf: of the primal and of the adjoint);
    bytes: per-point inputs and outputs once, bf16 weights, float32
    gradients."""
    def dims(name):
        return [tuple(layer["v"].shape) for layer in params[name]["layers"]]
    dd, sd, cd = dims("deform_network"), dims("sdf_network"), dims("color_network")
    deform = sum(i * o for i, o in dd)
    # the input cotangents of layers 1.. reach their h part only (x gets none)
    deform_in = sum(dd[l - 1][1] * dd[l][1] for l in range(1, len(dd)))
    s_h = sum(i * o for i, o in sd[:-1])
    s_out = sd[-1][0] * sd[-1][1]
    color = sum(i * o for i, o in cd)
    feat = sd[-1][1] - 1
    w_bytes = {k: sum(t.numel() for layer in params[k]["layers"] for t in layer.values())
               for k in ("deform_network", "sdf_network", "color_network")}
    macs = {"deform_fwd": 4 * deform, "deform_bwd": 4 * deform + 4 * deform_in + 4 * deform,
            "sdf_fwd": 2 * s_h + s_out, "sdf_bwd": 6 * s_h + 3 * s_out,
            "color_fwd": color, "color_bwd": 3 * color}
    io = {"deform_fwd": 4 + 12, "deform_bwd": 4 + 12, "sdf_fwd": 3 + 4 + feat,
          "sdf_bwd": 3 + 4 + feat + 3, "color_fwd": 9 + feat + 3,
          "color_bwd": 9 + feat + 3 + 9 + feat}
    net = {"deform": "deform_network", "sdf": "sdf_network", "color": "color_network"}
    out = {}
    for k, m in macs.items():
        wb = w_bytes[net[k.split("_")[0]]] * (2 if k.endswith("fwd") else 2 + 4)
        out[k] = (2.0 * m * n, n * io[k] * 4 + wb)
    return out


def segment_timing(spec, cases, reps: int) -> dict:
    """Phase 11: device ms of each segment kernel and of its plain version
    (forward; backward = recompute + autograd) on phase 9's bf16 inputs and
    cotangents (the plain chain's values at a train batch's points)."""
    from endosurf_tpu_torch.kernels import fused_train as ft
    from endosurf_tpu_torch.kernels import fused_train_cuda as ftc
    times = {}
    for seg, (like, flat, packed, inputs, cots) in cases.items():
        def plain_fwd():
            with torch.no_grad():
                return ft.seg_math(spec, seg, like, flat, inputs, "default")
        times[f"{seg}_fwd"] = (cuda_ms(lambda: ftc.FWD[seg](packed, *inputs), reps),
                               cuda_ms(plain_fwd, reps))
        times[f"{seg}_bwd"] = (cuda_ms(lambda: ftc.BWD[seg](packed, *inputs, *cots), reps),
                               cuda_ms(lambda: ft.plain_bwd(spec, seg, like, flat, inputs, cots,
                                                            "default"), reps))
    return times


def timed_train(scene, dev, exp_root: str):
    """Phase 7's run: EndoSurfTrainer on the in-memory base.yml config
    through Trainer.start, N_WARM steps, then the rest. Returns (trainer,
    warm-up s, timed s, peak GiB)."""
    from endosurf_tpu_torch.train.trainer_endosurf import EndoSurfTrainer
    tcfg = base_cfg()
    tcfg["exp"]["exp_dir"] = exp_root
    trainer = EndoSurfTrainer(tcfg, mode="train", scene=scene, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.start(log_every=N_STEPS, stop_after=N_WARM)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    trainer.start(log_every=N_STEPS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return trainer, t1 - t0, t2 - t1, torch.cuda.max_memory_allocated() / 2 ** 30


def density_raw_parity(spec, scene, dev) -> float:
    """Phase 17; returns the largest bf16 sound max error on the grid."""
    import dataclasses

    from endosurf_tpu_torch.kernels import fused_sdf as fsd
    from endosurf_tpu_torch.models.endonerf import init_dnerf_params
    grid = grid_slab_inputs(scene, dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    static_pts = (torch.rand(N_STATIC, 3, generator=gen, device=dev) * 2.4 - 1.2,
                  torch.rand(N_STATIC, 1, generator=gen, device=dev))
    static = dataclasses.replace(spec, use_deform=False)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    tol = fsd.DENSITY_PARITY_TOL
    worst = 0.0
    for seed in (0, 1):
        for what, s_spec, (x, t) in (("grid slab", spec, grid),
                                     ("static random", static, static_pts)):
            params = init_dnerf_params(s_spec, torch.Generator().manual_seed(seed), dev)
            got = {k: fsd.fused_density_raw_cuda(s_spec, params, x, t, dt)
                   for k, dt in dtypes.items()}
            ref = {k: fsd.fused_density_raw_reference(s_spec, params, x, t, dt)
                   for k, dt in dtypes.items()}
            torch.cuda.synchronize()
            for k_name in dtypes:
                for r_name, r_dt in dtypes.items():
                    med, p99, mx, ok = fsd.parity_errors(got[k_name], ref[r_name], r_dt, tol)
                    sound = k_name == r_name
                    print(f"density raw {'sound' if sound else 'control'} seed {seed} {what} "
                          f"({x.shape[0]} points) kernel {k_name} plain {r_name}: median "
                          f"{med:.3e}, p99 {p99:.3e}, max {mx:.3e} (tol {tol[r_dt]})",
                          flush=True)
                    if sound:
                        check(ok, f"density raw kernel vs plain ({what}, {k_name}, seed {seed})")
                        if k_name == "bfloat16" and what == "grid slab":
                            worst = max(worst, mx)
                    else:   # the limits must tell the precisions apart
                        check(not ok, f"density raw kernel {k_name} passes the {r_name} limits")
            tc_f64_readings(s_spec, params, "fused_density_raw", (None, None, (x, t)),
                            f"seed {seed} {what} ({x.shape[0]} points)")
    return worst


def dnerf_rays(renderer, n_guided: int, n_uniform: int):
    """Phase 18's rays: n_guided of a test frame with (gt depth, sigma) in
    slots 6/7 (the renderer's eval_ray_transform), evenly spaced, and the
    first n_uniform of the same frame with its (near, far) bounds."""
    from endosurf_tpu_torch.data.scene_data import frame_rays
    fid = int(renderer.scene.list_test[0])
    rays = frame_rays(renderer.scene.device_arrays, H, W, fid).reshape(-1, 9)
    guided = renderer.eval_ray_transform(rays, fid)
    step = rays.shape[0] // n_guided
    return guided[::step][:n_guided].contiguous(), rays[:n_uniform].contiguous()


def dnerf_render_parity(spec, rspec, renderer, dev) -> float:
    """Phase 18, on the seeded nets (seeds 0 and 1) and the opaque ones
    (seed 0 with fused_render_dnerf.DENSE_BIAS); returns the largest bf16
    sound max error."""
    import dataclasses

    from endosurf_tpu_torch.kernels import fused_render_dnerf as frd
    from endosurf_tpu_torch.models.endonerf import init_dnerf_params
    guided, uniform = dnerf_rays(renderer, N_PARITY, N_DN_UNIFORM)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    worst = 0.0
    for nets, seed, bias in (("seeded", 0, 0.0), ("seeded", 1, 0.0),
                             ("dense", 0, frd.DENSE_BIAS)):
        params = init_dnerf_params(spec, torch.Generator().manual_seed(seed), dev)
        if bias:
            params = frd.with_density_bias(params, bias)
        for what, rs, rays in (("depth-guided", rspec, guided),
                               ("uniform", dataclasses.replace(rspec, use_depth_sampling=False),
                                uniform)):
            got = {k: frd.fused_render_rays_dnerf_cuda(spec, rs, params, rays, None, dt, dt)
                   for k, dt in dtypes.items()}
            ref = {k: frd.fused_render_rays_dnerf_reference(spec, rs, params, rays, None, dt, dt)
                   for k, dt in dtypes.items()}
            torch.cuda.synchronize()
            for k_name in dtypes:
                for r_name, r_dt in dtypes.items():
                    errs = frd.parity_errors(got[k_name], ref[r_name], r_dt)
                    sound = k_name == r_name
                    tol = frd.PARITY_TOL[r_dt]
                    size = {k: float(v.abs().median()) for k, v in ref[r_name].items()}
                    print(f"dnerf render {'sound' if sound else 'control'} {nets} seed {seed} "
                          f"{what} ({rays.shape[0]} rays) kernel {k_name} twin {r_name}: "
                          + ", ".join(
                              f"{k} median {med:.3e} p99 {p99:.3e} max {mx:.3e} (tol "
                              f"{tol[k][0]:g} / {tol[k][1]:g} / {tol[k][2]:g}; median |map| "
                              f"{size[k]:.3e})" for k, (med, p99, mx, _) in errs.items()),
                          flush=True)
                    ok = all(v[-1] for v in errs.values())
                    if sound:
                        check(ok, f"dnerf render kernel vs twin ({nets}, {what}, {k_name}, "
                                  f"seed {seed})")
                        if k_name == "bfloat16":
                            worst = max(worst, max(v[2] for v in errs.values()))
                    else:   # the limits must tell the precisions apart
                        check(not ok, f"dnerf render kernel {k_name} passes the {r_name} limits")
            dnerf_render_f64_readings(spec, rs, params, rays,
                                      f"{nets} seed {seed} {what} ({rays.shape[0]} rays)")
    return worst


def dnerf_render_f64_readings(spec, rspec, params, rays, what: str) -> None:
    """Phase 18: the tensor-core and the SIMT bf16 render's distance from
    the float64 yardstick (fused_render_dnerf.fused_render_rays_dnerf_float64:
    the same bf16 operand roundings, float64 arithmetic), per map the median
    and p99 of the per-ray error (depth as depth x acc), side by side."""
    from endosurf_tpu_torch.kernels import fused_render as fr
    from endosurf_tpu_torch.kernels import fused_render_dnerf as frd
    bf = torch.bfloat16
    ref = frd.fused_render_rays_dnerf_float64(spec, rspec, params, rays)
    tc, simt = (frd.float64_distance(frd.fused_render_rays_dnerf_cuda(
        spec, rspec, params, rays, None, bf, bf, simt=flag), ref) for flag in (False, True))
    ok = fr.no_farther(tc, simt)
    for k in tc:
        print(f"dnerf render bf16 vs float64 {what} {k} (median, p99): tensor cores "
              f"{tc[k][0]:.4e}, {tc[k][1]:.4e}; SIMT {simt[k][0]:.4e}, {simt[k][1]:.4e}"
              + ("" if ok[k] else "  FARTHER"), flush=True)


def dnerf_fine_samples(spec, rspec, renderer, params, dev):
    """Phase 19's points: the 128 resampled depths of N_DN_SEG_RAYS
    depth-guided rays (coarse raw density on the kernel, the resample's plain
    version), as x, d [N, 3], t [N, 1]."""
    from endosurf_tpu_torch.kernels.fused_render_dnerf import init_z
    from endosurf_tpu_torch.kernels.fused_sampler import fine_resample_math
    from endosurf_tpu_torch.kernels.fused_sdf import fused_density_raw_cuda
    from endosurf_tpu_torch.models.endonerf import split_rays
    rays, _ = dnerf_rays(renderer, N_DN_SEG_RAYS, 1)
    o, d, d_z, _, _, t = split_rays(rays)
    z0 = init_z(rspec, rays)
    n, k0 = z0.shape

    def pts(z):
        return (o[:, None] + d_z[:, None] * z[..., None]).reshape(-1, 3)
    raw = fused_density_raw_cuda(spec, params, pts(z0), t.repeat_interleave(k0, 0),
                                 torch.bfloat16).reshape(n, k0)
    z = fine_resample_math(z0, torch.relu(raw), torch.linalg.norm(d, dim=-1, keepdim=True))
    k = z.shape[1]
    return (pts(z).contiguous(), d.repeat_interleave(k, 0).contiguous(),
            t.repeat_interleave(k, 0).contiguous())


def dnerf_segment_parity(spec, rspec, renderer, dev):
    """Phase 19; returns the max absolute error of each kernel and the bf16
    seed-0 cases (phase 22 times them)."""
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    from endosurf_tpu_torch.models.endonerf import init_dnerf_params
    abs_err, cases = {}, {}
    for seed in (0, 1):
        params = init_dnerf_params(spec, torch.Generator().manual_seed(seed), dev)
        x, d, t = dnerf_fine_samples(spec, rspec, renderer, params, dev)
        for prec, other in (("highest", "default"), ("default", "highest")):
            dtype = torch.bfloat16 if prec == "default" else torch.float32
            for kp in (prec, other):
                res, ae, seg_cases = ftd.segment_parity(spec, params, x, d, t, prec, kp)
                torch.cuda.synchronize()
                sound = kp == prec
                for name, outs in res.items():
                    print(f"dnerf segment {'sound' if sound else 'control'} seed {seed} kernel "
                          f"{kp} plain {prec} {name} ({x.shape[0]} points): " + ", ".join(
                              f"{k} median {v[0]:.3e} p99 {v[1]:.3e} max {v[2]:.3e}"
                              for k, v in outs.items())
                          + f" (tol {ftd.PARITY_TOL[dtype]})", flush=True)
                    ok = all(v[-1] for v in outs.values())
                    if sound:
                        check(ok, f"dnerf segment {name} kernel vs plain ({prec}, seed {seed})")
                    else:   # each segment's limits must tell the precisions apart
                        check(not ok, f"dnerf segment {name} kernel {kp} passes the {prec} limits")
                if sound and prec == "default":
                    for name in ("dnerf_deform_fwd", "dnerf_density_fwd", "dnerf_color_fwd"):
                        packed, inputs = seg_cases[name]
                        tc_f64_readings(spec, params, name, (packed, None, inputs),
                                        f"seed {seed} ({x.shape[0]} points)")
                    if seed == 0:
                        abs_err, cases = ae, seg_cases
    return abs_err, cases, x.shape[0]


def dnerf_serving_phase(renderer, smi: str) -> int:
    """Phase 20; returns the render kernel's launches."""
    import numpy as np

    from endosurf_tpu_torch.evaluation.render_eval import eval_frames
    from endosurf_tpu_torch.kernels import fused_render_dnerf as frd
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    frd.LAUNCHES["fused_render_rays_dnerf"] = 0
    packs = ftd.PACKS["dnerf"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats, pred = eval_frames(renderer, renderer.scene.list_test[:1], 0, ray_chunk=CHUNK,
                              save_images=False, return_pred=True)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = frd.LAUNCHES["fused_render_rays_dnerf"]
    packs = ftd.PACKS["dnerf"] - packs
    n_chunks = math.ceil(H * W / CHUNK)
    print(f"dnerf e2e ({smi}, save_images off): {H}x{W} frame in {e2e_s:.2f} s "
          f"({H * W / e2e_s:.0f} rays/s), peak memory {peak:.3f} GiB, {launches} render kernel "
          f"launches for {n_chunks} chunks on {packs} pack(s); "
          + ", ".join(f"{k} {v:.4f}" for k, v in stats.items()), flush=True)
    check(launches == n_chunks, f"{launches} dnerf render launches for {n_chunks} chunks")
    check(packs <= 1, f"{packs} D-NeRF packs for one frame on one parameter set")
    for k, ch in (("rgb", 3), ("depth", 1), ("normal", 3)):
        check(pred[k].shape == (1, H, W, ch), f"dnerf {k} map shape {pred[k].shape}")
        check(bool(np.isfinite(pred[k]).all()), f"dnerf {k} map finite")
    check(float(np.abs(pred["normal"]).sum()) > 0, "dnerf normals from depth")
    check(all(math.isfinite(v) for v in stats.values()), f"finite dnerf metrics {stats}")
    return launches


def dnerf_3d_phase(cfg, scene, dev) -> tuple:
    """Phase 21; returns (raw-density launches, segment launches)."""
    import numpy as np

    from endosurf_tpu_torch.evaluation.geometry3d import grid_axes, grid_slab
    from endosurf_tpu_torch.kernels import fused_sdf as fsd
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    from endosurf_tpu_torch.serve import EndoNeRFRenderer
    with tempfile.TemporaryDirectory() as exp_root:
        dcfg = json.loads(json.dumps(cfg))
        dcfg["exp"]["exp_dir"] = exp_root
        renderer = EndoNeRFRenderer(dcfg, scene=scene, step=0, device=dev)
        fid = int(scene.list_test[0])
        lin = grid_axes(scene.bbox_minmax[fid, :, 0] * 1.2, scene.bbox_minmax[fid, :, 1] * 1.2,
                        DN_PROBE)
        probe = grid_slab(lin, 0, DN_PROBE, dev)
        t_probe = scene.device_arrays["ts"][fid].reshape(1, 1).expand(probe.shape[0], 1)
        thresh = round(float(-renderer.demo_field_fn()(probe, t_probe.contiguous()).median()), 5)
        renderer.cfg["demo"]["marching_cubes_thresh"] = thresh
        print(f"dnerf demo 3d: iso-threshold {thresh} (the median raw density of a "
              f"{DN_PROBE}^3 probe; base.yml's 5 finds no surface in the seeded nets); "
              "visualize off", flush=True)
        fsd.LAUNCHES["fused_density_raw"] = 0
        for k in ftd.LAUNCHES:
            ftd.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = renderer.demo(0, test_mode=True, visualize=False, demo_2d=False, demo_3d=True)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = fsd.LAUNCHES["fused_density_raw"]
        seg = dict(ftd.LAUNCHES)
        tim = stats["timing_3d"][0]
        n_chunks = math.ceil(tim["n_verts"] / 65536)
        d3 = os.path.join(renderer.exp_dir, "demo", "iter_00000000",
                          f"test_3d_thresh_{thresh}_res_{GRID_RES}")
        plys = sorted(f for f in os.listdir(d3) if f.endswith(".ply"))
        print(f"dnerf demo 3d: 1 frame at {GRID_RES}^3 in {total_s:.2f} s: grid "
              f"{1e3 * tim['grid']:.1f} ms ({launches} kernel launches), mesh "
              f"{1e3 * tim['mesh']:.1f} ms (marching_cubes_filter 100), colour "
              f"{1e3 * tim['color']:.1f} ms (segment launches {seg}), metrics "
              f"{1e3 * tim['metrics']:.1f} ms; {tim['n_verts']} vertices, {tim['n_tris']} "
              f"triangles; geo_err_mean {stats['geo_err_mean']:.4f} mm; {plys}", flush=True)
        check(launches == GRID_RES // GRID_SLAB,
              f"{launches} raw-density launches for {GRID_RES // GRID_SLAB} slabs")
        check(all(v == (n_chunks if k.endswith("_fwd") else 0) for k, v in seg.items()),
              f"segment launches {seg} for {n_chunks} colour chunks")
        check(tim["n_verts"] > 0 and tim["n_tris"] > 0, "empty mesh")
        check(plys == ["000_color.ply", "000_geometry.ply", "000_gt.ply", "000_normal.ply"],
              f"PLYs written: {plys}")
        check(math.isfinite(stats["geo_err_mean"]) and bool(np.isfinite(
            stats["geo_err_per_frame"]).all()), f"geo_err_mean {stats['geo_err_mean']}")
    return launches, seg


# an EndoNeRF render chunk's kernels by family (phase 22): the bf16 passes
# on tensor cores, the SIMT ones (float32, and bf16 with simt=True)
DN_RENDER_FAMILIES = {"coarse sweep (tensor cores)": ("dn_sweep_tc_kernel",),
                      "field (tensor cores)": ("dn_field_tc_kernel",),
                      "coarse sweep (SIMT)": ("sweep_kernel<",),
                      "field (SIMT)": ("dn_field_kernel",), "resample": ("dn_resample",),
                      "composite": ("dn_composite",), "prep": ("dn_prep",)}


def render_split(fn, smi: str, what: str, reps: int = 3) -> None:
    """Device time of one EndoNeRF render chunk by kernel family
    (torch.profiler)."""
    parts = {k: 0.0 for k in DN_RENDER_FAMILIES}
    parts["other"] = 0.0
    for key, ms in kernel_device_ms(fn, reps).items():
        parts[next((f for f, names in DN_RENDER_FAMILIES.items()
                    if any(n in key for n in names)), "other")] += ms
    busy = sum(parts.values())
    if busy == 0:
        print("dnerf render split: the profiler recorded no device time", flush=True)
        return
    print(f"dnerf render split ({CHUNK} rays, bf16, {what}, {smi}): {busy:.3f} ms of device "
          "time = " + ", ".join(f"{k} {v:.3f} ms ({100 * v / busy:.1f} %)"
                                for k, v in parts.items() if v), flush=True)


def render_f64_readings(spec, params, rays, args, what: str) -> None:
    """Phase 3: the tensor-core and the SIMT bf16 render's distance from the
    float64 yardstick (fused_render.fused_render_rays_float64: the same bf16
    operand roundings, float64 arithmetic), per map the median and p99 of
    the per-ray error, side by side."""
    from endosurf_tpu_torch.kernels import fused_render as fr
    bf = torch.bfloat16
    ref = fr.fused_render_rays_float64(spec, params, rays, *args)
    tc, simt = (fr.float64_distance(fr.fused_render_rays_cuda(spec, params, rays, *args, bf, bf,
                                                               simt=flag), ref)
                for flag in (False, True))
    ok = fr.no_farther(tc, simt)
    for k in tc:
        print(f"render bf16 vs float64 {what} {k} (median, p99): tensor cores {tc[k][0]:.4e}, "
              f"{tc[k][1]:.4e}; SIMT {simt[k][0]:.4e}, {simt[k][1]:.4e}"
              + ("" if ok[k] else "  FARTHER"), flush=True)


def render_chunk_split(fn, smi: str, reps: int = 3) -> dict:
    """Phase 5: device time of one render chunk by family (torch.profiler)."""
    parts = {k: 0.0 for k in RENDER_FAMILIES}
    parts["other"] = 0.0
    for key, ms in kernel_device_ms(fn, reps).items():
        parts[next((f for f, names in RENDER_FAMILIES.items()
                    if any(n in key for n in names)), "other")] += ms
    busy = sum(parts.values())
    if busy == 0:
        print("render split: the profiler recorded no device time", flush=True)
        return parts
    print(f"render split ({CHUNK} rays, bf16, {smi}): {busy:.3f} ms of device time = "
          + ", ".join(f"{k} {v:.3f} ms ({100 * v / busy:.1f} %)" for k, v in parts.items()),
          flush=True)
    return parts


def dnerf_fwd_work(spec, params, n: int) -> dict:
    """{forward segment kernel: (flops, bytes)} at n points, bf16: the
    net's products; per-point inputs and outputs once, the bf16 weights."""
    bf = torch.bfloat16
    f = spec.geo_feat_dim
    macs = {k: net_macs(params, k) for k in ("deform", "density", "color")}
    wb = {k: _param_bytes(params, (k,), bf) for k in macs}
    io = {"deform": 4 + 3, "density": 3 + 1 + f, "color": 3 + f + 3}
    return {f"dnerf_{k}_fwd": (2.0 * n * macs[k], n * io[k] * 4 + wb[k]) for k in macs}


def dnerf_fwd_plain(spec, params) -> dict:
    """{forward segment kernel: its plain version on the kernel's inputs}, bf16."""
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    eff = ftd.prepare_effective_dnerf(spec, params)
    return {
        "dnerf_deform_fwd": lambda xt: ftd.seg_deform_math(spec, eff["deform"], xt, "default"),
        "dnerf_density_fwd": lambda xc: ftd.seg_density_math(
            spec, eff["density"], eff["sigma_head"], eff["geo_feat"], xc, "default"),
        "dnerf_color_fwd": lambda d, feat: ftd.seg_color_math(spec, eff["color"], d, feat,
                                                              "default"),
    }


def dnerf_timing(spec, rspec, renderer, seg_cases, n_seg, smi: str) -> dict:
    """Phase 22: device ms of the five EndoNeRF kernels and their plain
    versions at the paths' shapes, bf16, with (bound ms, bounded by) from the
    parameter shapes."""
    from endosurf_tpu_torch.kernels import fused_render_dnerf as frd
    from endosurf_tpu_torch.kernels import fused_sdf as fsd
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    from endosurf_tpu_torch.models.endonerf import init_dnerf_params
    bf = torch.bfloat16
    params = init_dnerf_params(spec, torch.Generator().manual_seed(0), renderer.device)
    x, t = grid_slab_inputs(renderer.scene, renderer.device)
    chunk, _ = dnerf_rays(renderer, CHUNK, 1)
    deform, dens, color = (net_macs(params, k) for k in ("deform", "density", "color"))
    chain = deform + net_macs(params, "density", 1)      # deform, density hidden, sigma head
    full = deform + dens + color
    wb = {k: _param_bytes(params, (k,), bf) for k in params}
    n_pts = x.shape[0]
    work = {
        "fused_render_rays_dnerf": (2.0 * CHUNK * (rspec.n_samples * chain
                                                   + (rspec.n_samples + rspec.n_importance)
                                                   * full),
                                    CHUNK * (9 + 5) * 4 + sum(wb.values())),
        "fused_density_raw": (2.0 * n_pts * chain,
                              n_pts * (3 + 1 + 1) * 4 + wb["deform"] + wb["density"]),
        **dnerf_fwd_work(spec, params, n_seg),
    }
    calls = {
        "fused_render_rays_dnerf": (
            lambda: frd.fused_render_rays_dnerf_cuda(spec, rspec, params, chunk, None, bf, bf),
            lambda: frd.fused_render_rays_dnerf_reference(spec, rspec, params, chunk, None, bf,
                                                          bf), 5),
        "fused_render_rays_dnerf (SIMT bf16)": (
            lambda: frd.fused_render_rays_dnerf_cuda(spec, rspec, params, chunk, None, bf, bf,
                                                     simt=True), None, 5),
        "fused_density_raw": (lambda: fsd.fused_density_raw_cuda(spec, params, x, t, bf),
                              lambda: fsd.fused_density_raw_reference(spec, params, x, t, bf), 3),
    }
    plain = dnerf_fwd_plain(spec, params)
    for name, (packed, inputs) in seg_cases.items():
        calls[name] = (lambda n=name, p=packed, i=inputs: ftd.FWD[n.split("_")[1]](p, *i),
                       lambda n=name, i=inputs: plain[n](*i), 5)
    calls["fused_density_raw (SIMT bf16)"] = (
        lambda: fsd.fused_density_raw_cuda(spec, params, x, t, bf, simt=True), None, 3)
    for name in ("dnerf_deform_fwd", "dnerf_density_fwd", "dnerf_color_fwd"):
        packed, inputs = seg_cases[name]
        calls[f"{name} (SIMT bf16)"] = (
            lambda f=ftd.FWD[name.split("_")[1]], p=packed, i=inputs: f(p, *i, simt=True), None, 5)
    render_split(calls["fused_render_rays_dnerf"][0], smi, "tensor cores")
    render_split(calls["fused_render_rays_dnerf (SIMT bf16)"][0], smi, "SIMT")
    out = {}
    for k, (kern, pl, reps) in calls.items():
        with torch.no_grad():
            k_ms = cuda_ms(kern, reps)
            p_ms = cuda_ms(pl, reps) if pl is not None else float("nan")
        name = k.split(" ")[0]
        b_ms, b_by = bound_ms(*work[name], bf)
        out[k] = (k_ms, p_ms, b_ms, b_by)
        print(f"{k} timing (bf16, {smi}): kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms; "
              f"{work[name][0] / 1e12:.4f} TFLOP, {work[name][1] / 1e6:.1f} MB -> bound "
              f"{b_ms:.4f} ms ({b_by}); {work[name][0] / k_ms / 1e9:.2f} TFLOP/s, "
              f"{work[name][1] / k_ms / 1e6:.1f} GB/s", flush=True)
    return out


def endonerf_train_cfg(exp_dir: str, n_iter: int = N_STEPS) -> dict:
    """endonerf_cfg() with configs/endonerf/base.yml's train keys; no eval
    during the run."""
    cfg = endonerf_cfg()
    cfg["exp"]["exp_dir"] = exp_dir
    cfg["train"].update({
        "n_iter": n_iter, "ray_batch": DN_RAY_BATCH, "mask_guided_ray_sampling": True,
        "color_loss_weight": 1.0, "depth_loss_weight": 1.0, "resume": False,
        "optim": {"lr": 0.0005, "lr_decay": 250},
        "eval": {"ray_batch": CHUNK}})
    cfg["log"] = {"i_eval": 0, "i_save": n_iter}
    return cfg


def dnerf_train_batch(spec, rspec, params, scene, gen, dev, n_rays=DN_RAY_BATCH):
    """The fine samples of one EndoNeRF train batch as the train step forms
    them: sample_train_batch, slots 6/7 = (depth, sigma), init_z with drawn
    eps, fused_density_raw (bf16) + unit noise + relu, fused_fine_resample.
    Returns (x, d [N, 3], t [N, 1], (z0, sigma, |d|), (x0 [M, 3], t0 [M, 1]):
    the coarse points the raw density query took)."""
    from endosurf_tpu_torch.data.scene_data import sample_train_batch
    from endosurf_tpu_torch.kernels import fused_sampler as fs
    from endosurf_tpu_torch.kernels.fused_render_dnerf import init_z
    from endosurf_tpu_torch.kernels.fused_sdf import fused_density_raw_cuda
    from endosurf_tpu_torch.models.endonerf import split_rays
    b = sample_train_batch(scene.device_arrays, scene.h, scene.w, n_rays, generator=gen)
    rays = torch.cat([b["rays"][:, :6], b["depth"],
                      torch.full_like(b["depth"], rspec.depth_sampling_sigma),
                      b["rays"][:, 8:9]], -1)
    o, d, d_z, _, _, t = split_rays(rays)
    n0 = rspec.n_samples
    z0 = init_z(rspec, rays, torch.randn(n_rays, n0, generator=gen, device=dev))

    def pts(z):
        return (o[:, None] + d_z[:, None] * z[..., None]).reshape(-1, 3)
    coarse = (pts(z0).contiguous(), t.repeat_interleave(n0, 0).contiguous())
    raw = fused_density_raw_cuda(spec, params, *coarse, torch.bfloat16).reshape(n_rays, n0)
    sigma = torch.relu(raw + torch.randn(raw.shape, generator=gen, device=dev))
    dn = torch.linalg.norm(d, dim=-1, keepdim=True)
    z = fs.fused_fine_resample_cuda(z0, sigma, dn, rspec.n_importance)
    k = z.shape[1]
    return (pts(z).contiguous(), d.repeat_interleave(k, 0).contiguous(),
            t.repeat_interleave(k, 0).contiguous(), (z0, sigma, dn), coarse)


def density_raw_coarse_parity(spec, params, coarse, what: str) -> None:
    """Phase 23: the bf16 raw density query against its plain version on a
    train batch's coarse points (the train step's coarse pass), sound and
    with the kernel in float32 (the control, which must fail), and its
    float64 readings."""
    from endosurf_tpu_torch.kernels import fused_sdf as fsd
    bf, f32 = torch.bfloat16, torch.float32
    ref = fsd.fused_density_raw_reference(spec, params, *coarse, bf)
    for k_dt in (bf, f32):
        med, p99, mx, ok = fsd.parity_errors(fsd.fused_density_raw_cuda(spec, params, *coarse,
                                                                        k_dt),
                                             ref, bf, fsd.DENSITY_PARITY_TOL)
        sound = k_dt == bf
        print(f"density raw {'sound' if sound else 'control'} {what} kernel {k_dt} plain "
              f"bf16: median {med:.3e}, p99 {p99:.3e}, max {mx:.3e} "
              f"(tol {fsd.DENSITY_PARITY_TOL[bf]})", flush=True)
        check(ok if sound else not ok,
              f"density raw kernel {k_dt} vs plain bf16 at the coarse points ({what})")
    tc_f64_readings(spec, params, "fused_density_raw", (None, None, coarse), what)


def dnerf_bwd_parity_phase(spec, x, d, t, dev, coarse=None):
    """Phase 23; returns each kernel's max absolute error and the bf16 seed-0
    sound cases (phase 27 times them). ``coarse``: the train batch's coarse
    points, where the raw density query is held too."""
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    from endosurf_tpu_torch.models.endonerf import init_dnerf_params
    abs_err, cases = {}, {}
    for seed in (0, 1):
        params = init_dnerf_params(spec, torch.Generator().manual_seed(seed), dev)
        n = x.shape[0] if seed == 0 else N_DN_BWD_SEED1
        for prec, other in (("highest", "default"), ("default", "highest")):
            dtype = torch.bfloat16 if prec == "default" else torch.float32
            tol = ftd.BWD_PARITY_TOL[dtype]
            for kp in (prec, other):
                res, ae, seg_cases = ftd.bwd_segment_parity(spec, params, x[:n], d[:n], t[:n],
                                                            prec, seed, kp)
                torch.cuda.synchronize()
                sound = kp == prec
                for name, kinds in res.items():
                    worst = max(kinds["leaf"].items(), key=lambda kv: kv[1][0])
                    n_bad = sum(not v[-1] for v in kinds["leaf"].values())
                    print(f"dnerf bwd {'sound' if sound else 'control'} seed {seed} kernel {kp} "
                          f"plain {prec} {name} ({n} points): " + "".join(
                              f"d {k} median {v[0]:.3e} p99 {v[1]:.3e} max {v[2]:.3e}; "
                              for k, v in kinds["cot"].items())
                          + f"leaves: worst rel L2 {worst[1][0]:.3e} ({worst[0]}), {n_bad}/"
                          f"{len(kinds['leaf'])} over; tol cot "
                          f"{[ftd.cot_tol(dtype, name, k) for k in kinds['cot']]} leaf "
                          f"{tol['leaf']}", flush=True)
                    ok = ftd.bwd_parity_ok({name: kinds})
                    if sound:
                        check(ok, f"dnerf bwd {name} kernel vs plain ({prec}, seed {seed})")
                    else:   # each kernel's limits must tell the precisions apart
                        check(not ok, f"dnerf bwd {name} kernel {kp} passes the {prec} limits")
                if sound and prec == "default":
                    f64_cases = seg_cases
                    if seed == 0:
                        abs_err, cases = ae, seg_cases
                del res, seg_cases
        tc_f64_train_readings(spec, params, f64_cases, f"seed {seed} ({n} points)")
        del f64_cases
        if coarse is not None:
            density_raw_coarse_parity(spec, params, coarse,
                                      f"seed {seed} ({coarse[0].shape[0]} coarse points)")
    return abs_err, cases


def tc_f64_train_readings(spec, params, cases, what: str) -> None:
    """Phase 23: tc_f64_readings of the three backwards on their bf16 cases
    (bwd_segment_parity's), of the deform forward on the deform backward's xt,
    of the density forward on the density backward's x_c and of the colour
    forward on the colour backward's d and feat; the deform and colour
    backwards' walks against float64 (walk_readings)."""
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    packed, like, _, inputs, cots = cases["dnerf_deform_bwd"]
    tc_f64_readings(spec, params, "dnerf_deform_fwd", (packed, None, inputs), what)
    tc_f64_readings(spec, params, "dnerf_deform_bwd", (packed, like, inputs, cots), what)
    walk_readings(spec, params, "deform", cases, what)
    packed, like, _, inputs, cots = cases["dnerf_density_bwd"]
    tc_f64_readings(spec, params, "dnerf_density_fwd", (packed, None, inputs), what)
    tc_f64_readings(spec, params, "dnerf_density_bwd", (packed, like, inputs, cots), what)
    packed, like, _, inputs, cots = cases["dnerf_color_bwd"]
    tc_f64_readings(spec, params, "dnerf_color_fwd", (packed, None, inputs), what)
    tc_f64_readings(spec, params, "dnerf_color_bwd", (packed, like, inputs, cots), what)
    walk_readings(spec, params, "color", cases, what)


def walk_readings(spec, params, seg: str, cases, what: str) -> None:
    """Phase 23: a backward's walk against float64, the tensor-core kernel
    beside the SIMT one (fused_train_dnerf.walk_distance)."""
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    packed, _, _, inputs, cots = cases[f"dnerf_{seg}_bwd"]
    walk = ftd.walk_distance(spec, params, seg, packed, inputs, cots)
    print(f"dnerf_{seg}_bwd bf16 vs float64 {what}: points whose operands or cotangents are off "
          f"the float64 walk, weight elements off float64, weight elements off the exact product "
          f"of the kernel's own operands " + "; ".join(
              f"{nm} {100 * v['points']:.3f} %, {100 * v['weights']:.3f} %, "
              f"{100 * v['product']:.3f} %" for nm, v in walk.items())
          + ("" if walk["tensor cores"]["points"] <= walk["SIMT"]["points"] else "  FARTHER"),
          flush=True)


def tc_f64_readings(spec, params, kernel: str, case, what: str) -> None:
    """Phases 12, 17, 19 and 23: a tensor-core bf16 D-NeRF kernel's and its SIMT
    bf16 kernel's distance from the float64 yardstick on the same inputs
    (fused_train_dnerf.tc_float64_distance: the same bf16 operand and
    cotangent roundings, float64 arithmetic), side by side: median and p99
    of each output's (a backward's d x_c) per-point error and of the weight
    gradients' per-element error. ``case``: (packed, like, inputs[, cots]);
    the raw density and observed-SDF queries take (None, None, (x, t))."""
    from endosurf_tpu_torch.kernels import fused_render as fr
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    dist = ftd.tc_float64_distance(spec, params, kernel, *case)
    ok = fr.no_farther(dist["tensor cores"], dist["SIMT"])
    for k in ok:
        print(f"{kernel} bf16 vs float64 {what} {k} (median, p99): " + "; ".join(
            f"{nm} {v[k][0]:.4e}, {v[k][1]:.4e}" for nm, v in dist.items())
              + ("" if ok[k] else "  FARTHER"), flush=True)


def shifted_resample(z_vals, sigma, d_norm, n_new):
    """Phase 24's control: fine_resample_math with its draws half a step
    early (u_j = j / n_new)."""
    from endosurf_tpu_torch.ops.neus import exclusive_cumprod_weights
    from endosurf_tpu_torch.ops.pdf import sample_pdf
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                       torch.full_like(z_vals[:, :1], 1e10)], -1)
    w = exclusive_cumprod_weights(1.0 - torch.exp(-sigma * (dists * d_norm)), eps=1e-10)
    u = (torch.arange(n_new, device=z_vals.device, dtype=z_vals.dtype) / n_new).expand(
        z_vals.shape[0], n_new).contiguous()
    z_new = sample_pdf(0.5 * (z_vals[:, 1:] + z_vals[:, :-1]), w[:, 1:-1], n_new, u=u)
    return torch.sort(torch.cat([z_vals, z_new], -1), dim=-1).values


def dnerf_resample_phase(spec, rspec, scene, dev) -> float:
    """Phase 24; returns the largest sound max error."""
    from endosurf_tpu_torch.kernels import fused_render_dnerf as frd
    from endosurf_tpu_torch.kernels import fused_sampler as fs
    from endosurf_tpu_torch.models.endonerf import init_dnerf_params
    worst = 0.0
    for nets, seed, bias in (("seeded", 0, 0.0), ("seeded", 1, 0.0),
                             ("dense", 0, frd.DENSE_BIAS)):
        params = init_dnerf_params(spec, torch.Generator().manual_seed(seed), dev)
        if bias:
            params = frd.with_density_bias(params, bias)
        *_, (z0, sigma, dn), _ = dnerf_train_batch(
            spec, rspec, params, scene, torch.Generator(device=dev).manual_seed(20 + seed), dev)
        got = fs.fused_fine_resample_cuda(z0, sigma, dn, rspec.n_importance)
        ref = fs.fused_fine_resample_reference(z0, sigma, dn, rspec.n_importance)
        ctl = shifted_resample(z0, sigma, dn, rspec.n_importance)
        torch.cuda.synchronize()
        sound, control = fs.resample_parity(got, ref), fs.resample_parity(got, ctl)
        opaque = float((sigma > 0).float().mean())
        print(f"resample {nets} seed {seed} ({z0.shape[0]} rays, {100 * opaque:.1f} % of "
              f"coarse samples with density): sound median {sound[0]:.3e} p99 {sound[1]:.3e} "
              f"max {sound[2]:.3e}; control (draws half a step early) median {control[0]:.3e} "
              f"p99 {control[1]:.3e} max {control[2]:.3e}; tol {fs.RESAMPLE_PARITY_TOL}; "
              f"sorted {bool((got[:, 1:] >= got[:, :-1]).all())}", flush=True)
        check(sound[-1], f"resample kernel vs plain ({nets}, seed {seed})")
        check(not control[-1], f"resample control passes ({nets}, seed {seed})")
        check(bool((got[:, 1:] >= got[:, :-1]).all()), "resampled depths sorted")
        worst = max(worst, sound[2])
    return worst


def dnerf_whole_step_vs_plain(spec, rspec, scene, dev) -> None:
    """Phase 25: one EndoNeRF train step (batch, render, losses, backward)
    with the kernels against one with the plain segments and resample, same
    params and draws, in each dot mode; the control runs the kernels at the
    other precision and must fail."""
    from endosurf_tpu_torch.bridge import flatten
    from endosurf_tpu_torch.kernels import fused_sampler as fs
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    from endosurf_tpu_torch.models.endonerf import init_dnerf_params
    from endosurf_tpu_torch.train.trainer_endonerf import LOSS_WEIGHT_KEYS, make_loss_fn
    weights = {k: 1.0 for k in LOSS_WEIGHT_KEYS}
    params = init_dnerf_params(spec, torch.Generator().manual_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    n0, k = rspec.n_samples, rspec.n_samples + rspec.n_importance
    draws = {"frame": torch.tensor(1, device=dev),
             "u_pix": torch.rand(DN_RAY_BATCH, generator=gen, device=dev),
             "z": torch.randn(DN_RAY_BATCH, n0, generator=gen, device=dev),
             "noise_c": torch.randn(DN_RAY_BATCH * n0, generator=gen, device=dev),
             "noise_f": torch.randn(DN_RAY_BATCH * k, generator=gen, device=dev)}
    field, resample = ftd.megakernel_field_raw, fs.fused_fine_resample

    def step(prec, field_fn, resample_fn):
        ftd.megakernel_field_raw, fs.fused_fine_resample = field_fn, resample_fn
        try:
            fn = make_loss_fn(spec, rspec, H, W, DN_RAY_BATCH, weights, precision=prec,
                              sampling_precision=prec)
            for v in flatten(params).values():
                v.requires_grad_(True)
                v.grad = None
            total, metrics = fn(params, scene.device_arrays, None, draws)
            total.backward()
        finally:
            ftd.megakernel_field_raw, fs.fused_fine_resample = field, resample
        return ({kk: float(v.detach()) for kk, v in metrics.items()},
                {kk: v.grad.clone() for kk, v in flatten(params).items()})

    for prec, other in (("highest", "default"), ("default", "highest")):
        mp, gp = step(prec, ftd.plain_field_raw, fs.fused_fine_resample_reference)
        runs = {"sound": step(prec, field, resample),
                f"control (kernels {other})": step(
                    prec, lambda s_, p_, x, d, t, _prec: field(s_, p_, x, d, t, other), resample)}
        m_tol, g_tol = DN_WHOLE_STEP_TOL[prec]
        for what, (mk, gk) in runs.items():
            m_rel = {kk: abs(mk[kk] - mp[kk]) / (abs(mp[kk]) + 1e-6) for kk in mp}
            g_rel = {}
            for net in ("deform", "density", "color"):
                keys = [kk for kk in gk if kk.startswith(net + "/")]
                diff = sum(float(((gk[kk] - gp[kk]) ** 2).sum()) for kk in keys) ** 0.5
                norm = sum(float((gp[kk] ** 2).sum()) for kk in keys) ** 0.5
                g_rel[net] = diff / max(norm, 1e-30)
            print(f"dnerf train step kernels vs plain ({prec}, {what}): metrics "
                  + ", ".join(f"{kk[5:]} {v:.3e}" for kk, v in m_rel.items())
                  + f" (tol {m_tol:g}); gradients " + ", ".join(
                      f"{kk} {v:.3e} (tol {g_tol[kk]:g})" for kk, v in g_rel.items()),
                  flush=True)
            ok = (all(v <= m_tol for v in m_rel.values())
                  and all(v <= g_tol[kk] for kk, v in g_rel.items()))
            if what == "sound":
                check(ok, f"dnerf step {prec} kernels vs plain: {m_rel} {g_rel}")
            else:
                check(not ok, f"dnerf step {prec}: the kernels at {other} pass the limits")


# the EndoNeRF step's kernels listed one by one in its trace (phase 26)
DN_DETAIL = ("dnerf_deform_bwd", "dnerf_density_bwd", "dnerf_color_bwd", "wgrad_",
             "dnerf_deform_fwd", "dnerf_density_fwd", "dnerf_color_fwd")
DN_FAMILIES = (("D-NeRF segment kernels", ("dnerf_", "wgrad_")),
               ("coarse density sweep", ("sweep_kernel", "dn_sweep_tc_kernel")),
               ("resample", ("dn_fine_resample_kernel",)))


def dnerf_train_phase(scene, dev, smi: str):
    """Phase 26: EndoNeRFTrainer.start on the in-memory config, N_WARM steps
    then the rest; launches, losses, checkpoint, rays/s and peak memory, the
    step split and trace, then trainer.eval. Returns ({kernel: launches in
    the run}, render launches of the eval)."""
    import numpy as np

    from endosurf_tpu_torch.evaluation import render_eval
    from endosurf_tpu_torch.kernels import fused_render_dnerf as frd
    from endosurf_tpu_torch.kernels import fused_sampler as fs
    from endosurf_tpu_torch.kernels import fused_sdf as fsd
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    from endosurf_tpu_torch.train.checkpoint import load_checkpoint
    from endosurf_tpu_torch.train.trainer_endonerf import EndoNeRFTrainer, make_loss_fn
    with tempfile.TemporaryDirectory() as exp_root:
        trainer = EndoNeRFTrainer(endonerf_train_cfg(exp_root), mode="train", scene=scene,
                                  device=dev)
        for kk in ftd.LAUNCHES:
            ftd.LAUNCHES[kk] = 0
        fs.LAUNCHES["fused_fine_resample"] = 0
        fsd.LAUNCHES["fused_density_raw"] = 0
        frd.LAUNCHES["fused_render_rays_dnerf"] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.start(log_every=N_STEPS, stop_after=N_WARM)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.start(log_every=N_STEPS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = {**ftd.LAUNCHES, "fused_fine_resample": fs.LAUNCHES["fused_fine_resample"],
                    "fused_density_raw": fsd.LAUNCHES["fused_density_raw"]}
        check(all(v == N_STEPS for v in launches.values()),
              f"EndoNeRF train launches {launches} for {N_STEPS} steps")
        check(frd.LAUNCHES["fused_render_rays_dnerf"] == 0, "training launched the render kernel")
        metrics = {}
        with open(os.path.join(trainer.exp_dir, "logs", "metrics.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                if rec["tag"].startswith("train/loss"):
                    metrics.setdefault(rec["step"], {})[rec["tag"]] = rec["value"]
        check(sorted(metrics) == [1, N_STEPS]
              and all(len(m) == 3 and all(math.isfinite(v) for v in m.values())
                      for m in metrics.values()), f"EndoNeRF losses {metrics}")
        restored = load_checkpoint(trainer.exp_dir, dev)
        check(restored is not None and restored["n_iter"] == N_STEPS, "checkpoint written")
        for name, net in trainer.params.items():
            for a, b in zip(restored["params"][name]["layers"], net["layers"]):
                check(all(torch.equal(a[kk], b[kk].detach()) for kk in b), f"checkpoint {name}")
        step_ms = (t2 - t1) / (N_STEPS - N_WARM) * 1e3
        print(f"dnerf train: {N_STEPS} steps x {DN_RAY_BATCH} rays, warm-up {t1 - t0:.2f} s for "
              f"{N_WARM}, then {step_ms:.1f} ms/step, {DN_RAY_BATCH / step_ms * 1e3:.0f} rays/s "
              f"({smi}); peak memory {peak_gib:.2f} GiB; launches {launches}; step {N_STEPS}: "
              + ", ".join(f"{kk[6:]} {v:.4f}" for kk, v in metrics[N_STEPS].items())
              + f"; step 1: " + ", ".join(f"{kk[6:]} {v:.4f}" for kk, v in metrics[1].items()),
              flush=True)

        loss_fn = make_loss_fn(trainer.spec, trainer.rspec, scene.h, scene.w, DN_RAY_BATCH,
                               trainer.loss_weights, precision=trainer.precision,
                               sampling_precision=trainer.sampling_precision)
        names = train_step_split(trainer, lambda s: loss_fn(trainer.params, scene.device_arrays,
                                                            trainer.generator)[0],
                                 DN_FAMILIES, step_ms, smi, label="dnerf train step",
                                 detail=DN_DETAIL)
        # bf16: the colour forward on tensor cores (where this process's
        # trace recorded device kernels; phase 29 traces it in a fresh one)
        check(not names or (any("dnerf_color_fwd_tc_kernel" in k for k in names)
                            and not any("dnerf_color_fwd_kernel" in k for k in names)),
              f"EndoNeRF step kernels: {sorted(names)}")

        # eval: every test frame through the render kernel; the composites
        # are not written (the card machine has no imageio)
        frd.LAUNCHES["fused_render_rays_dnerf"] = 0
        t0 = time.perf_counter()
        eval_frames = render_eval.eval_frames
        render_eval.eval_frames = functools.partial(eval_frames, save_images=False)
        try:
            stats = trainer.eval(N_STEPS)
        finally:
            render_eval.eval_frames = eval_frames
        torch.cuda.synchronize()
        eval_launches = frd.LAUNCHES["fused_render_rays_dnerf"]
        n_chunks = math.ceil(H * W / CHUNK) * len(scene.list_test)
        print(f"dnerf train eval: {len(scene.list_test)} test frame(s) in "
              f"{time.perf_counter() - t0:.2f} s, {eval_launches} render kernel launches; "
              + ", ".join(f"{kk} {v:.4f}" for kk, v in stats.items()), flush=True)
        check(eval_launches == n_chunks, f"{eval_launches} eval render launches, {n_chunks} chunks")
        check(all(math.isfinite(v) for v in stats.values()), f"finite eval metrics {stats}")
        check(np.isfinite(peak_gib), "peak memory")
    return launches, eval_launches


def simt_note(name: str, flops: float, k_ms: float, call) -> str:
    """For a kernel with a tensor-core version (fused_train_dnerf.TC_KERNELS),
    its SIMT bf16 kernel's time (``call(simt=True)``) and both TFLOP/s, as a
    note; else nothing."""
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    if name not in ftd.TC_KERNELS:
        return ""
    simt_ms = cuda_ms(lambda: call(simt=True), 2)
    return (f"; the SIMT bf16 kernel {simt_ms:.3f} ms; tensor cores "
            f"{flops / k_ms / 1e9:.2f} TFLOP/s, SIMT {flops / simt_ms / 1e9:.2f}")


# Phase 29: one kernel of fused_train_dnerf.TC_KERNELS, in bf16 and with
# simt=True, on 4096 points of the full seeded nets, each traced by
# torch.profiler after a warm-up call; prints {mode: {device kernel name:
# launches}}. Also the march ("fused_ray_march": 1024 rays, bf16 and
# simt=True) and the D-NeRF field of a train step ("dnerf_field": forward
# and backward, bf16 and, as its "SIMT" mode, float32).
_NAMES_SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
from endosurf_tpu_torch.models.endonerf import DNeRFSpec, init_dnerf_params
from endosurf_tpu_torch.models.fields import EndoSurfSpec, init_endosurf_params
kernel, dev = sys.argv[2], torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
x = torch.rand(4096, 3, generator=g, device=dev) * 1.6 - 0.8
d = torch.randn(4096, 3, generator=g, device=dev)
t = torch.rand(4096, 1, generator=g, device=dev)
run = ftd.TC_KERNELS[kernel][2] if kernel in ftd.TC_KERNELS else None
if kernel == "fused_ray_march":
    from endosurf_tpu_torch.kernels import fused_sampler as fs
    from endosurf_tpu_torch.ops.geometry import ray_sphere_intersection
    spec = EndoSurfSpec()
    o = torch.cat([x[:1024, :2] * 0.4, torch.full((1024, 1), -1.5, device=dev)], -1)
    v = x[1024:2048] * 0.25 - o
    v = v / v.norm(dim=-1, keepdim=True)
    near, far, _ = ray_sphere_intersection(o, v)
    args = (spec, init_endosurf_params(spec, torch.Generator().manual_seed(0), dev), o, v,
            t[:1024], near, far)
    def run(spec, params, *ins, simt):
        return fs.fused_ray_march_cuda(spec, params, *ins, sampling_dtype=torch.bfloat16,
                                       simt=simt)
elif kernel == "dnerf_field":
    from endosurf_tpu_torch.bridge import flatten, unflatten
    spec = DNeRFSpec()
    leaves = {k: v.requires_grad_(True) for k, v in flatten(
        init_dnerf_params(spec, torch.Generator().manual_seed(0), dev)).items()}
    args = (spec, unflatten(leaves))
    def run(spec, params, simt):
        rgb, raw = ftd.megakernel_field_raw(spec, params, x, d / d.norm(dim=-1, keepdim=True),
                                            t, "highest" if simt else "default")
        (rgb.sum() + raw.sum()).backward()
elif kernel == "fused_sdf_observed":
    spec = EndoSurfSpec()
    args = (spec, init_endosurf_params(spec, torch.Generator().manual_seed(0), dev), None, None,
            x, t)
else:
    spec = DNeRFSpec()
    params = init_dnerf_params(spec, torch.Generator().manual_seed(0), dev)
    _, _, cases = ftd.bwd_segment_parity(spec, params, x, d, t, "default")
    seg = kernel.split("_")[1]
    packed, like, _, inputs, cots = cases[f"dnerf_{seg}_bwd"]
    args = (spec, params, *(
        (None, None, x, t) if kernel == "fused_density_raw" else
        (packed, None, *inputs) if kernel.endswith("_fwd") else (packed, like, *inputs, *cots)))
names = {}
for mode, simt in (("tensor cores", False), ("SIMT", True)):
    run(*args, simt=simt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(*args, simt=simt)
        torch.cuda.synchronize()
    names[mode] = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            k = e.key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
            names[mode][k] = names[mode].get(k, 0) + e.count
print(json.dumps(names))
"""


def tc_kernel_names() -> None:
    """Phase 29: the device kernels each fused_train_dnerf.TC_KERNELS kernel,
    the march and the D-NeRF field of a train step launch in bf16 and with
    simt=True (the field: in float32) (_NAMES_SCRIPT, a fresh process a
    kernel, as the card tests trace them): the bf16 call must launch a
    tensor-core kernel, the other none; the bf16 march the tensor-core sweep
    for its scan and each of its 8 secant steps and no SIMT sweep; the bf16
    field the tensor-core colour forward and no SIMT segment kernel."""
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    root = os.path.dirname(os.path.abspath(__file__))
    for kernel in [*ftd.TC_KERNELS, "fused_ray_march", "dnerf_field"]:
        out = subprocess.run([sys.executable, "-c", _NAMES_SCRIPT, root, kernel],
                             capture_output=True, text=True, timeout=300)
        check(out.returncode == 0, f"tracing {kernel}: {out.stderr[-2000:]}")
        names = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"{kernel} kernels (torch.profiler, launches): " + "; ".join(
            f"{mode} " + ", ".join(f"{k} x{n}" for k, n in sorted(ks.items()))
            for mode, ks in names.items()), flush=True)
        check(any("_tc_" in k for k in names["tensor cores"])
              and not any("_tc_" in k for k in names["SIMT"]), f"{kernel} kernels: {names}")
        tc = names["tensor cores"]
        if kernel == "fused_ray_march":
            check(sum(n for k, n in tc.items() if "sweep_tc_kernel" in k) == 9
                  and not any("sweep_kernel<" in k for k in tc), f"bf16 march kernels: {tc}")
        if kernel == "dnerf_field":
            check(any("dnerf_color_fwd_tc_kernel" in k for k in tc)
                  and not any(k.startswith(f"dnerf_{seg}_{d}_kernel")
                              for k in tc for seg in ftd.SEGMENTS for d in ("fwd", "bwd")),
                  f"bf16 D-NeRF field kernels: {tc}")


def dnerf_fwd_timing(spec, params, bwd_cases, n, what: str) -> dict:
    """Phase 27: the three forward kernels against their plain versions on
    the inputs of bf16 backward cases (bwd_segment_parity's; the first n
    points, all with None), bf16, beside their bounds and TFLOP/s, and a
    tensor-core kernel's SIMT one: {f"{kernel} ({n} {what})": (kernel ms,
    plain ms, bound ms, bounded by)}."""
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    packed = bwd_cases["dnerf_density_bwd"][0]
    inputs = {seg: tuple(v[:n] for v in bwd_cases[f"dnerf_{seg}_bwd"][3])
              for seg in ("deform", "density", "color")}
    n = inputs["density"][0].shape[0]
    work, plain = dnerf_fwd_work(spec, params, n), dnerf_fwd_plain(spec, params)
    out = {}
    for seg, ins in inputs.items():
        name = f"dnerf_{seg}_fwd"
        with torch.no_grad():
            times = (cuda_ms(lambda: ftd.FWD[seg](packed, *ins), 3),
                     cuda_ms(lambda: plain[name](*ins), 3))
            simt = simt_note(name, work[name][0], times[0],
                             functools.partial(ftd.FWD[seg], packed, *ins))
        out[f"{name} ({n} {what})"] = (*times, *bound_ms(*work[name], torch.bfloat16))
        print(f"{name}: {n} {what}, {work[name][0] / 1e12:.4f} TFLOP, "
              f"{work[name][1] / 1e6:.1f} MB, {work[name][0] / times[0] / 1e9:.2f} TFLOP/s, "
              f"{work[name][1] / times[0] / 1e6:.1f} GB/s{simt}", flush=True)
    return out


def dnerf_train_timing(spec, rspec, bwd_cases, resample_in, smi: str, params=None,
                       coarse=None) -> dict:
    """Phase 27: device ms of the three backward kernels, the three forward
    ones, the coarse pass's raw density query and the resample against their
    plain versions at the train shape, bf16, with (bound ms, bounded by)
    from the shapes: a backward's recompute, input-cotangent and
    weight-gradient products; per-point inputs and outputs once, bf16
    weights, float32 gradients. The forward kernels run on the backward
    cases' inputs, the raw density query on the train batch's ``coarse``
    points (``params``: the cases' parameters, for the forward bounds;
    without them neither is timed). Beside a kernel with a tensor-core
    version (bf16), its SIMT kernel."""
    from endosurf_tpu_torch.kernels import fused_sampler as fs
    from endosurf_tpu_torch.kernels import fused_sdf as fsd
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    bf = torch.bfloat16
    out = {}
    f = spec.geo_feat_dim
    for name, (packed, like, flat, inputs, cots) in bwd_cases.items():
        seg = name.split("_")[1]
        n = inputs[0].shape[0]
        layout = packed.layout(seg)
        fwd_macs = sum(i * o for _, _, i, o in layout)
        skip = {"deform": spec.deform_layers, "density": spec.density_layers,
                "color": spec.color_layers}[seg][2]
        enc = layout[0][2]

        def cot_rows(l, n_in):
            """Input rows a layer's cotangent reaches: every row for the
            density net (d x_c goes through the encoding), the h rows for
            the others, the feature rows of the colour net's first layer."""
            if seg == "density":
                return n_in
            if l == 0:
                return f if seg == "color" else 0
            return n_in - enc if l in skip else n_in
        cot_macs = sum(cot_rows(l, i) * o for l, (_, _, i, o) in enumerate(layout))
        flops = 2.0 * n * (2 * fwd_macs + cot_macs)
        io = {"deform": 4 + 3, "density": 3 + 1 + f + 3, "color": 3 + f + 3 + f}[seg]
        w_bytes = sum(i * o + o for _, _, i, o in layout) * (2 + 4)
        times = (cuda_ms(lambda: ftd.BWD[seg](packed, like, *inputs, *cots), 2),
                 cuda_ms(lambda: ftd.plain_bwd(spec, seg, like, flat, inputs, cots, "default"), 2))
        out[name] = (*times, *bound_ms(flops, n * io * 4 + w_bytes, bf))
        simt = simt_note(name, flops, times[0], functools.partial(
            ftd.BWD[seg], packed, like, *inputs, *cots))
        print(f"{name}: {n} points, {flops / 1e12:.4f} TFLOP (recompute, input cotangents, "
              f"weight gradients){simt}", flush=True)
    if params is not None:
        out.update(dnerf_fwd_timing(spec, params, bwd_cases, None, "train points"))
    if params is not None and coarse is not None:
        n = coarse[0].shape[0]
        flops = 2.0 * n * (net_macs(params, "deform") + net_macs(params, "density", 1))
        with torch.no_grad():
            times = (cuda_ms(lambda: fsd.fused_density_raw_cuda(spec, params, *coarse, bf), 5),
                     cuda_ms(lambda: fsd.fused_density_raw_reference(spec, params, *coarse, bf),
                             5))
            simt = simt_note("fused_density_raw", flops, times[0], functools.partial(
                fsd.fused_density_raw_cuda, spec, params, *coarse, bf))
        out[f"fused_density_raw ({n} coarse points)"] = (*times, *bound_ms(
            flops, n * (3 + 1 + 1) * 4 + _param_bytes(params, ("deform", "density"), bf), bf))
        print(f"fused_density_raw: {n} coarse points of the train batch, {flops / 1e12:.4f} "
              f"TFLOP, {flops / times[0] / 1e9:.2f} TFLOP/s{simt}", flush=True)
    z0, sigma, dn = resample_in
    n_rays, n0 = z0.shape
    k = n0 + rspec.n_importance
    times = (cuda_ms(lambda: fs.fused_fine_resample_cuda(z0, sigma, dn, rspec.n_importance), 10),
             cuda_ms(lambda: fs.fused_fine_resample_reference(z0, sigma, dn,
                                                              rspec.n_importance), 10))
    out["fused_fine_resample"] = (*times, *bound_ms(2.0 * n_rays * n0 * rspec.n_importance,
                                                    n_rays * (2 * n0 + 1 + k) * 4,
                                                    torch.float32))
    for name, (k_ms, p_ms, b_ms, b_by) in out.items():
        print(f"{name} timing (bf16, {smi}): kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms; bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)
    return out


def smooth_scene(h: int, w: int, dev):
    """A static 4-frame scene with smooth colour and depth (a tilted,
    rippled plane), for phase 28."""
    import numpy as np

    from endosurf_tpu_torch.data.scene_data import SceneData
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    depth = 1.8 + 0.15 * xx + 0.1 * np.sin(3 * yy)
    color = np.stack([0.5 + 0.4 * np.sin(2 * xx + yy), 0.5 + 0.4 * np.cos(3 * yy),
                      0.5 + 0.3 * xx * yy], -1)
    n = 4
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 0.8 * w
    K[0, 2], K[1, 2] = w / 2, h / 2
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -2.0
    ids = np.arange(n)
    return SceneData.from_arrays(
        dset_name="synthetic", scene_name="smooth",
        colors=np.tile(color[None], (n, 1, 1, 1)).astype(np.float32),
        depths=np.tile(depth[None, ..., None], (n, 1, 1, 1)).astype(np.float32),
        color_masks=np.ones((n, h, w, 1), np.float32),
        intrinsics=np.tile(K, (n, 1, 1)), poses=np.tile(pose, (n, 1, 1)),
        bounds=np.tile(np.array([1.0, 3.0], np.float32), (n, 1)),
        bbox_minmax=np.tile(np.array([[-1, 1], [-1, 1], [-1, 1]], np.float32), (n, 1, 1)),
        list_train=ids[:-1], list_test=ids[-1:], depth_scale=100.0, device=dev)


def dnerf_render_quality(dev, smi: str) -> None:
    """Phase 28: a checkpoint the port trains itself (DN_QUALITY steps, bf16,
    base.yml's settings) on smooth_scene, its test frame rendered through
    the render kernel in bf16 and in float32."""
    from endosurf_tpu_torch.evaluation.render_eval import eval_frames
    from endosurf_tpu_torch.train.trainer_endonerf import EndoNeRFTrainer
    h, w, n_steps = DN_QUALITY
    scene = smooth_scene(h, w, dev)
    with tempfile.TemporaryDirectory() as exp_root:
        trainer = EndoNeRFTrainer(endonerf_train_cfg(exp_root, n_steps), mode="train",
                                  scene=scene, device=dev)
        t0 = time.perf_counter()
        trainer.start(log_every=n_steps)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        res = {}
        for prec in ("default", "highest"):
            trainer.precision = trainer.sampling_precision = prec
            res[prec] = eval_frames(trainer, scene.list_test, n_steps, ray_chunk=CHUNK,
                                    save_dir_name=f"quality_{prec}", save_images=False)
        check(all(math.isfinite(v) for r in res.values() for v in r.values()),
              f"finite quality metrics {res}")
        print(f"dnerf bf16 render quality ({smi}): {n_steps} train steps on a smooth {h}x{w} "
              f"scene in {train_s:.1f} s; test frame bf16 " + ", ".join(
                  f"{kk} {v:.4f}" for kk, v in res["default"].items()) + "; float32 " + ", ".join(
                  f"{kk} {v:.4f}" for kk, v in res["highest"].items()) + "; bf16 - float32: "
              + ", ".join(f"{kk} {res['default'][kk] - res['highest'][kk]:+.4f}"
                          for kk in res["default"]), flush=True)


def train_only(smi: str) -> int:
    """``--train-only``: the build, then phase 7's timed run, split and
    trace."""
    from endosurf_tpu_torch.data.scene_data import make_synthetic_arrays
    from endosurf_tpu_torch.kernels import build
    build.load_library()
    dev = torch.device("cuda")
    scene = make_synthetic_arrays(n_frames=4, h=H, w=W, seed=0, device=dev)
    with tempfile.TemporaryDirectory() as exp_root:
        trainer, warm_s, train_s, peak_gib = timed_train(scene, dev, exp_root)
        step_ms = train_s / (N_STEPS - N_WARM) * 1e3
        print(f"train ({os.path.dirname(os.path.abspath(__file__))}): warm-up {warm_s:.2f} s "
              f"for {N_WARM}, then {step_ms:.1f} ms/step, "
              f"{RAY_BATCH / step_ms * 1e3:.0f} rays/s ({smi}); peak memory {peak_gib:.2f} GiB",
              flush=True)
        endosurf_step_split(trainer, step_ms, smi)
    return 0


def dnerf_train_only(smi: str) -> int:
    """``--dnerf-train-only``: the build, then phase 26's timed EndoNeRF run
    (N_WARM steps, then the rest), its peak memory, split and trace."""
    from endosurf_tpu_torch.data.scene_data import make_synthetic_arrays
    from endosurf_tpu_torch.kernels import build
    from endosurf_tpu_torch.train.trainer_endonerf import EndoNeRFTrainer, make_loss_fn
    build.load_library()
    dev = torch.device("cuda")
    scene = make_synthetic_arrays(n_frames=4, h=H, w=W, seed=0, device=dev)
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as exp_root:
        trainer = EndoNeRFTrainer(endonerf_train_cfg(exp_root), mode="train", scene=scene,
                                  device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.start(log_every=N_STEPS, stop_after=N_WARM)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.start(log_every=N_STEPS)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t1) / (N_STEPS - N_WARM) * 1e3
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"dnerf train ({root}): warm-up {t1 - t0:.2f} s for {N_WARM}, then "
              f"{step_ms:.1f} ms/step, {DN_RAY_BATCH / step_ms * 1e3:.0f} rays/s ({smi}); peak "
              f"memory {peak_gib:.2f} GiB", flush=True)
        loss_fn = make_loss_fn(trainer.spec, trainer.rspec, scene.h, scene.w, DN_RAY_BATCH,
                               trainer.loss_weights, precision=trainer.precision,
                               sampling_precision=trainer.sampling_precision)
        train_step_split(trainer, lambda s: loss_fn(trainer.params, scene.device_arrays,
                                                    trainer.generator)[0],
                         DN_FAMILIES, step_ms, smi, label="dnerf train step", detail=DN_DETAIL)
    return 0


def dnerf_segments_only(smi: str) -> int:
    """``--dnerf-segments-only``: the build, phase 23's bf16 seed-0 sound
    parity on a train batch's 262,144 fine points, then phase 27's timing of
    the segment kernels there and of the forward ones on the first 65,536,
    and, where the checkout has tensor-core D-NeRF kernels, phase 23's
    float64 readings."""
    from endosurf_tpu_torch.data.scene_data import make_synthetic_arrays
    from endosurf_tpu_torch.kernels import build
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    from endosurf_tpu_torch.models.endonerf import DNeRFRenderSpec, DNeRFSpec, init_dnerf_params
    build.load_library()
    dev = torch.device("cuda")
    ncfg = endonerf_cfg()
    spec, rspec = DNeRFSpec.from_config(ncfg["net"]), DNeRFRenderSpec.from_config(ncfg["render"])
    scene = make_synthetic_arrays(n_frames=4, h=H, w=W, seed=0, device=dev)
    params = init_dnerf_params(spec, torch.Generator().manual_seed(0), dev)
    x, d, t, resample_in, coarse = dnerf_train_batch(spec, rspec, params, scene,
                                                torch.Generator(device=dev).manual_seed(7), dev)
    root = os.path.dirname(os.path.abspath(__file__))
    res, _, cases = ftd.bwd_segment_parity(spec, params, x, d, t, "default", 0)
    torch.cuda.synchronize()
    for name, kinds in res.items():
        worst = max(v[0] for v in kinds["leaf"].values())
        print(f"dnerf bwd sound seed 0 default {name} ({x.shape[0]} points, {root}): " + "".join(
            f"d {k} median {v[0]:.3e} p99 {v[1]:.3e} max {v[2]:.3e}; "
            for k, v in kinds["cot"].items()) + f"worst leaf rel L2 {worst:.3e}", flush=True)
    check(ftd.bwd_parity_ok(res), "dnerf backward kernels vs plain (bf16, seed 0)")
    del x, d, t
    dnerf_train_timing(spec, rspec, cases, resample_in, f"{smi}, {root}", params, coarse)
    for k, (k_ms, p_ms, b_ms, b_by) in dnerf_fwd_timing(spec, params, cases, 65536,
                                                        "points").items():
        print(f"{k} timing (bf16, {smi}, {root}): kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms; "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    n = cases["dnerf_density_bwd"][3][0].shape[0]
    tc_f64_train_readings(spec, params, cases, f"seed 0 ({n} points, {root})")
    density_raw_coarse_parity(spec, params, coarse,
                              f"seed 0 ({coarse[0].shape[0]} coarse points, {root})")
    return 0


def march_only(smi: str) -> int:
    """``--march-only``: the build, phase 14's march parity and float64
    readings and phase 16's timing (the grid query's and the march's, its
    scan and secant phase apart)."""
    from endosurf_tpu_torch.data.scene_data import make_synthetic_arrays
    from endosurf_tpu_torch.kernels import build
    from endosurf_tpu_torch.models.fields import EndoSurfSpec
    build.load_library()
    dev = torch.device("cuda")
    spec = EndoSurfSpec.from_config(base_cfg()["net"])
    scene = make_synthetic_arrays(n_frames=4, h=H, w=W, seed=0, device=dev)
    march_parity(spec, scene, dev)
    new_kernel_timing(spec, scene, dev, smi)
    return 0


def march_train_only(smi: str) -> int:
    """``--march-train-only``: the build, then phase 15's timed run with the
    sphere trace, its split and trace."""
    from endosurf_tpu_torch.data.scene_data import make_synthetic_arrays
    from endosurf_tpu_torch.kernels import build
    build.load_library()
    dev = torch.device("cuda")
    scene = make_synthetic_arrays(n_frames=4, h=H, w=W, seed=0, device=dev)
    print(f"march train ({os.path.dirname(os.path.abspath(__file__))})", flush=True)
    march_train_phase(base_cfg(), scene, dev, smi)
    return 0


def segments_only(smi: str) -> int:
    """``--segments-only``: the build, phase 9's bf16 seed-0 sound parity on
    a train batch's midpoints, phase 11's timing, phase 6's float64 readings
    of the bf16 upsample and phase 8's timing."""
    from endosurf_tpu_torch.data.scene_data import make_synthetic_arrays
    from endosurf_tpu_torch.kernels import build
    from endosurf_tpu_torch.kernels import fused_train_cuda as ftc
    from endosurf_tpu_torch.models.endosurf import RenderSpec
    from endosurf_tpu_torch.models.fields import EndoSurfSpec, init_endosurf_params
    build.load_library()
    dev = torch.device("cuda")
    cfg = base_cfg()
    spec, rspec = EndoSurfSpec.from_config(cfg["net"]), RenderSpec.from_config(cfg["render"])
    scene = make_synthetic_arrays(n_frames=4, h=H, w=W, seed=0, device=dev)
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    x, d, t = train_midpoints(spec, rspec, params, scene.device_arrays,
                              torch.Generator(device=dev).manual_seed(3), dev)
    res, _, cases = ftc.segment_parity(spec, params, x, d, t, "default", 0)
    torch.cuda.synchronize()
    root = os.path.dirname(os.path.abspath(__file__))
    print_segment_readings(res, f"sound seed 0 default ({x.shape[0]} points, {root})",
                           torch.bfloat16)
    work = segment_work(params, x.shape[0])
    for k, (k_ms, p_ms) in segment_timing(spec, cases, 3).items():
        b_ms, b_by = bound_ms(*work[k], torch.bfloat16)
        print(f"segment timing {k} ({x.shape[0]} points, bf16, {smi}, {root}): kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.3f} ms; {work[k][0] / 1e12:.4f} TFLOP -> bound "
              f"{b_ms:.4f} ms ({b_by}); {work[k][0] / k_ms / 1e9:.2f} TFLOP/s", flush=True)
    check(ftc.parity_ok(res), "segment kernels vs plain out of tolerance (bf16, seed 0)")
    for seed in (0, 1):
        s_params = init_endosurf_params(spec, torch.Generator().manual_seed(seed), dev)
        up_in = upsample_inputs(scene.device_arrays, rspec, N_PARITY,
                                torch.Generator(device=dev).manual_seed(seed), dev)
        upsample_f64_readings(spec, rspec, s_params, up_in,
                              f"seed {seed} ({N_PARITY} rays, {root})")
    upsample_timing(spec, rspec, params, upsample_inputs(
        scene.device_arrays, rspec, RAY_BATCH, torch.Generator(device=dev).manual_seed(2), dev),
        smi, f", {root}")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from endosurf_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    if sys.argv[1:] == ["--train-only"]:
        return train_only(smi)
    if sys.argv[1:] == ["--segments-only"]:
        return segments_only(smi)
    if sys.argv[1:] == ["--dnerf-train-only"]:
        return dnerf_train_only(smi)
    if sys.argv[1:] == ["--dnerf-segments-only"]:
        return dnerf_segments_only(smi)
    if sys.argv[1:] == ["--march-only"]:
        return march_only(smi)
    if sys.argv[1:] == ["--march-train-only"]:
        return march_train_only(smi)
    if sys.argv[1:]:
        raise SystemExit(f"usage: {sys.argv[0]} [--train-only | --segments-only | "
                         "--dnerf-train-only | --dnerf-segments-only | --march-only | "
                         "--march-train-only]")

    import numpy as np

    from endosurf_tpu_torch.data.scene_data import frame_rays, make_synthetic_arrays
    from endosurf_tpu_torch.evaluation.render_eval import eval_frames
    from endosurf_tpu_torch.kernels import fused_render as fr
    from endosurf_tpu_torch.kernels import fused_sampler as fs
    from endosurf_tpu_torch.kernels import fused_train_cuda as ftc
    from endosurf_tpu_torch.models.endosurf import RenderSpec
    from endosurf_tpu_torch.models.fields import EndoSurfSpec, init_endosurf_params
    from endosurf_tpu_torch.native import build as native_build
    from endosurf_tpu_torch.serve import EndoSurfRenderer
    from endosurf_tpu_torch.train.checkpoint import load_checkpoint

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build_library()
    build.load_library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    t0 = time.perf_counter()
    print(f"build: {native_build.build_library().name} (host geometry) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 3. render parity on the card
    cfg = base_cfg()
    renderer_scene = make_synthetic_arrays(n_frames=4, h=H, w=W, seed=0, device=dev)
    spec = EndoSurfSpec.from_config(cfg["net"])
    rspec = RenderSpec.from_config(cfg["render"])
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    all_rays = frame_rays(renderer_scene.device_arrays, H, W, 3).reshape(-1, 9)
    rays = all_rays[:: all_rays.shape[0] // N_PARITY][:N_PARITY].contiguous()
    step = 30000.0
    args = (rspec.n_samples, rspec.n_importance, rspec.up_sample_steps, rspec.anneal_end)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    got, ref, errs = {}, {}, {}
    for name, dt in dtypes.items():
        got[name] = fr.fused_render_rays_cuda(spec, params, rays, step, *args, dt, dt)
        ref[name] = fr.fused_render_rays_reference(spec, params, rays, step, *args, dt, dt)
        torch.cuda.synchronize()
        errs[name] = fr.parity_errors(got[name], ref[name], dt)
        for k, (p99, mx, ok) in errs[name].items():
            bulk, loose = fr.PARITY_TOL[dt][k]
            print(f"parity {name} {k} ({N_PARITY} rays): max {mx:.3e} (tol {loose:g}), "
                  f"p99 {p99:.3e} (tol {bulk:g})", flush=True)
    bad = [(n, k) for n, e in errs.items() for k, v in e.items() if not v[2]]
    check(not bad, f"kernel vs plain twin out of tolerance: {bad}")
    for seed in (0, 1):
        render_f64_readings(spec, init_endosurf_params(spec, torch.Generator().manual_seed(seed),
                                                       dev),
                            rays, (step, *args), f"seed {seed} ({N_PARITY} rays)")
    # The limits must tell the precisions apart: the kernel at one dot
    # precision fails against the twin at the other.
    for k_name, t_name in (("float32", "bfloat16"), ("bfloat16", "float32")):
        ctl = fr.parity_errors(got[k_name], ref[t_name], dtypes[t_name])
        tol = fr.PARITY_TOL[dtypes[t_name]]
        print(f"control: kernel {k_name} vs twin {t_name}: " + "; ".join(
            f"{k} p99 {v[0]:.3e} (tol {tol[k][0]:g}) max {v[1]:.3e} (tol {tol[k][1]:g})"
            for k, v in ctl.items()), flush=True)
        check(not all(v[2] for v in ctl.values()),
              f"kernel {k_name} passes the {t_name} parity limits")

    # 4. serving end to end through the serving entry point
    renderer = EndoSurfRenderer(cfg, scene=renderer_scene, step=int(step), device=dev)
    fr.LAUNCHES["fused_render_rays"] = 0
    fs.LAUNCHES["fused_upsample_z"] = 0
    packs = fr.PACKS["render"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats, pred = eval_frames(renderer, renderer_scene.list_test[:1], int(step),
                              ray_chunk=cfg["train"]["eval"]["ray_chunk"],
                              save_images=False, return_pred=True)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    e2e_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = fr.LAUNCHES["fused_render_rays"]
    n_chunks = math.ceil(H * W / CHUNK)
    print(f"e2e: {H}x{W} frame in {e2e_s:.2f} s ({H * W / e2e_s:.0f} rays/s), "
          f"peak memory {e2e_peak:.2f} GiB, {launches} kernel launches for {n_chunks} chunks; "
          + ", ".join(f"{k} {v:.4f}" for k, v in stats.items()), flush=True)
    check(launches == n_chunks, f"{launches} kernel launches for {n_chunks} chunks")
    packs = fr.PACKS["render"] - packs
    print(f"e2e: {packs} render pack(s) built for the frame", flush=True)
    check(packs == 1, f"{packs} render packs for one frame on one parameter set")
    check(fs.LAUNCHES["fused_upsample_z"] == 0, "serving launched the upsample kernel")
    for k, ch in (("rgb", 3), ("depth", 1), ("normal", 3)):
        check(pred[k].shape == (1, H, W, ch), f"{k} map shape {pred[k].shape}")
        check(bool(np.isfinite(pred[k]).all()), f"{k} map finite")
    check(all(math.isfinite(v) for v in stats.values()), f"finite metrics {stats}")

    # 5. render timing on one main-path chunk, kernel vs plain, in each mode
    chunk = all_rays[:CHUNK].contiguous()
    bf = torch.bfloat16
    deform, sdf_hidden = net_macs(params, "deform_network"), net_macs(params, "sdf_network", 0)
    sdf_full, color = net_macs(params, "sdf_network"), net_macs(params, "color_network")
    chain = chain_macs(params)
    k_new = rspec.n_importance // rspec.up_sample_steps
    n_sweep = rspec.n_samples + k_new * (rspec.up_sample_steps - 1)
    n_field = rspec.n_samples + rspec.n_importance
    render_flops = 2 * CHUNK * (n_sweep * chain
                                + n_field * (4 * deform + sdf_full + sdf_hidden + color))
    render_bytes = (CHUNK * 9 * 4 * 2 + _param_bytes(
        params, ("deform_network", "sdf_network", "color_network"), bf))
    r_bound, r_by = bound_ms(render_flops, render_bytes, bf)
    times = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", bf)):
        def kern(dt=dt):
            return fr.fused_render_rays_cuda(spec, params, chunk, step, *args, dt, dt)
        k_ms = cuda_ms(kern, 5)
        p_ms = cuda_ms(lambda dt=dt: fr.fused_render_rays_reference(spec, params, chunk, step,
                                                                    *args, dt, dt), 5)
        times[name] = (k_ms, p_ms)
        print(f"timing {name} ({CHUNK} rays, {smi}): kernel {k_ms:.3f} ms "
              f"({CHUNK / k_ms * 1e3:.0f} rays/s, {render_flops / k_ms / 1e9:.2f} TFLOP/s), "
              f"plain {p_ms:.3f} ms ({CHUNK / p_ms * 1e3:.0f} rays/s); "
              f"{render_flops / 1e12:.3f} TFLOP -> bound {r_bound:.3f} ms ({r_by})", flush=True)
        if dt == bf:
            render_chunk_split(kern, smi)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                kern()
            call_host_ms = (time.perf_counter() - t0) / 5 * 1e3
            torch.cuda.synchronize()
            fr._RENDER_PACKS.clear()
            t0 = time.perf_counter()
            fr.pack_render(spec, params, dt)
            torch.cuda.synchronize()
            pack_ms = 1e3 * (time.perf_counter() - t0)
            print(f"render host time (bf16, {CHUNK} rays): a call with its pack cached "
                  f"{call_host_ms:.3f} ms to enqueue; packing {pack_ms:.3f} ms (once a "
                  f"parameter set)", flush=True)

    # 6. upsample parity on train-batch rays with perturbed z0, two seeds
    arrays = renderer_scene.device_arrays
    up_args = (rspec.n_importance, rspec.up_sample_steps)
    u_max_err = 0.0
    for seed in (0, 1):
        s_params = init_endosurf_params(spec, torch.Generator().manual_seed(seed), dev)
        up_in = upsample_inputs(arrays, rspec, N_PARITY,
                                torch.Generator(device=dev).manual_seed(seed), dev)
        upsample_f64_readings(spec, rspec, s_params, up_in, f"seed {seed} ({N_PARITY} rays)")
        ugot, uref = {}, {}
        for name, dt in dtypes.items():
            z, sdf = fs.fused_upsample_z_cuda(spec, s_params, *up_in, *up_args, dt, True)
            ugot[name] = {"z": z, "sdf": sdf}
            z, sdf = fs.fused_upsample_z_reference(spec, s_params, *up_in, *up_args, dt, True)
            uref[name] = {"z": z, "sdf": sdf}
        torch.cuda.synchronize()
        for k_name, k_dt in dtypes.items():
            for t_name, t_dt in dtypes.items():
                u_errs = fs.parity_errors(ugot[k_name], uref[t_name], t_dt)
                cons = fs.consistency_report(fs.consistency_errors(
                    spec, s_params, *up_in, ugot[k_name]["z"], ugot[k_name]["sdf"], *up_args,
                    t_dt), t_dt)
                tol = fs.PARITY_TOL[t_dt]
                what = "sound" if k_name == t_name else "control"
                for k, (med, p99, mx, share, _) in u_errs.items():
                    print(f"upsample {what} seed {seed} kernel {k_name} twin {t_name} {k} "
                          f"({N_PARITY} rays): median {med:.3e} (tol {tol['median']:g}), p99 "
                          f"{p99:.3e} (tol {tol['p99']:g}), max {mx:.3e} (tol "
                          f"{tol['max'][k]:g}), over {tol['share'][0]:g} {100 * share:.2f} % "
                          f"(tol {100 * tol['share'][1]:g} %)", flush=True)
                (kept,), _ = cons["kept"]
                (sp_med, sp_share, sp_max), _ = cons["sdf_point"]
                (judged, worst), _ = cons["draw"]
                print(f"upsample {what} seed {seed} kernel {k_name} consistency at {t_name}: "
                      f"z0 kept on {100 * kept:.2f} % of rays; sdf at its own z: median "
                      f"{sp_med:.3e}, {100 * sp_share:.2f} % over "
                      f"{fs.CONSISTENCY_TOL[t_dt]['sdf_point'][1][0]:g}, max {sp_max:.3e}; "
                      f"draws replayed: {100 * judged:.2f} % of rays judged, worst "
                      f"{worst:.3e} of the error model", flush=True)
                ok = all(v[-1] for v in u_errs.values()) and all(v[1] for v in cons.values())
                if k_name == t_name:
                    check(ok, f"upsample kernel vs plain twin out of tolerance ({k_name}, "
                              f"seed {seed}): {u_errs} {cons}")
                else:   # the limits must tell the precisions apart
                    check(not ok, f"upsample kernel {k_name} passes the {t_name} limits")
        u_max_err = max(u_max_err, max(v[2] for v in fs.parity_errors(
            ugot["bfloat16"], uref["bfloat16"], torch.bfloat16).values()))

    # 7. training end to end through the trainer's entry points
    with tempfile.TemporaryDirectory() as exp_root:
        fr.LAUNCHES["fused_render_rays"] = 0
        fs.LAUNCHES["fused_upsample_z"] = 0
        for k in ftc.LAUNCHES:
            ftc.LAUNCHES[k] = 0
        trainer, warm_s, train_s, peak_gib = timed_train(renderer_scene, dev, exp_root)
        train_launches = fs.LAUNCHES["fused_upsample_z"]
        seg_launches = dict(ftc.LAUNCHES)
        check(train_launches == N_STEPS,
              f"{train_launches} upsample launches for {N_STEPS} steps")
        check(all(v == N_STEPS for v in seg_launches.values()),
              f"segment kernel launches {seg_launches} for {N_STEPS} steps")
        check(fr.LAUNCHES["fused_render_rays"] == 0, "training launched the render kernel")
        metrics = {}
        with open(os.path.join(trainer.exp_dir, "logs", "metrics.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                if rec["tag"].startswith("train/loss"):
                    metrics.setdefault(rec["step"], {})[rec["tag"]] = rec["value"]
        check(sorted(metrics) == [1, N_STEPS], f"logged steps {sorted(metrics)}")
        check(all(len(m) == 7 and all(math.isfinite(v) for v in m.values())
                  for m in metrics.values()), f"every loss finite at steps 1, {N_STEPS}")
        restored = load_checkpoint(trainer.exp_dir, dev)
        check(restored is not None and restored["n_iter"] == N_STEPS, "checkpoint written")
        for name, layers in trainer.params.items():
            if name == "deviation_network":
                check(torch.equal(restored["params"][name]["variance"],
                                  layers["variance"].detach()), "checkpoint variance")
                continue
            for a, b in zip(restored["params"][name]["layers"], layers["layers"]):
                check(all(torch.equal(a[k], b[k].detach()) for k in b), f"checkpoint {name}")
        train_rps = (N_STEPS - N_WARM) * RAY_BATCH / train_s
        step_ms = train_s / (N_STEPS - N_WARM) * 1e3
        last = metrics[N_STEPS]
        print(f"train: {N_STEPS} steps x {RAY_BATCH} rays, warm-up {warm_s:.2f} s for "
              f"{N_WARM}, then {train_s:.3f} s for {N_STEPS - N_WARM} = "
              f"{step_ms:.1f} ms/step, {train_rps:.0f} rays/s "
              f"({smi}); peak memory {peak_gib:.2f} GiB; {train_launches} upsample launches; "
              f"segment kernel launches {seg_launches}; "
              f"step {N_STEPS}: " + ", ".join(f"{k[6:]} {v:.4f}" for k, v in last.items()),
              flush=True)
        endosurf_step_split(trainer, step_ms, smi)

    # 8. upsample timing on one train batch (the main path's shape), both modes
    tb_in = upsample_inputs(arrays, rspec, RAY_BATCH, torch.Generator(device=dev).manual_seed(2),
                            dev)
    utimes = upsample_timing(spec, rspec, params, tb_in, smi)
    print(f"train step breakdown (bf16): {step_ms:.1f} ms/step, upsample kernel call "
          f"{utimes['bfloat16'][0]:.3f} ms ({100 * utimes['bfloat16'][0] / step_ms:.1f} %), "
          f"rest {step_ms - utimes['bfloat16'][0]:.1f} ms", flush=True)

    # 9. field segment parity on a real train batch's midpoints
    x_mid, d_mid, t_mid = train_midpoints(spec, rspec, params, arrays,
                                          torch.Generator(device=dev).manual_seed(3), dev)
    seg_abs, seg_cases = segment_parity_phase(spec, x_mid, d_mid, t_mid, dev)

    # 10. the whole train step, segment kernels vs the plain field path
    whole_step_vs_plain(spec, rspec, renderer_scene, dev)

    # 11. segment timing at the train step's 65,536 points, bf16
    seg_times = segment_timing(spec, seg_cases, 3)
    seg_work = segment_work(params, x_mid.shape[0])
    seg_bounds = {k: bound_ms(*seg_work[k], torch.bfloat16) for k in seg_work}
    for k, (k_ms, p_ms) in seg_times.items():
        print(f"segment timing {k} ({x_mid.shape[0]} points, bf16, {smi}): kernel {k_ms:.3f} ms, "
              f"plain {p_ms:.3f} ms; {seg_work[k][0] / 1e12:.4f} TFLOP -> bound "
              f"{seg_bounds[k][0]:.4f} ms ({seg_bounds[k][1]}); "
              f"{seg_work[k][0] / k_ms / 1e9:.2f} TFLOP/s", flush=True)

    # 12-16. the 3D demo's grid query and the sphere-traced march
    sdf_abs = sdf_query_parity(spec, renderer_scene, dev)
    sdf_launches = demo_3d_phase(cfg, renderer_scene, dev)
    march_abs = march_parity(spec, renderer_scene, dev)
    packs = fs.PACKS["sampling"]
    march_launches = march_train_phase(cfg, renderer_scene, dev, smi)
    packs = fs.PACKS["sampling"] - packs   # the upsampling and the march share one a step
    print(f"march train: {packs} sampling packs for {fs.LAUNCHES['fused_ray_march']} march "
          f"steps (the split and trace included)", flush=True)
    check(packs == fs.LAUNCHES["fused_ray_march"], "one sampling pack a march train step")
    new_times = new_kernel_timing(spec, renderer_scene, dev, smi)

    # 17-22. the EndoNeRF vertical
    from endosurf_tpu_torch.models.endonerf import DNeRFRenderSpec, DNeRFSpec, init_dnerf_params
    from endosurf_tpu_torch.serve import EndoNeRFRenderer
    ncfg = endonerf_cfg()
    dn_spec, dn_rspec = DNeRFSpec.from_config(ncfg["net"]), DNeRFRenderSpec.from_config(
        ncfg["render"])
    with tempfile.TemporaryDirectory() as exp_root:
        ncfg["exp"]["exp_dir"] = exp_root
        nerf = EndoNeRFRenderer(ncfg, scene=renderer_scene, step=0, device=dev)
        dens_abs = density_raw_parity(dn_spec, renderer_scene, dev)
        dn_render_abs = dnerf_render_parity(dn_spec, dn_rspec, nerf, dev)
        dn_seg_abs, dn_seg_cases, n_dn_seg = dnerf_segment_parity(dn_spec, dn_rspec, nerf, dev)
        dn_render_launches = dnerf_serving_phase(nerf, smi)
    dens_launches, dn_seg_launches = dnerf_3d_phase(endonerf_cfg(), renderer_scene, dev)
    dn_times = dnerf_timing(dn_spec, dn_rspec, nerf, dn_seg_cases, n_dn_seg, smi)

    # 23-28. EndoNeRF training
    dn_params = init_dnerf_params(dn_spec, torch.Generator().manual_seed(0), dev)
    x_f, d_f, t_f, resample_in, coarse = dnerf_train_batch(
        dn_spec, dn_rspec, dn_params, renderer_scene, torch.Generator(device=dev).manual_seed(7),
        dev)
    dn_bwd_abs, dn_bwd_cases = dnerf_bwd_parity_phase(dn_spec, x_f, d_f, t_f, dev, coarse)
    del x_f, d_f, t_f
    resample_abs = dnerf_resample_phase(dn_spec, dn_rspec, renderer_scene, dev)
    dnerf_whole_step_vs_plain(dn_spec, dn_rspec, renderer_scene, dev)
    dn_train_launches, _ = dnerf_train_phase(renderer_scene, dev, smi)
    dn_train_times = dnerf_train_timing(dn_spec, dn_rspec, dn_bwd_cases, resample_in, smi,
                                        dn_params, coarse)
    del coarse
    del dn_bwd_cases
    dnerf_render_quality(dev, smi)

    # 29. the kernels the tensor-core calls launch, by name
    tc_kernel_names()

    # the kernel record: work, bounds and times at the main paths' shapes (bf16)
    upsample_flops = 2 * RAY_BATCH * n_field * chain        # return_sdf: every sample
    upsample_bytes = (RAY_BATCH * (7 + rspec.n_samples + 2 * n_field) * 4
                      + _param_bytes(params, ("deform_network", "sdf_network"), bf))
    u_bound, u_by = bound_ms(upsample_flops, upsample_bytes, bf)
    print(f"bounds (H100 SXM peaks, bf16 989 TFLOP/s, 3.35 TB/s): render {CHUNK} rays "
          f"{render_flops / 1e12:.3f} TFLOP -> {r_bound:.3f} ms ({r_by}); upsample "
          f"{RAY_BATCH} rays {upsample_flops / 1e12:.4f} TFLOP -> {u_bound:.4f} ms ({u_by})",
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {"name": "fused_render_rays", "route": "cuda",
         "source": "endosurf_tpu_torch/kernels/csrc/fused_render.cu",
         "replaces": "endosurf_tpu/kernels/fused_render.py:274",
         "launches": launches,
         "max_abs_err": max(v[1] for v in errs["bfloat16"].values()),
         "ms": times["bfloat16"][0], "plain_ms": times["bfloat16"][1],
         "bound_ms": r_bound, "bound_by": r_by, "library_ms": None},
        {"name": "fused_upsample_z", "route": "cuda",   # bf16: the sweeps on tensor cores
         "source": "endosurf_tpu_torch/kernels/csrc/sweep_tc.cuh",
         "replaces": "endosurf_tpu/kernels/fused_sampler.py:515",
         "launches": train_launches,
         "max_abs_err": u_max_err,
         "ms": utimes["bfloat16"][0], "plain_ms": utimes["bfloat16"][1],
         "bound_ms": u_bound, "bound_by": u_by, "library_ms": None}] + [
        {"name": k, "route": "cuda", "source": f"endosurf_tpu_torch/kernels/csrc/{src}",
         "replaces": f"endosurf_tpu/kernels/fused_train_pallas.py:{line}",
         "launches": seg_launches[k], "max_abs_err": seg_abs[k],
         "ms": seg_times[k][0], "plain_ms": seg_times[k][1],
         "bound_ms": seg_bounds[k][0], "bound_by": seg_bounds[k][1], "library_ms": None}
        for k, line, src in (("deform_fwd", 204, "field_tc.cuh"),   # bf16: tensor cores
                             ("deform_bwd", 217, "field_tc.cuh"),
                             ("sdf_fwd", 238, "field_tc.cuh"), ("sdf_bwd", 258, "field_tc.cuh"),
                             ("color_fwd", 284, "field_tc.cuh"),
                             ("color_bwd", 298, "field_tc.cuh"))] + [
        {"name": k, "route": "cuda", "source": f"endosurf_tpu_torch/kernels/csrc/{src}",
         "replaces": f"endosurf_tpu/kernels/{rep}", "launches": n_launch, "max_abs_err": err,
         "ms": new_times[k][0], "plain_ms": new_times[k][1], "bound_ms": new_times[k][2],
         "bound_by": new_times[k][3], "library_ms": None}
        for k, src, rep, n_launch, err in (
            ("fused_sdf_observed", "sweep_tc.cuh", "fused_sdf.py:424", sdf_launches, sdf_abs),
            ("fused_ray_march", "fused_sampler.cu", "fused_sampler.py:685", march_launches,
             march_abs))] + [
        {"name": k, "route": "cuda", "source": f"endosurf_tpu_torch/kernels/csrc/{src}",
         "replaces": f"endosurf_tpu/kernels/{rep}", "launches": n_launch, "max_abs_err": err,
         "ms": dn_times[k][0], "plain_ms": dn_times[k][1], "bound_ms": dn_times[k][2],
         "bound_by": dn_times[k][3], "library_ms": None}
        for k, src, rep, n_launch, err in (
            ("fused_density_raw", "fused_sdf.cu", "fused_sdf.py:442", dens_launches, dens_abs),
            ("fused_render_rays_dnerf", "fused_render_dnerf.cu", "fused_render_dnerf.py:246",
             dn_render_launches, dn_render_abs),
            ("dnerf_deform_fwd", "fused_train_dnerf.cu", "fused_train_dnerf.py:242",
             dn_seg_launches["dnerf_deform_fwd"], dn_seg_abs["dnerf_deform_fwd"]),
            ("dnerf_density_fwd", "fused_train_dnerf.cu", "fused_train_dnerf.py:271",
             dn_seg_launches["dnerf_density_fwd"], dn_seg_abs["dnerf_density_fwd"]),
            ("dnerf_color_fwd", "fused_train_dnerf.cu", "fused_train_dnerf.py:313",
             dn_seg_launches["dnerf_color_fwd"], dn_seg_abs["dnerf_color_fwd"]))] + [
        {"name": k, "route": "cuda", "source": f"endosurf_tpu_torch/kernels/csrc/{src}",
         "replaces": f"endosurf_tpu/kernels/{rep}", "launches": dn_train_launches[k],
         "max_abs_err": err, "ms": dn_train_times[k][0], "plain_ms": dn_train_times[k][1],
         "bound_ms": dn_train_times[k][2], "bound_by": dn_train_times[k][3], "library_ms": None}
        for k, src, rep, err in (
            ("dnerf_deform_bwd", "fused_train_dnerf.cu", "fused_train_dnerf.py:254",
             dn_bwd_abs["dnerf_deform_bwd"]),
            ("dnerf_density_bwd", "fused_train_dnerf.cu", "fused_train_dnerf.py:291",
             dn_bwd_abs["dnerf_density_bwd"]),
            ("dnerf_color_bwd", "fused_train_dnerf.cu", "fused_train_dnerf.py:326",
             dn_bwd_abs["dnerf_color_bwd"]),
            ("fused_fine_resample", "fused_render_dnerf.cu", "fused_sampler.py:834",
             resample_abs))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
