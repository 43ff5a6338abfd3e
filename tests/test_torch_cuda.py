"""The CUDA kernels on the card, held against their plain PyTorch twins: the
render kernel (``fused_render_rays``), the upsample kernel
(``fused_upsample_z``), the six field segment kernels of the train step
(``fused_train_cuda``: deform / sdf / color, forward and backward), the
observed-SDF query (``fused_sdf_observed``) and the sphere-traced ray march
(``fused_ray_march``), plus one train step with the upsample kernel against
one with the plain upsampling; and the EndoNeRF kernels: the raw density
query (``fused_density_raw``), the render (``fused_render_rays_dnerf``), the
three D-NeRF segments forward and backward (``fused_train_dnerf``), the
resample (``fused_fine_resample``) and the EndoNeRF train step on them.

Every test here needs an NVIDIA GPU with nvcc and skips without one. The
file imports no JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(--noconftest: tests/conftest.py sets up JAX for the other files; -rP shows
the readings the tests print.) The tolerances and their reasons are
``fused_render.PARITY_TOL``, ``fused_sampler.PARITY_TOL`` and
``fused_sampler.CONSISTENCY_TOL``, ``fused_train_cuda.PARITY_TOL`` and
``ORDER_TOL`` below, ``fused_sdf.PARITY_TOL`` and
``fused_sampler.MARCH_TOL``, ``fused_sdf.DENSITY_PARITY_TOL``,
``fused_render_dnerf.PARITY_TOL``, ``fused_train_dnerf.PARITY_TOL`` and
``BWD_PARITY_TOL``, ``fused_sampler.RESAMPLE_PARITY_TOL``; the planted-fault
tests rebuild the kernels from a patched copy of the sources. The bf16
tensor-core kernels are also held against float64 yardsticks (no farther
from them than the SIMT kernels), and the float32 ones against digests of
the SIMT kernels' outputs.
"""

import dataclasses
import os.path as osp
import shutil

import pytest
import torch

from endosurf_tpu_torch.kernels import build
from endosurf_tpu_torch.bridge import flatten
from endosurf_tpu_torch.data.scene_data import make_synthetic_arrays
from endosurf_tpu_torch.kernels import fused_render as fr
from endosurf_tpu_torch.kernels import fused_render_dnerf as frd
from endosurf_tpu_torch.kernels.fused_render import NL
from endosurf_tpu_torch.kernels import fused_sampler as fs
from endosurf_tpu_torch.kernels import fused_sdf as fsd
from endosurf_tpu_torch.kernels import fused_train_cuda as ftc
from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
from endosurf_tpu_torch.models import endonerf as en
from endosurf_tpu_torch.models import endosurf as es
from endosurf_tpu_torch.models.fields import (
    EndoSurfSpec,
    MLPSpec,
    fused_point_eval,
    init_endosurf_params,
)
from endosurf_tpu_torch.ops.geometry import ray_sphere_intersection
from endosurf_tpu_torch.train.trainer_endosurf import EndoSurfTrainer, make_loss_fn

pytestmark = pytest.mark.cuda

MAPS = ("color_map", "depth_map", "normal_map", "acc_map", "weight_max")
NARROW = EndoSurfSpec(deform=MLPSpec(9, 64, (4,), 3), sdf=MLPSpec(9, 64, (4,), 65),
                      color=MLPSpec(9, 64, (4,), 3), color_feat_dim=64)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rays(n: int, dev, seed: int = 1) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    o = torch.cat([torch.rand(n, 2, generator=g) * 0.6 - 0.3, torch.full((n, 1), -1.5)], -1)
    d = torch.rand(n, 3, generator=g) * 0.4 - 0.2 - o
    d = d / d.norm(dim=-1, keepdim=True)
    return torch.cat([o, d, torch.zeros(n, 2), torch.rand(n, 1, generator=g)], -1).to(dev)


@pytest.mark.parametrize("spec", [NARROW, EndoSurfSpec(), EndoSurfSpec(use_deform=False)],
                         ids=["narrow", "full", "full-static"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_matches_plain_twin(dev, spec, dtype):
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    rays = _rays(1024, dev)
    got = fr.fused_render_rays_cuda(spec, params, rays, 30000.0, 32, 32, 4, 50000.0, dtype, dtype)
    ref = fr.fused_render_rays_reference(spec, params, rays, 30000.0, 32, 32, 4, 50000.0,
                                         dtype, dtype)
    torch.cuda.synchronize()
    for k in MAPS:
        assert got[k].shape == ref[k].shape and got[k].dtype == torch.float32
    errs = fr.parity_errors(got, ref, dtype)
    print(f"render sound {dtype}: " + "; ".join(f"{k} p99 {v[0]:.3e} max {v[1]:.3e}"
                                               for k, v in errs.items()))
    assert all(ok for _, _, ok in errs.values()), errs


@pytest.mark.parametrize("spec", [NARROW, EndoSurfSpec(), EndoSurfSpec(use_deform=False)],
                         ids=["narrow", "full", "full-static"])
def test_parity_limits_reject_the_other_precision(dev, spec):
    """PARITY_TOL tells the dot precisions apart: the kernel with float32
    dots in one pass or both fails against the bf16 twin, and the reverse."""
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    rays = _rays(1024, dev)
    f32, bf16 = torch.float32, torch.bfloat16

    def run(fn, sd, md):
        return fn(spec, params, rays, 30000.0, 32, 32, 4, 50000.0, sd, md)
    for twin_dt, kernel_dts in ((bf16, [(f32, f32), (bf16, f32), (f32, bf16)]),
                                (f32, [(bf16, bf16), (bf16, f32), (f32, bf16)])):
        ref = run(fr.fused_render_rays_reference, twin_dt, twin_dt)
        for sd, md in kernel_dts:
            errs = fr.parity_errors(run(fr.fused_render_rays_cuda, sd, md), ref, twin_dt)
            print(f"render control: kernel {sd} / {md} vs twin {twin_dt}: " + "; ".join(
                f"{k} p99 {v[0]:.3e} max {v[1]:.3e}" for k, v in errs.items()))
            assert not all(ok for _, _, ok in errs.values()), (twin_dt, sd, md, errs)


def test_inference_runs_the_kernel(dev):
    """render_rays_inference on CUDA tensors launches the kernel once per
    call, with mixed sampling / main modes and a ragged ray count."""
    params = init_endosurf_params(NARROW, torch.Generator().manual_seed(0), dev)
    rays = _rays(333, dev)
    before = fr.LAUNCHES["fused_render_rays"]
    out = es.render_rays_inference(NARROW, es.RenderSpec(), params, rays, 1000.0,
                                   precision="highest", sampling_precision="default")
    ref = fr.fused_render_rays_reference(NARROW, params, rays, 1000.0, 32, 32, 4, 50000.0,
                                         torch.bfloat16, torch.float32)
    assert fr.LAUNCHES["fused_render_rays"] == before + 1
    assert all(bool(torch.isfinite(out[k]).all()) for k in MAPS)
    errs = fr.parity_errors(out, ref, torch.bfloat16)
    assert all(ok for _, _, ok in errs.values()), errs


def test_failed_compile_raises_with_nvcc_output(dev, tmp_path, monkeypatch):
    if shutil.which("nvcc") is None and not osp.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc")
    bad = tmp_path / "csrc"
    bad.mkdir()
    (bad / "broken.cu").write_text("__global__ void k() { this is not cuda }\n")
    monkeypatch.setattr(build, "CSRC", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build_library()


def test_cuda_entry_checks_inputs(dev):
    params = init_endosurf_params(NARROW, torch.Generator().manual_seed(0), dev)
    with pytest.raises(ValueError, match="unsupported sample counts"):
        fr.fused_render_rays_cuda(NARROW, params, _rays(8, dev), 0.0, 64, 64, 4, 0.0)
    with pytest.raises(ValueError, match="rays must be"):
        fr.fused_render_rays_cuda(NARROW, params, _rays(8, dev)[:, :8], 0.0, 32, 32, 4, 0.0)
    cpu_params = init_endosurf_params(NARROW, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="params on"):
        fr.fused_render_rays_cuda(NARROW, cpu_params, _rays(8, dev), 0.0, 32, 32, 4, 0.0)
    assert len(build.source_hash()) == 16


SPECS = [NARROW, EndoSurfSpec(), EndoSurfSpec(use_deform=False)]
SPEC_IDS = ["narrow", "full", "full-static"]
# The workspace planners' cases add chip_smoke.py's phase 37 shapes: nets of
# 4, 5 and 3 layers, and a 199-wide SDF (its rows padded to c16) with a
# colour net of two skip layers.
PLANNER_SPECS = SPECS + [
    dataclasses.replace(EndoSurfSpec(), deform=MLPSpec(4, 256, (2,), 3),
                        sdf=MLPSpec(5, 256, (2,), 257), color=MLPSpec(3, 256, (1,), 3)),
    dataclasses.replace(EndoSurfSpec(), sdf=MLPSpec(9, 199, (4,), 257),
                        color=MLPSpec(9, 256, (2, 5), 3))]
PLANNER_IDS = SPEC_IDS + ["short", "odd"]
RENDER_ARGS = (30000.0, 32, 32, 4, 50000.0)


def _frame_rays(n: int, dev) -> torch.Tensor:
    """n rays spread over a synthetic 512 x 640 frame, as chip_smoke.py's
    phase 3 picks them."""
    from endosurf_tpu_torch.data.scene_data import frame_rays
    scene = make_synthetic_arrays(n_frames=4, h=512, w=640, seed=0, device=dev)
    rays = frame_rays(scene.device_arrays, 512, 640, 3).reshape(-1, 9)
    return rays[::rays.shape[0] // n][:n].contiguous()


def test_render_tensor_cores_no_farther_from_float64(dev):
    """The condition under which a bf16 render limit (fused_render.PARITY_TOL)
    may move with the tensor-core render: on every card cell of
    test_kernel_matches_plain_twin (three nets, 1024 rays) and on 8192 rays of
    chip_smoke.py's frame, each on two weight seeds, the tensor-core render's
    median and p99 per-ray error against the float64 yardstick
    (fused_render_rays_float64) are no larger than the SIMT bf16 render's
    (simt=True) on the same inputs, per map (fused_render.no_farther)."""
    bf = torch.bfloat16
    cells = [(sid, spec, seed, 1024) for sid, spec in zip(SPEC_IDS, SPECS) for seed in (0, 1)]
    cells += [("frame", EndoSurfSpec(), seed, 8192) for seed in (0, 1)]
    failed = []
    for sid, spec, seed, n in cells:
        params = init_endosurf_params(spec, torch.Generator().manual_seed(seed), dev)
        rays = _rays(n, dev) if n == 1024 else _frame_rays(n, dev)
        ref = fr.fused_render_rays_float64(spec, params, rays, *RENDER_ARGS)
        tc, simt = (fr.float64_distance(fr.fused_render_rays_cuda(
            spec, params, rays, *RENDER_ARGS, bf, bf, simt=flag), ref) for flag in (False, True))
        ok = fr.no_farther(tc, simt)
        for k in MAPS:
            print(f"render bf16 vs float64 {sid} seed {seed} {k} (median, p99): tensor cores "
                  f"{tc[k][0]:.4e}, {tc[k][1]:.4e}; SIMT {simt[k][0]:.4e}, {simt[k][1]:.4e}")
            if not ok[k]:
                failed.append((sid, seed, k))
    assert not failed, failed


# sha256 of the float32 render's maps (MAPS concatenated, float32 bytes) on
# _rays(1024) with the full net (seed 0) at RENDER_ARGS, as the SIMT kernel of
# the parent of the tensor-core render built it, and of the float32
# observed-SDF query's output on a grid slab (tools/render_f32_digest.py's
# case) as the SIMT sweep of the parent of the tensor-core query computed it
# (tools/render_f32_digest.py on an NVIDIA H100 80GB HBM3), and the nvcc
# release that compiled them: another toolchain may compile other bits, so
# the test skips under it (rerun the tool on both trees then).
F32_RENDER_DIGEST = "41736c66a893780b441d4699464f7384c7fe981e96c2862ab4628365852e59d5"
F32_SDF_QUERY_DIGEST = "ef0d45bb023dad05050a79f78a93ada5a694537f4543d838545c17473d0408ad"
F32_MARCH_DIGEST = "41cc18e8a4ad6a2225a648591451b378b4e8e08f8e7bcfcbf467c459f8a951f5"
F32_RENDER_NVCC = "release 12.9,"


def _tool(name: str):
    """The module of tools/<name>.py."""
    import importlib.util
    spec_ = importlib.util.spec_from_file_location(
        name, osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "tools", name + ".py"))
    tool = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(tool)
    return tool


def test_render_f32_is_the_simt_render(dev):
    """The float32 render runs the SIMT code it ran before the bf16 passes
    moved to tensor cores: its maps equal that kernel's bit for bit, and the
    same with simt=True; the float32 grid query and ray march likewise run
    the SIMT sweep they ran before their bf16 sweeps moved to tensor cores."""
    import hashlib
    import subprocess
    params = init_endosurf_params(EndoSurfSpec(), torch.Generator().manual_seed(0), dev)
    rays = _rays(1024, dev)
    outs = [fr.fused_render_rays_cuda(EndoSurfSpec(), params, rays, *RENDER_ARGS, simt=flag)
            for flag in (False, True)]
    cat = [torch.cat([o[k] for k in MAPS], -1) for o in outs]
    assert torch.equal(cat[0], cat[1])
    digest = hashlib.sha256(cat[0].cpu().numpy().tobytes()).hexdigest()
    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout
    release = next((ln for ln in nvcc.splitlines() if "release" in ln), nvcc.strip())
    query = _tool("render_f32_digest").sdf_query_digest(dev)
    march = _tool("render_f32_digest").march_digest(dev)
    print(f"float32 render digest {digest}, sdf query digest {query}, march digest {march} "
          f"({release})")
    if F32_RENDER_NVCC not in release:
        pytest.skip(f"the digest was taken with nvcc {F32_RENDER_NVCC.rstrip(',')}, "
                    f"this one is {release}")
    assert digest == F32_RENDER_DIGEST
    assert query == F32_SDF_QUERY_DIGEST
    assert march == F32_MARCH_DIGEST


def test_render_reuses_the_pack(dev):
    """Chunks on one parameter set share the render's pack: a second call
    packs nothing and gives the same maps; after an in-place update of a
    weight the next call repacks, and its maps equal those of a pack built
    from scratch."""
    params = init_endosurf_params(NARROW, torch.Generator().manual_seed(0), dev)
    rays = _rays(256, dev)
    bf = torch.bfloat16

    def run():
        out = fr.fused_render_rays_cuda(NARROW, params, rays, *RENDER_ARGS, bf, bf)
        return torch.cat([out[k] for k in MAPS], -1)
    first = run()
    n = fr.PACKS["render"]
    assert torch.equal(run(), first) and fr.PACKS["render"] == n
    with torch.no_grad():
        params["color_network"]["layers"][2]["b"].add_(0.5)
    updated = run()
    assert fr.PACKS["render"] == n + 1 and not torch.equal(updated, first)
    fr._RENDER_PACKS.clear()
    assert torch.equal(run(), updated) and fr.PACKS["render"] == n + 2


@pytest.mark.parametrize("spec", PLANNER_SPECS, ids=PLANNER_IDS)
def test_render_workspace_matches_the_planner(dev, spec):
    """fused_render.render_work_floats (the CPU mirror) equals csrc's
    fused_render_work_floats (plan_render_work) at several point counts, on
    base.yml's nets and on nets of other depths and padded widths."""
    import ctypes
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    _, meta = fr.pack_render(spec, params, torch.bfloat16)
    lib = build.load_library()
    arr = (ctypes.c_longlong * len(meta))(*meta)
    for n in (1, 63, 4097, 2048 * 64):
        assert lib.fused_render_work_floats(arr, n) == fr.render_work_floats(meta, n), n


# Faults planted in the bf16 render's tensor-core field stage
# (csrc/fused_render.cu): grad_o through J instead of J^T, and the sample
# point at a quarter of its section instead of the middle.
TC_RENDER_FAULTS = {
    "coupling_grad_o_untransposed": (
        "    go[k] = Jl[k * 3 + 0] * g[0] + Jl[k * 3 + 1] * g[1] + Jl[k * 3 + 2] * g[2];",
        "    go[k] = Jl[0 * 3 + k] * g[0] + Jl[1 * 3 + k] * g[1] + Jl[2 * 3 + k] * g[2];"),
    "midpoint_quarter_section": ("const float mid = z[j] + dist * 0.5f;",
                                 "const float mid = z[j] + dist * 0.25f;"),
}


@pytest.mark.parametrize("fault", sorted(TC_RENDER_FAULTS))
def test_render_limits_catch_planted_faults(dev, fault, tmp_path, monkeypatch):
    """The bf16 limits (PARITY_TOL) fail a tensor-core render with a planted
    fault in its field stage, on the full net and 1024 rays."""
    _rebuild_with(monkeypatch, tmp_path, "fused_render.cu", *TC_RENDER_FAULTS[fault])
    params = init_endosurf_params(EndoSurfSpec(), torch.Generator().manual_seed(0), dev)
    rays = _rays(1024, dev)
    bf = torch.bfloat16
    got = fr.fused_render_rays_cuda(EndoSurfSpec(), params, rays, *RENDER_ARGS, bf, bf)
    ref = fr.fused_render_rays_reference(EndoSurfSpec(), params, rays, *RENDER_ARGS, bf, bf)
    errs = fr.parity_errors(got, ref, bf)
    print(f"render fault {fault}: " + "; ".join(f"{k} p99 {v[0]:.3e} max {v[1]:.3e}"
                                              for k, v in errs.items()))
    assert not all(ok for _, _, ok in errs.values())


def test_render_refuses_nets_the_tensor_cores_do_not_take(dev):
    """An SDF net 200 wide (not a multiple of 16) renders in both precisions
    within PARITY_TOL of the plain twin on 1024 rays, the bf16 render on
    tensor cores no farther from the float64 yardstick than the SIMT render;
    a net past the kernels' box (a 10-layer SDF) is refused in both, with no
    fallback to the SIMT render or the plain twin."""
    w200 = dataclasses.replace(EndoSurfSpec(use_deform=False), sdf=MLPSpec(9, 200, (4,), 201),
                               color_feat_dim=200)
    params = init_endosurf_params(w200, torch.Generator().manual_seed(0), dev)
    rays = _rays(1024, dev)
    bf = torch.bfloat16
    for dt in (torch.float32, bf):
        before = fr.LAUNCHES["fused_render_rays"]
        got = fr.fused_render_rays_cuda(w200, params, rays, *RENDER_ARGS, dt, dt)
        assert fr.LAUNCHES["fused_render_rays"] == before + 1
        errs = fr.parity_errors(got, fr.fused_render_rays_reference(w200, params, rays,
                                                                    *RENDER_ARGS, dt, dt), dt)
        print(f"render w200 {dt}: " + "; ".join(f"{k} p99 {v[0]:.3e} max {v[1]:.3e}"
                                                for k, v in errs.items()))
        assert all(ok for _, _, ok in errs.values()), errs
    ref = fr.fused_render_rays_float64(w200, params, rays, *RENDER_ARGS)
    tc, simt = (fr.float64_distance(fr.fused_render_rays_cuda(
        w200, params, rays, *RENDER_ARGS, bf, bf, simt=flag), ref) for flag in (False, True))
    print(f"render w200 bf16 vs float64 (median, p99): tensor cores {tc}; SIMT {simt}")
    assert all(fr.no_farther(tc, simt).values())
    deep = dataclasses.replace(w200, sdf=MLPSpec(10, 200, (4,), 201))
    deep_params = init_endosurf_params(deep, torch.Generator().manual_seed(0), dev)
    for dt in (torch.float32, bf):
        with pytest.raises(ValueError, match="2 to 9 layers"):
            fr.fused_render_rays_cuda(deep, deep_params, rays[:64], *RENDER_ARGS, dt, dt)


def _upsample_inputs(n: int, dev, seed: int = 0):
    """o, d_z, t and perturbed z0 [n, 32] for the rays of _rays."""
    rays = _rays(n, "cpu", 1 + seed)
    o, d, d_z, t = es._split_rays(rays)
    near, far, _ = ray_sphere_intersection(o, d)
    z0 = es._stratified_z(near, far, 32,
                          torch.rand(n, 1, generator=torch.Generator().manual_seed(2 + seed)))
    return tuple(x.contiguous().to(dev) for x in (o, d_z, t, z0))


def _upsample(fn, spec, params, inputs, dtype, return_sdf):
    out = fn(spec, params, *inputs, 32, 4, dtype, return_sdf)
    return {"z": out[0], "sdf": out[1]} if return_sdf else {"z": out}


def _upsample_check(spec, params, inputs, got, ref, dtype):
    """(within every limit, readings): PARITY_TOL against the twin and, with
    the sdf, CONSISTENCY_TOL on the kernel's own samples."""
    errs = fs.parity_errors(got, ref, dtype)
    ok = all(v[-1] for v in errs.values())
    report = {"twin": errs}
    if "sdf" in got:
        report["own"] = fs.consistency_report(fs.consistency_errors(
            spec, params, *inputs, got["z"], got["sdf"], 32, 4, dtype), dtype)
        ok = ok and all(v[1] for v in report["own"].values())
    return ok, report


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("return_sdf", [False, True], ids=["z", "z+sdf"])
@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_upsample_kernel_matches_plain_twin(dev, spec, dtype, return_sdf, seed):
    params = init_endosurf_params(spec, torch.Generator().manual_seed(seed), dev)
    inputs = _upsample_inputs(1024, dev, seed)
    got = _upsample(fs.fused_upsample_z_cuda, spec, params, inputs, dtype, return_sdf)
    ref = _upsample(fs.fused_upsample_z_reference, spec, params, inputs, dtype, return_sdf)
    torch.cuda.synchronize()
    for k in got:
        assert got[k].shape == (1024, 64) and got[k].dtype == torch.float32
    assert bool((got["z"].diff(dim=-1) >= 0).all())
    ok, report = _upsample_check(spec, params, inputs, got, ref, dtype)
    print(f"sound {dtype} seed {seed}: {report}")
    assert ok, report


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_upsample_parity_limits_reject_the_other_precision(dev, spec, seed):
    """The limits tell the dot precisions apart: the kernel at one precision
    fails against the twin (and the plain SDF) at the other."""
    params = init_endosurf_params(spec, torch.Generator().manual_seed(seed), dev)
    inputs = _upsample_inputs(1024, dev, seed)
    f32, bf16 = torch.float32, torch.bfloat16
    for twin_dt, kernel_dt in ((bf16, f32), (f32, bf16)):
        ref = _upsample(fs.fused_upsample_z_reference, spec, params, inputs, twin_dt, True)
        got = _upsample(fs.fused_upsample_z_cuda, spec, params, inputs, kernel_dt, True)
        ok, report = _upsample_check(spec, params, inputs, got, ref, twin_dt)
        print(f"control: kernel {kernel_dt} vs {twin_dt} seed {seed}: {report}")
        assert not ok, report
        assert not all(v[1] for v in report["own"].values()), report


# Faults planted in the upsample's sources: per fault one (file, text
# replaced, replacement) for each edit, and the dot modes in which the limits
# must catch it. The first three hit a minority of rays in csrc/sdf_chain.cuh's
# draws and merges, which both modes run. One operand rounding differently
# moves a bf16 point's SDF by up to ~7e-3, so an SDF 0.1 % off is caught in
# float32 only. The last is a fault of the bf16 tensor-core sweep
# (csrc/sweep_tc.cuh): the skip scale applied to the accumulator after the
# dot, as the train segments do, instead of to the operands before it.
FAULTS = {
    "skip_last_merge_r64": ([
        ("sdf_chain.cuh", "  if (r >= R) return;\n  float* z = zl",
         "  if (r >= R) return;\n  if (s + k == 64 && r % 64 == 0) return;\n  float* z = zl")],
        (torch.float32, torch.bfloat16)),
    "shift_last_draws_r128": ([
        ("sdf_chain.cuh", "    float u = ((float)n + 0.5f) / (float)k;",
         "    float u = ((float)n + ((s + k == 64 && r % 128 == 0) ? 0.6f : 0.5f)) / (float)k;")],
        (torch.float32, torch.bfloat16)),
    "scale_new_sdf_r64": ([
        ("sdf_chain.cuh", "    float sn = snew ? snew[(size_t)r * KNEW_MAX + n] : 0.f;",
         "    float sn = snew ? snew[(size_t)r * KNEW_MAX + n] * (r % 64 == 0 ? 1.001f : 1.f)"
         " : 0.f;")],
        (torch.float32,)),
    "sweep_skip_scale_after_dot": ([
        ("sweep_tc.cuh", "sweep_round(acc[mt][nt][e], lo[mt][nt][e], b[c], relu, post, post_d)",
         "sweep_round(acc[mt][nt][e] * pre, lo[mt][nt][e] * pre, b[c], relu, 1.f, 1.0)"),
        ("sweep_tc.cuh", "    const float* b = wts + N.b_off[l];",
         "    const float* b = wts + N.b_off[l];\n"
         "    const float pre = ((N.skip_mask >> l) & 1) ? EndoSurfChain::kSkip : 1.f;"),
        ("sweep_tc.cuh", "      put_enc(H, ldh, in_l - ew, Es, ew, P, tid);",
         "      put_enc(H, ldh, in_l - ew, E0, ew, P, tid);")],
        (torch.bfloat16,)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_upsample_limits_catch_planted_faults(dev, fault, tmp_path, monkeypatch):
    """A kernel wrong on 1/64 or 1/128 of the rays, or rounding its skip
    operands in the wrong place, fails the limits, where the twin comparison
    alone lets the smaller faults through."""
    edits, dtypes = FAULTS[fault]
    _rebuild_with_all(monkeypatch, tmp_path, edits)
    spec = EndoSurfSpec()
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    inputs = _upsample_inputs(1024, dev)
    for dtype in dtypes:
        got = _upsample(fs.fused_upsample_z_cuda, spec, params, inputs, dtype, True)
        ref = _upsample(fs.fused_upsample_z_reference, spec, params, inputs, dtype, True)
        ok, report = _upsample_check(spec, params, inputs, got, ref, dtype)
        print(f"{fault} {dtype}: {report}")
        assert not ok, report


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_upsample_bf16_sweep_is_float32_noise(dev, spec, seed):
    """The bf16 upsample (its sweeps on tensor cores) sits about as far from
    a float64 plain upsample (fused_sampler.fused_upsample_z_float64: the
    same bf16 operand roundings, float64 arithmetic) as the float32 plain
    version does: every float32 order tips a bf16 operand rounding now and
    then, and the sharpness carries a tipped SDF into the later rounds'
    draws. Per output (z, sdf) the median and p99 of the per-ray max error
    against float64: the kernel's within 2x the float32 plain version's
    (both are printed; fused_sampler.PARITY_TOL has the readings)."""
    params = init_endosurf_params(spec, torch.Generator().manual_seed(seed), dev)
    inputs = _upsample_inputs(1024, dev, seed)
    bf = torch.bfloat16
    kernel = _upsample(fs.fused_upsample_z_cuda, spec, params, inputs, bf, True)
    plain = _upsample(fs.fused_upsample_z_reference, spec, params, inputs, bf, True)
    ref = dict(zip(("z", "sdf"), fs.fused_upsample_z_float64(spec, params, *inputs, 32, 4)))
    k_st, p_st = (fs.parity_errors({k: v.double() for k, v in got.items()}, ref, bf)
                  for got in (kernel, plain))
    print(f"upsample bf16 vs float64 seed {seed} (median, p99, max, share): kernel {k_st}; "
          f"float32 plain {p_st}")
    for k in ref:
        assert k_st[k][0] <= 2 * p_st[k][0] and k_st[k][1] <= 2 * p_st[k][1], k


def _train_upsample_inputs(n: int, dev, seed: int):
    """o, d_z, t and perturbed z0 [n, 32] of n rays of a synthetic 512 x 640
    scene's train batch, as chip_smoke.py's phase 6 draws them."""
    from endosurf_tpu_torch.data.scene_data import sample_train_batch
    scene = make_synthetic_arrays(n_frames=4, h=512, w=640, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rays = sample_train_batch(scene.device_arrays, 512, 640, n, generator=gen)["rays"]
    o, d, d_z, t = es._split_rays(rays)
    near, far, _ = ray_sphere_intersection(o, d)
    z0 = es._stratified_z(near, far, 32, torch.rand(n, 1, generator=gen, device=dev))
    return o, d_z, t, z0


def test_upsample_tensor_cores_no_farther_from_float64(dev, tmp_path, monkeypatch):
    """The condition under which the bf16 upsample limits moved with the
    tensor-core sweep (fused_sampler.PARITY_TOL): on every card cell of
    test_upsample_kernel_matches_plain_twin (three nets, 1024 rays) and on
    8192 train rays of chip_smoke.py's scene, each on two weight seeds, the
    tensor-core kernel's median and p99 per-ray error against the float64
    yardstick (fused_upsample_z_float64) are no larger than the SIMT sweep's
    on the same inputs, for z and sdf. The SIMT sweep comes from a copy of
    csrc/ whose bf16 upsample calls sweep_rays, as the render does."""
    bf = torch.bfloat16
    cells = [(sid, spec, seed, 1024) for sid, spec in zip(SPEC_IDS, SPECS) for seed in (0, 1)]
    cells += [("train", EndoSurfSpec(), seed, 8192) for seed in (0, 1)]

    def case(spec, seed, n):
        params = init_endosurf_params(spec, torch.Generator().manual_seed(seed), dev)
        inputs = (_upsample_inputs(n, dev, seed) if n == 1024
                  else _train_upsample_inputs(n, dev, seed))
        return params, inputs

    runs = {}
    for sid, spec, seed, n in cells:
        params, inputs = case(spec, seed, n)
        ref = dict(zip(("z", "sdf"), fs.fused_upsample_z_float64(spec, params, *inputs, 32, 4)))
        got = _upsample(fs.fused_upsample_z_cuda, spec, params, inputs, bf, True)
        runs[sid, seed] = [ref, got]
    _rebuild_with(monkeypatch, tmp_path, "fused_sampler.cu",
                  "return rb_samp ? sweep_rays_tc(w, m, fr, R, K, rb, z, ldz, dst, ldd, st)",
                  "return rb_samp ? sweep_rays(w, m, true, R, K, rb, z, ldz, dst, ldd, st)")
    failed = []
    for sid, spec, seed, n in cells:
        params, inputs = case(spec, seed, n)
        ref, tc = runs[sid, seed]
        simt = _upsample(fs.fused_upsample_z_cuda, spec, params, inputs, bf, True)
        t_st, s_st = (fs.parity_errors({k: v.double() for k, v in got.items()}, ref, bf)
                      for got in (tc, simt))
        for k in ("z", "sdf"):
            print(f"upsample bf16 vs float64 {sid} seed {seed} {k} (median, p99): tensor cores "
                  f"{t_st[k][0]:.4e}, {t_st[k][1]:.4e}; SIMT {s_st[k][0]:.4e}, {s_st[k][1]:.4e}")
            if t_st[k][0] > s_st[k][0] or t_st[k][1] > s_st[k][1]:
                failed.append((sid, seed, k))
    assert not failed, failed


# Sampling nets besides base.yml's for the tensor-core sweep: no skip layer,
# and hidden widths that are not multiples of 16 (the deform net's layer
# before the skip is then 148 wide).
SWEEP_NETS = {
    "noskip": dict(deform=MLPSpec(9, 256, (), 3), sdf=MLPSpec(9, 256, (), 257)),
    "w200": dict(deform=MLPSpec(9, 200, (4,), 3), sdf=MLPSpec(9, 200, (4,), 201),
                 color_feat_dim=200),
}


@pytest.mark.parametrize("net_id", sorted(SWEEP_NETS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_upsample_kernel_takes_other_nets(dev, net_id, dtype):
    """The upsample kernel against its plain twin at the limits, for nets
    whose deform and SDF MLPs are one of SWEEP_NETS."""
    spec = dataclasses.replace(EndoSurfSpec(), **SWEEP_NETS[net_id])
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    inputs = _upsample_inputs(1024, dev)
    got = _upsample(fs.fused_upsample_z_cuda, spec, params, inputs, dtype, True)
    ref = _upsample(fs.fused_upsample_z_reference, spec, params, inputs, dtype, True)
    ok, report = _upsample_check(spec, params, inputs, got, ref, dtype)
    print(f"upsample {net_id} {dtype}: {report}")
    assert ok, report


def test_render_rays_runs_the_upsample_kernel(dev):
    """render_rays on CUDA tensors launches the upsample kernel once per call
    and returns its (z, sdf); sample counts the kernel cannot take raise
    instead of running the plain upsampling."""
    params = init_endosurf_params(NARROW, torch.Generator().manual_seed(0), dev)
    rays = _rays(256, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    before = fs.LAUNCHES["fused_upsample_z"]
    out = es.render_rays(NARROW, es.RenderSpec(), params, rays, 100.0, generator=gen,
                         return_upsample=True)
    assert fs.LAUNCHES["fused_upsample_z"] == before + 1
    assert out["up_z"].shape == out["up_sdf"].shape == (256, 64)
    with pytest.raises(ValueError, match="unsupported sample counts"):
        es.render_rays(NARROW, es.RenderSpec(n_importance=64), params, rays, 100.0)
    assert fs.LAUNCHES["fused_upsample_z"] == before + 1


# One train step with the upsample kernel against one with the plain
# upsampling (same params, batch and draws; both run the field segment
# kernels): relative difference of every
# metric, and per network the relative L2 norm of the gradient difference.
# A draw on a bin edge moves a sample on a few rays, which moves their
# render and, through the surface search, their neighbour points. This
# test's own readings on an H100 (seeds 0 and 1, printed): float32 metrics
# 9.6e-6, gradients 2.5e-4 at most; bf16 metrics 1.4e-3, gradients 4.2e-3.
STEP_TOL = {"highest": (1e-4, 2e-3), "default": (5e-3, 2e-2)}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_train_step_kernel_matches_plain(dev, precision, seed, monkeypatch):
    scene = make_synthetic_arrays(4, 64, 80, 0, dev)
    params = init_endosurf_params(NARROW, torch.Generator().manual_seed(seed), dev)
    gen = torch.Generator(device=dev).manual_seed(3 + seed)
    draws = {"frame": torch.tensor(1, device=dev),
             "u_pix": torch.rand(512, generator=gen, device=dev),
             "z": torch.rand(512, 1, generator=gen, device=dev),
             "neig": torch.rand(512, 3, generator=gen, device=dev)}
    weights = {"color_loss_weight": 1.0, "depth_loss_weight": 1.0, "sdf_loss_weight": 1.0,
               "angle_loss_weight": 0.1, "eikonal_loss_weight": 0.1,
               "surf_neig_loss_weight": 0.1}
    fn = make_loss_fn(NARROW, es.RenderSpec(), 64, 80, 512, weights, 0.1,
                      precision=precision)
    res = {}
    for kernel in (True, False):
        for v in flatten(params).values():
            v.requires_grad_(True)
            v.grad = None
        before = fs.LAUNCHES["fused_upsample_z"]
        with monkeypatch.context() as m:
            if not kernel:      # the plain upsampling on the same CUDA tensors
                m.setattr(fs, "fused_upsample_z", fs.fused_upsample_z_reference)
            total, metrics = fn(params, scene.device_arrays, 100.0, None, draws)
        assert fs.LAUNCHES["fused_upsample_z"] == before + int(kernel)
        total.backward()
        res[kernel] = ({k: float(v.detach()) for k, v in metrics.items()},
                       {k: v.grad.clone() for k, v in flatten(params).items()})
    (mk, gk), (mp, gp) = res[True], res[False]
    m_tol, g_tol = STEP_TOL[precision]
    m_rel = {k: abs(mk[k] - mp[k]) / (abs(mp[k]) + 1e-6) for k in mk}
    g_rel = {}
    for net in ("deform_network", "sdf_network", "color_network", "deviation_network"):
        keys = [k for k in gk if k.startswith(net)]
        diff = sum(float(((gk[k] - gp[k]) ** 2).sum()) for k in keys) ** 0.5
        norm = sum(float((gp[k] ** 2).sum()) for k in keys) ** 0.5
        g_rel[net] = diff / max(norm, 1e-30)
    print(f"train step {precision} seed {seed}: worst metric {max(m_rel.values()):.3e}, "
          f"worst gradient {max(g_rel.values()):.3e}; {m_rel}; {g_rel}")
    assert all(v <= m_tol for v in m_rel.values()), m_rel
    assert all(v <= g_tol for v in g_rel.values()), g_rel


def test_upsample_entry_checks_inputs(dev):
    params = init_endosurf_params(NARROW, torch.Generator().manual_seed(0), dev)
    o, d_z, t, z0 = _upsample_inputs(8, dev)
    with pytest.raises(ValueError, match="unsupported sample counts"):
        fs.fused_upsample_z_cuda(NARROW, params, o, d_z, t, z0, 64, 4)
    with pytest.raises(ValueError, match="expected"):
        fs.fused_upsample_z_cuda(NARROW, params, o, d_z, t[:4], z0, 32, 4)
    cpu_params = init_endosurf_params(NARROW, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="params on"):
        fs.fused_upsample_z_cuda(NARROW, cpu_params, o, d_z, t, z0, 32, 4)


# ---------------------------------------------------------------------------
# the field segment kernels of the train step (csrc/fused_train.cu)
# ---------------------------------------------------------------------------

SEG_N = 8192
RAGGED_N = 65531          # not a multiple of the tiles or of the product's chunks
# The same points in another order give the same kernel gradients up to the
# order of the float32 sums over points: relative L2 per parameter leaf. In
# bf16 each weight gradient is rounded after its sum, so another order may
# move an element by one bf16 ulp (2^-8 relative) where the sum sits near a
# rounding boundary.
ORDER_TOL = {"highest": 1e-5, "default": 2.0 ** -8}


def _seg_points(n: int, dev, seed: int = 0):
    g = torch.Generator().manual_seed(10 + seed)
    x = torch.rand(n, 3, generator=g) * 1.6 - 0.8
    d = torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    return x.to(dev), d.to(dev), torch.rand(n, 1, generator=g).to(dev)


def _report(res):
    return {seg: {kind: {k: v for k, v in vals.items() if not v[-1]}
                  for kind, vals in kinds.items()} for seg, kinds in res.items()}


def _worst(res):
    return {f"{seg} {kind}": max(v[0] for v in vals.values())
            for seg, kinds in res.items() for kind, vals in kinds.items()}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
@pytest.mark.parametrize("precision", ["highest", "default"], ids=["f32", "bf16"])
def test_segment_kernels_match_plain(dev, spec, precision, seed):
    """Every segment kernel against its plain version (forward outputs,
    parameter gradients, input cotangents) at fused_train_cuda.PARITY_TOL."""
    params = init_endosurf_params(spec, torch.Generator().manual_seed(seed), dev)
    res, _, _ = ftc.segment_parity(spec, params, *_seg_points(SEG_N, dev, seed), precision, seed)
    torch.cuda.synchronize()
    print(f"segments sound {precision} seed {seed}: worst {_worst(res)}")
    assert ftc.parity_ok(res), _report(res)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_segment_limits_reject_the_other_precision(dev, spec, seed):
    """Each segment's limits tell the dot precisions apart: its kernels at one
    precision fail against its plain version at the other."""
    params = init_endosurf_params(spec, torch.Generator().manual_seed(seed), dev)
    pts = _seg_points(SEG_N, dev, seed)
    for prec, other in (("highest", "default"), ("default", "highest")):
        res, _, _ = ftc.segment_parity(spec, params, *pts, prec, seed, other)
        print(f"segments control: kernel {other} vs plain {prec} seed {seed}: worst {_worst(res)}")
        for seg, kinds in res.items():
            assert not ftc.parity_ok({seg: kinds}), (seg, prec)


# Colour nets besides base.yml's: no skip layer (the tensor-core walk then
# sends no skip cotangent to the colour input), and a hidden width that is
# not a multiple of 16 (the padding columns of the layers under the skip).
COLOR_NETS = {"noskip": MLPSpec(9, 256, (), 3), "w200": MLPSpec(9, 200, (4,), 3)}


@pytest.mark.parametrize("net_id", sorted(COLOR_NETS))
@pytest.mark.parametrize("precision", ["highest", "default"], ids=["f32", "bf16"])
def test_segment_kernels_take_other_colour_nets(dev, net_id, precision):
    """The segment kernels against their plain versions at PARITY_TOL, for a
    static spec whose colour net is one of COLOR_NETS."""
    spec = dataclasses.replace(EndoSurfSpec(use_deform=False), color=COLOR_NETS[net_id])
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    res, _, _ = ftc.segment_parity(spec, params, *_seg_points(SEG_N, dev), precision, 0)
    torch.cuda.synchronize()
    print(f"segments colour {net_id} {precision}: worst {_worst(res)}")
    assert ftc.parity_ok(res), _report(res)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("net_id", ["full"] + sorted(COLOR_NETS))
def test_color_fwd_tensor_cores_match_plain(dev, net_id, seed):
    """In bf16 the colour forward runs color_fwd_tc_kernel (one launch a
    call) and holds its plain version at PARITY_TOL's "out" limits, on both
    weight seeds, for base.yml's colour net and COLOR_NETS."""
    spec = (EndoSurfSpec() if net_id == "full"
            else dataclasses.replace(EndoSurfSpec(), color=COLOR_NETS[net_id]))
    params = init_endosurf_params(spec, torch.Generator().manual_seed(seed), dev)
    before = ftc.LAUNCHES["color_fwd"]
    res, _, _ = ftc.segment_parity(spec, params, *_seg_points(SEG_N, dev, seed), "default",
                                   seed)
    torch.cuda.synchronize()
    out = res["color"]["out"]["color"]
    print(f"color_fwd bf16 {net_id} seed {seed}: median {out[0]:.3e}, p99 {out[1]:.3e}, "
          f"max {out[2]:.3e}")
    assert ftc.LAUNCHES["color_fwd"] == before + 1
    assert out[-1], out


def test_color_fwd_is_the_backward_recompute(dev, tmp_path, monkeypatch):
    """In bf16 the colour forward kernel and the colour backward's recompute
    run one tile forward (field_tc.cuh's color_tc_forward and color_tc_rgb),
    so the forward the loss sees is the one the backward differentiates:
    at a ragged point count the forward's colour equals, bit for bit, the rgb
    that a build whose backward writes its recompute's rgb in place of d x_c
    returns."""
    rgb = "        const float rgb = color_tc_rgb(wts, C, H, ldh, p, c);\n"
    sections = "  // ---- the sections of the colour input: [enc(x_c), grad_c, enc(d_c), feat]\n"
    _rebuild_with_all(monkeypatch, tmp_path, [
        ("field_tc.cuh", rgb, rgb + "        dxc[(size_t)(base + p) * 3 + c] = rgb;\n"),
        ("field_tc.cuh", sections, "  return;\n" + sections)])
    spec = EndoSurfSpec()
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    _, _, cases = ftc.segment_parity(spec, params, *_seg_points(RAGGED_N, dev), "default", 0)
    _, _, packed, inputs, cots = cases["color"]
    (color,) = ftc.color_fwd(packed, *inputs)
    _, (probe, *_) = ftc.color_bwd(packed, *inputs, *cots)
    torch.cuda.synchronize()
    assert torch.equal(color, probe)


def _kernel_grads(spec, params, x, d, t, w, precision):
    """Parameter gradients of a weighted sum of the fields through the
    segment kernels (all six)."""
    from endosurf_tpu_torch.kernels.fused_train import megakernel_point_eval
    out = megakernel_point_eval(spec, params, x, d, t, precision)
    total = ((out["sdf"] * w[:, 0]).sum() + (out["color"] * w).sum()
             + (out["grad_o"] * w).sum())
    names = list(flatten(params))
    return dict(zip(names, torch.autograd.grad(total, list(flatten(params).values()),
                                                allow_unused=True)))


def _order_errors(spec, params, pts, precision, shift=5):
    """(two calls bit-identical, per-leaf relative L2 between the points in
    their order and rolled by ``shift``)."""
    for v in flatten(params).values():
        v.requires_grad_(True)
    w = torch.randn(pts[0].shape[0], 3, generator=torch.Generator().manual_seed(4)).to(pts[0].device)
    a = _kernel_grads(spec, params, *pts, w, precision)
    b = _kernel_grads(spec, params, *pts, w, precision)
    rolled = [torch.roll(p, shift, 0) for p in (*pts, w)]
    c = _kernel_grads(spec, params, *rolled[:3], rolled[3], precision)
    same = all((a[k] is None and b[k] is None) or torch.equal(a[k], b[k]) for k in a)
    rel = {k: float((c[k] - a[k]).norm() / max(float(a[k].norm()), 1e-30))
           for k in a if a[k] is not None}
    return same, rel


@pytest.mark.parametrize("precision", ["highest", "default"], ids=["f32", "bf16"])
def test_segment_kernels_ragged_and_deterministic(dev, precision):
    """At a point count that fills no tile or chunk: parity with the plain
    versions; two calls give identical bits (the fixed-order reduction); the
    same points in another order give the same gradients (ORDER_TOL)."""
    spec = EndoSurfSpec()
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    pts = _seg_points(RAGGED_N, dev)
    res, _, _ = ftc.segment_parity(spec, params, *pts, precision, 0)
    same, rel = _order_errors(spec, params, pts, precision)
    print(f"segments ragged {precision}: worst {_worst(res)}; order worst "
          f"{max(rel.values()):.3e}")
    assert ftc.parity_ok(res), _report(res)
    assert same
    assert max(rel.values()) <= ORDER_TOL[precision], rel


def test_segment_f32_tails_are_float32_noise(dev):
    """In f32 the colour segment kernel's parameter gradients sit about as far
    from a float64 plain version as the float32 plain version does: a relu
    gate whose pre-activation lies within float32 noise of 0 flips in either
    (the reason for PARITY_TOL's loose max). Per leaf relative L2 against
    float64: the kernel's worst within 2x the float32 plain version's."""
    from endosurf_tpu_torch.kernels import fused_train as ft
    spec = EndoSurfSpec()
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    x, d, t = _seg_points(65536, dev)
    with torch.no_grad():
        eff = ft.prepare_effective(spec, params)
        x_c, jrows = ft.seg_deform_math(spec, eff["deform"], torch.cat([x, t], -1), "highest")
        _, feat, grad_c = ft.seg_sdf_math(spec, eff["sdf"], eff["sdf_head"], eff["sdf_feat"],
                                          x_c, "highest")
        _, d_c = ft.coupling_math(jrows, grad_c, d)
    ins = (x_c, grad_c, d_c, feat)
    g = torch.randn(x.shape[0], 3, generator=torch.Generator().manual_seed(1)).to(dev)
    like, flat = ft.segment_weights(eff, "color")

    def plain(dtype):
        return ft.plain_bwd(spec, "color", like, [v.to(dtype) for v in flat],
                            [v.to(dtype) for v in ins], (g.to(dtype),), "highest")[0]

    ref = plain(torch.float64)
    kernel, _ = ftc.color_bwd(ftc.pack_segment(spec, "color", flat, like, "highest"), *ins, g)

    def worst(got):
        return max(float((a.double() - r).norm() / r.norm()) for a, r in zip(got, ref))
    k_err, p_err = worst(kernel), worst(plain(torch.float32))
    print(f"colour leaves vs float64: kernel {k_err:.3e}, float32 plain {p_err:.3e}")
    assert k_err <= 2 * p_err


@pytest.mark.parametrize("spec", PLANNER_SPECS, ids=PLANNER_IDS)
def test_segment_scratch_sizes_match_the_planner(dev, spec):
    """fused_train_cuda.bwd_sizes (the CPU tests' mirror) gives the scratch
    and partial-sum floats of csrc's planners (train_bwd_sizes) for every
    segment in both dot modes (the bf16 mode: field_tc.cuh's plan_bwd_tc for
    all three), and fwd_work_floats the SDF forward's workspace
    (train_sdf_fwd_work_floats: plan_sdf_fwd_tc in bf16), at point counts
    around the tiles, on base.yml's nets and on nets of other depths and
    padded widths."""
    import ctypes
    from endosurf_tpu_torch.kernels import fused_train as ft
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    eff = ft.prepare_effective(spec, params)
    lib = build.load_library()
    for seg in ftc.SEGMENTS if spec.use_deform else ("sdf", "color"):
        like, flat = ft.segment_weights(eff, seg)
        for precision in ("highest", "default"):
            packed = ftc.pack_segment(spec, seg, flat, like, precision)
            for n in (1, 63, 4097, RAGGED_N, 65536):
                got = (ctypes.c_longlong * 2)()
                lib.train_bwd_sizes(packed.meta, ftc.SEGMENTS.index(seg), int(packed.rb), n, got)
                assert tuple(got) == ftc.bwd_sizes(packed, n), (seg, precision, n)
                if seg == "sdf":
                    assert lib.train_sdf_fwd_work_floats(packed.meta, int(packed.rb), n) == \
                        ftc.fwd_work_floats(packed, n), (precision, n)


@pytest.mark.parametrize("seg", ["deform", "sdf", "color", "deform_fwd", "sdf_fwd"])
def test_segment_bf16_tails_are_float32_noise(dev, seg):
    """In bf16 the tensor-core kernels (the three backward kernels and the
    deform and SDF forward) sit about as far from a float64 plain version
    (the same bf16 roundings of every dot operand, input cotangent and weight
    gradient; float64 sums) as the float32 plain version does: both sum in
    float32, in other orders, and a bf16 rounding that the sums' last bits
    tip moves an activation or a cotangent by a bf16 ulp, which the next
    layers carry on (the reason for PARITY_TOL's bf16 limits). Against
    float64: a backward's worst leaf relative L2 and input-cotangent p99 (the
    SDF's d x_c; the colour's d x_c, d grad_c, d d_c, d feat) and a
    forward's outputs' median and p99 (the deform's x_c and rows, the SDF's
    sdf, feat and grad_c), each within 2x the float32 plain version's."""
    from endosurf_tpu_torch.kernels import fused_train as ft
    fwd = seg.endswith("_fwd")
    seg = seg.split("_")[0]
    spec = EndoSurfSpec()
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    x, d, t = _seg_points(65536, dev)
    with torch.no_grad():
        eff = ft.prepare_effective(spec, params)
        x_c, jrows = ft.seg_deform_math(spec, eff["deform"], torch.cat([x, t], -1), "default")
        _, feat, grad_c = ft.seg_sdf_math(spec, eff["sdf"], eff["sdf_head"], eff["sdf_feat"],
                                          x_c, "default")
        _, d_c = ft.coupling_math(jrows, grad_c, d)
    inputs = {"deform": (torch.cat([x, t], -1),), "sdf": (x_c,),
              "color": (x_c, grad_c, d_c, feat)}[seg]
    like, flat = ft.segment_weights(eff, seg)
    packed = ftc.pack_segment(spec, seg, flat, like, "default")
    with torch.no_grad():
        outs = ft.seg_math(spec, seg, like, flat, inputs, "default")
    if fwd:
        kernel = ftc.FWD[seg](packed, *inputs)
        with torch.no_grad():
            ref = ft.seg_math(spec, seg, like, [v.double() for v in flat],
                              [v.double() for v in inputs], "default")

        def stats(got):
            return [ftc._quantiles(ftc._point_err(g.double(), r))[:2] for g, r in zip(got, ref)]
        k_st, p_st = stats(kernel), stats(outs)
        print(f"{seg} fwd bf16 vs float64 (outputs' median, p99): kernel {k_st}; float32 "
              f"plain {p_st}")
        assert all(k <= 2 * p for ks, ps in zip(k_st, p_st) for k, p in zip(ks, ps))
        return
    gen = torch.Generator(device=dev).manual_seed(1)
    cots = tuple(torch.randn(*o.shape, generator=gen, device=dev) for o in outs)
    kernel = ftc.BWD[seg](packed, *inputs, *cots)
    plain = ft.plain_bwd(spec, seg, like, flat, inputs, cots, "default")
    ref = ft.plain_bwd(spec, seg, like, [v.double() for v in flat],
                       [v.double() for v in inputs], [c.double() for c in cots], "default")

    def worst(got):
        leaf = max(float((g.double() - r).norm() / max(float(r.norm()), 1e-300))
                   for g, r in zip(got[0], ref[0]))
        cot = [ftc._quantiles(ftc._point_err(g.double(), r))[1] for g, r in zip(got[1], ref[1])]
        return leaf, max(cot, default=0.0)
    (k_leaf, k_cot), (p_leaf, p_cot) = worst(kernel), worst(plain)
    print(f"{seg} bf16 vs float64: kernel leaf {k_leaf:.3e} cot p99 {k_cot:.3e}; float32 plain "
          f"leaf {p_leaf:.3e} cot p99 {p_cot:.3e}")
    assert k_leaf <= 2 * p_leaf and k_cot <= 2 * p_cot


# Faults planted in the segment kernels: per fault, one (file, text replaced,
# replacement) for each code path it lands in, and the dot modes that must
# catch it. The first three land in the float32 mode's SIMT kernels
# (fused_train.cu, wgrad.cuh) and in the bf16 mode's tensor-core ones
# (field_tc.cuh, wgrad_tc.cuh); the others are faults of the tensor-core
# design (mma_tile.cuh, field_tc.cuh), which only the bf16 mode runs.
BOTH, BF16 = ("highest", "default"), ("default",)
SEG_FAULTS = {
    "sdf_bwd_no_softplus2": ([
        ("fused_train.cu",
         "        sv.dz[l][row] = dag * sv.a[l][row] * 100.f * sig * (1.f - sig);",
         "        sv.dz[l][row] = 0.f;"),
        ("field_tc.cuh", "dag[e] * a[e] * 100.f * sig[e] * (1.f - sig[e]);", "0.f;")], BOTH),
    "wgrad_skips_last_partial_tile": ([
        ("wgrad.cuh", "  for (int k = k0; k < k1; k += 16) {",
         "  for (int k = k0; k + 16 <= k1; k += 16) {"),
        ("wgrad_tc.cuh", "  for (long long k = k0; k < k1; k += TC_KS) {",
         "  for (long long k = k0; k + TC_KS <= k1; k += TC_KS) {")], BOTH),
    "deform_bwd_drops_tangent_2": ([
        ("fused_train.cu",
         "          base + p < n ? g_j[(size_t)(base + p) * 9 + k * 3 + c] : 0.f;",
         "          base + p < n && k != 2 ? g_j[(size_t)(base + p) * 9 + k * 3 + c] : 0.f;"),
        ("field_tc.cuh", "                 : g_j[(size_t)(base + p) * 9 + (s - 1) * 3 + c];",
         "                 : (s == 3 ? 0.f : g_j[(size_t)(base + p) * 9 + (s - 1) * 3 + c]);")],
        BOTH),
    # a float32 operand's split keeps only its bf16 rounding (hi)
    "split_drops_lo": ([
        ("mma_tile.cuh", "  lo = __float2bfloat16_rn(x - __bfloat162float(hi));",
         "  lo = __float2bfloat16_rn(0.f);"),
        ("mma_tile.cuh", "  const float r = x - __bfloat162float(hi);", "  const float r = 0.f;")],
        BF16),
    # the tile product skips each product's last k-slab of weights
    "tile_skips_last_k_slab": ([
        ("mma_tile.cuh", "kt < kt1; ++kt,", "kt + 1 < kt1; ++kt,")], BF16),
    # the last, partial point tile takes one point fewer: that point's inputs read as zeros
    "ragged_tile_one_row_short": ([
        ("field_tc.cuh", "  return base + p < n;", "  return base + p + 1 < n;")], BF16),
    # the colour walk skips its second group of 256 input columns (the skip
    # layer's encoding columns 256 .. 511, layer 0's feature columns past 255)
    "color_walk_drops_group_2": ([
        ("field_tc.cuh", "for (int gr = (np_in - 1) / NPG; gr >= 1; --gr) {",
         "for (int gr = (np_in - 1) / NPG; gr >= 2; --gr) {")], BF16),
    # the colour's float32 output-layer cotangent reaches the weight-gradient
    # product as its bf16 rounding (hi) only
    "color_top_dz_drops_lo": ([
        ("field_tc.cuh", "      if (base + p < n) sv.dz[L - 1][(size_t)(base + p) * 4 + c] = v;",
         "      if (base + p < n) sv.dz[L - 1][(size_t)(base + p) * 4 + c] = bf16r(v);")], BF16),
    # the tile forward of the deform net leaves tangent stream 2 ungated (the
    # forward kernel and the backward's recompute share it)
    "deform_fwd_ungates_tangent_2": ([
        ("field_tc.cuh",
         "__float2bfloat16_rn(acc[k][nt][e] * sc * gate);",
         "__float2bfloat16_rn(acc[k][nt][e] * sc * (k == 2 ? 1.f : gate));")], BF16),
    # the SDF tile forward's adjoint drops its pass over the input columns past
    # the first 256 (the skip layer's encoding columns 256 .. 294), which the
    # forward kernel's grad_c and the backward's recompute share
    # the colour tile forward leaves the skip layer's colour input unwritten
    # (the forward kernel and the backward's recompute share it)
    "color_fwd_drops_skip_input": ([
        ("field_tc.cuh", "      put_enc(H, ldh, in_l - ci, E, ci, P, tid);\n", "")], BF16),
    "sdf_adjoint_drops_wide_pass": ([
        ("field_tc.cuh",
         "    const int npx = clampw(np_in - np_hmax - np_me);\n    if (npx > 0) {\n"
         "      zero_acc(acc);\n      tile_mma<MT, 1>",
         "    const int npx = 0;\n    if (npx > 0) {\n"
         "      zero_acc(acc);\n      tile_mma<MT, 1>")], BF16),
}


@pytest.mark.parametrize("fault", sorted(SEG_FAULTS))
def test_segment_limits_catch_planted_faults(dev, fault, tmp_path, monkeypatch):
    """A segment kernel built with a planted fault fails the limits (parity
    with the plain versions, or the order check) at the ragged point count,
    in each dot mode whose kernels the fault reaches."""
    edits, precisions = SEG_FAULTS[fault]
    _rebuild_with_all(monkeypatch, tmp_path, edits)
    spec = EndoSurfSpec()
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    pts = _seg_points(RAGGED_N, dev)
    for precision in precisions:
        res, _, _ = ftc.segment_parity(spec, params, *pts, precision, 0)
        _, rel = _order_errors(spec, params, pts, precision)
        print(f"{fault} {precision}: parity worst {_worst(res)}; order worst "
              f"{max(rel.values()):.3e}")
        assert not (ftc.parity_ok(res) and max(rel.values()) <= ORDER_TOL[precision]), precision


def _scratch_array(scratch, layout, name: str, layer: int) -> torch.Tensor:
    """One array of ``fused_train_cuda.tc_scratch_layout`` as a view of the
    float32 scratch."""
    _, _, off, shape, dt = next(a for a in layout if a[:2] == (name, layer))
    nbytes = shape[0] * shape[1] * (2 if dt == torch.bfloat16 else 4)
    return scratch.view(torch.uint8)[off:off + nbytes].view(dt).view(shape)


def test_sdf_fwd_is_the_backward_recompute(dev, tmp_path, monkeypatch):
    """In bf16 the SDF forward kernel and the SDF backward's recompute run one
    tile forward (field_tc.cuh's sdf_tc_forward), so the forward the loss sees
    is the one the backward differentiates, bit for bit: at a ragged point
    count, every hidden layer's pre-activations in the forward's workspace
    equal the backward's saved ones; sdf and feat are the output layer's
    product of the last hidden rows the backward saves (within float32
    rounding: the product's sum order is the mma's); grad_c equals, bit for
    bit, the one a build whose backward writes its recompute's grad_c (through
    the forward kernel's own sdf_tc_grad_c) in place of d x_c returns."""
    recompute_grad_c = "sdf_tc_forward<true>(wts, m, fr, n, base, xc, SdfTile{Hh, E, g1, aE, xs}, ring, sv, nullptr,\n                       nullptr);\n"
    _rebuild_with_all(monkeypatch, tmp_path, [(
        "field_tc.cuh", recompute_grad_c,
        recompute_grad_c + "  sdf_tc_grad_c(m, SdfTile{Hh, E, g1, aE, xs}, base, n, dxc);\n  return;\n")])
    from endosurf_tpu_torch.kernels import fused_train as ft
    spec = EndoSurfSpec()
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    x, _, _ = _seg_points(RAGGED_N, dev)
    n = x.shape[0]
    with torch.no_grad():
        like, flat = ft.segment_weights(ft.prepare_effective(spec, params), "sdf")
    packed = ftc.pack_segment(spec, "sdf", flat, like, "default")
    lib = build.load_library()
    f = packed.layers[-1][3] - 1
    sdf, feat, grad_c = (torch.empty(n, w, device=dev) for w in (1, f, 3))
    work = torch.empty(lib.train_sdf_fwd_work_floats(packed.meta, 1, n), device=dev)
    ftc._run("train_sdf_fwd", packed, x.device, n, x, sdf, feat, grad_c, work)
    gen = torch.Generator(device=dev).manual_seed(1)
    cots = [torch.randn(n, w, generator=gen, device=dev) for w in (1, f, 3)]
    scratch, partial, grad = ftc._bwd_buffers(packed, n, x.device)
    probe = torch.empty(n, 3, device=dev)
    ftc._run("train_sdf_bwd", packed, x.device, n, x, *cots, probe, scratch, partial, grad)
    torch.cuda.synchronize()
    layout, _ = ftc.tc_scratch_layout(packed, n)
    off = 0
    for l, lay in enumerate(packed.layers[:-1]):
        z_fwd = work.view(torch.uint8)[off:off + 4 * n * lay[3]].view(torch.float32).view(n, -1)
        off = -(-(off + 4 * n * lay[3]) // 256) * 256
        assert torch.equal(z_fwd, _scratch_array(scratch, layout, "z", l)), l
    w_off, b_off, n_in, n_out, _ = packed.layers[-1]
    h = _scratch_array(scratch, layout, "xin", NL - 1)[:, :n_in].double()
    w = packed.w[w_off:w_off + n_in * n_out].view(n_in, n_out).double()
    ref = h @ w + packed.w[b_off:b_off + n_out].double()
    bound = (h.abs() @ w.abs()) * 2.0 ** -18 + ref.abs() * 2.0 ** -23
    got = torch.cat([sdf, feat], -1).double()
    print(f"sdf fwd output layer vs float64 of the saved rows: max |err| / bound "
          f"{float(((got - ref).abs() / bound).max()):.3e}")
    assert bool(((got - ref).abs() <= bound).all())
    assert torch.equal(grad_c, probe)


@pytest.mark.parametrize("precision", ["highest", "default"], ids=["f32", "bf16"])
def test_sdf_segments_take_other_nets(dev, precision):
    """The segment kernels against their plain versions at PARITY_TOL for a
    static spec whose SDF net has no skip layer, and for one whose SDF net is
    200 wide (not a multiple of 16: the tensor-core SDF backward's adjoint
    then shares a k-tile between the skip layer's h part and its encoding,
    and runs the two rounded dots one after the other). In bf16 the 200-wide
    SDF segment's forward and backward are also held against the float64
    plain version (test_segment_bf16_tails_are_float32_noise's test: a
    backward's worst leaf relative L2 and d x_c p99, the forward's outputs'
    median and p99, each within 2x the float32 plain version's), and a
    reading outside PARITY_TOL passes only where that holds for it, for the
    SDF's d x_c alone and within twice its limits (the plain version's own
    bf16 noise on this net: d x_c p99 read 1.01e-2 against the limit 1e-2,
    chip_smoke's float64_fallback rule). An SDF net
    320 wide, past the kernels' box, is refused."""
    from endosurf_tpu_torch.kernels import fused_train as ft
    spec = dataclasses.replace(EndoSurfSpec(use_deform=False), sdf=MLPSpec(9, 256, (), 257))
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    res, _, _ = ftc.segment_parity(spec, params, *_seg_points(SEG_N, dev), precision, 0)
    torch.cuda.synchronize()
    print(f"segments sdf noskip {precision}: worst {_worst(res)}")
    assert ftc.parity_ok(res), _report(res)
    w200 = dataclasses.replace(EndoSurfSpec(use_deform=False), sdf=MLPSpec(9, 200, (4,), 201),
                               color_feat_dim=200)
    params = init_endosurf_params(w200, torch.Generator().manual_seed(0), dev)
    res, _, cases = ftc.segment_parity(w200, params, *_seg_points(SEG_N, dev), precision, 0)
    print(f"segments sdf w200 {precision}: worst {_worst(res)}")
    if precision == "highest":
        assert ftc.parity_ok(res), _report(res)
    else:
        like, flat, packed, inputs, cots = cases["sdf"]
        f64 = ([v.double() for v in flat], [v.double() for v in inputs])
        with torch.no_grad():
            ref = ft.seg_math(w200, "sdf", like, *f64, "default")
            k_out, p_out = ([ftc._quantiles(ftc._point_err(g.double(), r))[:2]
                             for g, r in zip(got, ref)]
                            for got in (ftc.FWD["sdf"](packed, *inputs),
                                        ft.seg_math(w200, "sdf", like, flat, inputs, "default")))
        ref = ft.plain_bwd(w200, "sdf", like, *f64, [c.double() for c in cots], "default")

        def worst(got):
            leaf = max(float((g.double() - r).norm() / max(float(r.norm()), 1e-300))
                       for g, r in zip(got[0], ref[0]))
            return leaf, ftc._quantiles(ftc._point_err(got[1][0].double(), ref[1][0]))[1]
        (k_leaf, k_cot), (p_leaf, p_cot) = (
            worst(ftc.BWD["sdf"](packed, *inputs, *cots)),
            worst(ft.plain_bwd(w200, "sdf", like, flat, inputs, cots, "default")))
        print(f"sdf w200 bf16 vs float64: fwd outputs (median, p99) kernel {k_out}, float32 "
              f"plain {p_out}; bwd kernel leaf {k_leaf:.3e} cot p99 {k_cot:.3e}, float32 plain "
              f"leaf {p_leaf:.3e} cot p99 {p_cot:.3e}")
        assert all(k <= 2 * p for ks, ps in zip(k_out, p_out) for k, p in zip(ks, ps))
        assert k_leaf <= 2 * p_leaf and k_cot <= 2 * p_cot
        bound = [2 * v for v in ftc.parity_tol(torch.bfloat16, "cot")]
        for seg, kinds in _report(res).items():
            for kind, vals in kinds.items():
                # outside PARITY_TOL only where the float64 reading above judges it
                # (the SDF backward's d x_c), and then within twice the limit
                assert not vals or (seg, kind, set(vals)) == ("sdf", "cot", {"x_c"}), (seg, kind)
                assert all(v <= b for v, b in zip(vals.get("x_c", ()), bound)), vals
    wide = dataclasses.replace(w200, sdf=MLPSpec(9, 320, (4,), 201))
    with pytest.raises(ValueError, match="no wider than 256"):
        ftc.segment_parity(wide, init_endosurf_params(wide, torch.Generator().manual_seed(0),
                                                      dev), *_seg_points(64, dev), precision, 0)


def test_train_step_runs_the_segment_kernels(dev, tmp_path):
    """On CUDA tensors the train step's field evaluation launches each
    segment kernel once (forward in the loss, backward in backward);
    megakernel "off" (in the trainer and in fused_point_eval) and a spec the
    kernels cannot take raise."""
    scene = make_synthetic_arrays(4, 64, 80, 0, dev)
    params = init_endosurf_params(NARROW, torch.Generator().manual_seed(0), dev)
    for v in flatten(params).values():
        v.requires_grad_(True)
    weights = {"color_loss_weight": 1.0, "depth_loss_weight": 1.0, "sdf_loss_weight": 1.0,
               "angle_loss_weight": 0.1, "eikonal_loss_weight": 0.1,
               "surf_neig_loss_weight": 0.1}
    before = dict(ftc.LAUNCHES)
    total, _ = make_loss_fn(NARROW, es.RenderSpec(), 64, 80, 256, weights, 0.1,
                            precision="default")(params, scene.device_arrays, 100.0,
                                                 torch.Generator(device=dev).manual_seed(0))
    assert {k: ftc.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k.endswith("fwd")) for k in before}
    total.backward()
    assert all(ftc.LAUNCHES[k] - before[k] == 1 for k in before)
    cfg = {"exp": {"project_name": "p", "exp_name": "e", "exp_dir": str(tmp_path)},
           "train": {"megakernel": "off", "n_iter": 1, "optim": {"lr": 1e-4}}, "net": {},
           "render": {}}
    with pytest.raises(NotImplementedError, match="megakernel: off"):
        EndoSurfTrainer(cfg, scene=scene, device=dev)
    x, d, t = _seg_points(64, dev)
    with pytest.raises(NotImplementedError, match="megakernel: off"):
        fused_point_eval(NARROW, params, x, d, t, megakernel="off")
    bad = EndoSurfSpec(sdf=MLPSpec(10, 256, (4,), 257))
    bad_params = init_endosurf_params(bad, torch.Generator().manual_seed(0), dev)
    with pytest.raises(ValueError, match="do not take"):
        fused_point_eval(bad, bad_params, x, d, t)


# ---------------------------------------------------------------------------
# the observed-SDF query (csrc/fused_sdf.cu) and the ray march
# (csrc/fused_sampler.cu's march)
# ---------------------------------------------------------------------------

SPEC_BY_ID = dict(zip(SPEC_IDS, SPECS))
F32_BF16 = (torch.float32, torch.bfloat16)


def _sdf_points(n: int, dev, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return ((torch.rand(n, 3, generator=g) * 2.4 - 1.2).to(dev),
            torch.rand(n, 1, generator=g).to(dev))


def _rebuild_with(monkeypatch, tmp_path, name: str, old: str, new: str) -> None:
    """Point build.py at a copy of csrc/ with ``old`` replaced in ``name``."""
    _rebuild_with_all(monkeypatch, tmp_path, [(name, old, new)])


def _rebuild_with_all(monkeypatch, tmp_path, edits) -> None:
    """Point build.py at a copy of csrc/ with each (name, old, new) of
    ``edits`` applied: ``old`` (found once) replaced in file ``name``."""
    if shutil.which("nvcc") is None and not osp.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc")
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC, src)
    for name, old, new in edits:
        text = (src / name).read_text()
        assert text.count(old) == 1, (name, old)
        (src / name).write_text(text.replace(old, new))
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_LIB", None)


# (spec id, points): three sizes of the full net (ragged), the narrow and
# the static nets at one
SDF_CELLS = [("full", 1000), ("full", 65537), ("full", 1048576), ("narrow", 65537),
             ("full-static", 65537)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cell", SDF_CELLS, ids=[f"{s}-{n}" for s, n in SDF_CELLS])
@pytest.mark.parametrize("dtype", F32_BF16, ids=["f32", "bf16"])
def test_sdf_query_kernel_matches_plain(dev, dtype, cell, seed):
    """The query against its plain version (fused_sdf.PARITY_TOL) and, in
    bf16 (tensor cores), against its float64 yardstick too
    (fused_sdf.FLOAT64_TOL)."""
    spec = SPEC_BY_ID[cell[0]]
    params = init_endosurf_params(spec, torch.Generator().manual_seed(seed), dev)
    x, t = _sdf_points(cell[1], dev, seed)
    got = fsd.fused_sdf_observed_cuda(spec, params, x, t, dtype)
    ref = fsd.fused_sdf_observed_reference(spec, params, x, t, dtype)
    torch.cuda.synchronize()
    assert got.shape == (cell[1], 1) and got.dtype == torch.float32
    errs = fsd.parity_errors(got, ref, dtype)
    print(f"sdf query sound {dtype} {cell} seed {seed}: median / p99 / max {errs[:3]}")
    assert errs[-1], errs
    if dtype == torch.bfloat16:
        errs = fsd.float64_errors(got, fsd.fused_sdf_observed_float64(spec, params, x, t))
        print(f"sdf query sound bf16 {cell} seed {seed} vs float64: median / p99 / max "
              f"{errs[:3]}")
        assert errs[-1], errs


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_sdf_query_limits_reject_the_other_precision(dev, spec):
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    x, t = _sdf_points(65537, dev)
    for plain_dt, kernel_dt in (F32_BF16, F32_BF16[::-1]):
        got = fsd.fused_sdf_observed_cuda(spec, params, x, t, kernel_dt)
        errs = fsd.parity_errors(got, fsd.fused_sdf_observed_reference(spec, params, x, t,
                                                                       plain_dt), plain_dt)
        print(f"sdf query control: kernel {kernel_dt} vs plain {plain_dt}: {errs[:3]}")
        assert not errs[-1], errs


def test_sdf_query_entry_and_dispatch(dev):
    """No points, one point, the checks, and the paths that run the kernel:
    _sdf_sampling (once a call, at every N) and the renderer's grid hook."""
    params = init_endosurf_params(NARROW, torch.Generator().manual_seed(0), dev)
    x, t = _sdf_points(1, dev)
    assert fsd.fused_sdf_observed_cuda(NARROW, params, x[:0], t[:0]).shape == (0, 1)
    one = fsd.fused_sdf_observed_cuda(NARROW, params, x, t)
    torch.testing.assert_close(one, fsd.fused_sdf_observed_reference(NARROW, params, x, t),
                               rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="expected"):
        fsd.fused_sdf_observed_cuda(NARROW, params, x, t[:, :0])
    with pytest.raises(ValueError, match="params on"):
        fsd.fused_sdf_observed_cuda(
            NARROW, init_endosurf_params(NARROW, torch.Generator().manual_seed(0)), x, t)
    bad = EndoSurfSpec(sdf=MLPSpec(10, 256, (4,), 257))
    with pytest.raises(ValueError, match="does not take"):
        fsd.fused_sdf_observed_cuda(
            bad, init_endosurf_params(bad, torch.Generator().manual_seed(0), dev), x, t)
    before = fsd.LAUNCHES["fused_sdf_observed"]
    for n in (3, 9000):
        xs, ts = _sdf_points(n, dev)
        es._sdf_sampling(NARROW, params, xs, ts, "default")
    assert fsd.LAUNCHES["fused_sdf_observed"] == before + 2


SDF_FAULTS = {
    # csrc/sdf_chain.cuh, the point-list store, which the SIMT sweep (float32)
    # and the tensor-core one (bf16) both store through: 0.1 % off on 1
    # point in 64
    "scale_sdf_i64": [("sdf_chain.cuh",
                       "  __device__ void store(long long i, float v) const { dst[i] = v; }",
                       "  __device__ void store(long long i, float v) const {\n"
                       "    dst[i] = (i % 64 == 0) ? v * 1.001f : v;\n  }")],
    # a sparse fault in each sweep's own point path: the last partial tile's
    # points (one of 65,537) written as 0 (tensor cores: csrc/sweep_tc.cuh)
    "tail_tile_zeroed": [
        ("sdf_chain.cuh", "    if (i < src.n) src.store(i, a + wts[N.b_off[l]]);",
         "    if (i < src.n) src.store(i, base + P_SWEEP > src.n ? 0.f : a + wts[N.b_off[l]]);"),
        ("sweep_tc.cuh",
         "    if (base + tid < src.n) src.store(base + tid, (float)(a + (double)wts[S.b_off[l]]));",
         "    if (base + tid < src.n)\n"
         "      src.store(base + tid, base + P > src.n ? 0.f\n"
         "                            : (float)(a + (double)wts[S.b_off[l]]));")],
}


@pytest.mark.parametrize("fault", sorted(SDF_FAULTS))
def test_sdf_query_limits_catch_planted_faults(dev, fault, tmp_path, monkeypatch):
    """The query built with a planted fault fails its limits in both modes:
    the SIMT sweep in float32 (against the plain version), the tensor-core
    sweep in bf16 (the plain version's limits or the float64 yardstick's;
    the profiler shows that sweep_tc_kernel ran)."""
    _rebuild_with_all(monkeypatch, tmp_path, SDF_FAULTS[fault])
    spec = EndoSurfSpec()
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    x, t = _sdf_points(65537, dev)
    for dtype in F32_BF16:
        got = fsd.fused_sdf_observed_cuda(spec, params, x, t, dtype)
        errs = fsd.parity_errors(got, fsd.fused_sdf_observed_reference(spec, params, x, t, dtype),
                                 dtype)
        print(f"{fault} {dtype}: {errs[:3]}")
        if dtype == torch.float32:
            assert not errs[-1], errs
            continue
        f64 = fsd.float64_errors(got, fsd.fused_sdf_observed_float64(spec, params, x, t))
        print(f"{fault} bf16 vs float64: {f64[:3]}")
        assert not (errs[-1] and f64[-1]), (errs, f64)
        names = _traced_kernels("sdf query bf16")["sdf query bf16"]
        assert any("sweep_tc_kernel" in k and "dn_" not in k for k in names), names


def test_sdf_query_tensor_cores_no_farther_from_float64(dev):
    """The condition under which the bf16 query's p99 limit against the plain
    version moved (fused_sdf.PARITY_TOL): on SDF_CELLS (the full net at
    three sizes, the narrow net, the static net), two weight seeds, the
    tensor-core query's median and p99 per-point error against its float64
    yardstick (fused_sdf_observed_float64) are no larger than the SIMT bf16
    sweep's (simt=True) on the same points
    (fused_train_dnerf.tc_float64_distance)."""
    failed = []
    for sid, n in SDF_CELLS:
        spec = SPEC_BY_ID[sid]
        for seed in (0, 1):
            params = init_endosurf_params(spec, torch.Generator().manual_seed(seed), dev)
            dist = ftd.tc_float64_distance(spec, params, "fused_sdf_observed", None, None,
                                           _sdf_points(n, dev, seed))
            print(f"sdf query bf16 vs float64 {sid} {n} seed {seed} (median, p99): "
                  + "; ".join(f"{nm} {v['sdf'][0]:.4e}, {v['sdf'][1]:.4e}"
                              for nm, v in dist.items()))
            if not fr.no_farther(dist["tensor cores"], dist["SIMT"])["sdf"]:
                failed.append((sid, n, seed))
    assert not failed, failed


def test_sdf_query_runs_on_tensor_cores(dev):
    """A bf16 query launches the tensor-core sweep (sweep_tc_kernel over a
    point list) and not the SIMT sweep; simt=True and the float32 query
    launch the SIMT sweep and no tensor-core kernel."""
    traced = _traced_kernels("sdf query bf16", "sdf query bf16 simt", "sdf query f32")
    tc = traced["sdf query bf16"]
    print(sorted(tc), sorted(traced["sdf query bf16 simt"]), sorted(traced["sdf query f32"]))
    assert any("sweep_tc_kernel" in k and "PointList" in k for k in tc)
    assert not any("sweep_kernel<" in k for k in tc)
    for what in ("sdf query bf16 simt", "sdf query f32"):
        assert any("sweep_kernel<" in k for k in traced[what]), what
        assert not any("_tc_" in k for k in traced[what]), what


def _march_inputs(n: int, dev, seed: int = 0):
    rays = _rays(n, "cpu", 1 + seed)
    o, d, d_z, t = es._split_rays(rays)
    near, far, _ = ray_sphere_intersection(o, d)
    return tuple(v.contiguous().to(dev) for v in (o, d_z, t, near, far))


def _march_check(spec, params, ins, got, ref, dtype, tau=0.0):
    """(within every MARCH_TOL limit, readings)."""
    par = fs.march_parity(got, ref, dtype)
    own = fs.march_consistency(spec, params, *ins[:3], got, dtype, tau)
    return all(v[1] for v in par.values()) and all(v[1] for v in own.values()), (par, own)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n", [64, 1024, 4099])
@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
@pytest.mark.parametrize("dtype", F32_BF16, ids=["f32", "bf16"])
def test_march_kernel_matches_plain(dev, dtype, spec, n, seed):
    params = init_endosurf_params(spec, torch.Generator().manual_seed(seed), dev)
    ins = _march_inputs(n, dev, seed)
    got = fs.fused_ray_march_cuda(spec, params, *ins, sampling_dtype=dtype)
    ref = fs.fused_ray_march_reference(spec, params, *ins, sampling_dtype=dtype)
    torch.cuda.synchronize()
    assert got["depth"].shape == (n, 1) and got["valid"].dtype == torch.bool
    assert bool(torch.isfinite(got["depth"]).all())
    ok, report = _march_check(spec, params, ins, got, ref, dtype)
    print(f"march sound {dtype} n {n} seed {seed}: "
          f"{100 * float(got['valid'].float().mean()):.1f} % valid; {report}")
    assert ok, report


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_march_limits_reject_the_other_precision(dev, spec):
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    ins = _march_inputs(1024, dev)
    for ref_dt, kernel_dt in (F32_BF16, F32_BF16[::-1]):
        got = fs.fused_ray_march_cuda(spec, params, *ins, sampling_dtype=kernel_dt)
        ref = fs.fused_ray_march_reference(spec, params, *ins, sampling_dtype=ref_dt)
        ok, report = _march_check(spec, params, ins, got, ref, ref_dt)
        print(f"march control: kernel {kernel_dt} vs plain {ref_dt}: {report}")
        assert not ok, report


# Faults planted in csrc/fused_sampler.cu's march on the rays r % 64 == 0,
# which the float32 march (SIMT sweeps) and the bf16 one (tensor-core
# sweeps) share, each with the level tau it is judged at: the crossing a bin
# late, the secant steps skipped, the SDF of the secant sweeps scaled by
# 0.1 %. The march must fail the limits against its plain version (float32)
# or those or the float64 ones (bf16, MARCH_FLOAT64_TOL: the secant steps
# move a depth by ~1e-4 in SDF, under the float32 plain version's bf16
# tips). A scale moves no root of sdf - tau at tau 0, only the secant's path
# (by ~2e-6 in depth): the sparse scale is judged at tau -0.4, half the
# seeded nets' radius, where it moves the level set by 0.4 permille of the
# SDF, and must fail the float64 limits.
MARCH_FAULTS = {
    "crossing_one_bin_late_r64": (
        "    if (vj * vn < 0.f) { idx = j; break; }",
        "    if (vj * vn < 0.f) { idx = (r % 64 == 0 && j + 2 < S) ? j + 1 : j; break; }", 0.0),
    "no_secant_r64": (
        "  const float f_mid = -(st[5] - tau);",
        "  if (r % 64 == 0) return;\n  const float f_mid = -(st[5] - tau);", 0.0),
    "secant_sdf_scaled_r64": (
        "  const float f_mid = -(st[5] - tau);",
        "  const float f_mid = -(st[5] * (r % 64 == 0 ? 1.001f : 1.f) - tau);", -0.4),
}


def _march_f64(spec, params, ins, tau=0.0, **outs):
    """(march_float64_distance of each march in outs, within MARCH_FLOAT64_TOL
    each)."""
    dist = fs.march_float64_distance(spec, params, *ins, outs, tau)
    return dist, {k: fs.march_float64_ok(v) for k, v in dist.items()}


@pytest.mark.parametrize("fault", sorted(MARCH_FAULTS))
def test_march_limits_catch_planted_faults(dev, fault, tmp_path, monkeypatch):
    old, new, tau = MARCH_FAULTS[fault]
    _rebuild_with(monkeypatch, tmp_path, "fused_sampler.cu", old, new)
    spec = EndoSurfSpec()
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    ins = _march_inputs(1024, dev)
    for dtype in F32_BF16:
        got = fs.fused_ray_march_cuda(spec, params, *ins, tau, sampling_dtype=dtype)
        ref = fs.fused_ray_march_reference(spec, params, *ins, tau, sampling_dtype=dtype)
        ok, report = _march_check(spec, params, ins, got, ref, dtype, tau)
        print(f"{fault} {dtype} tau {tau}: {report}")
        if dtype == torch.float32:
            assert not ok, report
            continue
        dist, f64_ok = _march_f64(spec, params, ins, tau, tensor_cores=got)
        print(f"{fault} bf16 vs float64 tau {tau}: {dist} (tol {fs.MARCH_FLOAT64_TOL})")
        assert not f64_ok["tensor_cores"] if fault == "secant_sdf_scaled_r64" else not (
            ok and f64_ok["tensor_cores"]), (report, dist)


# (spec id, rays, tau) of the float64 comparison: the three nets at tau 0,
# and the full net at the sparse scale fault's level
MARCH_F64_CELLS = [(sid, n, 0.0) for sid in SPEC_IDS for n in (1024, 4099)] + [
    ("full", 1024, -0.4)]


def test_march_tensor_cores_no_farther_from_float64(dev):
    """On MARCH_F64_CELLS, two weight seeds, the bf16 march on tensor cores
    is within MARCH_FLOAT64_TOL of its float64 yardstick
    (fused_ray_march_float64) and no farther from it than the SIMT bf16
    march (simt=True) on the same rays (fused_sampler.march_float64_distance):
    on each cell the depth and the residual against the yardstick's (median
    and p99) and the share off by more than 1e-6 on rays with the same
    crossing; the flipped crossings over all the cells. A flip is one ray
    whose crossing sample sits within a tipped bf16 rounding of tau, which
    either kernel tips now and then: per cell the tensor cores read 0 or 1
    ray where the SIMT march reads 0 to 6 (PERF.md §6)."""
    failed, flips = [], {"tensor cores": 0.0, "SIMT": 0.0}
    for sid, n, tau in MARCH_F64_CELLS:
        spec = SPEC_BY_ID[sid]
        for seed in (0, 1):
            params = init_endosurf_params(spec, torch.Generator().manual_seed(seed), dev)
            ins = _march_inputs(n, dev, seed)
            dist, ok = _march_f64(spec, params, ins, tau, **{
                nm: fs.fused_ray_march_cuda(spec, params, *ins, tau,
                                            sampling_dtype=torch.bfloat16, simt=simt)
                for nm, simt in (("tensor cores", False), ("SIMT", True))})
            print(f"march bf16 vs float64 {sid} {n} tau {tau} seed {seed}: " + "; ".join(
                f"{nm} flip {v['flip'][0]:.4e}, depth {v['depth'][0]:.4e} {v['depth'][1]:.4e}, "
                f"residual {v['residual'][0]:.4e} {v['residual'][1]:.4e}, off {v['off'][0]:.4e}"
                for nm, v in dist.items()))
            for nm in flips:
                flips[nm] += dist[nm]["flip"][0] * n
            nearer = fr.no_farther(*({k: v for k, v in dist[nm].items() if k != "flip"}
                                     for nm in ("tensor cores", "SIMT")))
            if not (all(nearer.values()) and ok["tensor cores"]):
                failed.append((sid, n, tau, seed, nearer, ok["tensor cores"]))
    print(f"flipped rays over the cells: {flips}")
    assert not failed, failed
    assert flips["tensor cores"] <= flips["SIMT"], flips


def test_march_runs_on_tensor_cores(dev):
    """A bf16 march launches the tensor-core sweep (sweep_tc_kernel over ray
    samples) for its scan and every secant step and no SIMT sweep; simt=True
    and the float32 march launch the SIMT sweep and no tensor-core kernel."""
    traced = _traced_kernels("march bf16", "march bf16 simt", "march f32")
    tc = traced["march bf16"]
    print(sorted(tc), sorted(traced["march bf16 simt"]), sorted(traced["march f32"]))
    assert any("sweep_tc_kernel" in k and "RaySamples" in k for k in tc)
    assert not any("sweep_kernel<" in k for k in tc)
    for what in ("march bf16 simt", "march f32"):
        assert any("sweep_kernel<" in k for k in traced[what]), what
        assert not any("_tc_" in k for k in traced[what]), what


def test_march_reuses_the_upsampling_pack(dev):
    """The upsampling and the march on one parameter set build one sampling
    pack between them (fused_sampler.cached_sampling_pack); an in-place
    update of a weight (an optimizer step) repacks."""
    spec = EndoSurfSpec()
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    before = fs.PACKS["sampling"]
    _upsample(fs.fused_upsample_z_cuda, spec, params, _upsample_inputs(256, dev),
              torch.bfloat16, True)
    fs.fused_ray_march_cuda(spec, params, *_march_inputs(256, dev),
                            sampling_dtype=torch.bfloat16)
    assert fs.PACKS["sampling"] == before + 1
    with torch.no_grad():
        params["sdf_network"]["layers"][0]["b"].add_(1e-3)
    fs.fused_ray_march_cuda(spec, params, *_march_inputs(256, dev),
                            sampling_dtype=torch.bfloat16)
    assert fs.PACKS["sampling"] == before + 2


def test_sphere_trace_runs_the_march_kernel(dev):
    """ray_march and the train step's surface search without reused samples
    launch the march kernel once a call; its input checks raise."""
    params = init_endosurf_params(NARROW, torch.Generator().manual_seed(0), dev)
    rays = _rays(256, dev)
    before = fs.LAUNCHES["fused_ray_march"]
    depth, valid = es.ray_march(NARROW, params, rays)
    assert fs.LAUNCHES["fused_ray_march"] == before + 1
    assert depth.shape == valid.shape == (256, 1) and bool(torch.isfinite(depth).all())
    mask = torch.ones(256, 1, device=dev)
    pts2, valid2 = es.surface_neighbour_points(NARROW, params, rays, mask,
                                               offset_uniform=torch.rand(256, 3, device=dev))
    assert fs.LAUNCHES["fused_ray_march"] == before + 2 and pts2.shape == (512, 3)
    assert torch.equal(valid2, valid)
    ins = _march_inputs(8, dev)
    with pytest.raises(ValueError, match="expected"):
        fs.fused_ray_march_cuda(NARROW, params, *ins[:3], ins[3][:4], ins[4])
    with pytest.raises(ValueError, match="unsupported march"):
        fs.fused_ray_march_cuda(NARROW, params, *ins, n_steps=1)
    with pytest.raises(ValueError, match="params on"):
        fs.fused_ray_march_cuda(
            NARROW, init_endosurf_params(NARROW, torch.Generator().manual_seed(0)), *ins)
    spec = dataclasses.replace(NARROW, use_deform=False)
    out = fs.fused_ray_march_cuda(spec, init_endosurf_params(spec, torch.Generator(), dev), *ins)
    assert out["depth"].shape == (8, 1)


# ---------------------------------------------------------------------------
# the EndoNeRF kernels: fused_density_raw (csrc/fused_sdf.cu), the render
# (csrc/fused_render_dnerf.cu) and the forward segments
# (csrc/fused_train_dnerf.cu)
# ---------------------------------------------------------------------------

DN_NARROW = en.DNeRFSpec(deform_layers=(3, 64, (1,)), density_layers=(3, 64, (1,)),
                         color_layers=(2, 64, ()), geo_feat_dim=32)
DN_SPECS = [DN_NARROW, en.DNeRFSpec(), en.DNeRFSpec(use_deform=False)]
DN_BY_ID = dict(zip(SPEC_IDS, DN_SPECS))
DN_CELLS = [("full", 1000), ("full", 65537), ("full", 1048576), ("narrow", 65537),
            ("full-static", 65537)]


def _dn_params(spec, seed, dev):
    return en.init_dnerf_params(spec, torch.Generator().manual_seed(seed), dev)


def _density_errs(spec, params, x, t, kernel_dt, plain_dt):
    got = fsd.fused_density_raw_cuda(spec, params, x, t, kernel_dt)
    ref = fsd.fused_density_raw_reference(spec, params, x, t, plain_dt)
    torch.cuda.synchronize()
    return fsd.parity_errors(got, ref, plain_dt, fsd.DENSITY_PARITY_TOL)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cell", DN_CELLS, ids=[f"{s}-{n}" for s, n in DN_CELLS])
@pytest.mark.parametrize("dtype", F32_BF16, ids=["f32", "bf16"])
def test_density_raw_kernel_matches_plain(dev, dtype, cell, seed):
    spec = DN_BY_ID[cell[0]]
    params = _dn_params(spec, seed, dev)
    x, t = _sdf_points(cell[1], dev, seed)
    assert fsd.fused_density_raw_cuda(spec, params, x, t, dtype).shape == (cell[1], 1)
    errs = _density_errs(spec, params, x, t, dtype, dtype)
    print(f"density raw sound {dtype} {cell} seed {seed}: median / p99 / max {errs[:3]}")
    assert errs[-1], errs


@pytest.mark.parametrize("spec", DN_SPECS, ids=SPEC_IDS)
def test_density_raw_limits_reject_the_other_precision(dev, spec):
    params = _dn_params(spec, 0, dev)
    x, t = _sdf_points(65537, dev)
    for plain_dt, kernel_dt in (F32_BF16, F32_BF16[::-1]):
        errs = _density_errs(spec, params, x, t, kernel_dt, plain_dt)
        print(f"density raw control: kernel {kernel_dt} vs plain {plain_dt}: {errs[:3]}")
        assert not errs[-1], errs


def test_density_raw_entry_and_dispatch(dev, tmp_path):
    """No points, one point, the checks, and the paths that run the kernel:
    density_observed (once a call, at every N) and the EndoNeRF renderer's
    grid hook."""
    from endosurf_tpu_torch.serve import EndoNeRFRenderer
    params = _dn_params(DN_NARROW, 0, dev)
    x, t = _sdf_points(1, dev)
    assert fsd.fused_density_raw_cuda(DN_NARROW, params, x[:0], t[:0]).shape == (0, 1)
    one = fsd.fused_density_raw_cuda(DN_NARROW, params, x, t)
    torch.testing.assert_close(one, fsd.fused_density_raw_reference(DN_NARROW, params, x, t),
                               rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="expected"):
        fsd.fused_density_raw_cuda(DN_NARROW, params, x, t[:, :0])
    with pytest.raises(ValueError, match="params on"):
        fsd.fused_density_raw_cuda(DN_NARROW, _dn_params(DN_NARROW, 0, "cpu"), x, t)
    bad = dataclasses.replace(DN_NARROW, color_layers=(2, 64, (1,)))
    with pytest.raises(ValueError, match="do not take"):
        fsd.fused_density_raw_cuda(bad, _dn_params(bad, 0, dev), x, t)
    before = fsd.LAUNCHES["fused_density_raw"]
    for n in (3, 9000):
        xs, ts = _sdf_points(n, dev)
        en.density_observed(DN_NARROW, params, xs, ts, "default")
    assert fsd.LAUNCHES["fused_density_raw"] == before + 2
    cfg = {"exp": {"project_name": "p", "exp_name": "e", "exp_dir": str(tmp_path)},
           "render": {"type": "endonerf"}, "net": {"net_deform_cfg": {"n_layers": 3,
                                                                      "hidden_dim": 64,
                                                                      "skips": [1]}}}
    renderer = EndoNeRFRenderer(cfg, scene=make_synthetic_arrays(4, 8, 8, 0, dev), device=dev)
    xs, ts = _sdf_points(5000, dev)
    field = renderer.demo_field_fn()(xs, ts)
    assert fsd.LAUNCHES["fused_density_raw"] == before + 3
    torch.testing.assert_close(field, -fsd.fused_density_raw_reference(
        renderer.spec, renderer.params, xs, ts, torch.bfloat16), rtol=0, atol=2e-2)


DENSITY_FAULTS = {   # each in the SIMT sweep (csrc/sdf_chain.cuh, float32) and the
    # tensor-core one (csrc/dnerf_tc.cuh, bf16)
    # the D-NeRF sweep with EndoSurf's skip scale (tensor cores: a skip
    # layer's operand rows [h | E] scaled by 1/sqrt(2), rounded)
    "skip_scale_inv_sqrt2": [
        ("sdf_chain.cuh", "  static constexpr float kSkip = 1.f;",
         "  static constexpr float kSkip = 0.70710678f;"),
        ("dnerf_tc.cuh", "      put_enc(H, ldh, in_l - ew, E, ew, DT_P, tid);\n      __syncthreads();",
         "      put_enc(H, ldh, in_l - ew, E, ew, DT_P, tid);\n      __syncthreads();\n"
         "      for (int i = tid; i < DT_P * ldh; i += NT)\n"
         "        H[i] = __float2bfloat16_rn(__bfloat162float(H[i]) * 0.70710678f);\n"
         "      __syncthreads();")],
    # a sparse fault: the last partial tile's points (one of 65,537) written as 0
    "tail_tile_zeroed": [
        ("sdf_chain.cuh", "    if (i < src.n) src.store(i, a + wts[N.b_off[l]]);",
         "    if (i < src.n) src.store(i, base + P_SWEEP > src.n ? 0.f : a + wts[N.b_off[l]]);"),
        ("dnerf_tc.cuh",
         "  if (tid < DT_P && base + tid < src.n) src.store(base + tid, s.out[tid * 4]);",
         "  if (tid < DT_P && base + tid < src.n)\n"
         "    src.store(base + tid, base + DT_P > src.n ? 0.f : s.out[tid * 4]);")],
}


@pytest.mark.parametrize("fault", sorted(DENSITY_FAULTS))
def test_density_raw_limits_catch_planted_faults(dev, fault, tmp_path, monkeypatch):
    """The raw density query built with a planted fault fails the limits in
    both modes (the SIMT sweep in float32, the tensor-core one in bf16)."""
    _rebuild_with_all(monkeypatch, tmp_path, DENSITY_FAULTS[fault])
    spec = en.DNeRFSpec()
    params = _dn_params(spec, 0, dev)
    x, t = _sdf_points(65537, dev)
    for dtype in F32_BF16:
        errs = _density_errs(spec, params, x, t, dtype, dtype)
        print(f"{fault} {dtype}: {errs[:3]}")
        assert not errs[-1], errs


def _dn_rays(n: int, dev, depth_guided: bool, seed: int = 1) -> torch.Tensor:
    """Directions scaled to d_z = 1, as a camera's (|d| from 1 to ~1.05)."""
    rays = _rays(n, "cpu", seed)
    rays[:, 3:6] /= rays[:, 5:6]
    g = torch.Generator().manual_seed(100 + seed)
    if depth_guided:   # slots 6/7: (gt depth mean, sigma)
        rays[:, 6] = torch.rand(n, generator=g) * 0.3 + 1.3
        rays[:, 7] = 0.08
    else:              # (near, far)
        rays[:, 6], rays[:, 7] = 0.8, 2.2
    return rays.to(dev)


def _dn_render(fn, spec, params, rays, depth_guided, dtype_s, dtype_m):
    rspec = en.DNeRFRenderSpec(use_depth_sampling=depth_guided)
    return fn(spec, rspec, params, rays, None, dtype_s, dtype_m)


# (nets, spec, density bias): the seeded nets render almost nothing; the
# dense ones are opaque within their samples (fused_render_dnerf.DENSE_BIAS)
RENDER_NETS = {"narrow": (DN_NARROW, 0.0), "full": (en.DNeRFSpec(), 0.0),
               "full-dense": (en.DNeRFSpec(), frd.DENSE_BIAS)}


def _render_params(nets, seed, dev):
    spec, bias = RENDER_NETS[nets]
    params = _dn_params(spec, seed, dev)
    return spec, (frd.with_density_bias(params, bias) if bias else params)


def _render_errs(spec, params, rays, depth_guided, kernel_dts, twin_dt):
    got = _dn_render(frd.fused_render_rays_dnerf_cuda, spec, params, rays, depth_guided,
                     *kernel_dts)
    ref = _dn_render(frd.fused_render_rays_dnerf_reference, spec, params, rays, depth_guided,
                     twin_dt, twin_dt)
    torch.cuda.synchronize()
    for k in ("color_map", "depth_map", "acc_map"):
        assert got[k].shape == ref[k].shape and got[k].dtype == torch.float32
    size = {k: float(v.abs().median()) for k, v in ref.items()}
    return frd.parity_errors(got, ref, twin_dt), size, got


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("depth_guided", [True, False], ids=["depth-guided", "uniform"])
@pytest.mark.parametrize("nets", sorted(RENDER_NETS))
@pytest.mark.parametrize("dtype", F32_BF16, ids=["f32", "bf16"])
def test_dnerf_render_kernel_matches_twin(dev, dtype, nets, depth_guided, seed):
    spec, params = _render_params(nets, seed, dev)
    rays = _dn_rays(1024, dev, depth_guided, seed)
    errs, size, got = _render_errs(spec, params, rays, depth_guided, (dtype, dtype), dtype)
    print(f"dnerf render sound {dtype} {nets} depth_guided {depth_guided} seed {seed}: "
          f"{errs}; median |map| {size}")
    assert all(bool(torch.isfinite(v).all()) for v in got.values())
    assert all(v[-1] for v in errs.values()), errs


@pytest.mark.parametrize("depth_guided", [True, False], ids=["depth-guided", "uniform"])
@pytest.mark.parametrize("nets", sorted(RENDER_NETS))
def test_dnerf_render_limits_reject_the_other_precision(dev, nets, depth_guided):
    """The kernel with its main pass (fields, composite) at the other dot
    precision fails the twin's limits, with the sampling pass at either."""
    spec, params = _render_params(nets, 0, dev)
    rays = _dn_rays(1024, dev, depth_guided)
    f32, bf16 = F32_BF16
    for twin_dt, kernel_dts in ((bf16, [(f32, f32), (bf16, f32)]),
                                (f32, [(bf16, bf16), (f32, bf16)])):
        for kd in kernel_dts:
            errs = _render_errs(spec, params, rays, depth_guided, kd, twin_dt)[0]
            print(f"dnerf render control {nets}: twin {twin_dt} kernel {kd}: {errs}")
            assert not all(v[-1] for v in errs.values()), (twin_dt, kd, errs)


# Planted faults in csrc/fused_render_dnerf.cu: (old, new, the nets on which
# the limits must reject it in both modes). The resample without its 1e-5
# weight floor divides 0 by 0 in the seeded nets' empty bins (NaN); the
# opaque nets have no empty bin, and there it moves the draws by the floor's
# small share of the pdf (colour medians 1.5e-6 to 8e-6 on an H100: float32
# depth-guided passes the limits, the other three cells fail). The
# resample with its draws half a step early (u = j / n_new) or with its
# coarse weights on distances without |d|, and the composite's depth sum
# without |d|, move every opaque ray a little.
# The resample and the composite are fused_render_dnerf.cu's: the resample
# its warp-a-ray dn_resample_warp_kernel (the render's, in float32 or, for
# the bf16 tensor-core render, in double, and the standalone
# fused_fine_resample's).
RESAMPLE_FAULTS = {
    "no_weight_floor": ("        const Real wf = w + floor_w;       // the pdf's weight floor",
                        "        const Real wf = w;", ("full",)),
    "draws_half_step": ("    const Real u = ((Real)jn + half) / (Real)n_new;",
                        "    const Real u = (Real)jn / (Real)n_new;", ("full-dense",)),
    "resample_dist_without_dn": (
        "    const Real dist = ((Real)s.v[j + 1] - (Real)s.v[j]) * dnv;",
        "    const Real dist = (Real)s.v[j + 1] - (Real)s.v[j];", ("full-dense",)),
}
RENDER_FAULTS = {
    **{k: ("fused_render_dnerf.cu", *v) for k, v in RESAMPLE_FAULTS.items()},
    "depth_without_dn": ("fused_render_dnerf.cu", "    dsum += w * z[j] * dn;",
                         "    dsum += w * z[j];", ("full-dense",)),
}


@pytest.mark.parametrize("fault", sorted(RENDER_FAULTS))
def test_dnerf_render_limits_catch_planted_faults(dev, fault, tmp_path, monkeypatch):
    """Each fault fails the limits in both modes, with either sampling, on
    the nets it names (the readings on both nets are printed)."""
    name, old, new, must_fail = RENDER_FAULTS[fault]
    _rebuild_with(monkeypatch, tmp_path, name, old, new)
    for nets in ("full", "full-dense"):
        spec, params = _render_params(nets, 0, dev)
        for depth_guided in (True, False):
            rays = _dn_rays(1024, dev, depth_guided)
            for dtype in F32_BF16:
                errs = _render_errs(spec, params, rays, depth_guided, (dtype, dtype),
                                    dtype)[0]
                print(f"{fault} {nets} depth_guided {depth_guided} {dtype}: {errs}")
                if nets in must_fail:
                    assert not all(v[-1] for v in errs.values()), errs


# Faults planted in the bf16 render's tensor-core passes (csrc/dnerf_tc.cuh,
# csrc/fused_render_dnerf.cu): the raw density read from the output layer's
# column 1 (the coarse sweep and the field stage), and the colour input's
# feature without its bias (the field stage). The float32 render runs the
# SIMT code and does not see them.
TC_DN_RENDER_FAULTS = {
    "raw_from_column_1": (
        "dnerf_tc.cuh",
        "  if (tid < DT_P) s.out[tid * 4] = (float)dt_out_col(S, wts, s.H, ldh, tid, 0);",
        "  if (tid < DT_P) s.out[tid * 4] = (float)dt_out_col(S, wts, s.H, ldh, tid, 1);"),
    "feature_without_bias": (
        "fused_render_dnerf.cu",
        "      if (c + e < F) H[row * ldh + cr + c + e] = __float2bfloat16_rn(a[e] + bf[c + e]);",
        "      if (c + e < F) H[row * ldh + cr + c + e] = __float2bfloat16_rn(a[e]);"),
}


@pytest.mark.parametrize("fault", sorted(TC_DN_RENDER_FAULTS))
def test_dnerf_tc_render_limits_catch_planted_faults(dev, fault, tmp_path, monkeypatch):
    """The bf16 limits fail a tensor-core render with a planted fault on the
    seeded and the opaque full nets, depth-guided and uniform rays (the
    readings are printed)."""
    _rebuild_with(monkeypatch, tmp_path, *TC_DN_RENDER_FAULTS[fault])
    bf = torch.bfloat16
    for nets in ("full", "full-dense"):
        spec, params = _render_params(nets, 0, dev)
        for depth_guided in (True, False):
            rays = _dn_rays(1024, dev, depth_guided)
            errs = _render_errs(spec, params, rays, depth_guided, (bf, bf), bf)[0]
            print(f"{fault} {nets} depth_guided {depth_guided}: {errs}")
            assert not all(v[-1] for v in errs.values()), errs


# The traced calls of the kernel-name tests, run in a fresh process: a long
# test process's torch.profiler sessions can record no device events at all.
_TRACE_SCRIPT = """
import json, os, sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, sys.argv[2])
from test_torch_cuda import (_dn_bwd_case, _dn_field_step, _dn_params, _dn_rays, _march_inputs,
                             _render_params, _sdf_points)
from endosurf_tpu_torch.kernels import fused_render_dnerf as frd
from endosurf_tpu_torch.kernels import fused_sampler as fs
from endosurf_tpu_torch.kernels import fused_sdf as fsd
from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
from endosurf_tpu_torch.models import endonerf as en
from endosurf_tpu_torch.models.fields import EndoSurfSpec, init_endosurf_params
from endosurf_tpu_torch.kernels import build
build.CSRC, build.BUILD_DIR = Path(os.environ["TRACE_CSRC"]), Path(os.environ["TRACE_BUILD_DIR"])
dev, bf = torch.device("cuda"), torch.bfloat16
spec, params = _render_params("full", 0, dev)
rays = _dn_rays(1024, dev, True)
_, packed, like, inputs, cots = _dn_bwd_case(en.DNeRFSpec(), 0, dev, 4096)
_, d_packed, d_like, d_inputs, d_cots = _dn_bwd_case(en.DNeRFSpec(), 0, dev, 4096, "deform")
_, c_packed, c_like, c_inputs, c_cots = _dn_bwd_case(en.DNeRFSpec(), 0, dev, 4096, "color")
es_params = init_endosurf_params(EndoSurfSpec(), torch.Generator().manual_seed(0), dev)
dn_params = _dn_params(en.DNeRFSpec(), 0, dev)
px, pt = _sdf_points(4096, dev)
mins = _march_inputs(1024, dev)
calls = {
    "render bf16": lambda: frd.fused_render_rays_dnerf_cuda(
        spec, en.DNeRFRenderSpec(), params, rays, None, bf, bf),
    "render bf16 simt": lambda: frd.fused_render_rays_dnerf_cuda(
        spec, en.DNeRFRenderSpec(), params, rays, None, bf, bf, simt=True),
    "render f32": lambda: frd.fused_render_rays_dnerf_cuda(spec, en.DNeRFRenderSpec(), params,
                                                           rays),
    "bwd bf16": lambda: ftd.dnerf_density_bwd(packed, like, *inputs, *cots),
    "bwd bf16 simt": lambda: ftd.dnerf_density_bwd(packed, like, *inputs, *cots, simt=True),
    "deform bwd bf16": lambda: ftd.dnerf_deform_bwd(d_packed, d_like, *d_inputs, *d_cots),
    "deform bwd bf16 simt": lambda: ftd.dnerf_deform_bwd(d_packed, d_like, *d_inputs, *d_cots,
                                                         simt=True),
    "density fwd bf16": lambda: ftd.dnerf_density_fwd(packed, *inputs),
    "density fwd bf16 simt": lambda: ftd.dnerf_density_fwd(packed, *inputs, simt=True),
    "deform fwd bf16": lambda: ftd.dnerf_deform_fwd(d_packed, *d_inputs),
    "deform fwd bf16 simt": lambda: ftd.dnerf_deform_fwd(d_packed, *d_inputs, simt=True),
    "density raw bf16": lambda: fsd.fused_density_raw_cuda(en.DNeRFSpec(), dn_params, px, pt, bf),
    "density raw bf16 simt": lambda: fsd.fused_density_raw_cuda(en.DNeRFSpec(), dn_params, px,
                                                                pt, bf, simt=True),
    "color bwd bf16": lambda: ftd.dnerf_color_bwd(c_packed, c_like, *c_inputs, *c_cots),
    "color bwd bf16 simt": lambda: ftd.dnerf_color_bwd(c_packed, c_like, *c_inputs, *c_cots,
                                                       simt=True),
    "sdf query bf16": lambda: fsd.fused_sdf_observed_cuda(EndoSurfSpec(), es_params, px, pt, bf),
    "sdf query bf16 simt": lambda: fsd.fused_sdf_observed_cuda(EndoSurfSpec(), es_params, px, pt,
                                                               bf, simt=True),
    "sdf query f32": lambda: fsd.fused_sdf_observed_cuda(EndoSurfSpec(), es_params, px, pt),
    "march bf16": lambda: fs.fused_ray_march_cuda(EndoSurfSpec(), es_params, *mins,
                                                  sampling_dtype=bf),
    "march bf16 simt": lambda: fs.fused_ray_march_cuda(EndoSurfSpec(), es_params, *mins,
                                                       sampling_dtype=bf, simt=True),
    "march f32": lambda: fs.fused_ray_march_cuda(EndoSurfSpec(), es_params, *mins),
    "color fwd bf16": lambda: ftd.dnerf_color_fwd(c_packed, *c_inputs),
    "color fwd bf16 simt": lambda: ftd.dnerf_color_fwd(c_packed, *c_inputs, simt=True),
    "dnerf field bf16": lambda: _dn_field_step(dn_params, px, pt),
}
names = {}
for what in sys.argv[3:]:
    calls[what]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        calls[what]()
        torch.cuda.synchronize()
    names[what] = sorted({e.key for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA})
print(json.dumps(names))
"""


def _dn_field_step(params, x, t):
    """The D-NeRF field of an EndoNeRF train step on these points (the
    directions from x), bf16, forward and backward: the segment kernels the
    step runs."""
    from endosurf_tpu_torch.bridge import unflatten
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in flatten(params).items()}
    rgb, raw = ftd.megakernel_field_raw(en.DNeRFSpec(), unflatten(leaves), x,
                                        x / x.norm(dim=-1, keepdim=True), t, "default")
    (rgb.sum() + raw.sum()).backward()


def _traced_kernels(*calls):
    """{call: the names of the device kernels one call launches}, traced by
    torch.profiler after a warm-up call in a fresh process (``calls``:
    _TRACE_SCRIPT's keys), on the kernels built from this process's
    ``build.CSRC`` (a planted fault's patched copy too)."""
    import json
    import os
    import subprocess
    import sys
    repo = osp.dirname(osp.dirname(osp.abspath(__file__)))
    env = {**os.environ, "TRACE_CSRC": str(build.CSRC), "TRACE_BUILD_DIR": str(build.BUILD_DIR)}
    out = subprocess.run([sys.executable, "-c", _TRACE_SCRIPT, repo, osp.join(repo, "tests"),
                          *calls], capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return {k: set(v) for k, v in json.loads(out.stdout.strip().splitlines()[-1]).items()}


def test_dnerf_bf16_render_runs_on_tensor_cores(dev):
    """A bf16 render chunk launches the tensor-core coarse sweep and field
    stage and neither dn_field_kernel nor the SIMT D-NeRF sweep; simt=True
    and the float32 render launch the SIMT kernels and no tensor-core one
    (the names the profiler records)."""
    traced = _traced_kernels("render bf16", "render bf16 simt", "render f32")
    tc = traced["render bf16"]
    print(sorted(tc))
    assert any("dn_sweep_tc_kernel" in k for k in tc) and any("dn_field_tc_kernel" in k for k in tc)
    assert not any("dn_field_kernel" in k or "sweep_kernel<" in k for k in tc), tc
    for what in ("render bf16 simt", "render f32"):
        names = traced[what]
        assert any("dn_field_kernel" in k for k in names) and any("sweep_kernel<" in k
                                                                  for k in names), names
        assert not any("_tc_kernel" in k for k in names), names


def test_dnerf_render_tensor_cores_no_farther_from_float64(dev):
    """The condition under which a bf16 D-NeRF render limit
    (fused_render_dnerf.PARITY_TOL) may move with the tensor-core render: on
    every card cell of test_dnerf_render_kernel_matches_twin (the narrow,
    full and opaque full nets, depth-guided and uniform rays, 1024 each, two
    weight seeds) the tensor-core render's median and p99 per-ray error
    against the float64 yardstick (fused_render_rays_dnerf_float64) are no
    larger than the SIMT bf16 render's (simt=True) on the same inputs, per
    map (depth as depth x acc)."""
    bf = torch.bfloat16
    failed = []
    for nets in sorted(RENDER_NETS):
        for depth_guided in (True, False):
            for seed in (0, 1):
                spec, params = _render_params(nets, seed, dev)
                rays = _dn_rays(1024, dev, depth_guided, seed)
                rspec = en.DNeRFRenderSpec(use_depth_sampling=depth_guided)
                ref = frd.fused_render_rays_dnerf_float64(spec, rspec, params, rays)
                tc, simt = (frd.float64_distance(frd.fused_render_rays_dnerf_cuda(
                    spec, rspec, params, rays, None, bf, bf, simt=flag), ref)
                    for flag in (False, True))
                ok = fr.no_farther(tc, simt)
                for k in tc:
                    print(f"dnerf render bf16 vs float64 {nets} depth_guided {depth_guided} "
                          f"seed {seed} {k} (median, p99): tensor cores {tc[k][0]:.4e}, "
                          f"{tc[k][1]:.4e}; SIMT {simt[k][0]:.4e}, {simt[k][1]:.4e}")
                    if not ok[k]:
                        failed.append((nets, depth_guided, seed, k))
    assert not failed, failed


def test_dnerf_render_reuses_the_pack(dev):
    """Chunks on one parameter set share the D-NeRF pack: a second bf16 call
    packs nothing and gives the same maps; after an in-place update of a
    weight the next call repacks, and its maps equal those of a pack built
    from scratch."""
    spec, params = _render_params("narrow", 0, dev)
    rays = _dn_rays(256, dev, True)
    bf = torch.bfloat16

    def run():
        out = frd.fused_render_rays_dnerf_cuda(spec, en.DNeRFRenderSpec(), params, rays, None,
                                               bf, bf)
        return torch.cat([out[k] for k in ("color_map", "depth_map", "acc_map")], -1)
    first = run()
    n = ftd.PACKS["dnerf"]
    assert torch.equal(run(), first) and ftd.PACKS["dnerf"] == n
    with torch.no_grad():
        params["color"]["layers"][0]["b"].add_(0.5)
    updated = run()
    assert ftd.PACKS["dnerf"] == n + 1 and not torch.equal(updated, first)
    ftd._DN_PACKS.clear()
    assert torch.equal(run(), updated) and ftd.PACKS["dnerf"] == n + 2


def test_dnerf_tensor_cores_refuse_nets_they_do_not_take(dev):
    """D-NeRF nets whose tiles do not fit in shared memory render and train
    in float32; their bf16 render, deform and density forwards and raw density
    query (a 110-octave density encoding at full width), bf16 density
    backward (a 40-octave one, narrow)
    and bf16 deform backward (a 90-octave deform encoding at full width,
    whose density forward still runs on tensor cores) are refused, with no
    fallback to the SIMT kernels."""
    spec = dataclasses.replace(en.DNeRFSpec(), pos_density_freqs=110)
    params = _dn_params(spec, 0, dev)
    rays = _dn_rays(64, dev, True)
    out = frd.fused_render_rays_dnerf_cuda(spec, en.DNeRFRenderSpec(), params, rays)
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    before = frd.LAUNCHES["fused_render_rays_dnerf"]
    with pytest.raises(ValueError, match="shared memory"):
        frd.fused_render_rays_dnerf_cuda(spec, en.DNeRFRenderSpec(), params, rays, None,
                                         torch.bfloat16, torch.bfloat16)
    assert frd.LAUNCHES["fused_render_rays_dnerf"] == before
    x, d, t = _seg_points(256, dev)
    assert all(bool(torch.isfinite(v).all())
               for v in ftd.dnerf_density_fwd(ftd.pack_dnerf(spec, params, torch.float32), x))
    before = ftd.LAUNCHES["dnerf_density_fwd"]
    with pytest.raises(ValueError, match="shared memory"):
        ftd.dnerf_density_fwd(ftd.pack_dnerf(spec, params, torch.bfloat16), x)
    assert ftd.LAUNCHES["dnerf_density_fwd"] == before
    xt = torch.cat([x, t], -1)
    assert bool(torch.isfinite(ftd.dnerf_deform_fwd(ftd.pack_dnerf(spec, params, torch.float32),
                                                    xt)).all())
    assert bool(torch.isfinite(fsd.fused_density_raw_cuda(spec, params, x, t)).all())
    before = (ftd.LAUNCHES["dnerf_deform_fwd"], fsd.LAUNCHES["fused_density_raw"])
    with pytest.raises(ValueError, match="shared memory"):
        ftd.dnerf_deform_fwd(ftd.pack_dnerf(spec, params, torch.bfloat16), xt)
    with pytest.raises(ValueError, match="shared memory"):
        fsd.fused_density_raw_cuda(spec, params, x, t, torch.bfloat16)
    assert (ftd.LAUNCHES["dnerf_deform_fwd"], fsd.LAUNCHES["fused_density_raw"]) == before
    spec = dataclasses.replace(en.DNeRFSpec(), pos_deform_freqs=90)
    params = _dn_params(spec, 0, dev)
    _, _, cases = ftd.bwd_segment_parity(spec, params, x, d, t, "highest")
    packed, like, _, inputs, cots = cases["dnerf_deform_bwd"]
    ftd.dnerf_deform_bwd(packed, like, *inputs, *cots)
    bf_pack = ftd.pack_dnerf(spec, params, torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        ftd.dnerf_deform_bwd(bf_pack, like, *inputs, *cots)
    assert all(bool(torch.isfinite(v).all()) for v in ftd.dnerf_density_fwd(bf_pack, x))
    spec = dataclasses.replace(DN_NARROW, pos_density_freqs=40)
    params = _dn_params(spec, 0, dev)
    _, _, cases = ftd.bwd_segment_parity(spec, params, x, d, t, "highest")
    packed, like, _, inputs, cots = cases["dnerf_density_bwd"]
    ftd.dnerf_density_bwd(packed, like, *inputs, *cots)
    bf_pack = ftd.pack_dnerf(spec, params, torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        ftd.dnerf_density_bwd(bf_pack, like, *inputs, *cots)


def test_dnerf_inference_runs_the_kernels(dev, monkeypatch):
    """render_rays_inference on CUDA tensors launches the render kernel once
    a call for every configuration it takes (mixed precisions, a ragged ray
    count, no deform net, 32 + 32 samples) and never runs the plain
    resample; without importance samples it runs the eval render_rays on the
    segment kernels; the entry checks raise."""
    def plain_resample(*args, **kw):
        raise AssertionError("the plain resample ran on CUDA tensors")
    params = _dn_params(DN_NARROW, 0, dev)
    rays = _dn_rays(333, dev, True)
    rspec = en.DNeRFRenderSpec()
    before = frd.LAUNCHES["fused_render_rays_dnerf"]
    ref = frd.fused_render_rays_dnerf_reference(DN_NARROW, rspec, params, rays, None,
                                                torch.bfloat16, torch.float32)
    seg_before, dens_before = dict(ftd.LAUNCHES), fsd.LAUNCHES["fused_density_raw"]
    monkeypatch.setattr(fs, "fine_resample_math", plain_resample)
    out = en.render_rays_inference(DN_NARROW, rspec, params, rays, precision="highest",
                                   sampling_precision="default")
    assert frd.LAUNCHES["fused_render_rays_dnerf"] == before + 1
    errs = frd.parity_errors(out, ref, torch.float32)
    assert all(v[-1] for v in errs.values()), errs
    static = dataclasses.replace(DN_NARROW, use_deform=False)
    for spec, rs in ((static, rspec),
                     (DN_NARROW, en.DNeRFRenderSpec(n_samples=32, n_importance=32))):
        out = en.render_rays_inference(spec, rs, _dn_params(spec, 0, dev), rays)
        assert all(bool(torch.isfinite(v).all()) for v in out.values())
    assert frd.LAUNCHES["fused_render_rays_dnerf"] == before + 3
    assert fsd.LAUNCHES["fused_density_raw"] == dens_before
    assert ftd.LAUNCHES == seg_before
    out = en.render_rays_inference(DN_NARROW, rspec, params, rays, use_importance=False)
    assert frd.LAUNCHES["fused_render_rays_dnerf"] == before + 3
    assert all(ftd.LAUNCHES[k] == seg_before[k] + k.endswith("_fwd") for k in seg_before)
    assert fsd.LAUNCHES["fused_density_raw"] == dens_before
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    with pytest.raises(ValueError, match="rays must be"):
        frd.fused_render_rays_dnerf_cuda(DN_NARROW, rspec, params, rays[:, :8])
    with pytest.raises(ValueError, match="does not take"):
        frd.fused_render_rays_dnerf_cuda(DN_NARROW, en.DNeRFRenderSpec(n_samples=65), params,
                                         rays)
    with pytest.raises(ValueError, match="params on"):
        frd.fused_render_rays_dnerf_cuda(DN_NARROW, rspec, _dn_params(DN_NARROW, 0, "cpu"),
                                         rays)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("spec", DN_SPECS, ids=SPEC_IDS)
@pytest.mark.parametrize("precision", ["highest", "default"], ids=["f32", "bf16"])
def test_dnerf_segments_match_plain(dev, precision, spec, seed):
    params = _dn_params(spec, seed, dev)
    x, d, t = _seg_points(RAGGED_N, dev, seed)
    res, _, _ = ftd.segment_parity(spec, params, x, d, t, precision)
    torch.cuda.synchronize()
    print(f"dnerf segments sound {precision} seed {seed}: {res}")
    assert all(v[-1] for seg in res.values() for v in seg.values()), res


@pytest.mark.parametrize("spec", DN_SPECS, ids=SPEC_IDS)
def test_dnerf_segment_limits_reject_the_other_precision(dev, spec):
    params = _dn_params(spec, 0, dev)
    x, d, t = _seg_points(SEG_N, dev)
    for prec, other in (("highest", "default"), ("default", "highest")):
        res, _, _ = ftd.segment_parity(spec, params, x, d, t, prec, other)
        print(f"dnerf segments control: plain {prec} kernels {other}: {res}")
        for name, outs in res.items():
            assert not all(v[-1] for v in outs.values()), (name, outs)


DN_SEG_FAULTS = {   # each in the SIMT kernel (dnerf_chain.cuh, float32) and the tensor-core
    # one (bf16): the density forward's sigma head read from feature column 1 and
    # its feature's bias read one column early; the deform forward's x_c
    # without x; the colour forward's feature columns 4k read from 4k + 1
    "head_from_column_1": ["dnerf_density_fwd",
        ("dnerf_chain.cuh",
         "    const float* Wh = W;                 // the sigma head: column 0 of the output layer",
         "    const float* Wh = W + 1;"),
        ("dnerf_tc.cuh",
         "  if (tid < DT_P) s.out[tid * 4] = (float)dt_out_col(S, wts, s.H, ldh, tid, 0);",
         "  if (tid < DT_P) s.out[tid * 4] = (float)dt_out_col(S, wts, s.H, ldh, tid, 1);")],
    "feature_bias_shifted": ["dnerf_density_fwd",
        ("dnerf_chain.cuh", "    const float b = wts[N.b_off[l] + 1 + tid];",
         "    const float b = wts[N.b_off[l] + tid];"),
        ("fused_train_dnerf.cu", "  const float* bf = wts + S.b_off[lo] + 1;",
         "  const float* bf = wts + S.b_off[lo];")],
    "xc_without_x": ["dnerf_deform_fwd",
        ("dnerf_chain.cuh",
         "    s.xc[p * 4 + col] = s.x[p * 4 + col] + dn_out_col(m.deform, wts, s.h + p * HMAX, col);",
         "    s.xc[p * 4 + col] = dn_out_col(m.deform, wts, s.h + p * HMAX, col);"),
        ("dnerf_tc.cuh", "    const double xc = (double)s.x[p * 4 + col]",
         "    const double xc = 0.0")],
    "feature_column_4k_from_4k1": ["dnerf_color_fwd",
        ("fused_train_dnerf.cu",
         "idx < P_DN * F; idx += NT) {\n    const int p = idx / F, c = idx - p * F;\n"
         "    s.h[p * HMAX + c] = base + p < n ? opnd<RB>(feat[(size_t)(base + p) * F + c])",
         "idx < P_DN * F; idx += NT) {\n    const int p = idx / F, c = idx - p * F;\n"
         "    s.h[p * HMAX + c] = base + p < n ? opnd<RB>(feat[(size_t)(base + p) * F + c + "
         "((c & 3) == 0)])"),
        ("fused_train_dnerf.cu", "      h[0] = __float2bfloat16_rn(v.x);",
         "      h[0] = __float2bfloat16_rn(v.y);")],
}


@pytest.mark.parametrize("fault", sorted(DN_SEG_FAULTS))
def test_dnerf_segment_limits_catch_planted_faults(dev, fault, tmp_path, monkeypatch):
    """A forward kernel (the fault's first entry) built with a planted fault
    fails the limits in both modes (the SIMT kernel in float32, the
    tensor-core one in bf16)."""
    kernel, *edits = DN_SEG_FAULTS[fault]
    _rebuild_with_all(monkeypatch, tmp_path, edits)
    spec = en.DNeRFSpec()
    params = _dn_params(spec, 0, dev)
    x, d, t = _seg_points(RAGGED_N, dev)
    for precision in ("highest", "default"):
        res, _, _ = ftd.segment_parity(spec, params, x, d, t, precision)
        print(f"{fault} {precision}: {res[kernel]}")
        assert not all(v[-1] for v in res[kernel].values()), precision


def test_dnerf_field_runs_the_segment_kernels(dev, tmp_path):
    """field_eval on CUDA tensors launches each forward segment once a call
    (the renderer's vertex colours too) and, under a gradient, each backward
    segment once, with parameter gradients that match the plain field's;
    a renderer with train.megakernel "off" and a spec the kernels cannot
    take raise."""
    from endosurf_tpu_torch.serve import EndoNeRFRenderer
    fwd = [k for k in ftd.LAUNCHES if k.endswith("_fwd")]
    params = _dn_params(DN_NARROW, 0, dev)
    x, d, t = _seg_points(5000, dev)
    before = dict(ftd.LAUNCHES)
    rgb, sigma = en.field_eval(DN_NARROW, params, x, d, t, precision="default")
    assert all(ftd.LAUNCHES[k] == before[k] + (k in fwd) for k in before)
    # End to end against the plain field (forward_math): median and p99 at the
    # forward segments' bf16 limits, max 1e-3 on every point but those where
    # the float64 deform shows a tip. The deform net rounds its hidden
    # activations to bf16, and the kernel's float32 sums and the plain
    # version's, in other orders, tip one of those roundings now and then:
    # that side's x_c then sits 1e-6 to 1e-3 off the float64 x_c
    # (dnerf_deform_fwd_float64), where an untipped x_c sits within 6e-8 of
    # it, and where the tip moves x_c's own bf16 rounding, the ten-octave
    # encoding moves the point's rgb by up to ~4e-3. Either side tips: on
    # this net (H100 readings, three seeds) x_c rounds to bf16 apart from the
    # float64 x_c on 5 to 11 of 65,536 points for the kernel, 7 to 16 for
    # the plain version. Only points where x_c rounds apart and one side is off the
    # float64 x_c by more than 1e-6 are excused, at most 0.1 % of them; every
    # point's rgb is held against the plain chain fed the kernel's own x_c,
    # and x_c against the plain deform at the deform segment's limits.
    bf = torch.bfloat16
    eff = ftd.prepare_effective_dnerf(DN_NARROW, params)
    xt = torch.cat([x, t], -1)
    x_c = ftd.dnerf_deform_fwd(ftd.pack_dnerf(DN_NARROW, params, bf), xt)
    f64_xc = ftd.dnerf_deform_fwd_float64(DN_NARROW, params, xt)
    with torch.no_grad():
        ref = ftd.forward_math(DN_NARROW, eff, x, t, d, "default")["rgb"]
        ref_xc = ftd.seg_deform_math(DN_NARROW, eff["deform"], xt, "default")
        _, feat = ftd.seg_density_math(DN_NARROW, eff["density"], eff["sigma_head"],
                                       eff["geo_feat"], x_c, "default")
        ref_on_xc = ftd.seg_color_math(DN_NARROW, eff["color"], d, feat, "default")
    assert rgb.shape == (5000, 3) and sigma.shape == (5000,)
    assert all(v[-1] for v in ftd.parity_errors({"x_c": x_c}, {"x_c": ref_xc}, bf).values())
    assert float((rgb - ref_on_xc).abs().max()) < 1e-3
    err = (rgb - ref).abs().amax(-1)
    med, p99 = torch.quantile(err, torch.tensor([0.5, 0.99], device=dev)).tolist()
    assert med <= ftd.PARITY_TOL[bf][0] and p99 <= ftd.PARITY_TOL[bf][1], (med, p99)
    tipped = torch.maximum((x_c.double() - f64_xc).abs(), (ref_xc.double() - f64_xc).abs())
    excused = (x_c.to(bf) != ref_xc.to(bf)).any(-1) & (tipped.amax(-1) > 1e-6)
    print(f"field rgb vs plain: median {med:.3e}, p99 {p99:.3e}, max {float(err.max()):.3e}; "
          f"{int(excused.sum())} points excused, max elsewhere {float(err[~excused].max()):.3e}")
    assert int(excused.sum()) <= 5
    assert float(err[~excused].max()) < 1e-3
    for v in flatten(params).values():
        v.requires_grad_(True)
    w = torch.randn(5000, 4, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    grads = {}
    for name, field in (("kernels", ftd.megakernel_field_raw), ("plain", ftd.plain_field_raw)):
        for v in flatten(params).values():
            v.grad = None
        before = dict(ftd.LAUNCHES)
        rgb, raw = field(DN_NARROW, params, x, d, t, "highest")
        ((rgb * w[:, :3]).sum() + (raw * w[:, 3]).sum()).backward()
        grads[name] = {k: v.grad.clone() for k, v in flatten(params).items()}
        if name == "kernels":
            assert all(ftd.LAUNCHES[k] == before[k] + 1 for k in before)
    tol = ftd.BWD_PARITY_TOL[torch.float32]["leaf"]
    for k, g in grads["plain"].items():
        rel = float((grads["kernels"][k] - g).norm() / g.norm())
        assert rel <= tol, (k, rel)
    with torch.no_grad():
        en.field_eval(DN_NARROW, params, x, d, t)
    cfg = {"exp": {"project_name": "p", "exp_name": "e", "exp_dir": str(tmp_path)},
           "render": {"type": "endonerf"}, "train": {"megakernel": "off"}, "net": {}}
    scene = make_synthetic_arrays(4, 8, 8, 0, dev)
    with pytest.raises(NotImplementedError, match="megakernel: off"):
        EndoNeRFRenderer(cfg, scene=scene, device=dev)
    cfg["train"] = {}
    renderer = EndoNeRFRenderer(cfg, scene=scene, device=dev)
    before = dict(ftd.LAUNCHES)
    cols = renderer.render_points_fn()(x.cpu().numpy(), d.cpu().numpy(), t.cpu().numpy())
    assert cols.shape == (5000, 3)
    assert all(ftd.LAUNCHES[k] == before[k] + (k in fwd) for k in before)
    bad = dataclasses.replace(DN_NARROW, geo_feat_dim=300)
    with pytest.raises(ValueError, match="do not take"):
        en.field_eval(bad, _dn_params(bad, 0, dev), x, d, t)


# ---------------------------------------------------------------------------
# EndoNeRF training: the backward segments and the resample
# ---------------------------------------------------------------------------

def _bwd_report(res):
    return {name: {"cot": {k: v[:3] for k, v in kinds["cot"].items()},
                   "leaf": max(v[0] for v in kinds["leaf"].values()),
                   "ok": ftd.bwd_parity_ok({name: kinds})} for name, kinds in res.items()}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("spec", DN_SPECS, ids=SPEC_IDS)
@pytest.mark.parametrize("precision", ["highest", "default"], ids=["f32", "bf16"])
def test_dnerf_backward_matches_plain(dev, precision, spec, seed):
    """Each D-NeRF backward kernel against its plain version on a ragged
    point count, seeded random cotangents, at BWD_PARITY_TOL."""
    params = _dn_params(spec, seed, dev)
    x, d, t = _seg_points(RAGGED_N, dev, seed)
    res, _, _ = ftd.bwd_segment_parity(spec, params, x, d, t, precision, seed)
    torch.cuda.synchronize()
    print(f"dnerf backward sound {precision} seed {seed}: {_bwd_report(res)}")
    assert ftd.bwd_parity_ok(res), _bwd_report(res)


@pytest.mark.parametrize("spec", DN_SPECS, ids=SPEC_IDS)
def test_dnerf_backward_limits_reject_the_other_precision(dev, spec):
    params = _dn_params(spec, 0, dev)
    x, d, t = _seg_points(SEG_N, dev)
    for prec, other in (("highest", "default"), ("default", "highest")):
        res, _, _ = ftd.bwd_segment_parity(spec, params, x, d, t, prec, 0, other)
        print(f"dnerf backward control: plain {prec} kernels {other}: {_bwd_report(res)}")
        for name, kinds in res.items():
            assert not ftd.bwd_parity_ok({name: kinds}), (name, _bwd_report(res))


def test_dnerf_backward_is_deterministic(dev):
    """Two calls give the same bits: the weight gradients are summed in a
    fixed order (wgrad.cuh), the input cotangents per point."""
    spec = en.DNeRFSpec()
    params = _dn_params(spec, 0, dev)
    x, d, t = _seg_points(RAGGED_N, dev)
    _, _, cases = ftd.bwd_segment_parity(spec, params, x, d, t, "default")
    for name, (packed, like, flat, inputs, cots) in cases.items():
        seg = name.split("_")[1]
        a, b = (ftd.BWD[seg](packed, like, *inputs, *cots) for _ in range(2))
        for u, v in zip([*a[0], *a[1]], [*b[0], *b[1]]):
            assert (u is None and v is None) or torch.equal(u, v), name


# csrc/fused_train_dnerf.cu: the skip layer's encoding rows left out of d x_c
# (the walk's section rows of skip layers dropped), the sigma head's
# cotangent reaching h through the first feature column's weights, the
# deform backward's cotangent g_xc read with its channels rotated, and the
# walks' relu' gates dropped (judged on the deform backward); each in the SIMT
# kernel (float32) and in the tensor-core one (bf16).
DN_BWD_FAULTS = {
    "skip_gradient_dropped": (
        [("    const int lo = l == 0 ? sec0 : (skip && skip_sec ? n_h : in_l);",
          "    const int lo = l == 0 ? sec0 : in_l;"),
         ("      if (den && i >= n_h && i < in_l) den[row * ew + i - n_h] += v;",
          "      if (den && i >= n_h && i < in_l && l == 0) den[row * ew + i - n_h] += v;")],
        ("dnerf_density_bwd",)),
    "deform_cotangent_channels_rotated": (
        [("    cur[p * HMAX + c] = base + p < n ? g_xc[(size_t)(base + p) * 3 + c] : 0.f;",
          "    cur[p * HMAX + c] = base + p < n ? g_xc[(size_t)(base + p) * 3 + (c + 1) % 3]"
          " : 0.f;"),
         ("    s.out[idx] = in && c < 3 ? g_xc[(size_t)(base + p) * 3 + c] : 0.f;   // g_xc",
          "    s.out[idx] = in && c < 3 ? g_xc[(size_t)(base + p) * 3 + (c + 1) % 3] : 0.f;")],
        ("dnerf_deform_bwd",)),
    "deform_relu_gate_dropped": (
        [("          const bool on = base + p < n && sv.xin[l][(size_t)(base + p) * in_l + i]"
          " > 0.f;",
          "          const bool on = base + p < n;"),
         ("        const bool on = i < n_h && ((word >> (i & 31)) & 1);",
          "        const bool on = i < n_h;")],
        ("dnerf_deform_bwd",)),
    "head_cotangent_wrong_column": (
        [("      acc_seg<P>(acc_h, WT, n_in, i, 0, gout, G, 1);",
          "      acc_seg<P>(acc_h, WT, n_in, i, 1, gout, G, 1);"),
         ("    const float* head = wts + S.wt_off[L - 1];   // W^T row 0: the raw column",
          "    const float* head = wts + S.wt_off[L - 1] + n_in;")],
        ("dnerf_density_bwd",)),
    # the colour walk's relu' gate dropped (SIMT: dn_bwd_walk, which every SIMT
    # backward walks with; tensor cores: the colour kernel's gate on h_{L-2})
    "color_relu_gate_dropped": (
        [("          const bool on = base + p < n && sv.xin[l][(size_t)(base + p) * in_l + i]"
          " > 0.f;",
          "          const bool on = base + p < n;"),
         ("      if (i < n_in && ((s.gbit[((L - 2) * DT_P + p) * WB + (i >> 5)] >> (i & 31)) & 1))"
          " {",
          "      if (i < n_in) {")],
        ("dnerf_color_bwd",)),
    # the sigmoid's derivative without its (1 - rgb) factor
    "color_sigmoid_slope_halved": (
        [("g_rgb[(size_t)(base + p) * 3 + c] * rgb * (1.f - rgb)",
          "g_rgb[(size_t)(base + p) * 3 + c] * rgb"),
         ("(float)((double)s.x[p * 4 + col] * rgb * (1.0 - rgb));",
          "(float)((double)s.x[p * 4 + col] * rgb);")],
        ("dnerf_color_bwd",)),
}


@pytest.mark.parametrize("fault", sorted(DN_BWD_FAULTS))
def test_dnerf_backward_limits_catch_planted_faults(dev, fault, tmp_path, monkeypatch):
    """A backward kernel built with a planted fault fails the limits in both
    modes (the readings are printed)."""
    edits, kernels = DN_BWD_FAULTS[fault]
    _rebuild_with_all(monkeypatch, tmp_path, [("fused_train_dnerf.cu", old, new)
                                              for old, new in edits])
    spec = en.DNeRFSpec()
    params = _dn_params(spec, 0, dev)
    x, d, t = _seg_points(RAGGED_N, dev)
    for precision in ("highest", "default"):
        res, _, _ = ftd.bwd_segment_parity(spec, params, x, d, t, precision)
        print(f"{fault} {precision}: {_bwd_report(res)}")
        for name in kernels:
            assert not ftd.bwd_parity_ok({name: res[name]}), (precision, name)


@pytest.mark.parametrize("spec", DN_SPECS, ids=SPEC_IDS)
def test_dnerf_bwd_sizes_match_the_planner(dev, spec):
    """fused_train_dnerf.bwd_sizes (the CPU mirror) equals csrc's
    dnerf_bwd_sizes (dn_plan_bwd, plan_density_bwd_tc) for every segment,
    both modes, at several point counts."""
    import ctypes
    params = _dn_params(spec, 0, dev)
    packed = ftd.pack_dnerf(spec, params, torch.bfloat16)
    lib = build.load_library()
    out = (ctypes.c_longlong * 2)()
    for seg in ftd.SEGMENTS if spec.use_deform else ("density", "color"):
        for tc in (False, True):
            for n in (1, 63, 4097, 262144):
                lib.dnerf_bwd_sizes(packed.meta, ftd.SLOTS[seg], int(tc), n, out)
                assert (out[0], out[1]) == ftd.bwd_sizes(packed.meta, seg, n, tc), (seg, tc, n)


def _dn_bwd_case(spec, seed, dev, n=RAGGED_N, seg="density"):
    """A backward's inputs on n ragged points (the density's: x_c from the
    plain deform segment; the deform's: xt), seeded cotangents, and the like
    / packs."""
    params = _dn_params(spec, seed, dev)
    x, d, t = _seg_points(n, dev, seed)
    _, _, cases = ftd.bwd_segment_parity(spec, params, x, d, t, "default", seed)
    packed, like, _, inputs, cots = cases[f"dnerf_{seg}_bwd"]
    return params, packed, like, inputs, cots


def test_dnerf_density_bwd_tensor_cores_no_farther_from_float64(dev):
    """The condition under which the bf16 d x_c limit of the density
    backward (fused_train_dnerf.BWD_PARITY_TOL[("dnerf_density_bwd",
    "x_c")]) moved with the tensor-core kernel: on the cells of
    test_dnerf_backward_matches_plain (three nets, 65,531 points, two seeds)
    the tensor-core kernel's median and p99 per-point error of d x_c
    against the float64 yardstick (dnerf_density_bwd_float64) are no larger
    than the SIMT bf16 kernel's (simt=True). The weight gradients'
    per-element readings are printed beside them and not judged here: their
    limit ("leaf") did not move, and their p99 sits at the bf16 roundings
    the walk's float32 sums tip, which the two kernels tip on other points
    (0.79-1.34x the SIMT kernel's, PERF.md §6; tools/dnerf_wgrad_floor.py
    reads them leaf by leaf)."""
    failed = []
    for sid, spec in zip(SPEC_IDS, DN_SPECS):
        for seed in (0, 1):
            params, packed, like, inputs, cots = _dn_bwd_case(spec, seed, dev)
            dist = ftd.tc_float64_distance(spec, params, "dnerf_density_bwd", packed, like, inputs,
                                           cots)
            ok = fr.no_farther(dist["tensor cores"], dist["SIMT"])
            for k in ok:
                print(f"dnerf density bwd bf16 vs float64 {sid} seed {seed} {k} (median, p99): "
                      + "; ".join(f"{nm} {v[k][0]:.4e}, {v[k][1]:.4e}" for nm, v in dist.items()))
            if not ok["d_xc"]:
                failed.append((sid, seed))
    assert not failed, failed


def test_dnerf_density_bwd_runs_on_tensor_cores(dev):
    """A bf16 density backward launches the tensor-core tile and product
    (dnerf_density_bwd_tc_kernel, wgrad_tc_partial_kernel) and not the SIMT
    ones; simt=True launches the SIMT kernel."""
    traced = _traced_kernels("bwd bf16", "bwd bf16 simt")
    tc, simt = traced["bwd bf16"], traced["bwd bf16 simt"]
    print(sorted(tc), sorted(simt))
    assert any("dnerf_density_bwd_tc_kernel" in k for k in tc)
    assert any("wgrad_tc_partial_kernel" in k for k in tc)
    assert not any("dnerf_density_bwd_kernel" in k or "wgrad_partial_kernel" in k for k in tc)
    assert any("dnerf_density_bwd_kernel" in k for k in simt)
    assert not any("_tc_" in k for k in simt)


def test_dnerf_color_bwd_tensor_cores_no_farther_from_float64(dev):
    """On the cells of test_dnerf_backward_matches_plain (three nets, 65,531
    points, two seeds) the tensor-core colour backward is no farther from
    float64 than the SIMT bf16 kernel (simt=True): d feat's median and p99
    per-point error against the float64 yardstick (dnerf_color_bwd_float64),
    and, one level down, the share of the points whose operand rows or
    pre-activation cotangents, read back from the scratch, differ from the
    float64 recompute and walk (dnerf_color_walk_float64,
    fused_train_dnerf.walk_distance). Each weight leaf's median and p99
    against the yardstick are printed beside them and not judged: the bias
    and output-layer gradients are float32 sums over every point, which sit
    at one summation floor for either kernel and land on either side of
    each other (PERF.md §6)."""
    failed = []
    for sid, spec in zip(SPEC_IDS, DN_SPECS):
        for seed in (0, 1):
            params, packed, like, inputs, cots = _dn_bwd_case(spec, seed, dev, seg="color")
            ref_leaves, (_, ref_df) = ftd.dnerf_color_bwd_float64(spec, params, *inputs, *cots)
            names = ftd.leaf_names(like, "color")
            dist = {}
            for nm, simt in (("tensor cores", False), ("SIMT", True)):
                leaves, (_, d_feat) = ftd.dnerf_color_bwd(packed, like, *inputs, *cots, simt=simt)
                dist[nm] = {"d_feat": ftd.bwd_float64_distance(leaves, d_feat, ref_leaves,
                                                               ref_df, "d_feat")["d_feat"],
                            **{k: ftd.bwd_float64_distance([g], None, [r], None)["weights"]
                               for k, g, r in zip(names, leaves, ref_leaves)}}
            walk = ftd.walk_distance(spec, params, "color", packed, inputs, cots)
            for k in dist["SIMT"]:
                print(f"dnerf colour bwd bf16 vs float64 {sid} seed {seed} {k} (median, p99): "
                      + "; ".join(f"{nm} {v[k][0]:.4e}, {v[k][1]:.4e}" for nm, v in dist.items()))
            print(f"dnerf colour bwd bf16 vs float64 {sid} seed {seed}: points off the float64 "
                  f"walk, weight elements off float64, weight elements off the exact product "
                  f"of the kernel's own operands " + "; ".join(
                      f"{nm} {100 * v['points']:.3f} %, {100 * v['weights']:.3f} %, "
                      f"{100 * v['product']:.3f} %" for nm, v in walk.items()))
            if not fr.no_farther(dist["tensor cores"], dist["SIMT"])["d_feat"]:
                failed.append((sid, seed, "d_feat"))
            if walk["tensor cores"]["points"] > walk["SIMT"]["points"]:
                failed.append((sid, seed, "walk"))
    assert not failed, failed


def test_dnerf_color_bwd_runs_on_tensor_cores(dev):
    """A bf16 colour backward launches the tensor-core tile and product
    (dnerf_color_bwd_tc_kernel, wgrad_tc_partial_kernel) and not the SIMT
    ones; simt=True launches the SIMT kernel and product."""
    traced = _traced_kernels("color bwd bf16", "color bwd bf16 simt")
    tc, simt = traced["color bwd bf16"], traced["color bwd bf16 simt"]
    print(sorted(tc), sorted(simt))
    assert any("dnerf_color_bwd_tc_kernel" in k for k in tc)
    assert any("wgrad_tc_partial_kernel" in k for k in tc)
    assert not any("dnerf_color_bwd_kernel" in k or "wgrad_partial_kernel" in k for k in tc)
    assert any("dnerf_color_bwd_kernel" in k for k in simt)
    assert any("wgrad_partial_kernel" in k for k in simt)
    assert not any("_tc_" in k for k in simt)


def test_dnerf_deform_bwd_tensor_cores_no_farther_from_float64(dev):
    """On the cells of test_dnerf_backward_matches_plain with a deform net
    (narrow and full, 65,531 points, two seeds) the tensor-core deform
    backward's own arithmetic is no farther from float64 than the SIMT bf16
    kernel's (simt=True): its operand rows and pre-activation cotangents,
    read back from the scratch, differ from the float64 recompute and walk
    (dnerf_deform_walk_float64) on no larger a share of the points
    (fused_train_dnerf.walk_distance). The weight gradients' median
    and p99 against the float64 yardstick (dnerf_deform_bwd_float64) are
    printed beside it and not judged: a float32 sum that tips one bf16
    rounding moves every later layer of its point through the chaotic net,
    so on the full nets a third of the gradient elements sit an ulp or more
    off float64 for either kernel, and the p99, one ulp of whichever element
    lands there, falls on either side (PERF.md §6)."""
    failed = []
    for sid, spec in zip(SPEC_IDS, DN_SPECS):
        if not spec.use_deform:
            continue
        for seed in (0, 1):
            params, packed, like, inputs, cots = _dn_bwd_case(spec, seed, dev, seg="deform")
            walk = ftd.walk_distance(spec, params, "deform", packed, inputs, cots)
            dist = ftd.tc_float64_distance(spec, params, "dnerf_deform_bwd", packed, like, inputs,
                                           cots)
            print(f"dnerf deform bwd bf16 vs float64 {sid} seed {seed}: points off the float64 "
                  f"walk, weight elements off float64, weight elements off the exact product "
                  f"of the kernel's own operands " + "; ".join(
                      f"{nm} {100 * v['points']:.3f} %, {100 * v['weights']:.3f} %, "
                      f"{100 * v['product']:.3f} %" for nm, v in walk.items())
                  + "; weights (median, p99) " + "; ".join(
                      f"{nm} {v['weights'][0]:.4e}, {v['weights'][1]:.4e}"
                      for nm, v in dist.items()))
            if walk["tensor cores"]["points"] > walk["SIMT"]["points"]:
                failed.append((sid, seed))
    assert not failed, failed


def test_dnerf_density_fwd_tensor_cores_no_farther_from_float64(dev):
    """On the cells of test_dnerf_segments_match_plain (three nets, 65,531
    points, two seeds) the tensor-core density forward's median and p99
    per-point error of raw sigma and of the feature against the float64
    yardstick (dnerf_density_fwd_float64) are no larger than the SIMT bf16
    kernel's (simt=True) on the same x_c (the plain deform segment's)."""
    failed = []
    for sid, spec in zip(SPEC_IDS, DN_SPECS):
        for seed in (0, 1):
            params = _dn_params(spec, seed, dev)
            x, d, t = _seg_points(RAGGED_N, dev, seed)
            _, _, cases = ftd.segment_parity(spec, params, x, d, t, "default")
            packed, inputs = cases["dnerf_density_fwd"]
            dist = ftd.tc_float64_distance(spec, params, "dnerf_density_fwd", packed, None, inputs)
            ok = fr.no_farther(dist["tensor cores"], dist["SIMT"])
            for k in ok:
                print(f"dnerf density fwd bf16 vs float64 {sid} seed {seed} {k} (median, p99): "
                      + "; ".join(f"{nm} {v[k][0]:.4e}, {v[k][1]:.4e}" for nm, v in dist.items()))
            if not all(ok.values()):
                failed.append((sid, seed, ok))
    assert not failed, failed


def test_dnerf_deform_bwd_runs_on_tensor_cores(dev):
    """A bf16 deform backward launches the tensor-core tile and product
    (dnerf_deform_bwd_tc_kernel, wgrad_tc_partial_kernel) and not the SIMT
    ones; simt=True launches the SIMT kernel."""
    traced = _traced_kernels("deform bwd bf16", "deform bwd bf16 simt")
    tc, simt = traced["deform bwd bf16"], traced["deform bwd bf16 simt"]
    print(sorted(tc), sorted(simt))
    assert any("dnerf_deform_bwd_tc_kernel" in k for k in tc)
    assert any("wgrad_tc_partial_kernel" in k for k in tc)
    assert not any("dnerf_deform_bwd_kernel" in k or "wgrad_partial_kernel" in k for k in tc)
    assert any("dnerf_deform_bwd_kernel" in k for k in simt)
    assert not any("_tc_" in k for k in simt)


def test_dnerf_density_fwd_runs_on_tensor_cores(dev):
    """A bf16 density forward launches the tensor-core kernel
    (dnerf_density_fwd_tc_kernel) and not the SIMT one; simt=True launches
    the SIMT kernel."""
    traced = _traced_kernels("density fwd bf16", "density fwd bf16 simt")
    tc, simt = traced["density fwd bf16"], traced["density fwd bf16 simt"]
    print(sorted(tc), sorted(simt))
    assert any("dnerf_density_fwd_tc_kernel" in k for k in tc)
    assert not any("dnerf_density_fwd_kernel" in k for k in tc)
    assert any("dnerf_density_fwd_kernel" in k for k in simt)
    assert not any("_tc_" in k for k in simt)


def test_dnerf_color_fwd_tensor_cores_no_farther_from_float64(dev):
    """On the cells of test_dnerf_segments_match_plain (three nets, 65,531
    points, two seeds) the tensor-core colour forward's median and p99
    per-point rgb error against the float64 yardstick
    (dnerf_color_fwd_float64) are no larger than the SIMT bf16 kernel's
    (simt=True) on the same directions and feature (the plain density
    segment's)."""
    failed = []
    for sid, spec in zip(SPEC_IDS, DN_SPECS):
        for seed in (0, 1):
            params = _dn_params(spec, seed, dev)
            x, d, t = _seg_points(RAGGED_N, dev, seed)
            _, _, cases = ftd.segment_parity(spec, params, x, d, t, "default")
            packed, inputs = cases["dnerf_color_fwd"]
            dist = ftd.tc_float64_distance(spec, params, "dnerf_color_fwd", packed, None, inputs)
            ok = fr.no_farther(dist["tensor cores"], dist["SIMT"])
            print(f"dnerf colour fwd bf16 vs float64 {sid} seed {seed} rgb (median, p99): "
                  + "; ".join(f"{nm} {v['rgb'][0]:.4e}, {v['rgb'][1]:.4e}"
                              for nm, v in dist.items()))
            if not all(ok.values()):
                failed.append((sid, seed, ok))
    assert not failed, failed


def test_dnerf_color_fwd_is_the_backward_recompute(dev, tmp_path, monkeypatch):
    """In bf16 the colour forward kernel computes what the colour
    backward's recompute computes (dnerf_tc.cuh's dt_hidden on [enc(d) |
    op(feat)], the output layer and the sigmoid in double), so the rgb the
    loss sees is the one the backward differentiates: at a ragged point
    count, on the full nets and the narrow ones, the forward's rgb equals,
    bit for bit, the rgb that a build whose backward writes its recompute's
    rgb (rounded once to float32) in place of d feat and stops returns."""
    rgb = "    const double rgb = 1.0 / (1.0 + exp(-dt_out_col(C, wts, s.H, ldh, p, col)));\n"
    walk = "  // ---- the cotangent on h_{L-2}: d z W^T (rank 3) in double, rounded once,\n"
    _rebuild_with_all(monkeypatch, tmp_path, [
        ("fused_train_dnerf.cu", rgb,
         rgb + "    if (base + p < n) dfeat[(size_t)(base + p) * F + col] = (float)rgb;\n"),
        ("fused_train_dnerf.cu", walk, "  return;\n" + walk)])
    for spec in (en.DNeRFSpec(), DN_NARROW):
        params, packed, like, inputs, cots = _dn_bwd_case(spec, 0, dev, seg="color")
        color = ftd.dnerf_color_fwd(packed, *inputs)
        _, (_, probe) = ftd.dnerf_color_bwd(packed, like, *inputs, *cots)
        torch.cuda.synchronize()
        assert torch.equal(color, probe[:, :3])


def test_dnerf_color_fwd_runs_on_tensor_cores(dev):
    """A bf16 colour forward launches the tensor-core kernel
    (dnerf_color_fwd_tc_kernel) and not the SIMT one; simt=True launches the
    SIMT kernel; the bf16 D-NeRF field of a train step (forward and
    backward) runs the tensor-core colour forward and no SIMT segment
    kernel."""
    traced = _traced_kernels("color fwd bf16", "color fwd bf16 simt", "dnerf field bf16")
    tc, simt, step = (traced[k] for k in ("color fwd bf16", "color fwd bf16 simt",
                                          "dnerf field bf16"))
    print(sorted(tc), sorted(simt), sorted(step))
    assert any("dnerf_color_fwd_tc_kernel" in k for k in tc)
    assert not any("dnerf_color_fwd_kernel" in k for k in tc)
    assert any("dnerf_color_fwd_kernel" in k for k in simt)
    assert not any("_tc_" in k for k in simt)
    assert any("dnerf_color_fwd_tc_kernel" in k for k in step)
    assert not any(f"dnerf_{seg}_{d}_kernel" in k for k in step
                   for seg in ("deform", "density", "color") for d in ("fwd", "bwd"))


def test_dnerf_deform_fwd_tensor_cores_no_farther_from_float64(dev):
    """On the cells of test_dnerf_segments_match_plain with a deform net
    (narrow and full, 65,531 points, two seeds) the tensor-core deform
    forward's median and p99 per-point error of x_c against the float64
    yardstick (dnerf_deform_fwd_float64) are no larger than the SIMT bf16
    kernel's (simt=True) on the same xt."""
    failed = []
    for sid, spec in zip(SPEC_IDS, DN_SPECS):
        if not spec.use_deform:
            continue
        for seed in (0, 1):
            params = _dn_params(spec, seed, dev)
            x, d, t = _seg_points(RAGGED_N, dev, seed)
            _, _, cases = ftd.segment_parity(spec, params, x, d, t, "default")
            packed, inputs = cases["dnerf_deform_fwd"]
            dist = ftd.tc_float64_distance(spec, params, "dnerf_deform_fwd", packed, None, inputs)
            ok = fr.no_farther(dist["tensor cores"], dist["SIMT"])
            print(f"dnerf deform fwd bf16 vs float64 {sid} seed {seed} x_c (median, p99): "
                  + "; ".join(f"{nm} {v['x_c'][0]:.4e}, {v['x_c'][1]:.4e}"
                              for nm, v in dist.items()))
            if not all(ok.values()):
                failed.append((sid, seed))
    assert not failed, failed


def _dn_grid_slab(dev):
    """A 1,048,576-point slab of a 128^3 grid over [-1.2, 1.2]^3 (the first 64
    x-planes, as the demo builds them) at t = 0.5."""
    import numpy as np

    from endosurf_tpu_torch.evaluation.geometry3d import grid_axes, grid_slab
    x = grid_slab(grid_axes(np.full(3, -1.2), np.full(3, 1.2), 128), 0, 64, dev)
    return x, torch.full((x.shape[0], 1), 0.5, device=dev)


def test_density_raw_tensor_cores_no_farther_from_float64(dev):
    """On a grid slab (1,048,576 points) and 65,537 random points, with the
    three nets (narrow, full, full without the deform net) and two weight
    seeds, the bf16 raw density query on tensor cores reads a median and p99
    per-point error against its float64 yardstick (fused_density_raw_float64,
    coordinates unrounded) no larger than the SIMT bf16 sweep's (simt=True)
    on the same points (fused_train_dnerf.tc_float64_distance)."""
    failed = []
    pts = {"grid slab": _dn_grid_slab(dev), "random": _sdf_points(65537, dev)}
    for sid, spec in zip(SPEC_IDS, DN_SPECS):
        for seed in (0, 1):
            params = _dn_params(spec, seed, dev)
            for what, (x, t) in pts.items():
                dist = ftd.tc_float64_distance(spec, params, "fused_density_raw", None, None,
                                               (x, t))
                print(f"density raw bf16 vs float64 {sid} seed {seed} {what} (median, p99): "
                      + "; ".join(f"{nm} {v['raw'][0]:.4e}, {v['raw'][1]:.4e}"
                                  for nm, v in dist.items()))
                if not all(fr.no_farther(dist["tensor cores"], dist["SIMT"]).values()):
                    failed.append((sid, seed, what))
    assert not failed, failed


def test_dnerf_deform_fwd_runs_on_tensor_cores(dev):
    """A bf16 deform forward launches the tensor-core kernel
    (dnerf_deform_fwd_tc_kernel) and not the SIMT one; simt=True launches
    the SIMT kernel."""
    traced = _traced_kernels("deform fwd bf16", "deform fwd bf16 simt")
    tc, simt = traced["deform fwd bf16"], traced["deform fwd bf16 simt"]
    print(sorted(tc), sorted(simt))
    assert any("dnerf_deform_fwd_tc_kernel" in k for k in tc)
    assert not any("dnerf_deform_fwd_kernel" in k for k in tc)
    assert any("dnerf_deform_fwd_kernel" in k for k in simt)
    assert not any("_tc_" in k for k in simt)


def test_density_raw_runs_on_tensor_cores(dev):
    """A bf16 raw density query launches the tensor-core sweep
    (dn_sweep_tc_kernel) and not the SIMT D-NeRF sweep; simt=True launches
    the SIMT sweep."""
    traced = _traced_kernels("density raw bf16", "density raw bf16 simt")
    tc, simt = traced["density raw bf16"], traced["density raw bf16 simt"]
    print(sorted(tc), sorted(simt))
    assert any("dn_sweep_tc_kernel" in k for k in tc)
    assert not any("sweep_kernel<" in k for k in tc)
    assert any("sweep_kernel<" in k for k in simt)
    assert not any("_tc_" in k for k in simt)


# sha256 of the float32 D-NeRF render's maps and of the float32 density
# backward's, deform backward's, density forward's, deform forward's, raw
# density query's and colour backward's outputs (tools/dnerf_f32_digest.py's
# cases) as the SIMT kernels compute them, taken on an NVIDIA H100 80GB HBM3
# from the trees before each bf16 kernel took tensor cores (the render and
# density backward's before the render's, the deform backward and density
# forward's before theirs, the deform forward and raw density's before
# theirs, the colour backward's before its own), and the nvcc release
# that compiled them: another toolchain may compile other bits, so the test
# skips under it (rerun the tool on both trees then). The float32 resample's
# depths and the bf16 tensor-core render's maps (its resample in double) as
# the one-thread-a-ray resample computed them, taken on the tree before the
# resample took one warp a ray.
F32_DN_RENDER_DIGEST = "b3e4a35b127df95a3c9a71e6b7db75576f0b578f2399281952151dd9710939b3"
F32_DN_BWD_DIGEST = "4c4f5d2f96ca75accf71af777e9b3717a249a97ffcfbdcede9e41cedd4c04897"
F32_DN_DEFORM_BWD_DIGEST = "22f84ebab5f4a77018efaf36bbebc7b6b7b1f1737d8fc2f51361efdf84e5ef31"
F32_DN_DENSITY_FWD_DIGEST = "2c3c9c5948a1620f725f4190e43481ec5ad45c9fe5331e177e079e653b180315"
F32_DN_DEFORM_FWD_DIGEST = "f6c35c5c0443c3be02e0051438a8805ee08b2fe8e59ad838eaf94206705bd1a1"
F32_DN_DENSITY_RAW_DIGEST = "ce7cb9fe9b6e1e424f8f9d058c64bb67cb893998beda92e15c4d2fa2b9169b4b"
F32_DN_COLOR_BWD_DIGEST = "026e761fe54a5fb2d4d9d3623d53f0e5489351da8fcae25b0f6bc25f50301d69"
F32_DN_COLOR_FWD_DIGEST = "da093a5cbcfa26e15679df28d0ff20d48479ed2e3164950b2869efc57912c1a3"
F32_DN_RESAMPLE_DIGEST = "6838646691cd712c204a5c253c618c90c2585dffbb1b0fd4e46df6da621405e9"
BF16_DN_RENDER_DIGEST = "375e6cad16f602e4fd62a27b9f247777a9f17b320c8ebe1fd8bcec0994d8aae8"


def test_dnerf_f32_is_the_simt_path(dev):
    """The float32 D-NeRF render, density backward, deform backward,
    density forward, deform forward, raw density query, colour backward and
    colour forward run the SIMT code, untouched by the tensor-core bf16
    kernels: their outputs equal that code's recorded digests bit for bit.
    The warp-a-ray resample keeps the one-thread resample's bits: in float32
    (the standalone resample) and in double (the bf16 render's maps)."""
    import subprocess
    got = _tool("dnerf_f32_digest").digests(dev)
    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout
    release = next((ln for ln in nvcc.splitlines() if "release" in ln), nvcc.strip())
    print(f"float32 dnerf render, density backward, deform backward, density forward, "
          f"deform forward, raw density, colour backward, colour forward, resample and bf16 "
          f"dnerf render digests {got} ({release})")
    if F32_RENDER_NVCC not in release:
        pytest.skip(f"the digests were taken with nvcc {F32_RENDER_NVCC.rstrip(',')}, "
                    f"this one is {release}")
    assert got == (F32_DN_RENDER_DIGEST, F32_DN_BWD_DIGEST, F32_DN_DEFORM_BWD_DIGEST,
                   F32_DN_DENSITY_FWD_DIGEST, F32_DN_DEFORM_FWD_DIGEST,
                   F32_DN_DENSITY_RAW_DIGEST, F32_DN_COLOR_BWD_DIGEST, F32_DN_COLOR_FWD_DIGEST,
                   F32_DN_RESAMPLE_DIGEST, BF16_DN_RENDER_DIGEST)


def _resample_inputs(nets: str, n0: int, dev, seed: int = 0):
    """Coarse depths, densities (the kernel's raw density, unit noise, relu)
    and |d| of 1024 depth-guided rays, on the seeded or the opaque full net."""
    spec, params = _render_params(nets, seed, dev)
    rays = _dn_rays(1024, dev, True, seed + 1)
    rspec = en.DNeRFRenderSpec(n_samples=n0)
    z0 = frd.init_z(rspec, rays, torch.randn(1024, n0, generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev))
    o, dd, d_z, _, _, t = en.split_rays(rays)
    pts = (o[:, None] + d_z[:, None] * z0[..., None]).reshape(-1, 3)
    raw = fsd.fused_density_raw_cuda(spec, params, pts, t.repeat_interleave(n0, 0),
                                     torch.float32).reshape(1024, n0)
    noise = torch.randn(raw.shape, generator=torch.Generator(device=dev).manual_seed(9 + seed),
                        device=dev)
    return z0, torch.relu(raw + noise), dd.norm(dim=-1, keepdim=True)


RESAMPLE_CELLS = [(64, 64), (32, 16), (8, 8)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("nets", ["full", "full-dense"])
@pytest.mark.parametrize("cell", RESAMPLE_CELLS, ids=[f"{a}+{b}" for a, b in RESAMPLE_CELLS])
def test_fine_resample_matches_plain(dev, cell, nets, seed):
    """fused_fine_resample against fine_resample_math at RESAMPLE_PARITY_TOL;
    one launch a call, sorted output, the coarse depths kept."""
    n0, n_new = cell
    z0, sigma, dn = _resample_inputs(nets, n0, dev, seed)
    before = fs.LAUNCHES["fused_fine_resample"]
    got = fs.fused_fine_resample(z0, sigma, dn, n_new)
    assert fs.LAUNCHES["fused_fine_resample"] == before + 1
    ref = fs.fused_fine_resample_reference(z0, sigma, dn, n_new)
    res = fs.resample_parity(got, ref)
    print(f"resample {cell} {nets} seed {seed}: {res}")
    assert res[-1], res
    assert got.shape == (1024, n0 + n_new) and bool((got[:, 1:] >= got[:, :-1]).all())
    assert bool(torch.isin(z0[:8], got[:8]).all())


@pytest.mark.parametrize("corner", fs.RESAMPLE_CORNERS,
                         ids=[f"{a}+{b}" for a, b in fs.RESAMPLE_CORNERS])
def test_fine_resample_edges_match_plain(dev, corner):
    """fused_fine_resample on fused_sampler.resample_edge_inputs (a pdf of
    the weight floor alone, one opaque sample, alpha exactly 1, duplicated
    depths, draws on a coarse depth; 64 rays of each) at the gate's corners
    against fine_resample_math at RESAMPLE_PARITY_TOL; one launch, sorted
    output, every ray's coarse depths kept."""
    n0, n_new = corner
    z0, sigma, dn = (a.to(dev) for a in fs.resample_edge_inputs(n0, 0, 64))
    before = fs.LAUNCHES["fused_fine_resample"]
    got = fs.fused_fine_resample(z0, sigma, dn, n_new)
    assert fs.LAUNCHES["fused_fine_resample"] == before + 1
    ref = fs.fused_fine_resample_reference(z0, sigma, dn, n_new)
    res = fs.resample_parity(got, ref)
    print(f"resample edges {corner}: {res}")
    assert res[-1], res
    assert got.shape == (z0.shape[0], n0 + n_new) and bool((got[:, 1:] >= got[:, :-1]).all())
    assert bool((got[:, None, :] == z0[:, :, None]).any(-1).all())


@pytest.mark.parametrize("fault", ["draws_half_step", "resample_dist_without_dn"])
def test_fine_resample_limits_catch_planted_faults(dev, fault, tmp_path, monkeypatch):
    """The resample built with its draws half a step early, or its coarse
    weights on distances without |d|, fails the limits on the opaque nets
    (the seeded nets' readings are printed)."""
    old, new, _ = RESAMPLE_FAULTS[fault]
    _rebuild_with(monkeypatch, tmp_path, "fused_render_dnerf.cu", old, new)
    for nets in ("full", "full-dense"):
        z0, sigma, dn = _resample_inputs(nets, 64, dev)
        res = fs.resample_parity(fs.fused_fine_resample_cuda(z0, sigma, dn),
                                 fs.fused_fine_resample_reference(z0, sigma, dn))
        print(f"{fault} {nets}: {res}")
        if nets == "full-dense" or fault == "draws_half_step":
            assert not res[-1], (nets, res)


def test_fine_resample_entry_checks(dev):
    z0, sigma, dn = _resample_inputs("full", 64, dev)
    with pytest.raises(ValueError, match="does not take"):
        fs.fused_fine_resample(z0, sigma, dn, 65)
    with pytest.raises(ValueError, match="expected"):
        fs.fused_fine_resample_cuda(z0, sigma[:, :8], dn)
    assert fs.fused_fine_resample(z0.cpu(), sigma.cpu(), dn.cpu()).device.type == "cpu"


def test_dnerf_train_step_runs_the_kernels(dev, tmp_path, monkeypatch):
    """EndoNeRFTrainer on the card: a step launches fused_density_raw,
    fused_fine_resample and each D-NeRF forward and backward segment once and
    never the plain resample or plain field; megakernel: off and
    sampler_kernel: off raise on a CUDA device."""
    from endosurf_tpu_torch.train.trainer_endonerf import EndoNeRFTrainer

    def plain(*args, **kw):
        raise AssertionError("a plain version ran on CUDA tensors")
    net = {"net_deform_cfg": {"n_layers": 3, "hidden_dim": 64, "skips": [1]},
           "net_density_cfg": {"n_layers": 3, "hidden_dim": 64, "skips": [1]},
           "net_color_cfg": {"n_layers": 2, "hidden_dim": 64, "skips": []}, "geo_feat_dim": 32}
    cfg = {"exp": {"project_name": "p", "exp_name": "e", "exp_dir": str(tmp_path)},
           "render": {"type": "endonerf"}, "net": net,
           "train": {"n_iter": 2, "ray_batch": 256, "optim": {"lr": 5e-4}},
           "log": {"i_eval": 0, "i_save": 2}}
    scene = make_synthetic_arrays(4, 32, 40, 0, dev)
    monkeypatch.setattr(fs, "fine_resample_math", plain)
    monkeypatch.setattr(ftd, "forward_math", plain)
    trainer = EndoNeRFTrainer(cfg, scene=scene, device=dev)
    before = {**ftd.LAUNCHES, "resample": fs.LAUNCHES["fused_fine_resample"],
              "density_raw": fsd.LAUNCHES["fused_density_raw"]}
    trainer.start(log_every=1)
    after = {**ftd.LAUNCHES, "resample": fs.LAUNCHES["fused_fine_resample"],
             "density_raw": fsd.LAUNCHES["fused_density_raw"]}
    assert all(after[k] == before[k] + 2 for k in before), (before, after)
    for key in ("megakernel", "sampler_kernel"):
        bad = {**cfg, "train": {**cfg["train"], key: "off"}}
        with pytest.raises(NotImplementedError, match="off"):
            EndoNeRFTrainer(bad, scene=scene, device=dev)
