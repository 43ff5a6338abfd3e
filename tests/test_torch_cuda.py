"""The CUDA kernels on the card, held against their plain PyTorch twins: the
render kernel (``fused_render_rays``) and the upsample kernel
(``fused_upsample_z``), plus one train step with the upsample kernel against
one with the plain upsampling.

Every test here needs an NVIDIA GPU with nvcc and skips without one. The
file imports no JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(--noconftest: tests/conftest.py sets up JAX for the other files; -rP shows
the readings the tests print.) The tolerances and their reasons are
``fused_render.PARITY_TOL``, ``fused_sampler.PARITY_TOL`` and
``fused_sampler.CONSISTENCY_TOL``; the planted-fault test rebuilds the
kernels from a patched copy of the sources.
"""

import os.path as osp
import shutil

import pytest
import torch

from endosurf_tpu_torch.kernels import build
from endosurf_tpu_torch.bridge import flatten
from endosurf_tpu_torch.data.scene_data import make_synthetic_arrays
from endosurf_tpu_torch.kernels import fused_render as fr
from endosurf_tpu_torch.kernels import fused_sampler as fs
from endosurf_tpu_torch.models import endosurf as es
from endosurf_tpu_torch.models.fields import EndoSurfSpec, MLPSpec, init_endosurf_params
from endosurf_tpu_torch.ops.geometry import ray_sphere_intersection
from endosurf_tpu_torch.train.trainer_endosurf import make_loss_fn

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


# Faults planted in csrc/sdf_chain.cuh that hit a minority of rays: the text
# replaced, its replacement, and the dot modes in which the limits must
# catch it. One operand rounding differently moves a bf16 point's SDF by up
# to ~7e-3, so an SDF 0.1 % off is caught in float32 only.
FAULTS = {
    "skip_last_merge_r64": (
        "  if (r >= R) return;\n  float* z = zl",
        "  if (r >= R) return;\n  if (s + k == 64 && r % 64 == 0) return;\n  float* z = zl",
        (torch.float32, torch.bfloat16)),
    "shift_last_draws_r128": (
        "    float u = ((float)n + 0.5f) / (float)k;",
        "    float u = ((float)n + ((s + k == 64 && r % 128 == 0) ? 0.6f : 0.5f)) / (float)k;",
        (torch.float32, torch.bfloat16)),
    "scale_new_sdf_r64": (
        "    float sn = snew ? snew[(size_t)r * KNEW_MAX + n] : 0.f;",
        "    float sn = snew ? snew[(size_t)r * KNEW_MAX + n] * (r % 64 == 0 ? 1.001f : 1.f)"
        " : 0.f;",
        (torch.float32,)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_upsample_limits_catch_planted_faults(dev, fault, tmp_path, monkeypatch):
    """A kernel wrong on 1/64 or 1/128 of the rays fails the limits, where
    the twin comparison alone lets the smaller faults through."""
    if shutil.which("nvcc") is None and not osp.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc")
    old, new, dtypes = FAULTS[fault]
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC, src)
    text = (src / "sdf_chain.cuh").read_text()
    assert text.count(old) == 1
    (src / "sdf_chain.cuh").write_text(text.replace(old, new))
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_LIB", None)
    spec = EndoSurfSpec()
    params = init_endosurf_params(spec, torch.Generator().manual_seed(0), dev)
    inputs = _upsample_inputs(1024, dev)
    for dtype in dtypes:
        got = _upsample(fs.fused_upsample_z_cuda, spec, params, inputs, dtype, True)
        ref = _upsample(fs.fused_upsample_z_reference, spec, params, inputs, dtype, True)
        ok, report = _upsample_check(spec, params, inputs, got, ref, dtype)
        print(f"{fault} {dtype}: {report}")
        assert not ok, report


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
# upsampling (same params, batch and draws): relative difference of every
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
