"""The CUDA render kernel on the card, held against its plain PyTorch twin.

Every test here needs an NVIDIA GPU with nvcc and skips without one. The
file imports no JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(--noconftest: tests/conftest.py sets up JAX for the other files.) The
tolerances and their reasons are ``fused_render.PARITY_TOL``.
"""

import os.path as osp
import shutil

import pytest
import torch

from endosurf_tpu_torch.kernels import build
from endosurf_tpu_torch.kernels import fused_render as fr
from endosurf_tpu_torch.models import endosurf as es
from endosurf_tpu_torch.models.fields import EndoSurfSpec, MLPSpec, init_endosurf_params

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
