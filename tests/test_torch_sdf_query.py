"""The observed-SDF query (kernels/fused_sdf.py) held against the JAX package
on the CPU.

The port's plain version ``fused_sdf_observed_reference`` (what the wrapper
runs for CPU tensors) is compared with JAX's Pallas kernel
``fused_sdf_observed`` under ``pltpu.force_tpu_interpret_mode()`` (as
tests/test_pallas_kernels.py runs it) and with JAX's ``sdf_observed``, from
one JAX init bridged to torch and one numpy draw of the points. A narrow
spec (9 layers of width 64) keeps the interpreted kernel to seconds.

Tolerances: float32 (JAX at precision="highest") 1e-5 absolute per point.
bf16 (``compute_dtype`` bf16 on both sides: bf16 operands, float32
accumulation) 1e-4 absolute on all but 1 point in 64 and 3e-3 on every
point: an operand on a bf16 rounding edge rounds the other way on one side.
Read here: float32 worst 9.5e-7; bf16 worst 1.53e-3, over 1e-4 on 0.59 % of
the points. The float32 math misses the bf16 kernel on most points, so
``test_bf16_tolerance_rejects_f32_dots`` holds the bf16 limit to that.

The bf16 query's float64 yardstick (``fused_sdf_observed_float64``) is held
against the same interpreted kernel at both precisions, with the same
limits.

The CUDA kernel itself is held against the plain version in
test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from endosurf_tpu.kernels import fused_sdf as j_fsd
from endosurf_tpu.models import endosurf as j_es
from endosurf_tpu.models import fields as j_fields
from endosurf_tpu.ops import mlp as j_mlp
from endosurf_tpu_torch.bridge import params_from_jax
from endosurf_tpu_torch.kernels import fused_sdf as t_fsd
from endosurf_tpu_torch.models import endosurf as t_es
from endosurf_tpu_torch.models import fields as t_fields

F32_TOL = 1e-5
BF16_TOL, BF16_LOOSE, BF16_FRAC = 1e-4, 3e-3, 1.0 / 64


def _narrow(mod, use_deform=True):
    return mod.EndoSurfSpec(use_deform=use_deform, deform=mod.MLPSpec(9, 64, (4,), 3),
                            sdf=mod.MLPSpec(9, 64, (4,), 65),
                            color=mod.MLPSpec(9, 64, (4,), 3), color_feat_dim=64)


@pytest.fixture(autouse=True)
def _highest():
    j_mlp.set_matmul_precision("highest")
    yield


@pytest.fixture(scope="module")
def params():
    pj = j_fields.init_endosurf_params(jax.random.PRNGKey(0), _narrow(j_fields))
    return pj, params_from_jax(pj)


def _points(n, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32),
            rng.uniform(0, 1, (n, 1)).astype(np.float32))


def _jax_kernel(spec, pj, x, t, dtype):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(j_fsd.fused_sdf_observed(spec, pj, jnp.asarray(x), jnp.asarray(t),
                                                   compute_dtype=dtype))


def _port(spec, pt, x, t, dtype):
    return t_fsd.fused_sdf_observed(spec, pt, torch.from_numpy(x), torch.from_numpy(t),
                                    dtype).numpy()


@pytest.mark.parametrize("n", [511, 513])
@pytest.mark.parametrize("use_deform", [True, False], ids=["deform", "static"])
def test_plain_matches_interpreted_jax_kernel_f32(params, use_deform, n):
    pj, pt = params
    x, t = _points(n)
    got = _port(_narrow(t_fields, use_deform), pt, x, t, torch.float32)
    ref = _jax_kernel(_narrow(j_fields, use_deform), pj, x, t, jnp.float32)
    assert got.shape == ref.shape == (n, 1) and got.dtype == np.float32
    print(f"f32 worst {np.abs(got - ref).max():.3e}")
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("use_deform", [True, False], ids=["deform", "static"])
def test_plain_matches_jax_sdf_observed(params, use_deform):
    pj, pt = params
    x, t = _points(700, seed=2)
    got = _port(_narrow(t_fields, use_deform), pt, x, t, torch.float32)
    ref = np.asarray(j_fields.sdf_observed(_narrow(j_fields, use_deform), pj, jnp.asarray(x),
                                           jnp.asarray(t)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_TOL)


def _bf16_close(got, ref):
    err = np.abs(got - ref)[:, 0]
    return err.max() <= BF16_LOOSE and (err > BF16_TOL).mean() <= BF16_FRAC, err


@pytest.mark.parametrize("use_deform", [True, False], ids=["deform", "static"])
def test_plain_matches_interpreted_jax_kernel_bf16(params, use_deform):
    pj, pt = params
    x, t = _points(1024, seed=3)
    got = _port(_narrow(t_fields, use_deform), pt, x, t, torch.bfloat16)
    ref = _jax_kernel(_narrow(j_fields, use_deform), pj, x, t, jnp.bfloat16)
    ok, err = _bf16_close(got, ref)
    print(f"bf16 worst {err.max():.3e}, over {BF16_TOL:g} on {100 * (err > BF16_TOL).mean():.2f} %")
    assert ok, (err.max(), (err > BF16_TOL).mean())


def test_bf16_tolerance_rejects_f32_dots(params):
    """The float32 math misses the bf16 kernel by more than the bf16 limit
    on most points: the limit sees whether the rounding is on."""
    pj, pt = params
    x, t = _points(1024, seed=3)
    got = _port(_narrow(t_fields), pt, x, t, torch.float32)
    ref = _jax_kernel(_narrow(j_fields), pj, x, t, jnp.bfloat16)
    ok, err = _bf16_close(got, ref)
    assert not ok and (err > BF16_TOL).mean() > 0.5, np.median(err)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("use_deform", [True, False], ids=["deform", "static"])
def test_float64_yardstick_matches_interpreted_jax_kernel(params, use_deform, dtype):
    """The bf16 query's float64 yardstick (``fused_sdf_observed_float64``: the
    plain version in float64 on the kernel's own weights, coordinates
    unrounded) against JAX's Pallas kernel, interpreted, on the same 1024
    points: in float32 within F32_TOL (float64 against float32 sums), with
    bf16 operand roundings on both sides within the bf16 limits (BF16_TOL on
    all but BF16_FRAC of the points, BF16_LOOSE on every one: an operand on
    a rounding edge rounds the other way on one side); the float32 yardstick
    misses the bf16 kernel on most points (the rounding is on)."""
    pj, pt = params
    x, t = _points(1024, seed=5)
    spec = _narrow(t_fields, use_deform)
    tdt, jdt = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]

    def yardstick(compute_dtype):
        out = t_fsd.fused_sdf_observed_float64(spec, pt, torch.from_numpy(x), torch.from_numpy(t),
                                               compute_dtype)
        assert out.shape == (1024, 1) and out.dtype == torch.float64
        return out.numpy()
    ref = _jax_kernel(_narrow(j_fields, use_deform), pj, x, t, jdt)
    got = yardstick(tdt)
    if dtype == "f32":
        print(f"float64 yardstick vs JAX f32 worst {np.abs(got - ref).max():.3e}")
        np.testing.assert_allclose(got, ref, rtol=0, atol=F32_TOL)
        return
    ok, err = _bf16_close(got, ref)
    print(f"float64 yardstick vs JAX bf16 worst {err.max():.3e}, over {BF16_TOL:g} on "
          f"{100 * (err > BF16_TOL).mean():.2f} %")
    assert ok, (err.max(), (err > BF16_TOL).mean())
    ok, err = _bf16_close(yardstick(torch.float32), ref)
    assert not ok and (err > BF16_TOL).mean() > 0.5, np.median(err)


def test_sdf_sampling_dispatch_and_precision(params):
    """_sdf_sampling on CPU tensors is the plain sdf_observed at the given
    precision (JAX's _sdf_sampling off the TPU at "highest"), for any N."""
    pj, pt = params
    x, t = _points(3000, seed=4)
    spec = _narrow(t_fields)
    got = t_es._sdf_sampling(spec, pt, torch.from_numpy(x), torch.from_numpy(t), "highest")
    ref = np.asarray(j_es._sdf_sampling(_narrow(j_fields), pj, jnp.asarray(x), jnp.asarray(t)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F32_TOL)
    bf = t_es._sdf_sampling(spec, pt, torch.from_numpy(x), torch.from_numpy(t), "default")
    want = t_fields.sdf_observed(spec, pt, torch.from_numpy(x), torch.from_numpy(t), "default")
    torch.testing.assert_close(bf, want.detach(), rtol=0, atol=0)
    assert float((bf - got).abs().max()) > 1e-4


def test_wrappers_refuse_what_the_kernel_does_not_take(params):
    _, pt = params
    spec = _narrow(t_fields)
    x, t = (torch.from_numpy(a) for a in _points(8))
    before = dict(t_fsd.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        t_fsd.fused_sdf_observed_cuda(spec, pt, x, t)
    with pytest.raises(ValueError, match="no fused_sdf_observed"):
        t_fsd.fused_sdf_observed(spec, pt, x.to("meta"), t.to("meta"))
    assert t_fsd.LAUNCHES == before
    out = t_fsd.fused_sdf_observed(dataclasses.replace(spec, use_deform=False), pt, x, t)
    assert out.shape == (8, 1) and not out.requires_grad
