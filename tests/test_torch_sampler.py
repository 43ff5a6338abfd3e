"""The upsample kernel's module (kernels/fused_sampler.py) held against the JAX
package on the CPU.

The port's plain twin ``fused_upsample_z_reference`` is compared with the JAX
Pallas kernel ``fused_upsample_z`` run in interpret mode (as
tests/test_fused_sampler.py runs it) and with JAX ``upsample_z``, on
perturbed z0 (stratified plus a per-ray jitter), with and without
``return_sdf``. A narrow spec (9 layers of width 64) keeps the interpreted
kernel to seconds.

Tolerances, per ray (max over its samples): float32 (JAX at
precision="highest") 1e-4 on all rays but at most 1 in 32, all within 5e-3:
a deterministic inverse-CDF draw on a bin edge moves a new sample on a few
rays (ROADMAP.md, section C). Read here: 6.0e-6 worst on z, 2.8e-6 on sdf.
bf16 ("default" dots on both sides): 2e-3 on the same terms. Read here: z
3.7e-6 worst; sdf 1.15e-3 worst, over 1e-4 on 6 rays of 32 (the two sides
round different operands in the sampling chain). The twin with float32 dots
misses the bf16 kernel by 4.1e-3 on the median ray's sdf (9.3e-3 worst), so
test_bf16_tolerance_rejects_f32_dots asserts that most rays miss 2e-3.

The CUDA kernel itself is held against the plain twin in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endosurf_tpu.kernels import fused_sampler as j_fs
from endosurf_tpu.models import endosurf as j_es
from endosurf_tpu.models import fields as j_fields
from endosurf_tpu.ops.mlp import set_matmul_precision
from endosurf_tpu_torch.bridge import params_from_jax
from endosurf_tpu_torch.kernels import fused_sampler as t_fs
from endosurf_tpu_torch.models import fields as t_fields

F32_TOL = 1e-4
BF16_TOL = 2e-3
LOOSE = 5e-3
FRAC = 1.0 / 32


def _narrow(mod):
    return mod.EndoSurfSpec(deform=mod.MLPSpec(9, 64, (4,), 3),
                            sdf=mod.MLPSpec(9, 64, (4,), 65),
                            color=mod.MLPSpec(9, 64, (4,), 3), color_feat_dim=64)


def _inputs(n: int = 32, seed: int = 1):
    """o, d_z [n, 3], t [n, 1] and perturbed ascending z0 [n, 32] (numpy)."""
    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(-0.3, 0.3, (n, 2)), np.full((n, 1), -1.5)], -1)
    d = rng.uniform(-0.2, 0.2, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d_z = d / (d[:, 2:3] + 1e-6)
    t = rng.uniform(0, 1, (n, 1))
    near, far = 0.6, 2.4
    z0 = near + (far - near) * np.linspace(0, 1, 32)[None, :]
    z0 = z0 + (rng.uniform(0, 1, (n, 1)) - 0.5) * (2.0 / 32)
    return [a.astype(np.float32) for a in (o, d_z, t, z0)]


def _per_ray(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max(-1)


def _assert_mostly_close(got, ref, tight, name):
    err = _per_ray(got, ref)
    assert err.max() <= LOOSE, (name, err.max())
    assert (err > tight).mean() <= FRAC, (name, np.sort(err)[-4:])


@pytest.fixture(scope="module")
def case():
    spec_j = _narrow(j_fields)
    pj = j_fields.init_endosurf_params(jax.random.PRNGKey(0), spec_j)
    return spec_j, pj, _inputs()


def _twin(pj, inputs, dtype, return_sdf):
    o, d_z, t, z0 = (torch.from_numpy(a) for a in inputs)
    return t_fs.fused_upsample_z_reference(_narrow(t_fields), params_from_jax(pj), o, d_z, t,
                                           z0, 32, 4, dtype, return_sdf)


def _jax_kernel(spec_j, pj, inputs, dtype, return_sdf):
    return j_fs.fused_upsample_z(spec_j, pj, *(jnp.asarray(a) for a in inputs), 32, 4,
                                 compute_dtype=dtype, interpret=True, return_sdf=return_sdf)


@pytest.mark.parametrize("return_sdf", [False, True], ids=["z", "z+sdf"])
def test_reference_matches_jax_f32(case, return_sdf):
    """Plain twin == interpreted JAX kernel == JAX upsample_z, float32."""
    set_matmul_precision("highest")
    spec_j, pj, inputs = case
    got = _twin(pj, inputs, torch.float32, return_sdf)
    kern = _jax_kernel(spec_j, pj, inputs, jnp.float32, return_sdf)
    o, d_z, t, z0 = (jnp.asarray(a) for a in inputs)
    ref = jax.jit(lambda p: j_es.upsample_z(spec_j, j_es.RenderSpec(), p, o, d_z, t, z0,
                                            return_sdf=return_sdf))(pj)
    if not return_sdf:
        got, kern, ref = (got,), (kern,), (ref,)
    for g, k, r, name in zip(got, kern, ref, ("z", "sdf")):
        assert g.shape == (32, 64) and g.dtype == torch.float32
        _assert_mostly_close(g.numpy(), k, F32_TOL, name + " vs kernel")
        _assert_mostly_close(g.numpy(), r, F32_TOL, name + " vs upsample_z")
    assert np.all(np.diff(got[0].numpy(), axis=-1) >= 0)


@pytest.fixture(scope="module")
def bf16_kernel(case):
    spec_j, pj, inputs = case
    return _jax_kernel(spec_j, pj, inputs, jnp.bfloat16, True)


def test_reference_matches_jax_kernel_bf16(case, bf16_kernel):
    _, pj, inputs = case
    z, sdf = _twin(pj, inputs, torch.bfloat16, True)
    _assert_mostly_close(z.numpy(), bf16_kernel[0], BF16_TOL, "z")
    _assert_mostly_close(sdf.numpy(), bf16_kernel[1], BF16_TOL, "sdf")


def test_bf16_tolerance_rejects_f32_dots(case, bf16_kernel):
    """BF16_TOL tells the precisions apart: the float32 twin misses the bf16
    JAX kernel's sdf on most rays."""
    _, pj, inputs = case
    _, sdf = _twin(pj, inputs, torch.float32, True)
    assert (_per_ray(sdf.numpy(), bf16_kernel[1]) > BF16_TOL).mean() > 0.5


def test_float64_yardstick_matches_jax_kernel_bf16(case, bf16_kernel):
    """fused_upsample_z_float64, the bf16 CUDA kernels' float64 yardstick, is
    a bf16 upsampling in float64: float64 (z, sdf), within the bf16 limits of
    the interpreted JAX kernel."""
    _, pj, inputs = case
    o, d_z, t, z0 = (torch.from_numpy(a) for a in inputs)
    z, sdf = t_fs.fused_upsample_z_float64(_narrow(t_fields), params_from_jax(pj), o, d_z, t, z0,
                                           32, 4)
    assert z.dtype == sdf.dtype == torch.float64 and z.shape == (32, 64)
    _assert_mostly_close(z.numpy(), bf16_kernel[0], BF16_TOL, "z")
    _assert_mostly_close(sdf.numpy(), bf16_kernel[1], BF16_TOL, "sdf")


def test_bf16_operand_keeps_float64():
    """A "default" operand is the bf16 rounding, float64 for a float64 value
    (the yardsticks' sums stay float64) and float32 otherwise."""
    from endosurf_tpu_torch.ops.mlp import operand
    x = torch.tensor([1.0 + 2.0 ** -7 + 2.0 ** -20, -3.0e-5], dtype=torch.float64)
    want = x.to(torch.bfloat16)
    got = operand(x, "default")
    assert got.dtype == torch.float64 and torch.equal(got, want.double())
    for dt in (torch.float32, torch.bfloat16):
        got = operand(x.to(dt), "default")
        assert got.dtype == torch.float32 and torch.equal(got, want.float())
    assert operand(x, "highest") is x


def test_return_sdf_keeps_z(case):
    """return_sdf adds the SDF at every sample and leaves z as it was."""
    _, pj, inputs = case
    z_plain = _twin(pj, inputs, torch.float32, False)
    z, sdf = _twin(pj, inputs, torch.float32, True)
    torch.testing.assert_close(z, z_plain, rtol=0, atol=0)
    assert sdf.shape == z.shape and bool(torch.isfinite(sdf).all())


def test_consistency_checks_accept_jax_and_catch_faults(case):
    """fused_sampler.consistency_errors at CONSISTENCY_TOL accepts the
    interpreted JAX kernel's float32 (z, sdf), an implementation of its own,
    and each of its checks rejects that output with a fault on 1 ray in 8: a
    new sample moved by 1e-3, an sdf 0.1 % off, a given sample replaced.
    (bf16 is not held here: JAX's sampling chain rounds other operands.)"""
    set_matmul_precision("highest")
    spec_j, pj, inputs = case
    spec, params = _narrow(t_fields), params_from_jax(pj)
    o, d_z, t, z0 = (torch.from_numpy(a) for a in inputs)
    z, sdf = (torch.from_numpy(np.array(a))
              for a in _jax_kernel(spec_j, pj, inputs, jnp.float32, True))

    def report(z_, sdf_):
        c = t_fs.consistency_errors(spec, params, o, d_z, t, z0, z_, sdf_, 32, 4)
        return t_fs.consistency_report(c, torch.float32)
    good = report(z, sdf)
    assert all(ok for _, ok in good.values()), good

    rows = torch.arange(0, z.shape[0], 8)
    new_col = (~(z[:, None, :] == z0[:, :, None]).any(1)).float().argmax(-1)
    moved = z.clone()
    moved[rows, new_col[rows]] += 1e-3
    order = torch.argsort(moved, dim=-1, stable=True)
    assert not report(torch.gather(moved, 1, order), torch.gather(sdf, 1, order))["draw"][1]
    off = sdf.clone()
    off[rows] *= 1.001
    assert not report(z, off)["sdf_point"][1]
    dropped = z.clone()
    dropped[rows, 0] -= 1e-3
    assert not report(dropped, sdf)["kept"][1]


def test_shape_gate_matches_jax():
    for n0 in (8, 16, 24, 32, 48, 64):
        for n_imp in (0, 8, 16, 30, 32, 48):
            for rounds in (1, 2, 4):
                assert (t_fs.upsample_shape_supported(n0, n_imp, rounds)
                        == j_fs.upsample_shape_supported(n0, n_imp, rounds)), (n0, n_imp, rounds)


def test_dispatch_on_cpu_and_cuda_entry_refuses_cpu(case):
    """CPU tensors take the plain twin (no launch); the CUDA entry raises on
    them rather than falling back."""
    _, pj, inputs = case
    spec = _narrow(t_fields)
    params = params_from_jax(pj)
    o, d_z, t, z0 = (torch.from_numpy(a) for a in inputs)
    before = dict(t_fs.LAUNCHES)
    z = t_fs.fused_upsample_z(spec, params, o, d_z, t, z0, 32, 4)
    assert t_fs.LAUNCHES == before
    torch.testing.assert_close(z, t_fs.fused_upsample_z_reference(spec, params, o, d_z, t, z0,
                                                                  32, 4), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        t_fs.fused_upsample_z_cuda(spec, params, o, d_z, t, z0, 32, 4)
    with pytest.raises(ValueError):
        t_fs.fused_upsample_z(spec, params, o, d_z, t, z0.to("meta"), 32, 4)
