"""Parity of the port's field evaluation (models/fields.py and the forward
half of kernels/fused_train.py) with the JAX package, full-width
EndoSurfSpec, float32 on the CPU.

Tolerances: 1e-4 for float32 (JAX at precision="highest"; the deform
Jacobian, the SDF adjoint and the colour net chain 27 layers of 256-wide
float32 sums in different orders). The bf16 ("default") mode rounds every
dot operand to bf16 on both sides; there a float32-ulp difference in an
accumulation can flip one bf16 rounding (0.4 % relative), so it is held at
2e-2 absolute on the sdf and colour and 5e-2 on the unnormalised gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endosurf_tpu.kernels import fused_train as j_ft
from endosurf_tpu.models import fields as j_fields
from endosurf_tpu.ops.mlp import set_matmul_precision
from endosurf_tpu_torch.bridge import params_from_jax
from endosurf_tpu_torch.kernels import fused_train as t_ft
from endosurf_tpu_torch.models import fields as t_fields

N = 48


@pytest.fixture(scope="module", params=[True, False], ids=["deform", "static"])
def case(request):
    spec_j = j_fields.EndoSurfSpec(use_deform=request.param)
    spec_t = t_fields.EndoSurfSpec(use_deform=request.param)
    pj = j_fields.init_endosurf_params(jax.random.PRNGKey(0), spec_j)
    rng = np.random.default_rng(7)
    x = rng.uniform(-0.7, 0.7, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = rng.uniform(0, 1, (N, 1)).astype(np.float32)
    return spec_j, spec_t, pj, params_from_jax(pj), x, d, t


def _t(a):
    return torch.from_numpy(a)


def test_fused_point_eval(case):
    spec_j, spec_t, pj, pt, x, d, t = case
    set_matmul_precision("highest")
    oj = j_fields.fused_point_eval(spec_j, pj, jnp.asarray(x), jnp.asarray(d), jnp.asarray(t))
    ot = t_fields.fused_point_eval(spec_t, pt, _t(x), _t(d), _t(t), precision="highest")
    for k in ("sdf", "color", "grad_o", "grad_c"):
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), atol=1e-4, err_msg=k)


def test_sdf_and_color_apply(case):
    spec_j, spec_t, pj, pt, x, d, t = case
    set_matmul_precision("highest")
    np.testing.assert_allclose(
        t_fields.sdf_observed(spec_t, pt, _t(x), _t(t)).numpy(),
        np.asarray(j_fields.sdf_observed(spec_j, pj, jnp.asarray(x), jnp.asarray(t))),
        atol=1e-5)
    feat = np.random.default_rng(3).normal(size=(N, 256)).astype(np.float32)
    np.testing.assert_allclose(
        t_fields.color_apply(spec_t, pt, _t(x), _t(d), _t(d), _t(feat)).numpy(),
        np.asarray(j_fields.color_apply(spec_j, pj, jnp.asarray(x), jnp.asarray(d),
                                        jnp.asarray(d), jnp.asarray(feat))),
        atol=1e-5)
    np.testing.assert_allclose(float(t_fields.inv_s(pt)), float(j_fields.inv_s(pj)), rtol=1e-6)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_forward_math(case, mode):
    """prepare_effective + forward_math against the JAX kernel math (its
    128-lane layout sliced back to the true widths)."""
    spec_j, spec_t, pj, pt, x, d, t = case
    if mode == "f32":
        j_ft.set_compute_mode(jnp.float32, "highest")
        tols = {"sdf": 1e-4, "color": 1e-4, "grad_o": 1e-4, "grad_c": 1e-4}
    else:
        j_ft.set_compute_mode(jnp.bfloat16, None)
        tols = {"sdf": 2e-2, "color": 2e-2, "grad_o": 5e-2, "grad_c": 5e-2}
    try:
        eff = j_ft.prepare_effective(spec_j, pj)
        oj = j_ft.forward_math(spec_j, eff, j_ft.selectors(spec_j),
                               j_ft.pad_lanes(jnp.asarray(x), jnp.asarray(t)),
                               j_ft.pad_lanes(jnp.asarray(d)))
    finally:
        j_ft.set_compute_mode(jnp.float32, "highest")
    ot = t_ft.forward_math(spec_t, t_ft.prepare_effective(spec_t, pt), _t(x), _t(t), _t(d),
                           precision="highest" if mode == "f32" else "default")
    widths = {"sdf": 1, "color": 3, "grad_o": 3, "grad_c": 3}
    for k, w in widths.items():
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k])[:, :w], atol=tols[k],
                                   err_msg=k)


def test_prepare_effective_layout(case):
    """Skip layers split into [h rows | encoding rows]; the SDF output layer
    into head and feature; no 128-lane padding."""
    spec_j, spec_t, pj, pt, *_ = case
    eff = t_ft.prepare_effective(spec_t, pt)
    assert eff["sdf_head"]["w"].shape == (256, 1)
    assert eff["sdf_feat"]["w"].shape == (256, 256)
    assert len(eff["sdf"]) == 8
    assert eff["sdf"][4]["wh"].shape == (256, 256)
    assert [w.shape[0] for w in eff["color"][0]["wsec"]] == [63, 3, 27, 256]
    if spec_t.use_deform:
        assert eff["deform"][3]["w"].shape == (256, 256 - 52)
        assert eff["deform"][4]["wh"].shape == (256 - 52, 256)
        assert eff["deform"][4]["wsec"][0].shape == (52, 256)
    else:
        assert "deform" not in eff
