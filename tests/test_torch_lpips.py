"""The port's LPIPS (``evaluation/lpips_torch.py``) and ``cal_lpips`` held
against the JAX package on the CPU, on random weights in the
``lpips_vgg16.npz`` schema (``tests/test_metrics.py``'s tiny-width
``_tiny_vgg_npz``): the metric, the masked and batched ``cal_lpips``, an
absent file giving None and corrupt files raising as ``validate_weights``
does.

Tolerance: rtol 1e-5, atol 1e-6 on the per-image LPIPS and ``cal_lpips``
(readings 2.2e-7 to 8.0e-7 relative): both sides run float32 convolutions (JAX's
``lax.conv`` at "highest", the port's ``F.conv2d``) in other summation
orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import endosurf_tpu.evaluation.lpips_jax as j_lp
from endosurf_tpu.evaluation import metrics as j_metrics
from endosurf_tpu_torch.evaluation import lpips_torch as t_lp
from endosurf_tpu_torch.evaluation import metrics as t_metrics
from test_metrics import _tiny_vgg_npz

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def weights(tmp_path, monkeypatch):
    path = str(tmp_path / "lpips_tiny.npz")
    raw = _tiny_vgg_npz(np.random.default_rng(0), path)
    monkeypatch.setenv("ESN_LPIPS_WEIGHTS", path)
    monkeypatch.setattr(j_lp, "WEIGHTS_PATH", path)
    j_lp.lpips_fn.cache_clear()
    t_lp.lpips_fn.cache_clear()
    yield path, raw
    j_lp.lpips_fn.cache_clear()
    t_lp.lpips_fn.cache_clear()


def _images(seed, n=3, h=32, w=40):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.15, a.shape), 0, 1).astype(np.float32)
    return a, b


def test_lpips_matches_jax(weights):
    path, _ = weights
    fn_t, fn_j = t_lp.lpips_fn(path), j_lp.lpips_fn(path)
    assert fn_t is not None and fn_j is not None
    a, b = _images(1)
    got = fn_t(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(fn_j(jnp.asarray(a), jnp.asarray(b))),
                               rtol=RTOL, atol=ATOL)
    assert got.shape == (3,) and (got > 0).all()
    np.testing.assert_allclose(fn_t(torch.from_numpy(a), torch.from_numpy(a)).numpy(), 0.0,
                               atol=1e-6)
    assert t_lp.lpips_fn(path) is fn_t   # built once a path


@pytest.mark.parametrize("mask_ndim", [3, 4])
def test_cal_lpips_matches_jax(weights, mask_ndim):
    """Masked, in batches of 2 over 3 images (the mean of the batches' means,
    as JAX's); the default path from $ESN_LPIPS_WEIGHTS."""
    a, b = _images(2)
    rng = np.random.default_rng(3)
    mask = (rng.uniform(size=a.shape[:3] + (1,)) < 0.8).astype(np.float32)
    if mask_ndim == 3:
        mask = mask[..., 0]
    ref = j_metrics.cal_lpips(a, b, mask)
    got = t_metrics.cal_lpips(a, b, mask)
    assert ref is not None and got is not None
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_metrics.cal_lpips(torch.from_numpy(a), torch.from_numpy(b),
                                                   torch.from_numpy(mask)), ref,
                               rtol=RTOL, atol=ATOL)


def test_absent_weights_give_none(tmp_path, monkeypatch):
    missing = str(tmp_path / "nope.npz")
    assert t_lp.lpips_fn(missing) is None
    monkeypatch.setenv("ESN_LPIPS_WEIGHTS", missing)
    assert t_lp.lpips_fn() is None
    a = np.zeros((1, 16, 16, 3), np.float32)
    assert t_metrics.cal_lpips(a, a, np.ones((1, 16, 16, 1), np.float32)) is None


@pytest.mark.parametrize("fault,match", [
    (lambda w: w.pop("lin2_w"), "schema mismatch"),
    (lambda w: w.__setitem__("conv0_w", np.transpose(w["conv0_w"], (3, 2, 0, 1))), "HWIO"),
    (lambda w: w.__setitem__("lin0_w", -w["lin0_w"]), "non-negative"),
    (lambda w: w.__setitem__("conv4_b", w["conv4_b"][:-1]), "out-channels"),
    (lambda w: w.__setitem__("lin1_w", w["lin1_w"][:-1]), "tap width"),
])
def test_corrupt_weights_raise_as_jax(weights, tmp_path, fault, match):
    _, raw = weights
    bad = dict(raw)
    fault(bad)
    path = str(tmp_path / "bad.npz")
    np.savez(path, **bad)
    with pytest.raises(ValueError, match=match):
        j_lp.lpips_fn(path)
    t_lp.lpips_fn.cache_clear()
    with pytest.raises(ValueError, match=match):
        t_lp.lpips_fn(path)
