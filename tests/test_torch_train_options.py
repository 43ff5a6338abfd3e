"""The last train options of the port against the JAX package on the CPU:
``train.fold_aux_queries`` (the auxiliary field queries folded into the
render's field evaluation), the ``alias`` pixel sampler (``native.
alias_table``, ``ops.pdf.sample_from_alias`` and an alias train step) and
``SceneData.export_debug_geometry``.

Both sides start from one JAX init bridged to torch and get JAX's draws
(``test_torch_train.jax_draws`` / ``alias_draws``); JAX runs its plain path
at precision "highest" (the autouse fixture of ``test_torch_train``). Small
nets (4 layers of 32, no skip) and 16 + 16 samples keep JAX's compiles short.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endosurf_tpu.data import scene_data as j_scene
from endosurf_tpu.models import endosurf as j_es
from endosurf_tpu.models import fields as j_fields
from endosurf_tpu.native import alias_table as j_alias_table
from endosurf_tpu.ops import pdf as j_pdf
from endosurf_tpu.train import trainer_endosurf as j_tr
from endosurf_tpu_torch.bridge import flatten, params_from_jax
from endosurf_tpu_torch.data import scene_data as t_scene
from endosurf_tpu_torch.models import endosurf as t_es
from endosurf_tpu_torch.models import fields as t_fields
from endosurf_tpu_torch.native import alias_table as t_alias_table
from endosurf_tpu_torch.ops import pdf as t_pdf
from endosurf_tpu_torch.train import trainer_endosurf as t_tr

from test_torch_parallel import ES_RENDER, _small
from test_torch_train import (  # noqa: F401  (_jax_plain_path: autouse)
    B, H, W, WEIGHTS, _grab_grads_tx, _grad_rel_l2, _jax_plain_path, alias_draws, jax_draws)

# port against JAX, float32 (test_train_step_matches_jax's limits)
METRIC_TOL = 2e-5
GRAD_TOL = {"color_network": 1e-2, "other": 1e-3}


@pytest.fixture(scope="module")
def scenes():
    return (j_scene.make_synthetic_arrays(4, H, W, seed=0),
            t_scene.make_synthetic_arrays(4, H, W, seed=0))


@pytest.fixture(scope="module")
def params_j():
    return j_fields.init_endosurf_params(jax.random.PRNGKey(0), _small(j_fields))


def _torch_params(pj):
    pt = params_from_jax(pj)
    for v in flatten(pt).values():
        v.requires_grad_(True)
    return pt


def _jax_step(sj, params_j, key, **kwargs):
    """JAX's metrics and gradients of one make_train_step on ``key``."""
    tx = _grab_grads_tx()
    step = j_tr.make_train_step(_small(j_fields), j_es.RenderSpec(**ES_RENDER), tx, H, W, B,
                                WEIGHTS, 0.1, **kwargs)
    _, grads, metrics = step(jax.tree_util.tree_map(jnp.array, params_j), tx.init(params_j),
                             sj.device_arrays, key, jnp.asarray(20.0))
    return ({k: float(v) for k, v in metrics.items()},
            {k: np.asarray(v) for k, v in flatten(grads).items()})


def _port_step(st, params_j, draws, **kwargs):
    """The port's metrics and gradients of one loss evaluation on ``draws``."""
    pt = _torch_params(params_j)
    loss_fn = t_tr.make_loss_fn(_small(t_fields), t_es.RenderSpec(**ES_RENDER), H, W, B,
                                WEIGHTS, 0.1, **kwargs)
    total, metrics = loss_fn(pt, st.device_arrays, 20.0, None, draws)
    total.backward()
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.grad.numpy() for k, v in flatten(pt).items()})


def _errors(got, ref):
    (m_got, g_got), (m_ref, g_ref) = got, ref
    assert set(m_got) == set(m_ref)
    m_err = {k: abs(m_got[k] - m_ref[k]) / max(abs(m_ref[k]), 1e-7) for k in m_ref}
    g_err = {k: _grad_rel_l2(g_got[k], g_ref[k]) for k in g_ref}
    return m_err, g_err


def _within(m_err, g_err) -> bool:
    return (max(m_err.values()) <= METRIC_TOL
            and all(e <= GRAD_TOL["color_network" if k.startswith("color_network") else "other"]
                    for k, e in g_err.items()))


# ---------------------------------------------------------------------------
# fold_aux_queries
# ---------------------------------------------------------------------------

def test_fold_aux_step_matches_jax(scenes, params_j, monkeypatch):
    """One step with fold_aux_queries (the depth points and the sphere-traced
    surface and neighbour points appended to the render's field evaluation)
    against JAX's make_train_step(fold_aux=True) on the same draws, float32:
    metrics within 2e-5 relative, gradients per leaf within 1e-3 relative L2
    (1e-2 the colour net). The folded step also stays within those limits of
    the port's unfolded step with the sphere trace (surf_march_reuse off),
    and, as the planted fault, the folded rows taken one ray off miss them."""
    sj, st = scenes
    key = jax.random.PRNGKey(7)
    draws = jax_draws(key, len(st.list_train), B)
    ref = _jax_step(sj, params_j, key, fold_aux=True)
    folded = _port_step(st, params_j, draws, fold_aux=True)
    m_err, g_err = _errors(folded, ref)
    print(f"fold vs JAX: metrics {max(m_err.values()):.2e}, grads {max(g_err.values()):.2e}")
    assert _within(m_err, g_err), (m_err, g_err)

    m_err, g_err = _errors(folded, _port_step(st, params_j, draws, march_reuse=False))
    print(f"fold vs unfolded: metrics {max(m_err.values()):.2e}, "
          f"grads {max(g_err.values()):.2e}")
    assert _within(m_err, g_err), (m_err, g_err)

    split = t_tr.fold_split

    def off_by_one(extra_sdf, extra_grad, n_rays, need_depth_terms):
        return split(extra_sdf.roll(1, 0), extra_grad.roll(1, 0), n_rays, need_depth_terms)
    monkeypatch.setattr(t_tr, "fold_split", off_by_one)
    m_err, g_err = _errors(_port_step(st, params_j, draws, fold_aux=True), ref)
    print(f"fold, rows one ray off: metrics {max(m_err.values()):.2e}, "
          f"grads {max(g_err.values()):.2e}")
    assert not _within(m_err, g_err)


# ---------------------------------------------------------------------------
# the alias pixel sampler
# ---------------------------------------------------------------------------

def test_alias_table_and_draws_match_jax(rng):
    """native.alias_table on batched weights with zeros (and an all-zero row:
    the uniform table) equals JAX's bit for bit; sample_from_alias at JAX's
    j and u draws JAX's indices exactly; the draws follow the weights (total
    variation of 10^6 draws over 500 bins under 0.03; sampling noise alone
    gives about 0.01) and never hit a zero weight."""
    w = rng.uniform(0, 1, (3, 500)).astype(np.float32) * (rng.uniform(size=(3, 500)) > 0.3)
    w[2] = 0.0
    prob_j, alias_j = j_alias_table(w)
    prob_t, alias_t = t_alias_table(w)
    np.testing.assert_array_equal(prob_t, prob_j)
    np.testing.assert_array_equal(alias_t, alias_j)
    key = jax.random.PRNGKey(9)
    k_j, k_u = jax.random.split(key)
    n = 4096
    j = torch.from_numpy(np.array(jax.random.randint(k_j, (n,), 0, 500, dtype=jnp.int32)))
    u = torch.from_numpy(np.array(jax.random.uniform(k_u, (n,))))
    for i in range(3):
        ref = np.asarray(j_pdf.sample_from_alias(jnp.asarray(prob_j[i]), jnp.asarray(alias_j[i]),
                                                 n, key))
        got = t_pdf.sample_from_alias(torch.from_numpy(prob_t[i]), torch.from_numpy(alias_t[i]),
                                      j, u)
        np.testing.assert_array_equal(got.numpy(), ref)
    g = torch.Generator().manual_seed(0)
    m = 1_000_000
    idx = t_pdf.sample_from_alias(torch.from_numpy(prob_t[0]), torch.from_numpy(alias_t[0]),
                                  torch.randint(0, 500, (m,), generator=g),
                                  torch.rand(m, generator=g))
    freq = np.bincount(idx.numpy(), minlength=500) / m
    tv = 0.5 * np.abs(freq - w[0] / w[0].sum()).sum()
    print(f"total variation of {m} alias draws: {tv:.4f}")
    assert tv < 0.03
    assert freq[w[0] == 0].sum() == 0


def test_alias_train_step_matches_jax(scenes, params_j):
    """One step with pixel_sampler "alias" against JAX's make_train_step
    (pixel_sampler="alias") on the same draws, float32: metrics within 2e-5
    relative, gradients per leaf within 1e-3 relative L2 (1e-2 the colour
    net); the port's scene built its alias tables for the step."""
    sj, _ = scenes
    st = t_scene.make_synthetic_arrays(4, H, W, seed=0)
    key = jax.random.PRNGKey(11)
    draws = {**jax_draws(key, len(st.list_train), B), **alias_draws(key, len(st.list_train), B)}
    ref = _jax_step(sj, params_j, key, pixel_sampler="alias")
    got = _port_step(st, params_j, draws, pixel_sampler="alias")
    assert "sample_alias_prob" in st.device_arrays
    m_err, g_err = _errors(got, ref)
    print(f"alias step vs JAX: metrics {max(m_err.values()):.2e}, "
          f"grads {max(g_err.values()):.2e}")
    assert _within(m_err, g_err), (m_err, g_err)


# ---------------------------------------------------------------------------
# export_debug_geometry
# ---------------------------------------------------------------------------

def test_export_debug_geometry_matches_jax(scenes, tmp_path):
    """SceneData.export_debug_geometry writes JAX's three PLYs (point cloud,
    cameras, unit sphere) byte for byte."""
    sj, st = scenes
    sj.export_debug_geometry(str(tmp_path / "jax"), downsample=0.3)
    st.export_debug_geometry(str(tmp_path / "port"), downsample=0.3)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["cameras.ply", "pointcloud.ply", "unit_sphere.ply"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
