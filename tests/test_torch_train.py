"""The train slice of the port held against the JAX package on the CPU.

Both packages start from one set of parameters (a JAX init bridged to torch)
and get the same random numbers: the test rebuilds the JAX train step's key
chain (``k_batch, k_loss = split(key)``; ``k_frame, k_pix = split(k_batch)``;
``k_z, k_neig = split(k_loss)``), draws the frame index, pixel uniforms, z
jitter and neighbour offsets from it as JAX does, and passes them to the port
as ``draws``. JAX runs at precision="highest" with its megakernel and
sampler kernel off (its plain path, which the port's autograd path mirrors).

A narrow spec (9 layers of width 64), a 12x16 synthetic scene and 32 rays
keep the JAX compiles to seconds. Tolerances are stated per test.
"""

import os
import os.path as osp
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from endosurf_tpu.data import scene_data as j_scene
from endosurf_tpu.kernels import fused_sampler as j_fs
from endosurf_tpu.models import endosurf as j_es
from endosurf_tpu.models import fields as j_fields
from endosurf_tpu.ops import mlp as j_mlp
from endosurf_tpu.ops import pdf as j_pdf
from endosurf_tpu.train import losses as j_losses
from endosurf_tpu.train import schedules as j_sched
from endosurf_tpu.train import trainer_endosurf as j_tr
from endosurf_tpu_torch.bridge import flatten, params_from_jax
from endosurf_tpu_torch.data import scene_data as t_scene
from endosurf_tpu_torch.models import endosurf as t_es
from endosurf_tpu_torch.models import fields as t_fields
from endosurf_tpu_torch.ops import pdf as t_pdf
from endosurf_tpu_torch.train import losses as t_losses
from endosurf_tpu_torch.train import schedules as t_sched
from endosurf_tpu_torch.train import trainer_endosurf as t_tr

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
H, W, B = 12, 16, 32
WEIGHTS = {"color_loss_weight": 1.0, "depth_loss_weight": 1.0, "sdf_loss_weight": 1.0,
           "angle_loss_weight": 0.1, "eikonal_loss_weight": 0.1,
           "surf_neig_loss_weight": 0.1}


def _narrow(mod):
    return mod.EndoSurfSpec(deform=mod.MLPSpec(9, 64, (4,), 3),
                            sdf=mod.MLPSpec(9, 64, (4,), 65),
                            color=mod.MLPSpec(9, 64, (4,), 3), color_feat_dim=64)


@pytest.fixture(autouse=True)
def _jax_plain_path():
    """JAX's plain (non-kernel) path at full precision, restored after."""
    j_fields.set_megakernel_mode("off")
    j_fs.set_sampler_kernel_mode("off")
    j_mlp.set_matmul_precision("highest")
    j_mlp.set_sampling_precision(None)
    yield
    j_fields.set_megakernel_mode("auto")
    j_fs.set_sampler_kernel_mode("auto")


@pytest.fixture(scope="module")
def scenes():
    return (j_scene.make_synthetic_arrays(4, H, W, seed=0),
            t_scene.make_synthetic_arrays(4, H, W, seed=0))


@pytest.fixture(scope="module")
def params_j():
    return j_fields.init_endosurf_params(jax.random.PRNGKey(0), _narrow(j_fields))


def _torch_params(pj):
    pt = params_from_jax(pj)
    for v in flatten(pt).values():
        v.requires_grad_(True)
    return pt


def jax_draws(key, n_train: int, ray_batch: int):
    """The train step's draws, from JAX's key chain, as torch tensors."""
    k_batch, k_loss = jax.random.split(key)
    k_frame, k_pix = jax.random.split(k_batch)
    k_z, k_neig = jax.random.split(k_loss)

    def t(x):
        return torch.from_numpy(np.array(x))
    return {"frame": t(jax.random.randint(k_frame, (), 0, n_train)),
            "u_pix": t(jax.random.uniform(k_pix, (ray_batch,))),
            "z": t(jax.random.uniform(k_z, (ray_batch, 1))),
            "neig": t(jax.random.uniform(k_neig, (ray_batch, 3)))}


def _grad_rel_l2(got, ref):
    return (np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


# ---------------------------------------------------------------------------
# pixel and z sampling
# ---------------------------------------------------------------------------

def alias_draws(key, n_train: int, ray_batch: int):
    """The alias sampler's batch draws from JAX's key chain (frame, then the
    bins j and uniforms u of ``split(k_pix)``), as torch tensors."""
    k_frame, k_pix = jax.random.split(jax.random.split(key)[0])
    k_j, k_u = jax.random.split(k_pix)

    def t(x):
        return torch.from_numpy(np.array(x))
    return {"frame": t(jax.random.randint(k_frame, (), 0, n_train)),
            "j_pix": t(jax.random.randint(k_j, (ray_batch,), 0, H * W)),
            "u_pix": t(jax.random.uniform(k_u, (ray_batch,)))}


def _assert_batch_equal(got, ref):
    assert int(got["frame_id"]) == int(ref["frame_id"])
    np.testing.assert_allclose(got["rays"].numpy(), np.asarray(ref["rays"]), atol=1e-6)
    for k in ("color", "depth", "mask", "color_mask", "depth_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_training_arrays_and_batch_match_jax(scenes):
    """The pixel weights and CDFs are JAX's; a batch from given draws is the
    batch JAX draws from the key (exact gathers, rays to 1e-6), for the cdf
    and the alias sampler. The alias tables are built only when the alias
    sampler asks, and then equal JAX's bit for bit."""
    sj, _ = scenes
    st = t_scene.make_synthetic_arrays(4, H, W, seed=0)
    for k in ("sample_w", "uniform_w", "sample_cdf", "uniform_cdf", "list_train"):
        np.testing.assert_array_equal(st.device_arrays[k].numpy(),
                                      np.asarray(sj.device_arrays[k]), err_msg=k)
    key = jax.random.PRNGKey(3)
    for mask_guided in (True, False):
        ref = j_scene.sample_train_batch(sj.device_arrays, H, W, jax.random.split(key)[0], B,
                                         mask_guided=mask_guided)
        d = jax_draws(key, len(st.list_train), B)
        _assert_batch_equal(t_scene.sample_train_batch(st.device_arrays, H, W, B, mask_guided,
                                                       frame_draw=d["frame"], u_pix=d["u_pix"]),
                            ref)
    assert "sample_alias_prob" not in st.device_arrays
    for mask_guided, kind in ((True, "sample"), (False, "uniform")):
        ref = j_scene.sample_train_batch(sj.device_arrays, H, W, jax.random.split(key)[0], B,
                                         mask_guided=mask_guided, pixel_sampler="alias")
        d = alias_draws(key, len(st.list_train), B)
        _assert_batch_equal(t_scene.sample_train_batch(
            st.device_arrays, H, W, B, mask_guided, "alias", frame_draw=d["frame"],
            u_pix=d["u_pix"], j_pix=d["j_pix"]), ref)
        for part in ("prob", "idx"):
            np.testing.assert_array_equal(st.device_arrays[f"{kind}_alias_{part}"].numpy(),
                                          np.asarray(sj.device_arrays[f"{kind}_alias_{part}"]))


def test_pdf_samplers_match_jax(rng):
    """sample_from_cdf / inverse_cdf_sample (searchsorted side="left") and the
    random sample_pdf branch at the same uniforms: exact indices, z to 1e-6."""
    key = jax.random.PRNGKey(5)
    w = rng.uniform(0, 1, 500).astype(np.float32) * (rng.uniform(size=500) > 0.3)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (64,))))
    idx_j = np.asarray(j_pdf.inverse_cdf_sample(jnp.asarray(w), 64, key))
    idx_t = t_pdf.inverse_cdf_sample(torch.from_numpy(w), 64, u=u)
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    cdf = np.cumsum(w + 1e-12).astype(np.float32)
    cdf /= cdf[-1]
    np.testing.assert_array_equal(
        t_pdf.sample_from_cdf(torch.from_numpy(cdf), 64, u=u).numpy(),
        np.asarray(j_pdf.sample_from_cdf(jnp.asarray(cdf), 64, key)))
    bins = np.sort(rng.uniform(0, 2, (8, 17)), -1).astype(np.float32)
    wts = rng.uniform(0, 1, (8, 16)).astype(np.float32)
    uu = torch.from_numpy(np.array(jax.random.uniform(key, (8, 5))))
    np.testing.assert_allclose(
        t_pdf.sample_pdf(torch.from_numpy(bins), torch.from_numpy(wts), 5, u=uu).numpy(),
        np.asarray(j_pdf.sample_pdf(jnp.asarray(bins), jnp.asarray(wts), 5, key=key)),
        atol=1e-6)
    g = torch.Generator().manual_seed(0)
    bins_t = torch.from_numpy(bins)
    draw = t_pdf.sample_pdf(bins_t, torch.from_numpy(wts), 5, generator=g)
    assert draw.shape == (8, 5)
    assert bool(((draw >= bins_t[:, :1]) & (draw <= bins_t[:, -1:])).all())


def _train_rays(scenes, key):
    sj, st = scenes
    d = jax_draws(key, len(st.list_train), B)
    batch = t_scene.sample_train_batch(st.device_arrays, H, W, B, frame_draw=d["frame"],
                                       u_pix=d["u_pix"])
    return batch, d


def test_render_rays_with_jitter_matches_jax(scenes, params_j):
    """render_rays with the per-ray z jitter and return_upsample, float32:
    maps, Eikonal term and the upsample (z, sdf) within 1e-4 on all rays but
    one in 32 (a draw on a bin edge), the Eikonal term within 1e-5."""
    key = jax.random.PRNGKey(11)
    batch, d = _train_rays(scenes, key)
    rays = batch["rays"]
    k_z = jax.random.split(jax.random.split(key)[1])[0]
    out_j = jax.jit(lambda p, r: j_es.render_rays(
        _narrow(j_fields), j_es.RenderSpec(anneal_end=50.0), p, r, jnp.asarray(20.0),
        key=k_z, return_upsample=True))(params_j, jnp.asarray(rays.numpy()))
    out_t = t_es.render_rays(_narrow(t_fields), t_es.RenderSpec(anneal_end=50.0),
                             params_from_jax(params_j), rays, 20.0, z_uniform=d["z"],
                             return_upsample=True)
    for k in ("color_map", "depth_map", "weights", "up_z", "up_sdf"):
        err = np.abs(out_t[k].detach().numpy() - np.asarray(out_j[k])).reshape(B, -1).max(-1)
        assert (err > 1e-4).mean() <= 1 / 32 and err.max() < 5e-3, (k, np.sort(err)[-3:])
    np.testing.assert_allclose(float(out_t["gradient_o_error"]),
                               float(out_j["gradient_o_error"]), atol=1e-5)


# ---------------------------------------------------------------------------
# fields: outputs and parameter gradients (first and second order)
# ---------------------------------------------------------------------------

def _points(rng, n=128):
    x = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return x, d, rng.uniform(0, 1, (n, 1)).astype(np.float32)


def _assert_grads_close(pt, gj, tol):
    """Per leaf relative L2 within ``tol``; a leaf autograd did not reach
    (None) must be zero in JAX too."""
    gj = flatten(gj)
    for k, v in flatten(pt).items():
        got = np.zeros_like(v.detach().numpy()) if v.grad is None else v.grad.numpy()
        if v.grad is None:
            np.testing.assert_array_equal(np.asarray(gj[k]), got, err_msg=k)
            continue
        rel = _grad_rel_l2(got, np.asarray(gj[k]))
        assert rel <= tol, (k, rel)


OUTPUTS = ("sdf", "color", "grad_o")


def _weighted(out, which, w):
    v = out[which]
    return (v * (w if v.ndim == 2 else w[:, 0])).sum()


@pytest.fixture(scope="module")
def point_case(params_j):
    """Points, weights and JAX's outputs and parameter gradients of a
    weighted sum of each output (one jitted program)."""
    x, d, t = _points(np.random.default_rng(0))
    wgt = np.random.default_rng(1).normal(size=(x.shape[0], 3)).astype(np.float32)
    spec_j = _narrow(j_fields)
    j_mlp.set_matmul_precision("highest")

    def out_fn(p):
        return j_fields.fused_point_eval(spec_j, p, jnp.asarray(x), jnp.asarray(d), jnp.asarray(t))

    grads = jax.jit(lambda p: {w: jax.grad(lambda q: _weighted(out_fn(q), w, jnp.asarray(wgt)))(p)
                               for w in OUTPUTS})(params_j)
    return (x, d, t, wgt), jax.jit(out_fn)(params_j), grads


@pytest.mark.parametrize("which", OUTPUTS)
def test_fused_point_eval_and_param_grads_match_jax(params_j, point_case, which):
    """fused_point_eval outputs (1e-5) and the parameter gradients of a
    weighted sum of one output, per leaf within 1e-4 relative L2 (read: 1.5e-5
    at most); the grad_o case is the Eikonal term's second-order gradient."""
    (x, d, t, wgt), out_j, grads_j = point_case
    pt = _torch_params(params_j)
    out_t = t_fields.fused_point_eval(_narrow(t_fields), pt, torch.from_numpy(x),
                                      torch.from_numpy(d), torch.from_numpy(t))
    for k in ("sdf", "color", "grad_o", "grad_c"):
        np.testing.assert_allclose(out_t[k].detach().numpy(), np.asarray(out_j[k]), atol=1e-5,
                                   err_msg=k)
    _weighted(out_t, which, torch.from_numpy(wgt)).backward()
    _assert_grads_close(pt, grads_j[which], 1e-4)


def test_sdf_grad_observed_is_second_order(rng, params_j):
    """sdf_grad_observed (1e-5) and the parameter gradient of a function of
    it (per leaf 1e-4 relative L2); without grad mode it builds no graph."""
    x, _, t = _points(rng)
    wgt = rng.normal(size=(x.shape[0], 3)).astype(np.float32)
    spec_j, spec_t = _narrow(j_fields), _narrow(t_fields)
    g_j = jax.jit(lambda p: j_fields.sdf_grad_observed(spec_j, p, jnp.asarray(x),
                                                       jnp.asarray(t)))(params_j)
    pt = _torch_params(params_j)
    g_t = t_fields.sdf_grad_observed(spec_t, pt, torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(g_t.detach().numpy(), np.asarray(g_j), atol=1e-5)
    (g_t * torch.from_numpy(wgt)).sum().backward()
    _assert_grads_close(pt, jax.jit(jax.grad(lambda p: jnp.sum(j_fields.sdf_grad_observed(
        spec_j, p, jnp.asarray(x), jnp.asarray(t)) * wgt)))(params_j), 1e-4)
    with torch.no_grad():
        g = t_fields.sdf_grad_observed(spec_t, pt, torch.from_numpy(x), torch.from_numpy(t))
    assert not g.requires_grad


def test_aux_losses_match_jax(scenes, params_j):
    """error_on_depth (with its unmasked relu-cos quirk), surface_from_samples
    on the render's own samples, and surface_neighbour_error with the same
    offsets, on those samples and by the sphere trace, float32: values
    within 1e-5, depths within 1e-5, same valid rays."""
    key = jax.random.PRNGKey(13)
    batch, d = _train_rays(scenes, key)
    rays, depth, mask = batch["rays"], batch["depth"], batch["mask"]
    spec_j, spec_t = _narrow(j_fields), _narrow(t_fields)
    pt = params_from_jax(params_j)
    rj = jnp.asarray(rays.numpy())
    got = t_es.error_on_depth(spec_t, pt, rays, depth, mask)
    ref = jax.jit(lambda p: j_es.error_on_depth(spec_j, p, rj, jnp.asarray(depth.numpy()),
                                                jnp.asarray(mask.numpy())))(params_j)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), atol=1e-5)

    z, sdf = t_es.upsample_z(spec_t, t_es.RenderSpec(), pt, *(
        a for i, a in enumerate(t_es._split_rays(rays)) if i != 1), t_es._stratified_z(
        *t_es.ray_sphere_intersection(rays[:, :3], rays[:, 3:6])[:2], 32, d["z"]),
        return_sdf=True)
    dep_t, val_t = t_es.surface_from_samples(spec_t, pt, rays, z, sdf)
    dep_j, val_j = jax.jit(lambda p: j_es.surface_from_samples(
        spec_j, p, rj, jnp.asarray(z.numpy()), jnp.asarray(sdf.numpy())))(params_j)
    np.testing.assert_array_equal(val_t.numpy(), np.asarray(val_j))
    assert val_t.sum() > 0
    np.testing.assert_allclose(dep_t.numpy(), np.asarray(dep_j), atol=1e-5)

    k_neig = jax.random.split(jax.random.split(key)[1])[1]
    err_t = t_es.surface_neighbour_error(spec_t, pt, rays, mask, 0.1, samples=(z, sdf),
                                         offset_uniform=d["neig"])
    err_j = jax.jit(lambda p: j_es.surface_neighbour_error(
        spec_j, p, rj, jnp.asarray(mask.numpy()), k_neig, 0.1,
        samples=(jnp.asarray(z.numpy()), jnp.asarray(sdf.numpy()))))(params_j)
    np.testing.assert_allclose(float(err_t.detach()), float(err_j), atol=1e-5)
    err_t = t_es.surface_neighbour_error(spec_t, pt, rays, mask, 0.1, offset_uniform=d["neig"])
    err_j = jax.jit(lambda p: j_es.surface_neighbour_error(
        spec_j, p, rj, jnp.asarray(mask.numpy()), k_neig, 0.1))(params_j)
    np.testing.assert_allclose(float(err_t.detach()), float(err_j), atol=1e-5)


def test_loss_terms_and_schedule_match_jax(rng):
    """endosurf_loss_terms on random inputs (1e-6 relative) and warmup_cosine
    over warmup, decay and the floor (1e-6 relative)."""
    n = 64
    out = {"color_map": rng.uniform(0, 1, (n, 3)), "depth_map": rng.uniform(1, 2, (n, 1)),
           "gradient_o_error": np.float32(0.3), "s_val": np.full((n, 1), 0.05),
           "cdf": rng.uniform(0, 1, (n, 64)), "weight_max": rng.uniform(0, 1, (n, 1))}
    batch = {"color": rng.uniform(0, 1, (n, 3)), "depth": rng.uniform(1, 2, (n, 1)),
             "mask": (rng.uniform(size=(n, 1)) > 0.3), "color_mask": np.ones((n, 1))}
    valid = (rng.uniform(size=(n, 1)) > 0.2)
    errs = (0.2, 0.4, 0.05)

    def as_(lib, tree):
        conv = (lambda a: jnp.asarray(a, jnp.float32)) if lib == "jax" else (
            lambda a: torch.as_tensor(np.asarray(a, np.float32)))
        return {k: conv(v) for k, v in tree.items()}
    tot_j, m_j = j_losses.endosurf_loss_terms(as_("jax", out), *map(jnp.float32, errs[:2]),
                                              jnp.asarray(valid, jnp.float32),
                                              jnp.float32(errs[2]), as_("jax", batch), WEIGHTS)
    tot_t, m_t = t_losses.endosurf_loss_terms(as_("t", out), *map(torch.tensor, errs[:2]),
                                              torch.as_tensor(valid, dtype=torch.float32),
                                              torch.tensor(errs[2]), as_("t", batch), WEIGHTS)
    assert set(m_t) == set(m_j)
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-6, err_msg=k)
    sj, st = j_sched.warmup_cosine(5e-4, 50, 400, 0.05), t_sched.warmup_cosine(5e-4, 50, 400, 0.05)
    for c in (0, 1, 25, 48, 49, 50, 200, 398, 399, 500):
        np.testing.assert_allclose(st(c), float(sj(c)), rtol=1e-6, err_msg=str(c))


def test_adam_matches_optax(rng):
    """The port's optimizer (two Adam groups, lr set from the schedule before
    each update) against optax.adam on the same given gradients, three
    updates: parameters within 1e-6 of each other."""
    params = {"deform_network": {"layers": [{"v": rng.normal(size=(4, 3))}]},
              "sdf_network": {"layers": [{"v": rng.normal(size=(5, 2)), "b": rng.normal(size=2)}]}}
    grads = [jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape) * 1e-3, params)
             for _ in range(3)]
    sched_j, sched_t = j_sched.warmup_cosine(1e-2, 2, 10, 0.05), t_sched.warmup_cosine(1e-2, 2, 10, 0.05)
    tx = optax.adam(sched_j)
    pj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), params)
    state = tx.init(pj)
    pt = params_from_jax(params)
    opt = t_tr.make_optimizer(pt, 1.0)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), g),
                               state, pj)
        pj = optax.apply_updates(pj, upd)
        for k, v in flatten(pt).items():
            v.grad = torch.as_tensor(np.asarray(flatten(g)[k], np.float32))
        lr = sched_t(t_tr.adam_count(opt))
        for group in opt.param_groups:
            group["lr"] = lr * group["lr_mult"]
        opt.step()
    assert t_tr.adam_count(opt) == 3
    for k, v in flatten(pt).items():
        np.testing.assert_allclose(v.numpy(), np.asarray(flatten(pj)[k]), atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the whole train step
# ---------------------------------------------------------------------------

def _grab_grads_tx():
    """A GradientTransformation whose new state is the gradient (zero
    update), so JAX's jitted step hands its gradients back."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def test_train_step_matches_jax(scenes, params_j):
    """One step of the port (autograd path, plain upsampling on the CPU)
    against JAX's make_train_step (megakernel and sampler kernel off), same
    params and draws, float32. Every metric within 2e-5 relative (read:
    2.7e-6). Every parameter gradient within a relative L2 per leaf of 1e-3
    (read: 6.1e-5, deform net), 1e-2 for the colour net's leaves (read:
    2.0e-3 on color_network/layers/7/g): its gradients are sums with
    cancellation over the batch, and JAX's own eager and jitted gradients of
    the colour loss on such a batch differ by up to 3.4e-3 in max norm."""
    sj, st = scenes
    key = jax.random.PRNGKey(7)
    tx = _grab_grads_tx()
    step = j_tr.make_train_step(_narrow(j_fields), j_es.RenderSpec(anneal_end=50.0), tx, H, W,
                                B, WEIGHTS, 0.1)
    _, grads_j, metrics_j = step(jax.tree_util.tree_map(jnp.array, params_j),
                                 tx.init(params_j), sj.device_arrays, key, jnp.asarray(20.0))
    pt = _torch_params(params_j)
    loss_fn = t_tr.make_loss_fn(_narrow(t_fields), t_es.RenderSpec(anneal_end=50.0), H, W, B,
                                WEIGHTS, 0.1)
    total, metrics_t = loss_fn(pt, st.device_arrays, 20.0, None,
                               jax_draws(key, len(st.list_train), B))
    total.backward()
    assert set(metrics_t) == set(metrics_j)
    for k in metrics_j:
        np.testing.assert_allclose(float(metrics_t[k].detach()), float(metrics_j[k]),
                                   rtol=2e-5, atol=1e-7, err_msg=k)
    gj = flatten(grads_j)
    for k, v in flatten(pt).items():
        rel = _grad_rel_l2(v.grad.numpy(), np.asarray(gj[k]))
        assert rel <= (1e-2 if k.startswith("color_network") else 1e-3), (k, rel)


def test_bf16_loss_track(scenes, params_j):
    """Three Adam steps at "default" precision against JAX's make_train_step
    at matmul_precision "default" with activation_dtype float32 (the JAX
    setting closest to the port's: float32 storage, the jacfwd Jacobian).
    On the CPU JAX's DEFAULT dot is float32, so the JAX track is the float32
    math; the port's bf16 track (bf16 operands, float32 accumulation) must
    stay within 5e-3 relative of it (read: 1.6e-3), the port's float32 track
    within 1e-4 (read: 8.2e-6), and, as the control, the bf16 track must miss
    the float32 limit (the rounding is on)."""
    sj, st = scenes
    j_mlp.set_matmul_precision("default")
    j_mlp.set_activation_dtype("float32")
    sched = (5e-3, 2, 10, 0.05)
    tx = optax.adam(j_sched.warmup_cosine(*sched))
    step_j = j_tr.make_train_step(_narrow(j_fields), j_es.RenderSpec(anneal_end=50.0), tx, H, W,
                                  B, WEIGHTS, 0.1)
    keys = [jax.random.PRNGKey(100 + i) for i in range(3)]
    p, s, track_j = jax.tree_util.tree_map(jnp.array, params_j), tx.init(params_j), []
    for i, k in enumerate(keys):
        p, s, m = step_j(p, s, sj.device_arrays, k, jnp.asarray(float(i + 1)))
        track_j.append(float(m["loss_total"]))

    def track_t(precision):
        pt = _torch_params(params_j)
        opt = t_tr.make_optimizer(pt, 1.0)
        step = t_tr.make_train_step(_narrow(t_fields), t_es.RenderSpec(anneal_end=50.0), H, W, B,
                                    WEIGHTS, 0.1, schedule=t_sched.warmup_cosine(*sched),
                                    precision=precision)
        return [float(step(pt, opt, st.device_arrays, None, float(i + 1),
                           jax_draws(k, len(st.list_train), B))["loss_total"])
                for i, k in enumerate(keys)]
    rel_bf16 = np.abs(np.array(track_t("default")) - track_j) / np.abs(track_j)
    rel_f32 = np.abs(np.array(track_t("highest")) - track_j) / np.abs(track_j)
    assert rel_bf16.max() <= 5e-3, rel_bf16
    assert rel_f32.max() <= 1e-4, rel_f32
    assert rel_bf16.max() > 1e-4, rel_bf16


# ---------------------------------------------------------------------------
# the trainer, its loop and the CLI
# ---------------------------------------------------------------------------

def _tiny_cfg(exp_dir, n_iter=4):
    return {
        "exp": {"project_name": "p", "exp_name": "e", "exp_dir": str(exp_dir), "seed": 0},
        "render": {"type": "endosurf", "anneal_end": 50, "n_samples": 16, "n_importance": 16,
                   "up_sample_steps": 2},
        "train": {"n_iter": n_iter, "ray_batch": 16, "matmul_precision": "highest",
                  "sampling_precision": "highest", **WEIGHTS, "surf_neig_rad": 0.1,
                  "optim": {"lr": 5e-4, "warm_up_end": 2}, "eval": {"ray_chunk": 96}},
        "net": {"deform_network": {"n_layers": 9, "hidden_dim": 32, "skips": [4],
                                   "out_dim": 3, "enc_pos_cfg": {"multires": 2},
                                   "enc_time_cfg": {"multires": 2}},
                "sdf_network": {"n_layers": 9, "hidden_dim": 32, "skips": [4], "out_dim": 17,
                                "enc_pos_cfg": {"multires": 2}},
                "color_network": {"n_layers": 9, "hidden_dim": 32, "skips": [4],
                                  "feat_dim": 16, "out_dim": 3,
                                  "enc_pos_cfg": {"multires": 2},
                                  "enc_dir_cfg": {"multires": 2}}},
        "log": {"i_eval": 3, "i_save": 2},
        "demo": {"ray_batch": 96},
    }


def test_trainer_loop_cadence_and_resume(tmp_path, scenes):
    """Eval before step 1 and the i_eval multiples, saves at the i_save
    multiples and the end, a pause with stop_after, then resume."""
    _, st = scenes
    from endosurf_tpu_torch.train.checkpoint import load_checkpoint
    cfg = _tiny_cfg(tmp_path, n_iter=4)
    tr = t_tr.EndoSurfTrainer(cfg, scene=st, device="cpu")
    evals = []
    tr.eval = lambda step: evals.append(step) or {}
    tr.start(log_every=1, stop_after=3)
    assert evals == [1, 3] and tr.step_start == 4
    assert load_checkpoint(tr.exp_dir)["n_iter"] == 3
    assert osp.exists(osp.join(tr.exp_dir, "ckpt_backup.pt"))      # step 2's
    assert osp.exists(osp.join(tr.exp_dir, "cfg.yml"))

    cfg["train"]["resume"] = True
    tr2 = t_tr.EndoSurfTrainer(cfg, scene=st, device="cpu")
    assert tr2.step_start == 4 and t_tr.adam_count(tr2.optimizer) == 3
    for k, v in flatten(tr2.params).items():
        torch.testing.assert_close(v.detach(), flatten(tr.params)[k].detach(), rtol=0, atol=0)
    evals2 = []
    tr2.eval = lambda step: evals2.append(step) or {}
    tr2.start(log_every=1)
    assert evals2 == [4] and load_checkpoint(tr2.exp_dir)["n_iter"] == 4
    with open(osp.join(tr2.exp_dir, "logs", "metrics.jsonl")) as f:
        steps = sorted({int(line.split('"step": ')[1].split(",")[0]) for line in f})
    assert steps == [1, 2, 3, 4]


@pytest.mark.parametrize("key, value", [("fold_aux_queries", True),
                                        ("pixel_sampler", "alias"),
                                        ("sampler_kernel", "off")])
def test_unported_train_options_raise(tmp_path, key, value):
    """``sampler_kernel: off`` is not ported and raises; the options ported
    since (``fold_aux_queries``, the alias pixel sampler) build a trainer
    that takes a CPU step with finite metrics."""
    st = t_scene.make_synthetic_arrays(4, H, W, seed=0)
    cfg = _tiny_cfg(tmp_path)
    cfg["train"][key] = value
    if (key, value) == ("sampler_kernel", "off"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            t_tr.EndoSurfTrainer(cfg, scene=st, device="cpu")
        return
    tr = t_tr.EndoSurfTrainer(cfg, scene=st, device="cpu")
    metrics = tr.train_step(1)
    assert t_tr.adam_count(tr.optimizer) == 1
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics


def _run_cli(args):
    env = {**os.environ, "PYTHONPATH": REPO}
    return subprocess.run([sys.executable, "-m", "endosurf_tpu_torch", *args],
                          capture_output=True, text=True, cwd=REPO, timeout=600, env=env)


def test_cli_train_then_test_2d_on_cpu(tmp_path):
    """python -m endosurf_tpu_torch --mode train --device cpu on a tiny scene
    from an info pkl writes a checkpoint; --mode test_2d then serves it."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from endosurf_tpu.data.scene_data import make_synthetic_scene\n"
            "print(make_synthetic_scene(%r, n_frames=4, h=12, w=16))\n") % (REPO, str(tmp_path / "s"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    cfg = _tiny_cfg(tmp_path / "logs", n_iter=3)
    cfg["data"] = {"info_dir": proc.stdout.strip().splitlines()[-1]}
    cfg["log"] = {"i_eval": 0, "i_save": 3}
    from endosurf_tpu_torch.config import save_config
    save_config(cfg, str(tmp_path / "cfg.yml"))
    proc = _run_cli(["--cfg", str(tmp_path / "cfg.yml"), "--mode", "train", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SAVE|iter:3/3" in proc.stdout and "Training complete!" in proc.stdout
    exp = tmp_path / "logs" / "p" / "e-synthetic-pulsating_sphere"
    assert (exp / "ckpt.pt").exists()
    proc = _run_cli(["--cfg", str(tmp_path / "cfg.yml"), "--mode", "test_2d", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PARAMS|checkpoint of iter 3" in proc.stdout
    assert (exp / "demo" / "iter_00000003" / "test_2d" / "stats_out.txt").exists()
