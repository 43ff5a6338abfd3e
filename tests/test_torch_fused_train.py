"""The field megakernel's segments (``kernels/fused_train.py``: SegDeform,
SegSdf, SegColor, megakernel_point_eval) held against the JAX package on the
CPU, where they run their plain versions.

* Each segment's forward and backward against JAX's jnp segments
  (``fused_train._build_segments``), one through the Pallas kernels in
  interpret mode, as JAX's own tests run them; the whole chain with and
  without the deform net.
* The Function path (``megakernel: on``) against the autograd path
  (``off``) on the same points.
* One train step with ``megakernel: on`` against JAX's trainer with
  ``megakernel: "on"`` (on the CPU its jnp segments).

Params are bridged from a JAX init, inputs drawn from numpy seeds; JAX runs at
precision "highest". Tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endosurf_tpu.kernels import fused_sampler as j_fs
from endosurf_tpu.kernels import fused_train as j_ft
from endosurf_tpu.models import endosurf as j_es
from endosurf_tpu.models import fields as j_fields
from endosurf_tpu.ops import mlp as j_mlp
from endosurf_tpu.train import trainer_endosurf as j_tr
from endosurf_tpu_torch.bridge import flatten, params_from_jax
from endosurf_tpu_torch.kernels import fused_train as t_ft
from endosurf_tpu_torch.models import endosurf as t_es
from endosurf_tpu_torch.models import fields as t_fields
from endosurf_tpu_torch.train import trainer_endosurf as t_tr
from tests.test_torch_train import (
    B,
    H,
    WEIGHTS,
    W,
    _grab_grads_tx,
    _grad_rel_l2,
    _narrow,
    _tiny_cfg,
    jax_draws,
)

N = 150      # no tile of the kernels or of the Pallas grid is full


def _small(mod, use_deform=True):
    """The narrow spec of tests/test_fused_train_pallas.py."""
    return mod.EndoSurfSpec(use_deform=use_deform, deform=mod.MLPSpec(3, 64, (1,), 3),
                            sdf=mod.MLPSpec(3, 64, (1,), 33), color=mod.MLPSpec(2, 64, (), 3),
                            color_feat_dim=32)


@pytest.fixture(autouse=True)
def _jax_modes():
    """JAX at full precision, its kernels off unless a test forces them."""
    j_mlp.set_matmul_precision("highest")
    j_mlp.set_sampling_precision(None)
    j_ft.set_compute_mode(jnp.float32, "highest")
    yield
    j_ft.set_force_kernel(False)
    j_fields.set_megakernel_mode("auto")
    j_fs.set_sampler_kernel_mode("auto")


def _params(use_deform=True):
    pj = j_fields.init_endosurf_params(jax.random.PRNGKey(0), _small(j_fields, use_deform))
    pt = params_from_jax(pj)
    for v in flatten(pt).values():
        v.requires_grad_(True)
    return pj, pt


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.8, 0.8, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return x, d, rng.uniform(0, 1, (N, 1)).astype(np.float32)


def _cot(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _check_grads(pt, gj, nets, tol):
    """Per leaf of ``nets``: relative L2 of torch's .grad against JAX's."""
    gj = flatten(gj)
    for k, v in flatten(pt).items():
        if k.split("/")[0] in nets:
            rel = _grad_rel_l2(v.grad.numpy(), np.asarray(gj[k]))
            assert rel <= tol, (k, rel)


def _pad(a):
    return j_ft.pad_lanes(jnp.asarray(a))


def _case(seg, pj, pt, spec_j, spec_t):
    """(JAX loss of params and inputs, torch loss builder, input arrays, the
    names of the inputs that get cotangents) for one segment: a weighted sum
    of its outputs with seeded weights."""
    rng = np.random.default_rng(1)
    x, d, t = _inputs()
    eff_t = t_ft.prepare_effective(spec_t, pt)
    if seg == "deform":
        w_x, w_j = _cot(rng, N, 3), _cot(rng, N, 3, 3)
        seg_fn = j_ft._build_segments(spec_j)[0]

        def loss_j(p, _):
            x_c, jrows = seg_fn(j_ft.prepare_effective(spec_j, p)["deform"],
                                j_ft.pad_lanes(jnp.asarray(x), jnp.asarray(t)))
            return (jnp.sum(x_c[:, :3] * w_x)
                    + sum(jnp.sum(jrows[k][:, :3] * w_j[:, k]) for k in range(3)))

        def loss_t(_):
            xt = torch.from_numpy(np.concatenate([x, t], -1))
            x_c, jrows = t_ft.SegDeform.apply(spec_t, eff_t["deform"], "highest", xt,
                                              *t_ft.flatten_layers(eff_t["deform"]))
            return (x_c * torch.from_numpy(w_x)).sum() + (jrows * torch.from_numpy(w_j)).sum(), \
                {"x_c": x_c, "jrows": jrows}
        return loss_j, loss_t, [], {}
    if seg == "sdf":
        w_s, w_f, w_g = _cot(rng, N, 1), _cot(rng, N, 32), _cot(rng, N, 3)
        seg_fn = j_ft._build_segments(spec_j)[1]

        def loss_j(p, ins):
            eff = j_ft.prepare_effective(spec_j, p)
            sdf, feat, grad_c = seg_fn(eff["sdf"], eff["sdf_head"], eff["sdf_feat"], ins[0])
            return jnp.sum(sdf * w_s) + jnp.sum(feat * w_f) + jnp.sum(grad_c[:, :3] * w_g)

        def loss_t(ins):
            flat = t_ft.flatten_layers(eff_t["sdf"]) + [
                eff_t["sdf_head"]["w"], eff_t["sdf_head"]["b"], eff_t["sdf_feat"]["w"],
                eff_t["sdf_feat"]["b"]]
            sdf, feat, grad_c = t_ft.SegSdf.apply(spec_t, eff_t["sdf"], "highest", ins[0], *flat)
            return ((sdf * torch.from_numpy(w_s)).sum() + (feat * torch.from_numpy(w_f)).sum()
                    + (grad_c * torch.from_numpy(w_g)).sum()), \
                {"sdf": sdf, "feat": feat, "grad_c": grad_c}
        return loss_j, loss_t, [x], {"sdf": 1, "feat": 32, "grad_c": 3}
    w_c = _cot(rng, N, 3)
    feat = rng.normal(size=(N, 32)).astype(np.float32) * 0.3
    grad_c = rng.normal(size=(N, 3)).astype(np.float32)
    seg_fn = j_ft._build_segments(spec_j)[2]

    def loss_j(p, ins):
        return jnp.sum(seg_fn(j_ft.prepare_effective(spec_j, p)["color"], *ins)[:, :3] * w_c)

    def loss_t(ins):
        color = t_ft.SegColor.apply(spec_t, eff_t["color"], "highest", *ins,
                                    *t_ft.flatten_layers(eff_t["color"]))
        return (color * torch.from_numpy(w_c)).sum(), {"color": color}
    return loss_j, loss_t, [x, grad_c, d, feat], {"color": 3}


@pytest.mark.parametrize("seg, pallas", [("deform", False), ("sdf", False), ("sdf", True),
                                         ("color", False)],
                         ids=["deform", "sdf", "sdf-pallas-interpret", "color"])
def test_segment_matches_jax(seg, pallas):
    """A segment's outputs (1e-5) and, for a weighted sum of them, the
    parameter gradients (per leaf 1e-4 relative L2) and the input cotangents
    (1e-4 relative L2) against JAX's segment: its jnp path, or its Pallas
    kernels in interpret mode."""
    spec_j, spec_t = _small(j_fields), _small(t_fields)
    pj, pt = _params()
    loss_j, loss_t, ins, widths = _case(seg, pj, pt, spec_j, spec_t)
    ins_t = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    total, outs = loss_t(ins_t)
    total.backward()
    ins_j = [_pad(a) if a.shape[1] == 3 else jnp.asarray(a) for a in ins]
    j_ft.set_force_kernel(pallas)
    g_params, g_ins = jax.grad(loss_j, argnums=(0, 1))(pj, ins_j)
    seg_fn = j_ft._build_segments(spec_j)
    eff = j_ft.prepare_effective(spec_j, pj)
    if seg == "deform":
        x, _, t = _inputs()
        xc, jrows = seg_fn[0](eff["deform"], j_ft.pad_lanes(jnp.asarray(x), jnp.asarray(t)))
        ref = {"x_c": xc[:, :3], "jrows": jnp.stack([j[:, :3] for j in jrows], 1)}
    elif seg == "sdf":
        sdf, feat, grad_c = seg_fn[1](eff["sdf"], eff["sdf_head"], eff["sdf_feat"], ins_j[0])
        ref = {"sdf": sdf, "feat": feat, "grad_c": grad_c[:, :3]}
    else:
        ref = {"color": seg_fn[2](eff["color"], *ins_j)[:, :3]}
    j_ft.set_force_kernel(False)
    for k, v in outs.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(ref[k]), atol=1e-5, err_msg=k)
    net = {"deform": "deform_network", "sdf": "sdf_network", "color": "color_network"}[seg]
    _check_grads(pt, g_params, (net,), 1e-4)
    for a, g in zip(ins_t, g_ins):
        got = a.grad.numpy()
        assert _grad_rel_l2(got, np.asarray(g)[:, :got.shape[1]]) <= 1e-4


def _chain_loss_j(spec, x, d, t, w):
    def loss(p):
        out = j_ft.megakernel_point_eval(spec, p, jnp.asarray(x), jnp.asarray(d), jnp.asarray(t))
        return (jnp.sum(out["sdf"] * w[:, 0]) + jnp.sum(out["color"] * w)
                + jnp.sum(out["grad_o"] * w))
    return loss


@pytest.mark.parametrize("use_deform", [True, False], ids=["deform", "static"])
def test_megakernel_point_eval_matches_jax(use_deform):
    """The whole chain (megakernel_point_eval, plain versions) against JAX's
    megakernel_point_eval on its jnp path: outputs within 1e-5, parameter
    gradients of a weighted sum of sdf, color and grad_o per leaf within 1e-4
    relative L2; with the deform net and without it (x_c = x, identity
    rows)."""
    spec_j, spec_t = _small(j_fields, use_deform), _small(t_fields, use_deform)
    pj, pt = _params(use_deform)
    x, d, t = _inputs(2)
    w = np.random.default_rng(3).normal(size=(N, 3)).astype(np.float32)
    out_j = j_ft.megakernel_point_eval(spec_j, pj, jnp.asarray(x), jnp.asarray(d),
                                       jnp.asarray(t))
    out_t = t_ft.megakernel_point_eval(spec_t, pt, torch.from_numpy(x), torch.from_numpy(d),
                                       torch.from_numpy(t))
    for k in ("sdf", "color", "grad_o", "grad_c"):
        np.testing.assert_allclose(out_t[k].detach().numpy(), np.asarray(out_j[k]), atol=1e-5,
                                   err_msg=k)
    wt = torch.from_numpy(w)
    ((out_t["sdf"] * wt[:, 0]).sum() + (out_t["color"] * wt).sum()
     + (out_t["grad_o"] * wt).sum()).backward()
    nets = ("deform_network", "sdf_network", "color_network")
    _check_grads(pt, jax.grad(_chain_loss_j(spec_j, x, d, t, w))(pj), nets, 1e-4)
    with pytest.raises(ValueError, match="no cotangents"):
        t_ft.megakernel_point_eval(spec_t, pt, torch.from_numpy(x).requires_grad_(True),
                                   torch.from_numpy(d), torch.from_numpy(t))


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("which", ["sdf", "color", "grad_o"])
def test_function_path_matches_autograd_path(which, precision):
    """fused_point_eval with megakernel "on" (the Functions, plain versions)
    against "off" (PR 2's autograd path) on a 9x64 spec: the same outputs
    (the same operations), and parameter gradients of a weighted sum of one
    output per leaf within 1e-5 relative L2 (sums taken in another order);
    the grad_o case is the Eikonal term's second order."""
    spec = _narrow(t_fields)
    pj = j_fields.init_endosurf_params(jax.random.PRNGKey(0), _narrow(j_fields))
    x, d, t = (torch.from_numpy(a) for a in _inputs(4))
    w = torch.from_numpy(np.random.default_rng(5).normal(size=(N, 3)).astype(np.float32))
    res = {}
    for mode in ("on", "off"):
        pt = params_from_jax(pj)
        for v in flatten(pt).values():
            v.requires_grad_(True)
        out = t_fields.fused_point_eval(spec, pt, x, d, t, precision, megakernel=mode)
        v = out[which]
        (v * (w if v.ndim == 2 else w[:, 0])).sum().backward()
        res[mode] = (out, {k: p.grad for k, p in flatten(pt).items() if p.grad is not None})
    (out_on, g_on), (out_off, g_off) = res["on"], res["off"]
    for k in out_off:
        torch.testing.assert_close(out_on[k].detach(), out_off[k].detach(), rtol=0, atol=1e-7)
    assert set(g_off) <= set(g_on)
    for k in g_on:      # the Functions return zeros where autograd returns None
        if k not in g_off:
            assert not bool(g_on[k].any()), k
            continue
        rel = float((g_on[k] - g_off[k]).norm() / max(float(g_off[k].norm()), 1e-30))
        assert rel <= 1e-5, (k, rel)


def test_train_step_megakernel_matches_jax():
    """One port step with megakernel "on" (the segments' plain versions)
    against JAX's make_train_step with megakernel "on" (its jnp segments on
    the CPU), same params and draws, float32, at test_train_step_matches_jax's
    limits: metrics within 2e-5 relative, parameter gradients per leaf within
    1e-3 relative L2 (1e-2 for the colour net's leaves)."""
    sj = __import__("endosurf_tpu.data.scene_data", fromlist=["x"]).make_synthetic_arrays(
        4, H, W, seed=0)
    st = __import__("endosurf_tpu_torch.data.scene_data", fromlist=["x"]).make_synthetic_arrays(
        4, H, W, seed=0)
    params_j = j_fields.init_endosurf_params(jax.random.PRNGKey(0), _narrow(j_fields))
    j_fields.set_megakernel_mode("on")
    j_fs.set_sampler_kernel_mode("off")
    key = jax.random.PRNGKey(7)
    tx = _grab_grads_tx()
    step = j_tr.make_train_step(_narrow(j_fields), j_es.RenderSpec(anneal_end=50.0), tx, H, W,
                                B, WEIGHTS, 0.1)
    _, grads_j, metrics_j = step(jax.tree_util.tree_map(jnp.array, params_j),
                                 tx.init(params_j), sj.device_arrays, key, jnp.asarray(20.0))
    pt = params_from_jax(params_j)
    for v in flatten(pt).values():
        v.requires_grad_(True)
    loss_fn = t_tr.make_loss_fn(_narrow(t_fields), t_es.RenderSpec(anneal_end=50.0), H, W, B,
                                WEIGHTS, 0.1, megakernel="on")
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


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_trainer_reads_megakernel(tmp_path, mode):
    """Every train.megakernel mode trains on the CPU (one step, finite loss);
    an unknown mode raises."""
    st = __import__("endosurf_tpu_torch.data.scene_data", fromlist=["x"]).make_synthetic_arrays(
        4, H, W, seed=0)
    cfg = _tiny_cfg(tmp_path)
    cfg["train"]["megakernel"] = mode
    tr = t_tr.EndoSurfTrainer(cfg, scene=st, device="cpu")
    assert tr.megakernel == mode
    assert np.isfinite(float(tr.train_step(1)["loss_total"]))
    cfg["train"]["megakernel"] = "sometimes"
    with pytest.raises(ValueError, match="megakernel"):
        t_tr.EndoSurfTrainer(cfg, scene=st, device="cpu")
