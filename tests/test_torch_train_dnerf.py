"""The EndoNeRF train step, trainer and CLI of the port held against the JAX
package on the CPU: one whole step (batch, ray slots 6/7, train render,
losses, Adam at the exponential learning rate) against JAX's
``make_train_step`` from bridged JAX parameters, a 3-step bf16 loss track,
the trainer's loop, checkpoint and resume, ``--mode train`` then
``--mode test_2d`` through the CLI, and the refused options.

Both sides get JAX's random numbers: the test rebuilds the step's key chain
(``k_batch, k_loss = split(key)``; ``k_frame, k_pix = split(k_batch)``;
``k_z, k_noise_c, k_noise_f = split(k_loss, 3)``) and passes the draws to
the port. JAX runs at precision "highest" on its plain path (on the CPU its
D-NeRF megakernel and sampler kernel stay off). Narrow nets (3 layers of
32), a 12x16 synthetic scene, 64 rays, 64 + 64 samples.
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
from endosurf_tpu.models import endonerf as j_en
from endosurf_tpu.ops import mlp as j_mlp
from endosurf_tpu.train import schedules as j_sched
from endosurf_tpu.train import trainer_endonerf as j_tr
from endosurf_tpu_torch.bridge import flatten, params_from_jax
from endosurf_tpu_torch.data import scene_data as t_scene
from endosurf_tpu_torch.models import endonerf as t_en
from endosurf_tpu_torch.train import schedules as t_sched
from endosurf_tpu_torch.train import trainer_endonerf as t_tr
from endosurf_tpu_torch.train.trainer_endosurf import adam_count

from test_torch_dnerf_grad import render_draws

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
H, W, B = 12, 16, 64
WEIGHTS = {"color_loss_weight": 1.0, "depth_loss_weight": 1.0}
SMALL = dict(deform_layers=(3, 32, (1,)), density_layers=(3, 32, (1,)),
             color_layers=(2, 32, ()), geo_feat_dim=16)
LR = (5e-4, 250)


@pytest.fixture(autouse=True)
def _jax_plain_path():
    j_mlp.set_matmul_precision("highest")
    j_mlp.set_sampling_precision(None)
    yield
    j_mlp.set_matmul_precision("highest")
    j_mlp.set_activation_dtype(None)


@pytest.fixture(scope="module")
def scenes():
    return (j_scene.make_synthetic_arrays(4, H, W, seed=0),
            t_scene.make_synthetic_arrays(4, H, W, seed=0))


@pytest.fixture(scope="module")
def params_j():
    return j_en.init_dnerf_params(jax.random.PRNGKey(0), j_en.DNeRFSpec(**SMALL))


def step_draws(key, rspec, n_train):
    """One train step's draws from JAX's key chain, as torch tensors."""
    k_batch, k_loss = jax.random.split(key)
    k_frame, k_pix = jax.random.split(k_batch)
    return {"frame": torch.from_numpy(np.array(jax.random.randint(k_frame, (), 0, n_train))),
            "u_pix": torch.from_numpy(np.array(jax.random.uniform(k_pix, (B,)))),
            **render_draws(k_loss, rspec, B)}


def _torch_params(pj):
    pt = params_from_jax(pj)
    for v in flatten(pt).values():
        v.requires_grad_(True)
    return pt


def _jax_step(rspec):
    tx = optax.adam(j_sched.exponential(*LR))
    return tx, j_tr.make_train_step(j_en.DNeRFSpec(**SMALL), rspec, tx, H, W, B, WEIGHTS)


def _port_step(rspec, precision="highest"):
    return t_tr.make_train_step(t_en.DNeRFSpec(**SMALL), rspec, H, W, B, WEIGHTS,
                                schedule=t_sched.exponential(*LR), precision=precision)


def _grab_grads_tx():
    """A GradientTransformation whose new state is the gradient (zero
    update), so JAX's jitted step hands its gradients back."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


# One step, port against JAX. The D-NeRF step is chaotic in float32 noise:
# ten octaves turn an ulp of a sample's x_c into ~1e-4 of its density, and a
# point whose raw density plus the train noise sits within that noise of 0
# has its whole gradient switched on or off by the relu. So the gradients,
# sums over 8192 points with cancellation, differ by more than the pieces
# do (read over keys 7, 100, 101, with and without perturb: metrics <= 1.2e-3
# relative; per-leaf gradient relative L2 <= 1.5e-2 colour net, 4.5e-2
# density net, 0.13 deform net, whose gradient carries the density's
# spatial derivative). The limits sit at about 2x those readings. The
# field's gradients at fixed points are held tightly in
# test_torch_dnerf_grad.py. Adam's first update is lr * sign(g), so a
# gradient element near 0 flips its whole update: the updates the two sides
# take from their own gradients differ by up to 0.5 of a leaf's update (keys
# 7, 100, 101 without perturb; up to 6 % of a leaf's elements flipped), too
# loose to hold the optimizer. The port's Adam step at the exponential
# learning rate is held instead on JAX's own gradients, where it must give
# JAX's update to float32 rounding.
STEP_TOL = {"metric": 2e-3,
            "grad": {"color": 3e-2, "density": 1e-1, "deform": 0.3}}

# The update p_after - p_before, port against optax on the same gradients:
# each element's difference over its float32 rounding at most UPDATE_TOL
# (read <= 0.73 on a step's JAX gradients, <= 1.0 over four steps). The
# rounding is the spacing of the parameter, where p + update rounds, plus
# 2e-5 of the update: optax forms Adam's bias corrections in float32, and
# 1 - 0.999 rounds 1.3e-5 off, so its first update is 6.4e-6 larger than
# torch's (float64 corrections). A step with no update, one at twice the
# learning rate and one at the schedule's value one count early (on the
# fast decay of test_adam_exponential_track_matches_optax) read above 1.8e4.
UPDATE_TOL = 4.0


def _update_err(after_t, after_j, before_t, before_j=None):
    """{leaf: the largest difference between the port's update (after_t -
    before_t) and JAX's (after_j - before_j), over its float32 rounding}.
    Each argument maps leaf names to torch tensors or arrays."""
    before_j = before_t if before_j is None else before_j
    out = {}
    for k in after_t:
        b_j, a_j = _np(before_j[k]), _np(after_j[k])
        d_t, d_j = _np(after_t[k]) - _np(before_t[k]), a_j - b_j
        ulp = np.spacing(np.maximum(np.abs(b_j), np.abs(a_j)))
        out[k] = float(np.max(np.abs(d_t - d_j) / (ulp + 2e-5 * np.abs(d_j))))
    return out


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _adam_on_grads(params_j, grads, schedule):
    """The port's optimizer (make_optimizer + apply_update at ``schedule``)
    on bridged ``params_j``, one step on each gradient tree of ``grads``;
    returns the torch params after each step."""
    pt = _torch_params(params_j)
    opt = t_tr.make_optimizer(pt, 1.0)
    track = []
    for g in grads:
        gt = flatten(params_from_jax(g))
        for k, v in flatten(pt).items():
            v.grad = gt[k].clone()
        t_tr.apply_update(opt, schedule)
        track.append({k: v.detach().clone() for k, v in flatten(pt).items()})
    return track


@pytest.mark.parametrize("perturb", [True, False], ids=["perturb", "no-perturb"])
def test_train_step_matches_jax(scenes, params_j, perturb):
    """One step from bridged JAX params (the checkpoint layout: {deform,
    density, color}/layers/i/{w, b}), same draws, float32: metrics and
    per-leaf gradients within STEP_TOL; the port's Adam update at the
    exponential learning rate, fed the gradients of JAX's step, equals the
    update JAX's make_train_step took within UPDATE_TOL, and the port's
    step takes that same update on its own gradients. As the controls, a
    step on another key's draws misses the metric limit, and no update, or
    an update at twice the learning rate, misses UPDATE_TOL."""
    sj, st = scenes
    jr, tr = j_en.DNeRFRenderSpec(perturb=perturb), t_en.DNeRFRenderSpec(perturb=perturb)
    key = jax.random.PRNGKey(7)
    tx, step_j = _jax_step(jr)
    p_after, _, m_j = step_j(jax.tree_util.tree_map(jnp.array, params_j), tx.init(params_j),
                             sj.device_arrays, key, jnp.asarray(1.0))
    grab = _grab_grads_tx()
    _, g_j, _ = j_tr.make_train_step(j_en.DNeRFSpec(**SMALL), jr, grab, H, W, B, WEIGHTS)(
        jax.tree_util.tree_map(jnp.array, params_j), grab.init(params_j), sj.device_arrays, key,
        jnp.asarray(1.0))
    pt = _torch_params(params_j)
    before = {k: v.detach().clone() for k, v in flatten(pt).items()}
    assert set(before) == set(flatten(params_j))
    opt = t_tr.make_optimizer(pt, 1.0)
    m_t = _port_step(tr)(pt, opt, st.device_arrays, None,
                         step_draws(key, tr, len(st.list_train)))
    assert adam_count(opt) == 1 and set(m_t) == set(m_j)
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=STEP_TOL["metric"],
                                   err_msg=k)
    grads = flatten(g_j)
    for k, v in flatten(pt).items():
        assert _rel(v.grad.numpy(), np.asarray(grads[k])) <= STEP_TOL["grad"][k.split("/")[0]], k

    sched, after = t_sched.exponential(*LR), flatten(p_after)
    [on_j] = _adam_on_grads(params_j, [g_j], sched)
    err = _update_err(on_j, after, before)
    assert max(err.values()) <= UPDATE_TOL, err
    [on_own] = _adam_on_grads(params_j, [{k: v.grad.numpy() for k, v in flatten(pt).items()}],
                              sched)
    for k, v in flatten(pt).items():
        torch.testing.assert_close(v.detach(), on_own[k], rtol=0, atol=0)
    [twice] = _adam_on_grads(params_j, [g_j], lambda c: 2 * sched(c))
    for control in (before, twice):         # no update; twice the learning rate
        assert min(_update_err(control, after, before).values()) > UPDATE_TOL
    other = _port_step(tr)(_torch_params(params_j), t_tr.make_optimizer(_torch_params(params_j),
                                                                        1.0),
                           st.device_arrays, None,
                           step_draws(jax.random.PRNGKey(8), tr, len(st.list_train)))
    assert abs(float(other["loss_total"]) / float(m_j["loss_total"]) - 1) > STEP_TOL["metric"]


@pytest.mark.parametrize("lr_decay", [LR[1], 0.002], ids=["base-decay", "fast-decay"])
def test_adam_exponential_track_matches_optax(params_j, lr_decay):
    """Four Adam updates on seeded gradients (per-leaf scales 1e-4 to 1e1,
    a quarter of the elements 0 at step 2), the port's make_optimizer +
    apply_update at exponential(5e-4, lr_decay) against optax.adam at JAX's
    exponential: each step's update within UPDATE_TOL of JAX's. 0.002 decays the rate 10x every 2 updates, so
    the schedule's count is seen: as the controls, the rate one count early
    and twice the rate miss UPDATE_TOL over the four updates."""
    rng = np.random.default_rng(3)
    leaves, treedef = jax.tree_util.tree_flatten(params_j)
    scales = 10.0 ** rng.uniform(-4, 1, len(leaves))
    grads = []
    for i in range(4):
        g = [(s * rng.standard_normal(x.shape) * (rng.random(x.shape) > (0.25 if i == 1 else 0)))
             .astype(np.float32) for s, x in zip(scales, leaves)]
        grads.append(jax.tree_util.tree_unflatten(treedef, g))
    tx = optax.adam(j_sched.exponential(LR[0], lr_decay))
    p, s, track_j = jax.tree_util.tree_map(jnp.array, params_j), tx.init(params_j), []
    for g in grads:
        u, s = tx.update(g, s, p)
        p = optax.apply_updates(p, u)
        track_j.append(flatten(p))
    sched, start = t_sched.exponential(LR[0], lr_decay), flatten(params_j)
    prev_t = prev_j = start
    for n, (a_t, a_j) in enumerate(zip(_adam_on_grads(params_j, grads, sched), track_j), 1):
        err = _update_err(a_t, a_j, prev_t, prev_j)
        assert max(err.values()) <= UPDATE_TOL, (n, err)
        prev_t, prev_j = a_t, a_j
    controls = [lambda c: 2 * sched(c)] + ([lambda c: sched(c - 1)] if lr_decay < 1 else [])
    for schedule in controls:               # twice the rate; the rate one count early
        err = _update_err(_adam_on_grads(params_j, grads, schedule)[-1], track_j[-1], start)
        assert min(err.values()) > UPDATE_TOL, err


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def test_bf16_loss_track(scenes, params_j):
    """Three Adam steps at "default" against JAX's make_train_step at
    matmul_precision "default" with activation_dtype float32 (on the CPU
    JAX's DEFAULT dot is float32, so its track is the float32 math). The
    port's float32 track: step 1 within 1e-3 relative (read 4.2e-4), steps
    2-3 within 2e-2 (read 5.5e-3: the chaos of STEP_TOL compounds through
    Adam, whose first updates are the gradients' signs). The port's bf16
    track (bf16 operands, coordinates included, float32 accumulation) within
    3e-2 (read 1.3e-2); as the control, its step 1 misses the float32 step-1
    limit (read 5.0e-3: ten octaves of a bf16-rounded coordinate)."""
    sj, st = scenes
    j_mlp.set_matmul_precision("default")
    j_mlp.set_activation_dtype("float32")
    jr, tr = j_en.DNeRFRenderSpec(), t_en.DNeRFRenderSpec()
    tx, step_j = _jax_step(jr)
    keys = [jax.random.PRNGKey(100 + i) for i in range(3)]
    p, s, track_j = jax.tree_util.tree_map(jnp.array, params_j), tx.init(params_j), []
    for i, k in enumerate(keys):
        p, s, m = step_j(p, s, sj.device_arrays, k, jnp.asarray(float(i + 1)))
        track_j.append(float(m["loss_total"]))

    def track_t(precision):
        pt = _torch_params(params_j)
        opt = t_tr.make_optimizer(pt, 1.0)
        step = _port_step(tr, precision)
        return [float(step(pt, opt, st.device_arrays, None,
                           step_draws(k, tr, len(st.list_train)))["loss_total"]) for k in keys]
    rel_bf16 = np.abs(np.array(track_t("default")) - track_j) / np.abs(track_j)
    rel_f32 = np.abs(np.array(track_t("highest")) - track_j) / np.abs(track_j)
    assert rel_f32[0] <= 1e-3 and rel_f32.max() <= 2e-2, rel_f32
    assert rel_bf16.max() <= 3e-2, rel_bf16
    assert rel_bf16[0] > 1e-3, rel_bf16


# ---------------------------------------------------------------------------
# the trainer, the CLI and the refusals
# ---------------------------------------------------------------------------

TINY_NET = {"net_deform_cfg": {"n_layers": 3, "hidden_dim": 32, "skips": [1]},
            "net_density_cfg": {"n_layers": 3, "hidden_dim": 32, "skips": [1]},
            "net_color_cfg": {"n_layers": 2, "hidden_dim": 32, "skips": []},
            "geo_feat_dim": 16}


def _tiny_cfg(exp_dir, n_iter=4):
    return {
        "exp": {"project_name": "p", "exp_name": "e", "exp_dir": str(exp_dir), "seed": 0},
        "render": {"type": "endonerf", "n_samples": 16, "n_importance": 16},
        "train": {"n_iter": n_iter, "ray_batch": 32, "matmul_precision": "highest",
                  "sampling_precision": "highest", **WEIGHTS,
                  "optim": {"lr": 5e-4, "lr_decay": 250}, "eval": {"ray_batch": 96}},
        "net": dict(TINY_NET),
        "log": {"i_eval": 3, "i_save": 2},
        "demo": {"ray_batch": 96},
    }


def test_trainer_loop_cadence_and_resume(tmp_path, scenes, params_j):
    """Eval before step 1 and the i_eval multiples, saves at the i_save
    multiples and the end, a pause with stop_after, then resume: the same
    parameters and optimizer count, and the steps logged once each; eval
    renders every test frame. The trainer's parameter tree is the one a
    bridged JAX tree has (names and shapes), so it restores from one."""
    from endosurf_tpu_torch.train.checkpoint import load_checkpoint
    _, st = scenes
    cfg = _tiny_cfg(tmp_path, n_iter=4)
    tr = t_tr.EndoNeRFTrainer(cfg, scene=st, device="cpu")
    bridged = flatten(params_from_jax(params_j))
    assert {k: tuple(v.shape) for k, v in flatten(tr.params).items()} == {
        k: tuple(v.shape) for k, v in bridged.items()}
    tr.restore({"n_iter": 0, "params": params_from_jax(params_j),
                "opt_state": tr.optimizer.state_dict()})
    assert all(torch.equal(v.detach(), bridged[k]) for k, v in flatten(tr.params).items())
    assert tr.lr_schedule(0) == pytest.approx(5e-4 * 0.1 ** (1 / 250000))
    evals = []
    tr.eval = lambda step: evals.append(step) or {}
    tr.start(log_every=1, stop_after=3)
    assert evals == [1, 3] and tr.step_start == 4
    assert load_checkpoint(tr.exp_dir)["n_iter"] == 3
    assert osp.exists(osp.join(tr.exp_dir, "ckpt_backup.pt"))
    cfg["train"]["resume"] = True
    tr2 = t_tr.EndoNeRFTrainer(cfg, scene=st, device="cpu")
    assert tr2.step_start == 4 and adam_count(tr2.optimizer) == 3
    for k, v in flatten(tr2.params).items():
        torch.testing.assert_close(v.detach(), flatten(tr.params)[k].detach(), rtol=0, atol=0)
    stats = tr2.eval(4)
    assert set(stats) == {"psnr_rgb_vr", "ssim_rgb_vr", "rmse_d_vr"}
    assert osp.exists(osp.join(tr2.exp_dir, "eval", "iter_00000004", "stats_out.txt"))
    tr2.eval = lambda step: {}
    tr2.start(log_every=1)
    assert load_checkpoint(tr2.exp_dir)["n_iter"] == 4
    with open(osp.join(tr2.exp_dir, "logs", "metrics.jsonl")) as f:
        steps = sorted({int(line.split('"step": ')[1].split(",")[0]) for line in f
                        if '"train/loss_total"' in line})
    assert steps == [1, 2, 3, 4]


@pytest.mark.parametrize("key, value, err", [
    # ported since: the ids they had while they raised
    pytest.param(("train", "pixel_sampler"), "alias", None,
                 id="key0-alias-NotImplementedError"),
    pytest.param(("parallel", "data_parallel"), True, None,
                 id="key1-True-NotImplementedError"),
    (("train", "matmul_precision"), "fast", ValueError),
    (("train", "megakernel"), "sometimes", ValueError)])
def test_refused_train_options_raise(tmp_path, scenes, key, value, err):
    """The options the port does not take raise (megakernel: off and
    sampler_kernel: off on a CUDA device are the card tests'); the options
    ported since (the alias pixel sampler, data_parallel, which on one CPU
    process runs the single-process step) build a trainer that takes a CPU
    step with finite metrics."""
    st = t_scene.make_synthetic_arrays(4, H, W, seed=0)
    cfg = _tiny_cfg(tmp_path)
    cfg.setdefault(key[0], {})[key[1]] = value
    if err is None:
        tr = t_tr.EndoNeRFTrainer(cfg, scene=st, device="cpu")
        metrics = tr.train_step(1)
        assert adam_count(tr.optimizer) == 1
        assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
        return
    with pytest.raises(err):
        t_tr.EndoNeRFTrainer(cfg, scene=st, device="cpu")
    cfg = _tiny_cfg(tmp_path)
    cfg["train"].update(megakernel="off", sampler_kernel="off")      # the CPU runs plain math
    t_tr.EndoNeRFTrainer(cfg, scene=st, device="cpu")


def _run_cli(args):
    env = {**os.environ, "PYTHONPATH": REPO}
    return subprocess.run([sys.executable, "-m", "endosurf_tpu_torch", *args],
                          capture_output=True, text=True, cwd=REPO, timeout=600, env=env)


def test_cli_train_then_test_2d_on_cpu(tmp_path):
    """python -m endosurf_tpu_torch --mode train --device cpu on a tiny
    endonerf config over an info pkl writes a checkpoint; --mode test_2d then
    serves that checkpoint."""
    from endosurf_tpu_torch.config import save_config
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from endosurf_tpu.data.scene_data import make_synthetic_scene\n"
            "print(make_synthetic_scene(%r, n_frames=4, h=12, w=16))\n") % (REPO, str(tmp_path / "s"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    cfg = _tiny_cfg(tmp_path / "logs", n_iter=3)
    cfg["data"] = {"info_dir": proc.stdout.strip().splitlines()[-1]}
    cfg["log"] = {"i_eval": 0, "i_save": 3}
    save_config(cfg, str(tmp_path / "cfg.yml"))
    proc = _run_cli(["--cfg", str(tmp_path / "cfg.yml"), "--mode", "train", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SAVE|iter:3/3" in proc.stdout and "Training complete!" in proc.stdout
    exp = tmp_path / "logs" / "p" / "e-synthetic-pulsating_sphere"
    assert (exp / "ckpt.pt").exists()
    proc = _run_cli(["--cfg", str(tmp_path / "cfg.yml"), "--mode", "test_2d", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PARAMS|checkpoint of iter 3" in proc.stdout
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("DEMO|")][-1]
    stats = dict(kv.split(":") for kv in line[len("DEMO|"):].split("|"))
    assert all(np.isfinite(float(v)) for v in stats.values())
    assert (exp / "demo" / "iter_00000003" / "test_2d" / "stats_out.txt").exists()
