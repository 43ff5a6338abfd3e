"""The sphere-traced ray march (kernels/fused_sampler.py::fused_ray_march,
models/endosurf.py::ray_march / march_math) and the train step with
``surf_march_reuse: false``, held against the JAX package on the CPU.

The port's plain march (what ``fused_ray_march`` runs for CPU tensors) is
compared with JAX's Pallas ``fused_ray_march(interpret=True)`` and with
JAX's ``ray_march``, from one JAX init bridged to torch and one numpy draw
of the rays; a narrow spec (9 layers of width 64) keeps the interpreted
kernel to seconds. Per ray: the valid flags agree on all but 1 ray in 32
and, where both are valid, the depth within 1e-4 (float32; read: flags
equal, depth 3.0e-7) or 2e-3 (bf16 dots on both sides; read: flags equal,
depth 3.1e-4), on all but 1 ray in 32. A flip of the chosen crossing, where a scan sample sits
within float noise of tau, would move the depth by a bin (ROADMAP.md,
section C), hence the allowance.

The limits of ``fused_sampler.MARCH_TOL`` are checked on the plain march's
own output and against output faults planted on 1 ray in 64; the CUDA
kernel is held against the plain march in test_torch_cuda.py. One train
step with the sphere trace matches JAX's (same draws) within the
tolerances of tests/test_torch_train.py.
"""

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
from endosurf_tpu.ops.geometry import ray_sphere_intersection as j_sphere
from endosurf_tpu.train import trainer_endosurf as j_tr
from endosurf_tpu_torch.bridge import flatten, params_from_jax
from endosurf_tpu_torch.data import scene_data as t_scene
from endosurf_tpu_torch.kernels import fused_sampler as t_fs
from endosurf_tpu_torch.models import endosurf as t_es
from endosurf_tpu_torch.models import fields as t_fields
from endosurf_tpu_torch.ops.geometry import ray_sphere_intersection
from endosurf_tpu_torch.train import trainer_endosurf as t_tr

N_RAYS = 64
FRAC = 1.0 / 32
DEPTH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-3}
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
    j_fields.set_megakernel_mode("off")
    j_fs.set_sampler_kernel_mode("off")
    j_mlp.set_matmul_precision("highest")
    j_mlp.set_sampling_precision(None)
    yield
    j_fields.set_megakernel_mode("auto")
    j_fs.set_sampler_kernel_mode("auto")


@pytest.fixture(scope="module")
def params():
    pj = j_fields.init_endosurf_params(jax.random.PRNGKey(1), _narrow(j_fields))
    return pj, params_from_jax(pj)


def _rays(n=N_RAYS, seed=1):
    """[n, 9] rays from z = -1.5: three in four towards the middle of the
    unit sphere (they cross the surface), one in four past its rim."""
    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(-0.3, 0.3, (n, 2)), np.full((n, 1), -1.5)], -1)
    target = rng.uniform(-0.3, 0.3, (n, 3))
    target[::4, 0] = rng.choice([-1.05, 1.05], n)[::4]
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, np.zeros((n, 2)), rng.uniform(0, 1, (n, 1))],
                          -1).astype(np.float32)


def _port_inputs(rays):
    o, d, d_z, t = t_es._split_rays(torch.from_numpy(rays))
    near, far, _ = ray_sphere_intersection(o, d)
    return o, d_z, t, near, far


def _jax_kernel(pj, rays, dtype):
    o, d, d_z, t = j_es._split_rays(jnp.asarray(rays))
    near, far, _ = j_sphere(o, d)
    depth, valid = j_fs.fused_ray_march(_narrow(j_fields), pj, o, d_z, t, near, far,
                                        compute_dtype=dtype, interpret=True)
    return np.asarray(depth), np.asarray(valid)


def _compare(depth, valid, ref_depth, ref_valid, tol):
    """(valid-flag mismatch share, worst depth error over rays valid on both
    sides but 1 in 32) and whether both are within the limits."""
    flips = float((valid != ref_valid).mean())
    both = (valid & ref_valid)[:, 0]
    err = np.sort(np.abs(depth - ref_depth)[both, 0])
    worst = float(err[max(0, len(err) - 1 - int(FRAC * len(err)))]) if len(err) else 0.0
    return flips, worst, flips <= FRAC and worst <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_march_matches_interpreted_jax_kernel(params, dtype):
    pj, pt = params
    rays = _rays()
    out = t_fs.fused_ray_march(_narrow(t_fields), pt, *_port_inputs(rays),
                               sampling_dtype=dtype)
    assert out["depth"].shape == (N_RAYS, 1) and out["valid"].dtype == torch.bool
    ref_d, ref_v = _jax_kernel(pj, rays, jnp.bfloat16 if dtype == torch.bfloat16
                               else jnp.float32)
    valid = out["valid"].numpy()
    assert 0.25 <= valid.mean() <= 0.95, valid.mean()     # both kinds of rays
    flips, worst, ok = _compare(out["depth"].numpy(), valid, ref_d, ref_v, DEPTH_TOL[dtype])
    print(f"{dtype}: {100 * valid.mean():.1f} % valid, flags differ on {100 * flips:.2f} %, "
          f"depth {worst:.3e}")
    assert ok, (flips, worst)
    mid = 0.5 * (out["d_low"] + out["d_high"])
    assert bool(torch.isfinite(out["depth"]).all() & torch.isfinite(mid).all())


def test_ray_march_matches_jax_ray_march(params):
    """``ray_march`` on CPU tensors (the plain march) against JAX's
    ``ray_march``, both float32: the same flags, depths within 1e-5."""
    pj, pt = params
    rays = _rays(seed=2)
    depth, valid = t_es.ray_march(_narrow(t_fields), pt, torch.from_numpy(rays))
    ref_d, ref_v = j_es.ray_march(_narrow(j_fields), pj, jnp.asarray(rays))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_v))
    np.testing.assert_allclose(depth.numpy(), np.asarray(ref_d), rtol=0, atol=1e-5)


def test_secant_converges_within_three_steps(params):
    """The march's 8 secant steps reach float32 noise in about 3 on these
    fields (residual |sdf(depth)| p99 <= 1e-6), while the crossing pair's
    interpolation alone is 1e-5 or more off: a planted fault must drop the
    refinement, not only its last step, to show."""
    _, pt = params
    spec, ins = _narrow(t_fields), _port_inputs(_rays(256, seed=3))
    res = {}
    for n in (0, 3, 8):
        out = t_fs.fused_ray_march_reference(spec, pt, *ins, n_secant=n)
        res[n] = t_fs.march_consistency(spec, pt, *ins[:3], out, torch.float32)["residual"][0]
    print({k: f"{v[1]:.3e}" for k, v in res.items()})
    assert res[3][1] <= 1e-6 and res[8][1] <= 1e-6 and res[0][1] >= 1e-5, res


def _plant(out, fault):
    """A copy of a march result wrong on 1 ray in 64 (valid rays only)."""
    bad = {k: v.clone() for k, v in out.items()}
    rows = torch.nonzero(out["valid"][:, 0])[:, 0][::64]
    if fault == "crossing_one_bin_late":
        step = out["bin"][rows]
        bad["idx"][rows] += 1
        bad["d_low"][rows] += step
        bad["d_high"][rows] += step
        bad["depth"][rows, 0] += step
    elif fault == "no_secant":
        bad["depth"][rows, 0] = out["first"][rows]
    elif fault == "valid_dropped":
        bad["valid"][rows] = False
    return bad


@pytest.mark.parametrize("fault", ["crossing_one_bin_late", "no_secant", "valid_dropped"])
def test_march_limits_catch_planted_output_faults(params, fault):
    """MARCH_TOL (float32) passes the plain march's own output and fails a
    result wrong on 1 ray in 64 of 1024."""
    _, pt = params
    spec, ins = _narrow(t_fields), _port_inputs(_rays(1024, seed=4))
    out = t_fs.fused_ray_march_reference(spec, pt, *ins)
    out["first"] = t_fs.fused_ray_march_reference(spec, pt, *ins, n_secant=0)["depth"][:, 0]
    out["bin"] = (ins[4] - ins[3])[:, 0] / 127

    def judge(res):
        par = t_fs.march_parity(res, out, torch.float32)
        own = t_fs.march_consistency(spec, pt, *ins[:3], res, torch.float32)
        return all(v[1] for v in par.values()) and all(v[1] for v in own.values()), par, own
    ok, par, own = judge(out)
    assert ok, (par, own)
    ok, par, own = judge(_plant(out, fault))
    print(fault, par, own)
    assert not ok, (par, own)


def _grab_grads_tx():
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _jax_draws(key, n_train):
    k_batch, k_loss = jax.random.split(key)
    k_frame, k_pix = jax.random.split(k_batch)
    k_z, k_neig = jax.random.split(k_loss)

    def t(x):
        return torch.from_numpy(np.array(x))
    return {"frame": t(jax.random.randint(k_frame, (), 0, n_train)),
            "u_pix": t(jax.random.uniform(k_pix, (B,))),
            "z": t(jax.random.uniform(k_z, (B, 1))),
            "neig": t(jax.random.uniform(k_neig, (B, 3)))}


def test_train_step_with_sphere_trace_matches_jax(params):
    """One step with ``march_reuse=False`` (the surface from the 128-sample
    march), same params and draws, float32: metrics within 2e-5 relative,
    parameter gradients within 1e-3 relative L2 per leaf (colour net 1e-2,
    as in test_torch_train.py)."""
    pj, _ = params
    sj = j_scene.make_synthetic_arrays(4, H, W, seed=0)
    st = t_scene.make_synthetic_arrays(4, H, W, seed=0)
    key = jax.random.PRNGKey(7)
    tx = _grab_grads_tx()
    step = j_tr.make_train_step(_narrow(j_fields), j_es.RenderSpec(anneal_end=50.0), tx, H, W,
                                B, WEIGHTS, 0.1, march_reuse=False)
    _, grads_j, metrics_j = step(jax.tree_util.tree_map(jnp.array, pj), tx.init(pj),
                                 sj.device_arrays, key, jnp.asarray(20.0))
    pt = params_from_jax(pj)
    for v in flatten(pt).values():
        v.requires_grad_(True)
    loss_fn = t_tr.make_loss_fn(_narrow(t_fields), t_es.RenderSpec(anneal_end=50.0), H, W, B,
                                WEIGHTS, 0.1, march_reuse=False)
    before = t_fs.LAUNCHES["fused_ray_march"]
    total, metrics_t = loss_fn(pt, st.device_arrays, 20.0, None,
                               _jax_draws(key, len(st.list_train)))
    total.backward()
    assert t_fs.LAUNCHES["fused_ray_march"] == before      # the CPU runs the plain march
    assert float(metrics_t["loss_surf_neig"]) > 0
    for k in metrics_j:
        np.testing.assert_allclose(float(metrics_t[k].detach()), float(metrics_j[k]),
                                   rtol=2e-5, atol=1e-7, err_msg=k)
    gj = flatten(grads_j)
    for k, v in flatten(pt).items():
        ref = np.asarray(gj[k])
        rel = np.linalg.norm(v.grad.numpy() - ref) / max(np.linalg.norm(ref), 1e-30)
        assert rel <= (1e-2 if k.startswith("color_network") else 1e-3), (k, rel)


def test_trainer_trains_with_surf_march_reuse_false(tmp_path):
    """EndoSurfTrainer takes ``surf_march_reuse: false`` (it raised before the
    march was ported) and trains two steps on the CPU with finite losses."""
    st = t_scene.make_synthetic_arrays(4, H, W, seed=0)
    cfg = {"exp": {"project_name": "p", "exp_name": "e", "exp_dir": str(tmp_path), "seed": 0},
           "render": {"type": "endosurf", "anneal_end": 50, "n_samples": 16,
                      "n_importance": 16, "up_sample_steps": 2},
           "train": {"n_iter": 2, "ray_batch": 16, "matmul_precision": "highest",
                     "sampling_precision": "highest", **WEIGHTS, "surf_neig_rad": 0.1,
                     "surf_march_reuse": False, "optim": {"lr": 5e-4, "warm_up_end": 2}},
           "net": {"deform_network": {"n_layers": 9, "hidden_dim": 32, "skips": [4],
                                      "out_dim": 3, "enc_pos_cfg": {"multires": 2},
                                      "enc_time_cfg": {"multires": 2}},
                   "sdf_network": {"n_layers": 9, "hidden_dim": 32, "skips": [4],
                                   "out_dim": 17, "enc_pos_cfg": {"multires": 2}},
                   "color_network": {"n_layers": 9, "hidden_dim": 32, "skips": [4],
                                     "feat_dim": 16, "out_dim": 3,
                                     "enc_pos_cfg": {"multires": 2},
                                     "enc_dir_cfg": {"multires": 2}}},
           "log": {"i_eval": 0, "i_save": 2}}
    tr = t_tr.EndoSurfTrainer(cfg, scene=st, device="cpu")
    metrics = [tr.train_step(s) for s in (1, 2)]
    assert all(torch.isfinite(v).all() for m in metrics for v in m.values())
    assert all(float(m["loss_surf_neig"]) >= 0 for m in metrics)
