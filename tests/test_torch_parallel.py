"""Data-parallel training and serving of the port (``endosurf_tpu_torch.
parallel``) on the CPU: two Gloo ranks, each a subprocess that imports only
the port, against the port's one-process step and JAX's sharded step.

One pair of workers runs every two-rank case (module fixture ``two_ranks``):
the worker reads a job file the test wrote (specs, bridged JAX parameters,
the draws of JAX's key chain) and each rank writes what it computed. The
cases: an EndoSurf and an EndoNeRF step on JAX's draws (held against JAX's
``make_train_step(..., mesh=make_mesh(8))`` on the conftest's 8 virtual CPU
devices, at ``test_torch_train.py``'s and ``test_torch_train_dnerf.py``'s
limits; at matmul_precision "default" beside one process, ROADMAP C1); two
EndoSurf and two EndoNeRF steps from the seeded generator
(against the one-process port: metrics 2e-5 relative, per-leaf gradient
relative L2 1e-4, the ranks' parameters bitwise equal); the planted control,
per-rank means with averaged gradients (DDP's default), which must miss those
limits; gathers of uneven splits; and a served frame, a grid and vertex
colours split over the ranks (against one process).
"""

import os
import os.path as osp
import socket
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
from endosurf_tpu.models import endosurf as j_es
from endosurf_tpu.models import fields as j_fields
from endosurf_tpu.parallel import mesh as j_mesh
from endosurf_tpu.train import trainer_endonerf as j_trn
from endosurf_tpu.train import trainer_endosurf as j_tr
from endosurf_tpu_torch.bridge import flatten, params_from_jax, unflatten
from endosurf_tpu_torch.data import scene_data as t_scene
from endosurf_tpu_torch.evaluation.geometry3d import eval_field_grid
from endosurf_tpu_torch.evaluation.render_eval import render_full_frames
from endosurf_tpu_torch.models import endonerf as t_en
from endosurf_tpu_torch.models import endosurf as t_es
from endosurf_tpu_torch.models import fields as t_fields
from endosurf_tpu_torch.parallel import mesh as t_mesh
from endosurf_tpu_torch.serve import EndoNeRFRenderer, EndoSurfRenderer
from endosurf_tpu_torch.train import schedules as t_sched
from endosurf_tpu_torch.train import trainer_endonerf as t_trn
from endosurf_tpu_torch.train import trainer_endosurf as t_tr

from test_torch_train import WEIGHTS, _grab_grads_tx, jax_draws
from test_torch_train_dnerf import SMALL, STEP_TOL, step_draws

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
H, W = 12, 16
B_ES, B_EN = 32, 64
DN_WEIGHTS = {"color_loss_weight": 1.0, "depth_loss_weight": 1.0}
ES_SCHED, EN_SCHED = (5e-3, 2, 10, 0.05), (5e-4, 250)
# 2 ranks against 1 process (both the port, float32)
METRIC_TOL, GRAD_TOL = 2e-5, 1e-4
FRAME, CHUNK, GRID_RES, GRID_BLOCK = 3, 64, 12, 5
TIMEOUT = 240

WORKER = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from endosurf_tpu_torch.bridge import flatten, unflatten
from endosurf_tpu_torch.data.scene_data import make_synthetic_arrays
from endosurf_tpu_torch.evaluation.geometry3d import eval_field_grid
from endosurf_tpu_torch.evaluation.render_eval import render_full_frames
from endosurf_tpu_torch.parallel import distributed
from endosurf_tpu_torch.parallel import mesh as pm
from endosurf_tpu_torch.serve import EndoNeRFRenderer, EndoSurfRenderer
from endosurf_tpu_torch.train import losses, schedules
from endosurf_tpu_torch.train import trainer_endonerf as trn
from endosurf_tpu_torch.train import trainer_endosurf as tr

assert distributed.initialize(backend="gloo")
job = torch.load(os.environ["ESN_JOB"], weights_only=False)
rank, world = distributed.rank(), distributed.process_count()
mesh = pm.make_mesh(False, "cpu")
assert mesh == pm.DataMesh(rank, world), mesh
scene = make_synthetic_arrays(4, job["H"], job["W"], seed=0)
out = {}


def params_of(flat):
    p = unflatten({k: v.clone() for k, v in flat.items()})
    for v in flatten(p).values():
        v.requires_grad_(True)
    return p


def run_steps(kind, flat, n_steps, draws=None, step_mesh=mesh, precision="highest"):
    # n_steps steps of the port's step; (metrics, step-1 grads, params)
    params = params_of(flat)
    prec = dict(precision=precision, sampling_precision=precision)
    if kind == "endosurf":
        opt = tr.make_optimizer(params, 1.0)
        step = tr.make_train_step(job["es_spec"], job["es_rspec"], job["H"], job["W"],
                                  job["B_ES"], job["WEIGHTS"], 0.1,
                                  schedule=schedules.warmup_cosine(*job["ES_SCHED"]),
                                  mesh=step_mesh, **prec)
        gen = torch.Generator().manual_seed(1)
        call = lambda i, d: step(params, opt, scene.device_arrays, gen, float(i + 1), d)
    else:
        opt = trn.make_optimizer(params, 1.0)
        step = trn.make_train_step(job["en_spec"], job["en_rspec"], job["H"], job["W"],
                                   job["B_EN"], job["DN_WEIGHTS"],
                                   schedule=schedules.exponential(*job["EN_SCHED"]),
                                   mesh=step_mesh, **prec)
        gen = torch.Generator().manual_seed(1)
        call = lambda i, d: step(params, opt, scene.device_arrays, gen, d)
    metrics, grads = [], None
    for i in range(n_steps):
        metrics.append({k: float(v) for k, v in call(i, None if draws is None else draws).items()})
        if i == 0:
            grads = {k: v.grad.clone() for k, v in flatten(params).items()}
    return metrics, grads, {k: v.detach().clone() for k, v in flatten(params).items()}


out["es_jax"] = run_steps("endosurf", job["es_params"], 1, job["es_draws"])
out["en_jax"] = run_steps("endonerf", job["en_params"], 1, job["en_draws"])
out["es_jax_bf16"] = run_steps("endosurf", job["es_params"], 1, job["es_draws"],
                               precision="default")
out["en_jax_bf16"] = run_steps("endonerf", job["en_params"], 1, job["en_draws"],
                               precision="default")
out["es_two"] = run_steps("endosurf", job["es_params"], 2)
out["en_two"] = run_steps("endonerf", job["en_params"], 2)

# the planted control: per-rank means (this rank's counts), gradients averaged
local_means = losses.global_means
losses.global_means = lambda terms, m: local_means(terms, None)
params = params_of(job["es_params"])
loss_fn = tr.make_loss_fn(job["es_spec"], job["es_rspec"], job["H"], job["W"], job["B_ES"],
                          job["WEIGHTS"], 0.1, mesh=mesh)
total, metrics = loss_fn(params, scene.device_arrays, 1.0, torch.Generator().manual_seed(1))
losses.global_means = local_means
total.backward()
pm.all_reduce_grads(flatten(params).values())
vec = torch.stack([v.detach() for v in metrics.values()])
mesh.sum_(vec)
out["control"] = ({k: float(v) / world for k, v in zip(metrics, vec)},
                  {k: v.grad / world for k, v in flatten(params).items()})

# gathers of uneven splits (one rank with no row too)
out["gather"] = {n: pm.gather_rows(mesh.rows(torch.arange(n * 3.0).reshape(n, 3)), n, rank,
                                   world) for n in (7, 1, 0)}

# a served frame, a grid and vertex colours, split over the ranks
cfg = job["es_cfg"]
r = EndoSurfRenderer(cfg, scene=scene, params=unflatten(job["es_params"]), device="cpu")
assert r.mesh == mesh
out["frame"] = render_full_frames(r.render_fn(), r.params, scene.device_arrays, job["H"],
                                  job["W"], [job["FRAME"]], 20, job["CHUNK"], mesh=r.mesh)
out["grid"] = eval_field_grid(r.demo_field_fn(), 0.5, -np.ones(3, np.float32),
                              np.ones(3, np.float32), job["GRID_RES"], job["GRID_BLOCK"])
pts, dirs, t = job["points"]
out["colours"] = r.render_points_fn()(pts, dirs, t)
rn = EndoNeRFRenderer(job["en_cfg"], scene=scene, params=unflatten(job["en_params"]),
                      device="cpu")
out["en_colours"] = rn.render_points_fn()(pts, dirs, t)
out["en_frame"] = render_full_frames(rn.render_fn(), rn.params, scene.device_arrays, job["H"],
                                     job["W"], [job["FRAME"]], 20, job["CHUNK"],
                                     rn.eval_ray_transform, mesh=rn.mesh)
torch.save(out, os.environ["ESN_OUT"] + f".{rank}")
distributed.shutdown()
print("WORKER_OK", rank, flush=True)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(script: str, env_extra: dict, n: int = 2):
    """Start ``script`` as ``n`` Gloo ranks on a free port."""
    port = free_port()
    procs = []
    for rank in range(n):
        env = {**os.environ, "PYTHONPATH": REPO, "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port), "WORLD_SIZE": str(n), "RANK": str(rank),
               "LOCAL_RANK": str(rank), "OMP_NUM_THREADS": "1", **env_extra}
        procs.append(subprocess.Popen([sys.executable, "-c", script], env=env, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    return procs


def wait_ranks(procs, timeout: int = TIMEOUT):
    """Each rank's output; a timeout kills every rank and fails with their
    output, a rank that failed fails with its own."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs += [p.communicate()[0] for p in procs[len(outs):]]
        pytest.fail(f"ranks timed out after {timeout} s:\n" + "\n=== next rank ===\n".join(
            o[-3000:] for o in outs))
    for rank, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{o[-5000:]}"
    return outs


def _tiny_cfg(render: dict, net: dict) -> dict:
    return {"exp": {"project_name": "p", "exp_name": "e", "exp_dir": "unused", "seed": 0},
            "render": render, "net": net,
            "train": {"matmul_precision": "highest", "sampling_precision": "highest"}}


ES_NET = {"deform_network": {"n_layers": 4, "hidden_dim": 32, "skips": [], "out_dim": 3},
          "sdf_network": {"n_layers": 4, "hidden_dim": 32, "skips": [], "out_dim": 33},
          "color_network": {"n_layers": 4, "hidden_dim": 32, "skips": [], "feat_dim": 32,
                            "out_dim": 3}}
ES_RENDER = dict(n_samples=16, n_importance=16, up_sample_steps=2, anneal_end=50.0)


def _small(mod):
    """ES_NET's spec in the package ``mod`` (JAX's or the port's fields)."""
    return mod.EndoSurfSpec(deform=mod.MLPSpec(4, 32, (), 3), sdf=mod.MLPSpec(4, 32, (), 33),
                            color=mod.MLPSpec(4, 32, (), 3), color_feat_dim=32)
EN_NET = {"net_deform_cfg": {"n_layers": 3, "hidden_dim": 32, "skips": [1]},
          "net_density_cfg": {"n_layers": 3, "hidden_dim": 32, "skips": [1]},
          "net_color_cfg": {"n_layers": 2, "hidden_dim": 32, "skips": []}, "geo_feat_dim": 16}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The inputs both sides share: specs, bridged JAX parameters, the draws
    of JAX's key chain, the renderers' configs and colour query points."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-0.6, 0.6, (101, 3)).astype(np.float32)
    dirs = rng.normal(size=(101, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    es_cfg = _tiny_cfg({"type": "endosurf", **ES_RENDER}, ES_NET)
    en_cfg = _tiny_cfg({"type": "endonerf", "n_samples": 16, "n_importance": 16}, EN_NET)
    es_pj = j_fields.init_endosurf_params(jax.random.PRNGKey(0), _small(j_fields))
    en_pj = j_en.init_dnerf_params(jax.random.PRNGKey(0), j_en.DNeRFSpec(**SMALL))
    st = t_scene.make_synthetic_arrays(4, H, W, seed=0)
    en_rspec = t_en.DNeRFRenderSpec()
    out = {
        "H": H, "W": W, "B_ES": B_ES, "B_EN": B_EN, "WEIGHTS": WEIGHTS,
        "DN_WEIGHTS": DN_WEIGHTS, "ES_SCHED": ES_SCHED, "EN_SCHED": EN_SCHED,
        "FRAME": FRAME, "CHUNK": CHUNK, "GRID_RES": GRID_RES, "GRID_BLOCK": GRID_BLOCK,
        "es_spec": _small(t_fields), "es_rspec": t_es.RenderSpec(**ES_RENDER),
        "en_spec": t_en.DNeRFSpec(**SMALL), "en_rspec": en_rspec,
        "es_params": flatten(params_from_jax(es_pj)), "en_params": flatten(params_from_jax(en_pj)),
        "es_draws": jax_draws(jax.random.PRNGKey(7), len(st.list_train), B_ES),
        "en_draws": step_draws(jax.random.PRNGKey(7), en_rspec, len(st.list_train)),
        "es_cfg": es_cfg, "en_cfg": en_cfg, "points": (pts, dirs, np.full((101, 1), 0.5,
                                                                          np.float32)),
        "es_pj": es_pj, "en_pj": en_pj,
    }
    path = tmp_path_factory.mktemp("dp") / "job.pt"
    torch.save({k: v for k, v in out.items() if not k.endswith("_pj")}, path)
    out["path"] = str(path)
    return out


class Ranks:
    """The worker's two ranks, started at once; ``results()`` waits for them
    (once) and reads each rank's output, in rank order."""

    def __init__(self, job):
        self.base = job["path"] + ".out"
        self.procs = start_ranks(WORKER, {"ESN_JOB": job["path"], "ESN_OUT": self.base})
        self.out = None

    def results(self):
        if self.out is None:
            wait_ranks(self.procs)
            self.out = [torch.load(f"{self.base}.{r}", weights_only=False) for r in range(2)]
        return self.out


@pytest.fixture(scope="module")
def ranks(job):
    """The two ranks, running while the first test computes JAX's side."""
    r = Ranks(job)
    yield r
    for p in r.procs:
        p.kill()
        p.communicate()


@pytest.fixture(scope="module")
def two_ranks(ranks):
    return ranks.results()


@pytest.fixture(scope="module")
def one_rank(job):
    """The port's one-process results on the same inputs."""
    scene = t_scene.make_synthetic_arrays(4, H, W, seed=0)

    def steps(kind, n, draws=None, precision="highest"):
        params = unflatten({k: v.clone().requires_grad_(True)
                            for k, v in job[f"{kind}_params"].items()})
        gen = torch.Generator().manual_seed(1)
        prec = dict(precision=precision, sampling_precision=precision)
        if kind == "es":
            opt = t_tr.make_optimizer(params, 1.0)
            step = t_tr.make_train_step(job["es_spec"], job["es_rspec"], H, W, B_ES, WEIGHTS,
                                        0.1, schedule=t_sched.warmup_cosine(*ES_SCHED), **prec)
            call = lambda i: step(params, opt, scene.device_arrays, gen, float(i + 1), draws)
        else:
            opt = t_trn.make_optimizer(params, 1.0)
            step = t_trn.make_train_step(job["en_spec"], job["en_rspec"], H, W, B_EN,
                                         DN_WEIGHTS, schedule=t_sched.exponential(*EN_SCHED),
                                         **prec)
            call = lambda i: step(params, opt, scene.device_arrays, gen, draws)
        metrics, grads = [], None
        for i in range(n):
            metrics.append({k: float(v) for k, v in call(i).items()})
            if i == 0:
                grads = {k: v.grad.clone() for k, v in flatten(params).items()}
        return metrics, grads

    r = EndoSurfRenderer(job["es_cfg"], scene=scene, params=unflatten(job["es_params"]),
                         device="cpu")
    assert r.mesh is None
    rn = EndoNeRFRenderer(job["en_cfg"], scene=scene, params=unflatten(job["en_params"]),
                          device="cpu")
    return {"es_two": steps("es", 2), "en_two": steps("en", 2),
            "es_jax_bf16": steps("es", 1, job["es_draws"], "default"),
            "en_jax_bf16": steps("en", 1, job["en_draws"], "default"),
            "frame": render_full_frames(r.render_fn(), r.params, scene.device_arrays, H, W,
                                        [FRAME], 20, CHUNK),
            "grid": eval_field_grid(r.demo_field_fn(), 0.5, -np.ones(3, np.float32),
                                    np.ones(3, np.float32), GRID_RES, GRID_BLOCK),
            "colours": r.render_points_fn()(*job["points"]),
            "en_colours": rn.render_points_fn()(*job["points"]),
            "en_frame": render_full_frames(rn.render_fn(), rn.params, scene.device_arrays, H, W,
                                           [FRAME], 20, CHUNK, rn.eval_ray_transform)}


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _metric_errs(got: dict, ref: dict) -> dict:
    assert set(got) == set(ref)
    return {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-7) for k in ref}


def _grad_errs(got: dict, ref: dict) -> dict:
    return {k: _rel(got[k], ref[k]) for k in ref}


# ---------------------------------------------------------------------------
# (a) two ranks against JAX's sharded step
# ---------------------------------------------------------------------------

def test_endosurf_two_ranks_match_jax_sharded_step(job, ranks):
    """An EndoSurf step on 2 Gloo ranks, fed JAX's draws, against JAX's
    make_train_step with the batch sharded over 8 virtual devices, same
    params: metrics within 2e-5 relative, per-leaf gradients within 1e-3
    relative L2 (1e-2 the colour net), on both ranks."""
    key = jax.random.PRNGKey(7)
    tx = _grab_grads_tx()
    try:
        step = j_tr.make_train_step(_small(j_fields), j_es.RenderSpec(**ES_RENDER), tx, H, W,
                                    B_ES, WEIGHTS, 0.1, mesh=j_mesh.make_mesh(8))
        sj = j_scene.make_synthetic_arrays(4, H, W, seed=0)
        _, grads_j, metrics_j = step(jax.tree_util.tree_map(jnp.array, job["es_pj"]),
                                     tx.init(job["es_pj"]), sj.device_arrays, key,
                                     jnp.asarray(1.0))
    finally:
        j_mesh.set_mesh_active(False)
    gj = {k: np.asarray(v) for k, v in flatten(grads_j).items()}
    two_ranks = ranks.results()
    for rank in range(2):
        (metrics,), grads, _ = two_ranks[rank]["es_jax"]
        errs = _metric_errs(metrics, {k: float(v) for k, v in metrics_j.items()})
        g_errs = _grad_errs({k: v.numpy() for k, v in grads.items()}, gj)
        print(f"rank {rank}: metrics {max(errs.values()):.2e}, grads {max(g_errs.values()):.2e}")
        assert max(errs.values()) <= 2e-5, (rank, errs)
        for k, e in g_errs.items():
            assert e <= (1e-2 if k.startswith("color_network") else 1e-3), (rank, k, e)


def test_endonerf_two_ranks_match_jax_sharded_step(job, ranks):
    """An EndoNeRF step on 2 Gloo ranks, fed JAX's draws, against JAX's
    sharded make_train_step (8 virtual devices), same params: metrics and
    per-leaf gradients within test_torch_train_dnerf.STEP_TOL."""
    key = jax.random.PRNGKey(7)
    tx = _grab_grads_tx()
    try:
        step = j_trn.make_train_step(j_en.DNeRFSpec(**SMALL), j_en.DNeRFRenderSpec(), tx, H, W,
                                     B_EN, DN_WEIGHTS, mesh=j_mesh.make_mesh(8))
        sj = j_scene.make_synthetic_arrays(4, H, W, seed=0)
        _, grads_j, metrics_j = step(jax.tree_util.tree_map(jnp.array, job["en_pj"]),
                                     tx.init(job["en_pj"]), sj.device_arrays, key,
                                     jnp.asarray(1.0))
    finally:
        j_mesh.set_mesh_active(False)
    gj = {k: np.asarray(v) for k, v in flatten(grads_j).items()}
    two_ranks = ranks.results()
    for rank in range(2):
        (metrics,), grads, _ = two_ranks[rank]["en_jax"]
        errs = _metric_errs(metrics, {k: float(v) for k, v in metrics_j.items()})
        g_errs = _grad_errs({k: v.numpy() for k, v in grads.items()}, gj)
        print(f"rank {rank}: metrics {max(errs.values()):.2e}, grads {max(g_errs.values()):.2e}")
        assert max(errs.values()) <= STEP_TOL["metric"], (rank, errs)
        for k, e in g_errs.items():
            assert e <= STEP_TOL["grad"][k.split("/")[0]], (rank, k, e)


@pytest.mark.parametrize("kind", ["es", "en"], ids=["endosurf", "endonerf"])
def test_bf16_two_ranks_round_as_jax_sharded_step(job, ranks, one_rank, kind):
    """ROADMAP C1 at matmul_precision "default": each rank's bf16 backward
    rounds its own weight-gradient sums before the all-reduce adds them,
    where one process rounds the whole batch's sum once. Both, fed JAX's
    draws, against JAX's make_train_step at "default" with the batch sharded
    over 8 virtual devices (on the CPU JAX's DEFAULT dots are float32, so the
    reference rounds no sum): per leaf, the relative L2 of the 2 ranks'
    gradients from JAX's is at most 2x the one process's plus the float32
    floor 1e-6 (read: at most 1.05x on EndoSurf's sdf_network/layers/2/g,
    1.001x on EndoNeRF's), and each rank's metrics are the one process's
    within 2e-5 relative (METRIC_TOL): rounding per rank moves no leaf
    measurably farther from the reference than the port's own bf16 rounding
    does."""
    from endosurf_tpu.ops import mlp as j_mlp
    key = jax.random.PRNGKey(7)
    tx = _grab_grads_tx()
    sj = j_scene.make_synthetic_arrays(4, H, W, seed=0)
    j_mlp.set_matmul_precision("default")
    try:
        if kind == "es":
            step = j_tr.make_train_step(_small(j_fields), j_es.RenderSpec(**ES_RENDER), tx, H, W,
                                        B_ES, WEIGHTS, 0.1, mesh=j_mesh.make_mesh(8))
        else:
            step = j_trn.make_train_step(j_en.DNeRFSpec(**SMALL), j_en.DNeRFRenderSpec(), tx, H,
                                         W, B_EN, DN_WEIGHTS, mesh=j_mesh.make_mesh(8))
        pj = job[f"{kind}_pj"]
        _, grads_j, _ = step(jax.tree_util.tree_map(jnp.array, pj), tx.init(pj),
                             sj.device_arrays, key, jnp.asarray(1.0))
    finally:
        j_mesh.set_mesh_active(False)
        j_mlp.set_matmul_precision("highest")
    gj = {k: np.asarray(v) for k, v in flatten(grads_j).items()}
    (m_one,), g_one = one_rank[f"{kind}_jax_bf16"]
    one = _grad_errs({k: v.numpy() for k, v in g_one.items()}, gj)
    for rank in range(2):
        (metrics,), grads, _ = ranks.results()[rank][f"{kind}_jax_bf16"]
        two = _grad_errs({k: v.numpy() for k, v in grads.items()}, gj)
        worst = max(two, key=lambda k: two[k] / max(one[k], 1e-30))
        print(f"{kind} bf16 rank {rank}: gradients from JAX's sharded step, worst leaf ratio "
              f"{worst}: 2 ranks {two[worst]:.3e}, one process {one[worst]:.3e}")
        assert max(_metric_errs(metrics, m_one).values()) <= METRIC_TOL, rank
        for k in two:
            assert two[k] <= 2 * one[k] + 1e-6, (rank, k, two[k], one[k])


# ---------------------------------------------------------------------------
# (b) two ranks against one process, and the planted control
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["es", "en"], ids=["endosurf", "endonerf"])
def test_two_ranks_match_one_process(two_ranks, one_rank, kind):
    """Two steps from the seeded generator on 2 ranks against the port's
    one-process steps: every step's metrics within 2e-5 relative, step 1's
    gradients per leaf within 1e-4 relative L2 (the ranks sum their points'
    weight-gradient products in another order), and the two ranks'
    parameters bitwise equal after the two steps."""
    ref_metrics, ref_grads = one_rank[f"{kind}_two"]
    for rank in range(2):
        metrics, grads, _ = two_ranks[rank][f"{kind}_two"]
        for got, ref in zip(metrics, ref_metrics):
            errs = _metric_errs(got, ref)
            print(f"rank {rank}: metrics {max(errs.values()):.2e}")
            assert max(errs.values()) <= METRIC_TOL, (rank, errs)
        errs = _grad_errs(grads, ref_grads)
        print(f"rank {rank}: grads {max(errs.values()):.2e}")
        assert max(errs.values()) <= GRAD_TOL, (rank, errs)
    p0, p1 = two_ranks[0][f"{kind}_two"][2], two_ranks[1][f"{kind}_two"][2]
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_per_rank_means_control_fails(two_ranks, one_rank):
    """The planted control: each rank's loss a mean over its own rows and the
    gradients averaged over the ranks (DDP's default) is another result on a
    batch whose masks, Eikonal regions and surface hits differ across the
    shards: it misses the limits the sound step keeps."""
    ref_metrics, ref_grads = one_rank["es_two"]
    metrics, grads = two_ranks[0]["control"]
    m_err = max(_metric_errs(metrics, ref_metrics[0]).values())
    g_err = max(_grad_errs(grads, ref_grads).values())
    print(f"control: metrics {m_err:.2e}, grads {g_err:.2e}")
    assert m_err > 10 * METRIC_TOL and g_err > 10 * GRAD_TOL, (m_err, g_err)


# ---------------------------------------------------------------------------
# (c) sharding and gathering uneven splits
# ---------------------------------------------------------------------------

def test_shard_ray_batch_uneven():
    """tensor_split rows: the first n % world ranks take one more, scalars
    stay whole, the shards concatenate to the batch."""
    batch = {"rays": torch.arange(7 * 9.0).reshape(7, 9), "frame_id": torch.tensor(2),
             "color": torch.rand(7, 3)}
    shards = [t_mesh.shard_ray_batch(batch, r, 3) for r in range(3)]
    assert [s["rays"].shape[0] for s in shards] == t_mesh.split_sizes(7, 3) == [3, 2, 2]
    for k in ("rays", "color"):
        assert torch.equal(torch.cat([s[k] for s in shards]), batch[k])
    assert all(s["frame_id"] is batch["frame_id"] for s in shards)
    assert t_mesh.split_sizes(1, 2) == [1, 0]


def test_gather_rows_uneven(two_ranks):
    """gather_rows of 7, 1 and 0 rows over 2 ranks: every rank holds the
    whole tensor in rank order, bit for bit."""
    for rank in range(2):
        for n, got in two_ranks[rank]["gather"].items():
            assert torch.equal(got, torch.arange(n * 3.0).reshape(n, 3)), (rank, n)


# ---------------------------------------------------------------------------
# (d) serving split over the ranks
# ---------------------------------------------------------------------------

def test_sharded_frame_grid_and_colours_match_one_process(two_ranks, one_rank):
    """A frame of each family split over 2 ranks (its three 64-ray chunks, 2
    and 1) and gathered, a grid in 5-plane slabs split by rows, and 101
    vertex colours of each family (51 / 50 rows): on both ranks equal to
    the one-process results. The frames keep the single process's chunks
    (the EndoNeRF depth-guided draws depend on a ray's place in its chunk),
    and per-point outputs do not depend on their neighbours, so the only
    difference allowed is the CPU's float32 matrix products, which may block
    another row count otherwise (1e-6)."""
    for rank in range(2):
        got = two_ranks[rank]
        print(f"rank {rank}: frame " + ", ".join(
            f"{k} {np.abs(got['frame'][k] - one_rank['frame'][k]).max():.1e}"
            for k in ("rgb", "depth", "normal"))
            + "; EndoNeRF frame " + ", ".join(
                f"{k} {np.abs(got['en_frame'][k] - one_rank['en_frame'][k]).max():.1e}"
                for k in ("rgb", "depth"))
            + f"; grid {np.abs(got['grid'] - one_rank['grid']).max():.1e}; colours "
            f"{np.abs(got['colours'] - one_rank['colours']).max():.1e}, "
            f"{np.abs(got['en_colours'] - one_rank['en_colours']).max():.1e}")
        for frame in ("frame", "en_frame"):
            assert set(got[frame]) == set(one_rank[frame])
            for k in one_rank[frame]:
                np.testing.assert_allclose(got[frame][k], one_rank[frame][k], rtol=0,
                                           atol=1e-6, err_msg=f"{rank} {frame} {k}")
        np.testing.assert_allclose(got["grid"], one_rank["grid"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["colours"], one_rank["colours"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["en_colours"], one_rank["en_colours"], rtol=0,
                                   atol=1e-6)


def test_data_parallel_without_a_group(monkeypatch):
    """make_mesh: None for one process on the CPU (data_parallel or not), so
    the step is the single-process one; a group is what turns it on. With
    data_parallel, no group and several visible cards it raises and names
    torchrun; initialize refuses NCCL ranks that would share a card, and is
    a no-op for one process."""
    assert t_mesh.make_mesh(True, "cpu") is None
    assert t_mesh.make_mesh(False, "cpu") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node=2"):
        t_mesh.make_mesh(True, "cuda")
    assert t_mesh.make_mesh(False, "cuda") is None
    from endosurf_tpu_torch.parallel import distributed
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.initialize(device="cuda") is False
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(RuntimeError, match="one card a rank"):
        distributed.initialize(device="cuda")
    assert not distributed.is_initialized() and distributed.is_main_process()
