"""The EndoNeRF serving path of the port held against the JAX package on the
CPU: the render kernel's plain twin against JAX's Pallas kernel in interpret
mode, ``render_rays_inference`` against JAX's, the eval / demo hooks
(ray transform, normals from depth, depth filter), and ``--mode test_2d`` /
``--mode test_3d`` against JAX's CLI on one synthetic scene and one set of
params.

Inputs come from numpy seeds; JAX runs at precision "highest". Both sides get
the same depth-guided draws: JAX draws eps from a fixed PRNGKey(0) of shape
[rays, 64] on every call, and the tests hand those numbers to the port
(``eps=``, or ``fused_render_dnerf.draw_eps`` patched).

Tolerances: the render maps per ray, 1e-4 on all but 1 ray in 32 and 5e-3
on every ray (bf16 dots: ``BF16_MAPS_TOL``): a deterministic draw on a cdf
step or in a floor-only bin moves with a float32 ulp of the coarse weights
(ROADMAP C). The CLI: PSNR
within 1e-4 relative, SSIM (near 0 for the untrained render) within 1e-4
absolute, depth RMSE within 5e-3 relative: the untrained density is faint
(acc ~1e-2 on many rays), where the disparity-form depth is a ratio of two
small sums and float32 noise moves a ray's depth by up to ~1e-2 (read 1.1e-2
on 96 rays of these nets, median 1.2e-5; the RMSE moved 1.4e-3 relative);
the meshes by vertex and triangle counts
(within 1 %) and the geometric error (1e-3 relative), as
test_torch_geometry3d.py holds EndoSurf's.
"""

import glob
import os
import os.path as osp
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endosurf_tpu.kernels import fused_render_dnerf as j_frd
from endosurf_tpu.models import endonerf as j_en
from endosurf_tpu.ops import mlp as j_mlp
from endosurf_tpu_torch.bridge import params_from_jax
from endosurf_tpu_torch.kernels import fused_render_dnerf as t_frd
from endosurf_tpu_torch.models import endonerf as t_en

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
MAPS = ("color_map", "depth_map", "acc_map")
TINY_NET = ("  net_deform_cfg: {n_layers: 3, hidden_dim: 32, skips: [1]}\n"
            "  net_density_cfg: {n_layers: 3, hidden_dim: 32, skips: [1]}\n"
            "  net_color_cfg: {n_layers: 2, hidden_dim: 32, skips: []}\n"
            "  geo_feat_dim: 16\n")


@pytest.fixture(autouse=True)
def _highest():
    j_mlp.set_matmul_precision("highest")
    yield


def _rays(n, depth_guided, seed=1):
    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(-0.3, 0.3, (n, 2)), np.full((n, 1), -1.5)], -1)
    d = rng.uniform(-0.2, 0.2, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nf = (np.stack([rng.uniform(1.3, 1.6, n), np.full(n, 0.08)], -1) if depth_guided
          else np.stack([np.full(n, 0.8), np.full(n, 2.2)], -1))
    return np.concatenate([o, d, nf, rng.uniform(0, 1, (n, 1))], -1).astype(np.float32)


def _jax_eps(n):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n, 64), jnp.float32))


def _check_maps(got, ref):
    for k in MAPS:
        g = got[k].numpy() if torch.is_tensor(got[k]) else np.asarray(got[k])
        r = np.asarray(ref[k])
        assert g.shape == r.shape, k
        err = np.abs(g - r).max(-1)
        assert err.max() <= 5e-3 and (err > 1e-4).mean() <= 1.0 / 32, (k, err.max(),
                                                                        (err > 1e-4).mean())


# bf16 dots on both sides, per map (colour, depth, acc): limits on the median
# and the max of the per-ray error. Read on these 24 rays, JAX's init seeds 0
# and 1: median <= 3.0e-7 / 4.5e-5 / 4.5e-7, max <= 6.8e-5 / 6.5e-3 / 1.3e-4
# (an operand on a bf16 rounding edge rounds the other way on one side and
# moves a ray). The port's float32 twin against JAX's bf16 kernel reads a
# colour median >= 1.2e-4 and fails.
BF16_MAPS_TOL = {"color_map": (1e-5, 2e-3), "depth_map": (2e-4, 2e-2), "acc_map": (1e-5, 2e-3)}


def _bf16_maps_ok(got, ref):
    out = {}
    for k, (t_med, t_max) in BF16_MAPS_TOL.items():
        err = np.abs(got[k].numpy() - np.asarray(ref[k])).max(-1)
        out[k] = (float(np.median(err)), float(err.max()))
    return all(m <= BF16_MAPS_TOL[k][0] and x <= BF16_MAPS_TOL[k][1]
               for k, (m, x) in out.items()), out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("depth_guided", [True, False], ids=["depth-guided", "uniform"])
def test_render_twin_matches_jax_kernel(depth_guided, dtype):
    """The port's plain twin against JAX's fused_render_rays_dnerf
    (interpreted) at the full DNeRFSpec, 64 + 64 samples, 24 rays: float32,
    and bf16 dots in both passes (JAX's serving call under "default")."""
    rspec_kw = {} if depth_guided else {"use_depth_sampling": False}
    js, ts = j_en.DNeRFSpec(), t_en.DNeRFSpec()
    jr, tr = j_en.DNeRFRenderSpec(**rspec_kw), t_en.DNeRFRenderSpec(**rspec_kw)
    pj = j_en.init_dnerf_params(jax.random.PRNGKey(0), js)
    rays = _rays(24, depth_guided)
    eps = torch.from_numpy(_jax_eps(24))
    assert t_frd.render_shape_supported(ts, tr)
    if dtype == "f32":
        ref = j_frd.fused_render_rays_dnerf(js, jr, pj, jnp.asarray(rays), interpret=True)
        got = t_frd.fused_render_rays_dnerf(ts, tr, params_from_jax(pj), torch.from_numpy(rays),
                                            eps=eps)
        _check_maps(got, ref)
        assert float(got["acc_map"].min()) > 0.0
        return
    ref = j_frd.fused_render_rays_dnerf(js, jr, pj, jnp.asarray(rays),
                                        sampling_dtype=jnp.bfloat16, main_dtype=jnp.bfloat16,
                                        main_precision=None, interpret=True)
    pt = params_from_jax(pj)
    got = t_frd.fused_render_rays_dnerf(ts, tr, pt, torch.from_numpy(rays), eps=eps,
                                        sampling_dtype=torch.bfloat16,
                                        main_dtype=torch.bfloat16)
    ok, errs = _bf16_maps_ok(got, ref)
    assert ok, errs
    f32 = t_frd.fused_render_rays_dnerf(ts, tr, pt, torch.from_numpy(rays), eps=eps)
    ok, errs = _bf16_maps_ok(f32, ref)
    assert not ok, errs          # the limits reject the float32 twin


def _small_specs(**kw):
    net = dict(deform_layers=(3, 64, (1,)), density_layers=(3, 64, (1,)),
               color_layers=(2, 64, ()), geo_feat_dim=32)
    net.update(kw)
    return j_en.DNeRFSpec(**net), t_en.DNeRFSpec(**net)


@pytest.mark.parametrize("case", ["depth-guided", "uniform", "no-importance", "static"])
def test_render_rays_inference_matches_jax(case, monkeypatch):
    """``render_rays_inference`` at small widths against JAX's (on the CPU
    JAX runs its ``render_rays`` with key=None): the twin for 64 + 64, the
    eval ``render_rays`` without importance samples or without the deform
    net."""
    js, ts = _small_specs(**({"use_deform": False} if case == "static" else {}))
    rspec_kw = {"use_depth_sampling": False} if case == "uniform" else {}
    jr, tr = j_en.DNeRFRenderSpec(**rspec_kw), t_en.DNeRFRenderSpec(**rspec_kw)
    pj = j_en.init_dnerf_params(jax.random.PRNGKey(1), js)
    rays = _rays(40, case != "uniform", seed=2)
    eps = torch.from_numpy(_jax_eps(40))
    monkeypatch.setattr(t_frd, "draw_eps", lambda n, s, device: eps[:n].to(device))
    use_imp = case != "no-importance"
    ref = j_en.render_rays_inference(js, jr, pj, jnp.asarray(rays), use_importance=use_imp)
    got = t_en.render_rays_inference(ts, tr, params_from_jax(pj), torch.from_numpy(rays),
                                     use_importance=use_imp)
    _check_maps(got, ref)


# ---------------------------------------------------------------------------
# eval / demo hooks
# ---------------------------------------------------------------------------

def _tiny_cfg(exp_dir, render_type="endonerf"):
    if render_type == "endonerf":
        return {"exp": {"project_name": "p", "exp_name": "e", "exp_dir": str(exp_dir), "seed": 0},
                "render": {"type": "endonerf", "depth_sampling_sigma": 0.1},
                "train": {"matmul_precision": "highest", "sampling_precision": "highest"},
                "net": {"net_deform_cfg": {"n_layers": 3, "hidden_dim": 32, "skips": [1]},
                        "net_density_cfg": {"n_layers": 3, "hidden_dim": 32, "skips": [1]},
                        "net_color_cfg": {"n_layers": 2, "hidden_dim": 32, "skips": []},
                        "geo_feat_dim": 16},
                "demo": {"ray_batch": 96}}
    return {"exp": {"project_name": "p", "exp_name": "s", "exp_dir": str(exp_dir), "seed": 0},
            "render": {"type": "endosurf", "n_samples": 16, "n_importance": 16,
                       "up_sample_steps": 2},
            "train": {"matmul_precision": "highest", "sampling_precision": "highest"},
            "net": {"deform_network": {"n_layers": 9, "hidden_dim": 64, "skips": [4], "out_dim": 3},
                    "sdf_network": {"n_layers": 9, "hidden_dim": 64, "skips": [4], "out_dim": 65},
                    "color_network": {"n_layers": 9, "hidden_dim": 64, "skips": [4],
                                      "feat_dim": 64, "out_dim": 3}},
            "demo": {"ray_batch": 96}}


def test_eval_hooks(tmp_path):
    """eval_frames with an EndoSurfRenderer renders what render_full_frames
    renders without hooks (EndoSurf output unchanged); with an
    EndoNeRFRenderer the chunks get the frame's gt depth and sigma in slots
    6/7 and the normal map comes from the depth map."""
    from endosurf_tpu_torch.data.scene_data import frame_rays, make_synthetic_arrays
    from endosurf_tpu_torch.evaluation import render_eval as re_
    from endosurf_tpu_torch.evaluation.vis import normal_from_depth
    from endosurf_tpu_torch.serve import EndoNeRFRenderer, EndoSurfRenderer, make_renderer
    scene = make_synthetic_arrays(n_frames=3, h=16, w=20, seed=0)
    surf = make_renderer(_tiny_cfg(tmp_path, "endosurf"), scene=scene, device="cpu")
    assert isinstance(surf, EndoSurfRenderer)
    stats, pred = re_.eval_frames(surf, [2], 10, ray_chunk=40, save_images=False,
                                  return_pred=True)
    plain = re_.render_full_frames(surf.render_fn(), surf.params, scene.device_arrays, 16, 20,
                                   [2], 10, 40)
    # two renders of one pipeline: equal up to the CPU GEMM's threading
    for k in ("rgb", "depth", "normal"):
        np.testing.assert_allclose(pred[k], plain[k], rtol=1e-6, atol=1e-7)
    ref_stats = re_.frame_stats(scene, [2], plain)
    assert stats.keys() == ref_stats.keys()
    for k, v in stats.items():
        assert abs(v - ref_stats[k]) <= 1e-5 * abs(v) + 1e-6, (k, v, ref_stats[k])

    nerf = make_renderer(_tiny_cfg(tmp_path), scene=scene, device="cpu")
    assert isinstance(nerf, EndoNeRFRenderer) and nerf.normals_from_depth
    seen = []
    fn = nerf.render_fn()
    nerf.render_fn = lambda: (lambda p, r, s: (seen.append(r.clone()), fn(p, r, s))[1])
    stats, pred = re_.eval_frames(nerf, [2], 10, ray_chunk=40, save_images=False,
                                  return_pred=True)
    rays = torch.cat(seen)[:320]
    gt = scene.device_arrays["depths"][2].reshape(-1)
    torch.testing.assert_close(rays[:, 6], gt, rtol=0, atol=0)
    assert bool((rays[:, 7] == 0.1).all())
    np.testing.assert_array_equal(rays[:, :6].numpy(),
                                  frame_rays(scene.device_arrays, 16, 20, 2).reshape(-1, 9)[:, :6])
    fr_rays = frame_rays(scene.device_arrays, 16, 20, 2).numpy()[None]
    np.testing.assert_allclose(pred["normal"], normal_from_depth(fr_rays, pred["depth"]),
                               rtol=0, atol=1e-6)
    assert all(np.isfinite(v) for v in stats.values())
    with pytest.raises(ValueError, match="serves render type"):
        EndoSurfRenderer(_tiny_cfg(tmp_path), scene=scene, device="cpu")


def test_demo_depth_filter(tmp_path):
    """run_demo smooths the 2D depth with demo.depth_filter before scoring
    it, and only when the config sets it."""
    from endosurf_tpu_torch.data.scene_data import make_synthetic_arrays
    from endosurf_tpu_torch.evaluation import render_eval as re_
    from endosurf_tpu_torch.evaluation.vis import filter_depth
    from endosurf_tpu_torch.serve import make_renderer
    scene = make_synthetic_arrays(n_frames=3, h=16, w=20, seed=1)
    cfg = _tiny_cfg(tmp_path)
    plain = make_renderer(cfg, scene=scene, device="cpu").demo(
        0, test_mode=True, visualize=False, demo_3d=False)
    cfg["demo"]["depth_filter"] = [5, 64, 32]
    r = make_renderer(cfg, scene=scene, device="cpu")
    got = r.demo(0, test_mode=True, visualize=False, demo_3d=False)
    pred = re_.render_full_frames(r.render_fn(), r.params, scene.device_arrays, 16, 20, [2], 0,
                                  96, r.eval_ray_transform)
    pred["depth"] = filter_depth(pred["depth"], [5, 64, 32])
    want = re_.frame_stats(scene, [2], pred)
    # equal up to the CPU GEMM's threading; the filter moves the depth RMSE
    assert abs(got["rmse_d_vr"] - want["rmse_d_vr"]) <= 1e-5 * abs(want["rmse_d_vr"])
    assert abs(got["rmse_d_vr"] - plain["rmse_d_vr"]) > 1e-3 * abs(plain["rmse_d_vr"])
    assert abs(got["psnr_rgb_vr"] - plain["psnr_rgb_vr"]) <= 1e-5 * abs(plain["psnr_rgb_vr"])


# ---------------------------------------------------------------------------
# the CLI against JAX's
# ---------------------------------------------------------------------------

def _run(args, timeout=600):
    env = {**os.environ, "PYTHONPATH": REPO}
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, cwd=REPO,
                          timeout=timeout, env=env)


def _cfg_yaml(exp_dir, exp_name, info, demo):
    return ("exp: {project_name: p, exp_name: %s, exp_dir: %s, seed: 0}\n"
            "data: {info_dir: %s}\n"
            "render: {type: endonerf, n_samples: 64, n_importance: 64, depth_sampling_sigma: 0.1}\n"
            "train: {n_iter: 1, matmul_precision: highest, sampling_precision: highest,\n"
            "        optim: {lr: 0.0005, lr_decay: 250}}\n"
            "net:\n%s"
            "demo: {%s}\n" % (exp_name, exp_dir, info, TINY_NET, demo))


@pytest.fixture(scope="module")
def cli_case(tmp_path_factory):
    """A synthetic scene, a JAX EndoNeRF init saved as JAX's checkpoint and as
    the port's npz, and the iso-threshold: the median raw density of a
    coarse probe of the test frame's grid box (the seeded init has no
    surface at base.yml's threshold of 5)."""
    from endosurf_tpu.config import load_config
    from endosurf_tpu.data.scene_data import make_synthetic_scene
    from endosurf_tpu.train.checkpoint import save_checkpoint
    from endosurf_tpu.train.trainer_endonerf import EndoNeRFTrainer
    from endosurf_tpu_torch.bridge import save_params_npz
    tmp = tmp_path_factory.mktemp("dnerf_cli")
    info = make_synthetic_scene(str(tmp / "scene"), n_frames=4, h=12, w=16)
    (tmp / "probe.yml").write_text(_cfg_yaml(tmp / "logs", "jax", info, "ray_batch: 96"))
    trainer = EndoNeRFTrainer(load_config(str(tmp / "probe.yml")), mode="train")
    save_checkpoint(trainer.exp_dir, 1, *trainer.checkpoint_state())
    npz = str(tmp / "p.npz")
    save_params_npz(npz, jax.device_get(trainer.params), step=1)
    fid = int(trainer.scene.list_test[0])
    lo, hi = trainer.scene.bbox_minmax[fid, :, 0] * 1.2, trainer.scene.bbox_minmax[fid, :, 1] * 1.2
    g = np.stack(np.meshgrid(*[np.linspace(lo[i], hi[i], 16) for i in range(3)], indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float32)
    t = np.full((len(g), 1), float(np.asarray(trainer.scene.device_arrays["ts"])[fid]), np.float32)
    dens = np.asarray(j_en.density_observed(trainer.spec, trainer.params, jnp.asarray(g),
                                            jnp.asarray(t)))
    return tmp, info, npz, round(float(np.median(dens)), 4)


def _stats(path):
    with open(path) as f:
        return {k: float(v) for k, v in (ln.split(":") for ln in f if ln.strip())}


def test_cli_test_2d_matches_jax(cli_case, monkeypatch):
    """``--mode test_2d`` (depth-guided draws, normals from depth, the depth
    filter) against JAX's CLI: the port's CLI runs in this process with JAX's
    draws patched in."""
    from endosurf_tpu_torch.__main__ import main
    tmp, info, npz, _ = cli_case
    demo = "ray_batch: 96, depth_filter: [5, 64, 32]"
    (tmp / "jax2.yml").write_text(_cfg_yaml(tmp / "logs", "jax", info, demo))
    (tmp / "port2.yml").write_text(_cfg_yaml(tmp / "logs", "port2", info, demo))
    proc = _run(["-m", "endosurf_tpu", "--cfg", str(tmp / "jax2.yml"), "--mode", "test_2d",
                 "--platform", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    eps = torch.from_numpy(_jax_eps(96))
    monkeypatch.setattr(t_frd, "draw_eps", lambda n, s, device: eps[:n].to(device))
    stats = main(["--cfg", str(tmp / "port2.yml"), "--mode", "test_2d", "--params", npz,
                  "--device", "cpu"])
    (j_dir,) = glob.glob(str(tmp / "logs" / "p" / "jax-*" / "demo" / "iter_00000001" / "test_2d"))
    (t_dir,) = glob.glob(str(tmp / "logs" / "p" / "port2-*" / "demo" / "iter_00000001" /
                             "test_2d"))
    ref, got = _stats(osp.join(j_dir, "stats_out.txt")), _stats(osp.join(t_dir, "stats_out.txt"))
    assert set(got) == {"psnr_rgb_vr", "ssim_rgb_vr", "rmse_d_vr"} <= set(ref)
    tols = {"psnr_rgb_vr": 1e-4 * abs(ref["psnr_rgb_vr"]), "ssim_rgb_vr": 1e-4,
            "rmse_d_vr": 5e-3 * abs(ref["rmse_d_vr"])}
    for k, v in got.items():
        assert abs(v - ref[k]) <= tols[k], (k, v, ref[k])
        assert abs(stats[k] - v) <= 1e-6 * abs(v) + 1e-6
    assert osp.exists(osp.join(t_dir, "000_all.png"))


def test_cli_test_3d_matches_jax(cli_case):
    from endosurf_tpu_torch.utils.ply import read_ply
    tmp, info, npz, thresh = cli_case
    demo = f"ray_batch: 96, marching_cubes_resolution: 40, marching_cubes_thresh: {thresh}"
    (tmp / "jax3.yml").write_text(_cfg_yaml(tmp / "logs", "jax", info, demo))
    (tmp / "port3.yml").write_text(_cfg_yaml(tmp / "logs", "port3", info, demo))
    proc = _run(["-m", "endosurf_tpu", "--cfg", str(tmp / "jax3.yml"), "--mode", "test_3d",
                 "--platform", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    proc = _run(["-m", "endosurf_tpu_torch", "--cfg", str(tmp / "port3.yml"), "--mode", "test_3d",
                 "--params", npz, "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = {}
    for name in ("jax", "port3"):
        (d3,) = glob.glob(str(tmp / "logs" / "p" / f"{name}-*" / "demo" / "iter_00000001" /
                              f"test_3d_thresh_{thresh}_res_40"))
        for kind in ("geometry", "color", "normal", "gt"):
            assert osp.exists(osp.join(d3, f"000_{kind}.ply")), (name, kind)
        with open(osp.join(d3, "stats_out.txt")) as f:
            mean = float(f.readline().split(":")[1])
        verts, tris = read_ply(osp.join(d3, "000_geometry.ply"))[:2]
        out[name] = (mean, len(verts), len(tris))
    (m_j, v_j, f_j), (m_t, v_t, f_t) = out["jax"], out["port3"]
    assert np.isfinite(m_t) and v_t > 0
    assert abs(v_t - v_j) <= 0.01 * v_j and abs(f_t - f_j) <= 0.01 * f_j, out
    assert abs(m_t - m_j) <= 1e-3 * abs(m_j), out
