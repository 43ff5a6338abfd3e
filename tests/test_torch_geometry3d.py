"""The 3D test/demo path of the port (native/, evaluation/geometry3d.py, the
3D branch of evaluation/demo.py, ``--mode test_3d``) held against the JAX
package on the CPU.

* The port's copy of the native geometry library gives the JAX package's
  output bit for bit on the same inputs (equal arrays).
* The field grid matches JAX's to 1e-5 (both at precision "highest");
  marching tetrahedra on JAX's own grid values give JAX's mesh exactly; on
  the port's grid the meshes are held by vertex and triangle counts (within
  1 %) and the symmetric nearest-neighbour distance between the vertex sets
  (within 1e-4 of the bbox): a 1e-7 difference in the SDF moves a vertex
  along its edge, and a grid value near 0 can add or drop a triangle.
* Point clouds, geometric errors and vertex colours match to 1e-5.
* ``python -m endosurf_tpu_torch --mode test_3d --device cpu`` against
  ``python -m endosurf_tpu --mode test_3d --platform cpu`` on one synthetic
  scene and one set of params (a JAX init saved as JAX's checkpoint and as
  the port's npz): vertex counts within 1 % and geo_err_mean within 1e-3
  relative.
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

from endosurf_tpu import native as j_native
from endosurf_tpu.evaluation import geometry3d as j_geo
from endosurf_tpu.models import fields as j_fields
from endosurf_tpu.ops import mlp as j_mlp
from endosurf_tpu_torch import native as t_native
from endosurf_tpu_torch.bridge import params_from_jax
from endosurf_tpu_torch.evaluation import geometry3d as t_geo
from endosurf_tpu_torch.models import endosurf as t_es
from endosurf_tpu_torch.models import fields as t_fields

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _narrow(mod):
    return mod.EndoSurfSpec(deform=mod.MLPSpec(9, 64, (4,), 3),
                            sdf=mod.MLPSpec(9, 64, (4,), 65),
                            color=mod.MLPSpec(9, 64, (4,), 3), color_feat_dim=64)


@pytest.fixture(autouse=True)
def _highest():
    j_mlp.set_matmul_precision("highest")
    yield


@pytest.fixture(scope="module")
def params():
    pj = j_fields.init_endosurf_params(jax.random.PRNGKey(3), _narrow(j_fields))
    return pj, params_from_jax(pj)


@pytest.fixture(scope="module")
def mesh_case():
    """A noisy sphere SDF grid, its mesh and a point cloud (numpy)."""
    rng = np.random.default_rng(0)
    ax = np.linspace(-1, 1, 24, dtype=np.float32)
    xx, yy, zz = np.meshgrid(ax, ax, ax, indexing="ij")
    grid = (np.sqrt(xx ** 2 + yy ** 2 + zz ** 2) - 0.6
            + 0.05 * rng.normal(size=xx.shape)).astype(np.float32)
    verts, tris = j_native.marching_tetrahedra(grid, 0.0)
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    return grid, verts, tris, pts


NATIVE_CASES = {
    "marching_tetrahedra": lambda m, g, v, f, p: m.marching_tetrahedra(g, 0.02),
    "clean_mesh": lambda m, g, v, f, p: m.clean_mesh(v, f, 0.9),
    "laplacian_smooth": lambda m, g, v, f, p: m.laplacian_smooth(v, f, 3),
    "vertex_normals": lambda m, g, v, f, p: m.vertex_normals(v, f),
    "point_cloud_distance": lambda m, g, v, f, p: m.point_cloud_distance(p, v),
    "rasterize_mesh": lambda m, g, v, f, p: m.rasterize_mesh(
        np.concatenate([(v[:, :2] + 1.2) * 20, v[:, 2:] + 3], -1).astype(np.float32),
        np.abs(v), f, 48, 40),
}


@pytest.mark.parametrize("fn", sorted(NATIVE_CASES))
def test_native_copy_matches_jax_native(mesh_case, fn):
    """The port's build of its geometry.cpp copy gives equal arrays."""
    got = NATIVE_CASES[fn](t_native, *mesh_case)
    ref = NATIVE_CASES[fn](j_native, *mesh_case)
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert g.dtype == r.dtype and g.shape == r.shape and g.size > 0
        np.testing.assert_array_equal(g, r)


def _field_fns(params):
    pj, pt = params
    jf = jax.jit(lambda x, t: j_fields.sdf_observed(_narrow(j_fields), pj, x, t))

    def tf(x, t):
        return t_es._sdf_sampling(_narrow(t_fields), pt, x, t, "highest")
    return jf, tf


def _nn(a, b):
    d = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.sqrt(d.min(1))


def test_field_grid_and_mesh_match_jax(params):
    jf, tf = _field_fns(params)
    bmin, bmax = np.array([-1.1, -1.0, -0.9], np.float32), np.array([1.0, 1.1, 1.2], np.float32)
    res, t = 20, 0.3
    g_ref = j_geo.eval_field_grid(jf, t, bmin, bmax, res, block=8)
    g_got = t_geo.eval_field_grid(tf, t, bmin, bmax, res, block=8)
    assert g_got.shape == (res,) * 3
    np.testing.assert_allclose(g_got, g_ref, rtol=0, atol=1e-5)

    # the same grid values: the same mesh, array for array
    def jax_values(x, tt):
        return torch.from_numpy(np.array(jf(jnp.asarray(x.numpy()), jnp.asarray(tt.numpy()))))
    v_ref, f_ref = j_geo.extract_mesh(jf, t, bmin, bmax, res, block=8)
    v_same, f_same = t_geo.extract_mesh(jax_values, t, bmin, bmax, res, block=8)
    np.testing.assert_array_equal(v_same, v_ref)
    np.testing.assert_array_equal(f_same, f_ref)

    # the port's own grid: counts and vertex positions
    v_got, f_got = t_geo.extract_mesh(tf, t, bmin, bmax, res, block=8)
    assert len(v_ref) > 100
    assert abs(len(v_got) - len(v_ref)) <= 0.01 * len(v_ref)
    assert abs(len(f_got) - len(f_ref)) <= 0.01 * len(f_ref)
    sym = max(_nn(v_got, v_ref).max(), _nn(v_ref, v_got).max())
    assert sym <= 1e-4 * float((bmax - bmin).max()), sym


def test_pointcloud_and_geometric_error_match_jax(mesh_case):
    rng = np.random.default_rng(5)
    rgb = rng.uniform(0, 1, (12, 16, 3)).astype(np.float32)
    depth = rng.uniform(0.1, 2.0, (12, 16, 1)).astype(np.float32)
    depth[0, :4] = 0.0
    K = np.array([[20.0, 0, 8.0], [0, 21.0, 6.0], [0, 0, 1.0]])
    c2w = np.eye(4)
    c2w[:3, 3] = [0.1, -0.2, -1.5]
    got = t_geo.rgbd_to_pointcloud(rgb, depth, K, c2w, 1.8)
    ref = j_geo.rgbd_to_pointcloud(rgb, depth, K, c2w, 1.8)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    _, verts, _, _ = mesh_case
    e_got = t_geo.geometric_error(got[0], verts, 100.0)
    assert e_got == j_geo.geometric_error(ref[0], verts, 100.0) and np.isfinite(e_got)
    assert t_geo.geometric_error(got[0][:0], verts) == float("inf")


def test_colored_meshes_match_jax(params, mesh_case):
    """Vertex colours through the renderer's hook (fused_point_eval) against
    JAX's, in chunks with a padded tail, and the normal colours."""
    from endosurf_tpu_torch.serve import EndoSurfRenderer
    pj, pt = params
    _, verts, tris, _ = mesh_case
    renderer = EndoSurfRenderer.__new__(EndoSurfRenderer)
    renderer.spec, renderer.params, renderer.precision = _narrow(t_fields), pt, "highest"
    renderer.device = torch.device("cpu")
    view = np.array([0.1, 0.2, -2.0], np.float32)
    got = t_geo.colored_meshes(renderer.render_points_fn(), verts, tris, view, 0.4, chunk=2048)
    jfn = jax.jit(lambda x, d, t: j_fields.fused_point_eval(_narrow(j_fields), pj, x, d,
                                                            t)["color"])
    ref = j_geo.colored_meshes(lambda x, d, t: jfn(jnp.asarray(x), jnp.asarray(d),
                                                   jnp.asarray(t)),
                               verts, tris, view, 0.4, chunk=2048)
    assert len(verts) > 2048 and got["color"].shape == (len(verts), 3)
    np.testing.assert_allclose(got["color"], ref["color"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["normal_color"], ref["normal_color"])


def _run(args, timeout=600):
    env = {**os.environ, "PYTHONPATH": REPO}
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, cwd=REPO,
                          timeout=timeout, env=env)


def _cfg_yaml(exp_dir, exp_name, info):
    return ("exp: {project_name: p, exp_name: %s, exp_dir: %s, seed: 0}\n"
            "data: {info_dir: %s}\n"
            "render: {type: endosurf, n_samples: 16, n_importance: 16, up_sample_steps: 2}\n"
            "train: {n_iter: 1, matmul_precision: highest, sampling_precision: highest,\n"
            "        optim: {lr: 0.0005}}\n"
            "net:\n"
            "  deform_network: {n_layers: 9, hidden_dim: 64, skips: [4], out_dim: 3}\n"
            "  sdf_network: {n_layers: 9, hidden_dim: 64, skips: [4], out_dim: 65}\n"
            "  color_network: {n_layers: 9, hidden_dim: 64, skips: [4], feat_dim: 64,"
            " out_dim: 3}\n"
            "demo: {ray_batch: 96, marching_cubes_resolution: 40}\n" % (exp_name, exp_dir, info))


def test_cli_test_3d_matches_jax(tmp_path):
    from endosurf_tpu.config import load_config
    from endosurf_tpu.data.scene_data import make_synthetic_scene
    from endosurf_tpu.train.checkpoint import save_checkpoint
    from endosurf_tpu.train.trainer_endosurf import EndoSurfTrainer
    from endosurf_tpu_torch.bridge import save_params_npz
    from endosurf_tpu_torch.utils.ply import read_ply

    info = make_synthetic_scene(str(tmp_path / "scene"), n_frames=4, h=12, w=16)
    logs = tmp_path / "logs"
    (tmp_path / "jax.yml").write_text(_cfg_yaml(logs, "jax", info))
    (tmp_path / "port.yml").write_text(_cfg_yaml(logs, "port", info))
    trainer = EndoSurfTrainer(load_config(str(tmp_path / "jax.yml")), mode="train")
    save_checkpoint(trainer.exp_dir, 1, *trainer.checkpoint_state())
    npz = str(tmp_path / "p.npz")
    save_params_npz(npz, jax.device_get(trainer.params), step=1)

    proc = _run(["-m", "endosurf_tpu", "--cfg", str(tmp_path / "jax.yml"), "--mode", "test_3d",
                 "--platform", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    proc = _run(["-m", "endosurf_tpu_torch", "--cfg", str(tmp_path / "port.yml"), "--mode",
                 "test_3d", "--params", npz, "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("DEMO|")][-1]
    assert line.startswith("DEMO|geo_err_mean:") and "psnr" not in line

    out = {}
    for name in ("jax", "port"):
        (d3,) = glob.glob(str(logs / "p" / f"{name}-*" / "demo" / "iter_00000001" /
                              "test_3d_thresh_0_res_40"))
        for kind in ("geometry", "color", "normal", "gt"):
            assert osp.exists(osp.join(d3, f"000_{kind}.ply")), (name, kind)
        with open(osp.join(d3, "stats_out.txt")) as f:
            mean = float(f.readline().split(":")[1])
        out[name] = (mean, len(read_ply(osp.join(d3, "000_geometry.ply"))[0]))
    (m_j, n_j), (m_t, n_t) = out["jax"], out["port"]
    assert np.isfinite(m_t) and n_t > 0
    assert abs(n_t - n_j) <= 0.01 * n_j, out
    assert abs(m_t - m_j) <= 1e-3 * abs(m_j), out
