"""The parameter bridge between the JAX package and the PyTorch port:
exact round trips, the init's tree structure, and the checkpoint export tool.
"""

import os.path as osp
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from endosurf_tpu.models import fields as j_fields
from endosurf_tpu.train.checkpoint import save_checkpoint
from endosurf_tpu_torch import bridge
from endosurf_tpu_torch.models import fields as t_fields

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _shapes(tree):
    return {k: tuple(np.shape(v)) for k, v in bridge.flatten(tree).items()}


def _assert_trees_equal(a, b):
    fa, fb = bridge.flatten(a), bridge.flatten(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=k)


@pytest.mark.parametrize("use_deform", [True, False])
def test_jax_npz_torch_roundtrip_exact(tmp_path, use_deform):
    spec = j_fields.EndoSurfSpec(use_deform=use_deform)
    pj = jax.device_get(j_fields.init_endosurf_params(jax.random.PRNGKey(2), spec))
    path = str(tmp_path / "p.npz")
    bridge.save_params_npz(path, pj, step=1234)
    pt, step = bridge.load_params_npz(path)
    assert step == 1234
    assert isinstance(pt["sdf_network"]["layers"], list)
    assert all(torch.is_tensor(v) and v.dtype == torch.float32
               for v in bridge.flatten(pt).values())
    _assert_trees_equal(bridge.params_to_numpy(pt), pj)
    _assert_trees_equal(bridge.params_to_numpy(bridge.params_from_jax(pj)), pj)


def test_npz_keys_are_flat_paths(tmp_path):
    spec = t_fields.EndoSurfSpec()
    params = t_fields.init_endosurf_params(spec, torch.Generator().manual_seed(0))
    path = str(tmp_path / "p.npz")
    bridge.save_params_npz(path, params)
    with np.load(path) as z:
        keys = set(z.files)
    assert "deform_network/layers/0/v" in keys
    assert "sdf_network/layers/8/g" in keys
    assert "deviation_network/variance" in keys
    assert bridge.STEP_KEY not in keys
    back, step = bridge.load_params_npz(path)
    assert step is None
    _assert_trees_equal(bridge.params_to_numpy(back), bridge.params_to_numpy(params))


@pytest.mark.parametrize("use_deform", [True, False])
def test_init_structure_matches_jax(use_deform):
    spec_j = j_fields.EndoSurfSpec(use_deform=use_deform)
    spec_t = t_fields.EndoSurfSpec(use_deform=use_deform)
    pj = j_fields.init_endosurf_params(jax.random.PRNGKey(0), spec_j)
    pt = t_fields.init_endosurf_params(spec_t, torch.Generator().manual_seed(0))
    assert _shapes(bridge.params_to_numpy(pt)) == _shapes(jax.device_get(pj))
    np.testing.assert_allclose(float(pt["deviation_network"]["variance"]), 0.3)


def test_spec_from_config_matches_jax():
    import yaml
    with open(osp.join(REPO, "configs", "endosurf", "base.yml")) as f:
        net = yaml.safe_load(f)["net"]
    sj = j_fields.EndoSurfSpec.from_config(net)
    st = t_fields.EndoSurfSpec.from_config(net)
    assert {k: getattr(st, k) for k in st.__dataclass_fields__ if k not in ("deform", "sdf", "color")} \
        == {k: getattr(sj, k) for k in sj.__dataclass_fields__ if k not in ("deform", "sdf", "color")}
    for k in ("deform", "sdf", "color"):
        assert tuple(getattr(st, k).__dict__.values()) == tuple(getattr(sj, k).__dict__.values())


def test_export_tool_roundtrip(tmp_path):
    """A checkpoint saved by the JAX trainer's checkpoint module comes out of
    tools/export_params_npz.py bit-exact, step included."""
    spec = j_fields.EndoSurfSpec()
    pj = j_fields.init_endosurf_params(jax.random.PRNGKey(5), spec)
    exp_dir = str(tmp_path / "exp")
    save_checkpoint(exp_dir, 777, pj, {"dummy": np.zeros(2, np.float32)})
    out = str(tmp_path / "exported.npz")
    proc = subprocess.run([sys.executable, osp.join(REPO, "tools", "export_params_npz.py"),
                           "--exp-dir", exp_dir, "--out", out],
                          capture_output=True, text=True, cwd=REPO, timeout=300,
                          env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    pt, step = bridge.load_params_npz(out)
    assert step == 777
    _assert_trees_equal(bridge.params_to_numpy(pt), jax.device_get(pj))
