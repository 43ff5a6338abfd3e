"""The port stands alone: importing it loads neither JAX nor the JAX package,
and no source of it names a file of the JAX package; its CUDA entry refuses
CPU tensors; the CLI serves a scene on the CPU and raises, rather than
falling back, when CUDA is asked for and absent.
"""

import os
import os.path as osp
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
PKG = osp.join(REPO, "endosurf_tpu_torch")


def _run(code_or_args, timeout=300, **kw):
    args = ([sys.executable, "-c", code_or_args] if isinstance(code_or_args, str)
            else [sys.executable, *code_or_args])
    env = {**os.environ, "PYTHONPATH": REPO}
    return subprocess.run(args, capture_output=True, text=True, cwd=kw.get("cwd", REPO),
                          timeout=timeout, env=env)


def test_import_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import endosurf_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'endosurf_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'endosurf_tpu' or m.startswith('endosurf_tpu.')]\n"
        "assert len(names) >= 20, names\n"
        "assert {'endosurf_tpu_torch.native.meshops', 'endosurf_tpu_torch.utils.ply',\n"
        "        'endosurf_tpu_torch.evaluation.geometry3d',\n"
        "        'endosurf_tpu_torch.kernels.fused_sdf',\n"
        "        'endosurf_tpu_torch.models.endonerf',\n"
        "        'endosurf_tpu_torch.kernels.fused_render_dnerf',\n"
        "        'endosurf_tpu_torch.kernels.fused_train_dnerf',\n"
        "        'endosurf_tpu_torch.train.trainer_endonerf',\n"
        "        'endosurf_tpu_torch.data.preprocess_common',\n"
        "        'endosurf_tpu_torch.data.preprocess_endonerf',\n"
        "        'endosurf_tpu_torch.data.preprocess_scared',\n"
        "        'endosurf_tpu_torch.evaluation.lpips_torch'} <= set(names), names\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


def test_preprocessing_and_lpips_import_no_image_library():
    """The preprocessing, LPIPS and the native wrappers import neither JAX nor
    imageio nor OpenCV: the card machine has none of them."""
    code = (
        "import sys\n"
        "import endosurf_tpu_torch.data.preprocess_endonerf\n"
        "import endosurf_tpu_torch.data.preprocess_scared\n"
        "import endosurf_tpu_torch.evaluation.lpips_torch\n"
        "from endosurf_tpu_torch.native import nn_distance_excl_self, radius_outlier_mask\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'endosurf_tpu', 'imageio', 'cv2')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


def test_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|endosurf_tpu)\b", re.M)
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = osp.join(root, f)
                with open(path) as fh:
                    if pattern.search(fh.read()):
                        offenders.append(path)
    assert not offenders, offenders


def _code_strings(source: str):
    """The string constants of Python source that are not docstrings."""
    import ast
    tree = ast.parse(source)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


def test_sources_name_no_jax_package_file():
    """No source of the port (.py, .cu, .cuh, .cpp) points its code at a file
    of the JAX package: no string in Python code and no C++ line outside a
    comment (an #include among them) holds a path under endosurf_tpu/.
    Docstrings and comments may cite the JAX code a module ports."""
    path_re = re.compile(r"(^|[^\w])endosurf_tpu[/\\]")
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            path = osp.join(root, f)
            if f.endswith(".py"):
                strings = _code_strings(open(path).read())
                if any(path_re.search(s) or s == "endosurf_tpu" for s in strings):
                    offenders.append(path)
            elif f.endswith((".cu", ".cuh", ".cpp")):
                code = re.sub(r"/\*.*?\*/", "", open(path).read(), flags=re.S)
                if any(path_re.search(line.split("//")[0]) for line in code.splitlines()):
                    offenders.append(path)
    assert not offenders, offenders
    # the check sees a path in code, a C++ include and a path join
    for text in ('x = "endosurf_tpu/native/geometry.cpp"\n',
                 'p = osp.join(REPO, "endosurf_tpu", "native")\n'):
        strings = _code_strings(text)
        assert any(path_re.search(s) or s == "endosurf_tpu" for s in strings), text
    assert path_re.search('#include "../../endosurf_tpu/native/geometry.cpp"'.split("//")[0])


def test_dnerf_cuda_entries_refuse_cpu_tensors():
    from endosurf_tpu_torch.kernels import fused_render_dnerf as frd
    from endosurf_tpu_torch.kernels import fused_sdf as fsd
    from endosurf_tpu_torch.kernels import fused_train_dnerf as ftd
    from endosurf_tpu_torch.models.endonerf import DNeRFRenderSpec, DNeRFSpec, init_dnerf_params
    spec = DNeRFSpec(deform_layers=(3, 32, (1,)), density_layers=(3, 32, (1,)),
                     color_layers=(2, 32, ()), geo_feat_dim=16)
    params = init_dnerf_params(spec)
    with pytest.raises(ValueError, match="CUDA"):
        frd.fused_render_rays_dnerf_cuda(spec, DNeRFRenderSpec(), params, torch.zeros(8, 9))
    with pytest.raises(ValueError, match="CUDA"):
        fsd.fused_density_raw_cuda(spec, params, torch.zeros(8, 3), torch.zeros(8, 1))
    packed = ftd.pack_dnerf(spec, params, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        ftd.dnerf_deform_fwd(packed, torch.zeros(8, 4))
    eff = ftd.prepare_effective_dnerf(spec, params)
    for seg, args in (("deform", (torch.zeros(8, 4), torch.zeros(8, 3))),
                      ("density", (torch.zeros(8, 3), torch.zeros(8, 1), torch.zeros(8, 16))),
                      ("color", (torch.zeros(8, 3), torch.zeros(8, 16), torch.zeros(8, 3)))):
        with pytest.raises(ValueError, match="CUDA"):
            ftd.BWD[seg](packed, ftd.segment_weights(eff, seg)[0], *args)
    from endosurf_tpu_torch.kernels import fused_sampler as fs
    with pytest.raises(ValueError, match="CUDA"):
        fs.fused_fine_resample_cuda(torch.zeros(8, 64), torch.zeros(8, 64), torch.ones(8, 1))
    with pytest.raises(ValueError):
        frd.fused_render_rays_dnerf(spec, DNeRFRenderSpec(), params, torch.zeros(8, 9, device="meta"))


def test_cuda_entry_refuses_cpu_tensors():
    from endosurf_tpu_torch.kernels import fused_render as fr
    from endosurf_tpu_torch.models.fields import EndoSurfSpec, init_endosurf_params
    spec = EndoSurfSpec()
    params = init_endosurf_params(spec)
    rays = torch.zeros(8, 9)
    with pytest.raises(ValueError, match="CUDA"):
        fr.fused_render_rays_cuda(spec, params, rays, 0.0, 32, 32, 4, 50000.0)
    with pytest.raises(ValueError):
        fr.fused_render_rays(spec, params, rays.to("meta"), 0.0, 32, 32, 4, 50000.0)
    assert fr.cuda_spec_supported(spec)
    assert not fr.cuda_spec_supported(
        EndoSurfSpec(sdf=spec.sdf.__class__(10, 256, (4,), 257)))


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from endosurf_tpu_torch.serve import resolve_device
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    for mode in ("test_2d", "test_3d"):
        proc = _run(["-m", "endosurf_tpu_torch", "--cfg", "none.yml", "--mode", mode,
                     "--device", "cuda"])
        assert proc.returncode != 0 and "CUDA is not available" in proc.stderr, mode


def test_cli_unported_mode_raises(tmp_path):
    """Every CLI mode is ported for both render types (EndoNeRF training in
    tests/test_torch_train_dnerf.py); --mode train on a render type the port
    does not know raises."""
    cfg = tmp_path / "cfg.yml"
    cfg.write_text("exp: {project_name: p, exp_name: e, exp_dir: %s}\n"
                   "render: {type: neus}\nnet: {}\ndata: {info_dir: none.pkl}\n"
                   % (tmp_path / "logs"))
    proc = _run(["-m", "endosurf_tpu_torch", "--cfg", str(cfg), "--mode", "train",
                 "--device", "cpu"])
    assert proc.returncode != 0
    assert "unknown render type 'neus'" in proc.stderr


def test_config_inherit_and_dict(tmp_path):
    from endosurf_tpu_torch.config import load_config
    parent = tmp_path / "parent.yml"
    parent.write_text("a: {b: 1, c: 2}\nd: 3\n")
    child = tmp_path / "child.yml"
    child.write_text("inherit_from: parent.yml\na: {c: 5}\n")
    cfg = load_config(str(child))
    assert cfg == {"a": {"b": 1, "c": 5}, "d": 3}
    copied = load_config(cfg)
    assert copied == cfg and copied is not cfg


def test_cli_test_2d_on_cpu(tmp_path):
    """python -m endosurf_tpu_torch --mode test_2d on a tiny scene loaded from
    an info pkl, with params from an npz, on the CPU: metrics and composites."""
    from endosurf_tpu_torch.bridge import save_params_npz
    from endosurf_tpu_torch.models.fields import EndoSurfSpec, MLPSpec, init_endosurf_params
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from endosurf_tpu.data.scene_data import make_synthetic_scene\n"
            "print(make_synthetic_scene(%r, n_frames=4, h=12, w=16))\n") % (REPO, str(tmp_path / "scene"))
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    info = proc.stdout.strip().splitlines()[-1]

    cfg = tmp_path / "cfg.yml"
    cfg.write_text(
        "exp: {project_name: p, exp_name: e, exp_dir: %s, seed: 0}\n"
        "data: {info_dir: %s}\n"
        "render: {type: endosurf, n_samples: 32, n_importance: 32, up_sample_steps: 4}\n"
        "train: {matmul_precision: highest, sampling_precision: highest}\n"
        "net:\n"
        "  deform_network: {n_layers: 9, hidden_dim: 64, skips: [4], out_dim: 3}\n"
        "  sdf_network: {n_layers: 9, hidden_dim: 64, skips: [4], out_dim: 65}\n"
        "  color_network: {n_layers: 9, hidden_dim: 64, skips: [4], feat_dim: 64, out_dim: 3}\n"
        "demo: {ray_batch: 96}\n" % (tmp_path / "logs", info))
    spec = EndoSurfSpec(deform=MLPSpec(9, 64, (4,), 3), sdf=MLPSpec(9, 64, (4,), 65),
                        color=MLPSpec(9, 64, (4,), 3), color_feat_dim=64)
    npz = str(tmp_path / "p.npz")
    save_params_npz(npz, init_endosurf_params(spec, torch.Generator().manual_seed(1)), step=40)
    proc = _run(["-m", "endosurf_tpu_torch", "--cfg", str(cfg), "--mode", "test_2d",
                 "--params", npz, "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("DEMO|")][-1]
    stats = dict(kv.split(":") for kv in line[len("DEMO|"):].split("|"))
    assert set(stats) == {"psnr_rgb_vr", "ssim_rgb_vr", "rmse_d_vr"}
    assert all(np.isfinite(float(v)) for v in stats.values())
    out = tmp_path / "logs" / "p" / "e-synthetic-pulsating_sphere" / "demo" / "iter_00000040"
    assert (out / "test_2d" / "stats_out.txt").exists()
    assert (out / "test_2d" / "000_all.png").exists() and (out / "test_2d" / "demo.gif").exists()
