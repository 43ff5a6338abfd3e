"""The port trainer's image and profile surface on the CPU: the
``train.profile`` window writes a Chrome trace of its steps;
``MetricsWriter.add_image`` / ``add_video`` / ``add_mesh`` write
tensorboardX events (skipped without tensorboardX); an eval writes its
first result panel to the writer, as the JAX package's eval does.
"""

import glob
import json
import os.path as osp
import struct

import numpy as np
import pytest

from endosurf_tpu_torch.data.scene_data import make_synthetic_arrays
from endosurf_tpu_torch.train.logging import MetricsWriter
from endosurf_tpu_torch.train.trainer_endosurf import EndoSurfTrainer


def _net(width, feat):
    enc = {"multires": 2}
    return {"deform_network": {"n_layers": 3, "hidden_dim": width, "skips": [], "out_dim": 3,
                               "enc_pos_cfg": enc, "enc_time_cfg": enc},
            "sdf_network": {"n_layers": 3, "hidden_dim": width, "skips": [],
                            "out_dim": feat + 1, "enc_pos_cfg": enc},
            "color_network": {"n_layers": 3, "hidden_dim": width, "skips": [],
                              "feat_dim": feat, "out_dim": 3, "enc_pos_cfg": enc,
                              "enc_dir_cfg": enc}}


def _cfg(exp_dir, n_iter, profile=None, i_eval=0):
    train = {"n_iter": n_iter, "ray_batch": 16, "matmul_precision": "highest",
             "sampling_precision": "highest", "optim": {"lr": 5e-4, "warm_up_end": 2},
             "eval": {"ray_chunk": 96}}
    if profile is not None:
        train["profile"] = profile
    return {"exp": {"project_name": "p", "exp_name": "e", "exp_dir": str(exp_dir), "seed": 0},
            "render": {"type": "endosurf", "anneal_end": 50, "n_samples": 8,
                       "n_importance": 8, "up_sample_steps": 2},
            "train": train, "net": _net(16, 8), "log": {"i_eval": i_eval, "i_save": 0}}


def _events(log_dir):
    """(tag, value kind, step) of every summary value in the event files."""
    from tensorboardX.proto import event_pb2
    out = []
    for path in glob.glob(osp.join(log_dir, "events.out.tfevents.*")):
        data, i = open(path, "rb").read(), 0
        while i < len(data):
            n = struct.unpack("<Q", data[i:i + 8])[0]
            ev = event_pb2.Event.FromString(data[i + 12:i + 12 + n])
            i += 12 + n + 4
            out += [(v.tag, v.WhichOneof("value"), ev.step) for v in ev.summary.value]
    return out


def test_profile_window_writes_a_trace(tmp_path):
    """train.profile {start: 2, stop: 3} over 4 steps: one Chrome trace under
    <exp_dir>/profile/ holding the window's operators."""
    scene = make_synthetic_arrays(n_frames=3, h=8, w=8, seed=0)
    tr = EndoSurfTrainer(_cfg(tmp_path, 4, {"start": 2, "stop": 3}), scene=scene, device="cpu")
    tr.start(log_every=1)
    traces = glob.glob(osp.join(tr.exp_dir, "profile", "*.json"))
    assert traces == [tr.profile_trace]
    assert osp.basename(tr.profile_trace) == "trace_steps_2_3.json"
    with open(tr.profile_trace) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert any("autograd" in n.lower() or "backward" in n.lower() for n in names)


def test_profile_window_off_writes_nothing(tmp_path):
    scene = make_synthetic_arrays(n_frames=3, h=8, w=8, seed=0)
    tr = EndoSurfTrainer(_cfg(tmp_path, 2), scene=scene, device="cpu")
    tr.start(log_every=1)
    assert tr.profile_trace is None and not osp.exists(osp.join(tr.exp_dir, "profile"))


def test_writer_image_video_mesh(tmp_path):
    pytest.importorskip("tensorboardX")
    w = MetricsWriter(str(tmp_path))
    rng = np.random.default_rng(0)
    w.add_image("eval/results", (rng.uniform(size=(8, 12, 3)) * 255).astype(np.uint8), 3)
    w.add_video("demo/video", (rng.uniform(size=(4, 8, 12, 3)) * 255).astype(np.uint8), 3)
    w.add_mesh("demo/mesh", rng.uniform(size=(4, 3)).astype(np.float32), 3,
               colors=np.full((4, 3), 200, np.uint8), faces=np.array([[0, 1, 2], [0, 2, 3]]))
    w.add_scalar("train/loss", 0.5, 3)
    w.close()
    ev = _events(w.log_dir)
    assert ("eval/results", "image", 3) in ev
    assert any(tag == "demo/video" and step == 3 for tag, _, step in ev)  # empty without moviepy
    assert {t for t, kind, _ in ev if t.startswith("demo/mesh") and kind == "tensor"} \
        == {"demo/mesh_1", "demo/mesh_2", "demo/mesh_3"}


def test_writer_without_tensorboard_does_nothing(tmp_path):
    w = MetricsWriter(str(tmp_path), backend="none")
    w.add_image("x", np.zeros((4, 4, 3), np.uint8), 1)
    w.add_video("v", np.zeros((2, 4, 4, 3), np.uint8), 1)
    w.add_mesh("m", np.zeros((3, 3), np.float32), 1)
    w.close()
    assert glob.glob(osp.join(w.log_dir, "events.out.tfevents.*")) == []


def test_eval_writes_its_first_panel(tmp_path):
    pytest.importorskip("tensorboardX")
    pytest.importorskip("imageio")
    scene = make_synthetic_arrays(n_frames=4, h=16, w=16, seed=1)
    tr = EndoSurfTrainer(_cfg(tmp_path, 1, i_eval=1), scene=scene, device="cpu")
    stats = tr.eval(1)
    tr.writer.close()
    assert np.isfinite(list(stats.values())).all()
    ev = _events(tr.writer.log_dir)
    assert ("eval/results", "image", 1) in ev
    assert ("eval/psnr_rgb_vr", "simple_value", 1) in ev
    assert osp.exists(osp.join(tr.exp_dir, "eval", "iter_00000001", "eval_000.png"))
