"""The port's CLI under ``torchrun`` on the CPU: two Gloo ranks train a tiny
EndoSurf scene (``python -m torch.distributed.run --standalone
--nproc_per_node 2 -m endosurf_tpu_torch --mode train --device cpu``), then a
second run resumes. Only the main rank writes: one
``cfg.yml``, one checkpoint, one metrics log holding each step once."""

import json
import os
import os.path as osp
import re
import subprocess
import sys

import pytest

from endosurf_tpu_torch.config import save_config
from endosurf_tpu_torch.data.scene_data import make_synthetic_scene
from endosurf_tpu_torch.train.checkpoint import load_checkpoint

from test_torch_train import _tiny_cfg

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _torchrun(cfg_path: str):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--monitor-interval", "0.1",
                           "--nproc_per_node", "2", "-m", "endosurf_tpu_torch", "--cfg",
                           cfg_path, "--mode", "train", "--device", "cpu"],
                          capture_output=True, text=True, cwd=REPO, timeout=300, env=env)


def _dist_lines(out: str):
    # the two ranks print to one pipe, so their lines may interleave
    return sorted(re.findall(r"DIST\|rank \d+/\d+\|device (?:cpu|cuda:\d+)", out))


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """A tiny EndoSurf config over a synthetic scene (data_parallel on,
    i_save 2, an eval before every step, its frame split over the ranks);
    its first run trains steps 1-2 on two ranks.
    Returns (config, its path, the run's stdout, the experiment dir)."""
    root = tmp_path_factory.mktemp("torchrun")
    cfg = _tiny_cfg(root / "logs", n_iter=2)
    cfg["data"] = {"info_dir": make_synthetic_scene(str(root / "s"), n_frames=4, h=12, w=16)}
    cfg["log"] = {"i_eval": 1, "i_save": 2}
    cfg["parallel"] = {"data_parallel": True}
    cfg_path = str(root / "cfg.yml")
    save_config(cfg, cfg_path)
    proc = _torchrun(cfg_path)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    return cfg, cfg_path, proc.stdout, root / "logs" / "p" / "e-synthetic-pulsating_sphere"


def _logged(exp_dir):
    """{tag: [steps]} of metrics.jsonl, in the order written."""
    out = {}
    with open(exp_dir / "logs" / "metrics.jsonl") as f:
        for rec in map(json.loads, f):
            out.setdefault(rec["tag"], []).append(rec["step"])
    return out


def test_torchrun_train_writes_from_the_main_rank(exp):
    """Two ranks train steps 1-2: a DIST line from each rank, one SAVE line,
    one "Training complete!", one EVAL line a step, and one cfg.yml, one
    ckpt.pt (step 2, no backup, no temporary file) and metrics.jsonl with
    the evals of steps 1-2 and the train metrics of step 1 (the CLI logs
    train metrics at step 1 and every 100th), each once."""
    _, _, out, exp_dir = exp
    assert _dist_lines(out) == ["DIST|rank 0/2|device cpu", "DIST|rank 1/2|device cpu"], out
    assert out.count("SAVE|iter:2/2") == 1 and out.count("Training complete!") == 1, out
    assert out.count("EVAL|iter:1|") == 1 and out.count("EVAL|iter:2|") == 1, out
    assert sorted(os.listdir(exp_dir)) == ["cfg.yml", "ckpt.pt", "eval", "logs"]
    assert load_checkpoint(str(exp_dir))["n_iter"] == 2
    logged = _logged(exp_dir)
    assert logged["eval/psnr_rgb_vr"] == [1, 2] and logged["train/loss_total"] == [1]


def test_torchrun_resume_on_cpu(exp):
    """The same config with resume and n_iter 4: both ranks restore step 2
    and train 3-4; ckpt.pt holds step 4 (its backup step 2) and the metrics
    log the evals of steps 1-4 once each."""
    cfg, cfg_path, _, exp_dir = exp
    cfg["train"].update(n_iter=4, resume=True)
    save_config(cfg, cfg_path)
    proc = _torchrun(cfg_path)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    assert _dist_lines(proc.stdout) == ["DIST|rank 0/2|device cpu", "DIST|rank 1/2|device cpu"]
    assert proc.stdout.count("SAVE|iter:4/4") == 1, proc.stdout
    assert proc.stdout.count("SAVE|") == 1, proc.stdout
    assert sorted(os.listdir(exp_dir)) == ["cfg.yml", "ckpt.pt", "ckpt_backup.pt", "eval",
                                           "logs"]
    assert load_checkpoint(str(exp_dir))["n_iter"] == 4
    logged = _logged(exp_dir)
    assert logged["eval/psnr_rgb_vr"] == [1, 2, 3, 4] and logged["train/loss_total"] == [1]
