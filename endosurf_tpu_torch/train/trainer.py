"""Base trainer: experiment directory, resume, the train loop with its eval,
save and log cadence (port of ``endosurf_tpu/train/trainer.py``).

Subclasses provide ``setup``, ``train_step``, ``eval`` and the checkpoint
state. The loop runs one optimizer step per ``train_step`` call;
``train.steps_per_call`` > 1 loops over steps inside a window, as the JAX
base class does (eval steps start their own window). ``train.profile``
opens a ``torch.profiler`` window over given steps.

Under a process group (``parallel``) every rank runs the steps, the evals and
the resume load; only the main rank writes (``cfg.yml``, checkpoints, the
metrics log and tensorboard, images, meshes, the profile trace), and every
rank waits at a barrier after each checkpoint write.
"""

from __future__ import annotations

import os
import os.path as osp
import time
from typing import Any, Dict, Optional, Union

import torch

from endosurf_tpu_torch.config import load_config, save_config
from endosurf_tpu_torch.data.scene_data import SceneData
from endosurf_tpu_torch.parallel import distributed
from endosurf_tpu_torch.parallel.mesh import make_mesh
from endosurf_tpu_torch.serve import resolve_device
from endosurf_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from endosurf_tpu_torch.train.logging import MetricsWriter


class Trainer:
    def __init__(self, cfg: Union[str, Dict[str, Any]], mode: str = "train",
                 scene: Optional[SceneData] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg = load_config(cfg)
        self.mode = mode
        self.device = resolve_device(device)
        if scene is None:
            data_cfg = cfg["data"]
            scene = SceneData.load(data_cfg["info_dir"],
                                   normalize_time=data_cfg.get("normalize_time", True),
                                   device=self.device)
        self.scene = scene

        exp_cfg = cfg["exp"]
        self.proj_name = exp_cfg["project_name"]
        self.exp_name = f"{exp_cfg['exp_name']}-{scene.dset_name}-{scene.scene_name}"
        self.exp_dir = osp.join(exp_cfg.get("exp_dir", "logs/"), self.proj_name,
                                self.exp_name)
        os.makedirs(self.exp_dir, exist_ok=True)

        self.train_cfg = cfg["train"]
        self.n_iter = self.train_cfg["n_iter"]
        self.resume = self.train_cfg.get("resume", False)
        log_cfg = cfg.get("log", {})
        self.i_eval = log_cfg.get("i_eval", 20000)
        self.i_save = log_cfg.get("i_save", 2500)
        self.step_start = 1
        self.writer: Optional[MetricsWriter] = None
        self.profile_trace: Optional[str] = None
        self.is_main = distributed.is_main_process()
        self.mesh = make_mesh(cfg.get("parallel", {}).get("data_parallel", False), self.device)

        self.setup()

        if mode != "train":
            restored = load_checkpoint(self.exp_dir, self.device)
            if restored is None:
                raise FileNotFoundError(f"no checkpoint found in {self.exp_dir}")
            self.restore(restored)
        else:
            if self.is_main:
                save_config(cfg, osp.join(self.exp_dir, "cfg.yml"))
            if self.resume:
                restored = load_checkpoint(self.exp_dir, self.device)
                if restored is not None:
                    self.restore(restored)
            if self.is_main:
                self.writer = MetricsWriter(self.exp_dir, cfg,
                                            backend=log_cfg.get("summary_writer", {})
                                            .get("type", "tensorboard"))

    # -- subclass interface -------------------------------------------------
    def setup(self) -> None:
        raise NotImplementedError

    def restore(self, restored: Dict[str, Any]) -> None:
        raise NotImplementedError

    def checkpoint_state(self):
        """(params, opt_state) to persist."""
        raise NotImplementedError

    def train_step(self, step: int) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def train_step_window(self, step: int, kk: int) -> Dict[str, torch.Tensor]:
        """Steps [step, step + kk - 1]; the last step's metrics."""
        metrics: Dict[str, torch.Tensor] = {}
        for s in range(step, step + kk):
            metrics = self.train_step(s)
        return metrics

    def window_boundaries(self):
        """Steps that must start a window (subclass hook)."""
        return ()

    def eval(self, step: int) -> Dict[str, float]:
        raise NotImplementedError

    # -- profile window -----------------------------------------------------
    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof, first: int, last: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out_dir = osp.join(self.exp_dir, "profile")
        os.makedirs(out_dir, exist_ok=True)
        self.profile_trace = osp.join(out_dir, f"trace_steps_{first}_{last}.json")
        prof.export_chrome_trace(self.profile_trace)
        print(f"PROFILE|steps:{first}-{last}|trace:{self.profile_trace}", flush=True)

    # -- main loop ----------------------------------------------------------
    def start(self, log_every: int = 100, stop_after: Optional[int] = None) -> None:
        """Train from ``step_start`` to ``n_iter`` (or pause after
        ``stop_after``, saving a checkpoint there; resume with
        ``train.resume``). Evals run before the step they are due at: step
        1, every ``log.i_eval``, and ``n_iter``.

        ``train.profile: {start: N, stop: M}`` records a ``torch.profiler``
        trace from before the window that holds step N (its eval included)
        to after the one that holds step M, the device synchronised first,
        and exports it as a Chrome trace under ``<exp_dir>/profile/``
        (``self.profile_trace``)."""
        t0 = time.time()
        rays_done = 0
        ray_batch = self.train_cfg.get("ray_batch", 1024)
        prof_cfg = self.train_cfg.get("profile") or {}
        prof_start, prof_stop = prof_cfg.get("start", 0), prof_cfg.get("stop", 0)
        prof = None
        end = self.n_iter if stop_after is None else min(stop_after, self.n_iter)
        K = max(1, int(self.train_cfg.get("steps_per_call", 1)))

        def in_window(cadence, a, b):
            """Is some multiple of ``cadence`` within [a, b]?"""
            return cadence > 0 and (b // cadence) > ((a - 1) // cadence)

        def eval_boundaries(step):
            if self.i_eval <= 0:
                return ()
            return ((step // self.i_eval + 1) * self.i_eval, self.n_iter)

        step = self.step_start
        while step <= end:
            kk = min(K, end - step + 1)
            for bnd in (*self.window_boundaries(), *eval_boundaries(step)):
                if step < bnd <= step + kk - 1:
                    kk = bnd - step
            s_last = step + kk - 1

            if prof_start and step <= prof_start <= s_last and self.is_main:
                prof = self._start_profile()
            if self.i_eval > 0 and (step == 1 or step % self.i_eval == 0
                                    or step == self.n_iter):
                self.eval(step)

            metrics = self.train_step_window(step, kk)
            rays_done += ray_batch * kk
            if prof is not None and prof_stop and step <= prof_stop <= s_last:
                self._stop_profile(prof, prof_start, prof_stop)
                prof = None

            if self.writer is not None and (step == 1 or in_window(log_every, step, s_last)):
                # metrics stay on the device until a log point
                metrics = {k: float(v) for k, v in metrics.items()}
                self.writer.add_scalars("train", metrics, s_last)
                if hasattr(self, "lr_schedule"):
                    self.writer.add_scalar("train/lr", self.lr_schedule(s_last - 1), s_last)
                dt = time.time() - t0
                self.writer.add_scalar("perf/rays_per_sec", rays_done / dt, s_last)
                if in_window(log_every * 10, step, s_last):
                    print(f"TRAIN|iter:{s_last}/{self.n_iter}"
                          f"|loss:{metrics.get('loss_total', float('nan')):.5g}"
                          f"|rays/s:{rays_done / dt:,.0f}", flush=True)

            if self.i_save > 0 and (in_window(self.i_save, step, s_last)
                                    or s_last in (self.n_iter, end)):
                if self.is_main:
                    params, opt_state = self.checkpoint_state()
                    path = save_checkpoint(self.exp_dir, s_last, params, opt_state)
                    print(f"SAVE|iter:{s_last}/{self.n_iter}|path:{path}", flush=True)
                distributed.barrier()
            step = s_last + 1
        if prof is not None:   # the window outlasted the run
            self._stop_profile(prof, prof_start, end)
        self.step_start = end + 1
        if self.writer is not None:
            self.writer.flush()
        if self.is_main:
            print("Training complete!" if end == self.n_iter
                  else f"Paused at {end}/{self.n_iter}.", flush=True)
