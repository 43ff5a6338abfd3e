"""Experiment logging: a JSONL metrics stream, plus TensorBoard when
``tensorboardX`` is importable (port of ``endosurf_tpu/train/logging.py``).

The JSONL file ``<exp_dir>/logs/metrics.jsonl`` is always written (scalars
only); tensorboardX is imported lazily and skipped where it is absent, and
the image, video and mesh methods then do nothing.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Any, Dict, Optional


class MetricsWriter:
    def __init__(self, exp_dir: str, config: Optional[Dict[str, Any]] = None,
                 backend: str = "tensorboard"):
        self.log_dir = osp.join(exp_dir, "logs")
        os.makedirs(self.log_dir, exist_ok=True)
        self._jsonl = open(osp.join(self.log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if backend == "tensorboard":
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(self.log_dir)
                if config is not None:
                    self._tb.add_text("config", json.dumps(config, indent=2, default=str), 0)

    def add_scalar(self, tag: str, value, step: int) -> None:
        v = float(value)
        self._jsonl.write(json.dumps({"tag": tag, "value": v, "step": step,
                                      "t": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, v, step)

    def add_scalars(self, prefix: str, metrics: Dict[str, Any], step: int) -> None:
        for k, v in metrics.items():
            self.add_scalar(f"{prefix}/{k}", v, step)

    def add_image(self, tag: str, img, step: int) -> None:
        """An [H, W, 3] image (uint8, or float in [0, 1])."""
        if self._tb is not None:
            self._tb.add_image(tag, img, step, dataformats="HWC")

    def add_video(self, tag: str, video, step: int, fps: int = 10) -> None:
        """A [T, H, W, 3] uint8 clip."""
        if self._tb is not None:
            self._tb.add_video(tag, video.transpose(0, 3, 1, 2)[None], step, fps=fps)

    def add_mesh(self, tag: str, vertices, step: int, colors=None, faces=None) -> None:
        """A mesh: vertices [N, 3], colors [N, 3] (uint8), faces [M, 3]."""
        if self._tb is not None:
            self._tb.add_mesh(tag, vertices[None],
                              colors=None if colors is None else colors[None],
                              faces=None if faces is None else faces[None], global_step=step)

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
