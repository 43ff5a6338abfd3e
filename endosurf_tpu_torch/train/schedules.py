"""The learning-rate schedules (port of ``endosurf_tpu/train/schedules.py``):
EndoSurf's warmup + cosine, EndoNeRF's exponential decay.

Plain functions of the optimizer's update count: the first update (count
0) runs at ``schedule(0)``, as optax's does; both start from step 1's
factor (count + 1).
"""

from __future__ import annotations

import math
from typing import Callable


def warmup_cosine(lr_init: float, warm_up_end: int, n_iter: int,
                  alpha: float) -> Callable[[int], float]:
    """Linear warmup to ``lr_init`` over ``warm_up_end`` steps, then cosine
    decay to ``alpha * lr_init`` at ``n_iter``."""
    def schedule(count: int) -> float:
        step = count + 1.0
        if step < warm_up_end:
            return lr_init * step / warm_up_end
        progress = min(max((step - warm_up_end) / max(n_iter - warm_up_end, 1), 0.0), 1.0)
        return lr_init * ((math.cos(math.pi * progress) + 1.0) * 0.5 * (1 - alpha) + alpha)
    return schedule


def exponential(lr_init: float, lr_decay_k: float,
                decay_rate: float = 0.1) -> Callable[[int], float]:
    """``lr_init * decay_rate ** (step / (lr_decay_k * 1000))``."""
    decay_steps = lr_decay_k * 1000.0

    def schedule(count: int) -> float:
        return lr_init * decay_rate ** ((count + 1.0) / decay_steps)
    return schedule
