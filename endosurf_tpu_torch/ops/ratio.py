"""A masked mean kept as its parts: a numerator and a count.

The losses, the Eikonal term and the auxiliary errors build their masked
means as :class:`Ratio` values; ``parallel.mesh.global_means`` resolves them,
dividing at once without a data mesh and by the global count with one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch


def plus(eps: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """The divisor ``den + eps`` (the masked means' usual guard)."""
    return lambda den: den + eps


def as_is(den: torch.Tensor) -> torch.Tensor:
    """The divisor ``den`` itself (a plain mean over a count that is never 0)."""
    return den


@dataclasses.dataclass
class Ratio:
    """A masked mean kept as this rank's parts, ``num / div(den)``: the
    numerator (differentiable) and the count, with ``div`` the mean's guard
    on the count (``plus(eps)``, or a clamp)."""
    num: torch.Tensor
    den: torch.Tensor
    div: Callable[[torch.Tensor], torch.Tensor] = plus(1e-10)

    def value(self) -> torch.Tensor:
        return self.num / self.div(self.den)


Term = Union[torch.Tensor, Ratio]
