"""Data parallelism over the ray axis (port of ``endosurf_tpu/parallel/mesh.py``).

JAX shards the ray batch over a 1-D ("data",) device mesh, keeps the
parameters replicated, and lets XLA turn every masked global sum of the loss
into a psum. The port runs one process a rank (``parallel.distributed``) and
does the same by hand:

* every rank samples the same global batch and keeps its contiguous rows
  (``shard_ray_batch``; an uneven batch splits as ``tensor_split`` does);
* every masked mean is an ``ops.ratio.Ratio`` of a local sum and a local count; the
  step all-reduces the counts, with the sums for the reported metrics, in one
  small vector (``global_means``), so each rank's loss is its share of the
  global mean;
* the gradients are all-reduced once, one flat bucket, SUMMED
  (``all_reduce_grads``): the sum of the ranks' shares is JAX's gradient of
  the global loss. Averaging per-rank means instead (DDP's default) differs
  whenever the masks differ across the shards;
* eval and grid rows come back to every rank in rank order (``gather_rows``,
  the counterpart of ``constrain_axis0`` + ``replicate_outputs``), through
  broadcasts, which Gloo carries for CUDA tensors too (it has no all-gather
  for them).

Without a group nothing here communicates, and :func:`global_means` divides
as the single-process code always did.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from endosurf_tpu_torch.ops.ratio import Ratio, Term
from endosurf_tpu_torch.parallel import distributed


def split_sizes(n: int, world: int) -> List[int]:
    """Rows of each rank when ``n`` rows split over ``world`` ranks
    (``tensor_split``: the first ``n % world`` ranks take one more)."""
    return [n // world + (1 if r < n % world else 0) for r in range(world)]


def shard_rows(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous rows of ``x``."""
    return x.tensor_split(world)[rank]


def shard_ray_batch(batch: Dict[str, Any], rank: int, world: int) -> Dict[str, Any]:
    """This rank's rows of every per-ray tensor of ``batch``; scalars (0-d
    tensors such as ``frame_id``, and non-tensors) stay whole."""
    return {k: shard_rows(v, rank, world) if torch.is_tensor(v) and v.ndim >= 1 else v
            for k, v in batch.items()}


def gather_rows(part: torch.Tensor, n: int, rank: int, world: int) -> torch.Tensor:
    """Every rank's rows of an [n, ...] tensor, each rank holding its
    ``shard_rows`` share as ``part``, on every rank in rank order (bit for
    bit: one broadcast a rank)."""
    sizes = split_sizes(n, world)
    if part.shape[0] != sizes[rank]:
        raise ValueError(f"rank {rank} holds {part.shape[0]} rows of {n}, expected "
                         f"{sizes[rank]}")
    out = part.new_empty((n,) + tuple(part.shape[1:]))
    start = 0
    for r, size in enumerate(sizes):
        rows = out[start:start + size]
        if r == rank:
            rows.copy_(part)
        if size:
            dist.broadcast(rows, src=r)
        start += size
    return out


def all_reduce_grads(params: Iterable[torch.Tensor]) -> None:
    """Sum every parameter's ``.grad`` over the ranks in one flat bucket (in
    place). Parameters without a gradient are skipped; every rank runs the same
    graph, so they are the same on every rank."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    start = 0
    for g in grads:
        g.copy_(flat[start:start + g.numel()].view_as(g))
        start += g.numel()


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The data-parallel group a step runs on: this process's ``rank`` of
    ``world`` (the counterpart of JAX's ("data",) mesh)."""
    rank: int
    world: int

    def shard(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        return shard_ray_batch(batch, self.rank, self.world)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        return shard_rows(x, self.rank, self.world)

    def gather(self, part: torch.Tensor, n: int) -> torch.Tensor:
        return gather_rows(part, n, self.rank, self.world)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce ``t`` in place (summed) and return it."""
        dist.all_reduce(t)
        return t


def make_mesh(data_parallel: bool, device: Union[str, torch.device]) -> Optional[DataMesh]:
    """The run's data mesh: the process group's ranks when one is initialized
    and ``parallel.data_parallel`` is on, or the group has more than one rank
    (as JAX, which always shards across processes); else None, one process on
    one device. ``data_parallel`` without a group on a machine with more than
    one visible card raises: the port runs a rank a card, and one process
    never uses the others silently."""
    if distributed.is_initialized() and (data_parallel or distributed.process_count() > 1):
        return DataMesh(distributed.rank(), distributed.process_count())
    n_cards = torch.cuda.device_count() if torch.device(device).type == "cuda" else 0
    if data_parallel and n_cards > 1:
        raise RuntimeError(f"parallel.data_parallel with {n_cards} cards runs a process a "
                           f"card: launch with torchrun --nproc_per_node={n_cards} -m "
                           "endosurf_tpu_torch ...")
    return None


def row_parallel(fn: Callable[..., torch.Tensor], mesh: Optional[DataMesh]
                 ) -> Callable[..., torch.Tensor]:
    """``fn(*row_tensors) -> [N, ...]`` with each rank evaluating its rows and
    every rank getting all N (``fn`` itself without a mesh): the grid slabs
    and vertex colours of the 3D demo."""
    if mesh is None:
        return fn

    def sharded(*xs: torch.Tensor) -> torch.Tensor:
        return mesh.gather(fn(*(mesh.rows(x) for x in xs)).contiguous(), xs[0].shape[0])
    return sharded


# ---------------------------------------------------------------------------
# global masked means
# ---------------------------------------------------------------------------

def global_means(terms: Dict[str, Term], mesh: Optional[DataMesh]
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(shares, values) of ``terms``: a tensor term is both; a Ratio's share
    is this rank's numerator over the global count, differentiable (the
    ranks' shares sum to the global mean), and its value the global mean,
    detached. Without a mesh both are ``num / div(den)``, the single-process
    expression. With one, the counts and numerators go in one vector and one
    all-reduce (the counts detached: no mask carries a gradient)."""
    ratios = [k for k, v in terms.items() if isinstance(v, Ratio)]
    if mesh is None or not ratios:
        out = {k: v.value() if isinstance(v, Ratio) else v for k, v in terms.items()}
        return out, out
    vec = torch.stack([terms[k].den.detach().float() for k in ratios]
                      + [terms[k].num.detach().float() for k in ratios])
    mesh.sum_(vec)
    shares = dict(terms)
    values = dict(terms)
    for i, k in enumerate(ratios):
        r = terms[k]
        div = r.div(vec[i])
        shares[k] = r.num / div
        values[k] = vec[len(ratios) + i] / div
    return shares, values
