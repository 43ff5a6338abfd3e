"""The multi-process runtime (port of ``endosurf_tpu/parallel/distributed.py``).

JAX brings up ``jax.distributed`` from ``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``; the port brings up a
``torch.distributed`` process group from the variables ``torchrun`` sets:
``MASTER_ADDR`` / ``MASTER_PORT`` (the rendezvous), ``WORLD_SIZE``, ``RANK``
and ``LOCAL_RANK`` (the card of this process). One process is one rank; data
parallelism over the ranks is ``parallel.mesh``.

Every rank samples the same global batch from the same seeded generator and
keeps its own rows, so no data moves between ranks; the gradient reduction is
one summed all-reduce a step (``mesh.all_reduce_grads``). Host-side writes
(config, checkpoints, logs, images, meshes) belong to the main rank
(``is_main_process``).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist


def initialize(backend: Optional[str] = None,
               device: Union[str, torch.device, None] = None) -> bool:
    """Join the process group that ``torchrun`` describes in the environment;
    a no-op returning False for one process (no ``WORLD_SIZE`` above 1) or
    when a group exists already.

    ``backend=None`` picks ``nccl`` for a CUDA ``device`` and ``gloo``
    otherwise. NCCL takes one card a rank: ranks that would share a card
    raise here (put two ranks on one card with ``backend="gloo"``)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or is_initialized():
        return False
    dev = torch.device(device if device is not None else "cpu")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        n_local, n_cards = int(os.environ.get("LOCAL_WORLD_SIZE", world)), torch.cuda.device_count()
        if n_local > n_cards:
            raise RuntimeError(f"NCCL needs one card a rank: {n_local} ranks on this host, "
                               f"{n_cards} visible card(s); pass backend='gloo' to share a card")
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ.get("MASTER_PORT", "29500")
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", world_size=world,
                            rank=int(os.environ["RANK"]))
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Ranks in the group (1 without one)."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if is_initialized() else 0


def local_rank() -> int:
    """This process's index on its host (``LOCAL_RANK``, 0 without one)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def is_main_process() -> bool:
    """True on the rank that owns host-side writes (rank 0, or no group):
    ranks sharing an experiment directory must not race on checkpoint
    renames or log appends."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (a no-op without a group)."""
    if is_initialized():
        dist.barrier()


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if is_initialized():
        dist.destroy_process_group()
