"""Torch-native checkpoints with the JAX package's crash-safety protocol
(port of ``endosurf_tpu/train/checkpoint.py``).

A checkpoint is one ``torch.save`` file ``<exp_dir>/ckpt.pt`` holding
``{"n_iter", "params", "opt_state"}``. A save writes ``ckpt.pt.tmp`` first,
moves the previous checkpoint to ``ckpt_backup.pt`` and then renames the new
one into place, so a crash at any point leaves a loadable file; loading
falls back to the backup. JAX (Orbax) checkpoints reach the port through the
npz bridge (``tools/export_params_npz.py``), not here.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Any, Dict, Optional

import torch

CKPT_NAME = "ckpt.pt"
BACKUP_NAME = "ckpt_backup.pt"


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree) if torch.is_tensor(tree) else tree


def save_checkpoint(exp_dir: str, step: int, params: Dict[str, Any],
                    opt_state: Any) -> str:
    """Write {n_iter, params, opt_state}; keep the previous file as backup."""
    ckpt = osp.join(exp_dir, CKPT_NAME)
    backup = osp.join(exp_dir, BACKUP_NAME)
    tmp = ckpt + ".tmp"
    torch.save({"n_iter": int(step), "params": _map(params, torch.Tensor.detach),
                "opt_state": opt_state}, tmp)
    if osp.exists(ckpt):
        os.replace(ckpt, backup)
    os.replace(tmp, ckpt)
    return ckpt


def load_checkpoint(exp_dir: str, device: Any = "cpu") -> Optional[Dict[str, Any]]:
    """The latest checkpoint (falling back to the backup), or None when there
    is none. The params are moved to ``device``; the optimizer state stays on
    the CPU (``Optimizer.load_state_dict`` moves it to its parameters)."""
    for name in (CKPT_NAME, BACKUP_NAME):
        path = osp.join(exp_dir, name)
        if osp.exists(path):
            restored = torch.load(path, map_location="cpu", weights_only=True)
            restored["params"] = _map(restored["params"], lambda t: t.to(device))
            return restored
    return None
