"""Parameters carried across between the JAX package and the port.

Both sides use the same tree: ``{"deform_network": {"layers": [{v, g, b},
...]}, "sdf_network": ..., "color_network": ..., "deviation_network":
{"variance"}}`` with weight-norm layers ``{v [in, out], g [out], b [out]}``
(plain layers ``{w, b}``). The port holds torch tensors, the JAX side numpy
or jax arrays. On disk the tree is an ``.npz`` with flattened ``a/b/c`` keys
(list indices become path parts), plus an optional ``meta/step`` entry with
the training step the parameters come from.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

STEP_KEY = "meta/step"


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts/lists -> {"a/b/0/c": leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten(flat: Dict[str, Any]) -> Any:
    """Inverse of :func:`flatten`; all-digit key sets become lists."""
    root: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = root
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def params_from_jax(tree: Any, device: Any = "cpu") -> Any:
    """A JAX params tree (numpy or jax arrays) -> the same tree of float32
    torch tensors on ``device``."""
    flat = {k: torch.as_tensor(np.array(v, dtype=np.float32), device=device)
            for k, v in flatten(tree).items()}
    return unflatten(flat)


def params_to_numpy(params: Any) -> Any:
    """The port's params -> the same tree of numpy float32 arrays (the
    layout JAX's init and checkpoints use)."""
    flat = {k: v.detach().to("cpu", torch.float32).numpy() if torch.is_tensor(v)
            else np.asarray(v, np.float32) for k, v in flatten(params).items()}
    return unflatten(flat)


def save_params_npz(path: str, params: Any, step: Optional[int] = None) -> None:
    """Write params (torch or numpy leaves) as a flattened npz."""
    flat = flatten(params_to_numpy(params))
    if step is not None:
        flat[STEP_KEY] = np.asarray(step, np.int64)
    np.savez(path, **flat)


def load_params_npz(path: str, device: Any = "cpu"
                    ) -> Tuple[Dict[str, Any], Optional[int]]:
    """Read an npz written by :func:`save_params_npz` -> (params, step)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    step = flat.pop(STEP_KEY, None)
    return params_from_jax(unflatten(flat), device), (None if step is None else int(step))
