#!/usr/bin/env python
"""Export a JAX (orbax) checkpoint's parameters to the PyTorch port's npz.

Reads the latest checkpoint of an experiment directory with
``endosurf_tpu.train.checkpoint.load_checkpoint`` and writes the parameter
tree, with the training step, in the format of
``endosurf_tpu_torch.bridge.save_params_npz``. The port then serves the
JAX-trained model:

    python tools/export_params_npz.py \\
        --exp-dir logs/endosurf/base-endonerf-pulling_soft_tissues --out params.npz
    python -m endosurf_tpu_torch --cfg configs/endosurf/base.yml --mode test_2d \\
        --params params.npz

Runs where JAX is installed; the optimizer state is not exported.
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))


def export(exp_dir: str, out: str) -> int:
    """Write ``out`` from ``exp_dir``'s checkpoint; returns the step."""
    import jax

    from endosurf_tpu.train.checkpoint import load_checkpoint
    from endosurf_tpu_torch.bridge import save_params_npz

    restored = load_checkpoint(exp_dir)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint found in {exp_dir}")
    params = jax.device_get(restored["params"])
    step = int(restored["n_iter"])
    save_params_npz(out, params, step=step)
    return step


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--exp-dir", required=True,
                        help="experiment directory holding the orbax checkpoint")
    parser.add_argument("--out", required=True, help="output .npz path")
    args = parser.parse_args()
    step = export(args.exp_dir, args.out)
    print(f"wrote {args.out} (step {step})")


if __name__ == "__main__":
    main()
