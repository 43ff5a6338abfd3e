#!/usr/bin/env python
"""Time and peak device memory of one served EndoSurf or EndoNeRF frame.

Serves one 512x640 frame of chip_smoke.py's synthetic scene through
``evaluation.render_eval.eval_frames`` with an ``EndoSurfRenderer``
(chip_smoke.py's base.yml config: three 9x256 MLPs, seeded weights, bf16
dots, 2048-ray chunks) or, with ``--endonerf``, an ``EndoNeRFRenderer``
(chip_smoke.py's EndoNeRF base.yml config: 9x256 / 9x256 / 2x128 nets,
64 + 64 depth-guided samples, seeded weights, bf16 dots, 2048-ray chunks)
from the checkout at ``--root`` (default: this one), once to build and warm
up and once measured, and prints the measured frame's seconds, the device
memory allocated before it and its peak (torch.cuda.max_memory_allocated
after a reset), with the card. Point ``--root`` at another checkout to
compare two trees on one card. Needs a CUDA device:

    python tools/serve_frame_memory.py [--root CHECKOUT] [--endonerf]
"""

from __future__ import annotations

import argparse
import os.path as osp
import subprocess
import sys
import time


def main():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--root", default=osp.dirname(osp.dirname(osp.abspath(__file__))))
    parser.add_argument("--endonerf", action="store_true", help="serve an EndoNeRF frame")
    args = parser.parse_args()
    root = osp.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import tempfile

    from chip_smoke import CHUNK, H, W, base_cfg, endonerf_cfg
    from endosurf_tpu_torch.data.scene_data import make_synthetic_arrays
    from endosurf_tpu_torch.evaluation.render_eval import eval_frames
    from endosurf_tpu_torch.serve import EndoNeRFRenderer, EndoSurfRenderer
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    scene = make_synthetic_arrays(n_frames=4, h=H, w=W, seed=0, device=dev)
    exp_root = tempfile.TemporaryDirectory()
    if args.endonerf:
        cfg = endonerf_cfg()
        cfg["exp"]["exp_dir"] = exp_root.name
        renderer, step, what = EndoNeRFRenderer(cfg, scene=scene, step=0, device=dev), 0, "EndoNeRF"
    else:
        renderer = EndoSurfRenderer(base_cfg(), scene=scene, step=30000, device=dev)
        step, what = 30000, "EndoSurf"

    def frame():
        eval_frames(renderer, scene.list_test[:1], step, ray_chunk=CHUNK, save_images=False)
        torch.cuda.synchronize()
    frame()
    before = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    frame()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{root}: served {what} {H}x{W} frame (bf16, {CHUNK}-ray chunks) in {seconds:.2f} s; "
          f"device memory {before:.3f} GiB before it, peak {peak:.3f} GiB ({smi})", flush=True)


if __name__ == "__main__":
    main()
