"""Demo / test modes, 2D view synthesis (port of the 2D branch of
``endosurf_tpu/evaluation/demo.py``).

Renders every frame (or the test split), scores PSNR / SSIM / depth RMSE and
writes per-frame composites plus an mp4 and a gif. Mesh extraction (the 3D
branch) is not ported yet.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict

from endosurf_tpu_torch.evaluation.render_eval import frame_stats, render_full_frames


def run_demo(renderer, step: int, test_mode: bool = False) -> Dict[str, float]:
    scene = renderer.scene
    cfg = renderer.cfg.get("demo", {})
    fps = cfg.get("fps", 10)
    ray_chunk = cfg.get("ray_batch", 1024)
    fids = [int(f) for f in (scene.list_test if test_mode else range(scene.n_frames))]
    tag = "test" if test_mode else "all"
    d2 = osp.join(renderer.exp_dir, "demo", f"iter_{step:08d}", f"{tag}_2d")
    os.makedirs(d2, exist_ok=True)
    pred = render_full_frames(renderer.render_fn(), renderer.params,
                              scene.device_arrays, scene.h, scene.w, fids,
                              step, ray_chunk)
    stats = frame_stats(scene, fids, pred)
    with open(osp.join(d2, "stats_out.txt"), "w") as f:
        for k, v in stats.items():
            f.write(f"{k}: {v:f}\n")
    _write_visuals(scene, fids, pred, d2, fps)
    print("DEMO|" + "|".join(f"{k}:{v:.4f}" for k, v in stats.items()), flush=True)
    return stats


def _write_visuals(scene, fids, pred, out_dir: str, fps: int) -> None:
    import imageio.v2 as iio

    from endosurf_tpu_torch.evaluation.vis import (
        composite_rows,
        depth_to_show,
        rgb_to_show,
        write_gif,
        write_video,
    )
    rows = composite_rows(scene, fids, pred)
    for i, row in enumerate(rows):
        iio.imwrite(osp.join(out_dir, f"{i:03d}_all.png"), row)
        iio.imwrite(osp.join(out_dir, f"{i:03d}_rgb_vr.png"), rgb_to_show(pred["rgb"][i]))
        iio.imwrite(osp.join(out_dir, f"{i:03d}_depth_vr.png"),
                    depth_to_show(pred["depth"][i], scene.far))
    write_video(osp.join(out_dir, "demo.mp4"), rows, fps)
    write_gif(osp.join(out_dir, "demo.gif"), rows, fps)
