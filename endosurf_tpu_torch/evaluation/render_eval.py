"""Full-frame rendering for eval/test/demo (port of
``endosurf_tpu/evaluation/render_eval.py``).

Frames are flattened to rays, rendered in fixed-size chunks on the scene's
device, and reassembled into RGB / depth / weighted-normal maps, then scored
with the masked metrics and optionally saved as side-by-side composites
(the first also to the renderer's ``writer``, where it has one).

Under a data mesh (the renderer's ``mesh``) each rank renders its share of a
frame's chunks and every rank gets the whole frame
(``parallel.mesh.gather_rows``); only the main rank writes files.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, Sequence

import numpy as np
import torch

from endosurf_tpu_torch.data.scene_data import frame_rays
from endosurf_tpu_torch.evaluation.metrics import cal_lpips, cal_psnr, cal_rmse, cal_ssim
from endosurf_tpu_torch.evaluation.vis import composite_rows
from endosurf_tpu_torch.parallel.distributed import is_main_process


def _chunk_maps(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A chunk's rgb / depth (/ normal) maps from the renderer's output."""
    maps = {"rgb": out["color_map"], "depth": out["depth_map"]}
    if "normal_map" in out:
        maps["normal"] = out["normal_map"]
    elif "gradients_o" in out:
        maps["normal"] = (out["gradients_o"] * out["weights"][..., None]).sum(1)
    return maps


def render_full_frames(render_fn, params, arrays, h: int, w: int,
                       fids: Sequence[int], step: int, ray_chunk: int = 2048,
                       ray_transform=None, mesh=None) -> Dict[str, np.ndarray]:
    """Render frames chunk by chunk; returns numpy rgb/depth(/normal) stacks.

    ``render_fn(params, rays[chunk, 9], step) -> dict`` returns color_map /
    depth_map and either normal_map or weights + gradients_o. The last chunk
    is padded by repeating the last ray, so every call has ``ray_chunk`` rays.
    With a ``mesh`` (``parallel.mesh.DataMesh``) the frame's chunks are split
    over the ranks by rows, each rank renders its own, and every rank gets
    the whole maps: the chunks are the single process's, so the maps are
    too, even where a chunk's draws depend on a ray's place in it (the
    EndoNeRF depth-guided samples).
    """
    out: Dict[str, list] = {}
    for fid in fids:
        rays = frame_rays(arrays, h, w, int(fid)).reshape(-1, 9)
        if ray_transform is not None:
            rays = ray_transform(rays, int(fid))
        n_rays = rays.shape[0]
        n_pad = (-n_rays) % ray_chunk
        if n_pad:
            rays = torch.cat([rays, rays[-1:].expand(n_pad, 9)], dim=0)
        chunks = rays.reshape(-1, ray_chunk, 9)
        n_chunks = chunks.shape[0]
        mine = chunks if mesh is None else mesh.rows(chunks)
        with torch.no_grad():
            # a rank without a chunk renders the first one for the maps' shapes
            maps = [_chunk_maps(render_fn(params, c.contiguous(), step))
                    for c in (mine if mine.shape[0] else chunks[:1])]
        for k in maps[0]:
            part = torch.stack([m[k] for m in maps])[:mine.shape[0]]
            if mesh is not None:
                part = mesh.gather(part.contiguous(), n_chunks)
            ch = part.shape[-1]
            out.setdefault(k, []).append(part.reshape(-1, ch)[:n_rays].reshape(h, w, ch)
                                         .cpu().numpy())
    return {k: np.stack(v) for k, v in out.items()}


def add_depth_normals(renderer, scene, fids: Sequence[int], pred: Dict[str, np.ndarray]) -> None:
    """With the renderer's ``normals_from_depth`` and no rendered normals:
    ``pred["normal"]`` from the depth map (``vis.normal_from_depth`` on the
    frames' own rays)."""
    if "normal" in pred or not getattr(renderer, "normals_from_depth", False):
        return
    from endosurf_tpu_torch.evaluation.vis import normal_from_depth
    arrays = scene.device_arrays
    rays = np.stack([frame_rays(arrays, scene.h, scene.w, f).cpu().numpy() for f in fids])
    pred["normal"] = normal_from_depth(rays, pred["depth"])


def frame_stats(scene, fids: Sequence[int], pred: Dict[str, np.ndarray]) -> Dict[str, float]:
    """PSNR / SSIM on colour and depth RMSE (scene units x depth_scale)."""
    arrays = scene.device_arrays
    rgb_gt = arrays["colors"][fids].cpu().numpy()
    depth_gt = arrays["depths"][fids].cpu().numpy()
    mask_gt = arrays["masks"][fids].cpu().numpy()
    color_mask_gt = arrays["color_masks"][fids].cpu().numpy()
    ds = scene.depth_scale
    stats = {
        "psnr_rgb_vr": cal_psnr(rgb_gt, pred["rgb"], color_mask_gt),
        "ssim_rgb_vr": cal_ssim(rgb_gt, pred["rgb"], color_mask_gt),
        "rmse_d_vr": cal_rmse(depth_gt * ds, pred["depth"] * ds, mask_gt),
    }
    lp = cal_lpips(rgb_gt, pred["rgb"], color_mask_gt, device=arrays["colors"].device)
    if lp is not None:
        stats["lpips_rgb_vr"] = lp
    return stats


def eval_frames(renderer, fids: Sequence[int], step: int, ray_chunk: int = 2048,
                save_dir_name: str = "eval", save_images: bool = True,
                return_pred: bool = False):
    """Render test frames, compute masked metrics, save composites + stats.

    The renderer's optional hooks: ``eval_ray_transform(rays, fid)`` rewrites
    a frame's rays before rendering, ``normals_from_depth`` derives the
    normal map from the depth map, ``mesh`` splits the frames' rays over the
    ranks. Every rank gets the stats; the main rank writes them and the
    images. Returns the stats dict, or (stats, predicted maps) with
    ``return_pred``.
    """
    scene = renderer.scene
    fids = [int(f) for f in fids]
    pred = render_full_frames(renderer.render_fn(), renderer.params,
                              scene.device_arrays, scene.h, scene.w, fids, step,
                              ray_chunk, getattr(renderer, "eval_ray_transform", None),
                              getattr(renderer, "mesh", None))
    add_depth_normals(renderer, scene, fids, pred)
    stats = frame_stats(scene, fids, pred)
    if not is_main_process():
        return (stats, pred) if return_pred else stats

    save_dir = osp.join(renderer.exp_dir, save_dir_name, f"iter_{step:08d}")
    os.makedirs(save_dir, exist_ok=True)
    with open(osp.join(save_dir, "stats_out.txt"), "w") as f:
        for k, v in stats.items():
            f.write(f"{k}: {v:f}\n")

    if save_images:
        import imageio.v2 as iio
        writer = getattr(renderer, "writer", None)
        for i, row in enumerate(composite_rows(scene, fids, pred)):
            iio.imwrite(osp.join(save_dir, f"eval_{i:03d}.png"), row)
            if writer is not None and i == 0:
                writer.add_image(f"{save_dir_name}/results", row, step)

    print(f"EVAL|iter:{step}|" + "|".join(
        f"{k}:{v:.4f}" for k, v in stats.items()), flush=True)
    return (stats, pred) if return_pred else stats
