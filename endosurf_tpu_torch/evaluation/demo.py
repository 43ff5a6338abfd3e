"""Demo / test modes: 2D view synthesis and 3D mesh extraction with metrics
(port of ``endosurf_tpu/evaluation/demo.py``).

Renders every frame (or the test split) and scores PSNR / SSIM / depth RMSE;
extracts a marching-tetrahedra mesh per frame from the renderer's scalar
field on a dense grid (EndoSurf's SDF through ``fused_sdf_observed``,
EndoNeRF's negated raw density through ``fused_density_raw``: CUDA kernels on
the card),
colours it from the radiance field, writes PLYs and reports the geometric
error in mm (ground-truth point cloud -> mesh vertices). With ``visualize``
it also writes composites, mesh screenshots, an mp4 and a gif; imageio and
OpenCV are imported only there. Under a data mesh every rank renders its rows
of the frames and grids (``render_eval.render_full_frames``, the renderer's
closures) and computes the stats; the main rank writes the files.
"""

from __future__ import annotations

import os
import os.path as osp
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from endosurf_tpu_torch.evaluation.geometry3d import (
    colored_meshes,
    extract_mesh,
    geometric_error,
    rgbd_to_pointcloud,
)
from endosurf_tpu_torch.evaluation.render_eval import (
    add_depth_normals,
    frame_stats,
    render_full_frames,
)
from endosurf_tpu_torch.native import rasterize_mesh
from endosurf_tpu_torch.parallel.distributed import is_main_process
from endosurf_tpu_torch.utils.ply import write_ply


def load_virtual_camera(path: str):
    """Parse an Open3D PinholeCameraParameters JSON (column-major matrices).
    Returns (K [3,3], w2c [4,4], w, h)."""
    import json
    with open(path) as f:
        data = json.load(f)
    intr = data["intrinsic"]
    K = np.asarray(intr["intrinsic_matrix"], np.float64).reshape(3, 3).T
    w2c = np.asarray(data["extrinsic"], np.float64).reshape(4, 4).T
    return K, w2c, int(intr["width"]), int(intr["height"])


def resolve_virtual_camera(cfg: Dict, scene):
    """Screenshot camera from ``demo.virtual_camera``: a camera JSON path, or
    "mean" (a fixed camera at the average frame pose). None: shoot each frame
    from its own camera."""
    spec = cfg.get("virtual_camera")
    if not spec:
        return None
    if isinstance(spec, str) and spec != "mean":
        return load_virtual_camera(spec)
    poses = scene.poses
    Rm = poses[:, :3, :3].mean(0)
    u, _, vt = np.linalg.svd(Rm)
    R = u @ vt
    if np.linalg.det(R) < 0:
        R = u @ np.diag([1.0, 1.0, -1.0]) @ vt
    pose = np.eye(4)
    pose[:3, :3] = R
    pose[:3, 3] = poses[:, :3, 3].mean(0)
    return scene.intrinsics[0][:3, :3], np.linalg.inv(pose), scene.w, scene.h


def _screenshot(verts, tris, colors, K, w2c, h, w):
    """Project a world-space mesh through a camera and rasterize it."""
    if len(verts) == 0:
        return np.ones((h, w, 3), np.float32)
    R, t = w2c[:3, :3], w2c[:3, 3]
    cam = verts @ R.T + t
    z = np.maximum(cam[:, 2], 1e-6)
    x = cam[:, 0] / z * K[0, 0] + K[0, 2]
    y = cam[:, 1] / z * K[1, 1] + K[1, 2]
    screen = np.stack([x, y, z], -1).astype(np.float32)
    return rasterize_mesh(screen, colors, tris, w, h)


def run_demo(renderer, step: int, test_mode: bool = False, visualize: bool = True,
             demo_2d: bool = True, demo_3d: bool = True) -> Dict:
    """``renderer`` provides scene, cfg, params, exp_dir, device,
    ``render_fn()``, ``demo_field_fn()``, ``demo_field_threshold(t)`` and
    ``render_points_fn()`` (``serve.EndoSurfRenderer`` /
    ``EndoNeRFRenderer``), and optionally ``eval_ray_transform`` and
    ``normals_from_depth`` (as ``render_eval.eval_frames``); the 2D depth is
    smoothed by ``demo.depth_filter`` when the config sets it. Returns the stats;
    with ``demo_3d`` they hold ``geo_err_mean``, ``geo_err_per_frame`` and
    ``timing_3d`` (seconds a frame of grid, mesh, colour and metrics)."""
    scene = renderer.scene
    cfg = renderer.cfg.get("demo", {})
    fps = cfg.get("fps", 10)
    ray_chunk = cfg.get("ray_batch", 1024)
    mesh_resolution = cfg.get("marching_cubes_resolution", 128)
    thresh = cfg.get("marching_cubes_thresh", 0)
    mesh_smooth_iters = cfg.get("marching_cubes_filter", None)
    if mesh_smooth_iters in ("None", None):
        mesh_smooth_iters = 0

    fids = [int(f) for f in (scene.list_test if test_mode else range(scene.n_frames))]
    tag = "test" if test_mode else "all"
    base_dir = osp.join(renderer.exp_dir, "demo", f"iter_{step:08d}")
    arrays = scene.device_arrays
    rgb_gt = arrays["colors"][fids].cpu().numpy()
    depth_gt = arrays["depths"][fids].cpu().numpy()
    ts = arrays["ts"][fids].cpu().numpy().reshape(-1)
    depth_max = scene.far
    ds = scene.depth_scale
    stats: Dict = {}
    write = is_main_process()
    visualize = visualize and write
    shows_2d: Optional[List[np.ndarray]] = None
    mesh_shots: Dict[str, List[np.ndarray]] = {}

    if demo_2d:
        d2 = osp.join(base_dir, f"{tag}_2d")
        os.makedirs(d2, exist_ok=True)
        pred = render_full_frames(renderer.render_fn(), renderer.params, arrays,
                                  scene.h, scene.w, fids, step, ray_chunk,
                                  getattr(renderer, "eval_ray_transform", None),
                                  getattr(renderer, "mesh", None))
        depth_filter = cfg.get("depth_filter")
        if depth_filter not in ("None", None):
            from endosurf_tpu_torch.evaluation.vis import filter_depth
            pred["depth"] = filter_depth(pred["depth"], depth_filter)
        add_depth_normals(renderer, scene, fids, pred)
        stats.update(frame_stats(scene, fids, pred))
        if write:
            with open(osp.join(d2, "stats_out.txt"), "w") as f:
                for k, v in stats.items():
                    f.write(f"{k}: {v:f}\n")
        if visualize:
            shows_2d = _write_visuals_2d(scene, fids, pred, d2, fps)

    if demo_3d:
        d3 = osp.join(base_dir, f"{tag}_3d_thresh_{thresh}_res_{mesh_resolution}")
        os.makedirs(d3, exist_ok=True)
        vcam = resolve_virtual_camera(cfg, scene)
        view_point = scene.poses[:, :3, 3].mean(0)
        field_fn = renderer.demo_field_fn()
        render_pts = renderer.render_points_fn()
        geo_errs, timing = [], []
        for i, fid in enumerate(fids):
            t0 = time.perf_counter()
            pcd_pts, pcd_col = rgbd_to_pointcloud(
                rgb_gt[i], depth_gt[i], scene.intrinsics[fid][:3, :3], scene.poses[fid],
                depth_max)
            # the frame's bbox, slightly enlarged
            bmin = scene.bbox_minmax[fid, :, 0] * 1.2
            bmax = scene.bbox_minmax[fid, :, 1] * 1.2
            mesh_t = {}
            grid_fn = _timed(field_fn, mesh_t, renderer.device)
            verts, tris = extract_mesh(grid_fn, float(ts[i]), bmin, bmax, mesh_resolution,
                                       renderer.demo_field_threshold(thresh),
                                       device=renderer.device)
            if len(verts) == 0:
                raise RuntimeError("Failed to find surface! Please tune threshold.")
            if mesh_smooth_iters:
                from endosurf_tpu_torch.native import laplacian_smooth
                verts = laplacian_smooth(verts, tris, mesh_smooth_iters)
            t1 = time.perf_counter()
            cm = colored_meshes(render_pts, verts, tris, view_point, float(ts[i]))
            t2 = time.perf_counter()
            if write:
                write_ply(osp.join(d3, f"{i:03d}_geometry.ply"), verts, tris)
                write_ply(osp.join(d3, f"{i:03d}_color.ply"), verts, tris, cm["color"])
                write_ply(osp.join(d3, f"{i:03d}_normal.ply"), verts, tris,
                          cm["normal_color"])
                write_ply(osp.join(d3, f"{i:03d}_gt.ply"), pcd_pts, colors=pcd_col)
            geo_errs.append(geometric_error(pcd_pts, verts, ds))
            t3 = time.perf_counter()
            grid_s = mesh_t.get("s", 0.0)
            timing.append({"grid": grid_s, "mesh": t1 - t0 - grid_s, "color": t2 - t1,
                           "metrics": t3 - t2, "n_verts": len(verts), "n_tris": len(tris)})
            if visualize:
                shots = _mesh_shots(scene, fid, vcam, verts, tris, cm)
                for kind, img in shots.items():
                    mesh_shots.setdefault(kind, []).append(img)
                    _imwrite(osp.join(d3, f"{i:03d}_{kind}.png"), img)

        stats["geo_err_mean"] = float(np.mean(geo_errs))
        stats["geo_err_per_frame"] = [float(e) for e in geo_errs]
        stats["timing_3d"] = timing
        if write:
            with open(osp.join(d3, "stats_out.txt"), "w") as f:
                f.write(f"mean: {stats['geo_err_mean']:f}\n")
                for k, v in enumerate(geo_errs):
                    f.write(f"{k}: {v:f}\n")
        if visualize and mesh_shots:
            from endosurf_tpu_torch.evaluation.vis import hstack_labeled, write_gif, write_video
            frames = [hstack_labeled([mesh_shots[k][i] for k in mesh_shots], list(mesh_shots))
                      for i in range(len(fids))]
            write_video(osp.join(d3, "demo.mp4"), frames, fps)
            write_gif(osp.join(d3, "demo.gif"), frames, fps)

    if demo_2d and demo_3d and visualize and shows_2d:
        _write_final(base_dir, tag, fids, shows_2d, mesh_shots, fps)

    if write:
        print("DEMO|" + "|".join(f"{k}:{v:.4f}" for k, v in stats.items() if np.isscalar(v)),
              flush=True)
    return stats


def _timed(field_fn, acc: Dict[str, float], device: torch.device):
    """``field_fn`` that adds its wall seconds (device work included) to
    ``acc["s"]``."""
    def fn(pts, t):
        t0 = time.perf_counter()
        out = field_fn(pts, t)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        acc["s"] = acc.get("s", 0.0) + time.perf_counter() - t0
        return out
    return fn


def _imwrite(path: str, img: np.ndarray) -> None:
    import imageio.v2 as iio
    iio.imwrite(path, img)


def _write_visuals_2d(scene, fids, pred, out_dir: str, fps: int) -> List[np.ndarray]:
    from endosurf_tpu_torch.evaluation.vis import (
        composite_rows,
        depth_to_show,
        rgb_to_show,
        write_gif,
        write_video,
    )
    rows = composite_rows(scene, fids, pred)
    for i, row in enumerate(rows):
        _imwrite(osp.join(out_dir, f"{i:03d}_all.png"), row)
        _imwrite(osp.join(out_dir, f"{i:03d}_rgb_vr.png"), rgb_to_show(pred["rgb"][i]))
        _imwrite(osp.join(out_dir, f"{i:03d}_depth_vr.png"),
                 depth_to_show(pred["depth"][i], scene.far))
    write_video(osp.join(out_dir, "demo.mp4"), rows, fps)
    write_gif(osp.join(out_dir, "demo.gif"), rows, fps)
    return rows


def _mesh_shots(scene, fid: int, vcam, verts, tris, cm) -> Dict[str, np.ndarray]:
    """Geometry (shaded), colour and normal screenshots of a frame's mesh."""
    from endosurf_tpu_torch.evaluation.vis import to8b
    if vcam is not None:
        K, w2c, shot_w, shot_h = vcam
    else:
        K = scene.intrinsics[fid][:3, :3]
        w2c = np.linalg.inv(scene.poses[fid])
        shot_w, shot_h = scene.w, scene.h
    shade = np.clip(np.abs(cm["normals"] @ (-w2c[2, :3])), 0.2, 1.0)
    return {kind: to8b(_screenshot(verts, tris, col, K, w2c, shot_h, shot_w))
            for kind, col in (("geometry", np.repeat(shade[:, None], 3, 1)),
                              ("color", cm["color"]), ("normal", cm["normal_color"]))}


def _write_final(base_dir: str, tag: str, fids, shows_2d, mesh_shots, fps: int) -> None:
    """The 2D composite beside the mesh screenshots, heights matched."""
    import cv2

    from endosurf_tpu_torch.evaluation.vis import hstack_labeled, write_gif, write_video
    df = osp.join(base_dir, f"{tag}_final")
    os.makedirs(df, exist_ok=True)

    def match_h(img, h):
        if img.shape[0] == h:
            return img
        return cv2.resize(img, (max(1, int(img.shape[1] * h / img.shape[0])), h))

    frames = []
    for i in range(len(fids)):
        panels = [shows_2d[i]] + [match_h(mesh_shots[k][i], shows_2d[i].shape[0])
                                  for k in mesh_shots]
        row = hstack_labeled(panels, ["render"] + [f"mesh_{k}" for k in mesh_shots])
        frames.append(row)
        _imwrite(osp.join(df, f"{i:03d}.png"), row)
    write_video(osp.join(df, "demo.mp4"), frames, fps)
    write_gif(osp.join(df, "demo.gif"), frames, fps)
