"""SCARED2019 preprocessing: stereo keyframe capture -> info pkl (port of
``endosurf_tpu/data/preprocess_scared.py``).

Per-frame calibration (KL and the camera pose, re-based to frame 0),
disparity converted to depth through the reprojection matrix (depth =
fl * bl / disp), the 30-300 mm depth band, colour masks from a
morphological closing of the depth mask, the border crop of predicted
disparity, frame subsampling, and the unit-sphere normalisation and split
of ``preprocess_common``.

Two layers: ``create_scared_info`` reads the capture's files (json, imageio
imported lazily), writes the processed images and the pkl;
``scared_info_from_arrays`` is the arrays core. The mask closing is numpy
(``close_mask``, held equal to ``cv2.morphologyEx``), so the core needs no
OpenCV. Only ``scale_factor != 1`` imports ``cv2``, for its
``cv2.resize``: OpenCV's uint8 bilinear is fixed-point arithmetic, which is
not re-derived here.

Per-case skip_every values: d1k1=2, d2k1=1, d3k1=4, d6k1=8, d7k1=8.

Usage:
    python -m endosurf_tpu_torch.data.preprocess_scared \\
        --dset_dir data/scared2019/dataset_1_keyframe_1 \\
        --info_dir data/data_info/scared2019/ --skip_every 2
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import pickle
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from endosurf_tpu_torch.data.preprocess_common import (
    frame_pointclouds,
    train_test_split,
    unit_sphere_normalization,
)

DEPTH_FAR_MM = 300.0
DEPTH_NEAR_MM = 30.0
CROP_WIDTH = 100
PAD_MM = np.array([0.0, 0.0, 0.0])


def _window_extreme(a: np.ndarray, k: int, axis: int, fill: float, op) -> np.ndarray:
    """``op`` (np.maximum or np.minimum) over the window [i - k // 2,
    i - k // 2 + k - 1] along ``axis``; cells outside the array read
    ``fill``, which ``op`` never picks."""
    anchor = k // 2
    pad = [(0, 0)] * a.ndim
    pad[axis] = (anchor, k - 1 - anchor)
    padded = np.pad(a, pad, constant_values=fill)
    n = a.shape[axis]
    out = padded.take(np.arange(0, n), axis=axis)
    for j in range(1, k):
        out = op(out, padded.take(np.arange(j, j + n), axis=axis))
    return out


def close_mask(mask: np.ndarray, k: int) -> np.ndarray:
    """Morphological closing of a 2D float mask with a k x k box:
    ``cv2.morphologyEx(mask, cv2.MORPH_CLOSE, np.ones((k, k), np.uint8))``.

    A dilation (max) then an erosion (min) over the same window, the anchor
    at (k // 2, k // 2) so that an even window reaches one cell farther
    before the anchor than after it, and the border ignored by both, as
    OpenCV's default border value for morphology does. The box is
    separable: each pass runs along rows, then along columns."""
    out = np.asarray(mask, np.float32)
    for op, fill in ((np.maximum, -np.inf), (np.minimum, np.inf)):
        for axis in (0, 1):
            out = _window_extreme(out, k, axis, fill, op)
    return out


def scared_info_from_arrays(kl: Sequence[np.ndarray], camera_poses: Sequence[np.ndarray],
                            reprojections: Sequence[np.ndarray], rgbs: Sequence[np.ndarray],
                            disps: Sequence[np.ndarray], scene_name: str,
                            scale_factor: int = 1, object_scale_in_sphere: float = 0.6,
                            test_every: int = 8, disp_type: str = "disparity_pred",
                            paths: Optional[Dict[str, Sequence[str]]] = None,
                            times: Optional[Dict[str, float]] = None
                            ) -> Tuple[Dict[str, Any], Dict[str, List[np.ndarray]]]:
    """The info dict of a SCARED capture given as arrays, and the processed
    images the pkl points at.

    Per frame (already subsampled): kl [3, 3] the left intrinsics,
    camera_poses [4, 4] the calibration's camera pose, reprojections [4, 4]
    the reprojection matrix Q, rgbs [H, W, 3+] uint8, disps [H, W]. ``paths``
    holds the "color", "depth" and "mask" file lists the pkl names (empty
    without it); ``times``, when given, gains the host seconds of the
    "pointclouds", "denoise" and "normalization" stages. Returns (info,
    {"rgb": [...], "disp": [...], "mask": [...]}): the (resized) colour
    images, the (resized) float32 disparities and the uint8 colour masks to
    write."""
    n_frames = len(kl)
    colors, depths, world_mat, camera_mat, pose_mat, bds, disp_consts = ([], [], [], [], [],
                                                                         [], [])
    processed = {"rgb": [], "disp": [], "mask": []}
    c2w0_inv = None
    w = h = 0
    for i in range(n_frames):
        K = np.eye(4)
        K[:3, :3] = np.array(kl[i])
        if scale_factor != 1:
            K = np.diag([1 / scale_factor, 1 / scale_factor, 1, 1]) @ K
        c2w = np.linalg.inv(np.array(camera_poses[i]))
        if c2w0_inv is None:
            c2w0_inv = np.linalg.inv(c2w)  # re-base poses to frame 0
        c2w = c2w0_inv @ c2w
        w2c = np.linalg.inv(c2w)

        rgb = np.asarray(rgbs[i])
        disp = np.asarray(disps[i]).astype(np.float32)
        h, w = disp.shape
        if scale_factor != 1:
            import cv2
            w, h = int(w / scale_factor), int(h / scale_factor)
            rgb = cv2.resize(rgb, (w, h), interpolation=cv2.INTER_LINEAR)
            disp = cv2.resize(disp, (w, h), interpolation=cv2.INTER_NEAREST)

        Q = np.array(reprojections[i])
        disp_const = Q[2, 3] * (1.0 / Q[3, 2])  # focal length * baseline

        depth = np.zeros_like(disp)
        nz = disp != 0
        depth[nz] = disp_const / disp[nz]
        depth[depth > DEPTH_FAR_MM] = 0
        depth[depth < DEPTH_NEAR_MM] = 0

        color_mask = close_mask((depth != 0).astype(np.float32), max(1, w // 128))
        if disp_type == "disparity_pred":
            # predicted disparity is unreliable near the border: keep only the
            # central crop
            border = np.ones_like(disp)
            border[CROP_WIDTH:-CROP_WIDTH, CROP_WIDTH:-CROP_WIDTH] = 0
            depth[border == 1] = 0

        processed["rgb"].append(rgb)
        processed["disp"].append(disp)
        processed["mask"].append((color_mask * 255).astype(np.uint8))
        colors.append(rgb[..., :3].astype(np.float32) / 255.0)
        depths.append(depth)
        world_mat.append(K @ w2c)
        camera_mat.append(K)
        pose_mat.append(c2w)
        bds.append(np.array([depth[depth != 0].min(), depth[depth != 0].max()]))
        disp_consts.append(disp_const)

    colors = np.stack(colors)
    depths = np.stack(depths)
    world_mat = np.stack(world_mat)
    camera_mat = np.stack(camera_mat)
    pose_mat = np.stack(pose_mat)
    bds = np.stack(bds)

    pcds, bboxes = frame_pointclouds(colors, depths, camera_mat, pose_mat,
                                     depth_trunc=bds.max(), fraction=0.1, radius_mult=10.0,
                                     times=times)
    t0 = time.perf_counter()
    all_pts = np.concatenate(pcds, 0)
    scale_mat, radius, bbox_minmax = unit_sphere_normalization(
        all_pts, bboxes, object_scale_in_sphere, PAD_MM)
    if times is not None:
        times["normalization"] = times.get("normalization", 0.0) + time.perf_counter() - t0

    paths = paths or {}
    list_train, list_test = train_test_split(n_frames, test_every)
    info = {
        "dset_name": "scared2019",
        "scene_name": f"{scene_name}_{disp_type}",
        "world_mat": world_mat,
        "camera_mat": camera_mat,
        "pose_mat": pose_mat,
        "wh": [w, h],
        "n_frames": n_frames,
        "color": list(paths.get("color", [])),
        "depth": list(paths.get("depth", [])),
        "depth_type": "disp",
        "disp_const": disp_consts,
        "mask": list(paths.get("mask", [])),
        "scale_mat": scale_mat,
        "bounds": bds,
        "list_train": list_train,
        "list_test": list_test,
        "bbox_minmax": bbox_minmax,
        "mask_type": "mask",
        "depth_norm_scale": radius,
    }
    return info, processed


def create_scared_info(dset_dir: str, info_dir: str, scale_factor: int = 1,
                       object_scale_in_sphere: float = 0.6, skip_every: int = 2,
                       test_every: int = 8, disp_type: str = "disparity_pred") -> str:
    """Read ``dset_dir/data`` (frame_data/, left_finalpass/, <disp_type>/,
    reprojection_data/), write the processed images under
    ``dset_dir/data_processed`` and ``<info_dir>/<scene>_<disp_type>.pkl``,
    and return the pkl's path."""
    import imageio.v2 as iio

    scene_name = osp.basename(osp.normpath(dset_dir))
    data = osp.join(dset_dir, "data")
    frame_ids = sorted(f[:-5] for f in os.listdir(osp.join(data, "frame_data")))[::skip_every]

    out_base = osp.join(dset_dir, "data_processed")
    save = {"disp": osp.join(out_base, f"{disp_type}_scale_{scale_factor}"),
            "rgb": osp.join(out_base, f"rgb_scale_{scale_factor}"),
            "mask": osp.join(out_base, f"mask_scale_{scale_factor}")}
    for d in save.values():
        os.makedirs(d, exist_ok=True)

    kl, poses, reprojections, rgbs, disps = [], [], [], [], []
    for fid in frame_ids:
        with open(osp.join(data, "frame_data", f"{fid}.json")) as f:
            calib = json.load(f)
        kl.append(calib["camera-calibration"]["KL"])
        poses.append(calib["camera-pose"])
        with open(osp.join(data, "reprojection_data", f"{fid}.json")) as f:
            reprojections.append(json.load(f)["reprojection-matrix"])
        rgbs.append(np.asarray(iio.imread(osp.join(data, "left_finalpass", f"{fid}.png"))))
        disps.append(np.asarray(iio.imread(osp.join(data, disp_type, f"{fid}.tiff"))))

    paths = {"color": [osp.join(save["rgb"], f"{fid}.png") for fid in frame_ids],
             "depth": [osp.join(save["disp"], f"{fid}.tiff") for fid in frame_ids],
             "mask": [osp.join(save["mask"], f"{fid}.png") for fid in frame_ids]}
    info, processed = scared_info_from_arrays(
        kl, poses, reprojections, rgbs, disps, scene_name, scale_factor,
        object_scale_in_sphere, test_every, disp_type, paths)
    for i in range(len(frame_ids)):
        iio.imwrite(paths["color"][i], processed["rgb"][i])
        iio.imwrite(paths["depth"][i], processed["disp"][i])
        iio.imwrite(paths["mask"][i], processed["mask"][i])

    out_path = osp.join(info_dir, f"{scene_name}_{disp_type}.pkl")
    os.makedirs(info_dir, exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump(info, f, protocol=pickle.HIGHEST_PROTOCOL)
    print(f"info data saved in {out_path}")
    return out_path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dset_dir", default="data/scared2019/dataset_1_keyframe_1")
    ap.add_argument("--info_dir", default="data/data_info/scared2019/")
    ap.add_argument("--scale_factor", default=1, type=int)
    ap.add_argument("--object_scale_in_sphere", default=0.6, type=float)
    ap.add_argument("--skip_every", default=2, type=int)
    ap.add_argument("--test_every", default=8, type=int)
    ap.add_argument("--disp_type", default="disparity_pred",
                    choices=["disparity_pred", "disparity"])
    args = ap.parse_args()
    create_scared_info(args.dset_dir, args.info_dir, args.scale_factor,
                       args.object_scale_in_sphere, args.skip_every, args.test_every,
                       args.disp_type)


if __name__ == "__main__":
    main()
