"""ENDONERF preprocessing: raw capture -> info pkl (port of
``endosurf_tpu/data/preprocess_endonerf.py``).

LLFF ``poses_bounds.npy`` (a 3x5 [R | t | hwf] per frame) -> per-frame K and
projection matrices; the depth cleanup (zero under the tool masks, then the
3 % / 99.9 % percentile band of the nonzero depths); per-frame denoised
point clouds; the scene -> unit-sphere scale matrix; padded normalised
bboxes; the (i - 1) % 8 train / test split.

Two layers: ``create_endonerf_info`` reads the capture's files (imageio,
imported lazily) and writes the pkl; ``endonerf_info_from_arrays`` is the
arrays core, which needs no image library.

Usage:
    python -m endosurf_tpu_torch.data.preprocess_endonerf \\
        --dset_dir data/endonerf/dataset/pulling_soft_tissues \\
        --info_dir data/data_info/endonerf/
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

from endosurf_tpu_torch.data.preprocess_common import (
    frame_pointclouds,
    train_test_split,
    unit_sphere_normalization,
)

PAD_MM = np.array([-5.0, -5.0, 10.0])  # bbox padding


def _list_images(d, exts=("JPG", "jpg", "png")):
    return [osp.join(d, f) for f in sorted(os.listdir(d)) if f.split(".")[-1] in exts]


def _read_stack(paths, kind):
    import imageio.v2 as iio
    imgs = []
    for p in paths:
        img = np.asarray(iio.imread(p))
        if kind == "color":
            imgs.append(img[..., :3].astype(np.float32) / 255.0)
        elif kind == "depth":
            imgs.append(img.astype(np.float32))
        elif kind == "mask_invert":
            imgs.append(1.0 - img.astype(np.float32) / 255.0)
    return np.stack(imgs)


def endonerf_info_from_arrays(poses_bounds: np.ndarray, colors: np.ndarray,
                              depths: np.ndarray, masks_inverted: np.ndarray,
                              scene_name: str, test_every: int = 8,
                              object_scale_in_sphere: float = 0.6,
                              paths: Optional[Dict[str, Sequence[str]]] = None,
                              times: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """The info dict of an ENDONERF capture given as arrays.

    poses_bounds [n, 17] (LLFF), colors [n, H, W, 3] in [0, 1], depths
    [n, H, W] as read, masks_inverted [n, H, W] = 1 - tool mask / 255 (0
    under a tool). ``paths`` holds the "color", "depth" and "mask" file lists
    the pkl names (empty lists without it). ``times``, when given, gains the
    host seconds of the "pointclouds", "denoise" and "normalization" stages.
    ``depths`` is not modified."""
    poses = poses_bounds[:, :-2].reshape(-1, 3, 5)
    bds = poses_bounds[:, -2:]
    n_frames = poses.shape[0]
    for name, arr in (("colors", colors), ("depths", depths), ("masks", masks_inverted)):
        if len(arr) != n_frames:
            raise ValueError(f"Mismatch between {name} ({len(arr)}) and poses ({n_frames})")

    world_mat, camera_mat, pose_mat = [], [], []
    for i in range(n_frames):
        pose = poses[i]
        c2w = np.vstack([pose[:, :4], [[0, 0, 0, 1]]])
        w2c = np.linalg.inv(c2w)
        h, w, f = int(pose[0, 4]), int(pose[1, 4]), pose[2, 4]
        K = np.array([[f, 0, (w - 1) * 0.5, 0], [0, f, (h - 1) * 0.5, 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]])
        world_mat.append(K @ w2c)
        camera_mat.append(K)
        pose_mat.append(c2w)
    world_mat = np.stack(world_mat)
    camera_mat = np.stack(camera_mat)
    pose_mat = np.stack(pose_mat)

    # depth cleanup: zero under the tool masks, clip to the 3 % / 99.9 %
    # percentile band of the nonzero depths
    depths = np.array(depths, np.float32)
    depths[masks_inverted == 0] = 0
    close_depth = np.percentile(depths[depths != 0], 3.0)
    inf_depth = np.percentile(depths[depths != 0], 99.9)
    depths[depths > inf_depth] = 0
    depths[(depths < close_depth) & (depths != 0)] = 0

    pcds, bboxes = frame_pointclouds(colors, depths, camera_mat, pose_mat,
                                     depth_trunc=inf_depth, fraction=0.005,
                                     radius_mult=20.0, times=times)
    t0 = time.perf_counter()
    all_pts = np.concatenate(pcds, 0)
    scale_mat, radius, bbox_minmax = unit_sphere_normalization(
        all_pts, bboxes, object_scale_in_sphere, PAD_MM)
    if times is not None:
        times["normalization"] = times.get("normalization", 0.0) + time.perf_counter() - t0

    paths = paths or {}
    list_train, list_test = train_test_split(n_frames, test_every)
    return {
        "dset_name": "endonerf",
        "scene_name": scene_name,
        "world_mat": world_mat,
        "camera_mat": camera_mat,
        "pose_mat": pose_mat,
        "wh": [int(poses[0, 1, 4]), int(poses[0, 0, 4])],
        "n_frames": n_frames,
        "color": list(paths.get("color", [])),
        "depth": list(paths.get("depth", [])),
        "depth_type": "depth",
        "mask": list(paths.get("mask", [])),
        "scale_mat": scale_mat,
        "bounds": bds,
        "list_train": list_train,
        "list_test": list_test,
        "bbox_minmax": bbox_minmax,
        "mask_type": "mask_invert",
        "depth_norm_scale": radius,
    }


def create_endonerf_info(dset_dir: str, info_dir: str, test_every: int = 8,
                         object_scale_in_sphere: float = 0.6) -> str:
    """Read ``dset_dir`` (poses_bounds.npy, images/, depth/, masks/), write
    ``<info_dir>/<scene>.pkl`` and return its path."""
    scene_name = osp.basename(osp.normpath(dset_dir))
    poses_bounds = np.load(osp.join(dset_dir, "poses_bounds.npy"))
    n_frames = poses_bounds.shape[0]
    paths = {"color": _list_images(osp.join(dset_dir, "images")),
             "depth": _list_images(osp.join(dset_dir, "depth")),
             "mask": _list_images(osp.join(dset_dir, "masks"))}
    for name, key in (("images", "color"), ("depth", "depth"), ("masks", "mask")):
        if len(paths[key]) != n_frames:
            raise ValueError(f"Mismatch between {name} ({len(paths[key])}) and poses "
                             f"({n_frames})")
    info = endonerf_info_from_arrays(
        poses_bounds, _read_stack(paths["color"], "color"),
        _read_stack(paths["depth"], "depth"), _read_stack(paths["mask"], "mask_invert"),
        scene_name, test_every, object_scale_in_sphere, paths)
    out_path = osp.join(info_dir, f"{scene_name}.pkl")
    os.makedirs(info_dir, exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump(info, f, protocol=pickle.HIGHEST_PROTOCOL)
    print(f"info data saved in {out_path}")
    return out_path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dset_dir", default="data/endonerf/dataset/pulling_soft_tissues")
    ap.add_argument("--info_dir", default="data/data_info/endonerf/")
    ap.add_argument("--test_every", default=8, type=int)
    ap.add_argument("--object_scale_in_sphere", default=0.8, type=float)
    args = ap.parse_args()
    create_endonerf_info(args.dset_dir, args.info_dir, args.test_every,
                         args.object_scale_in_sphere)


if __name__ == "__main__":
    main()
