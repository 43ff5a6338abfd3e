"""Shared preprocessing stages: point clouds, scene normalisation, splits
(port of ``endosurf_tpu/data/preprocess_common.py``).

Per-frame RGBD point clouds with a random subsample and radius-outlier
removal, per-frame AABBs, the scene -> unit-sphere scale matrix, the
normalised padded bboxes and the (i - 1) % test_every split. Host numpy and
the port's native KD-tree (``native.nn_distance_excl_self``,
``native.radius_outlier_mask``); no image library is imported here.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from endosurf_tpu_torch.evaluation.geometry3d import rgbd_to_pointcloud
from endosurf_tpu_torch.native import nn_distance_excl_self, radius_outlier_mask


def downsample_and_denoise(pts: np.ndarray, fraction: float, nb_points: int = 5,
                           radius_mult: float = 20.0,
                           rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Random subsample of ``fraction`` of the points (``rng.choice`` without
    replacement), then radius-outlier removal with the radius the mean
    nearest-neighbour distance times ``radius_mult``."""
    rng = rng or np.random.default_rng(0)
    if fraction < 1.0 and len(pts) > 0:
        n_keep = max(1, int(round(len(pts) * fraction)))
        pts = pts[rng.choice(len(pts), size=n_keep, replace=False)]
    if len(pts) > nb_points:
        radius = float(nn_distance_excl_self(pts).mean()) * radius_mult
        pts = pts[radius_outlier_mask(pts, nb_points, radius)]
    return pts


def frame_pointclouds(colors: np.ndarray, depths: np.ndarray, camera_mats: np.ndarray,
                      pose_mats: np.ndarray, depth_trunc: float, fraction: float,
                      radius_mult: float, seed: int = 0,
                      times: Optional[Dict[str, float]] = None
                      ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Per-frame denoised world point clouds and per-frame AABBs [n, 3, 2];
    one ``default_rng(seed)`` draws every frame's subsample in turn.
    ``times``, when given, gains the host seconds of the unprojection
    ("pointclouds") and of the subsample and outlier removal ("denoise")."""
    rng = np.random.default_rng(seed)
    times = {} if times is None else times
    pcds, bboxes = [], []
    for i in range(len(colors)):
        t0 = time.perf_counter()
        pts, _ = rgbd_to_pointcloud(colors[i], depths[i], camera_mats[i][:3, :3],
                                    pose_mats[i], depth_trunc)
        t1 = time.perf_counter()
        pts = downsample_and_denoise(pts, fraction, radius_mult=radius_mult, rng=rng)
        t2 = time.perf_counter()
        times["pointclouds"] = times.get("pointclouds", 0.0) + t1 - t0
        times["denoise"] = times.get("denoise", 0.0) + t2 - t1
        pcds.append(pts)
        bboxes.append(np.stack([pts.min(0), pts.max(0)], -1))
    return pcds, np.stack(bboxes)


def unit_sphere_normalization(all_points: np.ndarray, bboxes: np.ndarray,
                              object_scale_in_sphere: float, pad_mm: np.ndarray
                              ) -> Tuple[np.ndarray, float, np.ndarray]:
    """(scale_mat [4, 4], radius, bbox_minmax [n, 3, 2] normalised).

    scale_mat maps normalised coordinates back to the scene: diag(radius)
    with the points' bbox centre as translation; radius is the largest
    distance from that centre over ``object_scale_in_sphere``. The bboxes
    are padded by ``pad_mm`` / radius (a negative pad shrinks)."""
    bbox_min = all_points.min(0)
    bbox_max = all_points.max(0)
    center = (bbox_min + bbox_max) / 2.0
    radius = np.linalg.norm(all_points - center, axis=-1).max() / object_scale_in_sphere
    scale_mat = np.diag([radius, radius, radius, 1.0]).astype(np.float32)
    scale_mat[:3, 3] = center

    pad_norm = np.asarray(pad_mm, np.float64) / radius
    raw = (bboxes - center[None, :, None]) / radius
    norm_bboxes = raw.copy()
    norm_bboxes[:, :, 0] -= pad_norm
    norm_bboxes[:, :, 1] += pad_norm
    # ENDONERF's x/y pad is negative (a shrink that trims boundary noise).
    # On a frame narrower than the shrink it would invert min > max, which
    # gives every grid built from the bbox descending axes: an axis the pad
    # inverted keeps its unpadded bounds.
    inverted = norm_bboxes[:, :, 0] > norm_bboxes[:, :, 1]
    norm_bboxes[inverted] = raw[inverted]
    return scale_mat, float(radius), norm_bboxes.astype(np.float32)


def train_test_split(n_frames: int, test_every: int) -> Tuple[List[int], List[int]]:
    """Frame i is a test frame when (i - 1) % test_every == 0."""
    list_train = [i for i in range(n_frames) if (i - 1) % test_every != 0]
    list_test = [i for i in range(n_frames) if (i - 1) % test_every == 0]
    return list_train, list_test
