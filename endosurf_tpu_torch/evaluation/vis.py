"""Visualization helpers: image conversion, composition, video/gif writing.

A copy of ``endosurf_tpu/evaluation/vis.py`` (numpy only; the JAX package
cannot be imported where the port runs), plus ``composite_rows``, the panel
row that eval and demo output share. OpenCV and imageio are imported only by
the helpers that draw text or write files.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def to8b(x: np.ndarray) -> np.ndarray:
    return (255.0 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


def add_text(img: np.ndarray, text: str) -> np.ndarray:
    import cv2
    if not np.issubdtype(img.dtype, np.uint8):
        img = to8b(img)
    return cv2.putText(img.copy(), text, (10, 50),
                       cv2.FONT_HERSHEY_SIMPLEX, 2, (255, 0, 0), 4,
                       cv2.LINE_AA)


def rgb_to_show(rgb: np.ndarray) -> np.ndarray:
    return np.uint8((np.asarray(rgb) * 256).clip(0, 255))


def depth_to_show(depth: np.ndarray, depth_max: float) -> np.ndarray:
    """Inverted grayscale depth (utils.py:223-246)."""
    d = np.asarray(depth)
    if d.shape[-1] != 1:
        d = d[..., None]
    show = np.uint8(255.0 - np.clip(d / depth_max, 0, 1) * 255.0)
    return np.concatenate([show, show, show], axis=-1)


def normal_to_show(normal_world: np.ndarray, poses: np.ndarray) -> np.ndarray:
    """Rotate world normals into each camera frame and colorize
    (utils.py:186-205). normal_world: [n,H,W,3]; poses: [n,4,4]."""
    n = np.asarray(normal_world)
    n = n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-10)
    rot = np.linalg.inv(poses[:, :3, :3])
    flat = n.reshape(n.shape[0], -1, 3)
    cam = np.matmul(rot[:, None], flat[..., None])[..., 0].reshape(n.shape)
    return np.uint8((cam * 128 + 128).clip(0, 255))


def normal_from_depth(rays: np.ndarray, depths: np.ndarray) -> np.ndarray:
    """Cross-product normals from a depth map (utils.py:314-335).

    rays: [n,H,W,9]; depths: [n,H,W,1]. Returns camera-facing normal images
    [n,H,W,3] (zero border padding), already negated like the reference.
    """
    rays = np.asarray(rays)
    depths = np.asarray(depths)
    pts = rays[..., :3] + rays[..., 3:6] * depths
    u = pts[:, 1:-1, :-2] - pts[:, 1:-1, 1:-1]
    v = pts[:, :-2, 1:-1] - pts[:, 1:-1, 1:-1]
    n = np.cross(u, v)
    n = n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-10)
    out = np.zeros((*depths.shape[:-1], 3), np.float32)
    out[:, 1:-1, 1:-1] = -n
    return out


def filter_depth(depth_stack: np.ndarray, params: Sequence[float]
                 ) -> np.ndarray:
    """Median + bilateral depth filtering for demo output (utils.py:236-243).

    params = [d, sigma_color, sigma_space] as in the reference's
    demo.depth_filter config entry.
    """
    import cv2
    out = []
    for d in np.asarray(depth_stack):
        img = d[..., 0] if d.ndim == 3 else d
        img = cv2.medianBlur(img, 3)
        img = cv2.bilateralFilter(img, int(params[0]), params[1], params[2])
        out.append(img)
    return np.stack(out)[..., None]


def hstack_labeled(images: Sequence[np.ndarray], labels: Sequence[str],
                   max_width: int = 6000) -> np.ndarray:
    import cv2
    row = np.hstack([add_text(im, lb) for im, lb in zip(images, labels)])
    if row.shape[1] > max_width:
        scale = max_width / row.shape[1]
        row = cv2.resize(row, (max_width, int(row.shape[0] * scale)))
    return row


def composite_rows(scene, fids: Sequence[int], pred) -> List[np.ndarray]:
    """One labelled row per frame: rgb_gt | rgb_pred | depth_gt | depth_pred
    (| normal_pred when ``pred`` has normals), from the scene's ground truth
    and the predicted numpy stacks of ``render_full_frames``."""
    rgb_gt = scene.device_arrays["colors"][fids].cpu().numpy()
    depth_gt = scene.device_arrays["depths"][fids].cpu().numpy()
    normal_show = (normal_to_show(pred["normal"], scene.poses[fids])
                   if "normal" in pred else None)
    rows = []
    for i in range(len(fids)):
        panels = [rgb_to_show(rgb_gt[i]), rgb_to_show(pred["rgb"][i]),
                  depth_to_show(depth_gt[i], scene.far),
                  depth_to_show(pred["depth"][i], scene.far)]
        labels = ["rgb_gt", "rgb_pred", "depth_gt", "depth_pred"]
        if normal_show is not None:
            panels.append(normal_show[i])
            labels.append("normal_pred")
        rows.append(hstack_labeled(panels, labels))
    return rows


def write_video(path: str, frames: List[np.ndarray], fps: int = 10) -> None:
    import cv2
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()


def write_gif(path: str, frames: List[np.ndarray], fps: int = 10) -> None:
    import imageio.v2 as iio
    with iio.get_writer(path, mode="I", duration=1.0 / fps) as w:
        for f in frames:
            w.append_data(f)
