"""Scene data (port of ``endosurf_tpu/data/scene_data.py``).

Loads the preprocessed info-pkl schema (per-frame world matrices, scale
matrix, colour/depth/mask image paths, depth normalisation, splits) into
tensors on one device, builds full-frame rays, and draws training batches
with the mask-guided pixel CDFs (the ``cdf`` pixel sampler) or Walker/Vose
alias tables over the same weights (``alias``). The alias tables are built
on the host the first time the ``alias`` sampler asks for them and cached in
the scene's arrays; a ``cdf`` run never builds them (the JAX package builds
and uploads both kinds for every scene). ``SceneData.export_debug_geometry``
writes the scene's point cloud, cameras and unit sphere as PLYs.
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp
import pickle
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from endosurf_tpu_torch.ops.geometry import rays_from_pixels
from endosurf_tpu_torch.ops.pdf import sample_from_alias, sample_from_cdf


def decompose_projection(P: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split P = K [R|t] into (intrinsics 4x4, camera-to-world pose 4x4)."""
    import scipy.linalg
    M = P[:3, :3]
    K, R = scipy.linalg.rq(M)
    signs = np.sign(np.diag(K))
    signs[signs == 0] = 1.0
    S = np.diag(signs)
    K = K @ S
    R = S @ R
    if np.linalg.det(R) < 0:
        K, R = -K, -R
    t_w2c = np.linalg.solve(K, P[:3, 3])
    K = K / K[2, 2]
    intrinsics = np.eye(4, dtype=np.float64)
    intrinsics[:3, :3] = K
    pose = np.eye(4, dtype=np.float64)
    pose[:3, :3] = R.T
    pose[:3, 3] = -R.T @ t_w2c
    return intrinsics.astype(np.float32), pose.astype(np.float32)


def _load_images(paths: Sequence[str], kind: str,
                 disp_const: Optional[Sequence[float]] = None) -> np.ndarray:
    import imageio.v2 as iio

    out = []
    for i, p in enumerate(paths):
        img = np.asarray(iio.imread(p))
        if kind == "color":
            arr = img[..., :3].astype(np.float32) / 255.0
        elif kind == "depth":
            arr = img.astype(np.float32)[..., None]
        elif kind == "disp":
            disp = img.astype(np.float32)
            arr = np.zeros_like(disp)
            nz = disp != 0
            arr[nz] = disp_const[i] / disp[nz]
            arr = arr[..., None]
        elif kind == "mask":
            arr = (img.astype(np.float32) / 255.0)[..., None]
        elif kind == "mask_invert":
            arr = (1.0 - img.astype(np.float32) / 255.0)[..., None]
        else:
            raise ValueError(f"unknown image kind {kind!r}")
        out.append(arr)
    return np.stack(out, axis=0)


@dataclasses.dataclass
class SceneData:
    """Host-side scene description with its tensors in ``device_arrays``."""

    dset_name: str
    scene_name: str
    n_frames: int
    h: int
    w: int
    depth_scale: float
    near: float
    far: float
    list_train: np.ndarray
    list_test: np.ndarray
    bbox_minmax: np.ndarray          # [n, 3, 2]
    intrinsics: np.ndarray           # [n, 4, 4]
    poses: np.ndarray                # [n, 4, 4]
    device_arrays: Dict[str, torch.Tensor]

    @staticmethod
    def load(info_path: str, normalize_time: bool = True,
             device: Any = "cpu") -> "SceneData":
        """Load a preprocessed scene from an info pkl."""
        if not osp.exists(info_path):
            raise FileNotFoundError(
                f"Info file {info_path} does not exist — preprocess the dataset first")
        with open(info_path, "rb") as f:
            info = pickle.load(f)

        colors = _load_images(info["color"], "color")
        depth_type = info["depth_type"]
        if depth_type == "depth":
            depths = _load_images(info["depth"], "depth")
        elif depth_type == "disp":
            depths = _load_images(info["depth"], "disp", disp_const=info["disp_const"])
        else:
            raise ValueError(f"unknown depth type {depth_type!r}")
        mask_type = info.get("mask_type")
        color_masks = (_load_images(info["mask"], mask_type) if mask_type is not None
                       else None)
        return SceneData.from_info(info, colors, depths, color_masks, normalize_time, device)

    @staticmethod
    def from_info(info: Dict[str, Any], colors: np.ndarray, depths: np.ndarray,
                  color_masks: Optional[np.ndarray] = None, normalize_time: bool = True,
                  device: Any = "cpu") -> "SceneData":
        """A scene from an info dict and its images as arrays: colors [n, H, W,
        3] in [0, 1], depths [n, H, W, 1] in the capture's units (divided by
        ``depth_norm_scale`` here), color_masks [n, H, W, 1] (ones when
        None), as ``load`` reads them from the info's paths."""
        n_frames = info["n_frames"]
        scale_mat = np.asarray(info["scale_mat"], np.float64)
        world_mat = np.asarray(info["world_mat"], np.float64)
        intrinsics, poses = [], []
        for i in range(n_frames):
            K, pose = decompose_projection((world_mat[i] @ scale_mat)[:3, :4])
            intrinsics.append(K)
            poses.append(pose)

        depth_scale = float(info["depth_norm_scale"])
        depths = depths / depth_scale
        if color_masks is None:
            color_masks = np.ones_like(depths)

        return SceneData.from_arrays(
            dset_name=info["dset_name"], scene_name=info["scene_name"],
            colors=colors, depths=depths, color_masks=color_masks,
            intrinsics=np.stack(intrinsics), poses=np.stack(poses),
            bounds=np.asarray(info["bounds"], np.float32) / depth_scale,
            bbox_minmax=np.asarray(info["bbox_minmax"], np.float32),
            list_train=np.asarray(info["list_train"], np.int32),
            list_test=np.asarray(info["list_test"], np.int32),
            depth_scale=depth_scale, normalize_time=normalize_time, device=device)

    @staticmethod
    def from_arrays(dset_name: str, scene_name: str, colors: np.ndarray,
                    depths: np.ndarray, color_masks: np.ndarray,
                    intrinsics: np.ndarray, poses: np.ndarray, bounds: np.ndarray,
                    bbox_minmax: np.ndarray, list_train: np.ndarray,
                    list_test: np.ndarray, depth_scale: float,
                    normalize_time: bool = True, device: Any = "cpu") -> "SceneData":
        n_frames, h, w = colors.shape[:3]
        # depth-validity band from global percentiles
        near = float(np.percentile(depths, 3.0))
        far = float(np.percentile(depths, 99.5))
        depth_masks = ((depths > near) & (depths < far)).astype(np.float32)
        masks = depth_masks * color_masks

        # Mask-guided ray importance: pixels often occluded across frames
        # are upweighted where visible; the colour-mask pre-filter and the
        # 1e-5 floor are folded into the per-pixel sampling weight.
        freq = (1.0 - masks).sum(0)
        p = freq / np.sqrt((freq ** 2).sum() + 1e-12)
        importance = masks * (1.0 + p)
        sample_w = (color_masks * (importance + 1e-5)).reshape(n_frames, -1)
        uniform_w = color_masks.reshape(n_frames, -1)

        def norm_cdf(w):
            cdf = np.cumsum(w + 1e-12, axis=-1)
            return (cdf / cdf[:, -1:]).astype(np.float32)

        if normalize_time:
            ts = np.linspace(0.0, 1.0, n_frames, dtype=np.float32)
        else:
            ts = np.arange(n_frames, dtype=np.float32)
        intrinsics_inv = np.linalg.inv(intrinsics[:, :3, :3]).astype(np.float32)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        device_arrays = {
            "colors": dev(colors),
            "depths": dev(depths),
            "masks": dev(masks),
            "color_masks": dev(color_masks),
            "depth_masks": dev(depth_masks),
            "intrinsics_inv": dev(intrinsics_inv),
            "poses": dev(poses),
            "bounds": dev(bounds),
            "ts": dev(ts),
            "sample_w": dev(sample_w),
            "uniform_w": dev(uniform_w),
            "sample_cdf": dev(norm_cdf(sample_w)),
            "uniform_cdf": dev(norm_cdf(uniform_w)),
            "list_train": torch.as_tensor(np.asarray(list_train, np.int64), device=device),
        }
        return SceneData(
            dset_name=dset_name, scene_name=scene_name, n_frames=n_frames,
            h=h, w=w, depth_scale=depth_scale, near=near, far=far,
            list_train=np.asarray(list_train), list_test=np.asarray(list_test),
            bbox_minmax=np.asarray(bbox_minmax), intrinsics=intrinsics,
            poses=poses, device_arrays=device_arrays)

    def export_debug_geometry(self, out_dir: str, downsample: float = 0.1) -> None:
        """Write the scene's geometry as PLYs for inspection in a viewer: every
        frame's RGBD point cloud in world space, kept at random (numpy seed 0)
        with probability ``downsample`` (``pointcloud.ply``), the camera
        centres in red (``cameras.ply``) and a unit-sphere shell
        (``unit_sphere.ply``), as the JAX package writes them."""
        from endosurf_tpu_torch.evaluation.geometry3d import rgbd_to_pointcloud
        from endosurf_tpu_torch.utils.ply import write_ply

        os.makedirs(out_dir, exist_ok=True)
        rng = np.random.default_rng(0)
        pts_all, col_all = [], []
        colors = self.device_arrays["colors"].cpu().numpy()
        depths = self.device_arrays["depths"].cpu().numpy()
        for i in range(self.n_frames):
            pts, col = rgbd_to_pointcloud(colors[i], depths[i], self.intrinsics[i][:3, :3],
                                          self.poses[i], self.far)
            keep = rng.uniform(size=len(pts)) < downsample
            pts_all.append(pts[keep])
            col_all.append(col[keep])
        write_ply(osp.join(out_dir, "pointcloud.ply"), np.concatenate(pts_all),
                  colors=np.concatenate(col_all))
        cams = self.poses[:, :3, 3]
        cam_col = np.zeros((len(cams), 3), np.float32)
        cam_col[:, 0] = 1.0
        write_ply(osp.join(out_dir, "cameras.ply"), cams, colors=cam_col)
        uu, vv = np.meshgrid(np.linspace(0, np.pi, 32), np.linspace(0, 2 * np.pi, 64))
        sphere = np.stack([np.sin(uu) * np.cos(vv), np.sin(uu) * np.sin(vv), np.cos(uu)],
                          -1).reshape(-1, 3)
        write_ply(osp.join(out_dir, "unit_sphere.ply"), sphere.astype(np.float32))


def alias_tables(arrays: Dict[str, torch.Tensor], mask_guided: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-frame alias tables (prob [n, H*W] float32, alias [n, H*W]
    int64) of the mask-guided (``sample_w``) or uniform (``uniform_w``) pixel
    weights: built on the host (``native.alias_table``) at the first call,
    uploaded to the arrays' device and cached in ``arrays``."""
    kind = "sample" if mask_guided else "uniform"
    if f"{kind}_alias_prob" not in arrays:
        from endosurf_tpu_torch.native import alias_table
        weights = arrays[f"{kind}_w"]
        prob, alias = alias_table(weights.cpu().numpy())
        arrays[f"{kind}_alias_prob"] = torch.as_tensor(prob, device=weights.device)
        arrays[f"{kind}_alias_idx"] = torch.as_tensor(alias.astype(np.int64),
                                                      device=weights.device)
    return arrays[f"{kind}_alias_prob"], arrays[f"{kind}_alias_idx"]


def frame_rays(arrays: Dict[str, torch.Tensor], h: int, w: int, fid: int) -> torch.Tensor:
    """Full-frame [H, W, 9] ray tensor on the arrays' device."""
    device = arrays["poses"].device
    py, px = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    rays_o, rays_d = rays_from_pixels(px, py, arrays["intrinsics_inv"][fid],
                                      arrays["poses"][fid])
    bounds = arrays["bounds"][fid].expand(h, w, 2)
    t = arrays["ts"][fid].expand(h, w, 1)
    return torch.cat([rays_o, rays_d, bounds, t], dim=-1)


def sample_train_batch(arrays: Dict[str, torch.Tensor], h: int, w: int, ray_batch: int,
                       mask_guided: bool = True, pixel_sampler: str = "cdf",
                       generator: Optional[torch.Generator] = None,
                       frame_draw: Optional[torch.Tensor] = None,
                       u_pix: Optional[torch.Tensor] = None,
                       j_pix: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One training batch: a random train frame and importance-drawn pixels.

    ``frame_draw`` (an index into ``list_train``) and the pixel draws are
    taken from ``generator`` unless given, in this order: the frame, then for
    the ``cdf`` sampler the uniforms ``u_pix`` [ray_batch] (inverse CDF), for
    ``alias`` the bins ``j_pix`` [ray_batch] (integers in [0, H*W)) and the
    uniforms ``u_pix`` (``ops.pdf.sample_from_alias``). The two samplers draw
    from the same weights (the ``cdf`` path floors each at 1e-12) with other
    draws, so their batches differ. Returns rays [B, 9] and the per-ray
    supervision, all on the arrays' device."""
    if pixel_sampler not in ("cdf", "alias"):
        raise ValueError(f"unknown pixel_sampler: {pixel_sampler!r}")
    list_train = arrays["list_train"]
    device = list_train.device
    if frame_draw is None:
        frame_draw = torch.randint(0, list_train.shape[0], (), generator=generator,
                                   device=device)
    fid = list_train[torch.as_tensor(frame_draw, device=device)]
    if pixel_sampler == "alias":
        prob, alias = alias_tables(arrays, mask_guided)
        if j_pix is None:
            j_pix = torch.randint(0, h * w, (ray_batch,), generator=generator, device=device)
        if u_pix is None:
            u_pix = torch.rand(ray_batch, generator=generator, device=device)
        pix = sample_from_alias(prob[fid], alias[fid], j_pix, u_pix)
    else:
        cdf = arrays["sample_cdf" if mask_guided else "uniform_cdf"][fid]
        pix = sample_from_cdf(cdf, ray_batch, generator, u_pix)

    py = torch.div(pix, w, rounding_mode="floor").to(torch.float32)
    px = (pix % w).to(torch.float32)
    rays_o, rays_d = rays_from_pixels(px, py, arrays["intrinsics_inv"][fid],
                                      arrays["poses"][fid])

    def gather(name):
        return arrays[name][fid].reshape(h * w, -1)[pix]

    bounds = arrays["bounds"][fid].expand(ray_batch, 2)
    t = arrays["ts"][fid].expand(ray_batch, 1)
    return {
        "rays": torch.cat([rays_o, rays_d, bounds, t], dim=-1),
        "color": gather("colors"),
        "depth": gather("depths"),
        "mask": gather("masks"),
        "color_mask": gather("color_masks"),
        "depth_mask": gather("depth_masks"),
        "frame_id": fid,
    }


def make_synthetic_arrays(n_frames: int = 4, h: int = 16, w: int = 16,
                          seed: int = 0, device: Any = "cpu") -> SceneData:
    """In-memory random-content scene (no file IO), seeded with numpy: the
    same arrays as the JAX package's ``make_synthetic_arrays``."""
    rng = np.random.default_rng(seed)
    colors = rng.uniform(0, 1, (n_frames, h, w, 3)).astype(np.float32)
    depths = rng.uniform(1.4, 2.4, (n_frames, h, w, 1)).astype(np.float32)
    color_masks = np.ones((n_frames, h, w, 1), np.float32)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 0.8 * w
    K[0, 2], K[1, 2] = w / 2, h / 2
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -2.0
    ids = np.arange(n_frames)
    return SceneData.from_arrays(
        dset_name="synthetic", scene_name="arrays",
        colors=colors, depths=depths, color_masks=color_masks,
        intrinsics=np.tile(K, (n_frames, 1, 1)),
        poses=np.tile(pose, (n_frames, 1, 1)),
        bounds=np.tile(np.array([1.0, 3.0], np.float32), (n_frames, 1)),
        bbox_minmax=np.tile(np.array([[-1, 1], [-1, 1], [-1, 1]], np.float32),
                            (n_frames, 1, 1)),
        list_train=ids[:-1], list_test=ids[-1:], depth_scale=100.0, device=device)


def _orbit_pose(t_norm: float, orbit_deg: float, dist: float = 2.0) -> np.ndarray:
    """Camera-to-world pose [4, 4] on a look-at orbit around the origin.

    The azimuth sweeps +-orbit_deg (the elevation +-orbit_deg / 2) over the
    sequence; orbit_deg = 0 is the fixed camera at (0, 0, -dist) with the
    identity rotation. R's columns are the camera axes (x right, y down, z
    forward: the image convention of ``rays_from_pixels``)."""
    az = np.radians(orbit_deg) * np.sin(2 * np.pi * t_norm)
    el = np.radians(0.5 * orbit_deg) * np.cos(2 * np.pi * t_norm)
    C = dist * np.array([np.sin(az) * np.cos(el), np.sin(el), -np.cos(az) * np.cos(el)])
    z_cam = -C / np.linalg.norm(C)
    x_cam = np.cross([0.0, 1.0, 0.0], z_cam)
    x_cam = x_cam / np.linalg.norm(x_cam)
    y_cam = np.cross(z_cam, x_cam)
    pose = np.eye(4)
    pose[:3, :3] = np.stack([x_cam, y_cam, z_cam], axis=1)
    pose[:3, 3] = C
    return pose


def make_synthetic_scene(out_dir: str, n_frames: int = 8, h: int = 48, w: int = 64,
                         deform_amp: float = 0.1, seed: int = 0,
                         orbit_deg: float = 0.0) -> str:
    """Write a synthetic pulsating-sphere scene in the info-pkl schema and
    return the pkl's path: colour PNGs, float32 TIFF depths, mask PNGs
    (imageio, imported here) and ``info.pkl``, as the JAX package's
    ``make_synthetic_scene`` writes them.

    A Lambertian sphere of radius 0.5 (1 + deform_amp sin(2 pi t)) at the
    origin, seen from distance 2: a fixed camera at z = -2 looking down +z
    for orbit_deg = 0, else a +-orbit_deg look-at arc. Depths are world-z
    depths times ``depth_norm_scale`` = 100; a drifting rectangular tool
    occludes each frame's mask."""
    import imageio.v2 as iio

    os.makedirs(out_dir, exist_ok=True)
    fx = fy = 0.8 * w
    cx, cy = w / 2.0, h / 2.0
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    depth_norm_scale = 100.0

    world_mats, colors, depths, masks, bboxes, bounds = [], [], [], [], [], []
    # rays go through integer pixel coordinates (rays_from_pixels)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64),
                         indexing="ij")
    dirs_cam = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], -1)

    for i in range(n_frames):
        t_norm = i / max(n_frames - 1, 1)
        radius = 0.5 * (1.0 + deform_amp * np.sin(2 * np.pi * t_norm))
        pose = _orbit_pose(t_norm, orbit_deg)
        R, o = pose[:3, :3], pose[:3, 3]
        w2c = np.linalg.inv(pose)
        # analytic ray-sphere hit in world space from the camera centre o
        d = dirs_cam @ R.T
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        b = np.sum(d * o, -1)
        c = np.sum(o * o) - radius ** 2
        disc = b ** 2 - c
        hit = disc > 0
        t_hit = -b - np.sqrt(np.maximum(disc, 0.0))
        pts = o + t_hit[..., None] * d
        # World-z depth (the 9-float ray contract divides directions by their
        # world z): valid while every ray keeps a positive world z.
        z_depth = np.where(hit, pts[..., 2] - o[2], 3.0)  # background at z = 3
        if not (d[..., 2] > 0.05).all():
            raise ValueError("orbit too wide for the world-z depth convention")

        normal = pts / np.maximum(np.linalg.norm(pts, axis=-1, keepdims=True), 1e-6)
        lam = np.clip(-np.sum(normal * d, -1), 0, 1)
        base = 0.5 + 0.5 * np.sin(6 * pts[..., 0]) * np.cos(6 * pts[..., 1])
        col = np.stack([lam * base, lam * (1 - base), 0.3 + 0.7 * lam], -1)
        col = np.where(hit[..., None], col, 0.05)

        mask = np.ones((h, w), np.float32)
        x0 = int((0.2 + 0.5 * t_norm) * w)
        mask[h // 3: h // 2, x0: x0 + w // 6] = 0.0

        world_mats.append(K @ w2c[:3, :4])
        colors.append((np.clip(col, 0, 1) * 255).astype(np.uint8))
        depths.append((z_depth * depth_norm_scale).astype(np.float32))
        masks.append((mask * 255).astype(np.uint8))
        pad = 0.05
        pts_box = pts[hit] if hit.any() else pts.reshape(-1, 3)
        bboxes.append(np.stack([pts_box.min(0) - pad, pts_box.max(0) + pad], -1))
        z_near = z_depth[hit].min() if hit.any() else z_depth.min()
        bounds.append(np.array([z_near, z_depth.max()]) * depth_norm_scale)

    color_paths, depth_paths, mask_paths = [], [], []
    for i in range(n_frames):
        cp = osp.join(out_dir, f"color_{i:03d}.png")
        dp = osp.join(out_dir, f"depth_{i:03d}.tiff")
        mp = osp.join(out_dir, f"mask_{i:03d}.png")
        iio.imwrite(cp, colors[i])
        iio.imwrite(dp, depths[i])
        iio.imwrite(mp, masks[i])
        color_paths.append(cp)
        depth_paths.append(dp)
        mask_paths.append(mp)

    world_mat4 = np.zeros((n_frames, 4, 4))
    world_mat4[:, :3, :4] = np.stack(world_mats)
    world_mat4[:, 3, 3] = 1.0
    ids = np.arange(n_frames)
    info = {
        "dset_name": "synthetic",
        "scene_name": "pulsating_sphere",
        "n_frames": n_frames,
        "wh": [w, h],
        "world_mat": world_mat4,
        "scale_mat": np.eye(4),
        "color": color_paths,
        "depth": depth_paths,
        "depth_type": "depth",
        "mask": mask_paths,
        "mask_type": "mask",
        "depth_norm_scale": depth_norm_scale,
        "bounds": np.stack(bounds),
        "bbox_minmax": np.stack(bboxes),
        "list_train": ids[ids % 4 != 3],
        "list_test": ids[ids % 4 == 3],
    }
    pkl_path = osp.join(out_dir, "info.pkl")
    with open(pkl_path, "wb") as f:
        pickle.dump(info, f)
    return pkl_path
