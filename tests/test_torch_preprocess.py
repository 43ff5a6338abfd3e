"""The port's raw-capture preprocessing held against the JAX package on the
CPU: the ENDONERF and SCARED info pkls of ``tests/test_preprocess.py``'s
synthetic raw captures (every array bit for bit; splits, sizes and paths
equal, each side's paths under its own copy of the capture), the arrays
cores against the file readers, the two native wrappers, the numpy mask
closing against ``cv2.morphologyEx`` and ``make_synthetic_scene``.

Tolerance: none. The port runs the same numpy operations in the same order
and a copy of the same C++ KD-tree, so every output is bitwise equal.
"""

import json
import os
import os.path as osp
import pickle

import cv2
import imageio.v2 as iio
import numpy as np
import pytest
import torch

from endosurf_tpu.data import preprocess_endonerf as j_pe
from endosurf_tpu.data import preprocess_scared as j_ps
from endosurf_tpu.data import scene_data as j_sd
from endosurf_tpu.native import meshops as j_mesh
from endosurf_tpu_torch.data import preprocess_endonerf as t_pe
from endosurf_tpu_torch.data import preprocess_scared as t_ps
from endosurf_tpu_torch.data import scene_data as t_sd
from endosurf_tpu_torch.native import meshops as t_mesh
from test_preprocess import make_raw_endonerf, make_raw_scared


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_info_equal(got, ref, root_got="", root_ref=""):
    """Every key equal; arrays bit for bit with their dtypes; paths equal
    after swapping each side's root."""
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k]
        if isinstance(r, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == r.dtype, k
            np.testing.assert_array_equal(g, r, err_msg=k)
        elif k in ("color", "depth", "mask"):
            assert [p.replace(root_got, root_ref, 1) for p in g] == list(r), k
        elif k == "disp_const":
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r), err_msg=k)
        else:
            assert g == r and type(g) is type(r), (k, g, r)


def _scene_equal(a, b):
    assert (a.n_frames, a.h, a.w, a.near, a.far) == (b.n_frames, b.h, b.w, b.near, b.far)
    for k in ("intrinsics", "poses", "bbox_minmax"):
        np.testing.assert_array_equal(getattr(a, k), np.asarray(getattr(b, k)), err_msg=k)
    for k, v in a.device_arrays.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(b.device_arrays[k]), err_msg=k)


def test_endonerf_pkl_matches_jax(tmp_path):
    raw = str(tmp_path / "pulling_soft_tissues")
    make_raw_endonerf(raw)
    ref = _load(j_pe.create_endonerf_info(raw, str(tmp_path / "info_jax"), test_every=4))
    pkl = t_pe.create_endonerf_info(raw, str(tmp_path / "info_torch"), test_every=4)
    _assert_info_equal(_load(pkl), ref)
    assert ref["n_frames"] == 6 and ref["wh"] == [40, 32]
    _scene_equal(t_sd.SceneData.load(pkl), j_sd.SceneData.load(pkl))


@pytest.mark.parametrize("scale_factor", [1, 2])
def test_scared_pkl_matches_jax(tmp_path, scale_factor):
    """Each side on its own copy of the capture (the reader writes the
    processed images beside it): pkls and written images equal. At scale 2
    both resize with cv2 (w 320 -> 160, closing kernel 1); at scale 1 the
    closing kernel is 2 (even)."""
    out = {}
    for side, mod in (("jax", j_ps), ("torch", t_ps)):
        raw = str(tmp_path / side / "dataset_9_keyframe_9")
        make_raw_scared(raw)
        pkl = mod.create_scared_info(raw, str(tmp_path / side / "info"), skip_every=2,
                                     test_every=2, disp_type="disparity",
                                     scale_factor=scale_factor)
        out[side] = (pkl, _load(pkl))
    ref, got = out["jax"][1], out["torch"][1]
    _assert_info_equal(got, ref, str(tmp_path / "torch"), str(tmp_path / "jax"))
    assert got["n_frames"] == 3 and got["wh"] == [320 // scale_factor, 48 // scale_factor]
    for key in ("color", "depth", "mask"):
        for p_got, p_ref in zip(got[key], ref[key]):
            np.testing.assert_array_equal(iio.imread(p_got), iio.imread(p_ref), err_msg=p_got)
    _scene_equal(t_sd.SceneData.load(out["torch"][0]), j_sd.SceneData.load(out["jax"][0]))


def test_endonerf_core_equals_reader(tmp_path):
    """The arrays core on arrays read here equals the file reader's pkl, and
    leaves the caller's depths unchanged."""
    raw = str(tmp_path / "cap")
    make_raw_endonerf(raw, n_frames=5)
    pkl = t_pe.create_endonerf_info(raw, str(tmp_path / "info"), test_every=2)
    names = sorted(os.listdir(osp.join(raw, "images")))
    paths = {k: [osp.join(raw, d, n) for n in names]
             for k, d in (("color", "images"), ("depth", "depth"), ("mask", "masks"))}
    colors = np.stack([iio.imread(p)[..., :3] / np.float32(255) for p in paths["color"]])
    depths = np.stack([iio.imread(p).astype(np.float32) for p in paths["depth"]])
    masks = np.stack([1.0 - iio.imread(p).astype(np.float32) / 255.0 for p in paths["mask"]])
    before = depths.copy()
    times = {}
    info = t_pe.endonerf_info_from_arrays(np.load(osp.join(raw, "poses_bounds.npy")), colors,
                                          depths, masks, "cap", test_every=2, paths=paths,
                                          times=times)
    _assert_info_equal(info, _load(pkl))
    np.testing.assert_array_equal(depths, before)
    assert set(times) == {"pointclouds", "denoise", "normalization"}
    with pytest.raises(ValueError, match="Mismatch"):
        t_pe.endonerf_info_from_arrays(np.load(osp.join(raw, "poses_bounds.npy")), colors[:4],
                                       depths, masks, "cap")


def test_scared_core_equals_reader(tmp_path):
    raw = str(tmp_path / "dataset_1_keyframe_1")
    make_raw_scared(raw, n_frames=4)
    pkl = t_ps.create_scared_info(raw, str(tmp_path / "info"), skip_every=1, test_every=8,
                                  disp_type="disparity")
    data = osp.join(raw, "data")
    fids = sorted(f[:-5] for f in os.listdir(osp.join(data, "frame_data")))
    calibs = [json.load(open(osp.join(data, "frame_data", f"{i}.json"))) for i in fids]
    info, processed = t_ps.scared_info_from_arrays(
        [c["camera-calibration"]["KL"] for c in calibs], [c["camera-pose"] for c in calibs],
        [json.load(open(osp.join(data, "reprojection_data", f"{i}.json")))
         ["reprojection-matrix"] for i in fids],
        [iio.imread(osp.join(data, "left_finalpass", f"{i}.png")) for i in fids],
        [iio.imread(osp.join(data, "disparity", f"{i}.tiff")) for i in fids],
        "dataset_1_keyframe_1", test_every=8, disp_type="disparity")
    ref = _load(pkl)
    _assert_info_equal({**info, **{k: ref[k] for k in ("color", "depth", "mask")}}, ref)
    for i, p in enumerate(ref["mask"]):
        np.testing.assert_array_equal(processed["mask"][i], iio.imread(p))


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[: n // 20] *= 8.0   # a sparse halo of outliers
    pts[5] = pts[6]         # a duplicate point
    return pts


@pytest.mark.parametrize("seed", [0, 1])
def test_native_wrappers_match_jax(seed):
    pts = _cloud(600, seed)
    nn_t, nn_j = t_mesh.nn_distance_excl_self(pts), j_mesh.nn_distance_excl_self(pts)
    assert nn_t.dtype == nn_j.dtype == np.float32
    np.testing.assert_array_equal(nn_t, nn_j)
    radius = float(nn_t.mean()) * 2.0
    for k in (1, 5, 20):
        keep_t = t_mesh.radius_outlier_mask(pts, k, radius)
        keep_j = j_mesh.radius_outlier_mask(pts, k, radius)
        assert keep_t.dtype == bool
        np.testing.assert_array_equal(keep_t, keep_j)
        assert 0 < keep_t.sum() < len(pts)


@pytest.mark.parametrize("k", [1, 2, 3, 10])
def test_close_mask_matches_cv2(k):
    """The numpy closing equals cv2's on random masks with ones and holes on
    every edge and corner, at odd and even kernels (an even window is off
    centre: anchor k // 2)."""
    rng = np.random.default_rng(k)
    for shape, p_on in (((37, 53), 0.5), ((48, 320), 0.8), ((64, 41), 0.15)):
        m = (rng.uniform(size=shape) < p_on).astype(np.float32)
        m[0, ::3] = 1.0
        m[-1, 1::4] = 1.0
        m[::5, 0] = 1.0
        m[2::3, -1] = 1.0
        m[0, 0] = m[-1, -1] = 0.0
        m[0, -1] = m[-1, 0] = 1.0
        ref = cv2.morphologyEx(m, cv2.MORPH_CLOSE, np.ones((k, k), np.uint8))
        got = t_ps.close_mask(m, k)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("orbit_deg", [0.0, 10.0])
def test_make_synthetic_scene_matches_jax(tmp_path, orbit_deg):
    kw = dict(n_frames=5, h=12, w=16, deform_amp=0.2, seed=3, orbit_deg=orbit_deg)
    ref = _load(j_sd.make_synthetic_scene(str(tmp_path / "jax"), **kw))
    pkl = t_sd.make_synthetic_scene(str(tmp_path / "torch"), **kw)
    got = _load(pkl)
    _assert_info_equal(got, ref, str(tmp_path / "torch"), str(tmp_path / "jax"))
    for key in ("color", "depth", "mask"):
        for p_got, p_ref in zip(got[key], ref[key]):
            np.testing.assert_array_equal(iio.imread(p_got), iio.imread(p_ref))
    np.testing.assert_array_equal(t_sd._orbit_pose(0.3, 20.0), j_sd._orbit_pose(0.3, 20.0))
    scene = t_sd.SceneData.load(pkl)
    assert scene.n_frames == 5 and scene.device_arrays["colors"].dtype == torch.float32
