"""The EndoNeRF (D-NeRF) field of the port held against the JAX package on
the CPU: the init, the field (the segment maths) and ``density_observed``,
the three segment maths (float32 and bf16 operands), the forward segments against
JAX's Pallas segment kernels in interpret mode, the plain
``fused_density_raw`` against JAX's interpreted kernel (with and without the
deform net), ``fine_resample_math`` against JAX's interpreted
``fused_fine_resample``, raw2outputs, and the bridge of a JAX D-NeRF tree.

Inputs come from numpy seeds; JAX runs at precision "highest" and the port's
float32 dots are float32 (no TF32 on the CPU).

Tolerances: float32 1e-5 absolute (both sides run the same float32 math in
other summation orders). bf16 operands on both sides: 1e-4 absolute on all
but 1 point in 64, 3e-3 on every point (an operand on a bf16 rounding edge
rounds the other way on one side, as in test_torch_sdf_query.py). The
resampled depths: 1e-5 on all but 1 ray in 16 and 5e-3 on every ray. JAX
sums the cdf by a lane scan, the port by a running sum: a float32 ulp of the
cdf moves a deterministic draw that sits on a cdf step or in a bin that
holds only the 1e-5 weight floor (ROADMAP C). The coarse densities here are
harsh on purpose (a quarter of the rays empty, many empty bins): read 9 of
256 rays over 1e-5, the worst 1.9e-3.
"""

import dataclasses
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endosurf_tpu.kernels import fused_sampler as j_fs
from endosurf_tpu.kernels import fused_sdf as j_fsd
from endosurf_tpu.kernels import fused_train as j_ft
from endosurf_tpu.kernels import fused_train_dnerf as j_ftd
from endosurf_tpu.models import endonerf as j_en
from endosurf_tpu.ops import mlp as j_mlp
from endosurf_tpu_torch.bridge import load_params_npz, params_from_jax, save_params_npz
from endosurf_tpu_torch.kernels import fused_sampler as t_fs
from endosurf_tpu_torch.kernels import fused_sdf as t_fsd
from endosurf_tpu_torch.kernels import fused_train_dnerf as t_ftd
from endosurf_tpu_torch.models import endonerf as t_en

F32_TOL = 1e-5
BF16_TOL, BF16_LOOSE, BF16_FRAC = 1e-4, 3e-3, 1.0 / 64
SMALL = dict(deform_layers=(3, 64, (1,)), density_layers=(3, 64, (1,)),
             color_layers=(2, 64, ()), geo_feat_dim=32)


def _specs(**kw):
    return j_en.DNeRFSpec(**kw), t_en.DNeRFSpec(**kw)


@pytest.fixture(autouse=True)
def _highest():
    j_mlp.set_matmul_precision("highest")
    j_ft.set_compute_mode(jnp.float32, "highest")
    yield
    j_ft.set_compute_mode(jnp.float32, "highest")


def _params(js, seed):
    pj = j_en.init_dnerf_params(jax.random.PRNGKey(seed), js)
    return pj, params_from_jax(pj)


def _points(n, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    t = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return x, d / np.linalg.norm(d, axis=-1, keepdims=True), t


def _close_bf16(got, ref):
    err = np.abs(np.asarray(got) - np.asarray(ref)).reshape(len(ref), -1).max(-1)
    assert err.max() <= BF16_LOOSE and (err > BF16_TOL).mean() <= BF16_FRAC, (
        err.max(), (err > BF16_TOL).mean())


@pytest.mark.parametrize("use_deform", [True, False], ids=["deform", "static"])
def test_init_shapes_match_jax(use_deform):
    js, ts = _specs(use_deform=use_deform)
    pj = j_en.init_dnerf_params(jax.random.PRNGKey(0), js)
    pt = t_en.init_dnerf_params(ts, torch.Generator().manual_seed(0))
    shapes = {k: [{n: tuple(v.shape) for n, v in layer.items()} for layer in net["layers"]]
              for k, net in pj.items()}
    assert shapes == {k: [{n: tuple(v.shape) for n, v in layer.items()} for layer in net["layers"]]
                      for k, net in pt.items()}
    # torch-default Linear ranges, as the JAX init draws them
    w0 = pt["density"]["layers"][0]["w"]
    assert float(w0.abs().max()) <= 1.0 / np.sqrt(w0.shape[0])


@pytest.mark.parametrize("spec_kw", [SMALL, {}, dict(SMALL, use_deform=False)],
                         ids=["small", "full", "small-static"])
def test_field_and_density_match_jax(spec_kw):
    js, ts = _specs(**spec_kw)
    pj, pt = _params(js, 2)
    x, d, t = _points(64)
    rgb_j, raw_j = j_en._field_raw(js, pj, jnp.asarray(x), jnp.asarray(d), jnp.asarray(t))
    rgb_t, sigma_t = t_en.field_eval(ts, pt, *map(torch.from_numpy, (x, d, t)))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(sigma_t.numpy(), np.maximum(np.asarray(raw_j), 0), rtol=0,
                               atol=F32_TOL)
    dens_j = j_en.density_observed(js, pj, jnp.asarray(x), jnp.asarray(t))
    dens_t = t_en.density_observed(ts, pt, torch.from_numpy(x), torch.from_numpy(t))
    assert dens_t.shape == (64, 1)
    np.testing.assert_allclose(dens_t.numpy(), np.asarray(dens_j), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(dens_t.numpy()[:, 0], np.asarray(raw_j), rtol=0, atol=F32_TOL)


def _jax_segments(js, pj, x, d, t):
    """JAX's segment maths on its own chain: (x_c, raw, feat, rgb)."""
    eff = j_ftd.prepare_effective_dnerf(js, pj)
    consts = j_ftd.selectors_dnerf(js)
    xt = j_ft.pad_lanes(jnp.asarray(x), jnp.asarray(t))
    x_c = j_ftd.seg_deform_math(eff["deform"], consts, xt) if js.use_deform else xt
    raw, feat = j_ftd.seg_density_math(eff["density"], eff["sigma_head"], eff["geo_feat"],
                                       consts, x_c)
    rgb = j_ftd.seg_color_math(eff["color"], consts, j_ft.pad_lanes(jnp.asarray(d)), feat)
    return (np.asarray(x_c)[:, :3], np.asarray(raw), np.asarray(feat), np.asarray(rgb)[:, :3])


@pytest.mark.parametrize("precision", ["highest", "default"], ids=["f32", "bf16"])
@pytest.mark.parametrize("spec_kw", [SMALL, {}], ids=["small", "full"])
def test_segment_math_matches_jax(spec_kw, precision):
    """Each segment on the same inputs (JAX's own chain values), float32 and
    bf16 operands (JAX's compute mode bfloat16: every dot operand rounded,
    the coordinates included)."""
    js, ts = _specs(**spec_kw)
    pj, pt = _params(js, 3)
    x, d, t = _points(256, seed=4)
    if precision == "default":
        j_ft.set_compute_mode(jnp.bfloat16, None)
    x_c, raw, feat, rgb = (a.copy() for a in _jax_segments(js, pj, x, d, t))
    eff = t_ftd.prepare_effective_dnerf(ts, pt)
    got_xc = t_ftd.seg_deform_math(ts, eff["deform"], torch.from_numpy(np.concatenate([x, t], 1)),
                                   precision)
    got_raw, got_feat = t_ftd.seg_density_math(ts, eff["density"], eff["sigma_head"],
                                               eff["geo_feat"], torch.from_numpy(x_c), precision)
    got_rgb = t_ftd.seg_color_math(ts, eff["color"], torch.from_numpy(d), torch.from_numpy(feat),
                                   precision)
    for got, ref in ((got_xc, x_c), (got_raw, raw), (got_feat, feat), (got_rgb, rgb)):
        assert tuple(got.shape) == ref.shape
        if precision == "highest":
            np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F32_TOL)
        else:
            _close_bf16(got.numpy(), ref)
    if precision == "default":     # the bf16 limits reject the float32 segment
        f32 = t_ftd.seg_deform_math(ts, eff["deform"],
                                    torch.from_numpy(np.concatenate([x, t], 1)), "highest")
        assert float((f32 - got_xc).abs().max()) > BF16_LOOSE


def test_forward_segments_match_jax_pallas_kernels():
    """The port's field on CPU tensors (``field_eval`` -> the segment maths
    of ``megakernel_field_raw``) against JAX's forward segment kernels
    (``_deform_fwd_pl`` / ``_density_fwd_pl`` / ``_color_fwd_pl``, forced on,
    interpreted on the CPU)."""
    js, ts = _specs(**SMALL)
    pj, pt = _params(js, 5)
    x, d, t = _points(33, seed=6)
    rgb_j, raw_j = j_ftd.megakernel_field_raw(js, pj, jnp.asarray(x), jnp.asarray(d),
                                              jnp.asarray(t), force_kernel=True)
    rgb_t, sigma_t = t_en.field_eval(ts, pt, *map(torch.from_numpy, (x, d, t)))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(sigma_t.numpy(), np.maximum(np.asarray(raw_j), 0), rtol=0,
                               atol=F32_TOL)


def test_megakernel_modes_on_cpu(tmp_path):
    """The CPU field is the segment maths (``forward_math``) at every
    ``train.megakernel`` mode: field_eval takes no mode, the EndoNeRF
    renderer takes "auto" / "on" / "off" on the CPU and refuses an unknown
    one; the train-time noise comes only with a generator."""
    from endosurf_tpu_torch.data.scene_data import make_synthetic_arrays
    from endosurf_tpu_torch.serve import EndoNeRFRenderer
    js, ts = _specs(**SMALL)
    _, pt = _params(js, 7)
    x, d, t = map(torch.from_numpy, _points(40, seed=8))
    ref = t_ftd.forward_math(ts, t_ftd.prepare_effective_dnerf(ts, pt), x, t, d)
    rgb, raw = t_ftd.megakernel_field_raw(ts, pt, x, d, t)
    torch.testing.assert_close(rgb, ref["rgb"], rtol=0, atol=0)
    torch.testing.assert_close(raw, ref["raw_sigma"][:, 0], rtol=0, atol=0)
    rgb_e, sigma = t_en.field_eval(ts, pt, x, d, t)
    torch.testing.assert_close(rgb_e, rgb, rtol=0, atol=0)
    torch.testing.assert_close(sigma, torch.relu(raw), rtol=0, atol=0)
    scene = make_synthetic_arrays(n_frames=2, h=4, w=4, seed=0)
    cfg = {"exp": {"project_name": "p", "exp_name": "e", "exp_dir": str(tmp_path)},
           "render": {"type": "endonerf"}, "net": {}}
    for mode in ("auto", "on", "off"):
        EndoNeRFRenderer(dict(cfg, train={"megakernel": mode}), scene=scene, device="cpu")
    with pytest.raises(ValueError, match="megakernel mode"):
        EndoNeRFRenderer(dict(cfg, train={"megakernel": "sometimes"}), scene=scene, device="cpu")
    gen = torch.Generator().manual_seed(0)
    noisy = t_en.field_eval(ts, pt, x, d, t, generator=gen)[1]
    assert float((noisy - sigma).abs().max()) > 0.1      # train-time noise only with a generator


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_deform", [True, False], ids=["deform", "static"])
def test_fused_density_raw_matches_jax_kernel(use_deform, dtype):
    js, ts = _specs(**SMALL, **({} if use_deform else {"use_deform": False}))
    pj, pt = _params(js, 9)
    x, _, t = _points(300, seed=10)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                       torch.bfloat16)
    ref = np.asarray(j_fsd.fused_density_raw(js, pj, jnp.asarray(x), jnp.asarray(t),
                                             compute_dtype=jd, interpret=True))
    got = t_fsd.fused_density_raw(ts, pt, torch.from_numpy(x), torch.from_numpy(t), td)
    assert got.shape == (300, 1) and got.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F32_TOL)
    else:
        _close_bf16(got.numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_deform", [True, False], ids=["deform", "static"])
def test_fused_density_raw_float64_matches_jax_kernel(use_deform, dtype):
    """The float64 yardstick of the bf16 raw density query
    (fused_density_raw_float64: the plain chain in float64 on the float32
    weights, coordinates unrounded) against JAX's interpreted
    fused_density_raw at the same dot precision, 300 points: float32 within
    F32_TOL (float64 against float32 sums), bf16 operand roundings on both
    sides within the bf16 limits of test_fused_density_raw_matches_jax_kernel
    (an operand on a rounding edge rounds the other way now and then). The
    control: the float32 yardstick fails the bf16 limits against JAX's bf16
    kernel, more than 10 BF16_FRAC of its points over BF16_TOL (read 74-96
    %), so the rounding is on."""
    js, ts = _specs(**SMALL, **({} if use_deform else {"use_deform": False}))
    pj, pt = _params(js, 9)
    x, _, t = _points(300, seed=10)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                       torch.bfloat16)
    ref = np.asarray(j_fsd.fused_density_raw(js, pj, jnp.asarray(x), jnp.asarray(t),
                                             compute_dtype=jd, interpret=True))
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    got = t_fsd.fused_density_raw_float64(ts, pt, xt, tt, td)
    assert got.shape == (300, 1) and got.dtype == torch.float64
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F32_TOL)
    else:
        _close_bf16(got.numpy(), ref)
        control = t_fsd.fused_density_raw_float64(ts, pt, xt, tt, torch.float32).numpy()
        assert (np.abs(control - ref) > BF16_TOL).mean() > 10 * BF16_FRAC



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_color_fwd_float64_matches_jax_kernel(dtype):
    """The float64 yardstick of the bf16 colour forward
    (dnerf_color_fwd_float64: the colour segment in float64 on the float32
    weights) against JAX's colour segment forced onto its Pallas kernel
    (_color_fwd_pl, interpreted) at the same dot precision, 300 points, the
    feature a normal draw: float32 within F32_TOL (float64 against float32
    sums), bf16 operand roundings on both sides within the bf16 limits
    (_close_bf16). The control: the float32 yardstick fails the bf16 limits
    against JAX's bf16 kernel, more than 10 BF16_FRAC of its points over
    BF16_TOL, so the rounding is on."""
    js, ts = _specs(**SMALL)
    pj, pt = _params(js, 11)
    _, d, _ = _points(300, seed=12)
    feat = np.random.default_rng(13).normal(size=(300, js.geo_feat_dim)).astype(np.float32)
    if dtype == "bfloat16":
        j_ft.set_compute_mode(jnp.bfloat16, None)
    seg_color = j_ftd._build_segments(js, True)[2]
    eff = j_ftd.prepare_effective_dnerf(js, pj)
    ref = np.asarray(seg_color(eff["color"], j_ft.pad_lanes(jnp.asarray(d)),
                               jnp.asarray(feat)))[:, :3]
    j_ft.set_compute_mode(jnp.float32, "highest")
    dt, ft_ = torch.from_numpy(d), torch.from_numpy(feat)
    got = t_ftd.dnerf_color_fwd_float64(ts, pt, dt, ft_,
                                        "highest" if dtype == "float32" else "default")
    assert got.shape == (300, 3) and got.dtype == torch.float64
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F32_TOL)
    else:
        _close_bf16(got.numpy(), ref)
        control = t_ftd.dnerf_color_fwd_float64(ts, pt, dt, ft_, "highest").numpy()
        over = (np.abs(control - ref).max(-1) > BF16_TOL).mean()
        print(f"control (float32 yardstick vs JAX bf16): {100 * over:.1f} % over {BF16_TOL}")
        assert over > 10 * BF16_FRAC


def test_color_fwd_refuses_cpu_tensors():
    """dnerf_color_fwd launches a kernel or raises: on CPU tensors it raises
    in both modes and with ``simt``, and nothing runs on the CPU."""
    js, ts = _specs(**SMALL)
    _, pt = _params(js, 11)
    _, d, _ = _points(8, seed=12)
    feat = torch.zeros(8, js.geo_feat_dim)
    before = dict(t_ftd.LAUNCHES)
    for dtype in (torch.float32, torch.bfloat16):
        packed = t_ftd.pack_dnerf(ts, pt, dtype)
        for simt in (False, True):
            with pytest.raises(ValueError, match="must be a CUDA tensor"):
                t_ftd.dnerf_color_fwd(packed, torch.from_numpy(d), feat, simt=simt)
    assert t_ftd.LAUNCHES == before


@pytest.mark.parametrize("scale", [0.06, 0.65], ids=["full", "narrow"])
def test_density_parity_bf16_max_is_a_share_of_the_raw_scale(scale):
    """fused_sdf.DENSITY_PARITY_TOL's bf16 max is a share (0.1) of the
    reference's largest |raw density|, at the seeded full and narrow nets'
    scales (about 0.06 and 0.65): one point of 65,537 moved by 0.09 of it
    passes, by 0.11 fails; the float32 max stays a fixed 5e-5."""
    ref = torch.linspace(-scale, scale, 65537).reshape(-1, 1)
    tol = t_fsd.DENSITY_PARITY_TOL
    for share, ok in ((0.09, True), (0.11, False)):
        got = ref.clone()
        got[-1] -= share * scale
        assert t_fsd.parity_errors(got, ref, torch.bfloat16, tol)[-1] is ok, share
    got = ref.clone()
    got[-1] -= 6e-5
    assert not t_fsd.parity_errors(got, ref, torch.float32, tol)[-1]

def _coarse(n, seed):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.normal(1.8, 0.3, (n, 64)), axis=-1).astype(np.float32)
    sigma = np.maximum(rng.normal(0.0, 3.0, (n, 64)), 0).astype(np.float32)
    sigma[: n // 4] = 0.0                     # rays of the weight floor alone
    dn = rng.uniform(0.9, 1.3, (n, 1)).astype(np.float32)
    return z, sigma, dn


def test_fine_resample_math_matches_jax_kernel():
    z, sigma, dn = _coarse(256, 11)
    ref = np.asarray(j_fs.fused_fine_resample(jnp.asarray(z), jnp.asarray(sigma),
                                              jnp.asarray(dn), interpret=True))
    got = t_fs.fine_resample_math(*map(torch.from_numpy, (z, sigma, dn))).numpy()
    assert got.shape == (256, 128)
    assert np.all(np.diff(got, axis=-1) >= 0)
    err = np.abs(got - ref).max(-1)
    assert (err > F32_TOL).mean() <= 1.0 / 16 and err.max() <= 5e-3, (err.max(),
                                                                         (err > F32_TOL).mean())
    # the coarse depths are kept
    for r in range(0, 256, 37):
        assert np.isin(z[r], got[r]).all()


def test_raw2outputs_matches_jax():
    rng = np.random.default_rng(12)
    z, sigma, _ = _coarse(16, 13)
    rgb = rng.uniform(0, 1, (16, 64, 3)).astype(np.float32)
    d = rng.normal(size=(16, 3)).astype(np.float32)
    ref = j_en.raw2outputs(*map(jnp.asarray, (rgb, sigma, z, d)))
    got = t_en.raw2outputs(*map(torch.from_numpy, (rgb, sigma, z, d)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


def test_bridge_round_trip_of_a_jax_dnerf_tree(tmp_path):
    """A JAX D-NeRF tree through the npz bridge: the flat keys carry
    {deform,density,color}/layers/i/{w,b} and the arrays come back equal."""
    js, ts = _specs(**SMALL)
    pj = j_en.init_dnerf_params(jax.random.PRNGKey(14), js)
    path = str(tmp_path / "dnerf.npz")
    save_params_npz(path, jax.device_get(pj), step=7)
    with np.load(path) as z:
        keys = set(z.files)
    assert "deform/layers/0/w" in keys and "density/layers/2/b" in keys
    assert "color/layers/1/w" in keys and "meta/step" in keys
    pt, step = load_params_npz(path)
    assert step == 7 and set(pt) == {"deform", "density", "color"}
    for name in pt:
        assert len(pt[name]["layers"]) == len(pj[name]["layers"])
        for a, b in zip(pt[name]["layers"], pj[name]["layers"]):
            assert set(a) == {"w", "b"}
            for k in a:
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    x, d, t = _points(16, seed=15)
    rgb_j, raw_j = j_en._field_raw(js, pj, jnp.asarray(x), jnp.asarray(d), jnp.asarray(t))
    rgb_t, raw_t = t_ftd.megakernel_field_raw(ts, pt, *map(torch.from_numpy, (x, d, t)))
    np.testing.assert_allclose(raw_t.numpy(), np.asarray(raw_j), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0, atol=F32_TOL)


def test_dnerf_spec_from_config_matches_jax():
    import yaml
    with open(osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "configs", "endonerf",
                       "base.yml")) as f:
        cfg = yaml.safe_load(f)
    j = j_en.DNeRFSpec.from_config(cfg["net"])
    t = t_en.DNeRFSpec.from_config(cfg["net"])
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (dataclasses.asdict(j_en.DNeRFRenderSpec.from_config(cfg["render"]))
            == dataclasses.asdict(t_en.DNeRFRenderSpec.from_config(cfg["render"])))
    assert t == t_en.DNeRFSpec() and t_ftd.cuda_dnerf_supported(t)
    assert not t_ftd.cuda_dnerf_supported(dataclasses.replace(t, color_layers=(2, 128, (1,))))
    assert not t_ftd.cuda_dnerf_supported(dataclasses.replace(t, geo_feat_dim=300))
