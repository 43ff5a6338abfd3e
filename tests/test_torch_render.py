"""The render kernel's module (kernels/fused_render.py) and the serving slice
as a whole, held against the JAX package on the CPU.

The port's plain twin ``fused_render_rays_reference`` is compared with the
JAX Pallas kernel run in interpret mode and with JAX ``render_rays(key=None)``.
A narrow spec (9 layers of width 64; the JAX kernel takes it in interpret
mode) keeps the interpreted kernel to seconds.

Tolerances: float32 1e-4 (JAX at precision="highest"). bf16 ("default"
dots on both sides): 1e-3. On the bf16 case below the twin reaches 2.1e-4
(normal_map; 1.5e-5 or less on the other maps), while the twin with float32
dots in either pass or both misses the bf16 kernel by 1.5e-3 or more on
depth_map and 7.8e-3 or more on normal_map; test_bf16_tolerance_rejects_f32_dots
keeps that control.

The CUDA kernel itself is held against the plain twin in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endosurf_tpu.data import scene_data as j_scene
from endosurf_tpu.evaluation import metrics as j_metrics
from endosurf_tpu.evaluation import render_eval as j_eval
from endosurf_tpu.kernels import fused_render as j_fr
from endosurf_tpu.models import endosurf as j_es
from endosurf_tpu.models import fields as j_fields
from endosurf_tpu.ops.mlp import set_matmul_precision
from endosurf_tpu_torch.bridge import params_from_jax
from endosurf_tpu_torch.data import scene_data as t_scene
from endosurf_tpu_torch.evaluation import metrics as t_metrics
from endosurf_tpu_torch.evaluation import render_eval as t_eval
from endosurf_tpu_torch.kernels import fused_render as t_fr
from endosurf_tpu_torch.models import endosurf as t_es
from endosurf_tpu_torch.models import fields as t_fields
from endosurf_tpu_torch.ops.mlp import effective_weight

MAPS = ("color_map", "depth_map", "normal_map", "acc_map", "weight_max")
F32_TOL = 1e-4
BF16_TOL = 1e-3


def _narrow(mod, use_deform=True):
    return mod.EndoSurfSpec(use_deform=use_deform,
                            deform=mod.MLPSpec(9, 64, (4,), 3),
                            sdf=mod.MLPSpec(9, 64, (4,), 65),
                            color=mod.MLPSpec(9, 64, (4,), 3), color_feat_dim=64)


def _rays(n: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(-0.3, 0.3, (n, 2)), np.full((n, 1), -1.5)], -1)
    d = rng.uniform(-0.2, 0.2, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, np.zeros((n, 2)), rng.uniform(0, 1, (n, 1))],
                          -1).astype(np.float32)


def _jax_ref_maps(out, n):
    w = np.asarray(out["weights"])
    return {"color_map": np.asarray(out["color_map"]), "depth_map": np.asarray(out["depth_map"]),
            "normal_map": (np.asarray(out["gradients_o"]).reshape(n, -1, 3) * w[..., None]).sum(1),
            "acc_map": w.sum(-1, keepdims=True), "weight_max": w.max(-1, keepdims=True)}


def _check(got, ref, tol):
    for k in MAPS:
        t = tol[k] if isinstance(tol, dict) else tol
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=t, err_msg=k)


def _assert_mostly_close(got, ref, name, tight=F32_TOL, loose=5e-3, frac=0.02):
    """Per pixel: all within ``loose`` and all but ``frac`` within ``tight``.
    Over a whole frame a few rays put a deterministic inverse-CDF draw on a
    bin edge (cdf ~ u), where float32 summation order picks the bin."""
    err = np.abs(got - ref).reshape(-1, got.shape[-1]).max(-1)
    assert err.max() <= loose, (name, err.max())
    assert (err > tight).mean() <= frac, (name, (err > tight).mean())


CASES = {
    # name: (use_deform, anneal_end, step)
    "deform-anneal-mid": (True, 50000.0, 30000.0),
    "static-anneal-zero": (False, 50000.0, 0.0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_reference_matches_jax_f32(name):
    """Plain twin == interpreted JAX kernel == JAX render_rays, float32."""
    use_deform, anneal_end, step = CASES[name]
    set_matmul_precision("highest")
    spec_j, spec_t = _narrow(j_fields, use_deform), _narrow(t_fields, use_deform)
    pj = j_fields.init_endosurf_params(jax.random.PRNGKey(0), spec_j)
    rays = _rays(32)
    got = t_fr.fused_render_rays_reference(spec_t, params_from_jax(pj), torch.from_numpy(rays),
                                           step, 32, 32, 4, anneal_end)
    kern = j_fr.fused_render_rays(spec_j, pj, jnp.asarray(rays), jnp.asarray(step), 32, 32, 4,
                                  anneal_end, interpret=True)
    _check(got, kern, F32_TOL)
    rspec = j_es.RenderSpec(anneal_end=anneal_end)
    ref = jax.jit(lambda p, r, s: j_es.render_rays(spec_j, rspec, p, r, s, key=None))(
        pj, jnp.asarray(rays), jnp.asarray(step))
    _check(got, _jax_ref_maps(ref, rays.shape[0]), F32_TOL)


@pytest.fixture(scope="module")
def bf16_case():
    """The interpreted JAX kernel with both dot modes bf16 ("default"), and a
    twin runner ``(sampling_dtype, main_dtype) -> maps`` on the same inputs."""
    spec_j, spec_t = _narrow(j_fields), _narrow(t_fields)
    pj = j_fields.init_endosurf_params(jax.random.PRNGKey(0), spec_j)
    rays = _rays(32, seed=2)
    kern = j_fr.fused_render_rays(spec_j, pj, jnp.asarray(rays), jnp.asarray(30000.0), 32, 32,
                                  4, 50000.0, sampling_dtype=jnp.bfloat16,
                                  main_dtype=jnp.bfloat16, main_precision=None,
                                  interpret=True)

    def twin(sampling_dtype, main_dtype):
        return t_fr.fused_render_rays_reference(spec_t, params_from_jax(pj),
                                                torch.from_numpy(rays), 30000.0, 32, 32, 4,
                                                50000.0, sampling_dtype, main_dtype)
    return kern, twin


def test_reference_matches_jax_kernel_bf16(bf16_case):
    """Both dot modes bf16 ("default"), against the interpreted JAX kernel."""
    kern, twin = bf16_case
    _check(twin(torch.bfloat16, torch.bfloat16), kern, BF16_TOL)


def test_float64_yardstick_matches_jax_kernel_bf16(bf16_case):
    """``fused_render_rays_float64`` (the bf16 render's float64 yardstick:
    the kernels' bf16 operand roundings, float64 arithmetic) returns float64
    maps within BF16_TOL of the interpreted bf16 JAX kernel, as the float32
    twin does (the yardstick reads 2.7e-4 on normal_map, 1e-5 or less on the
    other maps)."""
    kern, _ = bf16_case
    spec_j, spec_t = _narrow(j_fields), _narrow(t_fields)
    pj = j_fields.init_endosurf_params(jax.random.PRNGKey(0), spec_j)
    got = t_fr.fused_render_rays_float64(spec_t, params_from_jax(pj),
                                         torch.from_numpy(_rays(32, seed=2)), 30000.0, 32, 32,
                                         4, 50000.0)
    assert all(got[k].dtype == torch.float64 and got[k].shape == np.asarray(kern[k]).shape
               for k in MAPS)
    _check(got, kern, BF16_TOL)


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.float32),
                                    (torch.float32, torch.bfloat16)],
                         ids=["f32-both", "f32-main", "f32-sampling"])
def test_bf16_tolerance_rejects_f32_dots(bf16_case, dtypes):
    """BF16_TOL tells the precisions apart: the twin with float32 dots in
    either pass misses the bf16 JAX kernel on some map."""
    kern, twin = bf16_case
    got = twin(*dtypes)
    worst = max(np.abs(got[k].numpy() - np.asarray(kern[k])).max() for k in MAPS)
    assert worst > BF16_TOL, worst


def test_shape_gate_matches_jax():
    for n0 in (8, 16, 24, 32, 48, 64):
        for n_imp in (0, 8, 16, 30, 32, 48):
            for rounds in (1, 2, 4):
                assert (t_fr.render_shape_supported(n0, n_imp, rounds)
                        == j_fr.render_shape_supported(n0, n_imp, rounds)), (n0, n_imp, rounds)


@pytest.mark.parametrize("use_deform", [True, False])
def test_pack_operands_layout(use_deform):
    """The packed buffer and meta the CUDA kernel decodes: every layer's W,
    b and (SDF hidden) W^T sit at their offsets, bf16 rounds only weights."""
    spec = t_fields.EndoSurfSpec(use_deform=use_deform)
    params = t_fields.init_endosurf_params(spec, torch.Generator().manual_seed(4))
    buf, meta = t_fr.pack_operands(spec, params, torch.bfloat16)
    assert len(meta) == 8 + 3 * t_fr.META_NET
    assert meta[:7] == [int(use_deform), 6, 6, 6, 10, 4, 256]
    names = ["deform_network", "sdf_network", "color_network"]
    for i, name in enumerate(names):
        q = meta[8 + i * t_fr.META_NET: 8 + (i + 1) * t_fr.META_NET]
        if name not in params:
            assert q[0] == 0
            continue
        n = q[0]
        assert n == 9 and q[1] == 1 << 4
        for l, layer in enumerate(params[name]["layers"]):
            d_in, d_out = q[2 + l], q[11 + l]
            w = buf[q[20 + l]: q[20 + l] + d_in * d_out].reshape(d_in, d_out)
            torch.testing.assert_close(
                w, effective_weight(layer).to(torch.bfloat16).float(), rtol=0, atol=0)
            torch.testing.assert_close(buf[q[29 + l]: q[29 + l] + d_out], layer["b"])
            if name == "sdf_network" and l < n - 1:
                wt = buf[q[38 + l]: q[38 + l] + d_in * d_out].reshape(d_out, d_in)
                torch.testing.assert_close(wt, w.T, rtol=0, atol=0)
            else:
                assert q[38 + l] == -1
    head = params["sdf_network"]["layers"][-1]
    torch.testing.assert_close(buf[meta[7]: meta[7] + 256], effective_weight(head)[:, 0])


def test_inference_dispatch_on_cpu():
    """On CPU tensors render_rays_inference runs the plain twin (no kernel
    launch); shapes outside the gate fall back to render_rays."""
    spec = _narrow(t_fields)
    params = t_fields.init_endosurf_params(spec, torch.Generator().manual_seed(0))
    rays = torch.from_numpy(_rays(16))
    before = dict(t_fr.LAUNCHES)
    out = t_es.render_rays_inference(spec, t_es.RenderSpec(anneal_end=0.0), params, rays, 10.0)
    assert set(out) == set(MAPS)
    assert t_fr.LAUNCHES == before
    fallback = t_es.render_rays_inference(spec, t_es.RenderSpec(n_importance=30), params,
                                          rays, 10.0)
    assert "weights" in fallback and "normal_map" not in fallback


def test_whole_slice_on_cpu():
    """Synthetic scene -> frame rays -> chunked render -> metrics, in both
    packages, float32."""
    set_matmul_precision("highest")
    h, w = 12, 16               # the SSIM window is 11x11
    sj = j_scene.make_synthetic_arrays(n_frames=4, h=h, w=w, seed=3)
    st = t_scene.make_synthetic_arrays(n_frames=4, h=h, w=w, seed=3)
    for k, v in st.device_arrays.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(sj.device_arrays[k]), err_msg=k)
    assert (st.near, st.far, st.h, st.w) == (sj.near, sj.far, sj.h, sj.w)
    np.testing.assert_array_equal(st.list_test, sj.list_test)

    fid = int(st.list_test[0])
    np.testing.assert_allclose(t_scene.frame_rays(st.device_arrays, h, w, fid).numpy(),
                               np.asarray(j_scene.frame_rays(sj.device_arrays, h, w, fid)),
                               atol=1e-6)

    spec_j, spec_t = _narrow(j_fields), _narrow(t_fields)
    pj = j_fields.init_endosurf_params(jax.random.PRNGKey(1), spec_j)
    rspec_j, rspec_t = j_es.RenderSpec(), t_es.RenderSpec()
    step = 20000

    @jax.jit
    def j_render(p, r, s):
        return j_es.render_rays_inference(spec_j, rspec_j, p, r, s)

    def t_render(p, r, s):
        return t_es.render_rays_inference(spec_t, rspec_t, p, r, s, precision="highest")

    pred_j = j_eval.render_full_frames(j_render, pj, sj.device_arrays, h, w, [fid], step,
                                       ray_chunk=64, chunks_per_call=1)
    pred_t = t_eval.render_full_frames(t_render, params_from_jax(pj), st.device_arrays, h, w,
                                       [fid], step, ray_chunk=64)
    for k in ("rgb", "depth", "normal"):
        _assert_mostly_close(pred_t[k], pred_j[k], k)

    stats_t = t_eval.frame_stats(st, [fid], pred_t)
    rgb_gt = np.asarray(sj.device_arrays["colors"])[[fid]]
    depth_gt = np.asarray(sj.device_arrays["depths"])[[fid]]
    cmask = np.asarray(sj.device_arrays["color_masks"])[[fid]]
    mask = np.asarray(sj.device_arrays["masks"])[[fid]]
    ds = sj.depth_scale
    stats_j = {"psnr_rgb_vr": j_metrics.cal_psnr(rgb_gt, pred_j["rgb"], cmask),
               "ssim_rgb_vr": j_metrics.cal_ssim(rgb_gt, pred_j["rgb"], cmask),
               "rmse_d_vr": j_metrics.cal_rmse(depth_gt * ds, pred_j["depth"] * ds, mask)}
    np.testing.assert_allclose(stats_t["psnr_rgb_vr"], stats_j["psnr_rgb_vr"], atol=1e-3)
    np.testing.assert_allclose(stats_t["ssim_rgb_vr"], stats_j["ssim_rgb_vr"], atol=1e-4)
    np.testing.assert_allclose(stats_t["rmse_d_vr"], stats_j["rmse_d_vr"], atol=1e-2)


@pytest.mark.parametrize("fn", ["cal_psnr", "cal_rmse", "cal_ssim"])
def test_metrics_match_jax(rng, fn):
    a = rng.uniform(0, 1, (2, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    m = (rng.uniform(size=(2, 24, 20, 1)) > 0.2).astype(np.float32)
    np.testing.assert_allclose(getattr(t_metrics, fn)(a, b, m), getattr(j_metrics, fn)(a, b, m),
                               rtol=1e-5)
    assert t_metrics.cal_lpips(a, b, m) is None
