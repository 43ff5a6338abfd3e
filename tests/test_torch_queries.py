"""The port's surface queries held against the JAX package on the CPU:
EndoSurf ``render_on_depth`` at the sphere trace's depths; EndoNeRF
``density_grad_observed``, ``render_on_depth`` and ``render_rays(...,
want_normals=True)``; the gradient against a central difference; invalid
rays giving zeros; and the control for the dropped deform Jacobian.

Inputs come from numpy seeds; both sides at precision "highest" (the port's
float32 dots are float32: no TF32 on the CPU).

Tolerances, about ten times the readings on the CPU (in brackets; JAX
jitted):
- EndoSurf (9x64 nets, 24 rays, 10 on the surface): colour max abs
  ``ES_COLOR_TOL`` 1e-6 [6.0e-8], grad_o relative L2 ``ES_GRAD_TOL`` 5e-6
  [4.2e-7].
- EndoNeRF (3x64 nets, 6 octaves): the gradient relative L2 ``DN_GRAD_TOL``
  5e-6 [5.6e-7 with the deform net, 1.6e-7 without]; ``render_on_depth``'s
  colour max abs ``DN_COLOR_TOL`` 1e-6 [6.0e-8] and normals
  ``DN_NORMAL_TOL`` 5e-5 [5.0e-6]; ``render_rays``' maps ``DN_MAP_TOL`` 5e-5
  [normal_map 5.3e-6, the others 5.7e-7]. A normal divides by |grad|, so
  where the gradient is small a float32 difference in its sums grows; the
  normal map sums 16 weighted normals, and an importance draw can sit a
  float32 ulp of the cdf apart (JAX's scan against the port's running sum).
- The central difference (JAX's ``tests/test_endonerf.py`` check on its
  tiny net): rtol 1e-2, atol 1e-4.
- The control: the gradient through the segment Functions with respect to
  x_c (what autograd through ``megakernel_field_raw`` gives, the deform
  segment giving x no cotangent) reads relative L2 0.87 against JAX's with
  the deform net and must exceed ``DN_GRAD_TOL`` ``CONTROL_FACTOR`` times;
  without the deform net it is exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endosurf_tpu.kernels import fused_sampler as j_fs
from endosurf_tpu.kernels import fused_train as j_ft
from endosurf_tpu.models import endonerf as j_en
from endosurf_tpu.models import endosurf as j_es
from endosurf_tpu.models import fields as j_fields
from endosurf_tpu.ops import mlp as j_mlp
from endosurf_tpu_torch.bridge import params_from_jax
from endosurf_tpu_torch.kernels import fused_train_dnerf as t_ftd
from endosurf_tpu_torch.models import endonerf as t_en
from endosurf_tpu_torch.models import endosurf as t_es
from endosurf_tpu_torch.models import fields as t_fields

ES_COLOR_TOL, ES_GRAD_TOL = 1e-6, 5e-6
DN_GRAD_TOL, DN_NORMAL_TOL, DN_COLOR_TOL, DN_MAP_TOL = 5e-6, 5e-5, 1e-6, 5e-5
CONTROL_FACTOR = 100.0
DN_KW = dict(pos_density_freqs=6, dir_color_freqs=4, time_deform_freqs=6, pos_deform_freqs=6,
             deform_layers=(3, 64, (1,)), density_layers=(3, 64, (1,)),
             color_layers=(2, 64, ()), geo_feat_dim=32)


@pytest.fixture(autouse=True)
def _jax_plain_highest():
    j_fields.set_megakernel_mode("off")
    j_fs.set_sampler_kernel_mode("off")
    j_mlp.set_matmul_precision("highest")
    j_mlp.set_sampling_precision(None)
    j_ft.set_compute_mode(jnp.float32, "highest")
    yield
    j_fields.set_megakernel_mode("auto")
    j_fs.set_sampler_kernel_mode("auto")


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _rays(n, seed, slot6=1.0, slot7=3.0):
    """Rays from a camera at z = -2 toward the origin, slots 6/7 given."""
    rng = np.random.default_rng(seed)
    o = np.tile([0.0, 0.0, -2.0], (n, 1)) + rng.uniform(-0.05, 0.05, (n, 3))
    d = np.concatenate([rng.uniform(-0.25, 0.25, (n, 2)), np.ones((n, 1))], -1)
    t = rng.uniform(0, 1, (n, 1))
    return np.concatenate([o, d, np.full((n, 1), slot6), np.full((n, 1), slot7), t],
                          -1).astype(np.float32)


def _narrow(mod):
    return mod.EndoSurfSpec(deform=mod.MLPSpec(9, 64, (4,), 3), sdf=mod.MLPSpec(9, 64, (4,), 65),
                            color=mod.MLPSpec(9, 64, (4,), 3), color_feat_dim=64)


@pytest.fixture(scope="module")
def endosurf_case():
    spec_j, spec_t = _narrow(j_fields), _narrow(t_fields)
    pj = j_fields.init_endosurf_params(jax.random.PRNGKey(0), spec_j)
    j_fs.set_sampler_kernel_mode("off")
    j_mlp.set_matmul_precision("highest")
    rays = _rays(24, 0)
    depth, valid = jax.jit(lambda p, r: j_es.ray_march(spec_j, p, r))(pj, jnp.asarray(rays))
    return spec_j, spec_t, pj, params_from_jax(pj), rays, np.array(depth), np.array(valid)


def test_endosurf_render_on_depth_matches_jax(endosurf_case):
    spec_j, spec_t, pj, pt, rays, depth, valid = endosurf_case
    valid = valid.copy()
    assert valid.sum() >= 4, "the sphere trace should hit the init surface"
    valid[np.flatnonzero(valid[:, 0])[0]] = False
    cj, gj = jax.jit(lambda *a: j_es.render_on_depth(spec_j, *a))(
        pj, jnp.asarray(rays), jnp.asarray(depth), jnp.asarray(valid))
    ct, gt = t_es.render_on_depth(spec_t, pt, torch.from_numpy(rays), torch.from_numpy(depth),
                                  torch.from_numpy(valid))
    assert np.abs(ct.detach().numpy() - np.asarray(cj)).max() <= ES_COLOR_TOL
    assert _rel_l2(gt.detach().numpy(), gj) <= ES_GRAD_TOL
    off = ~valid[:, 0]
    assert (ct[off] == 0).all() and (gt[off] == 0).all()
    assert gt[valid[:, 0]].norm(dim=-1).min() > 0


def test_endosurf_render_on_depth_invalid_is_zero(endosurf_case):
    _, spec_t, _, pt, rays, depth, _ = endosurf_case
    ct, gt = t_es.render_on_depth(spec_t, pt, torch.from_numpy(rays), torch.from_numpy(depth),
                                  torch.zeros(len(rays), 1, dtype=torch.bool))
    assert (ct == 0).all() and (gt == 0).all()


@pytest.fixture(scope="module", params=[True, False], ids=["deform", "static"])
def dnerf_case(request):
    spec_j = j_en.DNeRFSpec(use_deform=request.param, **DN_KW)
    spec_t = t_en.DNeRFSpec(use_deform=request.param, **DN_KW)
    pj = j_en.init_dnerf_params(jax.random.PRNGKey(1), spec_j)
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.6, 0.6, (32, 3)).astype(np.float32)
    t = rng.uniform(0, 1, (32, 1)).astype(np.float32)
    return spec_j, spec_t, pj, params_from_jax(pj), x, t


def _jax_grad(spec_j, pj, x, t):
    return jax.jit(lambda *a: j_en.density_grad_observed(spec_j, *a))(
        pj, jnp.asarray(x), jnp.asarray(t))


def test_density_grad_observed_matches_jax(dnerf_case):
    spec_j, spec_t, pj, pt, x, t = dnerf_case
    j_mlp.set_matmul_precision("highest")
    gj = _jax_grad(spec_j, pj, x, t)
    gt = t_en.density_grad_observed(spec_t, pt, torch.from_numpy(x), torch.from_numpy(t))
    assert gt.shape == (32, 3)
    assert _rel_l2(gt.detach().numpy(), gj) <= DN_GRAD_TOL


@pytest.mark.parametrize("use_deform", [True, False], ids=["deform", "static"])
def test_density_grad_matches_central_difference(use_deform):
    """JAX's own check (``tests/test_endonerf.py``) on its tiny net (2
    octaves, 2x32 layers): d raw / d x against (raw(x + eps) - raw(x -
    eps)) / 2 eps of ``density_observed``, eps 1e-3."""
    spec = t_en.DNeRFSpec(use_deform=use_deform, pos_density_freqs=2, dir_color_freqs=2,
                          time_deform_freqs=2, pos_deform_freqs=2, deform_layers=(2, 32, ()),
                          density_layers=(2, 32, ()), color_layers=(2, 32, ()),
                          geo_feat_dim=16)
    pt = params_from_jax(j_en.init_dnerf_params(jax.random.PRNGKey(0),
                                                j_en.DNeRFSpec(**dataclasses.asdict(spec))))
    x = torch.tensor([[0.1, -0.2, 0.3]])
    t = torch.tensor([[0.4]])
    g = t_en.density_grad_observed(spec, pt, x, t)[0].detach().numpy()
    eps = 1e-3
    num = np.zeros(3)
    for i in range(3):
        dx = torch.zeros(1, 3)
        dx[0, i] = eps
        diff = (t_en.density_observed(spec, pt, x + dx, t)
                - t_en.density_observed(spec, pt, x - dx, t))
        num[i] = float(diff[0, 0]) / (2 * eps)
    np.testing.assert_allclose(g, num, rtol=1e-2, atol=1e-4)


def _segment_route_grad(spec, params, x, t):
    """The planted fault: d raw / d x_c through the segment Functions (the
    deform segment gives x no cotangent), taken as d raw / d x."""
    eff = t_ftd.prepare_effective_dnerf(spec, params)
    with torch.enable_grad():
        x_c = x
        if spec.use_deform:
            like, flat = t_ftd.segment_weights(eff, "deform")
            with torch.no_grad():
                x_c = t_ftd.SegDeform.apply(spec, like, "highest", None,
                                            torch.cat([x, t], dim=-1), *flat)
        x_c = x_c.detach().requires_grad_(True)
        like, flat = t_ftd.segment_weights(eff, "density")
        raw, _ = t_ftd.SegDensity.apply(spec, like, "highest", None, x_c, *flat)
        (grad,) = torch.autograd.grad(raw.sum(), x_c)
    return grad


def test_segment_route_drops_the_jacobian(dnerf_case):
    """The control: without the deform net the segment route is exact; with
    it, it misses (I + d deform / d x)^T and fails the gradient limit."""
    spec_j, spec_t, pj, pt, x, t = dnerf_case
    j_mlp.set_matmul_precision("highest")
    gj = _jax_grad(spec_j, pj, x, t)
    err = _rel_l2(_segment_route_grad(spec_t, pt, torch.from_numpy(x),
                                      torch.from_numpy(t)).numpy(), gj)
    if spec_t.use_deform:
        assert err > CONTROL_FACTOR * DN_GRAD_TOL, err
    else:
        assert err <= DN_GRAD_TOL, err


def test_dnerf_render_on_depth_matches_jax(dnerf_case):
    spec_j, spec_t, pj, pt, _, _ = dnerf_case
    j_mlp.set_matmul_precision("highest")
    rays = _rays(12, 2)
    rng = np.random.default_rng(3)
    depth = rng.uniform(1.6, 2.2, (12, 1)).astype(np.float32)
    valid = rng.uniform(size=(12, 1)) < 0.75
    cj, nj = jax.jit(lambda *a: j_en.render_on_depth(spec_j, *a))(
        pj, jnp.asarray(rays), jnp.asarray(depth), jnp.asarray(valid))
    ct, nt = t_en.render_on_depth(spec_t, pt, torch.from_numpy(rays), torch.from_numpy(depth),
                                  torch.from_numpy(valid))
    assert np.abs(ct.detach().numpy() - np.asarray(cj)).max() <= DN_COLOR_TOL
    assert np.abs(nt.detach().numpy() - np.asarray(nj)).max() <= DN_NORMAL_TOL
    on = valid[:, 0]
    assert (ct[~on] == 0).all() and (nt[~on] == 0).all()
    np.testing.assert_allclose(nt[on].norm(dim=-1).detach().numpy(), 1.0, atol=1e-5)
    c0, n0 = t_en.render_on_depth(spec_t, pt, torch.from_numpy(rays), torch.from_numpy(depth),
                                  torch.zeros(12, 1, dtype=torch.bool))
    assert (c0 == 0).all() and (n0 == 0).all()


@pytest.mark.parametrize("depth_sampling", [True, False], ids=["guided", "uniform"])
def test_render_rays_normal_map_matches_jax(dnerf_case, depth_sampling):
    """``render_rays(..., want_normals=True)`` against JAX's eval render
    (key=None): 8 + 8 samples, the depth-guided draws from JAX's
    PRNGKey(0); the maps without normals are unchanged by the flag."""
    spec_j, spec_t, pj, pt, _, _ = dnerf_case
    j_mlp.set_matmul_precision("highest")
    kw = dict(n_samples=8, n_importance=8, use_depth_sampling=depth_sampling,
              depth_sampling_sigma=0.3)
    rspec_j, rspec_t = j_en.DNeRFRenderSpec(**kw), t_en.DNeRFRenderSpec(**kw)
    rays = _rays(10, 4, *((1.9, 0.3) if depth_sampling else (1.2, 2.8)))
    oj = jax.jit(lambda p, r: j_en.render_rays(spec_j, rspec_j, p, r, key=None,
                                               want_normals=True))(pj, jnp.asarray(rays))
    eps = torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(0), (10, 8))))
    ot = t_en.render_rays(spec_t, rspec_t, pt, torch.from_numpy(rays), eps=eps,
                          want_normals=True)
    assert ot["normal_map"].shape == (10, 3)
    assert np.abs(ot["normal_map"].detach().numpy() - np.asarray(oj["normal_map"])).max() \
        <= DN_MAP_TOL
    plain = t_en.render_rays(spec_t, rspec_t, pt, torch.from_numpy(rays), eps=eps)
    assert "normal_map" not in plain
    for k in ("color_map", "depth_map", "weights", "z_vals"):
        assert torch.equal(plain[k], ot[k]), k
        if k != "z_vals":
            np.testing.assert_allclose(ot[k].detach().numpy(), np.asarray(oj[k]), atol=DN_MAP_TOL)
