"""EndoSurf nets of other depths, widths and skips, held against the JAX
package on the CPU, where the port runs its plain versions.

JAX's Pallas kernels take nets of any depth, any hidden width and any skip
list but one at the output layer; so do the port's kernels (2 to 9 layers a
net, widths up to 256). Three shapes, (deform, SDF, colour), at narrow
widths:

* ``neus``: (9, 9, 5 with no skip), the colour net of NeuS's
  rendering network (5 linear layers, no skip);
* ``short``: (4, 5, 3), each net its own depth, with skips inside;
* ``wide``: 9-layer nets with an SDF 40 wide (not a multiple of 16) and a
  colour net with two skip layers, (2, 5).

For each: the render's plain twin against JAX's interpreted
``fused_render_rays`` (float32 and bf16, the float64 yardstick too); for
short and wide (``SAMPLING_SHAPES``: neus's sampling nets are base.yml's),
the upsampling's twin against the interpreted ``fused_upsample_z`` and the
grid query's plain version and float64 yardstick against the interpreted
``fused_sdf_observed``; tests/test_torch_nets_train.py holds the train
step's paths on the same shapes (the march, the segments, one step). The
tolerances are those of the 9-layer files (tests/test_torch_render.py,
test_torch_sampler.py, test_torch_sdf_query.py), restated per test. Params
are bridged from a JAX init; inputs come from numpy seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from endosurf_tpu.kernels import fused_render as j_fr
from endosurf_tpu.kernels import fused_sampler as j_fs
from endosurf_tpu.kernels import fused_sdf as j_fsd
from endosurf_tpu.kernels import fused_train as j_ft
from endosurf_tpu.models import fields as j_fields
from endosurf_tpu.ops import mlp as j_mlp
from endosurf_tpu_torch.bridge import params_from_jax
from endosurf_tpu_torch.kernels import fused_render as t_fr
from endosurf_tpu_torch.kernels import fused_sampler as t_fs
from endosurf_tpu_torch.kernels import fused_sdf as t_fsd
from endosurf_tpu_torch.kernels import fused_train as t_ft
from endosurf_tpu_torch.kernels import fused_train_cuda as t_ftc
from endosurf_tpu_torch.models import fields as t_fields

# (deform, SDF, colour) as (n_layers, hidden_dim, skips); the SDF's output is
# 1 + the feature width, 64
SHAPES = {
    "neus": ((9, 64, (4,)), (9, 64, (4,)), (5, 64, ())),
    "short": ((4, 64, (2,)), (5, 64, (2,)), (3, 64, (1,))),
    "wide": ((9, 64, (4,)), (9, 40, (4,)), (9, 64, (2, 5))),
}
# The sampling kernels (upsampling, march, grid query) run only the deform
# and SDF nets: neus's are base.yml's narrow 9-layer ones with the same
# weights as test_torch_sampler.py's and test_torch_sdf_query.py's
# (PRNGKey(0)), so those tests take the two other shapes.
SAMPLING_SHAPES = ("short", "wide")
FEAT = 64
FRAC = 1.0 / 32


def spec_of(mod, shape, use_deform=True):
    (dn, dw, ds), (sn, sw, ss), (cn, cw, cs) = SHAPES[shape]
    return mod.EndoSurfSpec(use_deform=use_deform, deform=mod.MLPSpec(dn, dw, ds, 3),
                            sdf=mod.MLPSpec(sn, sw, ss, 1 + FEAT),
                            color=mod.MLPSpec(cn, cw, cs, 3), color_feat_dim=FEAT)


@pytest.fixture(autouse=True)
def _jax_plain_path():
    """JAX at full precision on its plain path unless a test forces a
    kernel, restored after."""
    j_fields.set_megakernel_mode("off")
    j_fs.set_sampler_kernel_mode("off")
    j_mlp.set_matmul_precision("highest")
    j_mlp.set_sampling_precision(None)
    j_ft.set_compute_mode(jnp.float32, "highest")
    yield
    j_ft.set_force_kernel(False)
    j_fields.set_megakernel_mode("auto")
    j_fs.set_sampler_kernel_mode("auto")


_PARAMS = {}


def params(shape):
    """(JAX params, torch params) of a shape, from PRNGKey(0)."""
    if shape not in _PARAMS:
        pj = j_fields.init_endosurf_params(jax.random.PRNGKey(0), spec_of(j_fields, shape))
        _PARAMS[shape] = pj
    pj = _PARAMS[shape]
    return pj, params_from_jax(pj)


def _rays(n, seed):
    """[n, 9] rays from z = -1.5 towards the middle of the unit sphere."""
    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(-0.3, 0.3, (n, 2)), np.full((n, 1), -1.5)], -1)
    target = rng.uniform(-0.3, 0.3, (n, 3))
    target[::4, 0] = rng.choice([-1.05, 1.05], n)[::4]     # one in four past the rim
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, np.zeros((n, 2)), rng.uniform(0, 1, (n, 1))],
                          -1).astype(np.float32)


def _per_ray(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).reshape(a.shape[0], -1).max(-1)


def test_the_kernels_take_these_nets():
    """The CUDA gate takes every shape, and the segment packs of both
    precisions pack each net at its own depth (the meta's layer count and
    out widths); a net past the box (10 layers, 320 wide) or with a skip at
    its output layer is refused, naming the limit."""
    for shape in SHAPES:
        spec = spec_of(t_fields, shape)
        assert t_fr.cuda_spec_supported(spec), shape
        _, pt = params(shape)
        eff = t_ft.prepare_effective(spec, pt)
        for seg, net in (("deform", spec.deform), ("sdf", spec.sdf), ("color", spec.color)):
            like, flat = t_ft.segment_weights(eff, seg)
            for precision in ("highest", "default"):
                packed = t_ftc.pack_segment(spec, seg, flat, like, precision)
                q = t_ftc.SEGMENTS.index(seg)
                meta = list(packed.meta)[8 + q * t_fr.META_NET:8 + (q + 1) * t_fr.META_NET]
                assert meta[0] == net.n_layers == len(packed.layers), (shape, seg)
                assert meta[1] == sum(1 << s for s in net.skips)
                outs = meta[2 + t_fr.NL:2 + 2 * t_fr.NL]
                assert outs[:net.n_layers] == [lay[3] for lay in packed.layers]
                assert not any(outs[net.n_layers:])
    base = spec_of(t_fields, "neus")
    for bad, why in ((t_fields.MLPSpec(10, 64, (4,), 3), "2 to 9 layers"),
                     (t_fields.MLPSpec(9, 320, (4,), 3), "no wider than 256"),
                     (t_fields.MLPSpec(5, 64, (4,), 3), "output layer")):
        spec = dataclasses.replace(base, color=bad)
        assert not t_fr.cuda_spec_supported(spec)
        with pytest.raises(ValueError, match=why):
            t_ftc._check_spec(spec, "color")


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_render_twin_matches_jax_kernel(shape):
    """The render's plain twin against JAX's interpreted fused_render_rays
    (32 + 32 samples, 4 rounds, 16 rays): float32 within 1e-4 on every map
    (JAX at "highest"), both passes bf16 within 1e-3, and the float64
    yardstick within 1e-3 of the bf16 kernel (test_torch_render.py's
    limits)."""
    pj, pt = params(shape)
    spec_j, spec_t = spec_of(j_fields, shape), spec_of(t_fields, shape)
    rays = _rays(16, seed=1)
    maps = ("color_map", "depth_map", "normal_map", "acc_map", "weight_max")

    def check(got, ref, tol):
        for k in maps:
            np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(ref[k]),
                                       atol=tol, err_msg=f"{shape} {k}")
    got = t_fr.fused_render_rays_reference(spec_t, pt, torch.from_numpy(rays), 30000.0, 32, 32,
                                           4, 50000.0)
    kern = j_fr.fused_render_rays(spec_j, pj, jnp.asarray(rays), jnp.asarray(30000.0), 32, 32, 4,
                                  50000.0, interpret=True)
    check(got, kern, 1e-4)
    kern = j_fr.fused_render_rays(spec_j, pj, jnp.asarray(rays), jnp.asarray(30000.0), 32, 32, 4,
                                  50000.0, sampling_dtype=jnp.bfloat16, main_dtype=jnp.bfloat16,
                                  main_precision=None, interpret=True)
    got = t_fr.fused_render_rays_reference(spec_t, pt, torch.from_numpy(rays), 30000.0, 32, 32,
                                           4, 50000.0, torch.bfloat16, torch.bfloat16)
    check(got, kern, 1e-3)
    got = t_fr.fused_render_rays_float64(spec_t, pt, torch.from_numpy(rays), 30000.0, 32, 32, 4,
                                         50000.0)
    assert all(got[k].dtype == torch.float64 for k in maps)
    check(got, kern, 1e-3)


@pytest.mark.parametrize("shape", SAMPLING_SHAPES)
def test_upsample_twin_matches_jax_kernel(shape):
    """The upsampling's twin (z and sdf) against JAX's interpreted
    fused_upsample_z on 32 perturbed rays: float32 within 1e-4 on all rays
    but 1 in 32 and 5e-3 on every ray; bf16 (and its float64 yardstick)
    within 2e-3 on the same terms (test_torch_sampler.py's limits)."""
    pj, pt = params(shape)
    spec_j, spec_t = spec_of(j_fields, shape), spec_of(t_fields, shape)
    rng = np.random.default_rng(1)
    n = 32
    o = np.concatenate([rng.uniform(-0.3, 0.3, (n, 2)), np.full((n, 1), -1.5)], -1)
    d = rng.uniform(-0.2, 0.2, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z0 = 0.6 + 1.8 * np.linspace(0, 1, 32)[None, :] + (rng.uniform(0, 1, (n, 1)) - 0.5) / 16
    ins = [a.astype(np.float32) for a in (o, d / (d[:, 2:3] + 1e-6), rng.uniform(0, 1, (n, 1)),
                                          z0)]
    ins_t = [torch.from_numpy(a) for a in ins]
    for tdt, jdt, tight in ((torch.float32, jnp.float32, 1e-4), (torch.bfloat16, jnp.bfloat16,
                                                                 2e-3)):
        kern = j_fs.fused_upsample_z(spec_j, pj, *(jnp.asarray(a) for a in ins), 32, 4,
                                     compute_dtype=jdt, interpret=True, return_sdf=True)
        outs = [t_fs.fused_upsample_z_reference(spec_t, pt, *ins_t, 32, 4, tdt, True)]
        if tdt == torch.bfloat16:
            outs.append(t_fs.fused_upsample_z_float64(spec_t, pt, *ins_t, 32, 4))
        for got in outs:
            for g, k, name in zip(got, kern, ("z", "sdf")):
                err = _per_ray(g.numpy(), k)
                assert err.max() <= 5e-3, (shape, tdt, name, err.max())
                assert (err > tight).mean() <= FRAC, (shape, tdt, name, np.sort(err)[-4:])


@pytest.mark.parametrize("shape", SAMPLING_SHAPES)
def test_grid_query_matches_jax_kernel(shape):
    """The grid query's plain version and float64 yardstick against JAX's
    interpreted fused_sdf_observed on 1024 points (test_torch_sdf_query.py's
    points and limits): float32 within 1e-5; bf16 within 1e-4 on all but 1
    point in 64 and within 3e-3 on every point but at most one, where JAX's
    own float32 query sides with the port (it lies nearer the port's bf16
    value than JAX's bf16 kernel does: JAX's kernel rounded an operand on a
    bf16 edge the other way). Read on the 40-wide SDF: one point at 5.2e-3,
    the port 2.0e-3 and JAX's bf16 kernel 3.2e-3 from JAX's float32 value.
    That point counts in the 1-in-64 share too."""
    pj, pt = params(shape)
    spec_j, spec_t = spec_of(j_fields, shape), spec_of(t_fields, shape)
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.9, 0.9, (1024, 3)).astype(np.float32)
    t = rng.uniform(0, 1, (1024, 1)).astype(np.float32)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    jax_f32 = None
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(j_fsd.fused_sdf_observed(spec_j, pj, jnp.asarray(x), jnp.asarray(t),
                                                      compute_dtype=jdt))[:, 0]
        plain = t_fsd.fused_sdf_observed(spec_t, pt, xt, tt, tdt).double().numpy()[:, 0]
        f64 = t_fsd.fused_sdf_observed_float64(spec_t, pt, xt, tt, tdt).numpy()[:, 0]
        for got in (plain, f64):
            err = np.abs(got - ref)
            if tdt == torch.float32:
                assert err.max() <= 1e-5, (shape, err.max())
                continue
            over = err > 3e-3
            sides = np.abs(got - jax_f32) < np.abs(ref - jax_f32)
            print(f"{shape} bf16: max {err.max():.3e}, over 1e-4 on {(err > 1e-4).mean():.4f}, "
                  f"over 3e-3 on {int(over.sum())} (JAX's float32 sides with the port on "
                  f"{int((over & sides).sum())})")
            assert (err > 1e-4).mean() <= 1.0 / 64, (shape, (err > 1e-4).mean())
            assert not (over & ~sides).any() and over.sum() <= 1, (shape, err.max())
        if tdt == torch.float32:
            jax_f32 = ref.astype(np.float64)
