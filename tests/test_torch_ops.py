"""Parity of the PyTorch port's ops (endosurf_tpu_torch.ops) with the JAX
package's: the same numpy inputs through both, float32 on the CPU.

Tolerances: elementwise ops 1e-6 (float32 rounding of the same formulas);
skip MLPs 1e-5 (JAX at precision="highest", torch with TF32 off; 9 layers of
256-wide float32 sums in different orders).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endosurf_tpu.ops import encoding as j_enc
from endosurf_tpu.ops import geometry as j_geo
from endosurf_tpu.ops import mlp as j_mlp
from endosurf_tpu.ops import neus as j_neus
from endosurf_tpu.ops import pdf as j_pdf
from endosurf_tpu_torch.bridge import params_from_jax
from endosurf_tpu_torch.ops import encoding as t_enc
from endosurf_tpu_torch.ops import geometry as t_geo
from endosurf_tpu_torch.ops import mlp as t_mlp
from endosurf_tpu_torch.ops import neus as t_neus
from endosurf_tpu_torch.ops import pdf as t_pdf

ATOL = 1e-6


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t.detach().numpy() if torch.is_tensor(t) else t),
                               np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("n_freqs", [0, 4, 6, 10])
def test_freq_encode(rng, n_freqs):
    x = rng.uniform(-1, 1, (32, 3)).astype(np.float32)
    _close(j_enc.freq_encode(jnp.asarray(x), n_freqs),
           t_enc.freq_encode(torch.from_numpy(x), n_freqs))
    assert t_enc.freq_encode_dim(3, n_freqs) == j_enc.freq_encode_dim(3, n_freqs)


def test_encode_with_derivative(rng):
    """The column form (used by the field math) equals freq_encode, and its
    derivative equals autograd's."""
    x = torch.from_numpy(rng.uniform(-1, 1, (8, 4)).astype(np.float32))
    e, g1, coord, scale = t_enc.encode_with_derivative(x, (3, 1), (6, 6))
    ref = torch.cat([t_enc.freq_encode(x[:, :3], 6), t_enc.freq_encode(x[:, 3:], 6)], -1)
    _close(ref, e)
    xr = x.clone().requires_grad_(True)
    ref_r = torch.cat([t_enc.freq_encode(xr[:, :3], 6), t_enc.freq_encode(xr[:, 3:], 6)], -1)
    for c in (0, 5, 20, 40, 51):
        (grad,) = torch.autograd.grad(ref_r[:, c].sum(), xr, retain_graph=True)
        _close(grad[:, coord[c]], scale[c] * g1[:, c], atol=1e-5)


def test_rays_from_pixels_and_sphere(rng):
    px = rng.uniform(0, 64, (50,)).astype(np.float32)
    py = rng.uniform(0, 48, (50,)).astype(np.float32)
    K = np.array([[51.2, 0, 32], [0, 51.2, 24], [0, 0, 1]], np.float32)
    Kinv = np.linalg.inv(K).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    pose[:3, 3] = [0.1, -0.2, -2.0]
    jo, jd = j_geo.rays_from_pixels(jnp.asarray(px), jnp.asarray(py), jnp.asarray(Kinv),
                                    jnp.asarray(pose))
    to, td = t_geo.rays_from_pixels(torch.from_numpy(px), torch.from_numpy(py),
                                    torch.from_numpy(Kinv), torch.from_numpy(pose))
    _close(jo, to)
    _close(jd, td)
    jn, jf, jh = j_geo.ray_sphere_intersection(jo, jd)
    tn, tf, th = t_geo.ray_sphere_intersection(to, td)
    _close(jn, tn, 1e-5)
    _close(jf, tf, 1e-5)
    np.testing.assert_array_equal(np.asarray(jh), th.numpy())


def test_neus_ops(rng):
    sdf = rng.normal(0, 0.3, (16, 40)).astype(np.float32)
    cos = rng.uniform(-1, 1, (16, 40)).astype(np.float32)
    dists = rng.uniform(0.01, 0.1, (16, 40)).astype(np.float32)
    for anneal in (0.0, 0.6, 1.0):
        _close(j_neus.annealed_iter_cos(jnp.asarray(cos), anneal),
               t_neus.annealed_iter_cos(torch.from_numpy(cos), anneal))
    ja, jp = j_neus.neus_alpha(jnp.asarray(sdf), jnp.asarray(-np.abs(cos)),
                               jnp.asarray(dists), 20.0)
    ta, tp = t_neus.neus_alpha(torch.from_numpy(sdf), torch.from_numpy(-np.abs(cos)),
                               torch.from_numpy(dists), 20.0)
    _close(ja, ta)
    _close(jp, tp)
    _close(j_neus.exclusive_cumprod_weights(ja), t_neus.exclusive_cumprod_weights(ta))

    z = np.sort(rng.uniform(0.5, 2.5, (16, 40)), -1).astype(np.float32)
    radius = rng.uniform(0.5, 1.5, (16, 40)).astype(np.float32)
    for inv_s in (64.0, 512.0):
        _close(j_neus.upsample_weights_from_sdf(jnp.asarray(z), jnp.asarray(sdf),
                                                jnp.asarray(radius), inv_s),
               t_neus.upsample_weights_from_sdf(torch.from_numpy(z), torch.from_numpy(sdf),
                                                torch.from_numpy(radius), inv_s))


def test_merge_sorted_z(rng):
    z = np.sort(rng.uniform(0, 1, (8, 32)), -1).astype(np.float32)
    new = rng.uniform(0, 1, (8, 8)).astype(np.float32)
    s, ns = (rng.normal(size=(8, 32)).astype(np.float32),
             rng.normal(size=(8, 8)).astype(np.float32))
    jz, js = j_neus.merge_sorted_z(*(jnp.asarray(a) for a in (z, new, s, ns)))
    tz, ts = t_neus.merge_sorted_z(*(torch.from_numpy(a) for a in (z, new, s, ns)))
    _close(jz, tz, 0)
    _close(js, ts, 0)


@pytest.mark.parametrize("n_new", [8, 16])
def test_sample_pdf_det(rng, n_new):
    bins = np.sort(rng.uniform(0.5, 2.5, (16, 33)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (16, 32)).astype(np.float32)
    w[:, 5:9] = 0.0                       # empty bins hit the 1e-5 floor
    _close(j_pdf.sample_pdf(jnp.asarray(bins), jnp.asarray(w), n_new, key=None),
           t_pdf.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), n_new), 1e-5)


@pytest.mark.parametrize("style,activation,skips", [
    ("idr", "relu", (4,)), ("nerf", "softplus100", (4,)), ("nerf", "relu", ())])
def test_skip_mlp(style, activation, skips):
    j_mlp.set_matmul_precision("highest")
    in_dim = 39
    jp = j_mlp.init_skip_mlp(jax.random.PRNGKey(3), 9, 256, in_dim, 17, skips,
                             style=style, geometric_init=(activation == "softplus100"))
    tp = params_from_jax(jp)
    x = np.random.default_rng(1).uniform(-1, 1, (64, in_dim)).astype(np.float32)
    jo = j_mlp.skip_mlp_apply(jp, jnp.asarray(x), skips, activation)
    to = t_mlp.skip_mlp_apply(tp, torch.from_numpy(x), skips, activation, precision="highest")
    _close(jo, to, 1e-5)


def test_skip_mlp_default_precision_rounds_operands():
    """'default' feeds the dots bf16-rounded operands with f32 accumulation."""
    x = torch.tensor([[1.0 + 2 ** -10, 3.0]])
    w = torch.tensor([[1.0], [1.0 + 2 ** -12]])
    assert float(t_mlp.dot(x, w, "highest")) != float(t_mlp.dot(x, w, "default"))
    assert float(t_mlp.dot(x, w, "default")) == 4.0


def test_softplus100_matches_jax(rng):
    z = rng.uniform(-1, 1, (1000,)).astype(np.float32)
    _close(j_mlp.softplus100(jnp.asarray(z)), t_mlp.softplus100(torch.from_numpy(z)))


def test_geometric_init_distribution():
    """Same distributions as the JAX init (the draws themselves differ)."""
    gen = torch.Generator().manual_seed(0)
    p = t_mlp.init_skip_mlp(9, 256, 39, 257, (4,), style="nerf", geometric_init=True,
                            generator=gen)
    layers = p["layers"]
    last = layers[-1]["v"]
    assert abs(float(last.mean()) - math.sqrt(math.pi) / math.sqrt(256)) < 1e-4
    assert float(last.std()) < 2e-4
    assert torch.all(layers[-1]["b"] == -0.8)
    assert torch.all(layers[0]["v"][3:] == 0)
    assert torch.all(layers[4]["v"][-(39 - 3):] == 0)
    std = float(layers[2]["v"].std())
    assert abs(std - math.sqrt(2.0) / math.sqrt(256)) < 0.005
    torch.testing.assert_close(layers[2]["g"], torch.linalg.norm(layers[2]["v"], dim=0))
    plain = t_mlp.init_skip_mlp(3, 64, 10, 3, generator=gen)["layers"][0]["v"]
    assert float(plain.abs().max()) <= 1 / math.sqrt(10)
