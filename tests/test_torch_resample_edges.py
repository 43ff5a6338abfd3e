"""The EndoNeRF resample's plain version (``fused_sampler.fine_resample_math``,
the card kernel's twin) on the inputs where a parallel resample goes wrong
(``fused_sampler.resample_edge_inputs``: a pdf of the weight floor alone,
one opaque sample, alpha exactly 1, duplicated depths, draws exactly on a
coarse depth), held against JAX: at 64 + 64 against the Pallas kernel
``fused_fine_resample`` in interpret mode, at the gate's corners (3 + 1,
3 + 64, 64 + 1, 64 + 64) against JAX's plain path (``raw2outputs``'s
weights, ``sample_pdf`` with deterministic draws, then the sort, as
``models/endonerf.py``'s ``render_rays`` runs it without the kernel).

Tolerances: those of ``test_torch_endonerf.py``'s resample test, and
tighter on the edge rays. The two sides sum the weights and the cdf in other
orders, so a draw moves by float32 rounding (1e-5 absolute); on the random
rays a draw near a cdf step moves further, so, as that test allows, a
sixteenth of all rays may pass 1e-5 up to 5e-3. Every ray of the five edge
kinds, whose pdfs are mostly the exact 1e-5 floor, stays within 1e-5.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endosurf_tpu.kernels import fused_sampler as j_fs
from endosurf_tpu.models import endonerf as j_en
from endosurf_tpu.ops.pdf import sample_pdf as j_sample_pdf
from endosurf_tpu_torch.kernels import fused_sampler as t_fs

F32_TOL = 1e-5
SEED = 0


@functools.partial(jax.jit, static_argnums=3)
def _jax_plain(z, sigma, dn, n_new):
    """models/endonerf.py's resample without the kernel: the coarse weights of
    raw2outputs (rays_d = (|d|, 0, 0)), sample_pdf's deterministic draws over
    the midpoints, the sorted concatenation."""
    rays_d = jnp.concatenate([dn, jnp.zeros((dn.shape[0], 2), dn.dtype)], -1)
    _, _, w = j_en.raw2outputs(jnp.zeros(sigma.shape + (3,), sigma.dtype), sigma, z, rays_d)
    z_new = j_sample_pdf(0.5 * (z[..., 1:] + z[..., :-1]), w[..., 1:-1], n_new, key=None)
    return jnp.sort(jnp.concatenate([z, z_new], -1), axis=-1)


def _check(z, got, ref, n_new):
    """Shape, finite, sorted, the coarse depths kept; the per-ray max error
    within the tolerances above."""
    n, n0 = z.shape
    assert got.shape == ref.shape == (n, n0 + n_new)
    assert np.isfinite(got).all() and np.all(np.diff(got, axis=-1) >= 0)
    for r in range(n):
        assert np.isin(z[r], got[r]).all(), r
    err = np.abs(got - ref).max(-1)
    assert (err > F32_TOL).mean() <= 1.0 / 16 and err.max() <= 5e-3, (err.max(),
                                                                         (err > F32_TOL).mean())
    kinds = np.repeat(t_fs.RESAMPLE_EDGE_KINDS, n // len(t_fs.RESAMPLE_EDGE_KINDS))
    bad = {k: float(err[kinds == k].max()) for k in t_fs.RESAMPLE_EDGE_KINDS
           if k != "random" and err[kinds == k].max() > F32_TOL}
    assert not bad, bad


@pytest.mark.parametrize("corner", t_fs.RESAMPLE_CORNERS,
                         ids=[f"{a}+{b}" for a, b in t_fs.RESAMPLE_CORNERS])
def test_edge_resample_matches_jax_plain(corner):
    n0, n_new = corner
    z, sigma, dn = t_fs.resample_edge_inputs(n0, SEED)
    got = t_fs.fine_resample_math(z, sigma, dn, n_new).numpy()
    ref = np.asarray(_jax_plain(*(jnp.asarray(a.numpy()) for a in (z, sigma, dn)), n_new))
    _check(z.numpy(), got, ref, n_new)


def test_edge_resample_matches_jax_kernel():
    z, sigma, dn = t_fs.resample_edge_inputs(64, SEED)
    got = t_fs.fine_resample_math(z, sigma, dn, 64).numpy()
    ref = np.asarray(j_fs.fused_fine_resample(*(jnp.asarray(a.numpy()) for a in (z, sigma, dn)),
                                              interpret=True))
    _check(z.numpy(), got, ref, 64)


def test_edge_inputs_hold_their_cases():
    """Each kind holds its case at every corner: zero sigma; one opaque
    sample; alpha exactly 1; zero-length bins; draws equal to a coarse depth
    (on_depth rays, the plain version's draws)."""
    per = 8
    for n0, n_new in t_fs.RESAMPLE_CORNERS:
        z, sigma, dn = t_fs.resample_edge_inputs(n0, SEED, per)
        rows = {k: slice(i * per, (i + 1) * per)
                for i, k in enumerate(t_fs.RESAMPLE_EDGE_KINDS)}
        assert bool((z[:, 1:] >= z[:, :-1]).all()) and bool((dn > 0).all())
        assert bool((sigma[rows["zero"]] == 0).all())
        assert bool(((sigma[rows["one_opaque"]] > 0).sum(-1) == 1).all())
        h = rows["huge"]
        alpha = 1.0 - torch.exp(-sigma[h, :-1] * (z[h, 1:] - z[h, :-1]) * dn[h])
        assert bool((alpha == 1.0).any(-1).all())
        for kind in ("duplicates", "on_depth"):
            assert bool(((z[rows[kind], 1:] == z[rows[kind], :-1]).sum(-1) > 0).all()), kind
        out = t_fs.fine_resample_math(z, sigma, dn, n_new)
        on = rows["on_depth"]
        landed = [int(torch.isin(out[r], z[r]).sum()) - n0 for r in range(on.start, on.stop)]
        assert min(landed) >= 1, (n0, n_new, landed)
