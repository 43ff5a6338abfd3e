#!/usr/bin/env python
"""The EndoSurf train step's gradients, the port's against JAX's, on the
CPU, per draw key: how far apart they are, and where the gap comes from.

    JAX_PLATFORMS=cpu python tools/probe_step_keys.py [SHAPE] [KEY ...]

SHAPE is one of tests/test_torch_nets.py's SHAPES, or ``base9`` for
tests/test_torch_train.py's narrow 9-layer nets (default); KEYs default to
7 8 9 11. On the 12x16 synthetic scene with 32 rays (test_torch_train.py's
step), per key, the three worst leaves (relative L2; the colour net's
leaves left out, the tests hold them at 1e-2) of:

* the port's step (megakernel on, the segments' plain versions) against
  JAX's ``make_train_step`` (megakernel "on");
* JAX's two paths (on / off) against each other;
* the port's step against itself with the SDF's first layer scaled by
  1 + 2^-23 (whether the step is ill-conditioned there);
* JAX's step against the port's step in float64 (the plain field path);
* the port's step given JAX's upsampled samples against JAX's.

Then the upsampled z of the port's and JAX's float32 steps against the
port's float64 step's (median, p99, max), and the colour net's relu gates
whose pre-activation changes sign between the port's float32 and float64
steps (ray, sample, layer, unit, the two values).
"""

from __future__ import annotations

import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import endosurf_tpu.train.trainer_endosurf as j_tr
    import tests.test_torch_nets as tn
    import tests.test_torch_nets_train as tnt
    from endosurf_tpu.data import scene_data as j_scene
    from endosurf_tpu.kernels import fused_sampler as j_fs
    from endosurf_tpu.models import endosurf as j_es
    from endosurf_tpu.models import fields as j_fields
    from endosurf_tpu.ops import mlp as j_mlp
    from endosurf_tpu_torch.bridge import flatten, params_from_jax
    from endosurf_tpu_torch.data import scene_data as t_scene
    from endosurf_tpu_torch.kernels import fused_sampler as t_fs
    from endosurf_tpu_torch.kernels import fused_train as t_ft
    from endosurf_tpu_torch.models import endosurf as t_es
    from endosurf_tpu_torch.models import fields as t_fields
    from endosurf_tpu_torch.train import trainer_endosurf as t_tr
    from tests.test_torch_train import WEIGHTS, _grab_grads_tx, _grad_rel_l2, jax_draws

    tn.SHAPES["base9"] = ((9, 64, (4,)), (9, 64, (4,)), (9, 64, (4,)))
    shape = sys.argv[1] if len(sys.argv) > 1 else "base9"
    keys = [int(k) for k in sys.argv[2:]] or [7, 8, 9, 11]
    j_mlp.set_matmul_precision("highest")
    j_mlp.set_sampling_precision(None)
    j_fs.set_sampler_kernel_mode("off")
    h, w, b = tnt.H, tnt.W, tnt.B
    pj, _ = tn.params(shape)
    spec_j, spec_t = tn.spec_of(j_fields, shape), tn.spec_of(t_fields, shape)
    sj = j_scene.make_synthetic_arrays(4, h, w, seed=0)
    st = t_scene.make_synthetic_arrays(4, h, w, seed=0)
    seen = {}
    jax_terms, port_upsample, port_eval = (j_tr.endosurf_loss_terms, t_fs.fused_upsample_z,
                                           t_es.fused_point_eval)

    def spy(out, *rest):
        jax.debug.callback(lambda z, s: seen.update(z=np.array(z), sdf=np.array(s)),
                           out["up_z"], out["up_sdf"])
        return jax_terms(out, *rest)
    j_tr.endosurf_loss_terms = spy

    def jax_grads(key, mode):
        j_fields.set_megakernel_mode(mode)
        tx = _grab_grads_tx()
        step = j_tr.make_train_step(spec_j, j_es.RenderSpec(anneal_end=50.0), tx, h, w, b,
                                    WEIGHTS, 0.1)
        _, g, _ = step(jax.tree_util.tree_map(jnp.array, pj), tx.init(pj), sj.device_arrays,
                       key, jnp.asarray(20.0))
        jax.effects_barrier()
        return {k: np.asarray(v) for k, v in flatten(g).items()}

    def port_grads(key, eps=0.0, dtype=torch.float32, jax_samples=False):
        def upsample(*a, **k):
            z, sdf = port_upsample(*a, **k)
            seen["port_z"] = z.double().numpy()
            return ((torch.from_numpy(seen["z"]), torch.from_numpy(seen["sdf"]))
                    if jax_samples else (z, sdf))

        def point_eval(*a, **k):
            seen["points"] = a[:5]
            return port_eval(*a, **k)
        t_fs.fused_upsample_z, t_es.fused_point_eval = upsample, point_eval
        pt = params_from_jax(pj)
        with torch.no_grad():
            for k, v in flatten(pt).items():
                v.data = v.data.to(dtype)
                if k.startswith("sdf_network/layers/0"):
                    v.mul_(1 + eps)
        for v in flatten(pt).values():
            v.requires_grad_(True)
        arrays = {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v
                  for k, v in st.device_arrays.items()}
        draws = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in jax_draws(key, len(st.list_train), b).items()}
        loss = t_tr.make_loss_fn(spec_t, t_es.RenderSpec(anneal_end=50.0), h, w, b, WEIGHTS, 0.1,
                                 megakernel="off" if dtype == torch.float64 else "on")
        total, _ = loss(pt, arrays, 20.0, None, draws)
        total.backward()
        t_fs.fused_upsample_z, t_es.fused_point_eval = port_upsample, port_eval
        return {k: v.grad.double().numpy() for k, v in flatten(pt).items()}

    def colour_zs():
        """The colour net's hidden pre-activations at the render's last points."""
        spec, params, x, d, t = (a.detach() if torch.is_tensor(a) else a
                                 for a in seen["points"])
        with torch.no_grad():
            eff = t_ft.prepare_effective(spec, params)
            x_c, jrows = t_ft.seg_deform_math(spec, eff["deform"], torch.cat([x, t], -1))
            _, feat, grad_c = t_ft.seg_sdf_math(spec, eff["sdf"], eff["sdf_head"],
                                                eff["sdf_feat"], x_c)
            d_c = t_ft.coupling_math(jrows, grad_c, d)[1]
            enc = [t_ft.encode_with_derivative(a, (3,), (f,))[0]
                   for a, f in ((x_c, spec.color_pos_freqs), (d_c, spec.color_dir_freqs))]
            _, zs = t_ft._mlp_fwd(eff["color"], [enc[0], grad_c, enc[1], feat], torch.relu,
                                  "highest")
        return [z.double().numpy() for z in zs[:-1]]

    def worst(a, ref):
        rows = sorted(((_grad_rel_l2(a[k], ref[k]), k) for k in ref
                       if not k.startswith("color")), reverse=True)[:3]
        return ", ".join(f"{k} {r:.2e}" for r, k in rows)

    def spread(z, ref):
        e = np.abs(z - ref).ravel()
        return f"{np.median(e):.2e} / {np.quantile(e, 0.99):.2e} / {e.max():.2e}"

    for kk in keys:
        key = jax.random.PRNGKey(kk)
        off, on = jax_grads(key, "off"), jax_grads(key, "on")
        z_jax = seen["z"].astype(np.float64)
        f64 = port_grads(key, dtype=torch.float64)
        z64, zs64 = seen["port_z"], colour_zs()
        port = port_grads(key)
        z32, zs32 = seen["port_z"], colour_zs()
        print(f"{shape} key {kk}: port vs JAX: {worst(port, on)}; JAX on vs off: "
              f"{worst(on, off)}; port at 1 + 2^-23: {worst(port_grads(key, 2.0 ** -23), port)}; "
              f"JAX vs port in float64: {worst(on, f64)}; port on JAX's samples: "
              f"{worst(port_grads(key, jax_samples=True), on)}", flush=True)
        flips = [(l, i, j, a[i, j], c[i, j]) for l, (a, c) in enumerate(zip(zs32, zs64))
                 for i, j in np.argwhere(np.sign(a) != np.sign(c))]
        n_s = z32.shape[1]
        print(f"{shape} key {kk}: upsampled z against the port's float64 (median / p99 / max): "
              f"port {spread(z32, z64)}, JAX {spread(z_jax, z64)}; colour gates flipped "
              "(ray, sample, layer, unit: float32, float64): " + ("; ".join(
                  f"{i // n_s}, {i % n_s}, {l}, {j}: {a:.3e}, {c:.3e}"
                  for l, i, j, a, c in flips) or "none"), flush=True)
    j_fields.set_megakernel_mode("auto")
    j_tr.endosurf_loss_terms = jax_terms
    return 0


if __name__ == "__main__":
    sys.exit(main())
