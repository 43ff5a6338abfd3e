"""The EndoNeRF train step's pieces held against the JAX package on the CPU:
the two losses and the exponential schedule, the three D-NeRF segments'
backward (the port's autograd Functions on CPU tensors, whose backward is
the plain ``plain_bwd``) against JAX's custom_vjp segments forced onto their
Pallas backward kernels (``_deform_bwd_pl`` / ``_density_bwd_pl`` /
``_color_bwd_pl``, interpreted on the CPU), the field's parameter gradients
with the train noise fed in, ``fused_fine_resample`` on CPU tensors, the
train render (``render_rays_train``) against JAX's ``render_rays`` with a
key, and the float64 yardsticks of the tensor-core kernels (the density
forward's and the deform, density and colour backwards') against JAX's
segments.

Both sides start from one JAX init bridged to torch and get JAX's random
numbers: the segment cotangents from numpy, the render's draws rebuilt from
JAX's key chain (``k_z, k_noise_c, k_noise_f = split(key, 3)``).

Tolerances, per test: float32 gradients per leaf within 1e-5 relative L2
(same math, float32 sums in other orders); bf16 operands on both sides
within 2e-2 per leaf and 5e-2 per point of d x_c / d feat relative to their
RMS (a bf16-rounded cotangent tips on an ulp of float noise now and then),
and the float32 Function fails the bf16 limits as the control; a forward's
outputs per point within 1e-4 of their RMS in float32 and 5e-2 with bf16
operands.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endosurf_tpu.kernels import fused_sampler as j_fs
from endosurf_tpu.kernels import fused_train as j_ft
from endosurf_tpu.kernels import fused_train_dnerf as j_ftd
from endosurf_tpu.models import endonerf as j_en
from endosurf_tpu.ops import mlp as j_mlp
from endosurf_tpu.train import losses as j_losses
from endosurf_tpu.train import schedules as j_sched
from endosurf_tpu_torch.bridge import flatten, params_from_jax
from endosurf_tpu_torch.kernels import fused_sampler as t_fs
from endosurf_tpu_torch.kernels import fused_train_dnerf as t_ftd
from endosurf_tpu_torch.models import endonerf as t_en
from endosurf_tpu_torch.train import losses as t_losses
from endosurf_tpu_torch.train import schedules as t_sched

SMALL = dict(deform_layers=(3, 32, (1,)), density_layers=(3, 32, (1,)),
             color_layers=(2, 32, ()), geo_feat_dim=16)
F32_LEAF, BF16_LEAF, BF16_COT = 1e-5, 2e-2, 5e-2
# Through the whole chain the deform net's gradients arrive through d x_c,
# which the density net's 10-octave encoding scales by up to 2^9: float32
# noise of the density backward reaches 1e-5 relative there (read 1.03e-5 on
# the deform output bias).
F32_CHAIN_LEAF = 1e-4


@pytest.fixture(autouse=True)
def _jax_modes():
    j_mlp.set_matmul_precision("highest")
    j_mlp.set_sampling_precision(None)
    j_ft.set_compute_mode(jnp.float32, "highest")
    yield
    j_ft.set_compute_mode(jnp.float32, "highest")
    j_ftd.set_dnerf_megakernel_mode("auto")
    j_fs.set_sampler_kernel_mode("auto")


def _specs(**kw):
    return j_en.DNeRFSpec(**kw), t_en.DNeRFSpec(**kw)


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _points(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    t = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return x, d / np.linalg.norm(d, axis=-1, keepdims=True), t


def test_losses_and_schedule_match_jax():
    """masked_mse, masked_huber (errors on both sides of delta 0.2),
    endonerf_loss_terms and exponential, 1e-6 relative."""
    rng = np.random.default_rng(0)
    n = 64
    err = rng.uniform(-0.5, 0.5, (n, 1)).astype(np.float32)
    mask = (rng.uniform(size=(n, 1)) > 0.3).astype(np.float32)
    assert (np.abs(err * mask) > 0.2).any() and ((np.abs(err * mask) <= 0.2) & (mask > 0)).any()
    for fn in ("masked_mse", "masked_huber"):
        np.testing.assert_allclose(
            float(getattr(t_losses, fn)(torch.from_numpy(err), torch.from_numpy(mask))),
            float(getattr(j_losses, fn)(jnp.asarray(err), jnp.asarray(mask))), rtol=1e-6,
            err_msg=fn)
    out = {"color_map": rng.uniform(0, 1, (n, 3)), "depth_map": rng.uniform(1, 2, (n, 1))}
    batch = {"color": rng.uniform(0, 1, (n, 3)), "depth": rng.uniform(1, 2, (n, 1)),
             "mask": mask, "color_mask": (rng.uniform(size=(n, 1)) > 0.1)}
    weights = {"color_loss_weight": 1.0, "depth_loss_weight": 0.5}
    tot_j, m_j = j_losses.endonerf_loss_terms(
        {k: jnp.asarray(v, jnp.float32) for k, v in out.items()},
        {k: jnp.asarray(v, jnp.float32) for k, v in batch.items()}, weights)
    tot_t, m_t = t_losses.endonerf_loss_terms(
        {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in out.items()},
        {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in batch.items()}, weights)
    assert set(m_t) == set(m_j) == {"loss_color", "loss_depth", "loss_total", "psnr_color"}
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-6, err_msg=k)
    sj, st = j_sched.exponential(5e-4, 250), t_sched.exponential(5e-4, 250)
    for c in (0, 1, 999, 125000, 250000, 400000):
        np.testing.assert_allclose(st(c), float(sj(c)), rtol=1e-6, err_msg=str(c))


# ---------------------------------------------------------------------------
# the segments' backward
# ---------------------------------------------------------------------------

def _jax_segment_grads(js, pj, seg, inputs, cots, force=True):
    """JAX's custom_vjp segment forced onto its Pallas kernels (interpreted;
    with ``force`` False and the megakernel mode "off", its plain reference:
    jax.vjp of the segment maths), composed with the differentiable prep:
    gradients of the segment's {w, b} and of its differentiable input."""
    segs = dict(zip(("deform", "density", "color"), j_ftd._build_segments(js, force)))
    net = {"deform": "deform", "density": "density", "color": "color"}[seg]

    def f(p_net, *ins):
        eff = j_ftd.prepare_effective_dnerf(js, {**pj, net: p_net})
        if seg == "deform":
            return segs[seg](eff["deform"], ins[0])
        if seg == "density":
            return segs[seg](eff["density"], eff["sigma_head"], eff["geo_feat"], ins[0])
        return segs[seg](eff["color"], ins[0], ins[1])
    _, pull = jax.vjp(f, pj[net], *inputs)
    return pull(cots)


def _port_segment_grads(ts, pt, seg, inputs, cots, precision):
    """The port's Function on CPU tensors (plain backward), composed with the
    differentiable prep: gradients of the segment's {w, b} and of its
    inputs that get a cotangent."""
    net = pt[seg]
    leaves = list(flatten(net).values())
    for v in leaves:
        v.requires_grad_(True)
    ins = [torch.from_numpy(np.asarray(a)).requires_grad_(name in t_ftd.COTANGENT_INPUTS[seg])
           for a, name in zip(inputs, t_ftd.SEGMENT_INPUTS[seg])]
    eff = t_ftd.prepare_effective_dnerf(ts, pt)
    like, flat = t_ftd.segment_weights(eff, seg)
    outs = t_ftd.SEGMENT_FUNCTIONS[seg].apply(ts, like, precision, None, *ins, *flat)
    outs = outs if isinstance(outs, tuple) else (outs,)
    wanted = [i for i in ins if i.requires_grad]
    got = torch.autograd.grad(outs, leaves + wanted, [torch.from_numpy(np.asarray(c))
                                                      for c in cots])
    for v in leaves:
        v.requires_grad_(False)
    return dict(zip(flatten(net), got[:len(leaves)])), got[len(leaves):]


def _segment_case(js, ts, pj, seg, n, seed):
    """Inputs and cotangents of one segment in both layouts: (JAX inputs
    (128-lane padded), JAX cotangents, port inputs, port cotangents)."""
    rng = np.random.default_rng(seed)
    x, d, t = _points(n, seed)
    if seg == "deform":
        xt = np.asarray(j_ft.pad_lanes(jnp.asarray(x), jnp.asarray(t)))
        ct = np.zeros((n, 128), np.float32)
        ct[:, :3] = rng.normal(size=(n, 3))
        return (xt,), ct, (np.concatenate([x, t], 1),), (ct[:, :3],)
    if seg == "density":
        x_c = np.asarray(j_ft.pad_lanes(jnp.asarray(x)))
        c_raw = rng.normal(size=(n, 1)).astype(np.float32)
        c_feat = rng.normal(size=(n, js.geo_feat_dim)).astype(np.float32)
        return (x_c,), (c_raw, c_feat), (x,), (c_raw, c_feat)
    feat = rng.normal(size=(n, js.geo_feat_dim)).astype(np.float32)
    ct = np.zeros((n, 128), np.float32)
    ct[:, :3] = rng.normal(size=(n, 3))
    return (np.asarray(j_ft.pad_lanes(jnp.asarray(d))), feat), ct, (d, feat), (ct[:, :3],)


@pytest.mark.parametrize("precision", ["highest", "default"], ids=["f32", "bf16"])
@pytest.mark.parametrize("seg, use_deform", [("deform", True), ("density", True),
                                             ("color", True), ("density", False),
                                             ("color", False)],
                         ids=["deform", "density", "color", "density-static", "color-static"])
def test_segment_backward_matches_jax_pallas(seg, precision, use_deform):
    """Each segment's plain backward (the Function on CPU tensors) against
    JAX's Pallas backward kernel, interpreted: per-leaf gradients of the
    net's {w, b} and the input cotangent (d x_c [N, 3], d feat [N, F]), in
    float32 and with bf16 operands (JAX's compute mode bfloat16), with and
    without the deform net; the float32 Function fails the bf16 limits."""
    js, ts = _specs(**SMALL, use_deform=use_deform)
    pj = j_en.init_dnerf_params(jax.random.PRNGKey(3), js)
    pt = params_from_jax(pj)
    j_in, j_ct, t_in, t_ct = _segment_case(js, ts, pj, seg, 48, 4)
    if precision == "default":
        j_ft.set_compute_mode(jnp.bfloat16, None)
    j_grads = _jax_segment_grads(js, pj, seg, [jnp.asarray(a) for a in j_in],
                                 jax.tree_util.tree_map(jnp.asarray, j_ct))
    j_ft.set_compute_mode(jnp.float32, "highest")
    ref_leaves = {k: np.asarray(v) for k, v in flatten(j_grads[0]).items()}
    ref_in = ([] if seg == "deform" else [np.asarray(j_grads[1])[:, :3]] if seg == "density"
              else [np.asarray(j_grads[2])])

    def readings(prec):
        leaves, d_in = _port_segment_grads(ts, pt, seg, t_in, t_ct, prec)
        leaf = max(_rel(leaves[k].numpy(), r) for k, r in ref_leaves.items())
        cot = max((float((np.abs(g.numpy() - r).max(-1) / np.sqrt((r ** 2).mean())).max())
                   for g, r in zip(d_in, ref_in)), default=0.0)
        return leaf, cot
    leaf, cot = readings(precision)
    if precision == "highest":
        assert leaf <= F32_LEAF and cot <= F32_LEAF * 10, (leaf, cot)
    else:
        assert leaf <= BF16_LEAF and cot <= BF16_COT, (leaf, cot)
        leaf32, cot32 = readings("highest")
        assert leaf32 > F32_LEAF * 10, leaf32     # the rounding is on


def _as_jax_tree(names, leaves, n_layers, seg):
    """A segment's flat leaves (``leaf_names`` order) as JAX's {w, b} tree
    of its net, flattened: the hidden layers' skip blocks stacked; the
    density's last layer as head + feature columns."""
    got = dict(zip(names, leaves))
    rows = {}
    n_hidden = n_layers - 1 if seg == "density" else n_layers
    for l in range(n_hidden):
        parts = [got[k] for k in names if k.startswith(f"{l}.") and k != f"{l}.b"]
        rows[f"layers/{l}/w"] = torch.cat(parts, 0).numpy()
        rows[f"layers/{l}/b"] = got[f"{l}.b"].numpy()
    if seg == "density":
        rows[f"layers/{n_hidden}/w"] = torch.cat([got["head.w"], got["feat.w"]], 1).numpy()
        rows[f"layers/{n_hidden}/b"] = torch.cat([got["head.b"], got["feat.b"]]).numpy()
    return rows


@pytest.mark.parametrize("precision", ["highest", "default"], ids=["f32", "bf16"])
@pytest.mark.parametrize("use_deform", [True, False], ids=["deform", "static"])
def test_density_bwd_float64_yardstick_matches_jax(precision, use_deform):
    """The density backward's float64 yardstick (dnerf_density_bwd_float64:
    plain_bwd in float64 on the float32 weights) against JAX's density
    segment backward through its plain reference (jax.vjp of
    seg_density_math; the megakernel mode "off"), 48 points: in float32 per
    leaf within F32_LEAF and d x_c within 10 F32_LEAF of its RMS (float64
    against float32 sums); with bf16 operand and cotangent roundings on both
    sides within BF16_LEAF / BF16_COT (a rounding on an ulp of float32 noise
    tips now and then), and the float32 yardstick fails the bf16 limits."""
    js, ts = _specs(**SMALL, use_deform=use_deform)
    pj = j_en.init_dnerf_params(jax.random.PRNGKey(3), js)
    pt = params_from_jax(pj)
    j_in, j_ct, t_in, t_ct = _segment_case(js, ts, pj, "density", 48, 4)
    if precision == "default":
        j_ft.set_compute_mode(jnp.bfloat16, None)
    j_ftd.set_dnerf_megakernel_mode("off")
    j_grads = _jax_segment_grads(js, pj, "density", [jnp.asarray(a) for a in j_in],
                                 jax.tree_util.tree_map(jnp.asarray, j_ct), force=False)
    j_ft.set_compute_mode(jnp.float32, "highest")
    ref_leaves = {k: np.asarray(v) for k, v in flatten(j_grads[0]).items()}
    ref_dxc = np.asarray(j_grads[1])[:, :3]
    eff = t_ftd.prepare_effective_dnerf(ts, pt)
    like, _ = t_ftd.segment_weights(eff, "density")
    names = t_ftd.leaf_names(like, "density")

    def readings(prec):
        leaves, (d_xc,) = t_ftd.dnerf_density_bwd_float64(
            ts, pt, torch.from_numpy(t_in[0]), *(torch.from_numpy(c) for c in t_ct), prec)
        assert d_xc.dtype == torch.float64 and all(v.dtype == torch.float64 for v in leaves)
        rows = _as_jax_tree(names, leaves, len(pj["density"]["layers"]), "density")
        leaf = max(_rel(rows[k], r) for k, r in ref_leaves.items())
        cot = float((np.abs(d_xc.numpy() - ref_dxc).max(-1)
                     / np.sqrt((ref_dxc ** 2).mean())).max())
        return leaf, cot
    leaf, cot = readings(precision)
    if precision == "highest":
        assert leaf <= F32_LEAF and cot <= F32_LEAF * 10, (leaf, cot)
    else:
        assert leaf <= BF16_LEAF and cot <= BF16_COT, (leaf, cot)
        leaf32, _ = readings("highest")
        assert leaf32 > F32_LEAF * 10, leaf32     # the rounding is on


@pytest.mark.parametrize("precision", ["highest", "default"], ids=["f32", "bf16"])
@pytest.mark.parametrize("use_deform", [True, False], ids=["deform", "static"])
def test_color_bwd_float64_yardstick_matches_jax(precision, use_deform):
    """The colour backward's float64 yardstick (dnerf_color_bwd_float64:
    plain_bwd in float64 on the float32 weights) against JAX's colour
    segment backward forced onto its Pallas kernel (_color_bwd_pl,
    interpreted), 48 points: in float32 per leaf within F32_LEAF and d feat
    within 10 F32_LEAF of its RMS (float64 against float32 sums); with bf16
    operand and cotangent roundings on both sides within BF16_LEAF /
    BF16_COT (a rounding on an ulp of float32 noise tips now and then); the
    float32 yardstick fails the bf16 limits on the leaves."""
    js, ts = _specs(**SMALL, use_deform=use_deform)
    pj = j_en.init_dnerf_params(jax.random.PRNGKey(3), js)
    pt = params_from_jax(pj)
    j_in, j_ct, t_in, t_ct = _segment_case(js, ts, pj, "color", 48, 4)
    if precision == "default":
        j_ft.set_compute_mode(jnp.bfloat16, None)
    j_grads = _jax_segment_grads(js, pj, "color", [jnp.asarray(a) for a in j_in],
                                 jnp.asarray(j_ct))
    j_ft.set_compute_mode(jnp.float32, "highest")
    ref_leaves = {k: np.asarray(v) for k, v in flatten(j_grads[0]).items()}
    ref_dfeat = np.asarray(j_grads[2])
    like, _ = t_ftd.segment_weights(t_ftd.prepare_effective_dnerf(ts, pt), "color")
    names = t_ftd.leaf_names(like, "color")

    def readings(prec):
        leaves, (none, d_feat) = t_ftd.dnerf_color_bwd_float64(
            ts, pt, *(torch.from_numpy(a) for a in t_in), torch.from_numpy(t_ct[0]), prec)
        assert none is None and d_feat.dtype == torch.float64
        assert all(v.dtype == torch.float64 for v in leaves)
        rows = _as_jax_tree(names, leaves, len(pj["color"]["layers"]), "color")
        leaf = max(_rel(rows[k], r) for k, r in ref_leaves.items())
        cot = float((np.abs(d_feat.numpy() - ref_dfeat).max(-1)
                     / np.sqrt((ref_dfeat ** 2).mean())).max())
        return leaf, cot
    leaf, cot = readings(precision)
    print(f"colour bwd float64 yardstick vs JAX {precision}: leaf {leaf:.3e}, d feat {cot:.3e}")
    if precision == "highest":
        assert leaf <= F32_LEAF and cot <= F32_LEAF * 10, (leaf, cot)
    else:
        assert leaf <= BF16_LEAF and cot <= BF16_COT, (leaf, cot)
        leaf32, _ = readings("highest")
        assert leaf32 > F32_LEAF * 10, leaf32     # the rounding is on


@pytest.mark.parametrize("precision", ["highest", "default"], ids=["f32", "bf16"])
def test_color_walk_float64_is_the_yardstick_walk(precision):
    """The colour backward's float64 walk (dnerf_color_walk_float64, what
    walk_distance holds the kernels' scratch against) is the yardstick's
    (dnerf_color_bwd_float64) own arithmetic: its operands and cotangents
    give the yardstick's weight gradients (each layer's rounded as the
    yardstick rounds: bf16 under "default", the bias unrounded) and d feat
    (the feature columns of layer 0's input cotangent, rounded), within
    1e-12 relative (float64 sums in other orders)."""
    js, ts = _specs(**SMALL)
    pj = j_en.init_dnerf_params(jax.random.PRNGKey(3), js)
    pt = params_from_jax(pj)
    _, _, t_in, t_ct = _segment_case(js, ts, pj, "color", 48, 4)
    d, feat, g_rgb = (torch.from_numpy(np.asarray(a)) for a in (*t_in, t_ct[0]))
    ins, dzs = t_ftd.dnerf_color_walk_float64(ts, pt, d, feat, g_rgb, precision)
    leaves, (_, d_feat) = t_ftd.dnerf_color_bwd_float64(ts, pt, d, feat, g_rgb, precision)
    like, _ = t_ftd.segment_weights(t_ftd.prepare_effective_dnerf(ts, pt), "color")
    rows = _as_jax_tree(t_ftd.leaf_names(like, "color"), leaves, len(ins), "color")

    def op(x):
        return x.float().to(torch.bfloat16).double() if precision == "default" else x
    for l, (a, dz) in enumerate(zip(ins, dzs)):
        assert _rel(op(a.T @ dz).numpy(), rows[f"layers/{l}/w"]) <= 1e-12, l
        assert _rel(dz.sum(0).numpy(), rows[f"layers/{l}/b"]) <= 1e-12, l
    w0 = pt["color"]["layers"][0]["w"].double()
    want = op(dzs[0] @ (op(w0) if precision == "default" else w0).T)[:, -feat.shape[1]:]
    assert _rel(want.numpy(), d_feat.numpy()) <= 1e-12


@pytest.mark.parametrize("precision", ["highest", "default"], ids=["f32", "bf16"])
def test_deform_bwd_float64_yardstick_matches_jax(precision):
    """The deform backward's float64 yardstick (dnerf_deform_bwd_float64:
    plain_bwd in float64 on the float32 weights) against JAX's deform
    segment backward forced onto its Pallas kernel (_deform_bwd_pl,
    interpreted), 48 points: per leaf within F32_LEAF in float32 (float64
    against float32 sums) and BF16_LEAF with bf16 operand and cotangent
    roundings on both sides; the float32 yardstick fails the bf16 limit."""
    js, ts = _specs(**SMALL)
    pj = j_en.init_dnerf_params(jax.random.PRNGKey(3), js)
    pt = params_from_jax(pj)
    j_in, j_ct, t_in, t_ct = _segment_case(js, ts, pj, "deform", 48, 4)
    if precision == "default":
        j_ft.set_compute_mode(jnp.bfloat16, None)
    j_grads = _jax_segment_grads(js, pj, "deform", [jnp.asarray(a) for a in j_in],
                                 jnp.asarray(j_ct))
    j_ft.set_compute_mode(jnp.float32, "highest")
    ref_leaves = {k: np.asarray(v) for k, v in flatten(j_grads[0]).items()}
    like, _ = t_ftd.segment_weights(t_ftd.prepare_effective_dnerf(ts, pt), "deform")
    names = t_ftd.leaf_names(like, "deform")

    def reading(prec):
        leaves, (none,) = t_ftd.dnerf_deform_bwd_float64(
            ts, pt, torch.from_numpy(t_in[0]), torch.from_numpy(t_ct[0]), prec)
        assert none is None and all(v.dtype == torch.float64 for v in leaves)
        rows = _as_jax_tree(names, leaves, len(pj["deform"]["layers"]), "deform")
        return max(_rel(rows[k], r) for k, r in ref_leaves.items())
    leaf = reading(precision)
    if precision == "highest":
        assert leaf <= F32_LEAF, leaf
    else:
        assert leaf <= BF16_LEAF, leaf
        assert reading("highest") > F32_LEAF * 10     # the rounding is on


@pytest.mark.parametrize("precision", ["highest", "default"], ids=["f32", "bf16"])
def test_density_fwd_float64_yardstick_matches_jax(precision):
    """The density forward's float64 yardstick (dnerf_density_fwd_float64:
    seg_math in float64 on the float32 weights) against JAX's density
    segment forced onto its Pallas kernel (_density_fwd_pl, interpreted), 48
    points: per point, the largest |difference| of raw sigma and of the
    feature over the output's RMS, within 10 F32_LEAF in float32 (float64
    against float32 sums) and BF16_COT with bf16 operand roundings on both
    sides (an operand rounding on an ulp of float32 noise tips now and then);
    the float32 yardstick fails the bf16 limit by reading above 10 F32_LEAF
    on the feature."""
    js, ts = _specs(**SMALL)
    pj = j_en.init_dnerf_params(jax.random.PRNGKey(3), js)
    pt = params_from_jax(pj)
    j_in, _, t_in, _ = _segment_case(js, ts, pj, "density", 48, 4)
    if precision == "default":
        j_ft.set_compute_mode(jnp.bfloat16, None)
    seg_density = j_ftd._build_segments(js, True)[1]
    eff = j_ftd.prepare_effective_dnerf(js, pj)
    ref = [np.asarray(v) for v in seg_density(eff["density"], eff["sigma_head"], eff["geo_feat"],
                                              jnp.asarray(j_in[0]))]
    j_ft.set_compute_mode(jnp.float32, "highest")

    def readings(prec):
        outs = t_ftd.dnerf_density_fwd_float64(ts, pt, torch.from_numpy(t_in[0]), prec)
        assert all(v.dtype == torch.float64 for v in outs)
        return [float((np.abs(g.numpy() - r).max(-1) / np.sqrt((r ** 2).mean())).max())
                for g, r in zip(outs, ref)]
    errs = readings(precision)
    if precision == "highest":
        assert max(errs) <= F32_LEAF * 10, errs
    else:
        assert max(errs) <= BF16_COT, errs
        assert readings("highest")[1] > F32_LEAF * 10     # the rounding is on


@pytest.mark.parametrize("precision", ["highest", "default"], ids=["f32", "bf16"])
def test_deform_fwd_float64_yardstick_matches_jax(precision):
    """The deform forward's float64 yardstick (dnerf_deform_fwd_float64:
    seg_math in float64 on the float32 weights) against JAX's deform segment
    forced onto its Pallas kernel (_deform_fwd_pl, interpreted), 48 points:
    per point, the largest |difference| of x_c over its RMS, within F32_LEAF
    in float32 (float64 against float32 sums) and BF16_COT with bf16 operand
    roundings on both sides; the float32 yardstick fails the bf16 case by
    reading above 10 F32_LEAF."""
    js, ts = _specs(**SMALL)
    pj = j_en.init_dnerf_params(jax.random.PRNGKey(3), js)
    pt = params_from_jax(pj)
    j_in, _, t_in, _ = _segment_case(js, ts, pj, "deform", 48, 4)
    if precision == "default":
        j_ft.set_compute_mode(jnp.bfloat16, None)
    seg_deform = j_ftd._build_segments(js, True)[0]
    eff = j_ftd.prepare_effective_dnerf(js, pj)
    ref = np.asarray(seg_deform(eff["deform"], jnp.asarray(j_in[0])))[:, :3]
    j_ft.set_compute_mode(jnp.float32, "highest")

    def reading(prec):
        got = t_ftd.dnerf_deform_fwd_float64(ts, pt, torch.from_numpy(t_in[0]), prec)
        assert got.dtype == torch.float64 and got.shape == (48, 3)
        return float((np.abs(got.numpy() - ref).max(-1) / np.sqrt((ref ** 2).mean())).max())
    err = reading(precision)
    print(f"deform fwd float64 yardstick vs JAX {precision}: {err:.3e}")
    if precision == "highest":
        assert err <= F32_LEAF, err
    else:
        assert err <= BF16_COT, err
        control = reading("highest")
        print(f"control (float32 yardstick vs JAX bf16): {control:.3e}")
        assert control > F32_LEAF * 10     # the rounding is on


@pytest.mark.parametrize("precision", ["highest", "default"], ids=["f32", "bf16"])
def test_field_gradients_match_jax_megakernel(precision):
    """field_eval with the train noise fed in, under autograd through the
    three Functions, against JAX's field_eval on megakernel_field_raw forced
    onto its Pallas kernels: rgb and sigma, and the parameter gradients of a
    weighted sum of both, per leaf (float32 1e-5, bf16 2e-2 relative L2)."""
    js, ts = _specs(**SMALL)
    pj = j_en.init_dnerf_params(jax.random.PRNGKey(5), js)
    pt = params_from_jax(pj)
    x, d, t = _points(40, 6)
    rng = np.random.default_rng(7)
    w_rgb = rng.normal(size=(40, 3)).astype(np.float32)
    w_sig = rng.normal(size=(40,)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    noise = np.asarray(jax.random.normal(key, (40,), jnp.float32))
    j_ftd.set_dnerf_megakernel_mode("on")
    j_mlp.set_matmul_precision(precision)     # field_eval syncs the kernels' compute mode to it

    def loss_j(p):
        rgb, sigma = j_en.field_eval(js, p, jnp.asarray(x), jnp.asarray(d), jnp.asarray(t),
                                     noise_key=key)
        return jnp.sum(rgb * w_rgb) + jnp.sum(sigma * w_sig), (rgb, sigma)
    (_, (rgb_j, sig_j)), g_j = jax.value_and_grad(loss_j, has_aux=True)(pj)
    for v in flatten(pt).values():
        v.requires_grad_(True)
    rgb_t, sig_t = t_en.field_eval(ts, pt, *map(torch.from_numpy, (x, d, t)),
                                   precision=precision, noise=torch.from_numpy(noise.copy()))
    ((rgb_t * torch.from_numpy(w_rgb)).sum() + (sig_t * torch.from_numpy(w_sig)).sum()).backward()
    tol_out, tol_leaf = (1e-5, F32_CHAIN_LEAF) if precision == "highest" else (5e-3, BF16_LEAF)
    np.testing.assert_allclose(rgb_t.detach().numpy(), np.asarray(rgb_j), atol=tol_out)
    np.testing.assert_allclose(sig_t.detach().numpy(), np.asarray(sig_j), atol=tol_out * 10)
    gj = flatten(g_j)
    for k, v in flatten(pt).items():
        assert _rel(v.grad.numpy(), np.asarray(gj[k])) <= tol_leaf, (k, _rel(v.grad.numpy(),
                                                                               np.asarray(gj[k])))


def test_fused_fine_resample_on_cpu_matches_jax_kernel():
    """fused_fine_resample on CPU tensors (the plain version) against JAX's
    interpreted fused_fine_resample on harsh coarse densities (a quarter of
    the rays empty): 1e-5 on all but 1 ray in 16, 5e-3 on every ray (a draw
    on a cdf step moves with a float32 ulp); the kernel's own gate and the
    CUDA entry's device check."""
    rng = np.random.default_rng(11)
    z = np.sort(rng.normal(1.8, 0.3, (128, 64)), axis=-1).astype(np.float32)
    sigma = np.maximum(rng.normal(0.0, 3.0, (128, 64)), 0).astype(np.float32)
    sigma[:32] = 0.0
    dn = rng.uniform(0.9, 1.3, (128, 1)).astype(np.float32)
    ref = np.asarray(j_fs.fused_fine_resample(jnp.asarray(z), jnp.asarray(sigma), jnp.asarray(dn),
                                              interpret=True))
    got = t_fs.fused_fine_resample(*map(torch.from_numpy, (z, sigma, dn))).numpy()
    assert got.shape == (128, 128) and np.all(np.diff(got, axis=-1) >= 0)
    err = np.abs(got - ref).max(-1)
    assert (err > 1e-5).mean() <= 1.0 / 16 and err.max() <= 5e-3, (err.max(), (err > 1e-5).mean())
    assert t_fs.fine_resample_shape_supported(64, 64) and t_fs.fine_resample_shape_supported(8, 8)
    assert not t_fs.fine_resample_shape_supported(65, 64)
    assert not t_fs.fine_resample_shape_supported(64, 65)
    with pytest.raises(ValueError, match="CUDA"):
        t_fs.fused_fine_resample_cuda(*map(torch.from_numpy, (z, sigma, dn)))


# ---------------------------------------------------------------------------
# the train render
# ---------------------------------------------------------------------------

def render_draws(key, rspec, n_rays, raw_noise_std=1.0):
    """The train render's draws from JAX's key chain, as torch tensors."""
    k_z, k_noise_c, k_noise_f = jax.random.split(key, 3)
    n0, k = rspec.n_samples, rspec.n_samples + rspec.n_importance

    def t(a):
        return torch.from_numpy(np.array(a))
    out = {}
    if rspec.use_depth_sampling:
        out["z"] = t(jax.random.normal(k_z, (n_rays, n0)))
    elif rspec.perturb:
        out["z"] = t(jax.random.uniform(k_z, (n_rays, n0)))
    if not rspec.perturb:
        out["u_pdf"] = t(jax.random.uniform(k_z, (n_rays, rspec.n_importance)))
    if raw_noise_std > 0:
        out["noise_c"] = t(jax.random.normal(k_noise_c, (n_rays * n0,)))
        out["noise_f"] = t(jax.random.normal(k_noise_f, (n_rays * k,)))
    return out


def _train_rays(n, depth_guided, seed=1):
    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(-0.3, 0.3, (n, 2)), np.full((n, 1), -1.5)], -1)
    d = rng.uniform(-0.2, 0.2, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nf = (np.stack([rng.uniform(1.3, 1.6, n), np.full(n, 0.08)], -1) if depth_guided
          else np.stack([np.full(n, 0.8), np.full(n, 2.2)], -1))
    return np.concatenate([o, d, nf, rng.uniform(0, 1, (n, 1))], -1).astype(np.float32)


def _render_close(got, ref) -> bool:
    err = np.abs(got.detach().numpy() - np.asarray(ref)).reshape(got.shape[0], -1).max(-1)
    return bool(np.median(err) <= 2e-5 and (err > 1e-4).mean() <= 1.0 / 8 and err.max() <= 1e-2)


@pytest.mark.parametrize("perturb", [True, False], ids=["perturb", "no-perturb"])
@pytest.mark.parametrize("depth_guided", [True, False], ids=["depth-guided", "uniform"])
def test_train_render_matches_jax(depth_guided, perturb):
    """render_rays_train with JAX's draws against JAX's render_rays(key=k),
    64 + 64 samples, the train noise on, float32: per ray, the maps' and the
    weights' error has a median within 2e-5, at most 1 ray in 8 over 1e-4
    and every ray within 1e-2 (read over the four cases: medians <= 9.5e-6,
    <= 7.8 % of the rays over 1e-4, max 5.6e-3 on the weights). The fields
    are chaotic in their coordinates (10 octaves) and a deterministic draw
    on a cdf step moves with a float32 ulp of the coarse weights, which the
    train noise leaves on many steps. As the control, the render without
    the fine pass's noise fails."""
    js, ts = _specs(**SMALL)
    kw = dict(perturb=perturb, use_depth_sampling=depth_guided)
    jr, tr = j_en.DNeRFRenderSpec(**kw), t_en.DNeRFRenderSpec(**kw)
    pj = j_en.init_dnerf_params(jax.random.PRNGKey(9), js)
    rays = _train_rays(64, depth_guided)
    key = jax.random.PRNGKey(10)
    ref = jax.jit(lambda p, r: j_en.render_rays(js, jr, p, r, key=key))(pj, jnp.asarray(rays))
    pt = params_from_jax(pj)
    for v in flatten(pt).values():
        v.requires_grad_(True)
    got = t_en.render_rays_train(ts, tr, pt, torch.from_numpy(rays),
                                 draws=render_draws(key, tr, 64))
    for k in ("color_map", "depth_map", "weights"):
        assert got[k].shape == ref[k].shape, k
        assert _render_close(got[k], ref[k]), k
    assert got["color_map"].requires_grad
    if depth_guided and perturb:
        quiet = {**render_draws(key, tr, 64), "noise_f": torch.zeros(64 * 128)}
        ctl = t_en.render_rays_train(ts, tr, pt, torch.from_numpy(rays), draws=quiet)
        assert not _render_close(ctl["weights"], ref["weights"])
    gen = torch.Generator().manual_seed(0)      # the generator path draws the same shapes
    again = t_en.render_rays_train(ts, tr, params_from_jax(pj), torch.from_numpy(rays),
                                   generator=gen)
    assert again["weights"].shape == got["weights"].shape
    with pytest.raises(ValueError, match="needs draw"):
        t_en.render_rays_train(ts, tr, params_from_jax(pj), torch.from_numpy(rays), draws={})
