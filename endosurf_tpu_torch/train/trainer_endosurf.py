"""EndoSurf trainer (port of ``endosurf_tpu/train/trainer_endosurf.py``).

One train step: draw a batch (a train frame and mask-guided pixels), render
it with importance upsampling (``fused_upsample_z``: the CUDA kernel on the
GPU), query the fields at the ground-truth depth points and around the
surface found on the render's own samples (or, with ``surf_march_reuse:
false``, by the sphere trace ``fused_ray_march``: the CUDA kernel on the
GPU), sum the six losses, backpropagate
through the field evaluation with autograd (the Eikonal and the two
gradient losses are second order), and take an Adam step.

Port notes:
- ``train.megakernel`` picks the field evaluation's path as in JAX. On the
  card (``auto`` or ``on``) it runs the three field segments, forward and
  backward, as CUDA kernels (``kernels/fused_train_cuda.py``) at every point
  count: JAX's TPU path. On the CPU ``auto`` and ``off`` run the field math
  under autograd (JAX's path off its accelerator), and ``on`` runs the
  segments' plain versions. ``off`` on a CUDA device raises: the card always
  runs the kernels.
- ``"default"`` precision rounds every dot operand to bf16 and accumulates
  and stores in float32 (the JAX megakernel's semantics). The JAX non-kernel
  path at ``"default"`` also stores MLP activations in bf16 and uses its
  ``linearize`` Jacobian; ``activation_dtype``, ``jac_mode`` and ``remat``
  are JAX-only knobs and are not read here.
- ``fold_aux_queries: true`` appends the ground-truth depth points and the
  sphere-traced surface and neighbour points (``fused_ray_march`` on the
  card) to the render's sample points, so one field evaluation (the segment
  kernels on the card) serves the render and both auxiliary losses; it turns
  march reuse off, as in JAX. ``pixel_sampler: alias`` draws pixels from
  Walker/Vose tables (built when first asked for).
- ``parallel.data_parallel`` (and any process group of more than one rank)
  runs the step data-parallel (``parallel.mesh``): every rank draws the same
  global batch and draws, keeps its rows, takes its share of each global
  masked mean, and the gradients are summed over the ranks before the same
  Adam step on every rank. Launch one rank a card with ``torchrun``.
- ``sampler_kernel: off`` is not ported and raises. ``steps_per_call`` and
  ``presample_batches`` only change JAX's dispatch (a window of steps in one
  program; its batches drawn before the window's scan, the same draws by
  construction), so the port has nothing to port for them.
- Every random draw comes from one ``torch.Generator`` on the device
  (seeded from ``exp.seed``) or is passed in (``draws``), in this order:
  ``frame`` (index into list_train), the pixel draws (``u_pix`` [B]; for
  ``alias`` ``j_pix`` [B] then ``u_pix``), ``z`` [B, 1] (z jitter), ``neig``
  [B, 3] (neighbour offsets), the uniforms in [0, 1). Under data
  parallelism they are the global batch's draws on every rank.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from endosurf_tpu_torch.bridge import flatten
from endosurf_tpu_torch.data.scene_data import sample_train_batch
from endosurf_tpu_torch.models.endosurf import (
    RenderSpec,
    depth_points,
    error_on_depth_ratios,
    render_rays,
    surface_neighbour_points,
    surface_neighbour_ratio,
)
from endosurf_tpu_torch.models.fields import (
    MEGAKERNEL_MODES,
    EndoSurfSpec,
    init_endosurf_params,
    sdf_grad_observed,
    sdf_observed,
)
from endosurf_tpu_torch.ops.mlp import PRECISIONS
from endosurf_tpu_torch.parallel.mesh import DataMesh, all_reduce_grads
from endosurf_tpu_torch.serve import make_render_fn
from endosurf_tpu_torch.train.losses import endosurf_loss_terms
from endosurf_tpu_torch.train.schedules import warmup_cosine
from endosurf_tpu_torch.train.trainer import Trainer

LOSS_WEIGHT_KEYS = (
    "color_loss_weight", "depth_loss_weight", "sdf_loss_weight",
    "angle_loss_weight", "eikonal_loss_weight", "surf_neig_loss_weight",
)

Draws = Optional[Dict[str, torch.Tensor]]


def fold_split(extra_sdf: torch.Tensor, extra_grad: torch.Tensor, n_rays: int,
               need_depth_terms: bool):
    """The folded queries' rows of the render's ``extra_sdf`` / ``extra_grad``:
    (SDF and gradient at the depth points [R, ...], or None; the gradients at
    the surface then the neighbour points [2R, 3], or an empty slice)."""
    off = n_rays if need_depth_terms else 0
    depth = (extra_sdf[:n_rays], extra_grad[:n_rays]) if need_depth_terms else None
    return depth, extra_grad[off:off + 2 * n_rays]


def make_loss_fn(spec: EndoSurfSpec, rspec: RenderSpec, h: int, w: int, ray_batch: int,
                 loss_weights: Dict[str, float], surf_neig_rad: float,
                 mask_guided: bool = True, use_importance: bool = True,
                 fold_aux: bool = False, march_reuse: bool = True,
                 march_reuse_secant: int = 0, pixel_sampler: str = "cdf",
                 precision: str = "highest", sampling_precision: Optional[str] = None,
                 megakernel: str = "auto", mesh: Optional[DataMesh] = None):
    """``loss_fn(params, arrays, step, generator=None, draws=None) ->
    (total, metrics)``: batch, render, auxiliary queries and the six losses.
    Terms with zero weight are not computed. ``megakernel`` picks the render's
    field evaluation (``fields.fused_point_eval``). ``fold_aux`` batches the
    auxiliary queries into the render's field evaluation. With ``mesh`` the
    batch and draws are global, the render runs on this rank's rows, ``total``
    is this rank's share of the global loss and the metrics are global."""
    need_depth_terms = (loss_weights["sdf_loss_weight"] != 0.0
                        or loss_weights["angle_loss_weight"] != 0.0
                        or loss_weights["depth_loss_weight"] != 0.0)
    need_surf = loss_weights["surf_neig_loss_weight"] != 0.0
    march_reuse = (march_reuse and need_surf and use_importance and rspec.n_importance > 0
                   and not fold_aux)
    sp = sampling_precision or precision

    def loss_fn(params, arrays, step, generator: Optional[torch.Generator] = None,
                draws: Draws = None):
        draws = draws or {}
        batch = sample_train_batch(arrays, h, w, ray_batch, mask_guided, pixel_sampler,
                                   generator, draws.get("frame"), draws.get("u_pix"),
                                   draws.get("j_pix"))
        dev = batch["rays"].device
        ray_draws = {"z": draws.get("z"), "neig": draws.get("neig")}
        if ray_draws["z"] is None and rspec.perturb and generator is not None:
            ray_draws["z"] = torch.rand(ray_batch, 1, generator=generator, device=dev)
        if ray_draws["neig"] is None and need_surf and generator is not None:
            ray_draws["neig"] = torch.rand(ray_batch, 3, generator=generator, device=dev)
        if mesh is not None:
            batch, ray_draws = mesh.shard(batch), mesh.shard(ray_draws)
        rays, mask = batch["rays"], batch["mask"]
        n_rays, t = rays.shape[0], rays[:, 8:9]
        pts_d = depth_points(rays, batch["depth"]) if need_depth_terms else None

        extra, valid_surf = None, None
        if fold_aux and (need_depth_terms or need_surf):
            rays_d = rays[:, 3:6]
            groups = []
            if need_depth_terms:
                groups.append((pts_d, rays_d, t))
            if need_surf:
                pts2, valid_surf = surface_neighbour_points(
                    spec, params, rays, mask, surf_neig_rad, generator=generator,
                    offset_uniform=ray_draws["neig"], precision=sp)
                groups.append((pts2, torch.cat([rays_d, rays_d]), torch.cat([t, t])))
            extra = tuple(torch.cat(parts) for parts in zip(*groups))
        out = render_rays(spec, rspec, params, rays, step, generator=generator,
                          z_uniform=ray_draws["z"], use_importance=use_importance,
                          precision=precision, sampling_precision=sampling_precision,
                          return_upsample=march_reuse, megakernel=megakernel, extra=extra)
        if extra is not None:
            depth_q, surf_grad = fold_split(out["extra_sdf"], out["extra_grad"], n_rays,
                                            need_depth_terms)
        zero = torch.zeros((), device=dev)
        if need_depth_terms:
            if extra is None:
                depth_q = (sdf_observed(spec, params, pts_d, t, precision),
                           sdf_grad_observed(spec, params, pts_d, t, precision))
            sdf_err, angle_err, valid_region = error_on_depth_ratios(*depth_q, pts_d, rays, mask)
        else:
            sdf_err, angle_err, valid_region = zero, zero, torch.ones_like(mask)
        if need_surf:
            if extra is None:
                pts2, valid_surf = surface_neighbour_points(
                    spec, params, rays, mask, surf_neig_rad,
                    samples=(out["up_z"], out["up_sdf"]) if march_reuse else None,
                    n_secant_reuse=march_reuse_secant, generator=generator,
                    offset_uniform=ray_draws["neig"], precision=sp)
                surf_grad = sdf_grad_observed(spec, params, pts2, torch.cat([t, t]), precision)
            surf_err = surface_neighbour_ratio(surf_grad, valid_surf)
        else:
            surf_err = zero
        return endosurf_loss_terms(out, sdf_err, angle_err, valid_region, surf_err,
                                   batch, loss_weights, mesh)
    return loss_fn


def adam_count(optimizer: torch.optim.Optimizer) -> int:
    """Updates the optimizer has taken (0 before the first)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state and "step" in state:
                return int(state["step"])
    return 0


def make_train_step(spec: EndoSurfSpec, rspec: RenderSpec, h: int, w: int, ray_batch: int,
                    loss_weights: Dict[str, float], surf_neig_rad: float,
                    schedule: Optional[Callable[[int], float]] = None, **kwargs):
    """``step_fn(params, optimizer, arrays, generator, step, draws=None) ->
    metrics``: one optimizer step. ``schedule(count)`` sets each group's lr
    (times its ``lr_mult``) before the update; ``kwargs`` go to
    :func:`make_loss_fn`. With ``mesh`` the gradients are summed over the
    ranks (one flat all-reduce) before the update, so every rank takes the
    same step."""
    loss_fn = make_loss_fn(spec, rspec, h, w, ray_batch, loss_weights, surf_neig_rad,
                           **kwargs)
    mesh = kwargs.get("mesh")

    def step_fn(params, optimizer, arrays, generator, step, draws: Draws = None):
        optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn(params, arrays, step, generator, draws)
        total.backward()
        if mesh is not None:
            all_reduce_grads(p for g in optimizer.param_groups for p in g["params"])
        if schedule is not None:
            lr = schedule(adam_count(optimizer))
            for group in optimizer.param_groups:
                group["lr"] = lr * group.get("lr_mult", 1.0)
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}
    return step_fn


def make_optimizer(params: Dict[str, Any], lr: float,
                   deform_lr_mult: float = 1.0) -> torch.optim.Adam:
    """Adam (betas 0.9 / 0.999, eps 1e-8, as optax.adam) over two groups:
    the deform net at ``deform_lr_mult`` times the shared lr, and the rest."""
    flat = flatten(params)
    deform = [v for k, v in flat.items() if k.startswith("deform_network/")]
    rest = [v for k, v in flat.items() if not k.startswith("deform_network/")]
    groups = [{"params": rest, "lr_mult": 1.0}]
    if deform:
        groups.append({"params": deform, "lr_mult": deform_lr_mult})
    return torch.optim.Adam(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)


class EndoSurfTrainer(Trainer):
    def setup(self) -> None:
        cfg, tc = self.cfg, self.train_cfg
        self.spec = EndoSurfSpec.from_config(cfg["net"])
        self.rspec = RenderSpec.from_config(cfg["render"])
        self.precision = tc.get("matmul_precision", "default")
        self.sampling_precision = tc.get("sampling_precision", "default")
        for p in (self.precision, self.sampling_precision):
            if p not in PRECISIONS:
                raise ValueError(f"unknown matmul precision {p!r}")
        self.loss_weights = {k: float(tc.get(k, 0.0)) for k in LOSS_WEIGHT_KEYS}
        self.megakernel = tc.get("megakernel", "auto")
        if self.megakernel not in MEGAKERNEL_MODES:
            raise ValueError(f"unknown train.megakernel {self.megakernel!r}")
        if self.megakernel == "off" and torch.device(self.device).type == "cuda":
            raise NotImplementedError("not yet ported: train.megakernel: off on a CUDA device "
                                      "(the card always runs the field segment kernels)")
        if tc.get("sampler_kernel", "auto") == "off":
            raise NotImplementedError("not yet ported: train.sampler_kernel: off "
                                      "(the upsampling always runs fused_upsample_z)")

        seed = cfg.get("exp", {}).get("seed", 0)
        self.params = init_endosurf_params(self.spec, torch.Generator().manual_seed(seed),
                                           self.device)
        for v in flatten(self.params).values():
            v.requires_grad_(True)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)

        optim_cfg = tc["optim"]
        self.lr_schedule = warmup_cosine(optim_cfg["lr"], optim_cfg.get("warm_up_end", 5000),
                                         self.n_iter, optim_cfg.get("lr_alpha", 0.05))
        self.optimizer = make_optimizer(self.params, self.lr_schedule(0),
                                        float(optim_cfg.get("deform_lr_mult", 1.0)))
        self._step_fns: Dict[bool, Any] = {}

    def _get_step_fn(self, use_importance: bool):
        if use_importance not in self._step_fns:
            tc = self.train_cfg
            self._step_fns[use_importance] = make_train_step(
                self.spec, self.rspec, self.scene.h, self.scene.w,
                tc.get("ray_batch", 1024), self.loss_weights, tc.get("surf_neig_rad", 0.1),
                schedule=self.lr_schedule,
                mask_guided=tc.get("mask_guided_ray_sampling", True),
                use_importance=use_importance,
                fold_aux=tc.get("fold_aux_queries", False),
                march_reuse=tc.get("surf_march_reuse", True),
                march_reuse_secant=tc.get("surf_march_reuse_secant", 0),
                pixel_sampler=tc.get("pixel_sampler", "cdf"),
                precision=self.precision, sampling_precision=self.sampling_precision,
                megakernel=self.megakernel, mesh=self.mesh)
        return self._step_fns[use_importance]

    def restore(self, restored: Dict[str, Any]) -> None:
        self.step_start = int(restored["n_iter"]) + 1
        with torch.no_grad():
            for name, v in flatten(self.params).items():
                v.copy_(flatten(restored["params"])[name])
        self.optimizer.load_state_dict(restored["opt_state"])

    def checkpoint_state(self):
        return self.params, self.optimizer.state_dict()

    def train_step(self, step: int) -> Dict[str, torch.Tensor]:
        use_importance = (self.rspec.n_importance > 0
                          and step >= self.rspec.important_begin_iter)
        return self._get_step_fn(use_importance)(
            self.params, self.optimizer, self.scene.device_arrays, self.generator, step)

    def window_boundaries(self):
        return (self.rspec.important_begin_iter,)

    def render_fn(self, use_importance: bool = True):
        """Chunk renderer for eval (the serving kernel on the GPU)."""
        return make_render_fn(self.spec, self.rspec, self.precision,
                              self.sampling_precision, use_importance)

    def eval(self, step: int) -> Dict[str, float]:
        from endosurf_tpu_torch.evaluation.render_eval import eval_frames
        eval_cfg = self.train_cfg.get("eval", {})
        stats = eval_frames(self, self.scene.list_test[:1], step,
                            ray_chunk=eval_cfg.get("ray_chunk", 2048), save_dir_name="eval")
        if self.writer is not None:
            self.writer.add_scalars("eval", stats, step)
        return stats
