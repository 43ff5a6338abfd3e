"""EndoNeRF trainer (port of ``endosurf_tpu/train/trainer_endonerf.py``).

One train step: draw a batch (a train frame and mask-guided pixels), write
(batch depth, ``depth_sampling_sigma``) into ray slots 6/7 under depth-guided
sampling, render it with ``models.endonerf.render_rays_train`` (the coarse
density on ``fused_density_raw``, the deterministic importance draws on
``fused_fine_resample`` and the fine field's forward and backward on the
D-NeRF segment kernels on the card), take the masked MSE colour and masked
Huber depth losses, backpropagate and take one Adam step at the exponential
learning rate.

Port notes:
- ``"default"`` precision rounds every dot operand to bf16 and accumulates
  and stores in float32 (the JAX megakernel's semantics); JAX's
  ``activation_dtype`` is not read.
- ``train.megakernel: off`` and ``train.sampler_kernel: off`` on a CUDA
  device are not ported and raise (the card always runs the kernels).
  ``steps_per_call`` and ``presample_batches`` only change JAX's dispatch
  (the same draws by construction) and have nothing to port, as for
  EndoSurf. ``pixel_sampler: alias`` draws pixels from Walker/Vose tables.
- ``parallel.data_parallel`` (and any process group of more than one rank)
  runs the step data-parallel (``parallel.mesh``), as EndoSurf's: the global
  batch and draws on every rank, this rank's rows rendered, the global
  masked means, the gradients summed over the ranks before Adam.
- Every random draw comes from one ``torch.Generator`` on the device
  (seeded from ``exp.seed``) or is passed in (``draws``), in this order:
  ``frame`` and the pixel draws (the batch), then the render's ``z``,
  ``noise_c``, ``u_pdf`` and ``noise_f`` (``models.endonerf.train_draws``),
  all drawn for the global batch.
- Eval, test and demo rendering, and the 3D hooks, are
  ``serve.EndoNeRFRenderer``'s: the trainer is one.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from endosurf_tpu_torch.bridge import flatten
from endosurf_tpu_torch.data.scene_data import sample_train_batch
from endosurf_tpu_torch.models.endonerf import render_rays_train, train_draws
from endosurf_tpu_torch.ops.mlp import PRECISIONS
from endosurf_tpu_torch.parallel.mesh import DataMesh, all_reduce_grads
from endosurf_tpu_torch.serve import EndoNeRFRenderer
from endosurf_tpu_torch.train.losses import endonerf_loss_terms
from endosurf_tpu_torch.train.schedules import exponential
from endosurf_tpu_torch.train.trainer import Trainer
from endosurf_tpu_torch.train.trainer_endosurf import adam_count

LOSS_WEIGHT_KEYS = ("color_loss_weight", "depth_loss_weight")

Draws = Optional[Dict[str, torch.Tensor]]


def shard_draws(draws: Dict[str, torch.Tensor], mesh: DataMesh,
                n_rays: int) -> Dict[str, torch.Tensor]:
    """This rank's rows of the global batch's draws: a draw of n_rays * m
    values (ray-major, as the render's flat noise) keeps the m of each of its
    rays; 0-d draws stay whole."""
    return {k: mesh.rows(v.reshape(n_rays, -1)).reshape((-1,) + tuple(v.shape[1:]))
            if v.ndim else v for k, v in draws.items()}


def make_loss_fn(spec, rspec, h: int, w: int, ray_batch: int, loss_weights: Dict[str, float],
                 mask_guided: bool = True, pixel_sampler: str = "cdf",
                 precision: str = "highest", sampling_precision: Optional[str] = None,
                 mesh: Optional[DataMesh] = None):
    """``loss_fn(params, arrays, generator=None, draws=None) -> (total,
    metrics)``: batch, ray slots 6/7, the train render and the two losses.
    With ``mesh`` the batch and draws are global, the render runs on this
    rank's rows, ``total`` is this rank's share of the global loss and the
    metrics are global."""
    def loss_fn(params, arrays, generator: Optional[torch.Generator] = None,
                draws: Draws = None):
        draws = draws or {}
        batch = sample_train_batch(arrays, h, w, ray_batch, mask_guided, pixel_sampler,
                                   generator, draws.get("frame"), draws.get("u_pix"),
                                   draws.get("j_pix"))
        draws = train_draws(spec, rspec, ray_batch, generator, draws, batch["rays"].device)
        if mesh is not None:
            batch, draws = mesh.shard(batch), shard_draws(draws, mesh, ray_batch)
        rays = batch["rays"]
        if rspec.use_depth_sampling:
            rays = torch.cat([rays[:, :6], batch["depth"],
                              torch.full_like(rays[:, 7:8], rspec.depth_sampling_sigma),
                              rays[:, 8:9]], dim=-1)
        out = render_rays_train(spec, rspec, params, rays, precision, sampling_precision,
                                generator, draws)
        return endonerf_loss_terms(out, batch, loss_weights, mesh)
    return loss_fn


def make_train_step(spec, rspec, h: int, w: int, ray_batch: int, loss_weights: Dict[str, float],
                    schedule: Optional[Callable[[int], float]] = None, **kwargs):
    """``step_fn(params, optimizer, arrays, generator, draws=None) ->
    metrics``: one optimizer step, the lr set from ``schedule(count)`` before
    the update; ``kwargs`` go to :func:`make_loss_fn`. With ``mesh`` the
    gradients are summed over the ranks before the update."""
    loss_fn = make_loss_fn(spec, rspec, h, w, ray_batch, loss_weights, **kwargs)
    mesh = kwargs.get("mesh")

    def step_fn(params, optimizer, arrays, generator, draws: Draws = None):
        optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn(params, arrays, generator, draws)
        total.backward()
        if mesh is not None:
            all_reduce_grads(p for g in optimizer.param_groups for p in g["params"])
        apply_update(optimizer, schedule)
        return {k: v.detach() for k, v in metrics.items()}
    return step_fn


def apply_update(optimizer: torch.optim.Optimizer,
                 schedule: Optional[Callable[[int], float]] = None) -> None:
    """One optimizer step on the parameters' ``.grad``, the lr set from
    ``schedule(count)`` first (count: the updates taken so far)."""
    if schedule is not None:
        for group in optimizer.param_groups:
            group["lr"] = schedule(adam_count(optimizer))
    optimizer.step()


def make_optimizer(params: Dict[str, Any], lr: float) -> torch.optim.Adam:
    """One Adam over every parameter (betas 0.9 / 0.999, eps 1e-8, as
    optax.adam)."""
    return torch.optim.Adam(list(flatten(params).values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)


class EndoNeRFTrainer(Trainer, EndoNeRFRenderer):
    """``Trainer``'s loop over the EndoNeRF step; ``EndoNeRFRenderer``'s
    specs, init, eval rays, chunk renderer and demo hooks."""

    def setup(self) -> None:
        cfg, tc = self.cfg, self.train_cfg
        self.setup_specs()      # spec, rspec; megakernel: off refused on CUDA
        self.precision = tc.get("matmul_precision", "default")
        self.sampling_precision = tc.get("sampling_precision", "default")
        for p in (self.precision, self.sampling_precision):
            if p not in PRECISIONS:
                raise ValueError(f"unknown matmul precision {p!r}")
        if tc.get("sampler_kernel", "auto") == "off" and self.device.type == "cuda":
            raise NotImplementedError("not yet ported: train.sampler_kernel: off on a CUDA "
                                      "device (the resample always runs fused_fine_resample)")

        seed = cfg.get("exp", {}).get("seed", 0)
        self.params = self.init_params(torch.Generator().manual_seed(seed))
        for v in flatten(self.params).values():
            v.requires_grad_(True)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        optim_cfg = tc["optim"]
        self.lr_schedule = exponential(optim_cfg["lr"], optim_cfg.get("lr_decay", 250))
        self.optimizer = make_optimizer(self.params, self.lr_schedule(0))
        self.loss_weights = {k: float(tc.get(k, 1.0)) for k in LOSS_WEIGHT_KEYS}
        self._step_fn = make_train_step(
            self.spec, self.rspec, self.scene.h, self.scene.w, tc.get("ray_batch", 2048),
            self.loss_weights, schedule=self.lr_schedule,
            mask_guided=tc.get("mask_guided_ray_sampling", True),
            pixel_sampler=tc.get("pixel_sampler", "cdf"), precision=self.precision,
            sampling_precision=self.sampling_precision, mesh=self.mesh)

    def restore(self, restored: Dict[str, Any]) -> None:
        self.step_start = int(restored["n_iter"]) + 1
        with torch.no_grad():
            for name, v in flatten(self.params).items():
                v.copy_(flatten(restored["params"])[name])
        self.optimizer.load_state_dict(restored["opt_state"])

    def checkpoint_state(self):
        return self.params, self.optimizer.state_dict()

    def train_step(self, step: int) -> Dict[str, torch.Tensor]:
        return self._step_fn(self.params, self.optimizer, self.scene.device_arrays,
                             self.generator)

    def eval(self, step: int) -> Dict[str, float]:
        """Render every test frame in chunks of ``train.eval.ray_batch`` (the
        reference's EndoNeRF eval; EndoSurf's renders one frame)."""
        from endosurf_tpu_torch.evaluation.render_eval import eval_frames
        stats = eval_frames(self, self.scene.list_test, step,
                            ray_chunk=self.train_cfg.get("eval", {}).get("ray_batch", 2048),
                            save_dir_name="eval")
        if self.writer is not None:
            self.writer.add_scalars("eval", stats, step)
        return stats
