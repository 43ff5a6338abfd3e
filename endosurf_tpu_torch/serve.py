"""The serving halves of ``endosurf_tpu/train/trainer_endosurf.py`` and
``trainer_endonerf.py``.

A renderer holds a scene, parameters and the static specs, and hands out the
chunk renderer that eval and demo rendering call, and the 3D demo's hooks:
the scalar field for the mesh grid (``demo_field_fn``) and the vertex colours
(``render_points_fn``). ``EndoSurfRenderer`` serves the SDF fields (the grid
on the CUDA ``fused_sdf_observed``, the colours on the field segment
kernels), ``EndoNeRFRenderer`` the D-NeRF density baseline (chunks on
``fused_render_rays_dnerf``, the grid on ``fused_density_raw``, the colours on
the D-NeRF forward segment kernels); ``make_renderer`` picks one by the
config's ``render.type``. Parameters come from an npz written by
``bridge.save_params_npz`` (for example by ``tools/export_params_npz.py``
from a JAX checkpoint) or, without one, from the seeded init.

Under a process group (``parallel``) a renderer has a data mesh: eval and
demo frames, grid slabs and vertex colours are split by rows over the ranks
and gathered on every rank (``parallel.mesh.row_parallel``).
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Any, Dict, Optional, Union

import torch

from endosurf_tpu_torch.config import load_config
from endosurf_tpu_torch.data.scene_data import SceneData
from endosurf_tpu_torch.models import endonerf
from endosurf_tpu_torch.models.endosurf import (
    RenderSpec,
    _sdf_sampling,
    render_rays_inference,
)
from endosurf_tpu_torch.models.fields import (
    MEGAKERNEL_MODES,
    EndoSurfSpec,
    fused_point_eval,
    init_endosurf_params,
)
from endosurf_tpu_torch.ops.mlp import PRECISIONS
from endosurf_tpu_torch.parallel.mesh import make_mesh, row_parallel


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The requested device; a CUDA device without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def make_render_fn(spec: EndoSurfSpec, rspec: RenderSpec, precision: str,
                   sampling_precision: str, use_importance: bool = True):
    """Chunk renderer ``fn(params, rays[R, 9], step) -> maps`` for
    ``evaluation.render_eval`` (the serving kernel on the GPU)."""
    def fn(params, rays, step):
        return render_rays_inference(spec, rspec, params, rays, float(step),
                                     use_importance=use_importance, precision=precision,
                                     sampling_precision=sampling_precision)
    return fn


class _Renderer:
    """What both renderers share: config, device, matmul precisions, scene,
    parameters (the seeded init without given ones), step, exp dir and data
    mesh."""

    render_type = ""
    mesh = None     # the data mesh (parallel.mesh.DataMesh) under a process group

    def __init__(self, cfg: Union[str, Dict[str, Any]], scene: Optional[SceneData] = None,
                 params: Optional[Dict[str, Any]] = None, step: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = load_config(cfg)
        self.device = resolve_device(device)
        self.mesh = make_mesh(self.cfg.get("parallel", {}).get("data_parallel", False),
                              self.device)
        render_type = self.cfg["render"].get("type", "endosurf")
        if render_type != self.render_type:
            raise ValueError(f"{type(self).__name__} serves render type "
                             f"{self.render_type!r}, not {render_type!r}")
        self.setup_specs()
        train_cfg = self.cfg.get("train", {})
        self.precision = train_cfg.get("matmul_precision", "default")
        self.sampling_precision = train_cfg.get("sampling_precision", "default")
        for p in (self.precision, self.sampling_precision):
            if p not in PRECISIONS:
                raise ValueError(f"unknown matmul precision {p!r}")

        if scene is None:
            data_cfg = self.cfg["data"]
            scene = SceneData.load(data_cfg["info_dir"],
                                   normalize_time=data_cfg.get("normalize_time", True),
                                   device=self.device)
        self.scene = scene
        self.params_from_init = params is None
        if params is None:
            seed = self.cfg.get("exp", {}).get("seed", 0)
            params = self.init_params(torch.Generator().manual_seed(seed))
        self.params = params
        self.step = step

        exp_cfg = self.cfg["exp"]
        self.exp_dir = osp.join(
            exp_cfg.get("exp_dir", "logs/"), exp_cfg["project_name"],
            f"{exp_cfg['exp_name']}-{scene.dset_name}-{scene.scene_name}")
        os.makedirs(self.exp_dir, exist_ok=True)

    def setup_specs(self) -> None:
        raise NotImplementedError

    def init_params(self, generator: torch.Generator) -> Dict[str, Any]:
        raise NotImplementedError

    def demo(self, step: Optional[int] = None, test_mode: bool = False,
             visualize: bool = True, demo_2d: bool = True, demo_3d: bool = True):
        """View synthesis (``demo_2d``) and mesh extraction with the
        geometric error (``demo_3d``) of the test split or all frames."""
        from endosurf_tpu_torch.evaluation.demo import run_demo
        return run_demo(self, self.step if step is None else step, test_mode, visualize,
                        demo_2d, demo_3d)


class EndoSurfRenderer(_Renderer):
    render_type = "endosurf"

    def setup_specs(self) -> None:
        self.spec = EndoSurfSpec.from_config(self.cfg["net"])
        self.rspec = RenderSpec.from_config(self.cfg["render"])

    def init_params(self, generator: torch.Generator) -> Dict[str, Any]:
        return init_endosurf_params(self.spec, generator, self.device)

    def render_fn(self, use_importance: bool = True):
        """Chunk renderer ``fn(params, rays[R, 9], step) -> maps``."""
        return make_render_fn(self.spec, self.rspec, self.precision,
                              self.sampling_precision, use_importance)

    def demo_field_fn(self):
        """Scalar field for the isosurface: ``fn(pts [N, 3], t [N, 1]) -> sdf
        [N, 1]``, the observed-space SDF at the main matmul precision."""
        spec, params, precision = self.spec, self.params, self.precision

        def fn(pts, t):
            return _sdf_sampling(spec, params, pts, t, precision)
        return row_parallel(fn, self.mesh)

    def demo_field_threshold(self, thresh: float) -> float:
        return float(thresh)    # SDF: inside where sdf < thresh

    def render_points_fn(self):
        """Vertex colours: ``fn(pts, dirs [N, 3], t [N, 1]) -> colours
        [N, 3]``, numpy in and out, the fields at the main precision."""
        spec, params, precision, device = self.spec, self.params, self.precision, self.device
        colour = row_parallel(
            lambda x, d, tt: fused_point_eval(spec, params, x, d, tt, precision)["color"],
            self.mesh)

        def fn(pts, dirs, t):
            x, d, tt = (torch.as_tensor(a, dtype=torch.float32, device=device)
                        for a in (pts, dirs, t))
            with torch.no_grad():
                return colour(x, d, tt).cpu().numpy()
        return fn


class EndoNeRFRenderer(_Renderer):
    """The serving half of ``trainer_endonerf.py``: depth-guided eval rays
    (``eval_ray_transform``), display normals from the rendered depth
    (``normals_from_depth``), the negated raw density as the isosurface
    field (the reference extracts density > thresh; the mesh code keeps
    value < iso inside)."""

    render_type = "endonerf"
    normals_from_depth = True

    def setup_specs(self) -> None:
        self.spec = endonerf.DNeRFSpec.from_config(self.cfg["net"])
        self.rspec = endonerf.DNeRFRenderSpec.from_config(self.cfg["render"])
        # train.megakernel: the D-NeRF field always runs the segment kernels
        # on the card (their plain versions on the CPU), so "off" on a CUDA
        # device is refused
        megakernel = self.cfg.get("train", {}).get("megakernel", "auto")
        if megakernel not in MEGAKERNEL_MODES:
            raise ValueError(f"unknown megakernel mode {megakernel!r}")
        if self.device.type == "cuda" and megakernel == "off":
            raise NotImplementedError("not yet ported: train.megakernel: off on a CUDA device "
                                      "(the card always runs the D-NeRF segment kernels)")

    def init_params(self, generator: torch.Generator) -> Dict[str, Any]:
        return endonerf.init_dnerf_params(self.spec, generator, self.device)

    def eval_ray_transform(self, rays: torch.Tensor, fid: int) -> torch.Tensor:
        """Write (gt depth, depth_sampling_sigma) into ray slots 6/7 for
        depth-guided sampling."""
        if not self.rspec.use_depth_sampling:
            return rays
        rays = rays.clone()
        rays[:, 6] = self.scene.device_arrays["depths"][fid].reshape(-1)
        rays[:, 7] = self.rspec.depth_sampling_sigma
        return rays

    def render_fn(self, use_importance: bool = True):
        """Chunk renderer ``fn(params, rays[R, 9], step) -> maps`` (step is
        unused: D-NeRF has no annealing)."""
        spec, rspec, precision, sp = (self.spec, self.rspec, self.precision,
                                      self.sampling_precision)

        def fn(params, rays, step):
            return endonerf.render_rays_inference(spec, rspec, params, rays, use_importance,
                                                  precision, sp)
        return fn

    def demo_field_fn(self):
        """``fn(pts [N, 3], t [N, 1]) -> -raw density [N, 1]`` at the main
        matmul precision."""
        spec, params, precision = self.spec, self.params, self.precision

        def fn(pts, t):
            return -endonerf.density_observed(spec, params, pts, t, precision)
        return row_parallel(fn, self.mesh)

    def demo_field_threshold(self, thresh: float) -> float:
        return -float(thresh)

    def render_points_fn(self):
        """Vertex colours: ``fn(pts, dirs [N, 3], t [N, 1]) -> colours
        [N, 3]``, numpy in and out, the radiance field at the main precision."""
        spec, params, precision, device = self.spec, self.params, self.precision, self.device
        colour = row_parallel(
            lambda x, d, tt: endonerf.field_eval(spec, params, x, d, tt, precision=precision)[0],
            self.mesh)

        def fn(pts, dirs, t):
            x, d, tt = (torch.as_tensor(a, dtype=torch.float32, device=device)
                        for a in (pts, dirs, t))
            with torch.no_grad():
                return colour(x, d, tt).cpu().numpy()
        return fn


RENDERERS = {"endosurf": EndoSurfRenderer, "endonerf": EndoNeRFRenderer}


def make_renderer(cfg: Union[str, Dict[str, Any]], **kw) -> _Renderer:
    """The renderer of the config's ``render.type`` (keyword arguments as
    the renderers take them)."""
    cfg = load_config(cfg)
    render_type = cfg["render"].get("type", "endosurf")
    if render_type not in RENDERERS:
        raise ValueError(f"unknown render type {render_type!r}")
    return RENDERERS[render_type](cfg, **kw)
