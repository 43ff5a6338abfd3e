"""Where a two-rank train step's per-point values part from one process's,
on the card (bf16, base.yml widths).

One process runs each family's loss twice on the same global draws: whole,
and as two ranks in turn on an emulated two-rank mesh (each rank's rows, the
counts and sums of both ranks added as the all-reduce would add them, the
two ranks' gradients summed). It compares, rank rows against the whole
batch's rows, the inputs and outputs of the field evaluations (EndoSurf:
``fused_point_eval`` and the aux queries' ``sdf_observed`` /
``sdf_grad_observed``; EndoNeRF: the fine ``field_eval``) and the
cotangents that reach them, then the parameter gradients (per-leaf relative
L2), and counts the gradient leaves that hold only bf16 values (a gradient
rounded to bf16 on each rank separately differs from one rounded once). A
value that differs although its inputs do not is where the row count
enters.

    python tools/probe_dp_rows.py          # on a machine with a CUDA card
"""

from __future__ import annotations

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from endosurf_tpu_torch.bridge import flatten  # noqa: E402
from endosurf_tpu_torch.parallel.mesh import shard_ray_batch, shard_rows  # noqa: E402


class EmulatedMesh:
    """One rank of a two-rank mesh in one process: ``sum_`` records this
    rank's vector, or, once ``total`` is set, returns the ranks' sum."""

    def __init__(self, rank: int, world: int = 2):
        self.rank, self.world = rank, world
        self.seen, self.total = None, None

    def shard(self, batch):
        return shard_ray_batch(batch, self.rank, self.world)

    def rows(self, x):
        return shard_rows(x, self.rank, self.world)

    def sum_(self, t):
        if self.total is None:
            self.seen = t.clone()
        else:
            t.copy_(self.total)
        return t


class Capture:
    """Wraps functions where ``modules`` name them: keeps each call's tensor
    inputs and outputs and the gradients that reach the outputs. A call from
    a wrapped function to another is kept once, the outer one."""

    def __init__(self, modules, names):
        self.modules, self.names, self.saved, self.orig = modules, names, [], []
        self.depth = 0

    def __enter__(self):
        for module in self.modules:
            for name in self.names:
                if hasattr(module, name):
                    fn = getattr(module, name)
                    self.orig.append((module, name, fn))
                    setattr(module, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.orig:
            setattr(module, name, fn)

    def _wrap(self, name, fn):
        def wrapped(*args, **kw):
            self.depth += 1
            try:
                out = fn(*args, **kw)
            finally:
                self.depth -= 1
            if self.depth:
                return out
            rec = {"name": name, "in": [a.detach().clone() for a in args
                                        if torch.is_tensor(a) and a.ndim == 2]}
            outs = out.values() if isinstance(out, dict) else (
                out if isinstance(out, tuple) else (out,))
            rec["out"] = [o.detach().clone() for o in outs if torch.is_tensor(o)]
            rec["seq"] = [o.grad_fn._sequence_nr() if o.grad_fn is not None else None
                          for o in outs if torch.is_tensor(o)]
            rec["grad"] = [None] * len(rec["out"])
            for i, o in enumerate(o for o in outs if torch.is_tensor(o)):
                if o.requires_grad:
                    o.register_hook(lambda g, i=i, rec=rec: rec["grad"].__setitem__(
                        i, g.detach().clone()))
            self.saved.append(rec)
            return out
        return wrapped


def run(kind: str, dev) -> None:
    from endosurf_tpu_torch.data.scene_data import make_synthetic_arrays
    from endosurf_tpu_torch.models import endonerf, endosurf, fields
    from endosurf_tpu_torch.train import trainer_endosurf
    scene = make_synthetic_arrays(n_frames=4, h=cs.H, w=cs.W, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    f = cs.train_family(kind, dev)
    n = f["n"]
    draws = {"frame": torch.randint(0, len(scene.list_train), (), generator=gen, device=dev),
             "u_pix": torch.rand(n, generator=gen, device=dev)}
    if kind == "endosurf":
        modules = (endosurf, fields, trainer_endosurf)
        names = ("fused_point_eval", "sdf_observed", "sdf_grad_observed")
        draws.update(z=torch.rand(n, 1, generator=gen, device=dev),
                     neig=torch.rand(n, 3, generator=gen, device=dev))
    else:
        modules, names = (endonerf,), ("field_eval",)
        draws = endonerf.train_draws(f["spec"], f["rspec"], n, gen, draws, dev)

    def make(mesh):
        return f["tr"].make_loss_fn(f["spec"], f["rspec"], cs.H, cs.W, n, *f["args"],
                                    mesh=mesh, **f["kwargs"])

    def call(fn, p):
        return fn(p, scene.device_arrays, *f["step_args"], None, draws)
    init = f["init"]

    def loss_grads(mesh, capture=True):
        params = init()
        flat = flatten(params)
        with Capture(modules, names if capture else ()) as cap:
            total, _ = call(make(mesh), params)
            total.backward()
        return {k: v.grad.detach() for k, v in flat.items()}, cap.saved

    loss_grads(None, capture=False)          # settles autograd's order (probe_first_step.py)
    whole, saved_whole = loss_grads(None)
    meshes = [EmulatedMesh(r) for r in range(2)]
    for m in meshes:                         # record each rank's counts and sums
        call(make(m), init())
    total = meshes[0].seen + meshes[1].seen
    parts, saved = [], []
    for m in meshes:
        m.total = total
        g, s = loss_grads(m)
        parts.append(g)
        saved.append(s)
    print(f"{kind}: {len(saved_whole)} captured calls a step "
          f"({', '.join(r['name'] for r in saved_whole)})", flush=True)
    for i, rec in enumerate(saved_whole):
        for what in ("in", "out", "grad"):
            for j, ref in enumerate(rec[what]):
                got = [s[i][what][j] for s in saved]
                if ref is None or any(g is None for g in got):
                    continue
                rows = ref.shape[0]
                if rows % n:
                    continue
                k = rows // n
                if rec["name"] in ("fused_point_eval", "field_eval"):   # ray-major rows
                    cat = torch.cat([g.reshape(-1, k, *g.shape[1:]) for g in got])
                else:                           # k blocks of n rows (surface, then neighbours)
                    cat = torch.cat([torch.cat([g.reshape(k, -1, *g.shape[1:])[b] for g in got])
                                     for b in range(k)])
                cat = cat.reshape(ref.shape)
                diff = (cat.double() - ref.double()).abs()
                print(f"{kind} call {i} {rec['name']} {what}[{j}] {tuple(ref.shape)}: "
                      f"{int((diff > 0).sum())} elements differ, largest {float(diff.max()):.3e} "
                      f"(|ref| max {float(ref.abs().max()):.3e})", flush=True)
    exact = [k for k, v in whole.items() if torch.equal(v, v.to(torch.bfloat16).float())]
    print(f"{kind}: {len(exact)} of {len(whole)} gradient leaves hold only bf16 values "
          f"({', '.join(exact[:6])}{', ...' if len(exact) > 6 else ''})", flush=True)
    rel = {k: float((parts[0][k] + parts[1][k] - whole[k]).double().norm()
                    / whole[k].double().norm().clamp_min(1e-30)) for k in whole}
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:4]
    print(f"{kind} parameter gradients, emulated two ranks against one process: worst leaves "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_dp_rows: CUDA is not available", file=sys.stderr)
        return 2
    from endosurf_tpu_torch.kernels import build
    build.load_library()
    for kind in ("endosurf", "endonerf"):
        run(kind, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
