"""Whether a process's first train step computes other bits than its later
ones, and where, on the card (bf16, base.yml widths).

Each variant runs in a fresh process: the loss and backward of one step of
each family, ``RUNS`` times on the same draws and seed-0 parameters, with the
field calls captured (``probe_dp_rows.Capture``). Every run is held against
the last: per captured tensor the elements that differ, per parameter
gradient the relative L2. The variants:

* ``plain``: as the train step runs;
* ``nocache``: ``PYTORCH_NO_CUDA_MEMORY_CACHING=1``, every tensor its own
  ``cudaMalloc``;
* ``nan``: the caching allocator's free memory filled with NaN before each
  run, so a kernel that reads memory nothing wrote reads NaN;
* ``warm``: the aux queries' plain chain (``sdf_observed`` and
  ``sdf_grad_observed`` with its double backward) run once at other row
  counts before the first run;
* ``backward``: one backward of a two-op graph on the card before the first
  run (the autograd engine's first backward on the device);
* ``gemm``: one float32 matmul on the card, no autograd, before the first
  run (cuBLAS's first use in the process);
* ``nerf-first``: as ``plain``, EndoNeRF's runs before EndoSurf's (each
  family's first run is then the process's first);
* ``seq``: a 4,000-op chain differentiated with ``create_graph`` on the card
  before the first run, which makes its nodes on the autograd engine's
  device thread and so advances that thread's sequence numbers, touching no
  matrix product and none of the model;
* ``ops``: every ATen op of EndoSurf's first and last run recorded (a
  fingerprint of each input's and output's bits), and the ops whose inputs
  are the same bits in both runs and whose outputs are not listed: where
  the first run departs.

    python tools/probe_first_step.py [VARIANT ...]   # on a machine with a CUDA card
"""

from __future__ import annotations

import collections
import difflib
import os
import subprocess
import sys
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as cs  # noqa: E402
from probe_dp_rows import Capture  # noqa: E402

from endosurf_tpu_torch.bridge import flatten  # noqa: E402

RUNS = 3
VARIANTS = ("plain", "nocache", "nan", "warm", "backward", "gemm", "nerf-first", "seq", "ops")
NAMES = {"endosurf": ("fused_point_eval", "sdf_observed", "sdf_grad_observed"),
         "endonerf": ("field_eval",)}


def poison(dev) -> None:
    """Release the caching allocator's free memory (``empty_cache``), then fill
    8 GiB of its large pool and 1 GiB of its small pool with NaN and free
    them, so later tensors are carved from NaN."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    big = torch.full((2 ** 31,), float("nan"), device=dev)
    small = [torch.full((2 ** 18 - 128,), float("nan"), device=dev) for _ in range(1024)]
    torch.cuda.synchronize()
    del big, small


def warm_plain_chain(kind: str, dev) -> None:
    """The aux queries' plain chain at row counts the step does not use."""
    if kind != "endosurf":
        return
    from endosurf_tpu_torch.models.fields import sdf_grad_observed, sdf_observed
    f = cs.train_family(kind, dev)
    params = f["init"]()
    x = torch.rand(300, 3, device=dev) - 0.5
    t = torch.full((300, 1), 0.25, device=dev)
    prec = f["kwargs"]["precision"]
    (sdf_observed(f["spec"], params, x, t, prec).sum()
     + sdf_grad_observed(f["spec"], params, x, t, prec).sum()).backward()
    torch.cuda.synchronize()


class OpRecord(TorchDispatchMode):
    """Each ATen op's name, its tensor inputs' (shape, stride, dtype) and a
    fingerprint of every tensor input's and output's bits."""

    def __init__(self):
        super().__init__()
        self.ops, self.weights, self.main = [], {}, threading.get_ident()

    def fingerprint(self, t: torch.Tensor) -> int:
        if t.numel() == 0 or t.device.type not in ("cpu", "cuda"):
            return 0
        b = t.detach().contiguous().reshape(-1)
        ints = {torch.float32: torch.int32, torch.float64: torch.int64,
                torch.bfloat16: torch.int16, torch.float16: torch.int16}
        b = b.view(ints[b.dtype]) if b.dtype in ints else b.to(torch.int64)
        w = self.weights.get(b.device)
        if w is None or w.numel() < b.numel():
            g = torch.Generator(device=b.device).manual_seed(0)
            w = self.weights[b.device] = torch.randint(1, 2 ** 62, (max(b.numel(), 1 << 20),),
                                                       generator=g, device=b.device)
        return int((b.long() * w[:b.numel()]).sum())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [a for a in args if torch.is_tensor(a)]
        outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,))
                if torch.is_tensor(o)]
        with torch.utils._python_dispatch._disable_current_modes():
            where = "main" if threading.get_ident() == self.main else "other thread"
            self.ops.append((str(func), [(tuple(a.shape), a.stride(), str(a.dtype),
                                          a.device.type, where) for a in ins],
                             [self.fingerprint(a) for a in ins],
                             [self.fingerprint(o) for o in outs]))
        return out


def run_ops(dev) -> None:
    """The ``ops`` variant (EndoSurf)."""
    from endosurf_tpu_torch.data.scene_data import make_synthetic_arrays
    scene = make_synthetic_arrays(n_frames=4, h=cs.H, w=cs.W, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    f = cs.train_family("endosurf", dev)
    n = f["n"]
    draws = {"frame": torch.randint(0, len(scene.list_train), (), generator=gen, device=dev),
             "u_pix": torch.rand(n, generator=gen, device=dev),
             "z": torch.rand(n, 1, generator=gen, device=dev),
             "neig": torch.rand(n, 3, generator=gen, device=dev)}
    records, grads = [], []
    for _ in range(RUNS):
        params = f["init"]()
        loss_fn = f["tr"].make_loss_fn(f["spec"], f["rspec"], cs.H, cs.W, n, *f["args"],
                                       **f["kwargs"])
        with OpRecord() as rec:
            total, _ = loss_fn(params, scene.device_arrays, *f["step_args"], None, draws)
            total.backward()
        torch.cuda.synchronize()
        records.append(rec.ops)
        grads.append({k: v.grad.detach().clone() for k, v in flatten(params).items()})
    first, last = records[0], records[-1]
    # align the two runs' op sequences (run 1 may do work later runs skip)
    keys = [[(op[0], str(op[1])) for op in r] for r in (first, last)]
    match = difflib.SequenceMatcher(None, keys[0], keys[1], autojunk=False)
    pairs, extra = [], []
    for tag, i0, i1, j0, j1 in match.get_opcodes():
        if tag == "equal":
            pairs += list(zip(range(i0, i1), range(j0, j1)))
        else:
            extra += [(i, first[i]) for i in range(i0, i1)]
    origins = [(i, first[i]) for i, j in pairs if first[i][2] == last[j][2]
               and first[i][3] != last[j][3] and "empty" not in first[i][0]]
    differ = sum(first[i][3] != last[j][3] for i, j in pairs)
    print(f"first-step ops endosurf: {len(first)} ops in run 1, {len(last)} in run {RUNS}, "
          f"{len(pairs)} aligned; {len(extra)} of run 1's not in run {RUNS}: "
          f"{collections.Counter(op[0] for _, op in extra).most_common(8)}; "
          f"{differ} aligned ops' outputs differ, {len(origins)} on inputs of the same bits",
          flush=True)
    for tag, i0, i1, j0, j1 in match.get_opcodes():
        if tag == "equal":
            continue
        def brief(ops):
            return ", ".join(f"{op[0].replace('aten.', '')}{[m[:1] + m[3:] for m in op[1]]}"
                             for op in ops[:4])
        print(f"first-step ops block {tag}: run 1 #{i0}-{i1} [{brief(first[i0:i1])}] | run "
              f"{RUNS} #{j0}-{j1} [{brief(last[j0:j1])}]", flush=True)
    for i, (name, meta, _, _) in origins[:12]:
        print(f"first-step ops origin #{i}: {name} inputs {meta}", flush=True)
    nets = sorted({k.split("/")[0] for k in grads[0] if not torch.equal(grads[0][k], grads[-1][k])})
    print(f"first-step ops endosurf gradients differing in nets {nets}", flush=True)


def run(kind: str, variant: str, dev) -> None:
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
        draws.update(z=torch.rand(n, 1, generator=gen, device=dev),
                     neig=torch.rand(n, 3, generator=gen, device=dev))
    else:
        modules = (endonerf,)
        draws = endonerf.train_draws(f["spec"], f["rspec"], n, gen, draws, dev)
    if variant == "warm":
        warm_plain_chain(kind, dev)
    elif variant == "backward":
        a = torch.ones(4, device=dev, requires_grad=True)
        (a * 2.0).sum().backward()
    elif variant == "gemm":
        torch.randn(96, 64, device=dev) @ torch.randn(64, 32, device=dev)
    elif variant == "seq":
        a = torch.ones(4, device=dev, requires_grad=True)
        y = a
        for _ in range(4000):
            y = y * 1.0
        torch.autograd.grad(y.sum(), a, create_graph=True)
    torch.cuda.synchronize()
    runs = []
    for _ in range(RUNS):
        if variant == "nan":
            poison(dev)
        params = f["init"]()
        flat = flatten(params)
        loss_fn = f["tr"].make_loss_fn(f["spec"], f["rspec"], cs.H, cs.W, n, *f["args"],
                                       **f["kwargs"])
        with Capture(modules, NAMES[kind]) as cap:
            total, metrics = loss_fn(params, scene.device_arrays, *f["step_args"], None, draws)
            total.backward()
        torch.cuda.synchronize()
        runs.append(({k: v.grad.detach().clone() for k, v in flat.items()}, cap.saved,
                     {k: float(v.detach()) for k, v in metrics.items()}))
    last_g, last_s, last_m = runs[-1]
    for i, (g, saved, m) in enumerate(runs[:-1]):
        diffs = []
        for rec, ref in zip(saved, last_s):
            for what in ("in", "out", "grad"):
                for j, (a, b) in enumerate(zip(rec[what], ref[what])):
                    if a is None or b is None:
                        continue
                    nan = int(torch.isnan(a).sum())
                    d = (a.double() - b.double()).abs().nan_to_num(float("inf"))
                    if nan or bool((d > 0).any()):
                        diffs.append(f"{rec['name']} {what}[{j}] {tuple(a.shape)} "
                                     f"{int((d > 0).sum())} differ (largest {float(d.max()):.3e}"
                                     f", {nan} NaN)")
        leaves = {k: float((g[k] - last_g[k]).double().norm()
                           / last_g[k].double().norm().clamp_min(1e-30)) for k in g}
        bad = {k: v for k, v in leaves.items() if v != 0}
        nets = sorted({k.split("/")[0] for k in bad})
        worst = max(leaves.items(), key=lambda kv: kv[1])
        m_diff = [k for k in m if m[k] != last_m[k]]
        seq = "; ".join(f"{rec['name']} {rec['seq'][0]}" for rec in saved)
        seq_last = "; ".join(f"{rec['name']} {rec['seq'][0]}" for rec in last_s)
        print(f"first-step {variant} {kind} run {i + 1} against run {RUNS}: "
              f"{len(saved)} captured calls; "
              + ("; ".join(diffs) if diffs else "captured tensors all equal")
              + f"; gradient leaves differing {len(bad)} of {len(leaves)} (nets {nets}), "
              f"worst {worst[0]} {worst[1]:.3e}; metrics differing {m_diff}; outputs' autograd sequence "
              f"numbers: run {i + 1} {seq}; run {RUNS} {seq_last}", flush=True)


def child(variant: str) -> int:
    from endosurf_tpu_torch.kernels import build
    build.load_library()
    if variant == "ops":
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
        run_ops(torch.device("cuda", 0))
        return 0
    kinds = ("endonerf", "endosurf") if variant == "nerf-first" else ("endosurf", "endonerf")
    for kind in kinds:
        run(kind, variant, torch.device("cuda", 0))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_first_step: CUDA is not available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--variant"]:
        return child(sys.argv[2])
    from endosurf_tpu_torch.kernels import build
    build.build_library()
    rc = 0
    for variant in sys.argv[1:] or VARIANTS:
        env = dict(os.environ)
        if variant == "nocache":
            env["PYTORCH_NO_CUDA_MEMORY_CACHING"] = "1"
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--variant", variant],
                           env=env, timeout=600)
        rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
