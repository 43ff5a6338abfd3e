"""Registers and spills of every kernel, this tree's against another
checkout's, from ptxas' ``-v`` lines (``kernels/build.py`` keeps them beside
the library as ``<name>.log``).

    python tools/ptxas_compare.py [OTHER_ROOT] [--out FILE]

Builds the kernel library of this tree and of OTHER_ROOT (default ``_ab/
parent``: a checkout of the parent commit, e.g. unpacked with ``git archive``)
in parallel, then prints one line per kernel: registers, stack frame and
spill bytes in OTHER_ROOT and here, and a mark where this tree uses more
registers or spills more. A kernel is named by its demangled name and its
occurrence in the log (each .cu keeps its own copy of the shared kernels,
and the anonymous namespace's mangled token differs between checkouts).
Exits 1 if a kernel present in both uses more registers or spills more here,
or if a build fails. Needs nvcc (the card machine).
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ("from endosurf_tpu_torch.kernels.build import build_library; "
         "print(build_library().with_suffix('.log'))")


def build(root: Path) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", BUILD], cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def parse(log: str) -> list:
    """[(mangled name, {"regs", "stack", "spill_st", "spill_ld"})] in log order."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"regs": None, "stack": 0, "spill_st": 0, "spill_ld": 0}
            out.append((m.group(1), cur))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(stack=int(m.group(1)), spill_st=int(m.group(2)), spill_ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["regs"] = int(m.group(1))
    return out


def keyed(entries: list) -> dict:
    """{(demangled name, occurrence): figures}: the anonymous namespace's
    mangled token differs between checkouts, the demangled name does not."""
    names = demangle(sorted({n for n, _ in entries}))
    out, seen = {}, {}
    for n, figs in entries:
        name = names[n]
        seen[name] = seen.get(name, 0) + 1
        out[(name, seen[name])] = figs
    return out


def demangle(names):
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if not tool:
        return {n: n for n in names}
    res = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    return dict(zip(names, res.stdout.splitlines()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?", default=str(ROOT / "_ab" / "parent"))
    ap.add_argument("--out", default=None, help="write the table as JSON lines here too")
    args = ap.parse_args()
    procs = {"other": build(Path(args.other)), "this": build(ROOT)}
    logs = {}
    for key, proc in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"build of {key} failed:\n{text[-6000:]}")
            return 1
        logs[key] = keyed(parse(Path(text.strip().splitlines()[-1]).read_text()))
    keys = sorted(set(logs["other"]) | set(logs["this"]))
    worse, rows = 0, []
    for k in keys:
        a, b = logs["other"].get(k), logs["this"].get(k)
        mark = ""
        if a and b:
            if b["regs"] > a["regs"] or b["spill_st"] > a["spill_st"] \
                    or b["spill_ld"] > a["spill_ld"]:
                mark, worse = "WORSE", worse + 1
            elif b != a:
                mark = "changed"
        else:
            mark = "only here" if b else "only there"
        fmt = lambda r: ("-" if r is None else            # noqa: E731
                         f"{r['regs']}r {r['stack']}st {r['spill_st']}/{r['spill_ld']}sp")
        short = re.sub(r"\(.*", "", k[0].replace("(anonymous namespace)::", ""))[:90]
        print(f"{short} #{k[1]}: {fmt(a)} -> {fmt(b)} {mark}")
        rows.append({"kernel": k[0], "occurrence": k[1], "other": a, "this": b,
                     "mark": mark})
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    print(f"{len(keys)} kernels, {worse} with more registers or spills here")
    return 1 if worse else 0


if __name__ == "__main__":
    sys.exit(main())
