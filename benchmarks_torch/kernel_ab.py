"""The harness of the kernel benchmarks (`k1_ab.py`, `k4_ab.py`) on the card:
a kernel of this tree against another commit, and patched copies of it.

`in_turns` builds a library in both trees at once, then runs the calling
script's `--child TREE ROWS` in four processes in turn, parent, this tree,
this tree, parent: each imports its own tree's port and chip_smoke.py
(`child_module`) and times the same rows on the same seeds. `device_host`
splits a small call's eager time into the card's and the host's.
`build_copies` builds patched copies of this tree's source, and `loaded`
puts one in place of the tree's library for the calls made inside it.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def child_module(tree):
    """chip_smoke.py of `tree`, imported with `tree` first on the path (so
    that its port is the one imported), with float32 and bf16 matmuls at
    full precision."""
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    import chip_smoke as cs

    return cs


def in_turns(script, lib, parent, rows):
    """Build csrc/<lib>.cu in `parent` and this tree at once, then run
    `script --child TREE ROWS` for parent, change, change, parent; returns
    the four results (the last line each child prints), each with its
    "name"."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", "from instructany2pix_tpu_torch.ops import _build; "
                               f"_build.build([{lib!r}])"], cwd=tree) for tree in (parent, ROOT)]
    if any(p.wait() for p in procs):
        raise SystemExit(f"{Path(script).name}: a build failed")
    runs = []
    for name, tree in (("parent", parent), ("change", ROOT), ("change", ROOT),
                       ("parent", parent)):
        r = subprocess.run([sys.executable, str(script), "--child", str(tree), json.dumps(rows)],
                           capture_output=True, text=True, cwd=tree)
        if r.returncode:
            raise SystemExit(f"{Path(script).name}: the {name} run failed:\n"
                             f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
        res = json.loads(r.stdout.strip().splitlines()[-1])
        res["name"] = name
        runs.append(res)
        print(f"{name}: {len(res['rows'])} rows, failures {res['failures']}", flush=True)
    return runs


def device_host(cs, fn, calls=200):
    """(device ms per call of `fn` from a CUDA graph of its calls
    (`cs.graph_ms`), or None where capture fails; the host's ms to issue one
    call, from the wall time of `calls` calls with no sync between them).
    `cs` is a tree's chip_smoke.py."""
    import torch

    try:
        dev = cs.graph_ms([fn])
    except RuntimeError as e:
        print(f"graph capture failed: {e}", file=sys.stderr)
        dev = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return dev, host


def build_copies(lib, copies, kernel):
    """Build each patched copy of csrc/<lib>.cu (`_build.build_copies`)
    under build/<lib>_copies/; returns ({copy: library path}, {copy: the
    compiler's registers and spills for the functions named `kernel`})."""
    sys.path.insert(0, str(ROOT))
    from instructany2pix_tpu_torch.ops import _build

    built = _build.build_copies(lib, copies, _build.BUILD_DIR.parent / f"{lib}_copies")
    libs, ptxas = {}, {}
    for name, (so, report) in built.items():
        lines = report.splitlines()
        libs[name] = so
        ptxas[name] = [" ".join(x.strip() for x in lines[i + 1:i + 3])
                       for i, line in enumerate(lines)
                       if "Function properties" in line and kernel in line]
        print(f"ptxas {name}: " + " | ".join(ptxas[name]), flush=True)
    return libs, ptxas


@contextlib.contextmanager
def loaded(lib, so):
    """The library `so` in place of csrc/<lib>.cu's for the calls inside."""
    from instructany2pix_tpu_torch.ops import _build

    _build._LOADED[lib] = ctypes.CDLL(str(so))
    try:
        yield
    finally:
        _build._LOADED.pop(lib, None)


def finish(result, out, failures):
    """Write `result` to `out` (if given), print it as the last line, and
    return the exit code: 1 if any row failed its check."""
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 1 if failures else 0
