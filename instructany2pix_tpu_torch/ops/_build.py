"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
into `build/kernels/<name>-<hash>.so` at the root of the checkout (a
directory git ignores). The hash covers the source, the `csrc/` headers it
includes (`#include "..."`, also through another header) and the flags, so
an edited source or header is rebuilt and an unchanged one is reused.
Nothing is compiled when a module is imported; `load` compiles on the first
launch and `build` compiles several sources in parallel, one `nvcc` each.
`build_copies` builds patched copies of a source (the planted faults of
chip_smoke.py, the variants of the kernel benchmarks).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def sources(name: str) -> List[Path]:
    """`csrc/<name>.cu` and the `csrc/` headers it includes, directly or
    through another header, each once."""
    out = [CSRC / f"{name}.cu"]
    for path in out:
        for inc in _INCLUDE.findall(path.read_text()):
            if CSRC / inc not in out:
                out.append(CSRC / inc)
    return out


def artifact(name: str) -> Path:
    """Path of the shared library for `csrc/<name>.cu` at its current hash."""
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(src: Path, out: Path) -> List[str]:
    """The nvcc command line that builds `src` into the library `out`;
    `csrc/` is on the include path, so a copy of a source elsewhere still
    finds its headers."""
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)]


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every source not built yet, one `nvcc` per source, all at
    once. The compiler's report (registers, spills) lands beside each
    library as `.log`. Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Path] = {}
    procs: List[Tuple[str, Path, Path, subprocess.Popen]] = []
    for name in names:
        so = artifact(name)
        out[name] = so
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        log = so.with_suffix(".log").open("w")
        try:
            proc = subprocess.Popen(nvcc_command(CSRC / f"{name}.cu", tmp),
                                    stdout=log, stderr=subprocess.STDOUT)
        finally:
            log.close()
        procs.append((name, so, tmp, proc))
    failed = []
    for name, so, tmp, proc in procs:
        if proc.wait() != 0:
            failed.append(f"{name}:\n{so.with_suffix('.log').read_text()}")
            continue
        os.replace(tmp, so)  # atomic: a parallel builder sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def patch(text: str, patches: Iterable[Tuple[str, str]], where: str) -> str:
    """`text` with each (old, new) of `patches` applied in turn; every old
    text must be in it exactly once."""
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"a patch of {where} does not find its text there exactly once")
        text = text.replace(old, new)
    return text


def build_copies(name: str, copies: Dict[str, Dict[str, List[Tuple[str, str]]]],
                 under: Path) -> Dict[str, Tuple[Path, str]]:
    """Build patched copies of `csrc/<name>.cu`, one `nvcc` each, all at
    once. `copies` maps a copy's name to {file in csrc/: [(old, new), ...]}
    (`patch`); copy c is written to under/c/, where the source's
    `#include "..."` finds a patched header first and the others in csrc/.
    Returns {copy: (library path, the compiler's report)}; raises with the
    report of a copy that does not build."""
    texts = {copy: {target: patch((CSRC / target).read_text(), files.get(target, ()),
                                  f"{copy}: {target}") for target in {f"{name}.cu", *files}}
             for copy, files in copies.items()}  # every patch applies before any build
    procs = {}
    for copy, files in texts.items():
        out_dir = Path(under) / copy
        out_dir.mkdir(parents=True, exist_ok=True)
        for target, text in files.items():
            (out_dir / target).write_text(text)
        so = out_dir / f"{name}.so"
        procs[copy] = (so, subprocess.Popen(
            nvcc_command(out_dir / f"{name}.cu", so), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for copy, (so, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} copy {copy}:\n{report}")
        out[copy] = (so, report)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            so = build([name])[name]
            lib = _LOADED[name] = ctypes.CDLL(str(so))
        return lib
