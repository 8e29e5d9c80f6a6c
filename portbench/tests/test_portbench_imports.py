"""Nothing the benchmark runs imports JAX, the JAX package or the JAX-era
benchmark files, compared by whole top-level module name (the port's name
begins with the JAX package's); the reference imports nothing of the
port; a run's last line has the contract's keys."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest
from tinybench import REPO, copy_with_tiny_cells

from portbench import run

PKG = os.path.join(REPO, "portbench")
NEVER = {"jax", "jaxlib", "flax", "instructany2pix_tpu", "benchmarks", "benchmarks_torch", "bench"}
PROGRAM = "instructany2pix_tpu_torch"
JAX_ERA_FILES = ("benchmarks/", "benchmarks_torch", "bench.py", "BENCH_", "BASELINE.",
                 "MULTICHIP_")


def _sources():
    for base, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, PKG))
def test_no_forbidden_import(path):
    names = set(_top_level_imports(path))
    assert not names & NEVER
    if os.sep + "reference" + os.sep in path:
        assert PROGRAM not in names


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, PKG))
def test_no_jax_era_file_is_read(path):
    if os.sep + "tests" + os.sep in path:
        return
    with open(path) as f:
        text = f.read()
    assert not [s for s in JAX_ERA_FILES if s in text]


def test_the_module_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, PROGRAM + "_probe", sys)
    assert run.forbidden_modules() == [] or "instructany2pix_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "instructany2pix_tpu.probe", sys)
    assert "instructany2pix_tpu" in run.forbidden_modules()


CHILD = """
import json, sys, tempfile, torch
sys.path[:0] = [{repo!r}, {tests!r}]
torch.set_num_threads(4)
from portbench import run
with tempfile.TemporaryDirectory() as tmp:
    result = run.run_cell({root!r}, "tiny-single", 2**31 + 3, 1.0, False, "cpu", tmp)
print(json.dumps({{"modules": run.forbidden_modules(), "result": result}}))
"""


@pytest.fixture(scope="module")
def child_run(tmp_path_factory):
    """A tiny run in a process of its own."""
    root = copy_with_tiny_cells(str(tmp_path_factory.mktemp("child") / "checkout"))
    code = CHILD.format(repo=REPO, tests=os.path.dirname(__file__), root=root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax(child_run):
    assert child_run["modules"] == []


def test_the_result_has_the_contract_keys(child_run):
    result = child_run["result"]
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["metrics"]) == {"request_latency_s", "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
