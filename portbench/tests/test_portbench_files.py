"""A cell, a configuration and a per-layer metric are added by new files
and new entries of BENCHMARK.json alone: the harness finds them by name."""

from __future__ import annotations

import json
import os

from tinybench import REPO, digests, run_tiny

NEW_METRIC = '''"""Microbatches in the traced window (a test metric)."""


def read(rec):
    return len(rec["units"]) or None
'''


def test_new_cell_configuration_and_metric_come_from_new_files(tiny_root):
    with open(os.path.join(tiny_root, "portbench", "metrics", "units_traced.serve.py"), "w") as f:
        f.write(NEW_METRIC)
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "units_traced.serve", "unit": "count", "better": "higher",
                               "source": "program_span", "layer": "serving.py",
                               "moves": "served_requests_per_s", "workloads": ["tiny-serve"]})
    with open(path, "w") as f:
        json.dump(bench, f)

    result = run_tiny(tiny_root, "tiny-serve", trace_on=True)
    assert result["correct"], result["checks"]
    assert result["metrics"]["units_traced.serve"]["value"] >= 1
    assert {"between_batches_ms.serve", "unet_step_ms.serve", "mfu.serve"} <= set(result["metrics"])

    # every file the benchmark had is unchanged; its manifest only gained entries
    original, copy = digests(REPO), digests(tiny_root)
    assert all(copy[p] == d for p, d in original.items())
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        old = json.load(f)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[key]]
        assert names[:len(old[key])] == [e["name"] for e in old[key]]
