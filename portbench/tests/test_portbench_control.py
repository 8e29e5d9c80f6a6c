"""The control (the reference in float8 put in the program's place) comes
out not correct. On the CPU at tiny sizes against the tiny cells' limit;
with the card, at a cell's own size against that cell's limits, as
PERF.md records (run: `python3 -m pytest portbench/tests -m cuda`)."""

from __future__ import annotations

import json
import os

import pytest
from tinybench import REPO, TINY_CELLS

from portbench import control, correct


def test_control_fails_the_tiny_limit(tiny_root):
    worst = control.readings(tiny_root, "tiny-single", 2**31 + 5, "cpu", 1)
    within, checks = correct.judge(worst, TINY_CELLS["tiny-single"]["limits"])
    assert not within, checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["edit-serve-b4", "edit-single"])
def test_control_fails_the_cell_limit(cuda, cell):
    with open(os.path.join(REPO, "portbench", "workloads", f"{cell}.json")) as f:
        limits = json.load(f)["limits"]
    worst = control.readings(REPO, cell, 2**31 + 41, "cuda", 1)
    within, checks = correct.judge(worst, limits)
    assert not within, checks
