"""The edit, now behind `kinds/edit.py`, reads what it read when its code
sat in `run.py`, `correct.py` and `weights.py`: each module's generator
seed, the model FLOPs of a unit, and on one seed the tiny cells' checks.
The pinned values were read from the harness before the kinds existed, on
the CPU with four threads and a window of 0 s (one lone edit, one served
microbatch of two)."""

from __future__ import annotations

import os
import tempfile

import pytest
from tinybench import REPO, run_tiny

from portbench import run, weights

SEED = 2**31 + 7
SEEDS = {"unet": 2147490097450966, "image_proj": 2147490097458885,
         "refiner": 2147490097466804, "vae": 2147490097474723, "text1": 2147490097482642,
         "text2": 2147490097490561, "prior_text": 2147490097498480, "prior": 2147490097506399}
UNIT_FLOPS = {
    ("edit-single", 1): 897985271930880.0, ("edit-single", 2): 1795714426580992.0,
    ("edit-serve-b4", 3): 2693443581231104.0, ("edit-serve-b4", 4): 3591172735881216.0,
    ("tiny-single", 1): 14233968640.0, ("tiny-serve", 2): 28465574912.0,
}
CHECKS = {
    "tiny-single": (1, {"decode": 0.0, "encode": 8.266564325133219e-07, "steps": 0.0}),
    "tiny-serve": (2, {"decode": 0.0, "encode": 9.729059555856366e-07,
                       "steps": 2.76583359850904e-06}),
}


def test_the_edit_modules_keep_their_seeds():
    assert {m: weights._seed(SEED, m) for m in weights.MODULE_ORDER} == SEEDS
    assert {m: weights._seed(SEED, m, ("sam",) + weights.MODULE_ORDER)
            for m in weights.MODULE_ORDER} == SEEDS


@pytest.mark.parametrize("cell,rows", sorted(UNIT_FLOPS))
def test_the_edit_keeps_its_model_flops(tiny_root, cell, rows):
    root = tiny_root if cell.startswith("tiny") else REPO
    with tempfile.TemporaryDirectory() as tmp:
        r = run.Run(root, cell, SEED, 0.0, False, "cpu", tmp)
        assert r.kind.unit_flops(r, {"rows": rows}) == UNIT_FLOPS[cell, rows]
    assert os.path.basename(r.kind.__file__) == "edit.py"


@pytest.mark.parametrize("cell", sorted(CHECKS))
def test_the_tiny_cells_keep_their_checks(tiny_root, cell):
    result = run_tiny(tiny_root, cell, seed=SEED, seconds=0.0)
    attempted, values = CHECKS[cell]
    assert result["attempted"] == attempted
    assert {k: c["value"] for k, c in result["checks"].items()} == values
