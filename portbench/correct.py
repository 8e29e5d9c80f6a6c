"""What decides `correct`: once the window has closed and the program's
state is freed, a sample of the answered requests, drawn from the seed
with the first of them chosen by the configuration kind's key (for the
edit, the longest caption), is judged by the float32 reference (TF32 off)
from the same inputs.

This frame is common to every kind and no kind replaces it. A kind
(`portbench/kinds/<kind>.py`) supplies only `sample_key`, `trail`, an
answer as its reference reads it, and `readings`, the worst value of each
number its reference compares. Each number of the workload file's
"limits", as the file held them when the run began, is judged against its
limit, a number the kind did not read counting as inf and one it read
that no limit names not counting; a run is correct only where every
number is within its limit, no request failed, at least one was compared
and the readings left TF32 off. The limits and the readings they were set from
are in PERF.md.
"""

from __future__ import annotations

import gc
import random
import sys
from typing import Callable, Dict, List, Mapping, Tuple

import torch


def sample(answered: List[Tuple], seed: int, k: int, key: Callable) -> List[Tuple]:
    """`k` answered requests drawn from the seed, first the one whose
    request has the largest `key` (the earliest of equals)."""
    if not answered:
        return []
    first = max(range(len(answered)), key=lambda i: (key(answered[i][0]), -i))
    rest = [i for i in range(len(answered)) if i != first]
    picked = [first] + random.Random(int(seed)).sample(rest, min(k - 1, len(rest)))
    return [answered[i] for i in picked]


def judge(worst: Mapping[str, float],
          limits: Mapping[str, float]) -> Tuple[bool, Dict[str, Dict]]:
    """(within every limit, {number: {"value", "limit"}}); a number that was
    not read counts as inf."""
    checks = {key: {"value": float(worst.get(key, float("inf"))), "limit": lim}
              for key, lim in sorted(limits.items())}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def free_cuda():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(run, outcome) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {number: {"value", "limit"}}) for the run; the limits are
    those the workload file held when the run began (`run.limits`)."""
    kind = run.kind
    chosen = [(req, kind.trail(outs))
              for req, outs in sample(outcome["answered"], run.seed, run.wl["compare"],
                                      kind.sample_key)]
    outcome["answered"] = None
    for unit in outcome["units"]:
        unit.pop("steps", None)
    run.free_program()
    free_cuda()
    if torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    worst = dict(kind.readings(run, chosen))
    free_cuda()
    within, checks = judge(worst, run.limits)
    if torch.cuda.is_available() and (torch.backends.cuda.matmul.allow_tf32
                                      or torch.backends.cudnn.allow_tf32):
        print("portbench: the kind's readings switched TF32 back on", file=sys.stderr)
        within = False
    return bool(chosen) and outcome["failed"] == 0 and within, checks
