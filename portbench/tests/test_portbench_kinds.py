"""A configuration of a new kind is added by new files alone: the kind
(`kinds/<kind>.py`), its configuration, a cell on the `single` driver and a
metric. The toy kind runs one program module, the CLIP text tower of
`instructany2pix_tpu_torch.models.clip`, against `reference/clip.py`. The
frame of `correct` stays the harness's: a number of the cell's limits
that the kind's readings leave out counts as inf, and neither a kind's own
`check` nor limits it rewrites decide the run."""

from __future__ import annotations

import json
import math
import os

import pytest
from tinybench import REPO, digests, run_tiny

TOY_KIND = '''"""A toy kind: the program's CLIP text tower against the reference's."""

import dataclasses
import types

import torch

from portbench import weights
from portbench.reference import clip as ref_clip

FILE = "text_encoder"


def cfgs(cfg_json):
    return {"tower": ref_clip.CLIPTextConfig(**cfg_json["tower"]), "dtype": torch.float32}


def _table(c):
    km = ref_clip.text_keymap()
    return {"tower": (lambda: ref_clip.CLIPText(c["tower"]),
                      lambda named: {FILE: km.to_ref(named)})}


@dataclasses.dataclass
class Request:
    index: int
    ids: torch.Tensor
    eos: int


class Traffic:
    def __init__(self, seed, cfg, tokens):
        self.seed, self.cfg, self.tokens = seed, cfg, tokens

    def request(self, i):
        gen = torch.Generator().manual_seed((self.seed * 1_000_003 + i) % 2**63)
        ids = torch.randint(0, self.cfg.eos_token_id, (1, self.tokens), generator=gen)
        eos = int(torch.randint(1, self.tokens, (1,), generator=gen))
        ids[0, eos] = self.cfg.eos_token_id
        return Request(i, ids, eos)


def traffic(run):
    return Traffic(run.seed, run.cfgs["tower"], run.wl["tokens"])


def build(run):
    from instructany2pix_tpu_torch import loaders
    from instructany2pix_tpu_torch.models import clip

    cfg = clip.CLIPTextConfig(**run.cfg_json["tower"])
    files = weights.draw("tower", run.cfgs, run.seed, run.device, torch.float32,
                         _table(run.cfgs))
    tensors = clip.text_keymap().to_port(files[FILE], what=FILE)
    tower = loaders.build(lambda: clip.CLIPText(cfg), tensors, run.device, torch.float32, FILE)
    run.pipe = types.SimpleNamespace(tower=tower, cfg=cfg, stage_times={})


def single_call(run, req, steps, refinement):
    from instructany2pix_tpu_torch.models import clip

    out = clip.text_apply(run.pipe.tower, req.ids.to(run.device), run.pipe.cfg)
    return {"last": out["last_hidden_state"], "pooled": out["pooled"]}


def unit_flops(run, unit):
    c = run.cfgs["tower"]
    per_token = c.num_layers * (4 * c.hidden_size ** 2 + 2 * c.hidden_size * c.intermediate_size)
    return 2.0 * per_token * run.wl["tokens"] * unit["rows"]


def sample_key(req):
    return req.eos


def trail(outs):
    return {"last": outs["last"].float().cpu(), "pooled": outs["pooled"].float().cpu()}


def readings(run, chosen):
    tower = weights.reference_module("tower", run.cfgs, run.seed, run.device, _table(run.cfgs),
                                     {"tower": [(FILE, ref_clip.text_keymap(), "")]})
    worst = {}
    for req, got in chosen:
        out = ref_clip.text_apply(tower, req.ids, run.cfgs["tower"])
        for key, want in (("last", out["last_hidden_state"]), ("pooled", out["pooled"])):
            gap = float((got[key] - want).abs().max() / want.abs().max())
            worst[key] = max(worst.get(key, 0.0), gap)
    return worst
'''

# the toy kind with its readings cut short, trying to judge itself
PARTIAL_KIND = TOY_KIND + '''

_all_readings = readings


def readings(run, chosen):
    run.wl["limits"] = {}
    return {k: v for k, v in _all_readings(run, chosen).items() if k != "pooled"}


def check(run, outcome):
    return True, {}
'''

TOWER = {"vocab_size": 300, "hidden_size": 32, "intermediate_size": 64, "num_layers": 2,
         "num_heads": 4, "max_positions": 16, "hidden_act": "gelu", "projection_dim": None,
         "eos_token_id": 299}
CELL = {"config": "toytext", "driver": "single", "tokens": 16, "steps": 1, "refinement": 0.0,
        "warmup_steps": 1, "prefill": 8, "compare": 4, "limits": {"last": 1e-4, "pooled": 1e-4}}
METRIC = '''"""Requests answered in the traced window (a test metric)."""


def read(rec):
    return len(rec["units"]) or None
'''


def _add_toy(root, kind_source):
    """The toy configuration, its kind, a cell and a metric: new files and
    new entries of BENCHMARK.json."""
    pb = os.path.join(root, "portbench")
    files = {os.path.join("kinds", "toytext.py"): kind_source,
             os.path.join("configs", "toytext.json"):
                 json.dumps({"name": "toytext", "kind": "toytext", "tower": TOWER}),
             os.path.join("workloads", "toy-single.json"): json.dumps(CELL),
             os.path.join("metrics", "requests_traced.toy.py"): METRIC}
    for rel, text in files.items():
        with open(os.path.join(pb, rel), "w") as f:
            f.write(text)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toytext", "source": "portbench/tests", "reduced": [],
                             "file": "portbench/configs/toytext.json", "why": "CPU tests"})
    bench["workloads"].append({"name": "toy-single", "config": "toytext",
                               "traffic": "toy-single", "chips": 1, "why": "tests"})
    bench["per_layer"].append({"name": "requests_traced.toy", "unit": "count",
                               "better": "higher", "source": "program_span", "layer": "toy",
                               "moves": "request_latency_s", "workloads": ["toy-single"]})
    with open(path, "w") as f:
        json.dump(bench, f)


def _scaled_tower(mp):
    """The program's tower returns its output scaled by 1.01."""
    from instructany2pix_tpu_torch.models import clip

    real = clip.text_apply

    def text_apply(*a, **kw):
        out = dict(real(*a, **kw))
        out["last_hidden_state"] = out["last_hidden_state"] * 1.01
        out["pooled"] = out["pooled"] * 1.01
        return out

    mp.setattr(clip, "text_apply", text_apply)


def test_a_new_kind_comes_from_new_files(tiny_root):
    _add_toy(tiny_root, TOY_KIND)
    result = run_tiny(tiny_root, "toy-single", trace_on=True, seconds=0.2)
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == {"last", "pooled"}
    assert result["metrics"]["requests_traced.toy"]["value"] >= 2
    assert result["attempted"] >= 2 and result["failed"] == 0
    original, copy = digests(REPO), digests(tiny_root)
    assert all(copy[p] == d for p, d in original.items())


def test_a_fault_in_the_new_kinds_program_is_not_correct(tiny_root, monkeypatch):
    _add_toy(tiny_root, TOY_KIND)
    _scaled_tower(monkeypatch)
    result = run_tiny(tiny_root, "toy-single", seconds=0.2)
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["last"]["value"] > result["checks"]["last"]["limit"]


def test_the_frame_judges_every_limit_and_no_kind_judges_itself(tiny_root):
    _add_toy(tiny_root, PARTIAL_KIND)
    result = run_tiny(tiny_root, "toy-single", seconds=0.2)
    assert result["correct"] is False
    assert set(result["checks"]) == {"last", "pooled"}
    assert math.isinf(result["checks"]["pooled"]["value"])
    assert result["checks"]["last"]["value"] <= result["checks"]["last"]["limit"]


@pytest.mark.parametrize("order", [("tower",), ("sam", "tower")])
def test_a_new_kinds_modules_share_no_generator_with_the_edits(order):
    from portbench import weights

    edit = {weights._seed(2**31 + 7, m) for m in weights.MODULE_ORDER}
    own = [weights._seed(2**31 + 7, m, order) for m in order]
    assert not edit & set(own) and len(set(own)) == len(order)
    assert weights._seed(2**31 + 7, order[-1], order) == weights._seed(
        2**31 + 7, "tower", ("tower",)) + (len(order) - 1) * 7919
