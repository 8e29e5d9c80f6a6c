"""LoRA finetuning: attach, train, merge and save low-rank adapters;
counterpart of the JAX package's `train/lora.py`.

Adapters live on the linears themselves (`models/layers.add_lora`:
`lora_a`, `lora_b`, `lora_scale` beside the base `weight`), and
`layers.linear` applies them wherever the linear runs, so every model and
every loader's key map keeps working on a model that carries them.

Module paths and parameter names are the JAX tree's (`llama.layer_3.q`,
`vae_predictor_image.fc1.weight`), so the JAX regexes select the same
linears and heads. As in the JAX package, `^lm_head\\.` does not match the
LLM's `llama.lm_head`: over an `Any2PixLM` only the two predictor heads are
trained in full.

Adapters attach to the unfused projections (`q/k/v/o/gate/up/down`), so
`merge_lora` runs before `llama.fuse_projections` and before quantization;
`fuse_projections` refuses a layer that still carries them.

On disk the adapters take the layout of the reference's training
(LLaVA-style, reference train.py:917-927): PEFT's `adapter_config.json`
(`r`, `lora_alpha`), `adapter_model.bin` with
`base_model.model.model.layers.{i}.self_attn.q_proj.lora_A.weight` /
`lora_B.weight` and `non_lora_trainables.bin` with the fully trained heads
under `base_model.model.` + their HF keys. `keymap` holds both halves, read
both ways: `save_lora_checkpoint` writes what `read_lora_checkpoint` reads.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core import checkpoint as ckpt_lib
from ..core.checkpoint import KeyMap, Rule
from ..models import layers as L

# every llama linear, like the reference's find_all_linear_names
DEFAULT_TARGETS = (r"layer_\d+\.(q|k|v|o|gate|up|down)$",)
# heads trained in full alongside the adapters
DEFAULT_FULL_TRAIN = (
    r"^vae_predictor_image\.",
    r"^vae_predictor_audio\.",
    r"^lm_head\.",
)
ADAPTER_CONFIG = "adapter_config.json"
ADAPTER_FILES = ("adapter_model.safetensors", "adapter_model.bin")
NON_LORA = "non_lora_trainables.bin"
_HF_PROJ = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
            "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
            "down": "mlp.down_proj"}


def _linears(module: nn.Module):
    return [(n, m) for n, m in module.named_modules() if isinstance(m, nn.Linear)]


def apply_lora(module: nn.Module, generator: Optional[torch.Generator] = None, rank: int = 8,
               alpha: float = 16.0, targets: Sequence[str] = DEFAULT_TARGETS) -> nn.Module:
    """Attach adapters (`lora_b` zero, so the forward is unchanged) to
    every float linear whose path matches one of `targets`, in place.
    Returns `module`."""
    for path, lin in _linears(module):
        if any(re.search(t, path) for t in targets):
            L.add_lora(lin, rank, alpha, generator)
    return module


def trainable_mask(module: nn.Module, targets: Sequence[str] = DEFAULT_TARGETS,
                   full_train: Sequence[str] = DEFAULT_FULL_TRAIN) -> Dict[str, bool]:
    """Set `requires_grad` on exactly the adapter factors and the parameters
    of the heads matched by `full_train`; every other parameter is frozen.
    Returns {parameter name: trainable}, the JAX mask's leaves. `targets`
    is kept for the JAX signature: adapters are found by name."""
    del targets
    mask = {}
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        on = leaf in ("lora_a", "lora_b") or any(re.search(t, name) for t in full_train)
        p.requires_grad_(on)
        mask[name] = on
    return mask


@torch.no_grad()
def merge_lora(module: nn.Module) -> nn.Module:
    """Fold every linear's adapters into its base weight, W + (B @ A) ·
    scale in the weight's dtype, and detach them, in place. A quantized base
    carrying adapters raises: quantize after merging. Returns `module`."""
    for name, m in module.named_modules():
        if not L.has_lora(m):
            continue
        if not isinstance(m, nn.Linear):
            raise ValueError(f"{name}: adapters over a {type(m).__name__} cannot be merged; "
                             "merge before quantizing")
        w = m.weight
        m.weight.copy_(w + (m.lora_b.to(w.dtype) @ m.lora_a.to(w.dtype)) * m.lora_scale.to(w.dtype))
        L.remove_lora(m)
    return module


def split_lora_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The adapter tensors only (`lora_a`, `lora_b`, `lora_scale`) under
    their state-dict names: the LoRA-split checkpoint of reference
    train.py:917-927."""
    return {k: v for k, v in module.state_dict().items() if "lora" in k.rsplit(".", 1)[-1]}


# ------------------------------------------------------------ checkpoints


def keymap() -> KeyMap:
    """The reference's LoRA files ↔ an `Any2PixLM` carrying adapters: PEFT's
    adapter keys (A is (r, in) and B (out, r), the port's layout) and the
    fully trained heads under `base_model.model.` + their HF keys."""
    from ..llm import multimodal as mm_lib

    lay = "base_model.model.model.layers.{i}"
    rules = []
    for port, hf in _HF_PROJ.items():
        rules.append(Rule(f"{lay}.{hf}.lora_A.weight", f"llama.layer_{{i}}.{port}.lora_a"))
        rules.append(Rule(f"{lay}.{hf}.lora_B.weight", f"llama.layer_{{i}}.{port}.lora_b"))
    return KeyMap(rules) + mm_lib.keymap().prefixed(ref="base_model.model.")


@torch.no_grad()
def save_lora_checkpoint(module: nn.Module, path: str,
                         full_train: Sequence[str] = DEFAULT_FULL_TRAIN) -> Dict[str, int]:
    """Write an `Any2PixLM`'s adapters and its fully trained heads in the
    reference's layout under directory `path`. Every adapter must share one
    rank and one scale. Returns the tensor count of each file."""
    adapters = {k: v for k, v in split_lora_state(module).items() if not k.endswith("lora_scale")}
    if not adapters:
        raise ValueError("the module carries no adapters")
    ranks = {v.shape[0] for k, v in adapters.items() if k.endswith("lora_a")}
    scales = {float(v) for k, v in split_lora_state(module).items() if k.endswith("lora_scale")}
    if len(ranks) != 1 or len(scales) != 1:
        raise ValueError(f"adapters of ranks {sorted(ranks)} and scales {sorted(scales)}: "
                         "one of each is written")
    (r,), (scale,) = ranks, scales
    heads = {n: p for n, p in module.named_parameters()
             if any(re.search(t, n) for t in full_train)}
    km = keymap()
    os.makedirs(path, exist_ok=True)
    cfg = {"peft_type": "LORA", "task_type": "CAUSAL_LM", "r": int(r), "lora_alpha": scale * r,
           "target_modules": sorted({h.rsplit(".", 1)[-1] for h in _HF_PROJ.values()})}
    with open(os.path.join(path, ADAPTER_CONFIG), "w") as f:
        json.dump(cfg, f, indent=1)
    files = {ADAPTER_FILES[1]: adapters, NON_LORA: heads}
    for name, tensors in files.items():
        ref = km.to_ref({k: v.detach().cpu().contiguous() for k, v in tensors.items()},
                        what=name)
        torch.save(ref, os.path.join(path, name))
    return {name: len(t) for name, t in files.items()}


def read_lora_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor],
                                             float]:
    """(adapters, heads, lora_alpha / r) of a LoRA directory, as port
    tensors: adapters under `llama.layer_{i}.{proj}.lora_a|b`, heads
    (`non_lora_trainables.bin`, optional) under their parameter names. A
    missing config or adapter file raises `FileNotFoundError`; an unknown
    key raises `KeyError`, as does an adapter file that names no adapter."""
    cfg_path = os.path.join(path, ADAPTER_CONFIG)
    if not os.path.isfile(cfg_path):
        raise FileNotFoundError(f"no {ADAPTER_CONFIG} under {path}")
    with open(cfg_path) as f:
        cfg = json.load(f)
    scale = float(cfg["lora_alpha"]) / float(cfg["r"])
    files = [os.path.join(path, n) for n in ADAPTER_FILES if os.path.isfile(os.path.join(path, n))]
    if not files:
        raise FileNotFoundError(f"no {' or '.join(ADAPTER_FILES)} under {path}")
    km = keymap()
    adapters = km.to_port(ckpt_lib.load_torch_state_dict(files[0]), what=files[0])
    stray = [n for n in adapters if not n.endswith(("lora_a", "lora_b"))]
    if stray or not adapters:
        raise KeyError(f"{files[0]}: {stray[:4] or 'no adapters'}; only adapter factors belong "
                       "in the adapter file")
    heads: Dict[str, torch.Tensor] = {}
    if os.path.isfile(os.path.join(path, NON_LORA)):
        heads = km.to_port(ckpt_lib.load_torch_state_dict(os.path.join(path, NON_LORA)),
                           what=os.path.join(path, NON_LORA))
    return adapters, heads, scale


@torch.no_grad()
def load_adapters(module: nn.Module, adapters: Dict[str, torch.Tensor], scale: float) -> nn.Module:
    """Attach adapters given as {`<linear>.lora_a|b`: tensor} to `module`'s
    linears and fill them, in place. Each linear must get both factors, of
    matching rank; a name with no linear raises. Returns `module`."""
    linears = dict(module.named_modules())
    pairs: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, t in adapters.items():
        owner, _, leaf = name.rpartition(".")
        pairs.setdefault(owner, {})[leaf] = t
    for owner, pair in pairs.items():
        lin = linears.get(owner)
        if not isinstance(lin, nn.Linear):
            raise KeyError(f"{owner}: no float linear to attach adapters to")
        if set(pair) != {"lora_a", "lora_b"}:
            raise KeyError(f"{owner}: adapters need lora_a and lora_b, got {sorted(pair)}")
        a, b = pair["lora_a"], pair["lora_b"]
        if a.shape != (a.shape[0], lin.in_features) or b.shape != (lin.out_features, a.shape[0]):
            raise ValueError(f"{owner}: adapters {tuple(a.shape)} and {tuple(b.shape)} do not fit "
                             f"a ({lin.out_features}, {lin.in_features}) weight")
        L.add_lora(lin, rank=a.shape[0], alpha=scale * a.shape[0])
        lin.lora_a.copy_(a)
        lin.lora_b.copy_(b)
        lin.lora_scale.fill_(scale)
    return module
