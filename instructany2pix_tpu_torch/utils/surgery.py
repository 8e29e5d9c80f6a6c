"""Model surgery: weight deltas and consolidation, counterpart of the JAX
package's `utils/surgery.py` (reference llm/model/make_delta.py,
apply_delta.py, consolidate.py).

A finetune is distributed as its difference from the base. Both sides are
state dicts ({name: tensor}); a tensor the base lacks is kept as it is. The
LLM's embedding and `lm_head` grow by the 9 added special tokens
(reference make_delta.py:19-28): where the row counts differ, the rows the
base has are subtracted (added back) and the new rows are kept verbatim.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from ..core import checkpoint as ckpt_lib

CONSOLIDATED = "pytorch_model.bin"


def _delta_leaf(finetuned: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    if finetuned.shape == base.shape:
        return finetuned - base
    if finetuned.dim() != base.dim() or finetuned.shape[1:] != base.shape[1:]:
        raise ValueError(f"shapes {tuple(finetuned.shape)} and {tuple(base.shape)} differ beyond "
                         "the row count")
    out = finetuned.clone()
    n = min(finetuned.shape[0], base.shape[0])
    out[:n] -= base[:n]
    return out


def _apply_leaf(delta: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    if delta.shape == base.shape:
        return delta + base
    if delta.dim() != base.dim() or delta.shape[1:] != base.shape[1:]:
        raise ValueError(f"shapes {tuple(delta.shape)} and {tuple(base.shape)} differ beyond "
                         "the row count")
    out = delta.clone()
    n = min(delta.shape[0], base.shape[0])
    out[:n] += base[:n]
    return out


@torch.no_grad()
def make_delta(finetuned: Dict[str, torch.Tensor],
               base: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """finetuned − base, tensor by tensor (resized rows kept verbatim)."""
    return {k: _delta_leaf(v, base[k]) if k in base else v.clone() for k, v in finetuned.items()}


@torch.no_grad()
def apply_delta(delta: Dict[str, torch.Tensor],
                base: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """delta + base, tensor by tensor: the inverse of `make_delta`."""
    return {k: _apply_leaf(v, base[k]) if k in base else v.clone() for k, v in delta.items()}


def consolidate(src_path: str, dst_path: str) -> str:
    """Re-save a sharded checkpoint directory (every shard that
    `core.checkpoint.shard_files` lists) as one `pytorch_model.bin` under
    `dst_path`, which the port's loaders read as a one-shard directory.
    Returns the file written."""
    sd = ckpt_lib.load_sharded(src_path)
    os.makedirs(dst_path, exist_ok=True)
    out = os.path.join(dst_path, CONSOLIDATED)
    tmp = f"{out}.{os.getpid()}.tmp"
    torch.save({k: v.contiguous() for k, v in sd.items()}, tmp)
    os.replace(tmp, out)
    return out
