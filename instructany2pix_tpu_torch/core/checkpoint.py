"""Train-state checkpoints: `save` and `restore` of the parameters, the
optimizer state and the step count with `torch.save`, for the launcher's
`--resume`. The JAX package writes Orbax roots instead; those are a JAX
artefact and are not read here.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch


def save(path: str, state: Dict[str, Any]) -> int:
    """Write `state` ({"params": module, "opt_state": {...}, "step": int})
    to `path` atomically (a temporary file, then a rename). Returns the
    file's size in bytes."""
    blob = {"params": state["params"].state_dict(), "opt_state": state["opt_state"],
            "step": int(state["step"])}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return os.path.getsize(path)


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
        return dst
    if isinstance(dst, dict):
        return {k: _copy_into(dst[k], src[k]) for k in dst}
    if isinstance(dst, list):
        if len(dst) != len(src):
            raise ValueError(f"checkpoint: {len(src)} entries where the state has {len(dst)}")
        return [_copy_into(d, s) for d, s in zip(dst, src)]
    return src


@torch.no_grad()
def restore(path: str, like: Dict[str, Any]) -> Dict[str, Any]:
    """Load a `save`d state into `like` (same module and optimizer layout)
    in place, on `like`'s devices; returns `like`."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    like["params"].load_state_dict(blob["params"])
    like["opt_state"] = _copy_into(like["opt_state"], blob["opt_state"])
    like["step"] = int(blob["step"])
    return like
