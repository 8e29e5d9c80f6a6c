"""Weights from the JAX package's parameter trees into the port's modules.

The port's modules carry the JAX trees' key names, so a tree maps onto a
module key for key. Per leaf:
  * linear `w` is stored input-major (in, out) and becomes (out, in);
  * conv `w` is stored HWIO and becomes OIHW;
  * norm `g`/`b` become `weight`/`bias`, embedding `w` becomes `weight`;
  * free arrays (IP-Adapter's `raw_embed`) copy as they are.
Fused projections a tree may carry are split back first: `to_qkv`
(q|k|v along the output axis) and `to_kv` (k|v), and `ff_in_a`/`ff_in_g`
re-join into `ff_in` (value half, then gate half). Loading is strict:
a tree key without a counterpart, a shape mismatch or a module parameter
the tree leaves unset raises.

Trees may hold numpy arrays or anything `numpy.asarray` accepts.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .diffusion import ip_adapter as ipa
from .models import clip as clip_lib
from .models import layers as L
from .models import unet as unet_lib
from .models import vae as vae_lib


def unfuse(tree: Any) -> Any:
    """Split `to_qkv`/`to_kv` and re-join `ff_in_a`/`ff_in_g`."""
    if not isinstance(tree, dict):
        return tree
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if k == "to_qkv":
            w = np.asarray(v["w"])
            for name, part in zip(("to_q", "to_k", "to_v"), np.split(w, 3, axis=1)):
                out[name] = {"w": part}
        elif k == "to_kv":
            w = np.asarray(v["w"])
            for name, part in zip(("to_k", "to_v"), np.split(w, 2, axis=1)):
                out[name] = {"w": part}
        elif k in ("ff_in_a", "ff_in_g"):
            continue
        else:
            out[k] = unfuse(v)
    if "ff_in_a" in tree:
        a, g = tree["ff_in_a"], tree["ff_in_g"]
        ff = {"w": np.concatenate([np.asarray(a["w"]), np.asarray(g["w"])], axis=1)}
        if "b" in a:
            ff["b"] = np.concatenate([np.asarray(a["b"]), np.asarray(g["b"])])
        out["ff_in"] = ff
    return out


def _put(param: torch.Tensor, arr, name: str, seen: set) -> None:
    t = torch.from_numpy(np.array(arr, dtype=np.float32))
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"{name}: tree shape {tuple(t.shape)} != module shape {tuple(param.shape)}")
    param.copy_(t)
    seen.add(id(param))


def _leaf_keys(node: dict, allowed: set, name: str) -> None:
    extra = set(node) - allowed
    if extra:
        raise KeyError(f"{name}: leaves {sorted(extra)} have no counterpart")


def _load(module: nn.Module, tree: dict, path: str, seen: set) -> None:
    for key, val in tree.items():
        name = f"{path}{key}"
        child = getattr(module, key, None)
        if isinstance(child, nn.Parameter):
            _put(child, val, name, seen)
        elif isinstance(child, nn.Linear):
            _leaf_keys(val, {"w", "b"}, name)
            _put(child.weight, np.asarray(val["w"]).T, name + ".w", seen)
            if "b" in val:
                _put(child.bias, val["b"], name + ".b", seen)
        elif isinstance(child, nn.Conv2d):
            _leaf_keys(val, {"w", "b"}, name)
            _put(child.weight, np.asarray(val["w"]).transpose(3, 2, 0, 1), name + ".w", seen)
            if "b" in val:
                _put(child.bias, val["b"], name + ".b", seen)
        elif isinstance(child, (nn.LayerNorm, nn.GroupNorm)):
            _leaf_keys(val, {"g", "b"}, name)
            _put(child.weight, val["g"], name + ".g", seen)
            _put(child.bias, val["b"], name + ".b", seen)
        elif isinstance(child, nn.Embedding):
            _leaf_keys(val, {"w"}, name)
            _put(child.weight, val["w"], name + ".w", seen)
        elif isinstance(child, nn.Module) and isinstance(val, dict):
            _load(child, val, name + ".", seen)
        else:
            raise KeyError(f"{name} has no counterpart in {type(module).__name__}")


@torch.no_grad()
def load_tree(module: nn.Module, tree: dict) -> nn.Module:
    """Copy a JAX parameter tree into `module` in place (strict)."""
    seen: set = set()
    _load(module, unfuse(tree), "", seen)
    missing = [n for n, p in module.named_parameters() if id(p) not in seen]
    if missing:
        raise KeyError(f"tree leaves {len(missing)} parameters unset, e.g. {missing[:5]}")
    return module


def build(module_on_meta: nn.Module, tree: dict, device="cpu", dtype=torch.float32) -> nn.Module:
    """Allocate a meta-built module on `device` in `dtype` and load `tree`."""
    m = L.materialize(module_on_meta, torch.device(device), dtype)
    return load_tree(m, tree).eval().requires_grad_(False)


def _meta(cls, cfg):
    with torch.device("meta"):
        return cls(cfg)


def unet(tree, cfg: unet_lib.UNetConfig, device="cpu", dtype=torch.float32) -> unet_lib.UNet:
    return build(_meta(unet_lib.UNet, cfg), tree, device, dtype)


def vae(tree, cfg: vae_lib.VAEConfig, device="cpu", dtype=torch.float32) -> vae_lib.VAE:
    return build(_meta(vae_lib.VAE, cfg), tree, device, dtype)


def clip_text(tree, cfg: clip_lib.CLIPTextConfig, device="cpu", dtype=torch.float32) -> clip_lib.CLIPText:
    return build(_meta(clip_lib.CLIPText, cfg), tree, device, dtype)


def image_proj(tree, cfg: ipa.ImageProjConfig, device="cpu", dtype=torch.float32) -> ipa.ImageProj:
    return build(_meta(ipa.ImageProj, cfg), tree, device, dtype)


def to_numpy(tree: Any) -> Any:
    """Nested dict of arrays (JAX or numpy) → nested dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def pipeline_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The slice's components of a JAX pipeline's `params`, as numpy."""
    return {n: to_numpy(params[n]) for n in ("unet", "vae", "text1", "text2", "image_proj")}
