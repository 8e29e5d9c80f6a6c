"""Weights from the JAX package's parameter trees into the port's modules.

The port's modules carry the JAX trees' key names, so a tree maps onto a
module key for key. Per leaf:
  * linear `w` is stored input-major (in, out) and becomes (out, in);
  * conv `w` is stored HWIO and becomes OIHW;
  * norm `g`/`b` become `weight`/`bias`, embedding `w` becomes `weight`;
  * free arrays (IP-Adapter's `raw_embed`, ViT tokens) copy as they are;
  * weight-only quantized linears (`w_q`/`w_q4` with `scale`/`gscale`)
    become `QLinear`s holding the same bytes and float32 scales.
Fused projections a tree may carry are split back first: `to_qkv`
(q|k|v along the output axis) and `to_kv` (k|v), and `ff_in_a`/`ff_in_g`
re-join into `ff_in` (value half, then gate half). Loading is strict:
a tree key without a counterpart, a shape mismatch or a module parameter
the tree leaves unset raises.

Trees may hold numpy arrays or anything `numpy.asarray` accepts. Built
modules are frozen for inference (`eval`, no gradients), except the
trainer's `llm(..., trainable=True)`; `to_tree`
maps a float module back to a numpy tree in the JAX layout, to compare
parameters after training steps.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .diffusion import ip_adapter as ipa
from .grounding import bert as bert_lib
from .grounding import gdino as gdino_lib
from .grounding import sam as sam_lib
from .grounding import swin as swin_lib
from .llm import multimodal as mm_lib
from .models import clip as clip_lib
from .models import imagebind as imagebind_lib
from .models import layers as L
from .models import llama as llama_lib
from .models import unet as unet_lib
from .models import vae as vae_lib
from .ops import quant as Q
from .prior import model as prior_lib


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
        if isinstance(child, Q.QLinear):
            _leaf_keys(val, set(child.q), name)
            for k, buf in child.q.items():
                arr = np.asarray(val[k])
                if tuple(arr.shape) != tuple(buf.shape):
                    raise ValueError(f"{name}.{k}: tree shape {arr.shape} != {tuple(buf.shape)}")
                buf.copy_(torch.from_numpy(np.array(arr)).to(buf.dtype))
        elif isinstance(child, nn.Parameter):
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


def prior(tree, cfg: prior_lib.PriorConfig, device="cpu", dtype=torch.float32) -> prior_lib.Prior:
    """`output_proj` follows the tree (a checkpoint may carry one at any width)."""
    with torch.device("meta"):
        m = prior_lib.Prior(cfg, output_proj="output_proj" in tree)
    return build(m, tree, device, dtype)


def imagebind(tree, cfg: imagebind_lib.ViTConfig, device="cpu", dtype=torch.float32) -> imagebind_lib.ViT:
    """The token count, `bias_k`/`bias_v`, the audio stem's LayerNorm and
    the pre-trunk LayerNorm follow the tree."""
    with torch.device("meta"):
        m = imagebind_lib.ViT(
            cfg, num_patches=np.shape(tree["pos_embed"])[1] - 1,
            bias_kv="bias_k" in tree.get("block_0", {}), patch_norm="patch_norm" in tree,
            pre_ln="pre_ln" in tree,
        )
    return build(m, tree, device, dtype)


_QKEYS = ("w_q", "w_q4")


def sam(tree, cfg: sam_lib.SAMConfig, device="cpu", dtype=torch.float32) -> sam_lib.SAM:
    """SAM from the JAX `sam` tree (encoder, prompt, decoder); the
    transposed convs keep the JAX layout."""
    return build(_meta(sam_lib.SAM, cfg), tree, device, dtype)


def swin(tree, cfg: swin_lib.SwinConfig, device="cpu", dtype=torch.float32) -> swin_lib.Swin:
    return build(_meta(swin_lib.Swin, cfg), tree, device, dtype)


def bert(tree, cfg: bert_lib.BertConfig, device="cpu", dtype=torch.float32) -> bert_lib.Bert:
    return build(_meta(bert_lib.Bert, cfg), tree, device, dtype)


def gdino(tree, cfg: gdino_lib.GDinoConfig, device="cpu", dtype=torch.float32) -> gdino_lib.GDino:
    """GroundingDINO (with its Swin and BERT towers) from the JAX tree."""
    return build(_meta(gdino_lib.GDino, cfg), tree, device, dtype)


def _qlinear_empty(node: dict, device, dtype) -> Q.QLinear:
    """A QLinear with buffers shaped like a quantized tree node (int8
    bytes, float32 scales, the bias in `dtype`), to be filled by `_load`."""
    bufs = {}
    for k, v in node.items():
        dt = torch.int8 if k in _QKEYS else (dtype if k == "b" else torch.float32)
        bufs[k] = torch.empty(np.shape(v), dtype=dt, device=device)
    return Q.QLinear(bufs)


def _prepare_llama(lm: nn.Module, tree: dict) -> list:
    """Reshape a meta-built Llama to the tree: fused `qkv`/`gate_up` where
    the tree has them, and quantized linears taken out (returned as
    (owner, name, node) to be attached after materializing)."""
    quantized = []
    for name, node in tree.items():
        if not name.startswith("layer_") and name != "lm_head":
            continue
        owner = lm if name == "lm_head" else getattr(lm, name)
        for key, sub in ({name: node} if name == "lm_head" else node).items():
            if not isinstance(sub, dict) or not ({"w", *_QKEYS} & set(sub)):
                continue
            if key in ("qkv", "gate_up"):
                for part in (("q", "k", "v") if key == "qkv" else ("gate", "up")):
                    delattr(owner, part)
                if "w" in sub:
                    k_in, k_out = np.shape(sub["w"])
                    with torch.device("meta"):
                        setattr(owner, key, nn.Linear(k_in, k_out, bias="b" in sub))
            if "w" not in sub:
                if hasattr(owner, key):
                    delattr(owner, key)
                quantized.append((owner, key, sub))
    return quantized


def _build_llama_like(m: nn.Module, lm: nn.Module, tree: dict, llama_tree: dict, device,
                      dtype, trainable: bool = False) -> nn.Module:
    quantized = _prepare_llama(lm, llama_tree)
    if quantized and trainable:
        raise ValueError("a quantized tree cannot be built trainable")
    m = L.materialize(m, torch.device(device), dtype)
    for owner, key, sub in quantized:
        setattr(owner, key, _qlinear_empty(sub, device, dtype))
    m = load_tree(m, tree)
    return m.train().requires_grad_(True) if trainable else m.eval().requires_grad_(False)


def llama(tree, cfg: llama_lib.LlamaConfig, device="cpu", dtype=torch.float32) -> llama_lib.Llama:
    """A Llama from the JAX tree: float or quantized linears, unfused or
    fused (`qkv`, `gate_up`) per layer, as the tree holds them. Quantized
    linears never exist in float."""
    m = _meta(llama_lib.Llama, cfg)
    return _build_llama_like(m, m, tree, tree, device, dtype)


def llm(tree, cfg: mm_lib.Any2PixLMConfig, device="cpu", dtype=torch.float32,
        trainable: bool = False) -> mm_lib.Any2PixLM:
    """An Any2PixLM from the JAX `llm` tree (the Llama as `llama` does).
    `trainable=True` (float trees only) gives the trainer's module: every
    parameter requires a gradient."""
    m = _meta(mm_lib.Any2PixLM, cfg)
    return _build_llama_like(m, m.llama, tree, tree["llama"], device, dtype, trainable)


def to_tree(module: nn.Module) -> Dict[str, Any]:
    """A float LLM's parameters as a numpy tree in the JAX layout, the
    inverse of `load_tree` for linears (`w` input-major, `b`), embeddings
    (`w`) and free parameters such as RMSNorm gains (`g`)."""

    def arr(t):
        return t.detach().float().cpu().numpy()

    if isinstance(module, Q.QLinear):
        raise TypeError("to_tree maps float modules only")
    if isinstance(module, nn.Linear):
        out = {"w": arr(module.weight).T.copy()}
        if module.bias is not None:
            out["b"] = arr(module.bias)
        return out
    if isinstance(module, nn.Embedding):
        return {"w": arr(module.weight)}
    out = {n: arr(p) for n, p in module.named_parameters(recurse=False)}
    for n, child in module.named_children():
        sub = to_tree(child)
        if sub:
            out[n] = sub
    return out


def to_numpy(tree: Any) -> Any:
    """Nested dict of arrays (JAX or numpy) → nested dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


PIPELINE_COMPONENTS = (
    "unet", "refiner", "inpaint_unet", "vae", "text1", "text2", "prior_text", "image_proj", "prior",
    "imagebind_vision", "imagebind_audio", "llm",
)


def pipeline_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's components of a JAX pipeline's `params`, as numpy."""
    return {n: to_numpy(params[n]) for n in PIPELINE_COMPONENTS}
