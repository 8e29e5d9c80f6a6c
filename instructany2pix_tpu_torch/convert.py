"""Weights from the JAX package's parameter trees into the port's modules.

The port's modules carry the JAX trees' key names, so a tree maps onto a
module key for key. Per leaf:
  * linear `w` is stored input-major (in, out) and becomes (out, in);
  * conv `w` is stored HWIO and becomes OIHW;
  * conv1d `w` is stored (k, in, out) and becomes (out, in, k); a
    transposed conv1d's, stored pre-flipped in that orientation, becomes
    PyTorch's (in, out, k);
  * norm `g`/`b` become `weight`/`bias`, embedding `w` becomes `weight`;
  * free arrays (IP-Adapter's `raw_embed`, ViT tokens) copy as they are;
  * weight-only quantized linears (`w_q`/`w_q4` with `scale`/`gscale`)
    become `QLinear`s holding the same bytes and float32 scales;
  * LoRA leaves of a float or quantized linear (`lora_a` (in, r), `lora_b`
    (r, out), `lora_scale`) become its adapters (`layers.add_lora`, PEFT's
    (r, in) and (out, r) layout), attached when the module has none.
Fused projections a tree may carry are split back first: `to_qkv`
(q|k|v along the output axis) and `to_kv` (k|v), and `ff_in_a`/`ff_in_g`
re-join into `ff_in` (value half, then gate half). Loading is strict:
a tree key without a counterpart, a shape mismatch or a module parameter
the tree leaves unset raises.

Lists in a tree (LPAPS's `convs`, `lins`) load into `nn.ModuleList`s.
Trees may hold numpy arrays or anything `numpy.asarray` accepts. Built
modules are frozen for inference (`eval`, no gradients), except the
trainer's `llm(..., trainable=True)`; `to_tree`
maps a float module back to a numpy tree in the JAX layout (adapters
included), or its gradients (`grad=True`), to compare parameters and
gradients after training steps.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .codecs import audio as audio_lib
from .codecs import vqgan as vqgan_lib
from .codecs import vqgan_train as vqgan_train_lib
from .diffusion import ip_adapter as ipa
from .diffusion import ip_adapter_faceid as faceid_lib
from .diffusion import resampler as resampler_lib
from .grounding import bert as bert_lib
from .grounding import gdino as gdino_lib
from .grounding import sam as sam_lib
from .grounding import swin as swin_lib
from .llm import multimodal as mm_lib
from .models import clip as clip_lib
from .models import imagebind as imagebind_lib
from .models import layers as L
from .models import llama as llama_lib
from .models import mpt as mpt_lib
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


_LORA_KEYS = {"lora_a", "lora_b", "lora_scale"}


def _load_lora(lin: nn.Module, val: dict, name: str, seen: set) -> None:
    """JAX adapters (`lora_a` (in, r), `lora_b` (r, out), `lora_scale`,
    1 when absent) onto a linear, attached first when it has none."""
    if "lora_a" not in val:
        return
    a = np.asarray(val["lora_a"])
    scale = float(np.asarray(val.get("lora_scale", 1.0)))
    if not L.has_lora(lin):
        L.add_lora(lin, rank=a.shape[1], alpha=scale * a.shape[1])
    _put(lin.lora_a, a.T, name + ".lora_a", seen)
    _put(lin.lora_b, np.asarray(val["lora_b"]).T, name + ".lora_b", seen)
    lin.lora_scale.fill_(scale)


def _load(module: nn.Module, tree: dict, path: str, seen: set) -> None:
    for key, val in tree.items():
        name = f"{path}{key}"
        child = getattr(module, key, None)
        if isinstance(child, Q.QLinear):
            _leaf_keys(val, set(child.q) | _LORA_KEYS, name)
            _load_lora(child, val, name, seen)
            for k, buf in child.q.items():
                arr = np.asarray(val[k])
                if tuple(arr.shape) != tuple(buf.shape):
                    raise ValueError(f"{name}.{k}: tree shape {arr.shape} != {tuple(buf.shape)}")
                buf.copy_(torch.from_numpy(np.array(arr)).to(buf.dtype))
        elif isinstance(child, nn.Parameter):
            _put(child, val, name, seen)
        elif isinstance(child, nn.Linear):
            _leaf_keys(val, {"w", "b"} | _LORA_KEYS, name)
            _load_lora(child, val, name, seen)
            _put(child.weight, np.asarray(val["w"]).T, name + ".w", seen)
            if "b" in val:
                _put(child.bias, val["b"], name + ".b", seen)
        elif isinstance(child, nn.Conv2d):
            _leaf_keys(val, {"w", "b"}, name)
            _put(child.weight, np.asarray(val["w"]).transpose(3, 2, 0, 1), name + ".w", seen)
            if "b" in val:
                _put(child.bias, val["b"], name + ".b", seen)
        elif isinstance(child, nn.ConvTranspose1d):
            # stored pre-flipped in (k, cin, cout) conv orientation
            _leaf_keys(val, {"w", "b"}, name)
            w = np.ascontiguousarray(np.flip(np.asarray(val["w"]), axis=0).transpose(1, 2, 0))
            _put(child.weight, w, name + ".w", seen)
            if "b" in val:
                _put(child.bias, val["b"], name + ".b", seen)
        elif isinstance(child, nn.Conv1d):
            _leaf_keys(val, {"w", "b"}, name)
            _put(child.weight, np.asarray(val["w"]).transpose(2, 1, 0), name + ".w", seen)
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
        elif isinstance(child, nn.ModuleList) and isinstance(val, (list, tuple)):
            _load(child, {str(i): v for i, v in enumerate(val)}, name + ".", seen)
        else:
            raise KeyError(f"{name} has no counterpart in {type(module).__name__}")


@torch.no_grad()
def load_tree(module: nn.Module, tree: dict, split_fused: bool = True) -> nn.Module:
    """Copy a JAX parameter tree into `module` in place (strict). With
    `split_fused` the fused projections are split first (`unfuse`); the
    perceivers keep their own `to_kv`."""
    seen: set = set()
    _load(module, unfuse(tree) if split_fused else tree, "", seen)
    missing = [n for n, p in module.named_parameters() if id(p) not in seen]
    if missing:
        raise KeyError(f"tree leaves {len(missing)} parameters unset, e.g. {missing[:5]}")
    return module


def build(module_on_meta: nn.Module, tree: dict, device="cpu", dtype=torch.float32,
          split_fused: bool = True) -> nn.Module:
    """Allocate a meta-built module on `device` in `dtype` and load `tree`."""
    m = L.materialize(module_on_meta, torch.device(device), dtype)
    return load_tree(m, tree, split_fused).eval().requires_grad_(False)


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


def resampler(tree, cfg: resampler_lib.ResamplerConfig, device="cpu",
              dtype=torch.float32) -> resampler_lib.Resampler:
    """The IP-Adapter Plus Resampler from its JAX tree."""
    return build(_meta(resampler_lib.Resampler, cfg), tree, device, dtype, split_fused=False)


def face_proj(tree, cfg: faceid_lib.FaceProjConfig, device="cpu",
              dtype=torch.float32) -> faceid_lib.FaceProj:
    """The FaceID projector (with its perceiver for Plus) from its JAX tree."""
    return build(_meta(faceid_lib.FaceProj, cfg), tree, device, dtype, split_fused=False)


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


def clip_vision(tree, cfg: clip_lib.CLIPVisionConfig, device="cpu",
                dtype=torch.float32) -> clip_lib.CLIPVision:
    return build(_meta(clip_lib.CLIPVision, cfg), tree, device, dtype)


def vqgan(tree, cfg: vqgan_lib.VQConfig, device="cpu", dtype=torch.float32) -> vqgan_lib.VQModel:
    return build(_meta(vqgan_lib.VQModel, cfg), tree, device, dtype)


def vq1d(tree, cfg: audio_lib.VQ1DConfig, device="cpu", dtype=torch.float32) -> audio_lib.VQ1D:
    return build(_meta(audio_lib.VQ1D, cfg), tree, device, dtype)


def vocoder(tree, cfg: audio_lib.VocoderConfig, device="cpu",
            dtype=torch.float32) -> audio_lib.Vocoder:
    return build(_meta(audio_lib.Vocoder, cfg), tree, device, dtype)


def lpaps(tree, cfg: audio_lib.LPAPSConfig, device="cpu", dtype=torch.float32) -> audio_lib.LPAPS:
    """LPAPS with as many scaling statistics as the tree's `shift`."""
    with torch.device("meta"):
        m = audio_lib.LPAPS(cfg, n_stats=int(np.asarray(tree["shift"]).size))
    return build(m, tree, device, dtype)


def discriminator(tree, cfg: vqgan_train_lib.DiscConfig, device="cpu",
                  dtype=torch.float32) -> vqgan_train_lib.Discriminator:
    return build(_meta(vqgan_train_lib.Discriminator, cfg), tree, device, dtype)


def mpt(tree, cfg: mpt_lib.MPTConfig, device="cpu", dtype=torch.float32) -> mpt_lib.MPT:
    return build(_meta(mpt_lib.MPT, cfg), tree, device, dtype)


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


def to_tree(module: nn.Module, grad: bool = False) -> Dict[str, Any]:
    """A float module's parameters (or, with `grad`, their gradients) as a
    numpy tree in the JAX layout, the inverse of `load_tree` for linears
    (`w` input-major, `b`), convolutions (HWIO; conv1d (k, in, out), a
    transposed one pre-flipped), norms (`g`, `b`), embeddings (`w`) and free
    parameters such as RMSNorm gains (`g`). A parameter without a gradient
    maps to zeros."""

    def arr(t):
        if grad:
            t = t.grad if t.grad is not None else torch.zeros_like(t)
        return t.detach().float().cpu().numpy()

    def wb(m, w):
        out = {"w": np.ascontiguousarray(w)}
        if m.bias is not None:
            out["b"] = arr(m.bias)
        return out

    if isinstance(module, Q.QLinear):
        raise TypeError("to_tree maps float modules only")
    if isinstance(module, nn.Linear):
        out = wb(module, arr(module.weight).T)
        if L.has_lora(module):
            out.update(lora_a=arr(module.lora_a).T.copy(), lora_b=arr(module.lora_b).T.copy(),
                       lora_scale=module.lora_scale.detach().float().cpu().numpy())
        return out
    if isinstance(module, nn.Conv2d):
        return wb(module, arr(module.weight).transpose(2, 3, 1, 0))
    if isinstance(module, nn.ConvTranspose1d):
        return wb(module, np.flip(arr(module.weight).transpose(2, 0, 1), axis=0))
    if isinstance(module, nn.Conv1d):
        return wb(module, arr(module.weight).transpose(2, 1, 0))
    if isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
        return {"g": arr(module.weight), "b": arr(module.bias)}
    if isinstance(module, nn.Embedding):
        return {"w": arr(module.weight)}
    out = {n: arr(p) for n, p in module.named_parameters(recurse=False)}
    for n, child in module.named_children():
        sub = to_tree(child, grad)
        if sub:
            out[n] = sub
    return out


def to_numpy(tree: Any) -> Any:
    """Nested dicts and lists of arrays (JAX or numpy) → the same of numpy
    arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


PIPELINE_COMPONENTS = (
    "unet", "refiner", "inpaint_unet", "vae", "text1", "text2", "prior_text", "image_proj", "prior",
    "imagebind_vision", "imagebind_audio", "llm",
)


def pipeline_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's components of a JAX pipeline's `params`, as numpy."""
    return {n: to_numpy(params[n]) for n in PIPELINE_COMPONENTS}
