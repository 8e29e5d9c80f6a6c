"""Boot the port's modules from the reference's checkpoint layout,
counterpart of the JAX package's `loaders.py`:

    <ckpt>/
      <llm_folder>/                   HF Llama shards (+ tokenizer/)
      prior/model.bin
      sdxl-base/{unet,vae,text_encoder,text_encoder_2}/
      sdxl-refiner/unet/
      sdxl/ip_adapter_global_local_2_view.bin
      clip-vit-h/
      imagebind_huge.pth
      gdino/{gdino.pth,sam_vit_h_4b8939.pth,vocab.txt}   (grounding.lib)

Each module is built on the meta device, allocated on `device` in `dtype`,
and filled through its model's `KeyMap`: file tensors keep their dtype
until they reach the device, where they are cast once. Loading is strict
(see `core.checkpoint`): a missing file raises `FileNotFoundError`, and a
missing, unknown or misshapen key raises; nothing is drawn at random.

The LLM streams: its shards are read one at a time through memory maps,
and each decoder layer is loaded (and, with `quant_bits`, quantized) as
soon as all of its tensors have been read, so neither the host nor the
device holds a float copy of the whole model.

`times`, where a function takes it, accumulates seconds under "read"
(opening files and moving tensors to the device), "cast" and "quantize".
Orbax roots (the JAX package's converted checkpoints) are not read.

`staged_models_from_root` builds the same modules lazily, group by group,
into a `core.staging.StagedParams` store under a device-byte budget, for a
card that cannot hold them all.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from .core import checkpoint as ckpt_lib
from .diffusion import ip_adapter as ipa
from .llm import multimodal as mm_lib
from .models import clip as clip_lib
from .models import imagebind as imagebind_lib
from .models import layers as L
from .models import llama as llama_lib
from .models import unet as unet_lib
from .models import unet_convert
from .models import vae as vae_lib
from .ops import quant as Q
from .prior import model as prior_lib

IP_ADAPTER = os.path.join("sdxl", "ip_adapter_global_local_2_view.bin")


def _add(times: Optional[Dict[str, float]], key: str, t0: float) -> None:
    if times is not None:
        times[key] = times.get(key, 0.0) + time.perf_counter() - t0


def read(path: str, times=None) -> Dict[str, torch.Tensor]:
    """One checkpoint file (`core.checkpoint.load_torch_state_dict`), timed."""
    t0 = time.perf_counter()
    sd = ckpt_lib.load_torch_state_dict(path)
    _add(times, "read", t0)
    return sd


def _read_dir(path: str, times=None) -> Dict[str, torch.Tensor]:
    t0 = time.perf_counter()
    sd = ckpt_lib.load_sharded(path)
    _add(times, "read", t0)
    return sd


def build(make: Callable[[], torch.nn.Module], tensors: Dict[str, torch.Tensor], device,
          dtype: torch.dtype, what: str, times=None) -> torch.nn.Module:
    """`make()` on the meta device, allocated on `device` in `dtype` and
    loaded strictly from `tensors` (port names); frozen for inference."""
    with torch.device("meta"):
        m = make()
    m = L.materialize(m, torch.device(device), dtype)
    ckpt_lib.load_module(m, tensors, what, times)
    return m.eval().requires_grad_(False)


# --------------------------------------------------------------------- LLM


def _llm_groups(m: mm_lib.Any2PixLM) -> Dict[str, Tuple[torch.nn.Module, str]]:
    """Port-name prefix → (owner, attribute) of each unit loaded at once:
    every child of the Llama (embeddings, each decoder layer, the final
    norm, the vocab head) and each projector or predictor head."""
    groups = {f"llama.{n}.": (m.llama, n) for n, _ in m.llama.named_children()}
    groups.update({f"{n}.": (m, n) for n, _ in m.named_children() if n != "llama"})
    return groups


def load_llm_heads(path: str, times=None) -> Dict[str, torch.Tensor]:
    """Only the four heads of an LLM directory (a projector-only run's
    output), as port tensors; any other key raises."""
    tensors: Dict[str, torch.Tensor] = {}
    for f in ckpt_lib.shard_files(path):
        tensors.update(mm_lib.heads_keymap().to_port(read(f, times), what=f))
    return tensors


@torch.no_grad()
def load_llm(path: str, cfg: mm_lib.Any2PixLMConfig, device, dtype: torch.dtype,
             quant_bits: Optional[int] = None, heads: Optional[Dict[str, torch.Tensor]] = None,
             times=None, tp_layout: bool = False) -> mm_lib.Any2PixLM:
    """The multimodal LLM from an HF directory: every shard, the Llama and
    the four heads (`model.vae_{projector,predictor}_{image,audio}.{0,2}`).
    `heads` (port tensors, `load_llm_heads`) replaces the heads it holds.
    With `quant_bits` each decoder layer is quantized as it lands and the
    projections are fused at the end, as the random build does.
    `tp_layout` (a tensor-parallel server's LLM): o and down stay int8 and
    nothing is fused (`parallel/sharding.py` shards the unfused names)."""
    km = mm_lib.keymap()
    with torch.device("meta"):
        m = mm_lib.Any2PixLM(cfg)
    groups = _llm_groups(m)
    need = {g: {n for n, _ in getattr(o, a).named_parameters()} for g, (o, a) in groups.items()}
    pending: Dict[str, Dict[str, torch.Tensor]] = {g: {} for g in groups}
    done = set()
    dev = torch.device(device)

    def land(g: str) -> None:
        owner, attr = groups[g]
        child = L.materialize(getattr(owner, attr), dev, dtype)
        ckpt_lib.load_module(child, pending.pop(g), f"{path}: {g[:-1]}", times)
        setattr(owner, attr, child)
        done.add(g)
        if quant_bits and g.startswith("llama.") and isinstance(child, (llama_lib.LlamaLayer,
                                                                       torch.nn.Linear)):
            t0 = time.perf_counter()
            # skips what is still on the meta device
            Q.quantize_llama(m.llama, bits=quant_bits, tp_rows_int8=tp_layout)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            _add(times, "quantize", t0)

    def take(tensors: Dict[str, torch.Tensor], where: str) -> None:
        for name, t in tensors.items():
            g = next((g for g in groups if name.startswith(g)), None)
            leaf = name[len(g):] if g else None
            if g is None or leaf not in need[g]:
                raise KeyError(f"{where}: {name} has no parameter in the LLM")
            if g in done or leaf in pending[g]:
                raise KeyError(f"{where}: {name} is given twice")
            pending[g][leaf] = t
            if len(pending[g]) == len(need[g]):
                land(g)

    given = {n.split(".", 1)[0] + "." for n in heads or {}}
    take(heads or {}, "heads")
    for f in ckpt_lib.shard_files(path):
        mapped = km.to_port(read(f, times), what=f)
        take({n: t for n, t in mapped.items() if n.split(".", 1)[0] + "." not in given}, f)
        del mapped
    unset = [g[:-1] for g in groups if g not in done]
    if unset:
        raise KeyError(f"{path}: the checkpoint leaves {len(unset)} parts of the LLM unset or "
                       f"incomplete, e.g. {unset[:8]}")
    if quant_bits and not tp_layout:
        llama_lib.fuse_projections(m.llama)
    return m.eval().requires_grad_(False)


# ------------------------------------------------------------- the others


def load_prior(path: str, cfg: prior_lib.PriorConfig, device, dtype, times=None) -> prior_lib.Prior:
    """`prior/model.bin`; `output_proj` exists when the file has one."""
    tensors = prior_lib.keymap().to_port(read(path, times), what=path)
    return build(lambda: prior_lib.Prior(cfg, output_proj="output_proj.weight" in tensors),
                 tensors, device, dtype, path, times)


def load_ip_adapter(path: str, unet_cfg: unet_lib.UNetConfig, times=None):
    """The IP-Adapter file as (the UNet's `to_k_ip`/`to_v_ip` tensors, the
    `ImageProj` tensors), both under port names."""
    km = (ipa.ip_attn_keymap(unet_convert.cross_attn_paths(unet_cfg))
          + ipa.image_proj_keymap().prefixed(port="image_proj."))
    mapped = km.to_port(read(path, times), what=path)
    proj = {n[len("image_proj."):]: t for n, t in mapped.items() if n.startswith("image_proj.")}
    attn = {n: t for n, t in mapped.items() if not n.startswith("image_proj.")}
    return attn, proj


def load_unet(path: str, cfg: unet_lib.UNetConfig, device, dtype, ip_attn=None,
              times=None) -> unet_lib.UNet:
    """A diffusers UNet directory; `ip_attn` (from `load_ip_adapter`) adds
    the IP-Adapter's keys and values to the cross-attentions."""
    tensors = unet_convert.unet_keymap().to_port(_read_dir(path, times), what=path)
    tensors.update(ip_attn or {})
    return build(lambda: unet_lib.UNet(cfg), tensors, device, dtype, path, times)


def load_vae(path: str, cfg: vae_lib.VAEConfig, device, dtype, times=None) -> vae_lib.VAE:
    tensors = unet_convert.vae_keymap().to_port(_read_dir(path, times), what=path)
    return build(lambda: vae_lib.VAE(cfg), tensors, device, dtype, path, times)


def load_clip_text(path: str, cfg: clip_lib.CLIPTextConfig, device, dtype,
                   times=None) -> clip_lib.CLIPText:
    tensors = clip_lib.text_keymap().to_port(_read_dir(path, times), what=path)
    return build(lambda: clip_lib.CLIPText(cfg), tensors, device, dtype, path, times)


def load_clip_vision(path: str, cfg: clip_lib.CLIPVisionConfig, device, dtype,
                     times=None) -> clip_lib.CLIPVision:
    """An HF `CLIPVisionModelWithProjection` directory (the IP-Adapter's
    `sdxl/image_encoder`)."""
    tensors = clip_lib.vision_keymap().to_port(_read_dir(path, times), what=path)
    return build(lambda: clip_lib.CLIPVision(cfg), tensors, device, dtype, path, times)


def _imagebind_modality(mapped: Dict[str, torch.Tensor], modality: str,
                        cfg: imagebind_lib.ViTConfig, device, dtype, path: str, times=None):
    pre = f"{modality}."
    t = {n[len(pre):]: v for n, v in mapped.items() if n.startswith(pre)}
    if "pos_embed" not in t:
        raise KeyError(f"{path}: no {modality} modality")

    def make():
        return imagebind_lib.ViT(cfg, num_patches=t["pos_embed"].shape[1] - 1,
                                 bias_kv="block_0.bias_k" in t,
                                 patch_norm="patch_norm.weight" in t,
                                 pre_ln="pre_ln.weight" in t)

    return build(make, t, device, dtype, f"{path} ({modality})", times)


def load_imagebind(path: str, vision_cfg: imagebind_lib.ViTConfig,
                   audio_cfg: imagebind_lib.ViTConfig, device, dtype, times=None):
    """(vision, audio) from `imagebind_huge.pth`. The token count, the
    audio stem's LayerNorm, the pre-trunk LayerNorm and `bias_k`/`bias_v`
    follow the file."""
    mapped = imagebind_lib.file_keymap().to_port(read(path, times), what=path)
    return tuple(_imagebind_modality(mapped, modality, cfg, device, dtype, path, times)
                 for modality, cfg in (("vision", vision_cfg), ("audio", audio_cfg)))


def load_pipeline_models(cfg, ckpt: str, llm_folder: str, device, dtype: torch.dtype,
                         quant_bits: Optional[int] = None, times=None,
                         tp_layout: bool = False) -> Dict[str, torch.nn.Module]:
    """Every module of the pipeline from a reference-layout root (the JAX
    `load_pipeline_params`). The base UNet carries the IP-Adapter's
    cross-attention weights and serves inpainting too. `tp_layout`: the
    LLM as `load_llm` lays it out for tensor parallelism."""
    sdxl = os.path.join(ckpt, "sdxl-base")
    models: Dict[str, torch.nn.Module] = {}
    models["llm"] = load_llm(os.path.join(ckpt, llm_folder), cfg.llm, device, dtype, quant_bits,
                             times=times, tp_layout=tp_layout)
    models["prior"] = load_prior(os.path.join(ckpt, "prior", "model.bin"), cfg.prior, device,
                                 dtype, times)
    ip_attn, proj = load_ip_adapter(os.path.join(ckpt, IP_ADAPTER), cfg.unet, times)
    models["unet"] = load_unet(os.path.join(sdxl, "unet"), cfg.unet, device, dtype, ip_attn, times)
    models["image_proj"] = build(lambda: ipa.ImageProj(cfg.image_proj), proj, device, dtype,
                                 IP_ADAPTER, times)
    models["vae"] = load_vae(os.path.join(sdxl, "vae"), cfg.vae, device, dtype, times)
    models["text1"] = load_clip_text(os.path.join(sdxl, "text_encoder"), cfg.text1, device, dtype,
                                     times)
    models["text2"] = load_clip_text(os.path.join(sdxl, "text_encoder_2"), cfg.text2, device,
                                     dtype, times)
    models["refiner"] = load_unet(os.path.join(ckpt, "sdxl-refiner", "unet"), cfg.refiner, device,
                                  dtype, times=times)
    models["prior_text"] = load_clip_text(os.path.join(ckpt, "clip-vit-h"), cfg.prior_text, device,
                                          dtype, times)
    models["imagebind_vision"], models["imagebind_audio"] = load_imagebind(
        os.path.join(ckpt, "imagebind_huge.pth"), cfg.imagebind_vision, cfg.imagebind_audio,
        device, dtype, times)
    return models


def staged_models_from_root(cfg, ckpt: str, llm_folder: str = "llm-retrained", device=None,
                            dtype: torch.dtype = torch.bfloat16, quant_bits: Optional[int] = None,
                            budget_bytes: float = 12.5e9, pin: tuple = ()):
    """A `core.staging.StagedParams` store over a reference-layout root (the
    JAX `staged_params_from_root`): each group's factory runs this module's
    loader for it on first access, and groups evict least recently used
    under `budget_bytes` and restage from the host. Groups whose files are
    absent have no factory. The base UNet carries the IP-Adapter's
    cross-attention weights and serves inpainting (`inpaint_unet` is an
    alias of `unet`). ImageBind's two modalities are two groups, each read
    from `imagebind_huge.pth`."""
    from .core.device import resolve_device
    from .core.staging import StagedParams

    dev = resolve_device(device)
    sdxl = os.path.join(ckpt, "sdxl-base")
    ip_path = os.path.join(ckpt, IP_ADAPTER)
    ib_path = os.path.join(ckpt, "imagebind_huge.pth")

    def unet():
        ip_attn, _ = load_ip_adapter(ip_path, cfg.unet)
        return load_unet(os.path.join(sdxl, "unet"), cfg.unet, dev, dtype, ip_attn)

    def image_proj():
        _, proj = load_ip_adapter(ip_path, cfg.unet)
        return build(lambda: ipa.ImageProj(cfg.image_proj), proj, dev, dtype, IP_ADAPTER)

    def imagebind(modality, mcfg):
        def make():
            mapped = imagebind_lib.file_keymap().to_port(read(ib_path), what=ib_path)
            return _imagebind_modality(mapped, modality, mcfg, dev, dtype, ib_path)

        return make

    def text(path, tcfg):
        return lambda: load_clip_text(path, tcfg, dev, dtype)

    groups = {
        "llm": (os.path.join(ckpt, llm_folder),
                lambda: load_llm(os.path.join(ckpt, llm_folder), cfg.llm, dev, dtype, quant_bits)),
        "prior": (os.path.join(ckpt, "prior", "model.bin"),
                  lambda: load_prior(os.path.join(ckpt, "prior", "model.bin"), cfg.prior, dev,
                                     dtype)),
        "vae": (os.path.join(sdxl, "vae"),
                lambda: load_vae(os.path.join(sdxl, "vae"), cfg.vae, dev, dtype)),
        "text1": (os.path.join(sdxl, "text_encoder"),
                  text(os.path.join(sdxl, "text_encoder"), cfg.text1)),
        "text2": (os.path.join(sdxl, "text_encoder_2"),
                  text(os.path.join(sdxl, "text_encoder_2"), cfg.text2)),
        "refiner": (os.path.join(ckpt, "sdxl-refiner", "unet"),
                    lambda: load_unet(os.path.join(ckpt, "sdxl-refiner", "unet"), cfg.refiner,
                                      dev, dtype)),
        "prior_text": (os.path.join(ckpt, "clip-vit-h"),
                       text(os.path.join(ckpt, "clip-vit-h"), cfg.prior_text)),
        "imagebind_vision": (ib_path, imagebind("vision", cfg.imagebind_vision)),
        "imagebind_audio": (ib_path, imagebind("audio", cfg.imagebind_audio)),
        "unet": (os.path.join(sdxl, "unet"), unet),
        "image_proj": (ip_path, image_proj),
    }
    factories = {name: make for name, (path, make) in groups.items() if os.path.exists(path)}
    return StagedParams(factories, budget_bytes=budget_bytes, aliases={"inpaint_unet": "unet"},
                        pin=pin)


def load_pretrained_model(model_path: str, model_base: Optional[str] = None,
                          load_lora: bool = False, projector_only: bool = False,
                          cfg: Optional[mm_lib.Any2PixLMConfig] = None, device=None,
                          dtype: torch.dtype = torch.bfloat16):
    """The multimodal LM in one of the reference builder's load modes (the
    JAX `load_pretrained_model`): a full finetune directory (default); the
    heads of a projector-only run over `model_base`; or, with `load_lora`,
    `model_base` with the LoRA adapters and fully trained heads that
    `model_path` holds in the reference's layout (`train.lora`), merged
    into the base weights (merge on load). Returns (module, tokenizer,
    token_ids); the tokenizer is always `model_path`'s. `cfg` defaults to
    Vicuna-7B with the tokenizer's special-token ids. The merged model is
    float: quantize (and fuse) it afterwards."""
    from .core.device import resolve_device
    from .llm.tokenizer import initialize_vision_tokenizer, load_tokenizer

    device = resolve_device(device)
    tokenizer = load_tokenizer(os.path.join(model_path, "tokenizer"))
    token_ids = initialize_vision_tokenizer(tokenizer)
    cfg = cfg or mm_lib.Any2PixLMConfig().with_token_ids(token_ids)
    if projector_only or load_lora:
        if not model_base:
            raise ValueError(f"a {'LoRA' if load_lora else 'projector-only'} load needs model_base")
    if load_lora:
        from .train import lora as lora_lib

        adapters, heads, scale = lora_lib.read_lora_checkpoint(model_path)
        model = load_llm(model_base, cfg, device, dtype)
        params = dict(model.named_parameters())
        with torch.no_grad():
            for name, t in heads.items():
                if name not in params or tuple(params[name].shape) != tuple(t.shape):
                    raise KeyError(f"{model_path}: {name} {tuple(t.shape)} has no parameter of "
                                   "that shape in the LLM")
                params[name].copy_(t.to(params[name].device))
        lora_lib.load_adapters(model, adapters, scale)
        return lora_lib.merge_lora(model), tokenizer, token_ids
    if projector_only:
        heads = load_llm_heads(model_path)
        model = load_llm(model_base, cfg, device, dtype, heads=heads)
    else:
        model = load_llm(model_path, cfg, device, dtype)
    return model, tokenizer, token_ids
