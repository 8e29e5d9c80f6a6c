"""InstructAny2PixPipeline on PyTorch — the SDXL text2img slice.

Counterpart of the JAX package's `pipeline.py` for `text2img`: dual CLIP
prompt encoding, the CFG (optionally IP-Adapter) denoise loop on the SDXL
schedule, VAE decode. Components are built on the card unless the caller
passes `device="cpu"`; without `params` they are random, drawn from a
`torch.Generator` seeded with `seed`. `params` takes the JAX package's
parameter trees (`{"unet": ..., "vae": ..., "text1": ..., "text2": ...,
"image_proj": ...}`, as numpy), converted by `convert.py`.

The edit (`__call__`), `forward_llm` and their LLM, prior and ImageBind
components come with the next slice.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import convert
from .codecs import image_io
from .core.device import resolve_device
from .core.dtypes import DEFAULT, DTypePolicy
from .diffusion import ip_adapter as ipa
from .diffusion import sampler as sampler_lib
from .diffusion.schedulers import Schedule, SchedulerConfig
from .llm.clip_tokenizer import load_clip_tokenizer
from .llm.tokenizer import initialize_vision_tokenizer, load_tokenizer
from .models import clip as clip_lib
from .models import layers as L
from .models import unet as unet_lib
from .models import vae as vae_lib


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    unet: unet_lib.UNetConfig = unet_lib.UNetConfig.sdxl_base(with_ip=True)
    refiner: unet_lib.UNetConfig = unet_lib.UNetConfig.sdxl_refiner()
    inpaint_unet: unet_lib.UNetConfig = unet_lib.UNetConfig.sdxl_inpaint(with_ip=True)
    vae: vae_lib.VAEConfig = vae_lib.VAEConfig()
    text1: clip_lib.CLIPTextConfig = clip_lib.CLIPTextConfig.vit_l()
    text2: clip_lib.CLIPTextConfig = clip_lib.CLIPTextConfig.open_clip_bigg()
    image_proj: ipa.ImageProjConfig = ipa.ImageProjConfig()
    image_size: int = 1024

    @staticmethod
    def tiny() -> "PipelineConfig":
        t1 = clip_lib.CLIPTextConfig.tiny()
        t2 = dataclasses.replace(clip_lib.CLIPTextConfig.tiny(), projection_dim=24)
        tiny_unet = unet_lib.UNetConfig.tiny(with_ip=True)
        ctx = t1.hidden_size + t2.hidden_size  # 64
        unet_cfg = dataclasses.replace(
            tiny_unet,
            cross_attention_dim=ctx,
            projection_class_embeddings_input_dim=24 + 6 * tiny_unet.addition_time_embed_dim,
        )
        ref_cfg = dataclasses.replace(
            unet_lib.UNetConfig.tiny(with_ip=False),
            cross_attention_dim=t2.hidden_size,
            projection_class_embeddings_input_dim=24 + 5 * tiny_unet.addition_time_embed_dim,
            num_time_ids=5,
        )
        return PipelineConfig(
            unet=unet_cfg,
            refiner=ref_cfg,
            inpaint_unet=dataclasses.replace(unet_cfg, in_channels=9),
            vae=vae_lib.VAEConfig.tiny(),
            text1=t1,
            text2=t2,
            image_proj=ipa.ImageProjConfig(cross_attention_dim=ctx, clip_embeddings_dim=16),
            image_size=64,
        )


def _tokenize_pad(tok, text: str, length: int = 77, eos: Optional[int] = None):
    ids = tok.encode(text) if hasattr(tok, "encode") else tok(text).input_ids
    ids = list(ids)[:length]
    if eos is not None and (not ids or ids[-1] != eos) and len(ids) < length:
        ids.append(eos)
    ids = ids + [0] * (length - len(ids))
    return np.asarray([ids], np.int32)


# component name → (module class, config field, converter)
_COMPONENTS = {
    "unet": (unet_lib.UNet, "unet", convert.unet),
    "vae": (vae_lib.VAE, "vae", convert.vae),
    "text1": (clip_lib.CLIPText, "text1", convert.clip_text),
    "text2": (clip_lib.CLIPText, "text2", convert.clip_text),
    "image_proj": (ipa.ImageProj, "image_proj", convert.image_proj),
}


class InstructAny2PixPipeline:
    """Port of the JAX `InstructAny2PixPipeline`, text2img surface."""

    def __init__(
        self,
        config: Optional[PipelineConfig] = None,
        params: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        device=None,
        policy: DTypePolicy = DEFAULT,
        ckpt: str = "ckpts",
    ):
        self.device = resolve_device(device)
        self.cfg = config or PipelineConfig()
        self.policy = policy
        self.schedule = Schedule.create(SchedulerConfig(), self.device)
        # byte tokenizer fallback unless real CLIP vocabs are on disk
        self.tokenizer = load_tokenizer(None)
        self.token_ids = initialize_vision_tokenizer(self.tokenizer)
        sdxl_dir = os.path.join(ckpt, "sdxl-base")
        self.clip_tok1 = load_clip_tokenizer(os.path.join(sdxl_dir, "tokenizer"))
        self.clip_tok2 = load_clip_tokenizer(os.path.join(sdxl_dir, "tokenizer_2"))

        gen = torch.Generator(self.device).manual_seed(seed)
        self.models: Dict[str, torch.nn.Module] = {}
        for name, (cls, field, conv) in _COMPONENTS.items():
            cfg = getattr(self.cfg, field)
            if params is not None:
                m = conv(params[name], cfg, self.device, policy.param_dtype)
            else:
                with torch.device("meta"):
                    m = cls(cfg)
                m = L.materialize(m, self.device, policy.param_dtype)
                m = L.init_(m, gen).eval().requires_grad_(False)
            self.models[name] = m

    # ------------------------------------------------------------ prompts

    def _clip_ids(self, clip_tok, prompt: str, length: int, eos: Optional[int]):
        """Token ids for a CLIP text encoder: the BPE tokenizer when its
        vocab is on disk, the byte tokenizer otherwise."""
        if clip_tok is not None:
            ids = np.asarray([clip_tok.encode_padded(prompt, length)], np.int32)
        else:
            ids = _tokenize_pad(self.tokenizer, prompt, length, eos)
        return torch.as_tensor(ids, device=self.device)

    def _encode_sdxl_prompt(self, prompt: str):
        c = self.cfg
        ids1 = self._clip_ids(self.clip_tok1, prompt, c.text1.max_positions, c.text1.eos_token_id)
        ids2 = self._clip_ids(self.clip_tok2, prompt, c.text2.max_positions, c.text2.eos_token_id)
        return sampler_lib.encode_prompt_sdxl(
            self.models["text1"], c.text1, self.models["text2"], c.text2, ids1, ids2
        )

    # ------------------------------------------------------------ text2img

    @torch.inference_mode()
    def text2img(
        self,
        prompt: str,
        negative_prompt: str = "",
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        seed: int = 0,
        ip_embeds=None,
        ip_scale: float = 1.0,
        latents=None,
    ) -> np.ndarray:
        """SDXL text-to-image → (H, W, 3) uint8. `ip_embeds` (a 1024-d
        image embedding) conditions through the IP-Adapter in global mode.
        `latents` (1, h, h, 4) is the start noise; without it the noise is
        drawn from a generator seeded with `seed` (not the JAX stream)."""
        c = self.cfg
        ctx_p, pooled_p = self._encode_sdxl_prompt(prompt)
        ctx_n, pooled_n = self._encode_sdxl_prompt(negative_prompt)
        tid = sampler_lib.default_time_ids(c.image_size, c.image_size, 1, self.device)
        h = c.image_size // (2 ** (len(c.vae.block_out_channels) - 1))
        if latents is None:
            gen = torch.Generator(self.device).manual_seed(seed)
            lat = torch.randn((1, h, h, 4), generator=gen, device=self.device)
        else:
            lat = torch.as_tensor(np.array(latents, np.float32), device=self.device)
            if lat.shape != (1, h, h, 4):
                raise ValueError(f"latents shape {tuple(lat.shape)} != {(1, h, h, 4)}")
        ip_cond = ip_uncond = None
        if ip_embeds is not None:
            e = torch.as_tensor(np.array(ip_embeds, np.float32), device=self.device).reshape(1, -1)
            ip_cond, ip_uncond = ipa.get_image_embeds(
                self.models["image_proj"], c.image_proj, clip_image_embeds=e, mode="global"
            )
        lat = sampler_lib.denoise(
            self.models["unet"], c.unet, self.schedule, lat, ctx_p, ctx_n, pooled_p,
            pooled_n, tid, num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, ip_tokens=ip_cond, ip_tokens_uncond=ip_uncond,
            ip_scale=ip_scale,
        )
        img = vae_lib.decode(self.models["vae"], lat, c.vae)
        return image_io.from_model_range(img[0].float().cpu().numpy())
