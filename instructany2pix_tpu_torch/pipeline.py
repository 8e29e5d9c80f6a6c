"""InstructAny2PixPipeline on PyTorch: the instruction-driven edit, with
subject consistency, and SDXL text2img.

Counterpart of the JAX package's `pipeline.py` for `__call__`,
`forward_llm` and `text2img`. Components are built on the card unless
the caller passes `device="cpu"`. With the reference's checkpoint layout
under `ckpt` they are loaded from it (`loaders.py`); without checkpoints
or `params` they are random, drawn from a `torch.Generator` seeded with
`seed`. Either way `llm_quant_bits=4` (or 8) builds the LLM layer by
layer, quantizes each layer with `quantize_llama` as soon as it exists and
fuses its projections, the production format. `params` takes the JAX
package's parameter trees (`convert.pipeline_params`), float or quantized,
converted by `convert.py`.

Every sampling site draws from one `torch.Generator` seeded with `seed`,
in a fixed order (LLM sampling, VAE posterior, polar noise, with
`diffusion_mode="ipa_lcm"` the 4 LCM steps' noise, refiner VAE posterior,
refiner img2img noise, then per inpainted subject the VAE posteriors of
the image and of the masked image and the inpaint start noise), and each
takes an injected tensor instead (`vae_noise=`, `polar_noise=`,
`lcm_noise=`, `refiner_vae_noise=`, `refiner_noise=`, and
`subject_noise=[{"vae", "masked_vae", "inpaint"}, ...]`), so a test can
feed the JAX draws. Media files and base images are decoded once per file
version (`utils/filecache.py`), as in the JAX pipeline.

Subject consistency (`subject_strength > 0`) grounds each image subject
with `self.grounder`, masks it with `self.segmentor` and repaints the
region with the inpaint UNet in IP-Adapter local mode. Both callables come
from `grounding.lib.build_segmentator` (SAM and GroundingDINO from
`<ckpt>/gdino`, else the checkpoint-free fallbacks); callers may put a
SAM segmentor (`grounding.sam.make_segmentor`) or a GroundingDINO
grounder (`grounding.gdino.make_grounder`) in their place.
The inpaint UNet is built when `cfg.inpaint_unet` has 9 input channels;
otherwise the base UNet serves it (one module, no copy).

`cfg.llm_speculative_layers > 0` decodes greedily by exact self-speculative
decoding (`llm/speculative.py`, a draft of that many layers, 4 tokens a
round), as the JAX pipeline does; the batched server keeps its plain
decode. `__call__(debug=True)` runs one more conditioned UNet forward at
the final latent with the IP attention tap on and returns the JAX
pipeline's dict (attention maps, caption, latents, annotations, ...) in
place of "SUCCESS!".
"""

from __future__ import annotations

import dataclasses
import functools
import os
import re
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from . import convert, loaders
from .codecs import image_io
from .core.device import resolve_device
from .core.dtypes import DEFAULT, DTypePolicy
from .diffusion import img2img as i2i
from .diffusion import ip_adapter as ipa
from .diffusion import sampler as sampler_lib
from .diffusion.schedulers import Schedule, SchedulerConfig, lcm_timesteps
from .grounding import lib as grounding_lib
from .llm import constants as C
from .llm import generate as gen_lib
from .llm import multimodal as mm_lib
from .llm import speculative as spec_lib
from .llm.clip_tokenizer import load_clip_tokenizer
from .llm.conversation import conv_templates
from .llm.tokenizer import initialize_vision_tokenizer, load_tokenizer
from .models import clip as clip_lib
from .models import imagebind as imagebind_lib
from .models import layers as L
from .models import unet as unet_lib
from .models import vae as vae_lib
from .ops import quant as Q
from .prior import model as prior_lib
from .utils import profiling
from .utils.filecache import cached

MODALITY = prior_lib.MODALITY
REPLACEMENT_TYPE = C.REPLACEMENT_TYPE

# The reference calls the SDXL refiner with diffusers' default of 50
# inference steps: strength slices this fixed grid, whatever the edit's
# own step count.
REFINER_NUM_STEPS = 50
# `diffusion_mode="ipa_lcm"`: 4 LCM steps at guidance 1.0
LCM_NUM_STEPS = 4
# Subject inpainting runs on a fixed 50-step grid too, whatever the edit's
# step count (the JAX pipeline's `_make_inpaint_fn`).
INPAINT_NUM_STEPS = 50


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    llm: mm_lib.Any2PixLMConfig = None  # type: ignore[assignment]  # None → Vicuna-7B
    prior: prior_lib.PriorConfig = prior_lib.PriorConfig()
    unet: unet_lib.UNetConfig = unet_lib.UNetConfig.sdxl_base(with_ip=True)
    refiner: unet_lib.UNetConfig = unet_lib.UNetConfig.sdxl_refiner()
    inpaint_unet: unet_lib.UNetConfig = unet_lib.UNetConfig.sdxl_inpaint(with_ip=True)
    vae: vae_lib.VAEConfig = vae_lib.VAEConfig()
    text1: clip_lib.CLIPTextConfig = clip_lib.CLIPTextConfig.vit_l()
    text2: clip_lib.CLIPTextConfig = clip_lib.CLIPTextConfig.open_clip_bigg()
    prior_text: clip_lib.CLIPTextConfig = clip_lib.CLIPTextConfig.vit_h()
    image_proj: ipa.ImageProjConfig = ipa.ImageProjConfig()
    imagebind_vision: imagebind_lib.ViTConfig = imagebind_lib.ViTConfig.imagebind_vision()
    imagebind_audio: imagebind_lib.ViTConfig = imagebind_lib.ViTConfig.imagebind_audio()
    image_size: int = 1024
    embed_norm: float = 20.0
    # > 0: exact self-speculative greedy decode with an early-exit draft of
    # that many layers (llm/speculative.py); the server keeps plain decode
    llm_speculative_layers: int = 0
    # the grounding models `build_segmentator` loads from <ckpt>/gdino
    # (None selects Swin-T / ViT-H)
    gdino: Optional[Any] = None
    sam: Optional[Any] = None

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
            llm=mm_lib.Any2PixLMConfig.tiny(),
            prior=dataclasses.replace(
                prior_lib.PriorConfig.tiny(),
                embed_dim=16,  # the codec dim, so mix_latents works
                output_dim=16,
                imagebind_dim=16,
                text_dim=32,
                gpt2=dataclasses.replace(prior_lib.gpt2.GPT2Config.tiny(), hidden_size=16),
                sequence_input_key=(
                    ("src_type", 0),
                    ("imagebind", 16),
                    ("crossattn_clip", 32),
                    ("score", 8),
                    ("noisy_inputs", 0),
                ),
            ),
            unet=unet_cfg,
            refiner=ref_cfg,
            inpaint_unet=dataclasses.replace(unet_cfg, in_channels=9),
            vae=vae_lib.VAEConfig.tiny(),
            text1=t1,
            text2=t2,
            prior_text=dataclasses.replace(
                clip_lib.CLIPTextConfig.tiny(), hidden_size=32, intermediate_size=64,
                projection_dim=None,
            ),
            image_proj=ipa.ImageProjConfig(cross_attention_dim=ctx, clip_embeddings_dim=16),
            imagebind_vision=imagebind_lib.ViTConfig.tiny(),
            imagebind_audio=dataclasses.replace(
                imagebind_lib.ViTConfig.tiny(in_channels=1), image_size=0
            ),
            image_size=64,
        )


def _tokenize_pad(tok, text: str, length: int = 77, eos: Optional[int] = None):
    ids = tok.encode(text) if hasattr(tok, "encode") else tok(text).input_ids
    ids = list(ids)[:length]
    if eos is not None and (not ids or ids[-1] != eos) and len(ids) < length:
        ids.append(eos)
    ids = ids + [0] * (length - len(ids))
    return np.asarray([ids], np.int32)


def _meta_builders(cfg: PipelineConfig):
    """component → (module built on the meta device, converter from a JAX
    tree); the LLM is built apart (`_random_llm`, `convert.llm`)."""
    ib_audio_patches = imagebind_lib.audio_patches(cfg.imagebind_audio)
    return {
        "unet": (lambda: unet_lib.UNet(cfg.unet), lambda t, d, dt: convert.unet(t, cfg.unet, d, dt)),
        "refiner": (lambda: unet_lib.UNet(cfg.refiner),
                    lambda t, d, dt: convert.unet(t, cfg.refiner, d, dt)),
        "vae": (lambda: vae_lib.VAE(cfg.vae), lambda t, d, dt: convert.vae(t, cfg.vae, d, dt)),
        "text1": (lambda: clip_lib.CLIPText(cfg.text1),
                  lambda t, d, dt: convert.clip_text(t, cfg.text1, d, dt)),
        "text2": (lambda: clip_lib.CLIPText(cfg.text2),
                  lambda t, d, dt: convert.clip_text(t, cfg.text2, d, dt)),
        "prior_text": (lambda: clip_lib.CLIPText(cfg.prior_text),
                       lambda t, d, dt: convert.clip_text(t, cfg.prior_text, d, dt)),
        "image_proj": (lambda: ipa.ImageProj(cfg.image_proj),
                       lambda t, d, dt: convert.image_proj(t, cfg.image_proj, d, dt)),
        "prior": (lambda: prior_lib.Prior(cfg.prior),
                  lambda t, d, dt: convert.prior(t, cfg.prior, d, dt)),
        "imagebind_vision": (lambda: imagebind_lib.ViT(cfg.imagebind_vision),
                             lambda t, d, dt: convert.imagebind(t, cfg.imagebind_vision, d, dt)),
        "imagebind_audio": (
            lambda: imagebind_lib.ViT(cfg.imagebind_audio, num_patches=ib_audio_patches),
            lambda t, d, dt: convert.imagebind(t, cfg.imagebind_audio, d, dt)),
    }


def _random_module(make, device, dtype, gen) -> torch.nn.Module:
    with torch.device("meta"):
        m = make()
    m = L.materialize(m, device, dtype)
    return L.init_(m, gen).eval().requires_grad_(False)


@torch.no_grad()
def _random_llm(cfg: mm_lib.Any2PixLMConfig, device, dtype, gen,
                quant_bits: Optional[int], tp_layout: bool = False) -> mm_lib.Any2PixLM:
    """Random Any2PixLM. With `quant_bits` each decoder layer is quantized
    as soon as it is built, so no float copy of the whole LLM exists.
    `tp_layout`: o and down at int8 and nothing fused, for tensor
    parallelism (`loaders.load_llm`)."""
    with torch.device("meta"):
        m = mm_lib.Any2PixLM(cfg)
    for name, child in list(m.named_children()):
        if name != "llama":
            setattr(m, name, L.init_(L.materialize(child, device, dtype), gen))
    lm = m.llama
    for name, child in list(lm.named_children()):
        setattr(lm, name, L.init_(L.materialize(child, device, dtype), gen))
        if quant_bits:
            # skips layers still on the meta device
            Q.quantize_llama(lm, bits=quant_bits, tp_rows_int8=tp_layout)
    if quant_bits and not tp_layout:
        from .models import llama as llama_lib

        llama_lib.fuse_projections(lm)
    return m.eval().requires_grad_(False)


def _request_span(fn):
    """`fn` inside one "request" span, with the device allocator's deltas
    over it; its stages' times are settled once it has returned its images
    to the host."""

    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        with profiling.span("request", memory=True):
            out = fn(self, *args, **kwargs)
        self._settle_stages()
        return out

    return call


class InstructAny2PixPipeline:
    """Port of the JAX `InstructAny2PixPipeline`.

    Weights come from `params` (a converted JAX tree, `convert.pipeline_params`);
    else, when `<ckpt>/<llm_folder>` exists, from the reference's checkpoint
    layout under `ckpt` (`loaders.load_pipeline_models`: the LLM quantized
    with `llm_quant_bits` as it loads, the base UNet pinned to inpaint, and
    SAM and GroundingDINO from `<ckpt>/gdino`), where a missing file or key
    raises; else they are drawn at random from `seed`. Unlike the JAX
    constructor, which picks `PipelineConfig.tiny()` when there is neither a
    checkpoint nor `params`, the port builds `config` or, when it is None,
    the full `PipelineConfig()`.

    `models` takes the modules ready-made in place of all of that: a dict,
    or a `core.staging.StagedParams` store (`loaders.staged_models_from_root`)
    whose groups are built on first access and evicted under a byte budget.
    The pipeline looks every module up in `self.models` where it uses it, so
    a store may evict and restage between stages. With a checkpoint root
    the base UNet serves inpainting, as in the eager boot, and the
    tokenizers, SAM and GroundingDINO come from `ckpt` either way.
    """

    def __init__(
        self,
        config: Optional[PipelineConfig] = None,
        params: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        device=None,
        policy: DTypePolicy = DEFAULT,
        ckpt: str = "ckpts",
        llm_folder: str = "llm-retrained",
        llm_quant_bits: Optional[int] = None,
        models: Optional[Mapping[str, torch.nn.Module]] = None,
        mesh=None,
    ):
        # a mesh with a model axis (a tensor-parallel server, `serving.py`)
        # takes the LLM unfused, with o and down at int8
        self.mesh = mesh
        tp_layout = mesh is not None and mesh.n_model > 1
        self.device = resolve_device(device if device is not None or mesh is None else mesh.device)
        self.cfg = config or PipelineConfig()
        if self.cfg.llm is None:
            self.cfg = dataclasses.replace(self.cfg, llm=mm_lib.Any2PixLMConfig())
        on_disk = params is None and os.path.isdir(os.path.join(ckpt, llm_folder))
        from_disk = on_disk and models is None
        if on_disk:
            # the base UNet serves inpainting, as the reference builds its
            # inpaint pipeline from the base components
            self.cfg = dataclasses.replace(self.cfg, inpaint_unet=self.cfg.unet)
        self.policy = policy
        self.schedule = Schedule.create(SchedulerConfig(), self.device)
        self.cache = None
        self.last_generate: Optional[gen_lib.GenerateResult] = None
        # tokens emitted by each round of the last speculative decode
        self.last_rounds: List[int] = []
        # seconds per stage when `stage_times` is a dict (see `_stage`)
        self.stage_times: Optional[Dict[str, float]] = None

        # the LLM's tokenizer from <ckpt>/<llm_folder>/tokenizer when it is
        # on disk, the byte tokenizer otherwise
        self.tokenizer = load_tokenizer(os.path.join(ckpt, llm_folder, "tokenizer"))
        self.token_ids = initialize_vision_tokenizer(self.tokenizer)
        # CLIP BPE tokenizers for the SDXL text towers and the prior's
        # CLIP-ViT-H; the byte tokenizer where no vocab is on disk
        sdxl_dir = os.path.join(ckpt, "sdxl-base")
        self.clip_tok1 = load_clip_tokenizer(os.path.join(sdxl_dir, "tokenizer"))
        self.clip_tok2 = load_clip_tokenizer(os.path.join(sdxl_dir, "tokenizer_2"))
        self.prior_tok = load_clip_tokenizer(
            os.path.join(ckpt, "clip-vit-h", "tokenizer")
        ) or load_clip_tokenizer(os.path.join(ckpt, "clip-vit-h"))

        gen = torch.Generator(self.device).manual_seed(seed)
        dtype = policy.param_dtype
        # seconds of the checkpoint boot: "read", "cast" and "quantize"
        self.boot_times: Optional[Dict[str, float]] = {} if from_disk else None
        self.models: Mapping[str, torch.nn.Module] = {}
        if models is not None:
            self.models = models
        elif from_disk:
            self.models = loaders.load_pipeline_models(self.cfg, ckpt, llm_folder, self.device,
                                                       dtype, llm_quant_bits, self.boot_times,
                                                       tp_layout=tp_layout)
        else:
            for name, (make, conv) in _meta_builders(self.cfg).items():
                if params is not None:
                    self.models[name] = conv(params[name], self.device, dtype)
                else:
                    self.models[name] = _random_module(make, self.device, dtype, gen)
            self.models["llm"] = (
                convert.llm(params["llm"], self.cfg.llm, self.device, dtype) if params is not None
                else _random_llm(self.cfg.llm, self.device, dtype, gen, llm_quant_bits, tp_layout))
        # a 9-channel inpaint UNet of its own; else the base UNet inpaints
        icfg = self.cfg.inpaint_unet
        if models is not None:
            pass  # the store holds the inpaint UNet, or aliases the base one
        elif icfg.in_channels == 9:
            self.models["inpaint_unet"] = (
                convert.unet(params["inpaint_unet"], icfg, self.device, dtype) if params is not None
                else _random_module(lambda: unet_lib.UNet(icfg), self.device, dtype, gen))
        elif icfg != self.cfg.unet:
            raise ValueError("a 4-channel inpaint_unet config must equal the base UNet's: "
                             "the base UNet serves inpainting")
        self.segmentor, self.grounder = grounding_lib.build_segmentator(
            os.path.join(ckpt, "gdino"), sam_cfg=self.cfg.sam, dino_cfg=self.cfg.gdino,
            device=self.device, times=self.boot_times)

    # ---------------------------------------------------------- helpers

    @property
    def stage_times(self) -> Optional[Dict[str, float]]:
        """Seconds per stage, summed, while a dict is set here; None turns
        the timing off. On the card each stage is timed by CUDA events at
        its edges, with no sync, and `_settle_stages` reads them once the
        unit's images are on the host. Reading this before then waits for
        the device to finish the stages recorded so far."""
        self._settle_stages()
        return self._stage_times

    @stage_times.setter
    def stage_times(self, times: Optional[Dict[str, float]]):
        self._stage_times, self._stage_events = times, []

    def _settle_stages(self):
        """Add the seconds of the stages timed by CUDA events to
        `stage_times`. Called where the host has already waited for the
        unit's images (`__call__`'s return, the server's copy to the
        host), so the last event has completed and waiting on it is free."""
        if self._stage_events:
            events, self._stage_events = self._stage_events, []
            events[-1][2].synchronize()
            for name, start, stop in events:
                self._stage_times[name] = (self._stage_times.get(name, 0.0)
                                           + start.elapsed_time(stop) / 1e3)

    @contextmanager
    def _stage(self, name: str):
        """A stage: a span while the tracer is on, and its seconds in
        `stage_times` while that is a dict (host clock on the CPU, CUDA
        events on the card). Neither syncs."""
        with profiling.span(name):
            if self._stage_times is None:
                yield
            elif self.device.type == "cuda":
                stream = torch.cuda.current_stream(self.device)
                start = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                yield
                stop = torch.cuda.Event(enable_timing=True)
                stop.record(stream)
                self._stage_events.append((name, start, stop))
            else:
                t0 = time.perf_counter()
                yield
                dt = time.perf_counter() - t0
                self._stage_times[name] = self._stage_times.get(name, 0.0) + dt

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.array(x, np.float32), device=self.device)

    def _noise(self, given, shape, gen: torch.Generator) -> torch.Tensor:
        """An injected draw (checked against `shape`), or one from `gen`."""
        if given is None:
            return torch.randn(shape, generator=gen, device=self.device)
        t = self._tensor(given)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"injected noise shape {tuple(t.shape)} != {tuple(shape)}")
        return t

    def _latent_size(self) -> int:
        return self.cfg.image_size // (2 ** (len(self.cfg.vae.block_out_channels) - 1))

    # ------------------------------------------------------------ prompts

    def _clip_ids(self, clip_tok, prompt: str, length: int, eos: Optional[int]):
        """Token ids for a CLIP text encoder: the BPE tokenizer when its
        vocab is on disk, the byte tokenizer otherwise."""
        with profiling.span("tokenize"):
            if clip_tok is not None:
                ids = np.asarray([clip_tok.encode_padded(prompt, length)], np.int32)
            else:
                ids = _tokenize_pad(self.tokenizer, prompt, length, eos)
            return torch.as_tensor(ids, device=self.device)

    def _encode_sdxl_prompt(self, prompt: str):
        c = self.cfg
        ids1 = self._clip_ids(self.clip_tok1, prompt, c.text1.max_positions, c.text1.eos_token_id)
        ids2 = self._clip_ids(self.clip_tok2, prompt, c.text2.max_positions, c.text2.eos_token_id)
        return self._encode_sdxl_ids(ids1, ids2)

    def _encode_sdxl_ids(self, ids1: torch.Tensor, ids2: torch.Tensor):
        """`sampler.encode_prompt_sdxl`, each tower looked up just before it
        runs: a staged store may evict text1 while text2 loads."""
        c = self.cfg
        o1 = clip_lib.text_apply(self.models["text1"], ids1, c.text1)
        o2 = clip_lib.text_apply(self.models["text2"], ids2, c.text2)
        return sampler_lib.sdxl_prompt_embeds(o1, o2)

    def _encode_prior_text(self, prompt: str = ""):
        """CLIP-ViT-H last hidden state of `prompt` and its mask: only the
        tokens up to the first EOS count (the reference pads batch-longest;
        CLIP is causal, so masking the pads is the same)."""
        c = self.cfg
        ids = self._clip_ids(self.prior_tok, prompt, c.prior.text_len, c.prior_text.eos_token_id)
        hidden = clip_lib.text_apply(self.models["prior_text"], ids, c.prior_text)["last_hidden_state"]
        eos = c.prior_text.eos_token_id
        arr = ids[0].cpu().numpy()
        hits = np.nonzero(arr == eos)[0] if eos is not None else []
        n = int(hits[0]) + 1 if len(hits) else arr.shape[0]
        mask = (np.arange(arr.shape[0]) < n).astype(np.float32)[None]
        return hidden, torch.as_tensor(mask, device=self.device)

    # -------------------------------------------------------- conditioning

    def _embed_media(self, item: dict) -> torch.Tensor:
        """One mm_data entry → (1, 1024) ImageBind-space embedding, from a
        precomputed 'embed' or from the file under 'fname'."""
        if "embed" in item:
            return self._tensor(item["embed"]).reshape(1, -1)
        fpath = item["fname"]
        if item["type"] == "image":
            c = self.cfg.imagebind_vision
            size = c.image_size or 224
            x = cached(fpath, ("ib_vis", size),
                       lambda: imagebind_lib.preprocess_vision(image_io.load_image(fpath), size))
            return imagebind_lib.apply(self.models["imagebind_vision"], x, c).float()
        if item["type"] == "audio":
            c = self.cfg.imagebind_audio
            clips = cached(fpath, "ib_aud", lambda: imagebind_lib.preprocess_audio(_load_wav(fpath)))
            emb = imagebind_lib.apply(self.models["imagebind_audio"], clips, c)
            return emb.float().mean(dim=0, keepdim=True)
        raise ValueError(item["type"])

    def embed_mm_data(self, mm_data: List[dict]) -> torch.Tensor:
        """mm_data → renormed (N, D) conditioning matrix (aux_info)."""
        embeds = [self._embed_media(r) for r in mm_data]
        aux = (torch.cat(embeds, dim=0) if embeds
               else torch.zeros((0, self.cfg.llm.image_codec_dim), device=self.device))
        return aux / (torch.linalg.vector_norm(aux, dim=-1, keepdim=True) + 1e-9) * self.cfg.embed_norm

    # ---------------------------------------------------------- LLM stage

    def _prepare_llm_inputs(self, inst: str, aux_info: torch.Tensor):
        """instruction + conditioning → (input_ids, spliced embeds)."""
        conv = conv_templates["vicuna_v1"].copy()
        conv.append_message(conv.roles[0], inst)
        conv.append_message(conv.roles[1], None)
        with profiling.span("tokenize"):
            input_ids = np.asarray([self.tokenizer(conv.get_prompt()).input_ids], np.int64)
        types = torch.full((aux_info.shape[0],), REPLACEMENT_TYPE.INPUT, dtype=torch.int32)
        llm = self.models["llm"]
        embeds = mm_lib.splice_input_embeds(
            llm, self.cfg.llm, torch.as_tensor(input_ids, device=self.device),
            aux_info.to(llm.llama.embed_tokens.weight.dtype), types,
        )
        return input_ids, embeds

    @torch.inference_mode()
    def forward_llm(
        self,
        inst: str,
        mm_data: List[dict] = [],
        use_cache: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """→ (image_embeds, base_embed, caption, base_img_path, extra_data),
        or (None, None, caption, None, None) when the LLM emitted no
        generation tokens. Samples at temperature 0.3 from `generator`
        (one seeded at random without it), up to 100 tokens, stopping at
        EOS; with `cfg.llm_speculative_layers > 0` decodes greedily by
        self-speculative decoding instead."""
        if use_cache and self.cache is not None:
            return self.cache
        with self._stage("imagebind_encode"):
            aux_info = self.embed_mm_data(mm_data)
        input_ids, inputs_embeds = self._prepare_llm_inputs(inst, aux_info)
        eos_id = getattr(self.tokenizer, "eos_token_id", 2)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(int(np.random.randint(0, 2**31)))
        with self._stage("llm_generate"):
            if self.cfg.llm_speculative_layers > 0:
                self.last_rounds = []
                result = spec_lib.generate_speculative(
                    self.models["llm"].llama, self.cfg.llm.llama, inputs_embeds,
                    max_new_tokens=100, eos_id=eos_id,
                    draft_layers=self.cfg.llm_speculative_layers, rounds=self.last_rounds,
                )
            else:
                result = gen_lib.generate(
                    self.models["llm"].llama, self.cfg.llm.llama, inputs_embeds, generator,
                    max_new_tokens=100, temperature=0.3, eos_id=eos_id, bucket=64,
                    dynamic_stop=True,
                )
        self.last_generate = result
        n_out = min(int(result.done_at[0]) + 1, result.tokens.shape[1])
        out = self._postprocess_llm(
            result.tokens[0, :n_out].cpu().numpy(), result.hiddens[0, :n_out],
            input_ids, aux_info, mm_data,
        )
        self.cache = out
        return out

    def _predict(self, hidden: torch.Tensor) -> np.ndarray:
        return mm_lib.predict_image_embedding(self.models["llm"], hidden).float().cpu().numpy()

    def _postprocess_llm(self, out_seq: np.ndarray, hiddens: torch.Tensor, input_ids, aux_info,
                         mm_data):
        """Token bookkeeping after generation: where the generation token
        is, the predictor readouts, the base selection, subject parsing
        and the caption."""
        full_text = self.tokenizer.decode(list(input_ids[0]) + list(out_seq))
        vid_id = self.token_ids[C.DEFAULT_VIDEO_TOKEN]
        im_gen_id = self.token_ids[C.DEFAULT_IM_GEN_TOKEN]
        base_id = self.token_ids[C.DEFAULT_BASE_TOKEN]

        im_gen_pos = np.where(out_seq == im_gen_id)[0]
        all_gen = np.empty((0,), np.int64)
        if len(im_gen_pos):
            all_gen = np.where(out_seq == vid_id)[0]
            all_gen = all_gen[all_gen > im_gen_pos[-1]]
        if len(all_gen) == 0:
            # no usable generation tokens: caption only
            return None, None, full_text.split("ASSISTANT:")[-1], None, None
        gen_idx = int(all_gen[0])
        remaining = all_gen[1:]

        image_embeds = self._predict(hiddens[gen_idx][None])
        extra_embeds = (
            np.concatenate([self._predict(hiddens[int(i)][None]) for i in remaining])
            if len(remaining) else np.zeros((0, image_embeds.shape[-1]), np.float32)
        )
        aux_np = aux_info.float().cpu().numpy()
        if len(mm_data) == 1:
            base_idx = 0
            base_embed = aux_np[0]
        else:
            base_pos = np.where(out_seq == base_id)[0]
            if len(base_pos) and base_pos[0] + 1 < len(out_seq):
                base_pred = self._predict(hiddens[int(base_pos[0]) + 1][None])[0]
                sims = (base_pred / (np.linalg.norm(base_pred) + 1e-9) * self.cfg.embed_norm) @ aux_np.T
                base_idx = int(np.argmax(sims))
                # several inputs: the predicted base embedding itself is
                # returned; the cosine argmax only picks the source file
                base_embed = base_pred
            else:
                base_idx = 0
                base_embed = aux_np[base_idx] if len(aux_np) else np.zeros_like(image_embeds[0])
        base_img_path = mm_data[base_idx]["fname"] if mm_data else None

        all_objs = self.get_all_objs(full_text)
        if len(all_objs) != len(extra_embeds):
            all_objs = []
        extra_idx: Any = []
        if all_objs:
            sims = (extra_embeds / (np.linalg.norm(extra_embeds) + 1e-9) * self.cfg.embed_norm) @ aux_np.T
            extra_idx = np.argmax(sims, axis=1)
            extra_embeds = aux_np[extra_idx]
        caption_groups = re.findall(r"\[([^\]]+)\]", full_text)
        caption = caption_groups[0] if caption_groups else full_text.split("ASSISTANT:")[-1]
        extra_data = dict(all_objs=all_objs, extra_embeds=extra_embeds, extra_idx=extra_idx)
        return (self._tensor(image_embeds), self._tensor(base_embed), caption, base_img_path,
                extra_data)

    @staticmethod
    def get_all_objs(s: str) -> List[str]:
        """Parse the `additions:<name>:<video>.` subject suffix."""
        matched = re.findall(r"additions:(.*?)(?:\</s\>|$)", s, re.DOTALL)
        if not matched or not matched[0]:
            return []
        return re.findall(r"([^:]+):<video>", matched[0])

    def load_base_img(self, base_img_path) -> np.ndarray:
        with profiling.span("load_base_img"):
            if isinstance(base_img_path, (str, bytes)):
                return cached(base_img_path, ("base", self.cfg.image_size),
                              lambda: image_io.resize_and_crop(base_img_path, self.cfg.image_size))
            return image_io.resize_and_crop(base_img_path, self.cfg.image_size)

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
        h = self._latent_size()
        lat = self._noise(latents, (1, h, h, 4), torch.Generator(self.device).manual_seed(seed))
        ip_cond = ip_uncond = None
        if ip_embeds is not None:
            ip_cond, ip_uncond = ipa.get_image_embeds(
                self.models["image_proj"], c.image_proj,
                clip_image_embeds=self._tensor(ip_embeds).reshape(1, -1), mode="global",
            )
        lat = sampler_lib.denoise(
            self.models["unet"], c.unet, self.schedule, lat, ctx_p, ctx_n, pooled_p,
            pooled_n, tid, num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, ip_tokens=ip_cond, ip_tokens_uncond=ip_uncond,
            ip_scale=ip_scale,
        )
        img = vae_lib.decode(self.models["vae"], lat, c.vae)
        return image_io.from_model_range(img[0].float().cpu().numpy())

    # ------------------------------------------------------------- __call__

    @_request_span
    @torch.inference_mode()
    def __call__(
        self,
        inst: str,
        mm_data: List[dict],
        alpha: float = 0.7,
        h: Tuple[float, float, float] = (0.0, 0.4, 1.0),
        norm: float = 20.0,
        refinement: float = 0.5,
        llm_only: bool = False,
        num_inference_steps: int = 25,
        use_cache: bool = False,
        debug: bool = False,
        diffusion_mode: str = "default",
        subject_strength: float = 0.0,
        cfg: float = 10,
        scale: float = 1.0,
        seed: Optional[int] = None,
        vae_noise=None,
        polar_noise=None,
        refiner_vae_noise=None,
        refiner_noise=None,
        subject_noise=None,
        lcm_noise=None,
    ) -> Any:
        """The edit → (non_refined, refined, "SUCCESS!") uint8 images, or
        (None, None, caption) with `llm_only` or when the LLM asked for no
        image. With `subject_strength > 0` each image subject the LLM named
        is repainted into the refined image (IP-Adapter local mode).
        `diffusion_mode="ipa_lcm"` denoises in 4 LCM steps at guidance 1.0
        (it needs LCM-distilled UNet weights for quality); `lcm_noise`
        (4, 1, h, w, 4) injects their draws. `debug=True` returns, in place
        of "SUCCESS!", the JAX pipeline's dict: `attn_maps` (n_ip, H, W)
        from one more conditioned UNet forward at the final latent with the
        IP attention tap on (timestep 0; `stage_times["debug_tap"]`),
        `output_caption`, `latent_inv`, `img_base`, `latent_la`,
        `base_embed`, `annotations`, `subjec_data` (the reference's key) and
        `y` (the prior's output over its norm); the images are the same."""
        c = self.cfg
        seed = seed if seed is not None else int(np.random.randint(0, 2**31))
        gen = torch.Generator(self.device).manual_seed(seed)

        image_embeds, base_embed, caption, base_img_path, extra_data = self.forward_llm(
            inst, mm_data, use_cache=use_cache, generator=gen
        )
        self.cache = (image_embeds, base_embed, caption, base_img_path, extra_data)
        if llm_only or image_embeds is None:
            return None, None, caption
        image_embeds, base_embed = self._tensor(image_embeds), self._tensor(base_embed)

        # prior refinement
        with self._stage("prior"):
            th, tm = self._encode_prior_text("")
            src = image_embeds / (torch.linalg.vector_norm(image_embeds) + 1e-9) * 100.0
            y = prior_lib.generate_diffusion(
                self.models["prior"], c.prior, MODALITY.VIDEO, MODALITY.IMAGE,
                src.reshape(1, -1), th, tm, guidance_scale=10.0, score=6.5, no_diffusion=True,
            )[:, 0].float()
        latent_la = sampler_lib.mix_latents(
            base_embed.reshape(1, -1), image_embeds.reshape(1, -1),
            y / (torch.linalg.vector_norm(y) + 1e-9), h, norm,
        )

        # DDIM inversion of the base image
        hl = self._latent_size()
        with self._stage("vae_encode"):
            img_base = self.load_base_img(base_img_path)
            x = torch.as_tensor(image_io.to_model_range(img_base)[None], device=self.device)
            src_lat = vae_lib.encode(self.models["vae"], x,
                                     self._noise(vae_noise, (1, hl, hl, 4), gen), c.vae).float()
        ctx_null, pooled_null = self._encode_sdxl_prompt("")
        tid = sampler_lib.default_time_ids(c.image_size, c.image_size, 1, self.device)
        with self._stage("ddim_inversion"):
            latent_inv = sampler_lib.ddim_invert(
                self.models["unet"], c.unet, self.schedule, src_lat, ctx_null, pooled_null, tid,
                num_inference_steps=num_inference_steps,
            )
        latent_inv = sampler_lib.polar_interpolate(
            latent_inv, self._noise(polar_noise, tuple(latent_inv.shape), gen), alpha
        )

        # IP-Adapter global-mode generation
        ctx_p, pooled_p = self._encode_sdxl_prompt("best quality, high quality" + caption)
        ip_cond, ip_uncond = ipa.get_image_embeds(
            self.models["image_proj"], c.image_proj, clip_image_embeds=latent_la, mode="global"
        )
        with self._stage("denoise"):
            if diffusion_mode == "ipa_lcm":
                eps_fn = sampler_lib.make_cfg_eps_fn(
                    self.models["unet"], c.unet, ctx_p, ctx_null, pooled_p, pooled_null, tid,
                    guidance_scale=1.0, ip_tokens=ip_cond, ip_tokens_uncond=ip_uncond,
                    ip_scale=scale,
                )
                ts = lcm_timesteps(self.schedule, LCM_NUM_STEPS)
                noise = self._noise(lcm_noise, (len(ts),) + tuple(latent_inv.shape), gen)
                lat = sampler_lib.loop_denoise_lcm(eps_fn, self.schedule, latent_inv, ts,
                                                   noise=noise)
            else:
                lat = sampler_lib.denoise(
                    self.models["unet"], c.unet, self.schedule, latent_inv, ctx_p, ctx_null,
                    pooled_p, pooled_null, tid, num_inference_steps=num_inference_steps,
                    guidance_scale=cfg, ip_tokens=ip_cond, ip_tokens_uncond=ip_uncond,
                    ip_scale=scale,
                )
        with self._stage("vae_decode"):
            img = vae_lib.decode(self.models["vae"], lat, c.vae)
            non_refined = _to_host(img)

        refined = non_refined
        if refinement > 0:
            refined = self._refine(caption, non_refined, gen, refinement, refiner_vae_noise,
                                   refiner_noise)

        annotations, subjects = None, []
        if subject_strength > 0 and len(extra_data["extra_idx"]) > 0:
            subjects = [
                {"name": k, "embed": v}
                for k, v, i in zip(extra_data["all_objs"], extra_data["extra_embeds"],
                                   extra_data["extra_idx"])
                if mm_data[int(i)]["type"] == "image"
            ]
            refined, annotations = grounding_lib.subject_consistency(
                subjects, caption, refined, self._timed("segmentation", self.segmentor),
                self._timed("grounding", self.grounder),
                self._make_inpaint_fn(gen, subject_strength, subject_noise), subject_strength,
                device=self.device,
            )
        if not debug:
            return non_refined, refined, "SUCCESS!"
        with self._stage("debug_tap"):
            # the reference's attention-map tap: one more conditioned UNet
            # forward at the final latent, IP probabilities captured per layer
            _, taps = unet_lib.apply(
                self.models["unet"], lat, torch.zeros((1,), dtype=torch.long), ctx_p, c.unet,
                pooled_text=pooled_p, time_ids=tid, ip_tokens=ip_cond, ip_scale=scale,
                capture_ip_attn=True,
            )
            attn_maps = ipa.aggregate_attn_maps(taps, (c.image_size, c.image_size), batch_index=0)
        return non_refined, refined, dict(
            attn_maps=attn_maps, output_caption=caption, latent_inv=latent_inv,
            img_base=img_base, latent_la=latent_la, base_embed=base_embed,
            annotations=annotations,
            subjec_data=subjects,  # the reference's key name
            y=y / (torch.linalg.vector_norm(y) + 1e-9),
        )

    def _timed(self, stage: str, fn):
        def call(*args, **kwargs):
            with self._stage(stage):
                return fn(*args, **kwargs)

        return call

    def _refine(self, caption, non_refined, gen, refinement, refiner_vae_noise, refiner_noise):
        """The SDXL refiner: img2img on its fixed 50-step grid."""
        c = self.cfg
        hl = self._latent_size()
        rprompt = caption + ",high quality,well-formed,award-winning"
        o2 = clip_lib.text_apply(
            self.models["text2"],
            self._clip_ids(self.clip_tok2, rprompt, c.text2.max_positions, c.text2.eos_token_id),
            c.text2,
        )
        o2n = clip_lib.text_apply(
            self.models["text2"],
            self._clip_ids(self.clip_tok2, "", c.text2.max_positions, c.text2.eos_token_id),
            c.text2,
        )
        # the refiner's time ids carry the aesthetic score (6.0 cond, 2.5 uncond)
        rtid = torch.tensor([[c.image_size, c.image_size, 0, 0, 6.0]], device=self.device)
        rtid_u = torch.tensor([[c.image_size, c.image_size, 0, 0, 2.5]], device=self.device)
        with self._stage("refiner_vae_encode"):
            xr = torch.as_tensor(image_io.to_model_range(non_refined)[None], device=self.device)
            rlat = vae_lib.encode(self.models["vae"], xr,
                                  self._noise(refiner_vae_noise, (1, hl, hl, 4), gen), c.vae).float()
        with self._stage("refiner"):
            rlat = i2i.img2img(
                self.models["refiner"], c.refiner, self.schedule, rlat,
                o2["hidden_states"][-2], o2n["hidden_states"][-2],
                o2.get("text_embeds", o2["pooled"]), o2n.get("text_embeds", o2n["pooled"]),
                rtid, num_inference_steps=REFINER_NUM_STEPS, strength=refinement,
                guidance_scale=5.0, time_ids_uncond=rtid_u,
                noise=self._noise(refiner_noise, tuple(rlat.shape), gen),
            )
        with self._stage("refiner_vae_decode"):
            rimg = vae_lib.decode(self.models["vae"], rlat, c.vae)
            return _to_host(rimg)

    def _make_inpaint_fn(self, gen: torch.Generator, strength: float, subject_noise=None):
        """inpaint_fn(image, mask, subject_embed, prompt) → uint8 image for
        `grounding.lib.subject_consistency`: the caption as prompt, an empty
        negative prompt, guidance 7.5, the subject embedding as IP-Adapter
        local tokens at scale 0.8, `strength` of the 50-step grid. Each call
        takes the next dict of `subject_noise` (keys "vae", "masked_vae",
        "inpaint"), or draws from `gen` in that order."""
        c = self.cfg
        hl = self._latent_size()
        draws = iter(subject_noise or [])

        def inpaint_fn(image: np.ndarray, mask: np.ndarray, subject_embed, prompt: str):
            noise = next(draws, {})
            with self._stage("inpaint_vae_encode"):
                x = torch.as_tensor(image_io.to_model_range(image)[None], device=self.device)
                m = torch.as_tensor(np.asarray(mask, np.float32), device=self.device)[None, :, :, None]
                lat = vae_lib.encode(self.models["vae"], x,
                                     self._noise(noise.get("vae"), (1, hl, hl, 4), gen), c.vae).float()
                masked_lat = vae_lib.encode(
                    self.models["vae"], x * (1.0 - m),
                    self._noise(noise.get("masked_vae"), (1, hl, hl, 4), gen), c.vae).float()
            ctx_p, pooled_p = self._encode_sdxl_prompt(prompt)
            ctx_n, pooled_n = self._encode_sdxl_prompt("")
            tid = sampler_lib.default_time_ids(c.image_size, c.image_size, 1, self.device)
            ip_cond, ip_uncond = ipa.get_image_embeds(
                self.models["image_proj"], c.image_proj,
                clip_image_embeds_local=self._tensor(subject_embed).reshape(1, -1), mode="local",
            )
            with self._stage("inpaint"):
                # looked up here: a staged store may have evicted it since
                unet = self.models["inpaint_unet" if "inpaint_unet" in self.models else "unet"]
                out = i2i.inpaint(
                    unet, c.inpaint_unet, self.schedule, lat, m, masked_lat, ctx_p, ctx_n,
                    pooled_p, pooled_n, tid, num_inference_steps=INPAINT_NUM_STEPS,
                    strength=strength, guidance_scale=7.5, ip_tokens=ip_cond,
                    ip_tokens_uncond=ip_uncond, ip_scale=0.8,
                    noise=self._noise(noise.get("inpaint"), (1, hl, hl, 4), gen),
                )
            with self._stage("inpaint_vae_decode"):
                img = vae_lib.decode(self.models["vae"], out, c.vae)
                return _to_host(img)

        return inpaint_fn


def _to_host(img: torch.Tensor) -> np.ndarray:
    """The first image of a decoded batch as (H, W, 3) uint8 on the host."""
    with profiling.span("to_host", rows=1):
        return image_io.from_model_range(img[0].float().cpu().numpy())


def _resample_linear(data: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Linear-interpolation resample (mono)."""
    if sr == target_sr or data.size == 0:
        return data
    n_out = int(round(data.size * target_sr / sr))
    xp = np.arange(data.size, dtype=np.float64) / sr
    x = np.arange(n_out, dtype=np.float64) / target_sr
    return np.interp(x, xp, data).astype(np.float32)


def _decode_wav(path: str) -> Tuple[np.ndarray, int]:
    import wave

    with wave.open(path) as w:
        frames = w.readframes(w.getnframes())
        dtype = {1: np.int8, 2: np.int16, 4: np.int32}[w.getsampwidth()]
        data = np.frombuffer(frames, dtype=dtype).astype(np.float32)
        data /= float(np.iinfo(dtype).max)
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels()).mean(axis=1)
        return data, w.getframerate()


def _load_wav(path: str, target_sr: int = 16000) -> np.ndarray:
    """Audio for mm_data entries at `target_sr` (ImageBind's 16 kHz): .npy
    as it is, WAV through the standard library, other formats through an
    ffmpeg subprocess."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith(".wav"):
        data, sr = _decode_wav(path)
        return _resample_linear(data, sr, target_sr)
    import shutil
    import subprocess
    import tempfile

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(f"cannot decode {path!r}: not .wav/.npy and no ffmpeg on PATH")
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "decoded.wav")
        subprocess.run(
            [ffmpeg, "-i", path, "-hide_banner", "-loglevel", "panic",
             "-f", "wav", "-vn", "-ac", "1", "-ar", str(target_sr), "-y", out],
            check=True,
        )
        data, sr = _decode_wav(out)
    return _resample_linear(data, sr, target_sr)


def preprocess_mm_data(mm_data):
    """Normalize user mm_data entries to {type, fname} dicts."""
    out = []
    for r in mm_data:
        if isinstance(r, dict):
            out.append(r)
        else:
            t = "audio" if str(r).endswith((".wav", ".mp3", ".flac")) else "image"
            out.append({"type": t, "fname": r})
    return out
