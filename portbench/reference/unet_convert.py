"""Diffusers SDXL UNet and AutoencoderKL state dicts ↔ the port's `UNet`
and `VAE`, counterpart of the JAX package's `models/unet_convert.py`.

The port keeps torch's (out, in) linears and OIHW convs, so each rule is a
rename. `cross_attn_paths` lists the cross-attentions in diffusers'
`attn_processors` order (down blocks, then up blocks, then the mid block:
module registration order), the order the IP-Adapter checkpoint indexes
its processors by.
"""

from __future__ import annotations

from typing import List

from .checkpoint import KeyMap, Rule
from . import unet as unet_lib


def _wb(ref: str, port: str, leaves=("weight", "bias")) -> List[Rule]:
    return [Rule(f"{ref}.{leaf}", f"{port}.{leaf}") for leaf in leaves]


def _resnet(ref: str, port: str, time_emb: bool = True) -> List[Rule]:
    pairs = [("norm1", "norm1"), ("conv1", "conv1"), ("norm2", "norm2"), ("conv2", "conv2"),
             ("conv_shortcut", "shortcut")]
    if time_emb:
        pairs.append(("time_emb_proj", "time_emb"))
    return [r for a, b in pairs for r in _wb(f"{ref}.{a}", f"{port}.{b}")]


def _transformer(ref: str, port: str) -> List[Rule]:
    rules = []
    for a in ("norm", "proj_in", "proj_out"):
        rules += _wb(f"{ref}.{a}", f"{port}.{a}")
    tb, pb = f"{ref}.transformer_blocks.{{t}}", f"{port}.block_{{t}}"
    for a in ("norm1", "norm2", "norm3"):
        rules += _wb(f"{tb}.{a}", f"{pb}.{a}")
    for attn in ("attn1", "attn2"):
        for proj in ("to_q", "to_k", "to_v"):
            rules.append(Rule(f"{tb}.{attn}.{proj}.weight", f"{pb}.{attn}.{proj}.weight"))
        rules += _wb(f"{tb}.{attn}.to_out.0", f"{pb}.{attn}.to_out")
    # geglu: one projection, value half then gate half, as the port's ff_in
    rules += _wb(f"{tb}.ff.net.0.proj", f"{pb}.ff_in")
    rules += _wb(f"{tb}.ff.net.2", f"{pb}.ff_out")
    return rules


def unet_keymap() -> KeyMap:
    rules = _wb("conv_in", "conv_in") + _wb("conv_norm_out", "norm_out") + _wb("conv_out", "conv_out")
    for ref, port in (("time_embedding", "time_embed"), ("add_embedding", "add_embed")):
        rules += _wb(f"{ref}.linear_1", f"{port}.fc1") + _wb(f"{ref}.linear_2", f"{port}.fc2")
    rules += _resnet("down_blocks.{b}.resnets.{r}", "down_{b}.res_{r}")
    rules += _transformer("down_blocks.{b}.attentions.{a}", "down_{b}.attn_{a}")
    rules += _wb("down_blocks.{b}.downsamplers.0.conv", "down_{b}.down")
    rules += _resnet("mid_block.resnets.{r}", "mid.res_{r}")
    rules += _transformer("mid_block.attentions.0", "mid.attn")
    rules += _resnet("up_blocks.{b}.resnets.{r}", "up_{b}.res_{r}")
    rules += _transformer("up_blocks.{b}.attentions.{a}", "up_{b}.attn_{a}")
    rules += _wb("up_blocks.{b}.upsamplers.0.conv", "up_{b}.up")
    ignore = [(r"(time_proj|add_time_proj)\..*", "sinusoidal tables, recomputed")]
    return KeyMap(rules, ignore)


def _vae_attention(ref: str, port: str) -> List[Rule]:
    # current diffusers names (to_q, ...) and the legacy ones (query, ...)
    # both map; a file holds one set
    rules = _wb(f"{ref}.group_norm", f"{port}.norm")
    for names, ours in ((("to_q", "query"), "q"), (("to_k", "key"), "k"), (("to_v", "value"), "v"),
                        (("to_out.0", "proj_attn"), "o")):
        for a in names:
            rules += _wb(f"{ref}.{a}", f"{port}.{ours}")
    return rules


def vae_keymap() -> KeyMap:
    rules = []
    for side in ("encoder", "decoder"):
        for a, b in (("conv_in", "conv_in"), ("conv_norm_out", "norm_out"), ("conv_out", "conv_out")):
            rules += _wb(f"{side}.{a}", f"{side}.{b}")
        rules += _resnet(f"{side}.mid_block.resnets.{{r}}", f"{side}.mid.res_{{r}}", time_emb=False)
        rules += _vae_attention(f"{side}.mid_block.attentions.0", f"{side}.mid.attn")
    rules += _wb("quant_conv", "encoder.quant_conv") + _wb("post_quant_conv", "decoder.post_quant_conv")
    rules += _resnet("encoder.down_blocks.{b}.resnets.{r}", "encoder.down_{b}.res_{r}", time_emb=False)
    rules += _wb("encoder.down_blocks.{b}.downsamplers.0.conv", "encoder.down_{b}.down")
    rules += _resnet("decoder.up_blocks.{b}.resnets.{r}", "decoder.up_{b}.res_{r}", time_emb=False)
    rules += _wb("decoder.up_blocks.{b}.upsamplers.0.conv", "decoder.up_{b}.up")
    # legacy VAE resnets name the 1x1 shortcut nin_shortcut
    for side, blk in (("encoder", "down"), ("decoder", "up")):
        rules += _wb(f"{side}.{blk}_blocks.{{b}}.resnets.{{r}}.nin_shortcut",
                     f"{side}.{blk}_{{b}}.res_{{r}}.shortcut")
    return KeyMap(rules)


def cross_attn_paths(cfg: unet_lib.UNetConfig) -> List[str]:
    """Cross-attention (attn2) module paths in diffusers' attn_processors
    order: down blocks, up blocks, then the mid block; transformer blocks
    depth-first within."""
    paths = []
    for i, btype in enumerate(cfg.down_block_types):
        if btype != "CrossAttnDownBlock2D":
            continue
        for j in range(cfg.layers_per_block):
            for k in range(cfg.transformer_layers_per_block[i]):
                paths.append(f"down_{i}.attn_{j}.block_{k}.attn2")
    rev_types = list(reversed(cfg.down_block_types))
    rev_depth = list(reversed(cfg.transformer_layers_per_block))
    for i, btype in enumerate(rev_types):
        if btype != "CrossAttnDownBlock2D":
            continue
        for j in range(cfg.layers_per_block + 1):
            for k in range(rev_depth[i]):
                paths.append(f"up_{i}.attn_{j}.block_{k}.attn2")
    for k in range(cfg.transformer_layers_per_block[-1]):
        paths.append(f"mid.attn.block_{k}.attn2")
    return paths
