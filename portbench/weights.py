"""Seeded weights in each published checkpoint's key layout, made on the
device.

Each module of a configuration is drawn from a generator of its own,
seeded from the run's seed and the module's place (`_seed`), with one
`torch.randn` call for all of its weight matrices, in the dtype they are
served in. The initializers are fan-in-scaled normals (linear N(0,1)/√in,
conv N(0,1)/√(in·k·k), embeddings N(0,1)·0.02), zero biases and free
parameters, unit norm gains, so activations stay in range through many
denoising steps. A module is drawn in the reference's parameter layout and
written under the published keys through the reference's key maps; the
same call made again gives the same tensors, so the reference can draw a
module anew once the measured window is over.

The module table (`modules`) and the read-back key maps
(`reference_keymaps`) are the edit's unless a configuration kind passes
its own. The edit's published files: "unet" (diffusers `unet/`),
"ip_adapter" (`ip_adapter_global_local_2_view.bin`: the UNet's
`to_k_ip`/`to_v_ip` and `image_proj.*`), "refiner", "vae",
"text_encoder", "text_encoder_2", "clip-vit-h" and "prior"
(`prior/model.bin`).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from .reference import clip as clip_lib
from .reference import ip_adapter as ipa
from .reference import prior as prior_lib
from .reference import unet as unet_lib
from .reference import unet_convert
from .reference import vae as vae_lib
from .reference.checkpoint import KeyMap

Published = Dict[str, Dict[str, torch.Tensor]]  # file → {published key: tensor}
# module → (its reference module's maker, named tensors → published files)
Table = Dict[str, Tuple[Callable[[], nn.Module], Callable]]
# module → the (file, key map, name prefix) parts it is read back from
KeyMaps = Dict[str, List[Tuple[str, KeyMap, str]]]


def _ip_split(cfgs) -> Callable[[Dict[str, torch.Tensor]], Published]:
    def split(named):
        ip = {n: t for n, t in named.items() if "_ip." in n}
        rest = {n: t for n, t in named.items() if n not in ip}
        km = ipa.ip_attn_keymap(unet_convert.cross_attn_paths(cfgs["unet"]))
        return {"unet": unet_convert.unet_keymap().to_ref(rest), "ip_adapter": km.to_ref(ip)}

    return split


def _one(file: str, km: KeyMap, prefix: str = "") -> Callable:
    return lambda named: {file: km.to_ref({prefix + n: t for n, t in named.items()})}


def modules(cfgs) -> Table:
    """The edit's module table, in `MODULE_ORDER`. `cfgs` maps a component
    to its configuration dataclass."""
    text = clip_lib.text_keymap()
    return {
        "unet": (lambda: unet_lib.UNet(cfgs["unet"]), _ip_split(cfgs)),
        "image_proj": (lambda: ipa.ImageProj(cfgs["image_proj"]),
                       _one("ip_adapter", ipa.image_proj_keymap().prefixed(port="image_proj."),
                            "image_proj.")),
        "refiner": (lambda: unet_lib.UNet(cfgs["refiner"]),
                    _one("refiner", unet_convert.unet_keymap())),
        "vae": (lambda: vae_lib.VAE(cfgs["vae"]), _one("vae", unet_convert.vae_keymap())),
        "text1": (lambda: clip_lib.CLIPText(cfgs["text1"]), _one("text_encoder", text)),
        "text2": (lambda: clip_lib.CLIPText(cfgs["text2"]), _one("text_encoder_2", text)),
        "prior_text": (lambda: clip_lib.CLIPText(cfgs["prior_text"]), _one("clip-vit-h", text)),
        "prior": (lambda: prior_lib.Prior(cfgs["prior"], output_proj=cfgs["prior_output_proj"]),
                  _one("prior", prior_lib.keymap())),
    }


MODULE_ORDER = ("unet", "image_proj", "refiner", "vae", "text1", "text2", "prior_text", "prior")


def _plan(m: nn.Module) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, kind, scale) per parameter, kind "normal", "zeros" or
    "ones"."""
    names = {id(p): n for n, p in m.named_parameters()}
    out = []
    for mod in m.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            out.append((names[id(mod.weight)], tuple(mod.weight.shape), "normal",
                        mod.weight[0].numel() ** -0.5))
            if mod.bias is not None:
                out.append((names[id(mod.bias)], tuple(mod.bias.shape), "zeros", 0.0))
        elif isinstance(mod, nn.Embedding):
            out.append((names[id(mod.weight)], tuple(mod.weight.shape), "normal", 0.02))
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            out.append((names[id(mod.weight)], tuple(mod.weight.shape), "ones", 0.0))
            out.append((names[id(mod.bias)], tuple(mod.bias.shape), "zeros", 0.0))
        else:
            for _, p in mod.named_parameters(recurse=False):
                out.append((names[id(p)], tuple(p.shape), "ones" if type(mod).__name__ == "RMSNorm"
                            else "zeros", 0.0))
    return out


def _seed(seed: int, module: str, order: Tuple[str, ...] = MODULE_ORDER) -> int:
    """The generator's seed of `module`: from its place in `MODULE_ORDER`,
    or, for a module of another kind, from its place in that kind's
    `order` past the edit's modules, so that it shares no generator with
    one of them."""
    place = (MODULE_ORDER.index(module) if module in MODULE_ORDER
             else len(MODULE_ORDER) + order.index(module))
    return (int(seed) * 1_000_003 + place * 7919 + 1) % (2**63 - 1)


@torch.no_grad()
def draw(module: str, cfgs, seed: int, device, dtype=torch.bfloat16,
         table: Optional[Table] = None) -> Published:
    """One module's published files, drawn on `device` in `dtype`, from
    `table` (by default the edit's), whose order places its modules."""
    table = modules(cfgs) if table is None else table
    make, publish = table[module]
    with torch.device("meta"):
        m = make()
    plan = _plan(m)
    dev = torch.device(device)
    n_normal = sum(torch.Size(s).numel() for _, s, kind, _ in plan if kind == "normal")
    gen = torch.Generator(dev).manual_seed(_seed(seed, module, tuple(table)))
    flat = torch.randn(n_normal, generator=gen, device=dev, dtype=dtype)
    named, off = {}, 0
    for name, shape, kind, scale in plan:
        if kind == "normal":
            n = torch.Size(shape).numel()
            named[name] = flat[off:off + n].view(shape).mul_(scale)
            off += n
        elif kind == "ones":
            named[name] = torch.ones(shape, device=dev, dtype=dtype)
        else:
            named[name] = torch.zeros(shape, device=dev, dtype=dtype)
    return publish(named)


def draw_all(names: Iterable[str], cfgs, seed: int, device, dtype=torch.bfloat16,
             table: Optional[Table] = None) -> Published:
    out: Published = {}
    for name in names:
        for file, tensors in draw(name, cfgs, seed, device, dtype, table).items():
            out.setdefault(file, {}).update(tensors)
    return out


def reference_keymaps(cfgs) -> KeyMaps:
    """The edit's modules → the (file, key map, name prefix) parts to read
    each back from."""
    text = clip_lib.text_keymap()
    ip = ipa.ip_attn_keymap(unet_convert.cross_attn_paths(cfgs["unet"]))
    return {
        "refiner": [("refiner", unet_convert.unet_keymap(), "")],
        "vae": [("vae", unet_convert.vae_keymap(), "")],
        "text1": [("text_encoder", text, "")],
        "text2": [("text_encoder_2", text, "")],
        "prior_text": [("clip-vit-h", text, "")],
        "prior": [("prior", prior_lib.keymap(), "")],
        "image_proj": [("ip_adapter", ipa.image_proj_keymap().prefixed(port="image_proj."),
                        "image_proj.")],
        "unet": [("unet", unet_convert.unet_keymap(), ""), ("ip_adapter", ip, "")],
    }


@torch.no_grad()
def reference_module(module: str, cfgs, seed: int, device, table: Optional[Table] = None,
                     keymaps: Optional[KeyMaps] = None) -> nn.Module:
    """The reference's float32 module, from the same draw (in the dtype
    the configuration serves) read back through the reference's key maps;
    `table` and `keymaps` are the edit's unless given."""
    table = modules(cfgs) if table is None else table
    make, _ = table[module]
    files = draw(module, cfgs, seed, device, cfgs["dtype"], table)
    kms = reference_keymaps(cfgs) if keymaps is None else keymaps
    named: Dict[str, torch.Tensor] = {}
    for file, km, prefix in kms[module]:
        part = {k: v for k, v in files[file].items() if km._match_ref(k) is not None}
        named.update({n[len(prefix):]: t for n, t in km.to_port(part, what=file).items()})
    with torch.device("meta"):
        m = make()
    m = m.to_empty(device=torch.device(device)).float()
    m.load_state_dict(named, strict=True)
    del files, named
    return m.eval().requires_grad_(False)
