"""VQ-GAN adversarial training: the PatchGAN discriminator and the losses,
counterpart of the JAX package's `codecs/vqgan_train.py`.

An N-layer PatchGAN discriminator (GroupNorm in place of BatchNorm), hinge
and vanilla GAN losses, the generator objective with its discriminator
warm-up, the discriminator-free and segmentation objectives. Gradients come
from autograd; `jax.lax.stop_gradient` is `detach`. The perceptual term
takes any feature-map callable. As in JAX, the generator's adversarial
weight is the fixed `disc_weight` gated by `adopt_weight`, not an adaptive
(gradient-norm) weight.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models import layers as L
from . import vqgan


@dataclasses.dataclass(frozen=True)
class DiscConfig:
    in_channels: int = 3
    base_ch: int = 64
    n_layers: int = 3

    @staticmethod
    def tiny(in_channels: int = 3) -> "DiscConfig":
        return DiscConfig(in_channels=in_channels, base_ch=8, n_layers=2)


def _width(cfg: DiscConfig, i: int) -> int:
    return min(cfg.base_ch * (2**i), cfg.base_ch * 8)


class Discriminator(nn.Module):
    """NLayerDiscriminator (PatchGAN): 4×4 convs, stride 2 but the last two,
    channels doubling up to 8× the base."""

    def __init__(self, cfg: DiscConfig = DiscConfig()):
        super().__init__()
        self.cfg = cfg
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.base_ch, 4)
        ch = cfg.base_ch
        for i in range(1, cfg.n_layers + 1):
            cout = _width(cfg, i)
            self.add_module(f"conv_{i}", nn.Conv2d(ch, cout, 4))
            self.add_module(f"norm_{i}", nn.GroupNorm(min(8, cout), cout, eps=1e-5))
            ch = cout
        self.conv_out = nn.Conv2d(ch, 1, 4)


def _conv_same(p: nn.Conv2d, x: torch.Tensor, stride: int) -> torch.Tensor:
    """XLA's SAME padding for a 4×4 kernel: total max((⌈n/s⌉−1)·s + k − n, 0)
    per side pair, the smaller half before."""
    k = p.weight.shape[-1]
    pads = []
    for n in (x.shape[2], x.shape[1]):  # W then H: F.pad's order from the last axis
        out = -(-n // stride)
        total = max((out - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(x, (0, 0, *pads))
    return L.conv2d(p, x, stride=stride, padding="VALID")


def disc_apply(params: Discriminator, x: torch.Tensor,
               cfg: Optional[DiscConfig] = None) -> torch.Tensor:
    """(B, H, W, C) image → (B, h', w', 1) patch logits."""
    cfg = cfg or params.cfg
    h = F.leaky_relu(_conv_same(params.conv_in, x, 2), 0.2)
    for i in range(1, cfg.n_layers + 1):
        stride = 2 if i < cfg.n_layers else 1
        h = _conv_same(getattr(params, f"conv_{i}"), h, stride)
        h = F.leaky_relu(L.group_norm(getattr(params, f"norm_{i}"), h), 0.2)
    return _conv_same(params.conv_out, h, 1)


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real)) + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.softplus(-logits_real)) + torch.mean(F.softplus(logits_fake)))


def generator_loss(logits_fake):
    return -torch.mean(logits_fake)


def adopt_weight(weight, step, threshold: int):
    """Zero the adversarial weight before `threshold` (disc_start) steps."""
    return 0.0 if step < threshold else weight


def vqgan_generator_loss(
    vq_params: vqgan.VQModel,
    disc_params: Discriminator,
    x: torch.Tensor,
    step: int,
    vq_cfg: vqgan.VQConfig,
    disc_cfg: Optional[DiscConfig] = None,
    perceptual_fn: Optional[Callable] = None,
    disc_start: int = 10000,
    disc_weight: float = 0.8,
    codebook_weight: float = 1.0,
    perceptual_weight: float = 1.0,
):
    """Generator objective: L1 reconstruction + perceptual + codebook and
    commitment + the warm-up-gated adversarial term. Returns (loss, aux)."""
    _, aux = vqgan.vq_losses(vq_params, x, vq_cfg, beta=0.25)
    recon = aux["recon"]
    loss = aux["rec_loss"] + codebook_weight * (aux["codebook_loss"] + 0.25 * aux["commit_loss"])
    if perceptual_fn is not None:
        pl_ = torch.mean(torch.abs(perceptual_fn(x) - perceptual_fn(recon)))
        loss = loss + perceptual_weight * pl_
        aux["perceptual_loss"] = pl_
    g_loss = generator_loss(disc_apply(disc_params, recon, disc_cfg))
    w = adopt_weight(disc_weight, step, disc_start)
    loss = loss + w * g_loss
    aux["g_loss"] = g_loss
    aux["adv_weight"] = w
    return loss, aux


def vqgan_nodisc_loss(
    vq_params: vqgan.VQModel,
    x: torch.Tensor,
    vq_cfg: vqgan.VQConfig,
    perceptual_fn: Optional[Callable] = None,
    codebook_weight: float = 1.0,
    perceptual_weight: float = 1.0,
):
    """Discriminator-free objective (SpecVQGAN's `VQNoDiscModel`): L1
    reconstruction + optional perceptual + codebook and commitment, one
    optimizer, no GAN branch. Returns (loss, aux)."""
    _, aux = vqgan.vq_losses(vq_params, x, vq_cfg, beta=0.25)
    loss = aux["rec_loss"] + codebook_weight * (aux["codebook_loss"] + 0.25 * aux["commit_loss"])
    if perceptual_fn is not None:
        pl_ = torch.mean(torch.abs(perceptual_fn(x) - perceptual_fn(aux["recon"])))
        loss = loss + perceptual_weight * pl_
        aux["perceptual_loss"] = pl_
    return loss, aux


def vq_segmentation_loss(
    vq_params: vqgan.VQModel,
    x_onehot: torch.Tensor,
    vq_cfg: vqgan.VQConfig,
    codebook_weight: float = 1.0,
):
    """Segmentation-map objective (`VQSegmentationModel` with taming's
    BCELossWithQuant): the codec autoencodes a (B, H, W, n_labels) one-hot
    map, the decoder's output is per-label logits, the reconstruction term
    is sigmoid BCE against the one-hot targets. Returns (loss, aux)."""
    z = vqgan.encode_z(vq_params, x_onehot, vq_cfg)
    zq, idx, (cb_loss, commit) = vqgan.quantize(vq_params, z)
    logits = vqgan.decode_z(vq_params, zq, vq_cfg)
    # max(l, 0) - l·t + log(1 + exp(-|l|)), the JAX expression
    bce = torch.mean(torch.clamp(logits, min=0.0) - logits * x_onehot
                     + torch.log1p(torch.exp(-torch.abs(logits))))
    loss = bce + codebook_weight * (cb_loss + 0.25 * commit)
    return loss, {"bce_loss": bce, "codebook_loss": cb_loss, "commit_loss": commit,
                  "logits": logits, "indices": idx}


def colorize_init(generator: torch.Generator, n_labels: int, device=None) -> torch.Tensor:
    """Random label → RGB projection (the reference's `colorize` buffer for
    segmentation previews), N(0, 1) from `generator`."""
    return torch.randn((n_labels, 3), generator=generator, device=device)


def segmentation_to_rgb(colorize: torch.Tensor, x_onehot: torch.Tensor,
                        from_logits: bool = False) -> torch.Tensor:
    """Label planes (one-hot, or logits whose argmax is taken) through the
    colorize matrix, min-max normalized per image to [-1, 1]."""
    if from_logits:
        n = x_onehot.shape[-1]
        x_onehot = F.one_hot(x_onehot.argmax(-1), n).to(x_onehot.dtype)
    rgb = torch.einsum("bhwl,lc->bhwc", x_onehot, colorize.to(x_onehot.dtype))
    lo = rgb.amin(dim=(1, 2, 3), keepdim=True)
    hi = rgb.amax(dim=(1, 2, 3), keepdim=True)
    return 2.0 * (rgb - lo) / torch.clamp(hi - lo, min=1e-6) - 1.0


def vqgan_discriminator_loss(
    disc_params: Discriminator,
    vq_params: vqgan.VQModel,
    x: torch.Tensor,
    step: int,
    vq_cfg: vqgan.VQConfig,
    disc_cfg: Optional[DiscConfig] = None,
    disc_start: int = 10000,
    loss_type: str = "hinge",
):
    with torch.no_grad():  # the reconstruction is a constant of this loss
        z = vqgan.encode_z(vq_params, x, vq_cfg)
        zq, _, _ = vqgan.quantize(vq_params, z)
        recon = vqgan.decode_z(vq_params, zq, vq_cfg)
    logits_real = disc_apply(disc_params, x, disc_cfg)
    logits_fake = disc_apply(disc_params, recon, disc_cfg)
    fn = hinge_d_loss if loss_type == "hinge" else vanilla_d_loss
    d_loss = fn(logits_real, logits_fake) * adopt_weight(1.0, step, disc_start)
    return d_loss, {"logits_real": torch.mean(logits_real),
                    "logits_fake": torch.mean(logits_fake)}
