"""The audio codec stack of the port against the JAX package: the 1D VQ model
(forward, code indices, losses, gradients, the codec interface), the MelGAN
vocoder read raw from a weight-normed torch state dict (against
`convert_vocoder_from_torch`), LPAPS from an LPAPS-layout state dict
(against `convert_lpaps_from_torch`), and the wav → mel → VQ codes → mel →
wav round trip. Weights: seeded numpy draws in the JAX tree's layout, or a
torch module built from the public MelGAN and VGG definitions. CPU,
float32: code indices identical; values within TOL relative to the largest
element of the JAX result."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch_port_helpers import (assert_close, grad_close, grad_enabled,  # noqa: F401
                                one_torch_thread,
                                random_tree, randn, t)

from instructany2pix_tpu.codecs import audio as ja
from instructany2pix_tpu.codecs.processors import AudioVAEProcessor as JProc
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch.codecs import audio as ta
from instructany2pix_tpu_torch.codecs.processors import AudioVAEProcessor as TProc
from instructany2pix_tpu_torch.core import checkpoint as ckpt_lib
from instructany2pix_tpu_torch.models import layers as L

TOL = 1e-5  # float32 on both sides, sums in another order


def _port(cls, jcfg):
    return cls(**dataclasses.asdict(jcfg))


def _tree(init, cfg, seed):
    tree = random_tree(jax.eval_shape(lambda: init(jax.random.key(0), cfg)), seed)
    return jax.tree.map(jnp.asarray, tree), tree


CFG = ja.VQ1DConfig.tiny()
# compiled once for the whole file: JAX's eager convolutions compile op by op
_JVQ1D = jax.jit(lambda p, x: ja.vq1d_losses(p, x, CFG))


@pytest.fixture(scope="module")
def vq1d():
    params, tree = _tree(ja.vq1d_init, CFG, 0)
    return params, convert.vq1d(tree, _port(ta.VQ1DConfig, CFG))


def test_vq1d_forward_indices_and_losses(vq1d):
    params, module = vq1d
    x = randn(1, 2, 12, CFG.in_channels)
    tot_j, aux_j = _JVQ1D(params, x)
    tot_t, aux_t = ta.vq1d_losses(module, t(x), module.cfg)
    np.testing.assert_array_equal(aux_t["indices"].numpy(), np.asarray(aux_j["indices"]))
    for k in ("rec_loss", "codebook_loss", "commit_loss", "recon"):
        assert_close(aux_t[k], aux_j[k], TOL, 1, rel=True, what=k)
    assert_close(tot_t, tot_j, TOL, 1, rel=True, what="total")


def test_vq1d_gradients_match_jax_grad(vq1d, grad_enabled):
    params, module = vq1d
    x = randn(2, 2, 12, CFG.in_channels)
    want = jax.jit(jax.grad(lambda p, x: _JVQ1D(p, x)[0]))(params, x)
    m = module.requires_grad_(True)
    m.zero_grad()
    ta.vq1d_losses(m, t(x), m.cfg)[0].backward()
    got = convert.to_tree(m, grad=True)
    m.requires_grad_(False)
    assert grad_close(got, want, TOL, 2) == sum(1 for _ in m.parameters())


def test_vq1d_codec_interface(vq1d):
    """`VQ1DCodec` on JAX's `vq1d_losses`: the same codes, the frames the
    codebook rows, and decode_seq of codes or frames JAX's reconstruction."""
    params, module = vq1d
    mel = randn(3, 1, 10, CFG.in_channels)
    _, aux_j = _JVQ1D(params, mel)
    tc = ta.VQ1DCodec(module, module.cfg)
    zq_t, idx_t, n_t = tc.encode_seq(mel)
    assert n_t == 5
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(aux_j["indices"]))
    cb = np.asarray(params["codebook"]["w"])
    assert_close(zq_t, cb[np.asarray(aux_j["indices"])], TOL, 3, rel=True, what="z_q")
    assert_close(tc.decode_seq(idx_t), aux_j["recon"], TOL, 3, rel=True, what="from ids")
    assert_close(tc.decode_seq(zq_t), aux_j["recon"], TOL, 3, rel=True, what="from frames")


# ------------------------------------------------------------- MelGAN


def _torch_melgan(cfg, seed=0):
    """The public MelGAN Generator, every conv weight-normed, weights N(0, 0.05)."""
    from torch.nn.utils import weight_norm

    class ResnetBlock(nn.Module):
        def __init__(self, dim, dilation):
            super().__init__()
            self.block = nn.Sequential(
                nn.LeakyReLU(0.2), nn.ReflectionPad1d(dilation),
                weight_norm(nn.Conv1d(dim, dim, 3, dilation=dilation)),
                nn.LeakyReLU(0.2), weight_norm(nn.Conv1d(dim, dim, 1)))
            self.shortcut = weight_norm(nn.Conv1d(dim, dim, 1))

        def forward(self, x):
            return self.shortcut(x) + self.block(x)

    mult = 2 ** len(cfg.ratios)
    layers = [nn.ReflectionPad1d(3),
              weight_norm(nn.Conv1d(cfg.n_mel_channels, mult * cfg.ngf, 7, padding=0))]
    for r in cfg.ratios:
        layers += [nn.LeakyReLU(0.2), weight_norm(nn.ConvTranspose1d(
            mult * cfg.ngf, mult * cfg.ngf // 2, r * 2, stride=r, padding=r // 2 + r % 2,
            output_padding=r % 2))]
        layers += [ResnetBlock(mult * cfg.ngf // 2, 3**j) for j in range(cfg.n_residual_layers)]
        mult //= 2
    layers += [nn.LeakyReLU(0.2), nn.ReflectionPad1d(3),
               weight_norm(nn.Conv1d(cfg.ngf, 1, 7, padding=0)), nn.Tanh()]
    g = nn.Module()
    g.model = nn.Sequential(*layers)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in g.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return g.eval()


@pytest.mark.filterwarnings("ignore:.*weight_norm.*deprecated:FutureWarning")
@pytest.mark.parametrize("ratios,n_res", [((2, 2), 1), ((3, 2), 2)])
def test_vocoder_from_weight_normed_state_dict(ratios, n_res):
    """The raw torch dict: folded and read through `vocoder_keymap` by the
    port, through `convert_vocoder_from_torch` by JAX; an odd ratio takes
    the transposed conv's output padding."""
    jcfg = ja.VocoderConfig(n_mel_channels=6, ngf=2, n_residual_layers=n_res, ratios=ratios)
    tcfg = _port(ta.VocoderConfig, jcfg)
    g = _torch_melgan(jcfg)
    sd = {k: v.detach().clone() for k, v in g.state_dict().items()}
    assert any(k.endswith("weight_g") for k in sd)
    km = ta.vocoder_keymap(tcfg)
    with torch.device("meta"):
        m = ta.Vocoder(tcfg)
    m = L.materialize(m, torch.device("cpu"), torch.float32).eval().requires_grad_(False)
    ckpt_lib.load_module(m, km.to_port(ta.fold_weight_norm(sd), "melgan"), "melgan")
    params = ja.convert_vocoder_from_torch({k: v.numpy() for k, v in sd.items()}, jcfg)
    mel = randn(4, 2, 9, 6)
    with torch.no_grad():
        got = ta.vocoder_apply(m, t(mel), tcfg)
        ref = g.model(t(mel).transpose(1, 2))[:, 0]
    want = ja.vocoder_apply(params, jnp.asarray(mel), jcfg)
    assert tuple(got.shape) == want.shape == (2, 9 * tcfg.hop_length)
    assert_close(got, want, TOL, 4, rel=True, what="waveform vs JAX")
    assert_close(got, ref.numpy(), TOL, 4, rel=True, what="waveform vs torch")
    # the map read back: plain `weight` keys, every folded tensor
    back = km.to_ref(dict(m.named_parameters()))
    folded = ta.fold_weight_norm(sd)
    assert sorted(back) == sorted(folded)
    assert all(torch.equal(back[k], folded[k]) for k in back)
    # the JAX tree loads into the same module
    conv = convert.vocoder(convert.to_numpy(params), tcfg)
    for (n, a), (_, b) in zip(m.named_parameters(), conv.named_parameters()):
        assert_close(a, b.numpy(), 1e-6, 4, rel=True, what=n)


# --------------------------------------------------------------- LPAPS


def _lpaps_state(cfg, n_mels, seed=0):
    """An LPAPS-layout state dict from a torch conv/ReLU/maxpool stack built
    on the VGG recipe, plus the per-tap weights and scaling statistics."""
    layers, cin = [], 1
    for v in cfg.conv_layers:
        if v == "MP":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(cin, int(v), 3, padding=1), nn.ReLU()]
            cin = int(v)
    net = nn.Sequential(*layers)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    sd = {f"net.features.{k}": v for k, v in net.state_dict().items()}
    rs = np.random.RandomState(seed)
    for k, c in enumerate(cfg.chns):
        sd[f"lin{k}.model.1.weight"] = t(np.abs(rs.randn(1, c, 1, 1)).astype(np.float32))
    sd["scaling_layer.shift"] = t(rs.randn(1, n_mels, 1).astype(np.float32))
    sd["scaling_layer.scale"] = t((1 + 0.1 * np.abs(rs.randn(1, n_mels, 1))).astype(np.float32))
    return sd


def test_lpaps_from_state_dict_matches_jax():
    jcfg = ja.LPAPSConfig.tiny()
    tcfg = ta.LPAPSConfig(conv_layers=jcfg.conv_layers, chns=jcfg.chns)
    sd = _lpaps_state(jcfg, 16)
    km = ta.lpaps_keymap(tcfg)
    with torch.device("meta"):
        m = ta.LPAPS(tcfg, n_stats=16)
    m = L.materialize(m, torch.device("cpu"), torch.float32).eval().requires_grad_(False)
    ckpt_lib.load_module(m, km.to_port(sd, "lpaps"), "lpaps")
    params = ja.convert_lpaps_from_torch({k: v.numpy() for k, v in sd.items()}, jcfg)
    x, y = randn(5, 2, 16, 24), randn(6, 2, 16, 24)
    got = ta.lpaps_loss(m, t(x), t(y))
    assert_close(got, ja.lpaps_loss(params, jnp.asarray(x), jnp.asarray(y), jcfg), TOL, 5,
                 rel=True, what="lpaps")
    assert float(ta.lpaps_loss(m, t(x), t(x)).abs().max()) == 0.0
    fj = ja._vggish_features(params, jnp.asarray(x), jcfg)
    for i, (a, b) in enumerate(zip(ta._vggish_features(m, t(x), tcfg), fj)):
        assert_close(a, b, TOL, 5, rel=True, what=f"tap {i}")
    back = km.to_ref(dict(m.named_parameters()))
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in back)
    # the JAX tree (flattened statistics, lists of convs) loads too
    conv = convert.lpaps(convert.to_numpy(params), tcfg)
    assert_close(ta.lpaps_loss(conv, t(x), t(y)), got.numpy(), 1e-6, 5, rel=True, what="tree")


def test_lpaps_random_init_is_the_jax_init():
    """`lpaps_init_` draws as `lpaps_init` (`audio.py`): identity statistics
    (shift 0, scale 1) and non-negative per-tap weights, so a distance is
    finite, zero for equal inputs and positive otherwise."""
    cfg = ta.LPAPSConfig.tiny()
    with torch.device("meta"):
        m = ta.LPAPS(cfg)
    m = ta.lpaps_init_(L.materialize(m, torch.device("cpu"), torch.float32),
                       torch.Generator().manual_seed(0)).requires_grad_(False)
    shapes = jax.eval_shape(lambda: ja.lpaps_init(jax.random.key(0), ja.LPAPSConfig.tiny()))
    assert m.shift.shape == shapes["shift"].shape and m.scale.shape == shapes["scale"].shape
    assert float(m.shift) == 0.0 and float(m.scale) == 1.0
    assert all(bool((lin.weight >= 0).all()) for lin in m.lins)
    x, y = t(randn(7, 2, 16, 24)), t(randn(8, 2, 16, 24))
    assert float(ta.lpaps_loss(m, x, x).abs().max()) == 0.0
    d = ta.lpaps_loss(m, x, y)
    assert bool(torch.isfinite(d).all()) and bool((d > 0).all())


# --------------------------------------------------- end to end, full width


def test_wav_mel_vq_mel_wav_round_trip(vq1d):
    """wav → log-mel (the codec processor) → VQ codes → mel → waveform,
    each stage against JAX's on the same weights."""
    params, module = vq1d
    wav = (np.random.RandomState(0).randn(2000) * 0.1).astype(np.float32)
    mel_t, mel_j = TProc(4000, n_mels=8, duration=0.5)(wav), JProc(4000, n_mels=8, duration=0.5)(wav)
    np.testing.assert_array_equal(mel_t, mel_j)
    n = (mel_t.shape[1] // 2) * 2
    _, aux_j = _JVQ1D(params, mel_j.T[None, :n])
    tc = ta.VQ1DCodec(module, module.cfg)
    _, idx_t, _ = tc.encode_seq(mel_t.T[None, :n])
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(aux_j["indices"]))
    rec_t = tc.decode_seq(idx_t)
    assert_close(rec_t, aux_j["recon"], TOL, 0, rel=True, what="mel")
    vcfg = ja.VocoderConfig.tiny()
    vparams, vtree = _tree(ja.vocoder_init, vcfg, 1)
    voc = convert.vocoder(vtree, _port(ta.VocoderConfig, vcfg))
    w_t = ta.vocoder_apply(voc, rec_t, voc.cfg)
    w_j = ja.vocoder_apply(vparams, aux_j["recon"], vcfg)
    assert tuple(w_t.shape) == w_j.shape == (1, n * vcfg.hop_length)
    assert_close(w_t, w_j, TOL, 0, rel=True, what="waveform")


def test_full_width_audio_configs_have_the_jax_shapes():
    pairs = [
        (ja.vq1d_init, ja.VQ1DConfig(), lambda: ta.VQ1D(ta.VQ1DConfig())),
        (ja.vocoder_init, ja.VocoderConfig(), lambda: ta.Vocoder(ta.VocoderConfig())),
        (ja.lpaps_init, ja.LPAPSConfig(), lambda: ta.LPAPS(ta.LPAPSConfig())),
    ]
    for init, jcfg, make in pairs:
        shapes = jax.eval_shape(lambda: init(jax.random.key(0), jcfg))
        with torch.device("meta"):
            m = make()
        assert (sorted(p.numel() for p in m.parameters())
                == sorted(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)))
    with torch.device("meta"):
        voc = ta.Vocoder(ta.VocoderConfig())
    assert len(ta.vocoder_keymap(voc.cfg).to_ref(dict(voc.named_parameters()))) == \
        sum(1 for _ in voc.parameters())
