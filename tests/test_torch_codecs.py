"""The codec layer of the port against the JAX package: the vq-npz build for
both modalities, `NpzLoader`, `VQVAE`, the codec processors, the YAML
reader, `ClipVisionCodec`, and the 2-D VQ-GAN (forward, code indices,
losses, gradients, the codec interface, a raw taming state dict against
`convert_from_taming`). One set of weights, seeded numpy draws in the JAX
tree's layout carried to the port by `convert.py`, feeds both sides. CPU, float32:
code indices identical; values within TOL relative to the largest element
of the JAX result."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (assert_close, grad_close, grad_enabled,  # noqa: F401
                                one_torch_thread,
                                random_tree, randn, t)

from instructany2pix_tpu.codecs import builder as jbuilder
from instructany2pix_tpu.codecs import processors as jproc
from instructany2pix_tpu.codecs import vqgan as jvq
from instructany2pix_tpu.models import clip as jclip
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch.codecs import builder as tbuilder
from instructany2pix_tpu_torch.codecs import processors as tproc
from instructany2pix_tpu_torch.codecs import vqgan as tvq
from instructany2pix_tpu_torch.core import checkpoint as ckpt_lib
from instructany2pix_tpu_torch.models import clip as tclip
from instructany2pix_tpu_torch.models import layers as L

TOL = 1e-5  # float32 on both sides, sums in another order
CFG = jvq.VQConfig.tiny()
# compiled once for the whole file: JAX's eager convolutions compile op by op
_JVQ = jax.jit(lambda p, x: jvq.vq_losses(p, x, CFG))


def _tcfg(jcfg):
    return tvq.VQConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def vq():
    """(JAX params, port module) of one tiny VQ-GAN."""
    cfg = jvq.VQConfig.tiny()
    tree = random_tree(jax.eval_shape(lambda: jvq.init(jax.random.key(0), cfg)), 0)
    return jax.tree.map(jnp.asarray, tree), convert.vqgan(tree, _tcfg(cfg))


# ------------------------------------------------------------- the builder


@pytest.mark.parametrize("modality", ["image", "audio"])
def test_vq_npz_builds_the_passthrough(modality):
    jm, jp = jbuilder.build_vae("vq-npz", modality)
    tm, tp = tbuilder.build_vae("vq-npz", modality)
    assert type(tm).__name__ == type(jm).__name__ == "TensorLoader"
    assert type(tp).__name__ == type(jp).__name__ == "NpzLoader"
    assert (tm.embed_dim, tm.n_embed) == (jm.embed_dim, jm.n_embed) == (1024, 1024)
    x = randn(0, 2, 1024)
    q, idx, info = tm.encode_seq(x)
    assert q is x and idx is None and info is None
    assert tm.decode_seq(x) is x


def test_vqvae_matches_jax():
    jv, tv = jbuilder.VQVAE("vq-npz", "vq-npz"), tbuilder.VQVAE("vq-npz", "vq-npz")
    for k in ("embed_dim_image", "embed_dim_audio", "vocab_size_image", "vocab_size_audio"):
        assert getattr(tv, k) == getattr(jv, k)
    x = {"image": randn(1, 3, 1024), "audio": randn(2, 1, 1024)}
    got, want = tv(x), jv(x)
    assert sorted(got) == sorted(want) == ["audio", "image"]
    for k in got:
        np.testing.assert_array_equal(got[k][0], np.asarray(want[k][0]))
    empty = tbuilder.VQVAE(None, None)
    assert empty.image_vae is None and empty({"image": x["image"]}) == {}
    with pytest.raises(NotImplementedError):
        tv.processor(x["image"], "video")


def test_shipped_config_is_a_copy_and_reads_as_yaml():
    import pathlib

    import yaml

    ours = (pathlib.Path(tbuilder.__file__).parent / "vq-npz.yaml").read_text()
    theirs = (pathlib.Path(jbuilder.__file__).parent / "vq-npz.yaml").read_text()
    assert ours == theirs
    assert tbuilder._load_yaml(ours) == yaml.safe_load(theirs)


@pytest.mark.parametrize("text", ["1e-5", "1.0e-5", ".5", "3.", "on", "Off", "YES", "no", "~",
                                  "null", "12", "-7", "1_000", "abc", "'on'", '"12"', "tRue",
                                  "True", "y", "a: b"])
def test_yaml_scalars_resolve_as_pyyaml(text):
    import yaml

    if text == "a: b":  # a nested mapping, a null leaf and a comment
        doc = "top:\n  a: 1  # c\n  b:\n    c: on\n  d:\ne: x\n"
        assert tbuilder._load_yaml(doc) == yaml.safe_load(doc)
        return
    want = yaml.safe_load("k: " + text)["k"]
    got = tbuilder._scalar(text)
    assert got == want and type(got) is type(want)


def test_yaml_reader_refuses_what_it_does_not_read():
    for doc in ("a:\n  - 1\n", "a: [1, 2]\n", "a: &x 1\n", "a: |\n  text\n"):
        with pytest.raises(ValueError):
            tbuilder._load_yaml(doc)


def test_npz_loader_reads_the_state_array(tmp_path):
    state = randn(2, 4, 1024)
    path = tmp_path / "feat.npz"
    np.savez(path, state=state, other=np.zeros(3))
    got, want = tbuilder.NpzLoader()(str(path)), jbuilder.NpzLoader()(str(path))
    np.testing.assert_array_equal(got, state)
    np.testing.assert_array_equal(got, want)


def test_codec_processors_match_jax(tmp_path):
    rs = np.random.RandomState(0)
    img = rs.randint(0, 255, (40, 56, 3), np.uint8)
    np.testing.assert_array_equal(tproc.ImageVAEProcessor(32)(img),
                                  jproc.ImageVAEProcessor(32)(img))
    wav = (rs.randn(6000) * 0.1).astype(np.float32)
    for dur in (None, 0.2, 0.5):
        got = tproc.AudioVAEProcessor(8000, n_mels=16, duration=dur)(wav)
        want = jproc.AudioVAEProcessor(8000, n_mels=16, duration=dur)(wav)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tproc.specvqgan_mel(wav, 8000, n_mels=16),
                                  jproc.specvqgan_mel(wav, 8000, n_mels=16))


def test_clip_vision_codec_matches_jax():
    """The codec is `vision_apply`'s image embeds with two unit axes (the
    tower itself is held against JAX in `test_torch_clip_vision.py`)."""
    jcfg = jclip.CLIPVisionConfig.tiny()
    shapes = jax.eval_shape(lambda: jclip.vision_init(jax.random.key(3), jcfg))
    tree = random_tree(shapes, 3)
    tcfg = tclip.CLIPVisionConfig(**dataclasses.asdict(jcfg))
    module = convert.clip_vision(tree, tcfg)
    jc = jbuilder.ClipVisionCodec(cfg=jcfg)
    tc = tbuilder.ClipVisionCodec(params=module, cfg=tcfg)
    px = randn(4, 2, jcfg.image_size, jcfg.image_size, 3)
    got = tc.encode_seq(t(px))
    want = jax.eval_shape(lambda p, x: jbuilder.ClipVisionCodec(params=p, cfg=jcfg).encode_seq(x),
                          shapes, jax.ShapeDtypeStruct(px.shape, jnp.float32))
    assert got[1] is None and got[2] is None and want[1] is None and want[2] is None
    assert tuple(got[0].shape) == want[0].shape == (2, jcfg.projection_dim, 1, 1)
    emb = tclip.vision_apply(module, t(px), tcfg)["image_embeds"]
    assert torch.equal(got[0], emb[..., None, None])
    assert (tc.embed_dim, tc.n_embed) == (jc.embed_dim, jc.n_embed) == (1024, 1024)
    with pytest.raises(ValueError):
        tbuilder.ClipVisionCodec().encode_seq(t(px))
    # the reference's target strings resolve to the port's classes
    assert tbuilder._TARGET_ALIASES.keys() == jbuilder._TARGET_ALIASES.keys()
    assert tbuilder._instantiate({
        "target": "instructany2pix.llm.model.vae.clip.ClipVisionModelInterfaceForLLM",
        "params": {"embed_dim": 8}}).embed_dim == 8


# ------------------------------------------------------------- the VQ-GAN


def test_vqgan_forward_indices_and_losses(vq):
    """encode_z → quantize → decode_z inside `vq_losses` against JAX's, and
    `quantize` alone on the same latents."""
    params, module = vq
    x = randn(5, 2, 8, 8, 3)
    z = randn(9, 2, 4, 4, CFG.embed_dim)
    zq_j, idx_j, (cb_j, cm_j) = jvq.quantize(params, jnp.asarray(z))
    zq_t, idx_t, (cb_t, cm_t) = tvq.quantize(module, t(z))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert_close(zq_t, zq_j, TOL, 9, rel=True, what="z_q")
    assert_close(cb_t, cb_j, TOL, 9, rel=True, what="codebook loss")
    assert_close(cm_t, cm_j, TOL, 9, rel=True, what="commit loss")
    tot_j, aux_j = _JVQ(params, x)
    tot_t, aux_t = tvq.vq_losses(module, t(x), module.cfg)
    z_t = tvq.encode_z(module, t(x), module.cfg)
    rec_t = tvq.decode_z(module, tvq.quantize(module, z_t)[0], module.cfg)
    assert torch.equal(rec_t, aux_t["recon"])
    np.testing.assert_array_equal(aux_t["indices"].numpy(), np.asarray(aux_j["indices"]))
    for k in ("rec_loss", "codebook_loss", "commit_loss", "recon"):
        assert_close(aux_t[k], aux_j[k], TOL, 5, rel=True, what=k)
    assert_close(tot_t, tot_j, TOL, 5, rel=True, what="total")


def test_vqgan_codec_interface(vq):
    """`VQGANCodec` on JAX's `vq_losses`: the same codes, z_q the codebook
    rows, and decode_seq of the codes JAX's reconstruction."""
    params, module = vq
    x = randn(6, 2, 8, 8, 3)
    _, aux_j = _JVQ(params, x)
    tc = tvq.VQGANCodec(module, module.cfg)
    q_t, idx_t, hw_t = tc.encode_seq(x)
    assert hw_t == (4, 4) and (tc.embed_dim, tc.n_embed) == (CFG.embed_dim, CFG.n_embed)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(aux_j["indices"]).reshape(2, -1))
    cb = np.asarray(params["codebook"]["w"])
    assert_close(q_t, cb[np.asarray(aux_j["indices"]).reshape(2, -1)], TOL, 6, rel=True,
                 what="encode_seq")
    assert_close(tc.decode_seq(idx_t, hw_t), aux_j["recon"], TOL, 6, rel=True, what="decode_seq")


def test_vqgan_gradients_match_jax_grad(vq, grad_enabled):
    params, module = vq
    cfg = jvq.VQConfig.tiny()
    x = randn(7, 2, 8, 8, 3)
    want = jax.jit(jax.grad(lambda p, x: _JVQ(p, x)[0]))(params, x)
    m = module.requires_grad_(True)
    m.zero_grad()
    tvq.vq_losses(m, t(x), m.cfg)[0].backward()
    got = convert.to_tree(m, grad=True)
    m.requires_grad_(False)
    assert grad_close(got, want, TOL, 7) == sum(1 for _ in m.parameters())


def test_taming_state_dict_read_raw_matches_convert_from_taming(vq):
    """A taming `VQModel` state dict, written from the port's module under
    the reference keys (plus a training-loss key the codec ignores), read
    raw by the port and by `convert_from_taming`: the same trees, and the
    same outputs."""
    _, module = vq
    cfg = jvq.VQConfig.tiny()
    km = tvq.taming_keymap(module.cfg)
    sd = {k: v.detach().clone() for k, v in km.to_ref(dict(module.named_parameters())).items()}
    # taming's names: 1x1-conv attention weights, mirrored decoder levels
    assert sd["encoder.down.1.attn.0.q.weight"].shape == (16, 16, 1, 1)
    assert "decoder.up.1.attn.0.q.weight" in sd and "decoder.up.0.block.1.conv1.weight" in sd
    assert "decoder.up.0.upsample.conv.weight" not in sd
    assert "decoder.up.1.upsample.conv.weight" in sd
    sd["loss.discriminator.main.0.weight"] = torch.zeros(1)
    jparams = jvq.convert_from_taming({k: v.numpy() for k, v in sd.items()}, cfg)
    with torch.device("meta"):
        port = tvq.VQModel(module.cfg)
    port = L.materialize(port, torch.device("cpu"), torch.float32)
    ckpt_lib.load_module(port, km.to_port(sd, "taming"), "taming")
    for (n, a), (_, b) in zip(port.named_parameters(), module.named_parameters()):
        assert torch.equal(a, b), n
    x = randn(8, 2, 8, 8, 3)
    tot_j, aux_j = _JVQ(jparams, x)
    tot_t, aux_t = tvq.vq_losses(port, t(x), port.cfg)
    np.testing.assert_array_equal(aux_t["indices"].numpy(), np.asarray(aux_j["indices"]))
    assert_close(aux_t["recon"], aux_j["recon"], TOL, 8, rel=True, what="recon")
    with pytest.raises(KeyError):
        km.to_port({**sd, "encoder.unknown.weight": torch.zeros(1)})


@pytest.mark.parametrize("name", ["image_f16", "audio_spec"])
def test_full_width_configs_have_the_jax_shapes(name):
    jcfg = getattr(jvq.VQConfig, name)()
    shapes = jax.eval_shape(lambda: jvq.init(jax.random.key(0), jcfg))
    with torch.device("meta"):
        m = tvq.VQModel(_tcfg(jcfg))
    want = sorted(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    got = sorted(p.numel() for p in m.parameters())
    assert got == want
    assert len(tvq.taming_keymap(m.cfg).to_ref(dict(m.named_parameters()))) == len(got)
