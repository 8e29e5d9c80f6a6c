"""The IP-Adapter FaceID family of the port against the JAX package at tiny
sizes, float32: the plain and Plus projectors (with `shortcut`), the
uncond side projecting zeros, zero-init LoRA preserving the UNet, and one
random state dict in the reference's {"image_proj", "ip_adapter"} layout
fed raw to the port (`convert_faceid` + `merge_faceid_weights`) and through
the JAX `convert_faceid_from_torch` + `merge_faceid_weights`, giving equal
face tokens and equal UNet outputs (live and with precomputed cross K/V)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instructany2pix_tpu.diffusion import ip_adapter_faceid as jface
from instructany2pix_tpu.models import unet as j_unet
from instructany2pix_tpu.models import unet_convert as j_uc
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch.diffusion import ip_adapter_faceid as face
from instructany2pix_tpu_torch.models import unet, unet_convert
from torch_port_helpers import assert_close, one_torch_thread, randn, t  # noqa: F401

TOL = 2e-5
UNET_REL_TOL = 1e-4
RANK = 4


def _pcfg(jcfg):
    return face.FaceProjConfig(**dataclasses.asdict(jcfg))


def _tree(jcfg, seed):
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + 0.1 * rs.randn(*np.shape(x))).astype(np.float32),
                        jface.init(jax.random.key(seed), jcfg))


@pytest.mark.parametrize("plus,shortcut", [(False, False), (True, False), (True, True)])
def test_projector_matches_jax(plus, shortcut):
    seed = 321
    jcfg = jface.FaceProjConfig.tiny(plus=plus)
    tree = _tree(jcfg, seed)
    model = convert.face_proj(tree, _pcfg(jcfg))
    ids = randn(seed, 2, jcfg.id_embeddings_dim)
    clip = randn(seed + 1, 2, 9, jcfg.clip_embeddings_dim) if plus else None
    ref = jface.apply(tree, jnp.asarray(ids), jcfg, None if clip is None else jnp.asarray(clip),
                      shortcut, 0.6)
    out = face.apply(model, t(ids), _pcfg(jcfg), None if clip is None else t(clip), shortcut, 0.6)
    assert_close(out, ref, TOL, seed, what=f"plus={plus} shortcut={shortcut}")
    cond, uncond = face.get_image_embeds(model, _pcfg(jcfg), t(ids),
                                         None if clip is None else t(clip), shortcut=shortcut,
                                         s_scale=0.6)
    jc, ju = jface.get_image_embeds(tree, jcfg, jnp.asarray(ids),
                                    None if clip is None else jnp.asarray(clip),
                                    shortcut=shortcut, s_scale=0.6)
    assert_close(cond, jc, TOL, seed, what="cond")
    assert_close(uncond, ju, TOL, seed, what="uncond")
    zeros = face.apply(model, torch.zeros_like(t(ids)), _pcfg(jcfg),
                       None if clip is None else torch.zeros_like(t(clip)), shortcut, 0.6)
    assert torch.equal(uncond, zeros)


def _unet_inputs(jcfg, seed, b=2):
    return (randn(seed, b, 8, 8, 4), randn(seed + 1, b, 7, jcfg.cross_attention_dim),
            randn(seed + 2, b, jcfg.pooled_dim),
            np.tile(np.array([[32, 32, 0, 0, 32, 32]], np.float32), (b, 1)),
            np.array([700, 300], np.int32))


def test_zero_init_lora_preserves_the_unet():
    seed = 323
    jcfg = j_unet.UNetConfig.tiny(with_ip=True)
    pcfg = unet.UNetConfig(**dataclasses.asdict(jcfg))
    model = convert.unet(convert.to_numpy(j_unet.init(jax.random.key(seed), jcfg)), pcfg)
    x, ctx, pooled, tids, ts = _unet_inputs(jcfg, seed)
    ip = t(randn(seed + 5, 2, 4, jcfg.cross_attention_dim))
    kw = dict(pooled_text=t(pooled), time_ids=t(tids), ip_tokens=ip, ip_scale=0.5)
    a = unet.apply(model, t(x), t(ts), t(ctx), pcfg, **kw)
    face.attach_faceid_lora(model, torch.Generator().manual_seed(1), rank=RANK)
    n = sum(1 for n_, _ in model.named_parameters() if n_.endswith("lora_a"))
    assert n == 4 * len(unet_convert.all_attn_paths(pcfg))
    assert model.mid["attn"].block_0.attn2.to_k.lora_a.shape == (RANK, jcfg.cross_attention_dim)
    b = unet.apply(model, t(x), t(ts), t(ctx), pcfg, **kw)
    assert torch.equal(a, b)
    with torch.no_grad():
        model.mid["attn"].block_0.attn2.to_v.lora_b.fill_(0.1)
    c = unet.apply(model, t(x), t(ts), t(ctx), pcfg, **kw)
    assert (c - a).abs().max() > 1e-4


def _reference_state_dict(ucfg, pcfg, seed):
    """A random FaceID checkpoint in the reference's nested layout."""
    rs = np.random.RandomState(seed)

    def r(*shape):
        return torch.from_numpy((rs.randn(*shape) * 0.2).astype(np.float32))

    ca, idd = pcfg.cross_attention_dim, pcfg.id_embeddings_dim
    ip = {"proj.0.weight": r(idd * 2, idd), "proj.0.bias": r(idd * 2),
          "proj.2.weight": r(ca * pcfg.num_tokens, idd * 2), "proj.2.bias": r(ca * pcfg.num_tokens),
          "norm.weight": 1 + r(ca), "norm.bias": r(ca)}
    if pcfg.plus:
        inner, pr = pcfg.heads * pcfg.dim_head, "perceiver_resampler."
        ip.update({f"{pr}proj_in.weight": r(ca, pcfg.clip_embeddings_dim),
                   f"{pr}proj_in.bias": r(ca), f"{pr}proj_out.weight": r(ca, ca),
                   f"{pr}proj_out.bias": r(ca), f"{pr}norm_out.weight": 1 + r(ca),
                   f"{pr}norm_out.bias": r(ca)})
        for i in range(pcfg.depth):
            a, f = f"{pr}layers.{i}.0", f"{pr}layers.{i}.1"
            ip.update({f"{a}.norm1.weight": 1 + r(ca), f"{a}.norm1.bias": r(ca),
                       f"{a}.norm2.weight": 1 + r(ca), f"{a}.norm2.bias": r(ca),
                       f"{a}.to_q.weight": r(inner, ca), f"{a}.to_kv.weight": r(2 * inner, ca),
                       f"{a}.to_out.weight": r(ca, inner), f"{f}.0.weight": 1 + r(ca),
                       f"{f}.0.bias": r(ca), f"{f}.1.weight": r(ca * pcfg.ff_mult, ca),
                       f"{f}.3.weight": r(ca, ca * pcfg.ff_mult)})
    att = {}
    paths = unet_convert.all_attn_paths(ucfg)
    chans = {f"down_{i}": c for i, c in enumerate(ucfg.block_out_channels)}
    chans.update({f"up_{i}": c for i, c in enumerate(reversed(ucfg.block_out_channels))})
    chans["mid"] = ucfg.block_out_channels[-1]
    for i, path in enumerate(paths):
        d = chans[path.split(".")[0]]
        cross = path.endswith("attn2")
        for proj in ("to_q", "to_k", "to_v", "to_out"):
            n_in = ucfg.cross_attention_dim if cross and proj in ("to_k", "to_v") else d
            att[f"{i}.{proj}_lora.down.weight"] = r(RANK, n_in)
            att[f"{i}.{proj}_lora.up.weight"] = r(d, RANK)
        if cross:
            att[f"{i}.to_k_ip.weight"] = r(d, ucfg.cross_attention_dim)
            att[f"{i}.to_v_ip.weight"] = r(d, ucfg.cross_attention_dim)
    return {"image_proj": ip, "ip_adapter": att}


@pytest.mark.parametrize("plus", [False, True])
def test_reference_checkpoint_gives_equal_unet_outputs(plus):
    seed = 325 + int(plus)
    jucfg = j_unet.UNetConfig.tiny(with_ip=True)
    ucfg = unet.UNetConfig(**dataclasses.asdict(jucfg))
    jpcfg = jface.FaceProjConfig.tiny(plus=plus)
    pcfg = _pcfg(jpcfg)
    pcfg = dataclasses.replace(pcfg, cross_attention_dim=ucfg.cross_attention_dim)
    jpcfg = dataclasses.replace(jpcfg, cross_attention_dim=ucfg.cross_attention_dim)
    sd = _reference_state_dict(ucfg, pcfg, seed)

    base = convert.to_numpy(j_unet.init(jax.random.key(seed), jucfg))
    jproj, lora_tree = jface.convert_faceid_from_torch(
        {k: {kk: vv.numpy() for kk, vv in v.items()} for k, v in sd.items()}, jpcfg,
        j_uc.all_attn_paths(jucfg))
    jtree = jface.merge_faceid_weights(base, lora_tree)

    proj_t, attn_t = face.convert_faceid(sd, ucfg, pcfg)
    model = face.merge_faceid_weights(convert.unet(base, ucfg), attn_t)
    proj = face.build_proj(proj_t, pcfg, "cpu", torch.float32)
    assert torch.equal(model.down_1.attn_0.block_0.attn2.to_k_ip.weight,
                       sd["ip_adapter"]["1.to_k_ip.weight"])

    ids = randn(seed, 2, pcfg.id_embeddings_dim)
    clip = randn(seed + 1, 2, 9, pcfg.clip_embeddings_dim) if plus else None
    jtok = jface.apply(jproj, jnp.asarray(ids), jpcfg, None if clip is None else jnp.asarray(clip),
                       shortcut=plus)
    tok = face.apply(proj, t(ids), pcfg, None if clip is None else t(clip), shortcut=plus)
    assert_close(tok, jtok, TOL, seed, what="face tokens")

    x, ctx, pooled, tids, ts = _unet_inputs(jucfg, seed)
    ref = j_unet.apply(jtree, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), jucfg,
                       pooled_text=jnp.asarray(pooled), time_ids=jnp.asarray(tids),
                       ip_tokens=jtok, ip_scale=0.8)
    out = unet.apply(model, t(x), t(ts), t(ctx), ucfg, pooled_text=t(pooled), time_ids=t(tids),
                     ip_tokens=tok, ip_scale=0.8)
    assert_close(out, ref, UNET_REL_TOL, seed, rel=True, what="unet, live context")
    kv = unet.precompute_cross_kv(model, ucfg, t(ctx), tok)
    out_kv = unet.apply(model, t(x), t(ts), t(ctx), ucfg, pooled_text=t(pooled),
                        time_ids=t(tids), ip_scale=0.8, cross_kv=kv)
    assert_close(out_kv, ref, UNET_REL_TOL, seed, rel=True, what="unet, precomputed K/V")

    bad = {"image_proj": sd["image_proj"],
           "ip_adapter": {k: v for k, v in sd["ip_adapter"].items() if not k.startswith("0.to_q")}}
    with pytest.raises(KeyError, match="adapters missing"):
        face.convert_faceid(bad, ucfg, pcfg)
    extra = {**sd, "ip_adapter": {**sd["ip_adapter"], "0.to_k_ip.weight": torch.zeros(1)}}
    with pytest.raises(KeyError, match="no counterpart"):
        face.convert_faceid(extra, ucfg, pcfg)
