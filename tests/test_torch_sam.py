"""The port's SAM and K3's plain version vs the JAX package: the rel-pos
attention against the Pallas kernel in interpret mode, the encoder, the
two-way decoder, `predict_box_mask` and `make_segmentor(dtype=None)` with
converted weights. CPU, float32, inputs from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instructany2pix_tpu.grounding import sam as jsam
from instructany2pix_tpu.ops.flash_attention import flash_attention_relpos2d as j_relpos2d
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch.grounding import sam as tsam
from instructany2pix_tpu_torch.ops import flash_attention as fa
from torch_port_helpers import assert_close, randn, t

RELPOS_TOL = 2e-5  # float32 both sides; the kernel sums keys in another order
SAM_TOL = 1e-4  # float32 through a few blocks, relative to the largest value
MASK_LOGIT_BAND = 1e-4  # masks may differ only where |JAX logit| < this


def _sam_cfg():
    # ragged windows (a 5x5 grid in 2x2 windows) and one global block
    return jsam.SAMConfig(img_size=80, patch=16, embed_dim=32, depth=3, heads=4, window=2,
                          global_blocks=(1,), out_chans=16, decoder_mlp=32)


def _port_cfg(jcfg):
    import dataclasses

    return tsam.SAMConfig(**dataclasses.asdict(jcfg))


def _randomize(tree, seed):
    """The JAX init zeroes the rel-pos and positional tables; fill every
    leaf from a seed so the test sees them."""
    leaves, treedef = jax.tree.flatten(tree)
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(
        treedef, [jnp.asarray(rs.randn(*np.shape(x)).astype(np.float32) * 0.3) for x in leaves])


@pytest.fixture(scope="module")
def sam_pair():
    jcfg = _sam_cfg()
    params = _randomize(jsam.init(jax.random.key(3), jcfg), 11)
    tree = convert.to_numpy(params)
    return jcfg, params, _port_cfg(jcfg), convert.sam(tree, _port_cfg(jcfg))


@pytest.mark.parametrize("g", [8, 16])
def test_relpos2d_plain_matches_pallas_interpret(g):
    b, h, d, n = 1, 2, 32, g * g
    seed = 100 + g
    q, k, v = (randn(seed + i, b, h, n, d) for i in range(3))
    bh, bw = randn(seed + 3, b, h, n, g), randn(seed + 4, b, h, n, g)
    o_j = j_relpos2d(*(jnp.asarray(x) for x in (q, k, v, bh, bw)), block_q=128, interpret=True)
    o = fa._reference_relpos2d(t(q), t(k), t(v), t(bh), t(bw), d**-0.5)
    assert_close(o, o_j, RELPOS_TOL, seed, what="relpos2d o")
    # the public wrapper takes the plain version on CPU tensors, also on
    # (B, N, H, D) views, and counts no launch
    before = fa.flash_relpos2d_cuda.launches
    views = [t(x).transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    o_v = fa.flash_attention_relpos2d(*views, t(bh), t(bw))
    assert fa.flash_relpos2d_cuda.launches == before
    assert_close(o_v, o_j, RELPOS_TOL, seed, what="relpos2d o, strided views")


def test_relpos2d_kernel_wrapper_rejects_cpu_tensors():
    x = t(randn(0, 1, 2, 64, 64))
    bias = t(randn(1, 1, 2, 64, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_relpos2d_cuda(x, x, x, bias, bias, 0.125)


@pytest.mark.parametrize("hw,block", [(2, 0), (5, 1)])
def test_attn_with_relpos_matches_jax(sam_pair, hw, block):
    jcfg, params, _, tp = sam_pair
    b, heads, hd = 3, jcfg.heads, jcfg.embed_dim // jcfg.heads
    n = hw * hw
    seed = 200 + hw
    q, k, v = (randn(seed + i, b, n, heads, hd) for i in range(3))
    jp = params["encoder"][f"block_{block}"]
    o_j = jsam._attn_with_relpos(*(jnp.asarray(x) for x in (q, k, v)), jp, hw, heads)
    o = tsam._attn_with_relpos(t(q), t(k), t(v), getattr(tp.encoder, f"block_{block}"), hw, heads)
    assert_close(o, o_j, SAM_TOL, seed, rel=True, what="attn_with_relpos")


def test_encoder_matches_jax(sam_pair):
    jcfg, params, tcfg, tp = sam_pair
    x = randn(300, 2, jcfg.img_size, jcfg.img_size, 3)
    e_j = jsam.encoder_apply(params["encoder"], jnp.asarray(x), jcfg)
    e = tsam.encoder_apply(tp.encoder, t(x), tcfg)
    assert e.shape == (2, 5, 5, jcfg.out_chans)
    assert_close(e, e_j, SAM_TOL, 300, rel=True, what="encoder")


def test_prompt_and_decoder_match_jax(sam_pair):
    jcfg, params, tcfg, tp = sam_pair
    g, c = 5, jcfg.out_chans
    emb = randn(400, 1, g, g, c)
    box = np.asarray([[7.0, 11.0, 60.0, 71.0]], np.float32)
    sp_j = jsam.encode_box(params["prompt"], jnp.asarray(box), jcfg.img_size)
    pe_j = jsam.dense_pe(params["prompt"], g)
    sp = tsam.encode_box(tp.prompt, t(box), tcfg.img_size)
    pe = tsam.dense_pe(tp.prompt, g)
    assert_close(sp, sp_j, 1e-5, 400, rel=True, what="box tokens")
    assert_close(pe, pe_j, 1e-5, 400, rel=True, what="dense pe")
    m_j, iou_j = jsam.decoder_apply(params["decoder"], jnp.asarray(emb), pe_j, sp_j, jcfg)
    m, iou = tsam.decoder_apply(tp.decoder, t(emb), pe, sp, tcfg)
    assert m.shape == (1, jcfg.num_mask_tokens, 4 * g, 4 * g)
    assert_close(m, m_j, SAM_TOL, 400, rel=True, what="mask logits")
    assert_close(iou, iou_j, SAM_TOL, 400, rel=True, what="iou")


def _jax_full_logits(params, cfg, img, box):
    """The JAX `predict_box_mask` before its threshold."""
    x, scale = jsam.preprocess(img, cfg)
    emb = jsam.encoder_apply(params["encoder"], jnp.asarray(x), cfg)
    g = emb.shape[1]
    sparse = jsam.encode_box(params["prompt"], jnp.asarray(np.asarray(box, np.float32) * scale)
                             .reshape(1, 4), cfg.img_size)
    emb = emb + params["prompt"]["no_mask"]
    masks, iou = jsam.decoder_apply(params["decoder"], emb, jsam.dense_pe(params["prompt"], g),
                                    sparse, cfg)
    m = masks[0, jnp.argmax(iou[0, 1:]) + 1]
    h, w = img.shape[:2]
    nh, nw = int(round(h * scale)), int(round(w * scale))
    full = jax.image.resize(m, (cfg.img_size, cfg.img_size), "bilinear")[:nh, :nw]
    return np.asarray(jax.image.resize(full, (h, w), "bilinear"))


def _check_mask(mask, logits, what):
    ref = (logits > 0).astype(np.float32)
    assert mask.shape == ref.shape and mask.dtype == np.float32, what
    bad = (mask != ref) & (np.abs(logits) >= MASK_LOGIT_BAND)
    assert not bad.any(), f"{what}: {int(bad.sum())} pixels differ away from the threshold"
    assert 0 < ref.mean() < 1, f"{what}: degenerate reference mask"


@pytest.mark.parametrize("shape", [(80, 80), (60, 72)])
def test_predict_box_mask_matches_jax(sam_pair, shape):
    jcfg, params, tcfg, tp = sam_pair
    img = np.random.RandomState(500).randint(0, 255, (*shape, 3)).astype(np.uint8)
    box = [5.0, 4.0, shape[1] - 9.0, shape[0] - 3.0]
    logits = _jax_full_logits(params, jcfg, img, box)
    np.testing.assert_array_equal(jsam.predict_box_mask(params, jcfg, img, box),
                                  (logits > 0).astype(np.float32))
    _check_mask(tsam.predict_box_mask(tp, tcfg, img, box), logits, f"predict_box_mask {shape}")


def test_make_segmentor_fp32_matches_jax(sam_pair):
    jcfg, params, tcfg, tp = sam_pair
    img = np.random.RandomState(501).randint(0, 255, (80, 80, 3)).astype(np.uint8)
    box = [3.0, 9.0, 70.0, 77.0]
    m_j = jsam.make_segmentor(params, jcfg, dtype=None)(img, box)
    logits = _jax_full_logits(params, jcfg, img, box)
    np.testing.assert_array_equal(m_j, (logits > 0).astype(np.float32))
    _check_mask(tsam.make_segmentor(tp, tcfg, dtype=None)(img, box), logits, "segmentor")


def test_config_and_random_init_match_jax():
    import dataclasses

    for name in ("vit_h", "tiny"):
        assert dataclasses.asdict(getattr(tsam.SAMConfig, name)()) == \
            dataclasses.asdict(getattr(jsam.SAMConfig, name)())
    cfg = tsam.SAMConfig.tiny()
    with torch.device("meta"):
        m = tsam.SAM(cfg)
    from instructany2pix_tpu_torch.models import layers as L

    m = tsam.init_(L.materialize(m, torch.device("cpu"), torch.float32), torch.Generator().manual_seed(0))
    jtree = convert.to_numpy(jsam.init(jax.random.key(0), jsam.SAMConfig.tiny()))
    # every JAX leaf has a counterpart of the same shape (convert is strict)
    convert.load_tree(m, jtree)
