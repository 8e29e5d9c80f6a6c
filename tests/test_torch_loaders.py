"""The port booted from the reference's checkpoint layout vs the JAX
package booted from the same files: a complete tiny tree written in the
official key layouts (`ckpt_fixtures.build_checkpoint_tree`), loaded by
`InstructAny2PixPipeline(ckpt=root, device="cpu")` on one side and by the
JAX constructor on the other. Parameters agree bitwise in float32 with a
port pipeline built from the JAX pipeline's converted trees; the tiny
edit agrees within 1 uint8 level (`from_model_range` truncates) and the
greedy tokens are identical. Also: sharded, safetensors and fp16 LLM
directories, the safetensors reader, the projector-only load, every key
map read both ways, and the errors a broken tree raises. CPU, float32."""

import dataclasses
import os
import shutil
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instructany2pix_tpu import loaders as jloaders
from instructany2pix_tpu import pipeline as jpl
from instructany2pix_tpu.core.prng import KeyChain
from instructany2pix_tpu.grounding import gdino as jgdino
from instructany2pix_tpu.grounding import sam as jsam
from instructany2pix_tpu.llm import generate as jgen
from instructany2pix_tpu_torch import convert, loaders
from instructany2pix_tpu_torch import pipeline as tpl
from instructany2pix_tpu_torch.core import checkpoint as ckpt_lib
from instructany2pix_tpu_torch.core.dtypes import FP32
from instructany2pix_tpu_torch.grounding import gdino as tgdino
from instructany2pix_tpu_torch.grounding import lib as tlib
from instructany2pix_tpu_torch.grounding import sam as tsam
from instructany2pix_tpu_torch.llm import generate as tgen
from instructany2pix_tpu_torch.llm import multimodal as tmm
from instructany2pix_tpu_torch.llm import tokenizer as ttok
from instructany2pix_tpu_torch.models import layers as L
from instructany2pix_tpu_torch.ops import quant as Q

from ckpt_fixtures import build_checkpoint_tree

UINT8_TOL = 1
UNET_F32_TOL = 1e-3  # of the largest output, against float64
LLM = "llm-retrained"


def _mirror(port, ref):
    """The port's config with every field of the JAX one (nested dataclasses too)."""
    kw = {}
    for f in dataclasses.fields(port):
        pv, rv = getattr(port, f.name), getattr(ref, f.name)
        both = dataclasses.is_dataclass(pv) and dataclasses.is_dataclass(rv)
        kw[f.name] = _mirror(pv, rv) if both else rv
    return dataclasses.replace(port, **kw)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpts"))
    jcfg = build_checkpoint_tree(root)
    base = dataclasses.replace(tpl.PipelineConfig.tiny(), gdino=tgdino.GDinoConfig.tiny(),
                               sam=tsam.SAMConfig.tiny())
    return root, jcfg, _mirror(base, jcfg)


@pytest.fixture(scope="module")
def booted(tree):
    root, jcfg, pcfg = tree
    jp = jpl.InstructAny2PixPipeline(ckpt=root, tiny=False, config=jcfg, seed=0)
    tp = tpl.InstructAny2PixPipeline(pcfg, ckpt=root, device="cpu", policy=FP32)
    return jp, tp


@pytest.fixture(scope="module")
def converted(booted, tree):
    """A port pipeline built from the booted JAX pipeline's trees."""
    root, _, pcfg = tree
    cfg = dataclasses.replace(pcfg, inpaint_unet=pcfg.unet)
    return tpl.InstructAny2PixPipeline(cfg, params=convert.pipeline_params(booted[0].params),
                                       device="cpu", policy=FP32, ckpt=root)


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("media")
    rs = np.random.RandomState(0)
    img = str(d / "img1.png")
    Image.fromarray(rs.randint(0, 255, (96, 80, 3), np.uint8)).save(img)
    wav = str(d / "a.wav")
    with wave.open(wav, "w") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.sin(np.arange(16000) * 0.05) * 9000).astype(np.int16).tobytes())
    return [{"type": "image", "fname": img}, {"type": "audio", "fname": wav}]


def _assert_same_params(got: torch.nn.Module, want: torch.nn.Module, what: str):
    a, b = got.state_dict(), want.state_dict()
    assert a.keys() == b.keys(), f"{what}: {sorted(a.keys() ^ b.keys())[:8]}"
    for k in a:
        x, y = a[k].float(), b[k].float()
        assert x.shape == y.shape, f"{what}.{k}: {tuple(x.shape)} != {tuple(y.shape)}"
        d = (x - y).abs()
        assert torch.equal(x, y), f"{what}.{k}: max diff {d.max():.3g} mean diff {d.mean():.3g}"


# ------------------------------------------------------------------ the boot


def test_boot_uses_real_components(booted):
    _, tp = booted
    assert not isinstance(tp.tokenizer, ttok.ByteTokenizer)
    assert tp.clip_tok1 is not None and tp.clip_tok2 is not None and tp.prior_tok is not None
    assert tp.segmentor.__qualname__.startswith("make_segmentor")
    assert tp.grounder.__qualname__.startswith("make_grounder")
    assert "inpaint_unet" not in tp.models and tp.cfg.inpaint_unet == tp.cfg.unet
    assert set(tp.boot_times) == {"read", "cast"}
    unet = tp.models["unet"]
    assert any(n.endswith("to_k_ip.weight") for n, _ in unet.named_parameters())


@pytest.mark.parametrize("component", [
    "unet", "refiner", "vae", "text1", "text2", "prior_text", "image_proj", "prior",
    "imagebind_vision", "imagebind_audio", "llm"])
def test_boot_matches_converted_jax_params(booted, converted, component):
    """Each module equals, bitwise in float32, the one built from the
    booted JAX pipeline's trees through `convert.py`."""
    _, tp = booted
    _assert_same_params(tp.models[component], converted.models[component], component)


@pytest.mark.parametrize("which", ["sam", "gdino"])
def test_grounding_params_match_jax_converters(tree, which):
    root, jcfg, pcfg = tree
    path = os.path.join(root, "gdino", "sam_vit_h_4b8939.pth" if which == "sam" else "gdino.pth")
    if which == "sam":
        jtree = jsam.convert_from_sam(path, jcfg.sam)
        want = convert.sam(convert.to_numpy(jtree), pcfg.sam)
        km, make = tsam.keymap(pcfg.sam), lambda: tsam.SAM(pcfg.sam)
    else:
        jtree = jgdino.convert_from_torch(path, jcfg.gdino)
        want = convert.gdino(convert.to_numpy(jtree), pcfg.gdino)
        km, make = tgdino.keymap(pcfg.gdino), lambda: tgdino.GDino(pcfg.gdino)
    got = loaders.build(make, km.to_port(loaders.read(path)), "cpu", torch.float32, path)
    _assert_same_params(got, want, which)


def test_segmentator_pair_runs_the_loaded_models(tree):
    """`build_segmentator`'s pair gives what SAM (bf16) and GroundingDINO
    (float32) built from the JAX converters' trees give."""
    root, jcfg, pcfg = tree
    seg, grd = tlib.build_segmentator(os.path.join(root, "gdino"), pcfg.sam, pcfg.gdino, "cpu")
    sam = convert.sam(convert.to_numpy(jsam.convert_from_sam(
        os.path.join(root, "gdino", "sam_vit_h_4b8939.pth"), jcfg.sam)), pcfg.sam)
    dino = convert.gdino(convert.to_numpy(jgdino.convert_from_torch(
        os.path.join(root, "gdino", "gdino.pth"), jcfg.gdino)), pcfg.gdino)
    tok = tlib._load_bert_tokenizer(os.path.join(root, "gdino"))
    img = np.random.RandomState(3).randint(0, 255, (48, 40, 3), np.uint8)
    box = np.asarray([4.0, 6.0, 30.0, 40.0], np.float32)
    assert np.array_equal(seg(img, box), tsam.make_segmentor(sam, pcfg.sam)(img, box))
    got = grd(img, "a cat . a dog")
    want = tgdino.make_grounder(dino, pcfg.gdino, tokenizer=tok)(img, "a cat . a dog")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_greedy_tokens_match_jax(booted, media):
    jp, tp = booted
    inst = "add <video> to <video>"
    ids_j, emb_j = jp._prepare_llm_inputs(inst, jp.embed_mm_data(media))
    ids_t, emb_t = tp._prepare_llm_inputs(inst, tp.embed_mm_data(media))
    assert np.array_equal(ids_t, np.asarray(ids_j))
    kw = dict(max_new_tokens=8, temperature=0.0, eos_id=-1, bucket=64)
    jr = jgen.generate(jp.params["llm"]["llama"], jp.cfg.llm.llama, jnp.asarray(np.asarray(emb_j)),
                       jax.random.key(0), **kw)
    tr = tgen.generate(tp.models["llm"].llama, tp.cfg.llm.llama, emb_t, None, **kw)
    assert np.array_equal(tr.tokens.numpy(), np.asarray(jr.tokens)), (tr.tokens, jr.tokens)


def _seed_cache(pipe, media, to_array):
    rs = np.random.RandomState(7)
    d = pipe.cfg.llm.image_codec_dim
    pipe.cache = (to_array(rs.randn(1, d).astype(np.float32)), to_array(rs.randn(d).astype(np.float32)),
                  "a cat. a clock.", media[0]["fname"],
                  dict(all_objs=["cat"], extra_embeds=rs.randn(1, d).astype(np.float32),
                       extra_idx=np.array([0])))


@pytest.mark.parametrize("seed", [0, 5])
def test_edit_matches_booted_jax(booted, media, seed):
    """Without the refiner. The fixture's random SDXL weights give latents
    of magnitude ~5e3, and through the refiner's 20 steps float32 rounding
    alone moves the port's refined latents by ~2e-4 of that (float32 against
    float64 in the port itself), several uint8 levels at a few pixels: the
    refiner is held to JAX one step at a time instead
    (`test_unet_forward_matches_jax_on_booted_weights`)."""
    jp, tp = booted
    refinement = 0.0
    _seed_cache(jp, media, jnp.asarray)
    j_non, j_ref, j_msg = jp("add <video> to <video>", media, num_inference_steps=2,
                             refinement=refinement, seed=seed, use_cache=True)
    kc = KeyChain(seed)
    kc()  # the LLM's draw
    hl = tp._latent_size()
    names = ["vae_noise", "polar_noise"] + (["refiner_vae_noise", "refiner_noise"] if refinement
                                            else [])
    draws = {n: np.asarray(jax.random.normal(kc(), (1, hl, hl, 4))) for n in names}
    _seed_cache(tp, media, np.asarray)
    t_non, t_ref, t_msg = tp("add <video> to <video>", media, num_inference_steps=2,
                             refinement=refinement, seed=seed, use_cache=True, **draws)
    jp.cache = tp.cache = None
    assert t_msg == j_msg == "SUCCESS!"
    for name, a, b in (("non_refined", t_non, j_non), ("refined", t_ref, j_ref)):
        assert a.shape == b.shape and a.dtype == np.uint8
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= UINT8_TOL, (
            f"{name} seed {seed}: max {d.max()} levels, mean {d.mean():.4g}, "
            f"{int((d > 0).sum())} differ")


@pytest.mark.parametrize("name", ["unet", "refiner"])
def test_unet_forward_matches_jax_on_booted_weights(booted, tree, name):
    """One UNet call on the booted weights, the base UNet with IP tokens
    (the IP-Adapter file's keys and values in diffusers' processor order),
    with the port's float64 forward on the same files as the reference.
    The fixture's UNet weights are N(0, 1), not scaled by fan-in, so
    activations grow through the blocks and float32 rounding alone reaches
    ~1e-4 of the output's scale (JAX's own float32 error against float64
    reads 1e-5 to 5e-5): both float32 forwards must stay within
    UNET_F32_TOL of it, far below what a wrong weight or order gives."""
    from instructany2pix_tpu.models import unet as junet
    from instructany2pix_tpu_torch.models import unet as tunet
    from torch_port_helpers import randn

    jp, tp = booted
    root = tree[0]
    jc, tc = getattr(jp.cfg, name), getattr(tp.cfg, name)
    ip_attn = None
    if name == "unet":
        ip_attn, _ = loaders.load_ip_adapter(os.path.join(root, loaders.IP_ADAPTER), tc)
    path = os.path.join(root, "sdxl-base" if name == "unet" else "sdxl-refiner", "unet")
    exact = loaders.load_unet(path, tc, "cpu", torch.float64, ip_attn)
    seed = 11
    x = randn(seed, 2, 8, 8, jc.in_channels)
    ctx = randn(seed + 1, 2, 7, jc.cross_attention_dim)
    pooled = randn(seed + 2, 2, jc.pooled_dim)
    tids = np.abs(randn(seed + 3, 2, jc.num_time_ids)) * 100
    ip = randn(seed + 4, 2, jc.ip_num_tokens, jc.cross_attention_dim) if jc.with_ip else None
    tstep = np.asarray([500.0, 20.0], np.float32)
    ref = junet.apply(jp.params[name], jnp.asarray(x), jnp.asarray(tstep), jnp.asarray(ctx), jc,
                      pooled_text=jnp.asarray(pooled), time_ids=jnp.asarray(tids),
                      ip_tokens=None if ip is None else jnp.asarray(ip))

    def port(module, dtype):
        def f(a):
            return None if a is None else torch.from_numpy(a).to(dtype)

        return tunet.apply(module, f(x), torch.from_numpy(tstep), f(ctx), tc, pooled_text=f(pooled),
                           time_ids=torch.from_numpy(tids), ip_tokens=f(ip)).double().numpy()

    y64 = port(exact, torch.float64)
    limit = UNET_F32_TOL * np.abs(y64).max()
    for what, y in (("JAX float32", np.asarray(ref, np.float64)),
                    ("port float32", port(tp.models[name], torch.float32))):
        d = np.abs(y - y64)
        assert d.max() <= limit, (f"{name}, {what} against the port in float64: seed {seed} max "
                                  f"diff {d.max():.3g} mean diff {d.mean():.3g} > {limit:.3g}")


def test_subject_call_runs_through_the_loaded_pair(booted, media):
    _, tp = booted
    calls = {"grounder": 0, "segmentor": 0}
    seg, grd = tp.segmentor, tp.grounder

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    tp.segmentor, tp.grounder = count("segmentor", seg), count("grounder", grd)
    try:
        _seed_cache(tp, media, np.asarray)
        non, out, msg = tp("add <video> to <video>", media, num_inference_steps=2, refinement=0.4,
                           subject_strength=0.6, seed=0, use_cache=True)
    finally:
        tp.segmentor, tp.grounder, tp.cache = seg, grd, None
    assert msg == "SUCCESS!" and calls["grounder"] == 1
    assert out.shape == non.shape == (tp.cfg.image_size, tp.cfg.image_size, 3)


# ------------------------------------------------------- LLM directories


def _llm_sd(root):
    return ckpt_lib.load_torch_state_dict(os.path.join(root, LLM, "pytorch_model.bin"))


def _write_shards(d, sd, n, fmt="bin", dtype=None):
    os.makedirs(d, exist_ok=True)
    keys = list(sd)
    for i in range(n):
        part = {k: (sd[k].to(dtype) if dtype else sd[k]).contiguous() for k in keys[i::n]}
        if fmt == "bin":
            torch.save(part, os.path.join(d, f"pytorch_model-{i + 1:05d}-of-{n:05d}.bin"))
        else:
            from safetensors.torch import save_file

            save_file(part, os.path.join(d, f"model-{i + 1:05d}-of-{n:05d}.safetensors"))


@pytest.mark.parametrize("fmt,dtype", [("bin", None), ("safetensors", None),
                                       ("bin", torch.float16), ("safetensors", torch.float16)])
def test_llm_directories_load_alike(tree, tmp_path, fmt, dtype):
    """Two shards, interleaved so layers straddle them, in .bin or
    .safetensors, float32 or fp16: the values the files hold."""
    root, _, pcfg = tree
    sd = _llm_sd(root)
    _write_shards(str(tmp_path), sd, 2, fmt, dtype)
    got = loaders.load_llm(str(tmp_path), pcfg.llm, "cpu", torch.float32)
    want = loaders.load_llm(os.path.join(root, LLM), pcfg.llm, "cpu", torch.float32)
    if dtype is not None:
        for p in want.parameters():
            p.copy_(p.to(dtype).float())
    _assert_same_params(got, want, f"{fmt} {dtype}")


def test_streamed_quantization_matches_quantize_after_load(tree):
    """Layers quantized as they land equal the whole float model quantized
    and fused afterwards."""
    root, _, pcfg = tree
    path = os.path.join(root, LLM)
    got = loaders.load_llm(path, pcfg.llm, "cpu", torch.float32, quant_bits=8)
    want = loaders.load_llm(path, pcfg.llm, "cpu", torch.float32)
    Q.quantize_llama(want.llama, bits=8)
    from instructany2pix_tpu_torch.models import llama as tllama

    tllama.fuse_projections(want.llama)
    a = {n: b for n, b in got.named_buffers()} | dict(got.named_parameters())
    b = {n: b for n, b in want.named_buffers()} | dict(want.named_parameters())
    assert a.keys() == b.keys() and any("qkv" in k for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
def test_safetensors_reader_matches_the_package(tmp_path, dtype):
    """numpy has no bfloat16, so bf16 is read back through the package's
    torch reader; fp16 and float32 through its numpy one."""
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file as torch_load
    from safetensors.torch import save_file

    rs = np.random.RandomState(0)
    sd = {"a.weight": torch.from_numpy(rs.randn(5, 7).astype(np.float32)).to(dtype),
          "b": torch.from_numpy(rs.randn(3).astype(np.float32)).to(dtype),
          "empty": torch.zeros(0, 4, dtype=dtype), "ids": torch.arange(6, dtype=torch.int64)}
    path = str(tmp_path / "x.safetensors")
    save_file(sd, path, metadata={"format": "pt"})
    got = ckpt_lib.load_safetensors(path)
    assert got.keys() == sd.keys()
    want = torch_load(path) if dtype == torch.bfloat16 else {
        k: torch.from_numpy(v) for k, v in np_load(path).items()}
    for k in sd:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_projector_only_load_matches_jax(tree, tmp_path):
    root, _, pcfg = tree
    sd = _llm_sd(root)
    heads = {k: v.clone() + 1.0 for k, v in sd.items() if k.startswith("model.vae_")}
    d = tmp_path / "proj"
    d.mkdir()
    torch.save(heads, str(d / "pytorch_model.bin"))
    base = os.path.join(root, LLM)
    jparams, _, _ = jloaders.load_pretrained_model(str(d), base, projector_only=True)
    got, tok, ids = loaders.load_pretrained_model(str(d), base, projector_only=True, cfg=pcfg.llm,
                                                  device="cpu", dtype=torch.float32)
    assert isinstance(tok, ttok.ByteTokenizer) and ids
    _assert_same_params(got, convert.llm(convert.to_numpy(jparams), pcfg.llm), "projector-only")
    assert torch.equal(got.vae_projector_image.fc1.weight,
                       heads["model.vae_projector_image.0.weight"])
    with pytest.raises(NotImplementedError, match="Queue 1, item 9"):
        loaders.load_pretrained_model(str(d), base, load_lora=True, device="cpu")


# ------------------------------------------------------------------ errors


def _broken_llm(root, d, edit):
    sd = dict(_llm_sd(root))
    edit(sd)
    os.makedirs(d)
    torch.save(sd, os.path.join(d, "pytorch_model.bin"))


@pytest.mark.parametrize("case", ["missing_key", "unknown_key", "wrong_shape", "no_shards"])
def test_broken_llm_directory_raises(tree, tmp_path, case):
    root, _, pcfg = tree
    d = str(tmp_path / "llm")
    if case == "missing_key":
        _broken_llm(root, d, lambda sd: sd.pop("model.layers.1.mlp.up_proj.weight"))
        err, match = KeyError, "unset"
    elif case == "unknown_key":
        _broken_llm(root, d, lambda sd: sd.__setitem__("model.layers.0.extra.weight", torch.ones(2)))
        err, match = KeyError, "no counterpart"
    elif case == "wrong_shape":
        _broken_llm(root, d, lambda sd: sd.__setitem__("model.norm.weight", torch.ones(3)))
        err, match = ValueError, "shape"
    else:
        os.makedirs(d)
        err, match = FileNotFoundError, "no weight shards"
    with pytest.raises(err, match=match):
        loaders.load_llm(d, pcfg.llm, "cpu", torch.float32)


@pytest.mark.parametrize("case", ["no_vocab", "missing_file"])
def test_broken_tree_raises(tree, tmp_path, case):
    root, _, pcfg = tree
    copy = str(tmp_path / "ckpts")
    shutil.copytree(root, copy)
    if case == "no_vocab":
        os.remove(os.path.join(copy, "gdino", "vocab.txt"))
        with pytest.raises(FileNotFoundError, match="vocab"):
            tlib.build_segmentator(os.path.join(copy, "gdino"), pcfg.sam, pcfg.gdino, "cpu")
    else:
        os.remove(os.path.join(copy, "imagebind_huge.pth"))
    with pytest.raises(FileNotFoundError):
        tpl.InstructAny2PixPipeline(pcfg, ckpt=copy, device="cpu", policy=FP32)


# -------------------------------------------------------------- key maps


def _round_trip(km, module):
    named = {n: p.detach() for n, p in module.named_parameters()}
    back = km.to_port(km.to_ref(named))
    assert back.keys() == named.keys()
    for n, t in named.items():
        assert torch.equal(back[n], t), n


@pytest.mark.parametrize("model", ["llm", "prior", "unet", "vae", "text", "imagebind", "ip_adapter",
                                   "sam", "gdino"])
def test_keymaps_read_both_ways(tree, model):
    """Port tensors written under the reference keys (`to_ref`) map back
    to the same tensors; each model drawn at random at its tiny size."""
    from instructany2pix_tpu_torch.diffusion import ip_adapter as tipa
    from instructany2pix_tpu_torch.models import clip as tclip
    from instructany2pix_tpu_torch.models import imagebind as tib
    from instructany2pix_tpu_torch.models import unet as tunet
    from instructany2pix_tpu_torch.models import unet_convert
    from instructany2pix_tpu_torch.models import vae as tvae
    from instructany2pix_tpu_torch.prior import model as tprior

    _, _, c = tree
    gen = torch.Generator().manual_seed(0)

    def rand(make):
        with torch.device("meta"):
            m = make()
        m = L.materialize(m, torch.device("cpu"), torch.float32)
        for p in m.parameters():
            p.data.normal_(generator=gen)
        return m

    if model == "imagebind":
        v = rand(lambda: tib.ViT(c.imagebind_vision))
        a = rand(lambda: tib.ViT(c.imagebind_audio, num_patches=8, bias_kv=True, patch_norm=True))
        both = torch.nn.ModuleDict({"vision": v, "audio": a})
        return _round_trip(tib.file_keymap(), both)
    if model == "ip_adapter":
        unet = rand(lambda: tunet.UNet(c.unet))
        paths = unet_convert.cross_attn_paths(c.unet)
        km = tipa.ip_attn_keymap(paths)
        named = {n: p for n, p in unet.named_parameters() if "_ip." in n}
        ref = km.to_ref(named)
        assert sorted(ref) == sorted(f"ip_adapter.{2 * i + 1}.to_{w}_ip.weight"
                                     for i in range(len(paths)) for w in "kv")
        return _round_trip(tipa.image_proj_keymap(), rand(lambda: tipa.ImageProj(c.image_proj)))
    make, km = {
        "llm": (lambda: tmm.Any2PixLM(c.llm), tmm.keymap()),
        "prior": (lambda: tprior.Prior(c.prior, output_proj=True), tprior.keymap()),
        "unet": (lambda: tunet.UNet(dataclasses.replace(c.unet, with_ip=False)),
                 unet_convert.unet_keymap()),
        "vae": (lambda: tvae.VAE(c.vae), unet_convert.vae_keymap()),
        "text": (lambda: tclip.CLIPText(c.text2), tclip.text_keymap()),
        "sam": (lambda: tsam.SAM(c.sam), tsam.keymap(c.sam)),
        "gdino": (lambda: tgdino.GDino(c.gdino), tgdino.keymap(c.gdino)),
    }[model]
    _round_trip(km, rand(make))


def test_aliases_and_ignored_keys(tree):
    """GroundingDINO's `module.` prefix and the decoder's copy of the box
    heads are read as the top-level keys; buffers on the ignore list are
    skipped."""
    root, _, pcfg = tree
    sd = ckpt_lib.load_torch_state_dict(os.path.join(root, "gdino", "gdino.pth"))
    km = tgdino.keymap(pcfg.gdino)
    want = km.to_port(sd)
    extra = {f"module.{k}": v for k, v in sd.items()}
    for k, v in sd.items():
        if k.startswith("bbox_embed."):
            extra[f"module.transformer.decoder.{k}"] = v + 1  # never read: the shared copy
    extra["module.backbone.0.layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(4, 4)
    got = km.to_port(extra)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------- tokenizer


def test_tokenizer_directory_needs_transformers(tree, monkeypatch):
    """A tokenizer directory that cannot be read raises and names the
    package; no directory gives the byte tokenizer, as in the JAX package."""
    import builtins

    root, _, _ = tree
    real_import = builtins.__import__

    def no_transformers(name, *a, **k):
        if name == "transformers" or name.startswith("transformers."):
            raise ImportError("No module named 'transformers'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_transformers)
    with pytest.raises(ImportError, match="transformers"):
        ttok.load_tokenizer(os.path.join(root, LLM, "tokenizer"))
    assert isinstance(ttok.load_tokenizer(os.path.join(root, "nowhere")), ttok.ByteTokenizer)
    assert isinstance(ttok.load_tokenizer(None), ttok.ByteTokenizer)
