"""The port's text2img slice as a whole vs the JAX pipeline at the tiny
config: same converted weights, same start latent (the JAX draw handed to
the port), float32 on the CPU. `from_model_range` truncates to uint8, so
a last-digit difference may flip one level: images agree within 1."""

import os

import jax
import numpy as np
import pytest
import torch

from instructany2pix_tpu.core.prng import KeyChain
from instructany2pix_tpu.pipeline import InstructAny2PixPipeline as JaxPipeline
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch import pipeline as tpl
from instructany2pix_tpu_torch.core.device import resolve_device
from instructany2pix_tpu_torch.core.dtypes import FP32
from instructany2pix_tpu_torch.pipeline import InstructAny2PixPipeline, PipelineConfig

UINT8_TOL = 1


@pytest.fixture(scope="module")
def pipes():
    jp = JaxPipeline(tiny=True, seed=0)
    tp = InstructAny2PixPipeline(PipelineConfig.tiny(), params=convert.pipeline_params(jp.params),
                                 device="cpu", policy=FP32)
    return jp, tp


@pytest.mark.parametrize("seed,with_ip", [(3, True), (5, False)])
def test_text2img_matches_jax(pipes, seed, with_ip):
    jp, tp = pipes
    e = np.random.RandomState(seed).randn(16).astype(np.float32) if with_ip else None
    ref = jp.text2img("a cat in an antique shop", num_inference_steps=3, seed=seed, ip_embeds=e)
    h = tp.cfg.image_size // 2 ** (len(tp.cfg.vae.block_out_channels) - 1)
    lat = np.asarray(jax.random.normal(KeyChain(seed)(), (1, h, h, 4)))
    out = tp.text2img("a cat in an antique shop", num_inference_steps=3, seed=seed,
                      ip_embeds=e, latents=lat)
    assert out.shape == ref.shape == (64, 64, 3) and out.dtype == np.uint8
    d = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= UINT8_TOL, (
        f"seed {seed}: max {d.max()} levels, mean {d.mean():.4g}, {int((d > 0).sum())} differ")


def test_config_matches_jax_for_the_slice(pipes):
    jp, tp = pipes
    for field in ("unet", "refiner", "inpaint_unet", "vae", "text1", "text2", "image_proj"):
        assert vars(getattr(tp.cfg, field)) == vars(getattr(jp.cfg, field)), field
    assert tp.cfg.image_size == jp.cfg.image_size


def test_seeded_noise_is_deterministic(pipes):
    _, tp = pipes
    a = tp.text2img("a cat", num_inference_steps=2, seed=7)
    b = tp.text2img("a cat", num_inference_steps=2, seed=7)
    assert np.array_equal(a, b)


def test_entry_points_refuse_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        InstructAny2PixPipeline(PipelineConfig.tiny())
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("llm_folder", ["llm-retrained", "my-llm"])
def test_checkpoints_on_disk_are_loaded_not_drawn(pipes, tmp_path, monkeypatch, llm_folder):
    """With <ckpt>/<llm_folder> on disk and no `params`, the constructor
    loads the checkpoints, as the JAX one does; a folder without weight
    shards raises `FileNotFoundError` and no random module is drawn in
    their place. Given `params` it builds from them as before."""
    os.makedirs(tmp_path / llm_folder)

    def no_module(*_a, **_k):
        raise AssertionError("a random module was drawn beside checkpoints on disk")

    with monkeypatch.context() as m:
        m.setattr(tpl, "_random_module", no_module)
        m.setattr(tpl, "_random_llm", no_module)
        with pytest.raises(FileNotFoundError, match="no weight shards"):
            InstructAny2PixPipeline(PipelineConfig.tiny(), device="cpu", policy=FP32,
                                    ckpt=str(tmp_path), llm_folder=llm_folder)
    jp, tp = pipes
    built = InstructAny2PixPipeline(PipelineConfig.tiny(), params=convert.pipeline_params(jp.params),
                                    device="cpu", policy=FP32, ckpt=str(tmp_path),
                                    llm_folder=llm_folder)
    assert built.models.keys() == tp.models.keys()
