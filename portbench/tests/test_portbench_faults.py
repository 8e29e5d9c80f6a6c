"""A run whose timed path is broken underneath comes out not correct:
the harness's look for a chip is skipped and the rest of a run is driven
on the CPU at tiny sizes, once per fault the cells can have. (The cells
run on one chip, so no exchange between chips can be left out.)"""

from __future__ import annotations

import pytest
import torch
from tinybench import run_tiny


def _state_unchanged(mp):
    """Every denoising step returns the latent it was given."""
    from instructany2pix_tpu_torch.diffusion import schedulers

    mp.setattr(schedulers.Schedule, "ddim_step",
               lambda self, model_out, t, t_prev, sample, eta=0.0, noise=None: sample)


def _half_batch(mp):
    """The batched denoise computes the first half of its rows and gives
    their mean to the rest."""
    from instructany2pix_tpu_torch import serving

    real = serving.BatchedDenoiser.denoise

    def denoise(self, lat, *a, **kw):
        out = real(self, lat, *a, **kw)
        half = max(1, out.shape[0] // 2)
        out[half:] = out[:half].mean(dim=0, keepdim=True)
        return out

    mp.setattr(serving.BatchedDenoiser, "denoise", denoise)


def _answer_altered(mp):
    """The decoded image is shifted where it is produced."""
    from instructany2pix_tpu_torch.models import vae

    real = vae.decode
    mp.setattr(vae, "decode", lambda *a, **kw: torch.clamp(real(*a, **kw) + 0.1, -1, 1))


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}
CASES = [("tiny-serve", f) for f in FAULTS] + [("tiny-single", "state_unchanged"),
                                              ("tiny-single", "answer_altered")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    result = run_tiny(tiny_root, cell)
    assert result["correct"] is False, result["checks"]


def test_the_sound_path_is_correct(tiny_root):
    result = run_tiny(tiny_root, "tiny-serve")
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 2 and result["failed"] == 0
