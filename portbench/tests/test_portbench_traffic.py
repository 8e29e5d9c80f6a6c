"""The traffic is the same for one seed and differs between two, with the
same sizes."""

from __future__ import annotations

import numpy as np
import pytest
from tinybench import run_tiny

from portbench.traffic import Traffic

WL = {"caption_bytes": [8, 60], "alpha": 0.7, "h": [0.0, 0.4, 1.0], "norm": 20.0}


def _draw(seed, tmp_path, n=4):
    t = Traffic(WL, seed, 16, 64, 8, str(tmp_path / str(seed)))
    return [t.request(i) for i in range(n)]


def test_one_seed_gives_the_same_requests(tmp_path):
    a, b = _draw(2**31 + 99, tmp_path / "a"), _draw(2**31 + 99, tmp_path / "b")
    for x, y in zip(a, b):
        assert x.caption == y.caption and x.seed == y.seed
        for f in ("image_embeds", "base_embed", "vae_noise", "polar_noise", "refiner_vae_noise",
                  "refiner_noise"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
        with open(x.base_path, "rb") as fx, open(y.base_path, "rb") as fy:
            assert fx.read() == fy.read()


def test_two_seeds_give_other_requests_of_the_same_sizes(tmp_path):
    a, b = _draw(5, tmp_path), _draw(6, tmp_path)
    assert [x.caption for x in a] != [y.caption for y in b]
    for x, y in zip(a, b):
        assert not np.array_equal(x.vae_noise, y.vae_noise)
        assert x.vae_noise.shape == y.vae_noise.shape == (8, 8, 4)
        assert 8 <= len(x.caption.encode()) <= 60 and 8 <= len(y.caption.encode()) <= 60


@pytest.mark.parametrize("cell", ["tiny-serve", "tiny-single"])
def test_the_window_takes_only_requests_drawn_before_it(tiny_root, capfd, cell):
    """Drawing a request (a 1024² PNG in a cell) inside the window would
    cost host time that a faster program could not show: a run says so on
    standard error, and the tiny cells, whose windows hold many requests,
    never do."""
    result = run_tiny(tiny_root, cell)
    assert result["attempted"] >= 1
    assert "drawn inside the window" not in capfd.readouterr().err
