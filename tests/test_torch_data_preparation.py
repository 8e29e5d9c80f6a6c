"""The port's offline ImageBind feature extraction against the JAX
package's `scripts/data_preparation.py` at tiny sizes, float32: the same
tiny encoders (JAX trees converted) embed the same image, WAV and `.npy`
files; the written `.npz` states are what `train.data.MediaMap` reads; the
`--tiny` entry point runs; a missing checkpoint without `--tiny` raises."""

import dataclasses
import importlib.util
import os
import wave

import jax
import numpy as np
import pytest

from instructany2pix_tpu.models import imagebind as jib
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch.models import imagebind as tib
from instructany2pix_tpu_torch.train import data as data_lib
from instructany2pix_tpu_torch.train import data_preparation as prep
from torch_port_helpers import one_torch_thread  # noqa: F401

TOL = 2e-5  # float32 both sides


def _jax_script():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "data_preparation.py")
    spec = importlib.util.spec_from_file_location("jax_data_preparation", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _media(d):
    from PIL import Image

    rs = np.random.RandomState(0)
    Image.fromarray(rs.randint(0, 255, (40, 52, 3), np.uint8)).save(os.path.join(d, "b_img.png"))
    with wave.open(os.path.join(d, "a_snd.wav"), "w") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.sin(np.arange(24000) * 0.03) * 8000).astype(np.int16).tobytes())
    np.save(os.path.join(d, "c_raw.npy"), (rs.randn(40000) * 0.1).astype(np.float32))
    (open(os.path.join(d, "notes.txt"), "w")).write("skipped")


def test_features_match_the_jax_script_and_feed_media_map(tmp_path):
    src, out = tmp_path / "media", tmp_path / "feats"
    src.mkdir()
    _media(str(src))
    from instructany2pix_tpu.pipeline import _audio_patches

    vcfg, acfg = jib.ViTConfig.tiny(), jib.ViTConfig.tiny(in_channels=1)
    vtree = convert.to_numpy(jib.init(jax.random.key(1), vcfg))
    atree = convert.to_numpy(jib.init(jax.random.key(2), acfg, num_patches=_audio_patches(acfg)))
    tv, ta = (tib.ViTConfig(**dataclasses.asdict(c)) for c in (vcfg, acfg))
    vision, audio = convert.imagebind(vtree, tv), convert.imagebind(atree, ta)

    written = prep.run(str(src), str(out), vision, tv, audio, ta, log=None)
    assert [os.path.basename(p) for p in written] == ["a_snd.npz", "b_img.npz", "c_raw.npz"]
    js = _jax_script()
    want = {"a_snd": js.process_one_audio(atree, acfg, str(src / "a_snd.wav")),
            "b_img": js.process_one_image(vtree, vcfg, str(src / "b_img.png")),
            "c_raw": js.process_one_audio(atree, acfg, str(src / "c_raw.npy"))}
    for stem, ref in want.items():
        state = np.load(out / f"{stem}.npz")["state"]
        assert state.dtype == np.float32 and state.shape == ref.shape == (16,)
        np.testing.assert_allclose(state, ref, atol=TOL, err_msg=stem)

    mm = data_lib.MediaMap({"a photo": "b_img.npz", "a sound": "a_snd.npz"}, str(out), 16)
    got = mm.get("a photo")
    state = np.load(out / "b_img.npz")["state"]
    np.testing.assert_allclose(got, state / np.linalg.norm(state) * 20.0, rtol=1e-6)
    assert np.allclose(np.linalg.norm(mm.get_batch(["a sound", "a photo"]), axis=-1), 20.0,
                       rtol=1e-5)


def test_entry_point_tiny_and_missing_checkpoint(tmp_path):
    src = tmp_path / "media"
    src.mkdir()
    _media(str(src))
    written = prep.main(["--input", str(src), "--output", str(tmp_path / "o"), "--tiny"],
                        device="cpu")
    assert len(written) == 3
    assert all(np.isfinite(np.load(p)["state"]).all() for p in written)
    with pytest.raises(FileNotFoundError, match="--tiny"):
        prep.main(["--input", str(src), "--output", str(tmp_path / "o2"),
                   "--ckpt", str(tmp_path / "absent.pth")], device="cpu")
    assert not (tmp_path / "o2").exists()
