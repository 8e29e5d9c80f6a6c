"""The port's serving front end (`serve.py`) vs the JAX package's: marker
parsing (the cases of tests/test_serve_train.py), `run` handing every
argument to the pipeline's `__call__`, and a marker error coming back as
the caption. No pipeline is built: `run` gets a stub."""

import sys

import pytest

from instructany2pix_tpu import serve as jserve
from instructany2pix_tpu_torch import serve


def test_parse_rewrites_markers_in_order():
    uploads = {"image1": "i.png", "audio1": "a.wav"}
    inst, mm_data = serve.parse_instruction("add [audio1] to [image1]", uploads)
    assert inst == "add <video> to <video>"
    assert mm_data == [{"type": "audio", "fname": "a.wav"}, {"type": "image", "fname": "i.png"}]
    assert (inst, mm_data) == jserve.parse_instruction("add [audio1] to [image1]", uploads)


@pytest.mark.parametrize("inst,uploads", [
    ("use [image9]", {}),
    ("[image1] and [image1]", {"image1": "x"}),
    ("[image1]", {}),
    ("hello", {"image1": "x"}),
])
def test_parse_rejects_bad_inputs(inst, uploads):
    with pytest.raises(serve.MarkerError) as port_err:
        serve.parse_instruction(inst, uploads)
    with pytest.raises(jserve.MarkerError) as jax_err:
        jserve.parse_instruction(inst, uploads)
    assert str(port_err.value) == str(jax_err.value)


def test_marks_and_example_match_jax():
    assert serve.VALID_MARKS == jserve.VALID_MARKS
    assert serve.EXAMPLE == jserve.EXAMPLE
    inst, mm = serve.parse_instruction(serve.EXAMPLE["instruction"],
                                       {"image1": "shop.png", "audio1": "clock.wav"})
    assert inst.count("<video>") == len(mm) == 2


class _StubPipe:
    def __init__(self, msg="a caption", refined="refined"):
        self.calls = []
        self.msg, self.refined = msg, refined

    def __call__(self, inst, mm_data, **kw):
        self.calls.append((inst, mm_data, kw))
        return "non_refined", self.refined, self.msg


def test_run_hands_every_argument_to_the_pipeline():
    pipe = _StubPipe()
    caption, image = serve.run(pipe, "add [audio1] to [image1]", {"image1": "i.png", "audio1": "a.wav"},
                               alpha=0.6, h0=0.1, h1=0.3, h2=0.9, norm=15.0, refinement=0.25, steps=12,
                               seed=5, subject_refinement=0.4, cfg=7.5, mode="ipa_lcm")
    assert (caption, image) == ("a caption", "refined")
    inst, mm_data, kw = pipe.calls[0]
    assert inst == "add <video> to <video>" and len(mm_data) == 2
    assert kw == dict(alpha=0.6, h=(0.1, 0.3, 0.9), norm=15.0, refinement=0.25,
                      num_inference_steps=12, diffusion_mode="ipa_lcm", subject_strength=0.4,
                      cfg=7.5, seed=5)
    jpipe = _StubPipe()
    jserve.run(jpipe, "add [audio1] to [image1]", {"image1": "i.png", "audio1": "a.wav"},
               alpha=0.6, h0=0.1, h1=0.3, h2=0.9, norm=15.0, refinement=0.25, steps=12,
               seed=5, subject_refinement=0.4, cfg=7.5, mode="ipa_lcm")
    assert jpipe.calls == pipe.calls


def test_run_answers_a_marker_error_as_the_caption():
    pipe = _StubPipe()
    caption, image = serve.run(pipe, "use [image9]", {})
    assert image is None and "unknown markers" in caption and not pipe.calls


def test_run_reads_a_dict_message_and_falls_back_to_the_non_refined_image():
    pipe = _StubPipe(msg={"output_caption": "from a dict"}, refined=None)
    assert serve.run(pipe, "draw [image1]", {"image1": "x.png"}) == ("from a dict", "non_refined")
    assert serve.run(_StubPipe(msg={}), "draw [image1]", {"image1": "x.png"})[0] == ""


def test_the_ui_names_gradio_when_it_is_missing(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="gradio"):
        serve.build_demo(_StubPipe())
    with pytest.raises(ImportError, match="gradio"):
        serve.main(device="cpu")
