"""Serving front-end: instruction-marker parsing + gradio Blocks UI,
counterpart of the JAX package's `serve.py`.

Rebuild of reference serve.py:13-115. The request-handling logic
(`parse_instruction`, `run`) is importable and testable without gradio;
`build_demo()` and `main()` need gradio, imported when they are called,
and raise `ImportError` naming it where it is not installed.

    python -m instructany2pix_tpu_torch.serve

builds the pipeline on the GPU from `ckpts/` (`llm_folder="llm-instance"`)
and serves the UI; the batched server for many users is `serving.py`.

Marker contract (reference serve.py:13-36): instructions reference
uploaded media as [image1]..[image3], [audio1]..[audio3]; each used
slot must be uploaded, duplicates are rejected, unreferenced uploads
are rejected; markers rewrite to `<video>` before hitting the LLM.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

VALID_MARKS = ["[image1]", "[image2]", "[image3]", "[audio1]", "[audio2]", "[audio3]"]


class MarkerError(ValueError):
    pass


def parse_instruction(
    instruction: str, uploads: Dict[str, Optional[str]]
) -> Tuple[str, List[dict]]:
    """Validate markers and build (rewritten_instruction, mm_data).

    uploads: {"image1": path|None, ..., "audio3": path|None}.
    Raises MarkerError on: unknown marker, duplicate use, marker
    without an upload, or upload without a marker.
    """
    marks = re.findall(r"\[(?:image|audio)\d+\]", instruction)
    unknown = [m for m in marks if m not in VALID_MARKS]
    if unknown:
        raise MarkerError(f"unknown markers: {unknown}")
    if len(set(marks)) != len(marks):
        raise MarkerError("duplicate markers in instruction")
    used = {m.strip("[]") for m in marks}
    have = {k for k, v in uploads.items() if v}
    missing = used - have
    if missing:
        raise MarkerError(f"markers without uploads: {sorted(missing)}")
    extra = have - used
    if extra:
        raise MarkerError(f"uploads not referenced: {sorted(extra)}")

    mm_data = []
    out = instruction
    # mm_data order follows marker appearance order (the j-th <video>
    # splices the j-th embedding)
    for m in marks:
        slot = m.strip("[]")
        kind = "image" if slot.startswith("image") else "audio"
        mm_data.append({"type": kind, "fname": uploads[slot]})
        out = out.replace(m, "<video>", 1)
    return out, mm_data


def run(
    pipe,
    instruction: str,
    uploads: Dict[str, Optional[str]],
    alpha: float = 0.7,
    h0: float = 0.0,
    h1: float = 0.4,
    h2: float = 1.0,
    norm: float = 20.0,
    refinement: float = 0.5,
    steps: int = 25,
    seed: int = 42,
    subject_refinement: float = 0.0,
    cfg: float = 10.0,
    mode: str = "default",
):
    """Gradio callback body (reference serve.py:14-45)."""
    try:
        inst, mm_data = parse_instruction(instruction, uploads)
    except MarkerError as e:
        return str(e), None
    non_refined, refined, msg = pipe(
        inst,
        mm_data,
        alpha=alpha,
        h=(h0, h1, h2),
        norm=norm,
        refinement=refinement,
        num_inference_steps=steps,
        diffusion_mode=mode,
        subject_strength=subject_refinement,
        cfg=cfg,
        seed=seed,
    )
    caption = msg if isinstance(msg, str) else msg.get("output_caption", "")
    return caption, refined if refined is not None else non_refined


EXAMPLE = {
    "instruction": "add [audio1] to [image1]",
    "description": "antique shop + clock ticking (reference serve.py:48-56)",
}


def _gradio():
    try:
        import gradio
    except ImportError as e:
        raise ImportError("the UI needs the `gradio` package, which is not installed; "
                          "`run` and `serving.PipelineServer` work without it") from e
    return gradio


def build_demo(pipe):
    """Gradio Blocks UI with the reference's control surface
    (serve.py:59-115). Requires gradio."""
    gr = _gradio()

    with gr.Blocks() as demo:
        gr.Markdown("# InstructAny2Pix")
        with gr.Row():
            with gr.Column():
                inst = gr.Textbox(label="Instruction", value=EXAMPLE["instruction"])
                images = [gr.Image(type="filepath", label=f"image{i}") for i in (1, 2, 3)]
                audios = [gr.Audio(type="filepath", label=f"audio{i}") for i in (1, 2, 3)]
                alpha = gr.Slider(0, 1, value=0.7, label="alpha")
                h0 = gr.Slider(0, 1, value=0.0, label="h0")
                h1 = gr.Slider(0, 1, value=0.4, label="h1")
                h2 = gr.Slider(0, 1, value=1.0, label="h2")
                norm = gr.Slider(0, 40, value=20.0, label="norm")
                refinement = gr.Slider(0, 1, value=0.5, label="refinement")
                steps = gr.Slider(10, 50, value=25, step=1, label="steps")
                seed = gr.Number(value=42, label="seed")
                subject = gr.Slider(0, 1, value=0.0, label="subject_refinement")
                cfg = gr.Slider(1, 20, value=10.0, label="cfg")
                mode = gr.Dropdown(["ipa", "ipa_lcm", "default"], value="default", label="mode")
                btn = gr.Button("Generate")
            with gr.Column():
                caption = gr.Textbox(label="caption")
                out = gr.Image(label="result")

        def _cb(inst_v, i1, i2, i3, a1, a2, a3, *args):
            uploads = {
                "image1": i1, "image2": i2, "image3": i3,
                "audio1": a1, "audio2": a2, "audio3": a3,
            }
            return run(pipe, inst_v, uploads, *args)

        btn.click(
            _cb,
            [inst, *images, *audios, alpha, h0, h1, h2, norm, refinement, steps,
             seed, subject, cfg, mode],
            [caption, out],
        )
    return demo


def main(device=None):
    """The UI over one pipeline on `device` (the GPU unless the caller
    passes "cpu")."""
    _gradio()  # before the pipeline's boot, not after it
    from .pipeline import InstructAny2PixPipeline

    pipe = InstructAny2PixPipeline(llm_folder="llm-instance", device=device)
    demo = build_demo(pipe)
    demo.queue(max_size=20)
    demo.launch(server_name="0.0.0.0")


if __name__ == "__main__":
    main()
