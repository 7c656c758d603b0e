"""Gradio front end (JAX counterpart: ``flux_fp8_api_tpu.main_gr``; reference
``main_gr.py:1-132``): a text-to-image and an image-to-image tab with resolution
presets, steps, guidance, seed and step-cache controls, the settings of each image
shown and, optionally, written into its PNG.

gradio is imported when the UI is built, not with this module: where it is missing,
``build_ui`` raises an ``ImportError`` that names the HTTP server (``main.py``), which
serves the same pipeline with no extra package.

    python -m flux_fp8_api_tpu_torch.main_gr --config configs/config-dev.json
"""

from __future__ import annotations

import functools
import json
import os
import tempfile
from typing import Optional

from PIL import Image

from .webui import RESOLUTION_PRESETS, STEP_CACHE_PRESETS

# label → the request's ``cache``: the web page's presets (webui.py)
STEP_CACHE_CHOICES = STEP_CACHE_PRESETS

_STEP_LIMITS = (1, 50)
_SIZE_LIMITS = (128, 4096)  # the pipeline rounds to multiples of 16
_KEEP_PNGS = 16  # the newest metadata PNGs kept on disk; older ones are removed
_TEMP_PNGS: list = []


def resolve_seed(raw) -> Optional[int]:
    """The seed field → the pipeline's seed: blank or -1 (and anything not an int)
    mean a random one, as in the API."""
    if raw is None:
        return None
    text = str(raw).strip()
    if text in ("", "-1"):
        return None
    try:
        return int(text)
    except ValueError:
        return None


def settings_record(prompt, width, height, steps, guidance, seed, strength=None) -> dict:
    """The settings of one image, shown in the UI and written into its PNG."""
    rec = {
        "prompt": prompt,
        "width": int(width),
        "height": int(height),
        "num_steps": int(steps),
        "guidance": float(guidance),
        "seed": int(seed),
    }
    if strength is not None:
        rec["strength"] = float(strength)
    return rec


def attach_metadata(image: Image.Image, record: dict) -> str:
    """Write ``image`` to a PNG whose ``parameters`` text chunk holds ``record`` and
    return its path. PIL keeps text chunks only through an explicit ``PngInfo``, and
    gradio re-encodes images it is given, so the UI hands it the file."""
    from PIL.PngImagePlugin import PngInfo

    meta = PngInfo()
    meta.add_text("parameters", json.dumps(record))
    with tempfile.NamedTemporaryFile(suffix=".png", delete=False) as f:
        image.save(f, format="PNG", pnginfo=meta)
    _TEMP_PNGS.append(f.name)
    while len(_TEMP_PNGS) > _KEEP_PNGS:
        try:
            os.unlink(_TEMP_PNGS.pop(0))
        except OSError:
            pass
    return f.name


def run_generation(pipeline, prompt, preset, width, height, steps, guidance, seed_text, embed_meta,
                   cache_choice=None, source_image=None, strength=0.75):
    """One click of either tab → (image or PNG path, the settings as JSON)."""
    if RESOLUTION_PRESETS.get(preset):
        width, height = RESOLUTION_PRESETS[preset]
    jpeg, used_seed = pipeline.generate(
        prompt=prompt, width=int(width), height=int(height), num_steps=int(steps),
        guidance=float(guidance), seed=resolve_seed(seed_text), init_image=source_image,
        strength=float(strength), silent=True, return_seed=True,
        cache=STEP_CACHE_CHOICES.get(cache_choice),
    )
    img = Image.open(jpeg)
    rec = settings_record(prompt, width, height, steps, guidance, used_seed,
                          strength if source_image is not None else None)
    if embed_meta:
        img = attach_metadata(img, rec)
    return img, json.dumps(rec, indent=2)


def _gradio():
    try:
        import gradio
    except ImportError as e:
        raise ImportError(
            "gradio is not installed in this environment; use the HTTP server "
            "(python -m flux_fp8_api_tpu_torch.main) instead, or pip install gradio."
        ) from e
    return gradio


def build_ui(pipeline):
    """The Blocks app around a loaded FluxPipeline."""
    gr = _gradio()
    schnell = str(pipeline.config.version) == "flux-schnell"
    default_steps = 4 if schnell else 28
    run = functools.partial(run_generation, pipeline)

    def shared_controls():
        preset = gr.Dropdown(list(RESOLUTION_PRESETS), value="square 1024 (1:1)", label="Resolution")
        with gr.Row():
            width = gr.Slider(*_SIZE_LIMITS, value=1024, step=16, label="Width (custom)")
            height = gr.Slider(*_SIZE_LIMITS, value=1024, step=16, label="Height (custom)")
        steps = gr.Slider(*_STEP_LIMITS, value=default_steps, step=1, label="Denoise steps",
                          interactive=not schnell)
        guidance = gr.Slider(1.0, 10.0, value=3.5, step=0.1, label="Guidance scale", interactive=not schnell)
        seed_text = gr.Textbox(value="", label="Seed (blank or -1 = random)")
        embed_meta = gr.Checkbox(value=True, label="Embed settings in image metadata")
        cache_choice = gr.Dropdown(list(STEP_CACHE_CHOICES), value=next(iter(STEP_CACHE_CHOICES)),
                                   label="Step cache (speed ↔ fidelity)")
        return preset, width, height, steps, guidance, seed_text, embed_meta, cache_choice

    with gr.Blocks(title="flux-fp8 (PyTorch/CUDA)") as app:
        gr.Markdown(f"## flux-fp8 — {pipeline.config.version} on {pipeline.device_flux}")
        with gr.Tab("Text to image"):
            t_prompt = gr.Textbox(label="Prompt", lines=3, placeholder="describe the image to generate…")
            t_ctl = shared_controls()
            t_go = gr.Button("Generate", variant="primary")
            t_img = gr.Image(label="Result")
            t_rec = gr.Code(label="Generation settings", language="json")
            t_go.click(run, inputs=[t_prompt, *t_ctl], outputs=[t_img, t_rec])

        with gr.Tab("Image to image", interactive=not schnell):
            i_prompt = gr.Textbox(label="Prompt", lines=3)
            i_source = gr.Image(label="Source image", type="numpy")
            i_strength = gr.Slider(0.0, 1.0, value=0.75, step=0.05, label="Noising strength (1 = ignore source)")
            i_ctl = shared_controls()
            i_go = gr.Button("Generate from image", variant="primary")
            i_img = gr.Image(label="Result")
            i_rec = gr.Code(label="Generation settings", language="json")
            i_go.click(run, inputs=[i_prompt, *i_ctl, i_source, i_strength], outputs=[i_img, i_rec])
    return app


def create_demo(config_path: str):
    """Load the pipeline from a config JSON and return the Blocks app."""
    from .pipeline import FluxPipeline

    # the UI generates silently: compile() skips the interactive warm-up (JAX main_gr.py:200)
    return build_ui(FluxPipeline.load_pipeline_from_config_path(config_path, precompile_interactive=False))


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="flux-fp8 Gradio UI (PyTorch/CUDA)")
    parser.add_argument("--config", type=str, default="configs/config-dev.json")
    parser.add_argument("--share", action="store_true", help="Expose a public link")
    args = parser.parse_args(argv)
    create_demo(args.config).launch(share=args.share)


if __name__ == "__main__":
    main()
