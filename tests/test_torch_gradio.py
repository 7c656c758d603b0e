"""The Gradio front end (``main_gr.py``) on the CPU: the JAX package's
tests/test_gradio_ui.py cases against the port's helpers, with the JAX helpers' outputs
beside them; the presets against the web page's (webui.py) and the JAX UI's; the
missing-gradio error; and the UI built on a stand-in gradio module, its buttons
driving a tiny pipeline (gradio is not a dependency of the port)."""

import json
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch
from PIL import Image

from flux_fp8_api_tpu import main_gr as jmain_gr
from flux_fp8_api_tpu_torch import main_gr, webui
from flux_fp8_api_tpu_torch.pipeline import FluxPipeline

torch.set_num_threads(1)


@pytest.mark.parametrize("raw,want", [("", None), ("  ", None), ("-1", None), (None, None), ("42", 42), (0, 0),
                                      ("not a seed", None)])
def test_seed_resolution_matches_jax(raw, want):
    assert main_gr.resolve_seed(raw) == jmain_gr.resolve_seed(raw) == want


def test_settings_record_matches_jax():
    rec = main_gr.settings_record("a cat", 1024.0, 768.0, 28.0, 3.5, 7)
    assert rec == jmain_gr.settings_record("a cat", 1024.0, 768.0, 28.0, 3.5, 7) == {
        "prompt": "a cat", "width": 1024, "height": 768, "num_steps": 28, "guidance": 3.5, "seed": 7}
    assert main_gr.settings_record("a cat", 64, 64, 2, 3.5, 7, strength=0.8)["strength"] == 0.8
    assert "strength" not in rec


def test_attach_metadata_survives_png_roundtrip():
    im = Image.fromarray(np.zeros((8, 8, 3), np.uint8))
    rec = main_gr.settings_record("x", 64, 64, 2, 3.5, 1)
    path = main_gr.attach_metadata(im, rec)
    try:
        assert json.loads(Image.open(path).info["parameters"]) == rec
    finally:
        os.unlink(path)


def test_presets_are_the_web_pages_and_the_jax_uis():
    """Resolutions: the JAX UI's, every one a multiple of 16. Step-cache presets: the
    web page's labels, and the same three cache specs as the JAX UI's."""
    assert main_gr.RESOLUTION_PRESETS == webui.RESOLUTION_PRESETS == jmain_gr.RESOLUTION_PRESETS
    for wh in main_gr.RESOLUTION_PRESETS.values():
        assert wh is None or (wh[0] % 16 == 0 and wh[1] % 16 == 0)
    assert main_gr.STEP_CACHE_CHOICES == webui.STEP_CACHE_PRESETS
    assert list(main_gr.STEP_CACHE_CHOICES.values()) == list(jmain_gr.STEP_CACHE_CHOICES.values())


def test_build_ui_without_gradio_raises_clear_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)  # not installed
    with pytest.raises(ImportError, match="gradio is not installed"):
        main_gr.build_ui(pipeline=None)


@pytest.fixture(scope="module")
def tiny_pipeline():
    return FluxPipeline.load_pipeline_from_config_path("configs/config-tiny-cpu.json")


def test_ui_buttons_drive_the_pipeline(monkeypatch, tiny_pipeline):
    """build_ui on a stand-in gradio: both tabs' buttons are wired to the pipeline.
    The text tab's callback with a preset, a seed and the metadata PNG; the image tab's
    with a source image and its strength in the record."""
    gr = mock.MagicMock()
    monkeypatch.setitem(sys.modules, "gradio", gr)
    main_gr.build_ui(tiny_pipeline)
    (t_call, i_call) = [c for c in gr.Button.return_value.click.call_args_list]
    run = t_call.args[0]
    assert len(t_call.kwargs["inputs"]) == 9 and len(i_call.kwargs["inputs"]) == 11
    monkeypatch.setitem(main_gr.RESOLUTION_PRESETS, "tiny", (64, 48))
    path, rec = run("a cat", "tiny", 1024, 1024, 2, 3.5, "5", True, next(iter(main_gr.STEP_CACHE_CHOICES)))
    try:
        assert Image.open(path).size == (64, 48)
        assert json.loads(Image.open(path).info["parameters"]) == json.loads(rec)
    finally:
        os.unlink(path)
    assert json.loads(rec) == main_gr.settings_record("a cat", 64, 48, 2, 3.5, 5)
    src = np.full((64, 64, 3), 127, np.uint8)
    img, rec = i_call.args[0]("a dog", "custom", 64, 64, 4, 3.5, "", False, None, src, 0.5)
    assert img.size == (64, 64) and json.loads(rec)["strength"] == 0.5
