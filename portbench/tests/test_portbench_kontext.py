"""The Kontext family at a size the CPU holds: the editing loop's images, the
configuration against the shipped file and the published widths, the served path
against the reference through the whole harness, the faults and controls that must
fail it, and the context path's reader."""

import json
from pathlib import Path

import pytest
import torch

import flux_fp8_api_tpu_torch.pipeline as tpipeline
from portbench import check, generator, images, run
from portbench.generator import Record
from portbench.reference import kontext as rkontext
from portbench.tests.tiny import stdlib_serve, tiny_cell
from portbench.traffic import closed_edit

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**33 + 29
# the preferred resolutions shrunk to sizes the CPU holds, in the port and the reference alike
SMALL = ((64, 64), (48, 80), (80, 48))
PUBLISHED = rkontext.PREFERRED_RESOLUTIONS


@pytest.fixture(autouse=True)
def small(monkeypatch):
    import flux_fp8_api_tpu_torch.models.flux as flux

    torch.set_num_threads(4)
    monkeypatch.setattr(tpipeline, "PREFERRED_KONTEXT_RESOLUTIONS", SMALL)
    monkeypatch.setattr(rkontext, "PREFERRED_RESOLUTIONS", SMALL)
    old = flux.COMPILE_BACKEND
    flux.COMPILE_BACKEND = "aot_eager"
    flux.reset_compiled()
    yield
    flux.COMPILE_BACKEND = old
    flux.reset_compiled()


def kontext_cell(steps=3):
    """The tiny cell of ``tiny.py`` as the Kontext family serves it: the editing loop,
    guidance 2.5, the limits of ``kontext-1024``."""
    cell = tiny_cell("flux-dev", steps=steps, limits="dev-1024")
    cell["spec"]["family"] = "kontext"
    cell["spec"]["spec"]["version"] = "flux-dev-kontext"
    cell["family"] = run.load_family("kontext")
    cell["mix"].update(loop="closed_edit", body={"guidance": 2.5})
    cell["limits"] = json.loads((ROOT / "portbench" / "limits" / "kontext-1024.json").read_text())
    return cell


def float_cell(steps=3):
    """The tiny cell at the float tier, eager. Over eight requests the served latents
    read ``latent_rel`` 0.0048-0.0112 here (bf16 against float32) and the reference
    without the context 0.066-0.115, so ``latent_rel`` is judged at 0.03, between them;
    at the fp8 tier the sound readings (0.018-0.035) come too near the context's own
    effect (0.066-0.107) at 3 steps of a 5-block flow."""
    cell = kontext_cell(steps)
    cell["spec"]["spec"].update(flow_quantization_dtype=None, text_enc_quantization_dtype=None,
                                compile_blocks=False, compile_extras=False)
    cell["limits"]["latent_rel"] = 0.03
    return cell


def tiny_run(cell=None):
    return run.run_cell(cell or kontext_cell(), SEED, seconds=1.5, trace=False, device="cpu", serve=stdlib_serve)


def test_request_i_s_image_depends_on_seed_and_index_alone():
    mix = kontext_cell()["mix"]
    a = closed_edit.body(SEED, 3, mix)
    assert a == closed_edit.body(SEED, 3, mix) and a["input_image"] == images.input_image(SEED, 3, 64, 64)
    assert a["input_image"] != closed_edit.body(SEED + 1, 3, mix)["input_image"]
    assert a["input_image"] != closed_edit.body(SEED, 4, mix)["input_image"]
    assert {k: v for k, v in a.items() if k != "input_image"} == generator.request(SEED, 3, mix)
    assert rkontext.decode_image(a["input_image"]).shape == (64, 64, 3)


def test_the_configuration_is_the_shipped_file_at_published_widths():
    spec = json.loads((ROOT / "portbench" / "configs" / "flux-kontext-dev-fp8.json").read_text())
    assert spec["spec"] == json.loads((ROOT / "configs" / "kontext" / "config-kontext-dev.json").read_text())
    family = run.load_family(spec["family"])
    assert family.widths(spec) == family.PUBLISHED[spec["source"]] and spec["reduced"] == []
    dev = json.loads((ROOT / "configs" / "config-dev.json").read_text())
    assert {k: v for k, v in spec["spec"].items() if k not in ("version", "repo_id", "repo_flow")} == \
        {k: v for k, v in dev.items() if k not in ("version", "repo_id", "repo_flow")}


@pytest.mark.parametrize("cell", [kontext_cell, float_cell])
def test_the_served_edit_matches_the_reference(cell):
    res = tiny_run(cell())
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert list(res["check"]) == ["t5_rel", "clip_rel", "latent_rel", "pixel_mad", "context_rel", "context_ids_off"]
    assert res["check"]["context_ids_off"] == {"value": 0.0, "limit": 0}


def test_a_served_latent_without_the_context_fails(monkeypatch):
    denoise = tpipeline.denoise
    monkeypatch.setattr(tpipeline, "denoise",
                        lambda *a, **k: denoise(*a, **{**k, "context": None, "context_ids": None}))
    res = tiny_run(float_cell())
    assert not res["correct"] and res["check"]["latent_rel"]["value"] > res["check"]["latent_rel"]["limit"]


def test_a_context_at_rope_index_0_fails(monkeypatch):
    """Caught by its ids: the latents move too little to tell (PERF.md)."""
    ids = tpipeline.make_img_ids
    monkeypatch.setattr(tpipeline, "make_img_ids", lambda *a, **k: ids(*a, **{**k, "first": 0}))
    res = tiny_run()
    assert not res["correct"] and res["check"]["context_ids_off"]["value"] == 1.0


@pytest.mark.parametrize("name,make", [("lower", kontext_cell), ("no_context", float_cell)])
def test_the_controls_fail_the_check(name, make):
    cell = make()
    bodies = [generator.request(SEED, i, cell["mix"]) for i in range(2)]
    numbers = cell["family"].control(cell["spec"], SEED, bodies, "cpu", name)
    assert not check.verdict(numbers, cell["limits"]), numbers
    if name == "no_context":
        assert numbers["latent_rel"] > cell["limits"]["latent_rel"]
        assert numbers["context_rel"] == numbers["t5_rel"] == numbers["pixel_mad"] == numbers["context_ids_off"] == 0.0


def test_a_step_cache_is_refused_before_set_up():
    cell = kontext_cell()
    cell["mix"]["body"]["cache"] = {"mode": "interval", "interval": 3}
    with pytest.raises(ValueError, match="cache"):
        tiny_run(cell)


def _record(i, **timings):
    body = {"width": 1024, "height": 1024, "num_steps": 28, "prompt": "p", "seed": i}
    return Record(i, body, sent=10.0 * i, done=10.0 * i + 7.0, status=200, payload=b"x",
                  kept={"timings": {"denoise_seconds": 6.0, "denoise_it_per_s": 28 / 6.0, **timings}})


def test_context_encode_ms_reads_the_context_span():
    c = run.load_cell("kontext-1024")
    data = run.RunData(c["family"], c["spec"], c["mix"], [_record(0, context_seconds=0.080), _record(1),
                                                          _record(2, context_seconds=0.100)])
    assert run.read_metric("context.encode_ms", data) == pytest.approx(90.0)
    assert run.read_metric("context.encode_ms", run.RunData(c["family"], c["spec"], c["mix"], [_record(0)])) is None


def test_the_readers_count_the_context_tokens(monkeypatch):
    monkeypatch.setattr(rkontext, "PREFERRED_RESOLUTIONS", PUBLISHED)
    c = run.load_cell("kontext-1024")
    fam, spec = c["family"], c["spec"]
    text = generator.request(SEED, 0, c["mix"])
    edit = closed_edit.body(SEED, 0, c["mix"])
    assert fam.lengths(spec, text) == (4096, 512) and fam.lengths(spec, edit) == (8192, 512)
    assert fam.attention_ms(spec, edit) / fam.attention_ms(spec, text) == pytest.approx((8704 / 4608) ** 2)
    assert fam.fp8_linears_ms(spec, edit) > 1.8 * fam.fp8_linears_ms(spec, text)
