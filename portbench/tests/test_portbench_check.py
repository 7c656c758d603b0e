"""The check at a size the CPU holds: the served path passes against the plain
reference; the control and the faults a serving cell can have fail it."""

import numpy as np
import pytest
import torch

from portbench import check, generator, run
from portbench.tests.tiny import stdlib_serve, tiny_cell

SEED = 2**33 + 17  # more than 32 bits, as the checks' seeds are


@pytest.fixture(autouse=True)
def eager_compile():
    """Compiled blocks and extras through dynamo with the aot_eager backend: the
    compiled path's graphs without a C++ or Triton compile."""
    import flux_fp8_api_tpu_torch.models.flux as flux

    torch.set_num_threads(4)
    old = flux.COMPILE_BACKEND
    flux.COMPILE_BACKEND = "aot_eager"
    flux.reset_compiled()
    yield
    flux.COMPILE_BACKEND = old
    flux.reset_compiled()


def tiny_run(version="flux-dev", **cell):
    return run.run_cell(tiny_cell(version, **cell), SEED, seconds=1.5, trace=False, device="cpu", serve=stdlib_serve)


@pytest.mark.parametrize("version", ["flux-dev", "flux-schnell"])
def test_served_path_matches_the_reference(version):
    res = tiny_run(version)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert list(res)[-1] == "check"
    assert set(res["metrics"]) == {"images_per_s", "first_byte_p95_s", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    phases = res["setup_phases"]
    assert list(phases) == ["import", "flow", "ae", "text", "calibrate", "warm", "serve", "http_warm"]
    assert sum(phases.values()) == pytest.approx(res["metrics"]["setup_s"]["value"], rel=1e-9)


def test_control_fails_the_check():
    cell = tiny_cell()
    bodies = [generator.request(SEED, i, cell["mix"]) for i in range(2)]
    numbers = cell["family"].control(cell["spec"], SEED, bodies, "cpu")
    assert not check.verdict(numbers, cell["limits"]), numbers


# 7 steps at interval 3 (warmup 2, tail 1): steps 0, 1, 3 and 6 evaluate, 2, 4 and 5 skip
CACHE3 = {"cache": {"mode": "interval", "interval": 3}}


@pytest.mark.parametrize("order", [0, 1])
def test_the_cached_path_matches_the_reference(order):
    res = tiny_run(steps=7, body={"cache": {**CACHE3["cache"], "order": order}}, limits="dev-1024-cache3")
    assert res["correct"], res["check"]
    assert res["check"]["evaluations_off"] == {"value": 0.0, "limit": 0}
    assert list(res["check"]) == ["t5_rel", "clip_rel", "latent_rel", "pixel_mad", "evaluations_off"]


def test_a_served_path_that_ignores_the_cache_fails(monkeypatch):
    import flux_fp8_api_tpu_torch.pipeline as pipeline_mod

    denoise = pipeline_mod.denoise
    monkeypatch.setattr(pipeline_mod, "denoise", lambda *a, **k: denoise(*a, **{**k, "cache": None}))
    res = tiny_run(steps=7, body=CACHE3, limits="dev-1024-cache3")
    assert not res["correct"] and res["check"]["evaluations_off"]["value"] == 3.0


def test_the_uncached_control_fails_a_cached_cell():
    cell = tiny_cell(steps=7, body=CACHE3, limits="dev-1024-cache3")
    bodies = [generator.request(SEED, i, cell["mix"]) for i in range(2)]
    numbers = cell["family"].control(cell["spec"], SEED, bodies, "cpu", "uncached")
    assert numbers["evaluations_off"] == 3.0 and numbers["latent_rel"] > cell["limits"]["latent_rel"]
    assert not check.verdict(numbers, cell["limits"])


@pytest.mark.parametrize("body,field", [
    ({"cache": {"mode": "dynamic", "threshold": 0.25}}, "dynamic"),
    ({"init_image": "aGVsbG8="}, "init_image"),
    ({"strength": 0.6}, "strength"),
])
def test_a_body_the_reference_does_not_model_is_refused_before_set_up(body, field):
    with pytest.raises(ValueError, match=field):
        tiny_run(body=body)


def test_a_step_that_returns_its_state_unchanged_fails(monkeypatch):
    import flux_fp8_api_tpu_torch.sampling as sampling

    monkeypatch.setattr(sampling, "_update", lambda img, dt, pred: img + 0 * pred)
    res = tiny_run()
    assert not res["correct"] and res["check"]["latent_rel"]["value"] > res["check"]["latent_rel"]["limit"]


def test_an_answer_altered_where_it_is_produced_fails(monkeypatch):
    from flux_fp8_api_tpu_torch.image_encoder import ImageEncoder

    encode = ImageEncoder.encode_array

    def altered(self, x, quality=95):
        x = np.array(x)
        x[..., :8, :] = 255 - x[..., :8, :]  # eight columns inverted
        return encode(self, x, quality)

    monkeypatch.setattr(ImageEncoder, "encode_array", altered)
    res = tiny_run()
    assert not res["correct"] and res["check"]["pixel_mad"]["value"] > res["check"]["pixel_mad"]["limit"]


@pytest.mark.cuda
def test_tiny_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = tiny_cell()
    cell["spec"]["spec"].update(flux_device="cuda:0", ae_device="cuda:0", text_enc_device="cuda:0")
    res = run.run_cell(cell, SEED, seconds=0.5, trace=False, device="cuda", serve=stdlib_serve)
    assert res["correct"], res["check"]
