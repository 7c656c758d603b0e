"""The family seam: a configuration names its family, the harness loads the family's
module by that name and names no model itself, a family module the harness never
heard of runs a cell, and the check judges every number a family returns."""

import re
from pathlib import Path

import pytest
import torch

from portbench import check, run
from portbench.reference.pipeline import Precision, StepCache, request_cache
from portbench.tests import standin_family
from portbench.tests.tiny import stdlib_serve, tiny_cell

ROOT = Path(__file__).resolve().parents[2]
WORDS = (ROOT / "portbench" / "traffic" / "prompt-words.txt").read_text().split()


def standin_cell(dtype="float32", limits=None):
    mix = {"loop": "closed", "clients": 1, "body": {}, "shapes": [{"width": 48, "height": 32, "num_steps": 3}],
           "prompt_words": [8, 20], "emphasis_share": 0.0, "words": "prompt-words.txt", "word_list": WORDS,
           "profiled_requests": 1, "checked_requests": 3}
    return {"cell": {"name": "standin", "chips": 1}, "spec": {"name": "toy", "family": "standin", "dtype": dtype},
            "family": standin_family, "mix": mix, "limits": limits or {"pixel_mad": 0.0}, "per_layer": [],
            "end_to_end": [{"name": "first_byte_p95_s", "unit": "s"}, {"name": "setup_s", "unit": "s"}]}


def standin_run(cell):
    return run.run_cell(cell, 2**35 + 3, seconds=0.3, trace=False, device="cpu", serve=stdlib_serve)


def test_a_family_no_harness_file_names_runs_a_cell():
    res = standin_run(standin_cell())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 3, res["check"]
    assert res["check"] == {"pixel_mad": {"value": 0.0, "limit": 0.0}}
    assert list(res["setup_phases"]) == ["import", "toy", "serve", "http_warm"]
    assert set(res["metrics"]) == {"first_byte_p95_s", "setup_s"}


def test_a_stand_in_program_in_a_lower_precision_fails():
    res = standin_run(standin_cell(dtype="bfloat16"))
    assert not res["correct"] and res["check"]["pixel_mad"]["value"] > 0


def test_a_limit_without_a_number_fails_the_run():
    res = standin_run(standin_cell(limits={"pixel_mad": 0.0, "latent_rel": 1.0}))
    assert not res["correct"]
    assert res["check"]["latent_rel"] == {"value": None, "limit": 1.0}


@pytest.mark.parametrize("numbers,limits,ok", [
    ({"a": 1.0, "b": 2.0}, {"a": 1.0, "b": 2.0}, True),
    ({"a": 1.0, "b": 2.0}, {"a": 1.0}, False),  # a number no limit judges
    ({"a": 1.0}, {"a": 1.0, "b": 2.0}, False),  # a stale limit
    ({"a": 1.5}, {"a": 1.0}, False),
    ({"a": float("nan")}, {"a": 1.0}, False),
    ({}, {}, False),
])
def test_verdict_judges_every_number_and_every_limit(numbers, limits, ok):
    assert check.verdict(numbers, limits) is ok


def test_an_unknown_family_fails_at_load():
    with pytest.raises(SystemExit, match="no-such-family"):
        run.load_family("no-such-family")


@pytest.mark.parametrize("cell", ["dev-1024", "schnell-1024", "dev-1024-cache3"])
def test_a_cell_loads_its_configuration_s_family(cell):
    c = run.load_cell(cell)
    assert c["spec"]["family"] == "flux" and c["family"].__file__.endswith("families/flux.py")


# the harness files and the names of the one family they may not know
HARNESS = ["run.py", "check.py", "control.py", "system.py", *sorted(
    str(p.relative_to(ROOT / "portbench")) for p in (ROOT / "portbench" / "metrics").glob("*.py"))]
MODEL_NAMES = re.compile(r"FluxPipeline|schnell|depth_single_blocks|\bt5|\bclip|flux(?!_fp8)", re.IGNORECASE)


@pytest.mark.parametrize("name", HARNESS)
def test_the_harness_names_no_model(name):
    text = (ROOT / "portbench" / name).read_text()
    assert not [m.group(0) for m in MODEL_NAMES.finditer(text)]


# ---------------------------------------------------------------- the reference's refusals


@pytest.mark.parametrize("body,field", [
    ({"cache": {"mode": "dynamic", "threshold": 0.25}}, "dynamic"),
    ({"init_image": "aGVsbG8="}, "init_image"),
    ({"strength": 0.6}, "strength"),
    ({"cache": {"mode": "interval", "interval": 3, "window": 2}}, "window"),
    ({"num_images": 2}, "num_images"),
])
def test_the_reference_refuses_what_it_does_not_model(body, field):
    with pytest.raises(ValueError, match=field):
        request_cache({"prompt": "p", "seed": 1, "width": 64, "height": 64, "num_steps": 4, **body})


def test_the_reference_refuses_a_body_before_it_builds_a_model():
    cell = tiny_cell()
    with pytest.raises(ValueError, match="dynamic"):
        cell["family"].reference(cell["spec"], 1, [{"prompt": "p", "cache": {"mode": "dynamic"}}], "cpu",
                                 Precision.of(cell["spec"]))


@pytest.mark.parametrize("cache,evaluated", [
    (None, None),
    ({}, None),
    ({"mode": "none", "interval": 3}, None),
    ({"mode": "interval", "interval": 3}, [0, 1, 3, 6, 9, 12, 15, 18, 21, 24, 27]),
    ({"mode": "interval", "interval": 3, "warmup": 1, "tail": 0, "order": 1}, [0, 3, 6, 9, 12, 15, 18, 21, 24, 27]),
    ({"mode": "interval", "interval": 5, "warmup": 4, "tail": 3}, [0, 1, 2, 3, 5, 10, 15, 20, 25, 26, 27]),
])
def test_the_step_cache_evaluates_as_served(cache, evaluated):
    c = request_cache({"prompt": "p", "cache": cache})
    if evaluated is None:
        assert c is None
    else:
        assert [i for i in range(28) if c.evaluates(i, 28)] == evaluated
        assert c.order == cache.get("order", 0)


@pytest.mark.parametrize("order", [0, 1])
def test_the_reference_s_cached_loop_reuses_or_extrapolates_the_velocity(order):
    """A flow whose velocity is t itself, at interval 3 over 7 steps: a skipped step
    takes the last evaluated t (order 0) or the t it extrapolates to (order 1, exact
    for a velocity linear in t)."""
    from portbench.reference import pipeline as ref

    seen = []

    def flow(x, ids, txt, txt_ids, t, vec, g):
        seen.append(float(t))
        return torch.full_like(x, float(t))

    spec = {"spec": {"version": "flux-dev", "params": {"in_channels": 64}}}
    x, n = ref.denoise(flow, spec, None, torch.zeros(1, 4, 8), 5, 32, 32, 7, 3.5,
                       StepCache(interval=3, order=order))
    ts = ref.schedule(7, 4, shift=True)
    evaluated = [0, 1, 3, 6]
    velocity = {}
    for i in range(7):
        if i in evaluated:
            velocity[i] = torch.tensor(ts[i]).bfloat16().item()
        elif order == 0:
            velocity[i] = velocity[max(j for j in evaluated if j < i)]
        else:
            a, b = [j for j in evaluated if j < i][-2:]
            velocity[i] = velocity[b] + (ts[i] - ts[b]) * (velocity[b] - velocity[a]) / (ts[b] - ts[a])
    assert n == 4 and len(seen) == 4
    x0 = ref.pack(ref.noise(5, 32, 32, 16, "cpu"))
    want = x0 + sum((ts[i + 1] - ts[i]) * velocity[i] for i in range(7))
    assert torch.allclose(x, want, atol=1e-5)


@pytest.mark.parametrize("key,tier", [("flow_quantization_dtype", "qint8"), ("flow_quantization_dtype", "qint4"),
                                      ("text_enc_quantization_dtype", "qint8")])
def test_precision_refuses_a_tier_it_does_not_model(key, tier):
    spec = tiny_cell()["spec"]
    spec["spec"][key] = tier
    with pytest.raises(ValueError, match=f"{key} '{tier}'"):
        Precision.of(spec)
