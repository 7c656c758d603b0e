"""FLUX.1 Kontext [dev] editing in the port, on the CPU at tiny size, against the plain
reference ``portbench/reference/kontext.py`` (float32 PyTorch, nothing of either
package): the context's ids, its place after the target and the slice back to the
target, the posterior's mean, the preferred-resolution resize, a whole ``generate``;
the refusals, each a 400 naming its field; the ``context`` span and its counter.

Weights are drawn from a seed by checkpoint name (``portbench/weights.py``) and loaded
into the port through its own loaders (``portbench/families/kontext.py:build``), so both
sides hold the same ``configs/config-tiny-cpu.json``-sized flow and VAE, at the float
tier (no quantization), eager. The preferred Kontext resolutions, about a megapixel
each, are shrunk to 64² and two 80 × 48 shapes, in the port and the reference alike.

Tolerances, each with its reason:

- the encoder in float32 (``ae_dtype`` float32): the same convolutions and norms in
  another order, rtol/atol 1e-5;
- a whole request in the served dtypes (bf16 flow, text encoders and VAE, as shipped)
  against float32: every stage rounds to bf16 (2^-8), and three Euler steps carry the
  rounding through 2 + 3 blocks: 0.03 in relative norm, where the same request without
  its context reads about 0.12;
- resize and ids: equal.
"""

import base64
import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

import flux_fp8_api_tpu_torch.pipeline as tpipeline
from flux_fp8_api_tpu_torch import sampling, tracing
from flux_fp8_api_tpu_torch.models.autoencoder import ae_encode
from flux_fp8_api_tpu_torch.ops.packing import make_img_ids, pack_latents
from flux_fp8_api_tpu_torch.server import PipelineServer
from portbench import check, run
from portbench.reference import kontext as rkontext
from portbench.reference.pipeline import Precision
from portbench.tests.tiny import tiny_cell
from portbench.images import input_image

torch.set_num_threads(1)

SEED = 2**33 + 5
SMALL = ((64, 64), (48, 80), (80, 48))
PUBLISHED, PUBLISHED_REF = tpipeline.PREFERRED_KONTEXT_RESOLUTIONS, rkontext.PREFERRED_RESOLUTIONS
FAMILY = run.load_family("kontext")


@pytest.fixture(autouse=True)
def small_resolutions(monkeypatch):
    monkeypatch.setattr(tpipeline, "PREFERRED_KONTEXT_RESOLUTIONS", SMALL)
    monkeypatch.setattr(rkontext, "PREFERRED_RESOLUTIONS", SMALL)


def kontext_spec(dtype="bfloat16"):
    spec = tiny_cell("flux-dev")["spec"]
    spec["family"] = "kontext"
    spec["spec"].update(version="flux-dev-kontext", flow_quantization_dtype=None, text_enc_quantization_dtype=None,
                        compile_blocks=False, compile_extras=False, flow_dtype=dtype, ae_dtype=dtype,
                        text_enc_dtype=dtype)
    return spec


def build(spec):
    return FAMILY.build(spec, FAMILY.weights(spec, SEED, "cpu"), {})


@pytest.fixture(scope="module")
def served():
    spec = kontext_spec()
    return spec, build(spec)


@pytest.fixture(scope="module")
def encoder32():
    spec = kontext_spec("float32")
    return spec, build(spec)


def body(i=0, width=80, height=48, **kw):
    return {"prompt": "a red house by the (lake:1.2) at dawn", "width": 64, "height": 64, "num_steps": 3,
            "guidance": 2.5, "seed": 11 + i, "input_image": input_image(SEED, i, width, height), **kw}


def pixels(b):
    return np.array(Image.open(io.BytesIO(base64.b64decode(b["input_image"]))).convert("RGB"))


# ------------------------------------------------------------------- the context path


@pytest.mark.parametrize("size,want", [((64, 64), (64, 64)), ((80, 48), (80, 48)), ((100, 50), (80, 48)),
                                       ((40, 72), (48, 80)), ((70, 60), (64, 64))])
def test_the_resize_takes_the_preferred_resolution_nearest_the_aspect_ratio(size, want):
    img = pixels(body(width=size[0], height=size[1]))
    got = tpipeline.kontext_resize(img)
    assert tpipeline.kontext_size(*size) == rkontext.preferred_size(*size) == want
    assert got.shape == (want[1], want[0], 3)
    np.testing.assert_array_equal(got, rkontext.resize(img))


def test_the_published_preferred_resolutions(monkeypatch):
    monkeypatch.setattr(tpipeline, "PREFERRED_KONTEXT_RESOLUTIONS", PUBLISHED)
    monkeypatch.setattr(rkontext, "PREFERRED_RESOLUTIONS", PUBLISHED_REF)
    assert PUBLISHED == PUBLISHED_REF and len(PUBLISHED) == 17 and PUBLISHED[8] == (1024, 1024)
    for size, want in (((1024, 1024), (1024, 1024)), ((800, 600), (1184, 880)), ((600, 800), (880, 1184)),
                       ((4000, 1000), (1568, 672))):
        assert tpipeline.kontext_size(*size) == rkontext.preferred_size(*size) == want
    img = np.random.default_rng(0).integers(0, 256, size=(1024, 1024, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tpipeline.kontext_resize(img), img)  # the identity at 1024²


def test_the_context_ids_take_first_axis_one():
    ids = make_img_ids(6, 10, 2, first=1)
    assert ids.shape == (2, 15, 3) and (ids[..., 0] == 1).all()
    assert torch.equal(ids[:1], rkontext.context_ids(6, 10, "cpu"))
    assert torch.equal(ids[..., 1:], make_img_ids(6, 10, 2)[..., 1:]) and (make_img_ids(6, 10, 2)[..., 0] == 0).all()


def test_the_context_is_the_posterior_mean(encoder32):
    spec, pipe = encoder32
    b = body()
    packed, ids = pipe.prepare_context(b["input_image"])
    enc = rkontext.Encoder(spec["spec"]["ae_params"], FAMILY.weights(spec, SEED, "cpu")["ae"])
    ref, ref_ids = rkontext.context(enc, pixels(b), "cpu")
    assert packed.shape == ref.shape == (1, 15, 16) and torch.equal(ids, ref_ids)
    torch.testing.assert_close(packed, ref, rtol=1e-5, atol=1e-5)
    x = torch.from_numpy(tpipeline.kontext_resize(pixels(b)).astype(np.float32) / 127.5 - 1.0)[None]
    sampled = ae_encode(pipe.ae_params, pipe.config.ae_params, x, torch.Generator().manual_seed(0))
    assert check.rel(pack_latents(sampled.permute(0, 3, 1, 2)), ref) > 0.1  # a sample is far from the mean


def test_the_context_follows_the_target_and_the_slice_keeps_the_target(monkeypatch):
    """Each evaluation takes [target; context] with [target ids; context ids]; the
    update reads the first L_img rows of the prediction alone."""
    img, ids = torch.randn(1, 4, 16), make_img_ids(4, 4, 1)
    ctx, ctx_ids = torch.randn(1, 6, 16), make_img_ids(4, 6, 1, first=1)
    seen = []

    def flow(model, cfg, x, x_ids, *args, **kwargs):
        seen.append((x.clone(), x_ids.clone()))
        return torch.cat([torch.ones_like(x[:, :4]), torch.full_like(x[:, 4:], 1e3)], dim=1)

    monkeypatch.setattr(sampling, "flux_apply", flow)
    cfg = SimpleNamespace(dtype=torch.float32, guidance_embed=False)
    out = sampling.denoise(None, cfg, img, ids, None, None, None, [1.0, 0.5, 0.0], 2.5,
                           context=ctx, context_ids=ctx_ids)
    assert len(seen) == 2
    for x, x_ids in seen:
        assert torch.equal(x[:, 4:], ctx) and torch.equal(x_ids, torch.cat([ids, ctx_ids], dim=1))
    assert torch.equal(seen[0][0][:, :4], img)
    torch.testing.assert_close(out, img - 1.0)  # two steps of dt −0.5 at velocity 1


def test_a_kontext_generate_matches_the_reference(served):
    spec, pipe = served
    b = body()
    pipe.generate(silent=True, **b)
    kept = FAMILY.keep(pipe, b)
    (ref,) = FAMILY.reference(spec, SEED, [b], "cpu", Precision.of(spec))
    (no_ctx,) = FAMILY.reference(spec, SEED, [b], "cpu", Precision.of(spec), loops=(False,))
    assert pipe.timings["context_tokens"] == 15 and kept["latents"].shape == (1, 16, 16)
    assert check.rel(kept["latents"], ref[0].latents) < 0.03
    assert check.rel(no_ctx[0].latents, ref[0].latents) > 0.08
    assert check.rel(kept["context"], ref[0].context) < 0.03


def test_a_kontext_request_differs_from_the_same_request_without_its_image(served):
    _, pipe = served
    b = body(1)
    pipe.generate(silent=True, **b)
    edited = pipe.last_latents.clone()
    pipe.generate(silent=True, **{k: v for k, v in b.items() if k != "input_image"})
    assert pipe.last_context is None and "context_tokens" not in pipe.timings
    assert check.rel(pipe.last_latents, edited) > 0.05


def test_warmup_warms_the_text_and_the_context_buckets(served, monkeypatch):
    _, pipe = served
    calls = []
    monkeypatch.setattr(pipe, "generate", lambda **kw: calls.append(kw))
    pipe.warmup([(64, 64)], num_steps=2, autotune=False, precompile_interactive=False)
    assert [c["input_image"] is None for c in calls] == [True, False]
    assert calls[1]["input_image"].shape == (64, 64, 3)


# ------------------------------------------------------------------------ the refusals


def refused(pipe, **kw):
    status, _, payload, _ = PipelineServer(pipe).handle_generate({**body(), **kw})
    return status, payload.decode()


@pytest.mark.parametrize("kw,field", [
    ({"init_image": "aGVsbG8="}, "init_image"),
    ({"cache": {"mode": "interval", "interval": 2}}, "cache"),
])
def test_a_kontext_server_refuses_by_name(served, kw, field):
    status, message = refused(served[1], **kw)
    assert status == 400 and field in message


@pytest.mark.parametrize("shape", [{"tp": 2}, {"pp": 2}])
def test_a_kontext_request_on_a_mesh_is_refused(served, monkeypatch, shape):
    monkeypatch.setattr(served[1], "mesh", SimpleNamespace(shape=shape, size=lambda axis: shape.get(axis, 1)))
    status, message = refused(served[1])
    assert status == 400 and "input_image" in message and "mesh" in message


def test_a_kontext_request_under_streamed_offload_is_refused(served, monkeypatch):
    monkeypatch.setattr(served[1], "offload_flow", True)
    status, message = refused(served[1])
    assert status == 400 and "input_image" in message and "offload" in message


@pytest.mark.parametrize("version", ["flux-dev", "flux-schnell"])
def test_a_flux_dev_server_refuses_input_image(version):
    spec = kontext_spec()
    spec["spec"]["version"] = version
    status, message = refused(build(spec))
    assert status == 400 and "input_image" in message and f"serves {version}," in message and "flux-dev-kontext" in message


# --------------------------------------------------------------------- span and counter


def test_the_context_span_and_its_token_counter(served):
    _, pipe = served
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("generate"):
            pipe.generate(silent=True, **body(2))
    spans = [(e.name[len(tracing.PREFIX):], e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith(tracing.PREFIX)]
    (ctx,) = [sp for sp in spans if sp[0] == "context"]
    (gen,) = [sp for sp in spans if sp[0] == "generate"]
    (pre,) = [sp for sp in spans if sp[0] == "preprocess"]
    assert gen[1] <= ctx[1] and ctx[2] <= gen[2] and pre[2] <= ctx[1]
    assert 0 < pipe.timings["context_seconds"] <= (ctx[2] - ctx[1]) / 1e6 + 1e-3
    assert pipe.timings["context_tokens"] == 15
