"""Pipeline parallelism (parallel/pp.py) against the JAX package's, on the CPU: every
case of tests/test_pp.py.

JAX runs here on its 8-device virtual CPU mesh and computes the references: its
``make_pp_runner`` inside ``flux_apply``, ``jax.grad`` through it, its
``make_pp_train_step`` and its pipeline on a pp mesh. The port's stages run in worlds
of processes over gloo (tests/torch_mesh_worker.py), all started at once while JAX
computes.

Tolerances: fp32 compute on both sides. The runner's forward holds JAX's own bound
for a runner against the plain scan (atol 1e-5) against the port's world of one; against
JAX's runner it holds the relative norm of 2e-5 of the other cross-package mesh tests
(tests/test_torch_mesh.py), because the two packages' fp32 forwards of this model differ
by up to 4.3e-5 in absolute value with no pp at all (relative norm 8.9e-6). Gradients
and updated tensors: atol 1e-5, rtol 1e-4 (JAX's bound). An int8 tree and M = 1 are one
rank's bit for bit (a stage runs one rank's ops on one rank's shapes); images within a
mean of one uint8 step (JAX's bound).
"""

import io
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_fp8_api_tpu import pipeline as jpipeline
from flux_fp8_api_tpu.models import flux as jflux
from flux_fp8_api_tpu.ops.schedule import get_schedule
from flux_fp8_api_tpu.parallel import mesh as jmesh
from flux_fp8_api_tpu.parallel import pp as jpp
from flux_fp8_api_tpu.parallel import train as jtrain
from flux_fp8_api_tpu.utils.config import FluxParams
from flux_fp8_api_tpu_torch.models import flux as tflux
from flux_fp8_api_tpu_torch.parallel.mesh import Mesh, stage_blocks
from flux_fp8_api_tpu_torch.parallel.pp import make_pp_runner
from flux_fp8_api_tpu_torch.pipeline import FluxPipeline
from flux_fp8_api_tpu_torch.server import PipelineServer
from flux_fp8_api_tpu_torch.utils.config import FluxParams as TFluxParams

from .helpers import TINY_AE_PARAMS, TINY_FLUX_PARAMS, tiny_spec
from .test_pipeline import decode_jpeg
from .torch_mesh_worker import start_worlds
from .torch_parity import flatten, numpy_ae_params, numpy_flux_params, t, to_torch

torch.set_num_threads(1)

# tests/test_pp.py's tiny flux: 2 doubles and 4 singles, hidden 128, 4 heads
PARAMS = FluxParams(
    in_channels=16, vec_in_dim=64, context_in_dim=96, hidden_size=128,
    mlp_ratio=4.0, num_heads=4, depth=2, depth_single_blocks=4,
    axes_dim=[8, 12, 12], theta=10_000, qkv_bias=True, guidance_embed=True,
)
TIMESTEPS = [float(x) for x in get_schedule(2, 16, shift=True)]
GEN = dict(width=64, height=64, num_steps=2, seed=11)


def jcfg():
    return jflux.FluxStatic.from_params(PARAMS, compute_dtype="float32", use_pallas=False)


def pcfg(use_pallas=False):
    return tflux.FluxStatic.from_params(TFluxParams(**PARAMS.model_dump()), compute_dtype="float32",
                                        use_pallas=use_pallas)


def batch(b, seed=1):
    """JAX's make_dummy_batch, as numpy."""
    return {k: np.asarray(v) for k, v in jtrain.make_dummy_batch(jcfg(), b, 8, 8, 16, jax.random.PRNGKey(seed)).items()}


def inputs(b):
    x = batch(b)
    return dict(img=x["latents"], img_ids=x["img_ids"], txt=x["txt"], txt_ids=x["txt_ids"],
                t=np.full((b,), 0.5, np.float32), y=x["y"], g=np.full((b,), 3.5, np.float32))


def jargs(x):
    return tuple(jnp.asarray(x[k]) for k in ("img", "img_ids", "txt", "txt_ids", "t", "y", "g"))


def draws(key, shape):
    """The t and ε that JAX's flow_matching_loss draws from ``key``."""
    k_t, k_eps = jax.random.split(key)
    tt = jtrain.sample_timesteps(k_t, shape[0], shape[1], "uniform")
    return np.asarray(tt), np.asarray(jax.random.normal(k_eps, shape, jnp.float32))


@pytest.fixture(scope="module")
def trees():
    base = numpy_flux_params(jcfg())
    return {"float": base, "int8": jflux.quantize_flux_tree(base, kind="int8")}


def pp_task(tree, **kw):
    return ("pp", {"tree": flatten(tree), "flux_params": PARAMS.model_dump(), "dtype": "float32",
                   "use_pallas": False, **kw})


# the serving side: the tiny pipeline of tests/helpers.py with fixed noise and text
@pytest.fixture(scope="module")
def serving():
    cfg = jflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32", use_pallas=False)
    params = numpy_flux_params(cfg)
    r = np.random.default_rng(21)
    fixed = dict(noise=r.normal(size=(1, TINY_FLUX_PARAMS.in_channels // 4, 8, 8)).astype(np.float32),
                 vec=r.normal(size=(1, TINY_FLUX_PARAMS.vec_in_dim)).astype(np.float32),
                 txt=r.normal(size=(1, 6, TINY_FLUX_PARAMS.context_in_dim)).astype(np.float32),
                 timesteps=TIMESTEPS)
    fixed2 = dict(fixed, noise=r.normal(size=(2, TINY_FLUX_PARAMS.in_channels // 4, 8, 8)).astype(np.float32),
                  vec=np.repeat(fixed["vec"], 2, 0), txt=np.repeat(fixed["txt"], 2, 0))
    return cfg, params, numpy_ae_params(TINY_AE_PARAMS), fixed, fixed2


def spec(**kw):
    return tiny_spec(flow_dtype="float32", ae_dtype="float32", **kw)


def pipeline_task(tree, ae, fixed, spec_, use_pallas=False, generates=(GEN,), **kw):
    return ("pipeline", {"tree": flatten(tree), "flux_params": TINY_FLUX_PARAMS.model_dump(), "dtype": "float32",
                         "use_pallas": use_pallas, "ae": flatten(ae), "spec": spec_.model_dump(),
                         "generates": list(generates), **fixed, **kw})


@pytest.fixture(scope="module")
def worlds(trees, serving, tmp_path_factory):
    """Every world, started at once; → (a function that waits for their results, the
    directory of the files they write)."""
    _, sparams, ae, fixed, fixed2 = serving
    b4, b2 = batch(4), batch(2)
    t4, n4 = draws(jax.random.PRNGKey(3), b4["latents"].shape)
    ts, ns = draws(jax.random.PRNGKey(4), b4["latents"].shape)
    sint8 = jflux.quantize_flux_tree(sparams, kind="int8")
    root = tmp_path_factory.mktemp("pp")
    jobs = {
        "dp2pp2": {"mesh": {"dp": 2, "pp": 2}, "tasks": [
            pp_task(trees["float"], inputs=inputs(4), M=2),
            pp_task(trees["float"], grads=True, batch=b4, t=t4, noise=n4, M=2),
            pp_task(trees["float"], step="sgd", batch=b4, t=ts, noise=ns, M=2),
            pipeline_task(sparams, ae, fixed2, spec(mesh={"dp": 2, "pp": 2}), generates=[dict(GEN, num_images=2)]),
        ]},
        "pp4": {"mesh": {"pp": 4}, "tasks": [
            pp_task(trees["float"], inputs=inputs(2), M=1),
            pp_task(trees["float"], inputs=inputs(2), M=2),
        ]},
        "pp2": {"mesh": {"pp": 2}, "tasks": [
            pp_task(trees["int8"], inputs=inputs(2), M=2),
            pipeline_task(sparams, ae, fixed, spec(mesh={"pp": 2}, use_pallas=True), use_pallas=True,
                          generates=[GEN, dict(GEN, num_steps=1, seed=0, silent=False)]),
            pipeline_task(sint8, ae, fixed, spec(mesh={"pp": 2}), expect_error=True),
            pipeline_task(sint8, ae, fixed, spec(mesh={"pp": 2}, num_scale_trials=0), save=str(root / "pp2.sft")),
        ]},
    }
    return start_worlds(root, jobs, timeout=170), root


@pytest.fixture(scope="module")
def results(worlds):
    return worlds[0]()


def jax_pp_forward(tree, shape, m, x):
    """JAX flux_apply through make_pp_runner on its mesh (tests/test_pp.py)."""
    mesh = jmesh.make_mesh(shape, jax.devices()[: int(np.prod(list(shape.values())))])
    sharded = jmesh.shard_flux_params(tree, mesh, tp_axis=None, pp_axis="pp")
    args = jargs(x)
    if "dp" in shape:
        args = tuple(jax.device_put(a, jmesh.batch_sharding(mesh)) for a in args)
    runner = jpp.make_pp_runner(mesh, num_microbatches=m, dp_axis="dp" if "dp" in shape else None)
    return np.asarray(jax.jit(jflux.flux_apply, static_argnames=("cfg", "stack_runner"))(
        sharded, jcfg(), *args, stack_runner=runner))


def assert_runner(got, one, ref, msg=""):
    """The runner's output: the port's world of one within 1e-5, JAX's runner within a
    relative norm of 2e-5 (the module docstring)."""
    np.testing.assert_allclose(got, one, atol=1e-5, err_msg=msg)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 2e-5, msg


def port_one(tree, x):
    with torch.inference_mode():
        return tflux.flux_apply(to_torch(tree), pcfg(), *(torch.from_numpy(np.array(x[k])) for k in
                                                          ("img", "img_ids", "txt", "txt_ids", "t", "y", "g")))


# ------------------------------------------------------------------------- forward


def test_forward_matches_scan_runner(trees, results):
    """dp 2 × pp 2, M = 2: every rank's output is JAX's runner's (atol 1e-5) and the
    port's world of one's."""
    x = inputs(4)
    ref = jax_pp_forward(trees["float"], {"dp": 2, "pp": 2}, 2, x)
    one = port_one(trees["float"], x).numpy()
    for r, rank in enumerate(results["dp2pp2"]):
        assert_runner(rank[0]["pred"], one, ref, f"rank {r}")
        assert rank[0]["blocks"] == {"double_blocks": 1, "single_blocks": 2}


def test_pp4_single_microbatch(trees, results):
    """M = 1 degenerates to sequential stages: one rank's output bit for bit. The
    singles pipeline (the doubles' depth 2 stays whole on four stages); per evaluation
    each stage hands the (B, L, hidden) activations on once and every rank takes the
    last stage's result by one broadcast (the pinned budget)."""
    x = inputs(2)
    ref = jax_pp_forward(trees["float"], {"pp": 4}, 1, x)
    one = port_one(trees["float"], x).numpy()
    shape = ("float32", (2, 16 + 16, PARAMS.hidden_size))
    for s, rank in enumerate(results["pp4"]):
        assert_runner(rank[0]["pred"], one, ref)
        np.testing.assert_array_equal(rank[0]["pred"], one)
        want = {("broadcast", *shape): 1}
        if s > 0:
            want[("recv", *shape)] = 1
        if s < 3:
            want[("send", *shape)] = 1
        assert rank[0]["collectives"] == want, s


def test_prime_depth_falls_back_to_replicated_scan(trees, results):
    """On pp 4 the singles (depth 4) get one block per stage and the doubles (depth 2)
    stay whole, as JAX's shard rule puts them; the output is JAX's runner's."""
    mesh = jmesh.make_mesh({"pp": 4}, jax.devices()[:4])
    sh = jmesh.flux_param_shardings(trees["float"], mesh, tp_axis=None, pp_axis="pp")
    assert sh["single_blocks"]["linear1"].kernel.spec[0] == "pp"
    assert sh["double_blocks"]["img_attn_qkv"].kernel.spec[0] is None
    x = inputs(2)
    ref = jax_pp_forward(trees["float"], {"pp": 4}, 2, x)
    one = port_one(trees["float"], x).numpy()
    for s, rank in enumerate(results["pp4"]):
        assert rank[1]["blocks"] == {"double_blocks": 2, "single_blocks": 1}
        assert list(stage_blocks(4, Mesh({"pp": 4}, rank=s))) == [s]
        assert_runner(rank[1]["pred"], one, ref)


def test_quantized_params_pipeline(trees, results):
    """int8 per-block scales ride the depth split: JAX's runner's output, and one
    rank's bit for bit."""
    x = inputs(2)
    ref = jax_pp_forward(trees["int8"], {"pp": 2}, 2, x)
    one = port_one(trees["int8"], x).numpy()
    for rank in results["pp2"]:
        assert_runner(rank[0]["pred"], one, ref)
        np.testing.assert_array_equal(rank[0]["pred"], one)


# ------------------------------------------------------------------------ backward


def _port_names(jax_tree):
    """{port name: numpy} of a JAX tree (gradients or params) in the port's layout."""
    return {k: v.numpy() for k, v in to_torch(jax_tree).named_buffers()}


def _merged(ranks, key):
    """{global name: numpy} from every rank's part."""
    out = {}
    for rank in ranks:
        out.update(rank[key])
    return out


def _trainable_names(tree):
    from flux_fp8_api_tpu_torch.parallel.train import trainable_tensors

    model = to_torch(tree)
    ids = {id(x) for x in trainable_tensors(model)}
    return [k for k, v in model.named_buffers() if id(v) in ids]


def test_grads_match_scan_runner(trees, results):
    """The hand-written GPipe backward against jax.grad through JAX's runner on its
    dp 2 × pp 2 mesh and through the plain scan: the loss and every trainable
    tensor's gradient (the stages' blocks from their ranks), atol 1e-5, rtol 1e-4."""
    b = batch(4)
    key = jax.random.PRNGKey(3)
    params = trees["float"]
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jtrain.flow_matching_loss), static_argnames=("cfg",))(
        params, jcfg(), {k: jnp.asarray(v) for k, v in b.items()}, key)
    mesh = jmesh.make_mesh({"dp": 2, "pp": 2}, jax.devices()[:4])
    sharded = jmesh.shard_flux_params(params, mesh, pp_axis="pp")
    bs = {k: jax.device_put(jnp.asarray(v), jmesh.batch_sharding(mesh)) for k, v in b.items()}
    runner = jpp.make_pp_runner(mesh, num_microbatches=2, dp_axis="dp")
    pp_loss, pp_grads = jax.jit(jax.value_and_grad(
        lambda p: jtrain.flow_matching_loss(p, jcfg(), bs, key, stack_runner=runner)))(sharded)
    want, want_pp = _port_names(ref_grads), _port_names(pp_grads)
    ranks = [rank[1] for rank in results["dp2pp2"]]
    got = _merged(ranks, "grads")
    assert sorted(got) == sorted(_trainable_names(trees["float"]))  # every trainable tensor
    for rank in ranks:
        np.testing.assert_allclose(rank["loss"], float(ref_loss), rtol=1e-5)
        np.testing.assert_allclose(rank["loss"], float(pp_loss), rtol=1e-5)
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], atol=1e-5, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(g, want_pp[name], atol=1e-5, rtol=1e-4, err_msg=name)


def test_pp_train_step_runs_and_updates(trees, results):
    """One SGD step of the port's make_pp_train_step against JAX make_pp_train_step
    on the same dp 2 × pp 2 mesh and draws: the loss and every updated tensor."""
    b = batch(4)
    mesh = jmesh.make_mesh({"dp": 2, "pp": 2}, jax.devices()[:4])
    sharded = jmesh.shard_flux_params(trees["float"], mesh, pp_axis="pp")
    bs = {k: jax.device_put(jnp.asarray(v), jmesh.batch_sharding(mesh)) for k, v in b.items()}
    step = jpp.make_pp_train_step(jcfg(), mesh, num_microbatches=2)
    new, loss = step(sharded, bs, jax.random.PRNGKey(4))
    want = _port_names(new)
    before = _port_names(trees["float"])
    ranks = [rank[2] for rank in results["dp2pp2"]]
    for rank in ranks:
        np.testing.assert_allclose(rank["step_loss"], float(loss), rtol=1e-5)
    got = _merged(ranks, "params_after")
    moved = 0.0
    for name, p in got.items():
        np.testing.assert_allclose(p, want[name], atol=1e-5, rtol=1e-4, err_msg=name)
        assert np.isfinite(p).all()
        moved = max(moved, float(np.abs(p - before[name]).max()))
    assert moved > 0  # params moved (the SGD rate is small)


def test_collect_amax_rejected_under_pp(trees):
    runner = make_pp_runner(Mesh({"pp": 2}), num_microbatches=1)
    x = inputs(2)
    with pytest.raises(ValueError, match="collect_amax"):
        tflux.flux_apply(to_torch(trees["float"]), pcfg(), *(torch.from_numpy(np.array(x[k])) for k in
                                                             ("img", "img_ids", "txt", "txt_ids", "t", "y", "g")),
                         collect_amax=True, stack_runner=runner)


def test_bad_microbatch_count_raises(trees):
    """batch 4 over dp 2 leaves 2 rows a rank, which M = 3 does not split."""
    runner = make_pp_runner(Mesh({"dp": 2, "pp": 2}), num_microbatches=3, dp_axis="dp")
    x = inputs(2)  # this dp rank's rows
    with pytest.raises(ValueError, match="microbatches"):
        tflux.flux_apply(to_torch(trees["float"]), pcfg(), *(torch.from_numpy(np.array(x[k])) for k in
                                                             ("img", "img_ids", "txt", "txt_ids", "t", "y", "g")),
                         stack_runner=runner)


def test_tp_axis_rejected():
    with pytest.raises(ValueError, match="pp composes only with dp"):
        make_pp_runner(Mesh({"tp": 2, "pp": 2}), num_microbatches=2)
    make_pp_runner(Mesh({"tp": 1, "pp": 2}), num_microbatches=2)  # an inert tp axis is fine
    with pytest.raises(ValueError, match="num_microbatches"):
        make_pp_runner(Mesh({"pp": 2}), num_microbatches=0)


# ------------------------------------------------------------------------- serving


def jax_generate(serving, mesh, fixed):
    cfg, params, ae, _, _ = serving
    jpipe = jpipeline.FluxPipeline("flux-dev", model=params, model_cfg=cfg, ae=ae, config=spec(mesh=mesh))
    jpipe.preprocess_latent = lambda *a, **kw: (jnp.asarray(fixed["noise"]), TIMESTEPS)
    jpipe._encode_prompts = lambda prompts: {p: (jnp.asarray(fixed["vec"][:1]), jnp.asarray(fixed["txt"][:1]))
                                             for p in prompts}
    return decode_jpeg(jpipe.generate("a cat", silent=True, **dict(GEN, num_images=len(fixed["noise"]))))


def port_generate(serving, fixed, use_pallas=False):
    _, params, ae, _, _ = serving
    cfg = tflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32", use_pallas=use_pallas)
    pipe = FluxPipeline("flux-dev", model=to_torch(params), model_cfg=cfg, ae=to_torch(ae), config=spec())
    pipe.preprocess_latent = lambda *a, **kw: (t(fixed["noise"]), list(TIMESTEPS))
    pipe._encode_prompts = lambda prompts: {p: (t(fixed["vec"][:1]), t(fixed["txt"][:1])) for p in prompts}
    jpeg = pipe.generate("a cat", silent=True, **dict(GEN, num_images=len(fixed["noise"])))
    return pipe.last_latents.numpy(), decode_jpeg(jpeg)


def _mean_step(a, b):
    return float(np.mean(np.abs(a.astype(np.int16) - b.astype(np.int16))))


def test_pp_serving_matches_single_chip(serving, results):
    """pp 2 with the max-free kernel on (its plain version here): within a mean uint8
    step of one rank and of the JAX pipeline on its pp 2 mesh, which serves pp with XLA
    attention (a deliberate deviation: a port rank holds whole heads, so K1 stays on)."""
    fixed = serving[3]
    lat, one = port_generate(serving, fixed, use_pallas=True)
    ref = jax_generate(serving, {"pp": 2}, fixed)
    for r, rank in enumerate(results["pp2"]):
        out = rank[1]
        assert out["cfg"]["use_pallas"] is True
        np.testing.assert_allclose(out["latents0"], lat, atol=1e-5)
        assert (out["jpeg0"] is not None) == (r == 0)
    img = decode_jpeg(io.BytesIO(results["pp2"][0][1]["jpeg0"]))
    assert img.shape == ref.shape == one.shape
    assert _mean_step(img, one) < 1.0 and _mean_step(img, ref) < 1.0


def test_dp_pp_serving_matches_single_chip(serving, results):
    """dp 2 × pp 2, two images (one microbatch per dp rank): within a mean uint8 step
    of one rank and of the JAX pipeline."""
    fixed2 = serving[4]
    lat, one = port_generate(serving, fixed2)
    ref = jax_generate(serving, {"dp": 2, "pp": 2}, fixed2)
    out = results["dp2pp2"][0][3]
    np.testing.assert_allclose(out["latents0"], lat, atol=1e-5)
    img = decode_jpeg(io.BytesIO(out["jpeg0"]))
    assert img.shape == ref.shape == one.shape == (128, 64, 3)  # the two images, one above the other
    assert _mean_step(img, one) < 1.0 and _mean_step(img, ref) < 1.0


def test_pp_serving_params_sharded(results):
    """Tiny flux on pp 2: each stage holds one of the 2 doubles; the 3 singles stay
    whole on both (the per-stack fallback); the runner is set and K1 stays on."""
    for rank in results["pp2"]:
        out = rank[1]
        assert out["blocks"] == {"double_blocks": 1, "single_blocks": 3}
        assert out["pp_runner"] and out["cfg"]["use_pallas"]


def test_pp_interactive_path(results):
    """The per-step (tqdm) loop runs the pp runner too."""
    jpeg = results["pp2"][0][1]["jpeg1"]
    img = decode_jpeg(io.BytesIO(jpeg))
    assert img.shape == (64, 64, 3) and np.isfinite(img.astype(np.float32)).all()


def test_pp_with_tp_rejected():
    with pytest.raises(ValueError, match="pp does not compose"):
        FluxPipeline("flux-dev", config=spec(mesh={"tp": 2, "pp": 2}))


def test_unknown_mesh_axis_rejected():
    with pytest.raises(ValueError, match="not serving axes"):
        FluxPipeline("flux-dev", config=spec(mesh={"ep": 2}))


def test_pp_divides_nothing_rejected():
    """Tiny depths (2 doubles, 3 singles): pp 4 divides neither stack."""
    with pytest.raises(ValueError, match="divides neither"):
        FluxPipeline("flux-dev", config=spec(mesh={"pp": 4}))


def test_pp_requires_calibrated_scales(results):
    for rank in results["pp2"]:
        assert "prequantized" in rank[2]["error"]


def test_pp_quantized_prequant_generate(serving, results):
    """int8 with num_scale_trials 0 on pp 2: a finite 64² image, whose latents are
    one rank's bit for bit."""
    _, params, ae, fixed, _ = serving
    cfg = tflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32", use_pallas=False)
    pipe = FluxPipeline("flux-dev", model=to_torch(jflux.quantize_flux_tree(params, kind="int8")), model_cfg=cfg,
                        ae=to_torch(ae), config=spec(num_scale_trials=0))
    pipe.preprocess_latent = lambda *a, **kw: (t(fixed["noise"]), list(TIMESTEPS))
    pipe._encode_prompts = lambda prompts: {p: (t(fixed["vec"]), t(fixed["txt"])) for p in prompts}
    pipe.generate("a cat", silent=True, **GEN)
    out = results["pp2"][0][3]
    np.testing.assert_array_equal(out["latents0"], pipe.last_latents.numpy())
    img = decode_jpeg(io.BytesIO(out["jpeg0"]))
    assert img.shape == (64, 64, 3) and np.isfinite(img.astype(np.float32)).all()


def test_save_prequantized_from_pp_writes_one_ranks_file(serving, results, worlds, tmp_path):
    """Every stage's blocks gathered: the file a pp 2 pipeline's first rank writes holds
    the tensors and metadata one rank writes."""
    from flux_fp8_api_tpu_torch.utils.safetensors_io import SafetensorsFile

    from .torch_mesh_worker import np_

    _, params, ae, _, _ = serving
    cfg = tflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32", use_pallas=False)
    one = FluxPipeline("flux-dev", model=to_torch(jflux.quantize_flux_tree(params, kind="int8")), model_cfg=cfg,
                       ae=to_torch(ae), config=spec(num_scale_trials=0))
    one.save_prequantized(str(tmp_path / "one.sft"))
    a, b = SafetensorsFile(tmp_path / "one.sft"), SafetensorsFile(worlds[1] / "pp2.sft")
    assert a.metadata == b.metadata and sorted(a.keys()) == sorted(b.keys())
    for k in a.keys():
        np.testing.assert_array_equal(np_(b.get(k)), np_(a.get(k)), err_msg=k)


def test_cached_request_under_pp_answers_400_not_500():
    """The JAX package raises inside the request (a 500, ROADMAP §3); the port's
    handler, which the FastAPI app shares, refuses it first, naming pp, and never
    calls generate."""
    pipe = types.SimpleNamespace(mesh=Mesh({"pp": 2}), generate=lambda **kw: pytest.fail("generate ran"))
    server = PipelineServer(pipe)
    status, _, payload, _ = server.handle_generate({"prompt": "a cat", "cache": {"mode": "interval"}})
    assert status == 400 and b"pipeline parallelism (pp)" in payload
    with pytest.raises(ValueError, match="pp"):
        from flux_fp8_api_tpu_torch.sampling import CacheConfig, denoise

        denoise(None, pcfg(), None, None, None, None, None, [1.0, 0.0], 3.5,
                cache=CacheConfig(mode="interval"), stack_runner=make_pp_runner(Mesh({"pp": 2}), 1))
