"""The compiled serving path through the port's pipeline on the CPU: ``compile()``
compiling its warm-up bucket, a LoRA fused in and out, a mesh staying eager, the
buckets one process compiles (``models/flux.py:MAX_COMPILED_BUCKETS``), and inductor's
caches in ``compilation_cache_dir``. The backend and the fixtures are
test_torch_compile.py's (``aot_eager``, every compiled function dropped around each
test).
"""

import logging

import numpy as np
import torch

from flux_fp8_api_tpu.models import flux as jflux
from flux_fp8_api_tpu_torch import pipeline as tpipeline
from flux_fp8_api_tpu_torch.models import flux as tflux
from flux_fp8_api_tpu_torch.pipeline import FluxPipeline

from .helpers import TINY_AE_PARAMS, TINY_FLUX_PARAMS, tiny_spec
from .test_lora import make_kohya_lora
from .test_torch_compile import ALL, _compile_on_the_cpu, graphs, per_function  # noqa: F401 (a fixture)
from .test_torch_lora import torch_sd
from .torch_parity import numpy_ae_params, numpy_flux_params, to_torch

torch.set_num_threads(1)


def _tiny_pipeline(monkeypatch, quantized=False, **overrides):
    """The tiny flux of tests/helpers.py in a pipeline with the compile flags, fixed
    conditioning in place of the text encoders; compile() (in the constructor) warms
    one 64x64 bucket at 2 steps unless ``overrides`` say otherwise."""
    cfg = tflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32")
    params = numpy_flux_params(jflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32"))
    if quantized:
        params = jflux.quantize_flux_tree(params)
    r = np.random.default_rng(6)
    vec = torch.from_numpy(r.normal(size=(1, TINY_FLUX_PARAMS.vec_in_dim)).astype(np.float32))
    txt = torch.from_numpy(r.normal(size=(1, 6, TINY_FLUX_PARAMS.context_in_dim)).astype(np.float32))
    monkeypatch.setattr(FluxPipeline, "_encode_prompts", lambda self, prompts: {p: (vec, txt) for p in prompts})
    fields = dict(num_scale_trials=0, flow_dtype="float32", ae_dtype="float32", compile_blocks=True,
                  compile_extras=True, warmup_resolutions=[[64, 64]], warmup_steps=2)
    fields.update(overrides)
    return FluxPipeline("flux-dev", model=to_torch(params), model_cfg=cfg,
                        ae=to_torch(numpy_ae_params(TINY_AE_PARAMS)), config=tiny_spec(**fields))


def test_one_graph_per_bucket_across_a_lora_load_and_unload(monkeypatch):
    """A pipeline with the compile flags (the tiny fp8 flux of test_torch_lora.py): a
    LoRA fused in and out replaces Linears by new ones with new buffers, which are new
    inputs to the same graphs. Calibration runs eagerly."""
    pipe = _tiny_pipeline(monkeypatch, quantized=True, num_scale_trials=1, compile_blocks=False,
                          compile_extras=False)
    pipe.generate("a cat", 64, 64, 3, seed=4, silent=True)  # calibration
    assert not pipe._needs_calibration
    pipe.config.compile_blocks = pipe.config.compile_extras = True
    pipe.generate("a cat", 64, 64, 3, seed=4, silent=True)
    unfused = pipe.last_latents.clone()
    assert graphs() == per_function(1)
    pipe.load_lora(torch_sd(make_kohya_lora()), 1.0, name="k")
    pipe.generate("a cat", 64, 64, 3, seed=4, silent=True)
    assert torch.isfinite(pipe.last_latents).all() and not torch.equal(pipe.last_latents, unfused)
    pipe.unload_lora("k")
    pipe.generate("a cat", 64, 64, 3, seed=4, silent=True)
    assert graphs() == per_function(1)
    compiled = pipe.last_latents.clone()
    pipe.config.compile_blocks = pipe.config.compile_extras = False
    pipe.generate("a cat", 64, 64, 3, seed=4, silent=True)
    assert torch.equal(pipe.last_latents, compiled) and graphs() == per_function(1)


def test_a_mesh_pipeline_with_the_flags_logs_and_stays_eager(caplog, monkeypatch):
    with caplog.at_level(logging.INFO, logger=tpipeline.__name__):
        pipe = _tiny_pipeline(monkeypatch, mesh={"dp": 1, "tp": 1})
    assert pipe.compiled == ALL  # what the config asks; the forward decides (_may_compile)
    assert [r for r in caplog.records if "runs eagerly on a mesh" in r.getMessage()]
    assert graphs() == per_function(0)  # compile() warmed its bucket eagerly
    pipe.generate("a cat", 64, 64, 2, seed=1, silent=True)
    assert graphs() == per_function(0)


def test_compile_warms_the_bucket_compiled(monkeypatch):
    """compile() compiles the warm-up bucket ahead: a request at it compiles nothing."""
    pipe = _tiny_pipeline(monkeypatch)
    assert pipe.compiled == ALL and graphs() == per_function(1)
    pipe.generate("a cat", 64, 64, 2, seed=1, silent=True)
    assert graphs() == per_function(1)


def test_requests_of_more_sizes_than_the_admitted_buckets_are_all_served(monkeypatch):
    """A server meets any size. With room for two buckets per function and dynamo's
    limit at two graphs, the warm-up bucket and the first new size compile, and
    64x80 runs 80x64's graph (the same shapes; the ids differ in value only); every
    later size runs eagerly with a warning, gives what the eager pipeline gives, and
    never reaches dynamo's limit, where a compiled call would raise. An admitted
    bucket still runs its graph."""
    import torch._dynamo

    pipe = _tiny_pipeline(monkeypatch)
    monkeypatch.setattr(tflux, "MAX_COMPILED_BUCKETS", 2)
    monkeypatch.setattr(torch._dynamo.config, "recompile_limit", 2)
    sizes = [(80, 64), (64, 80), (96, 64), (80, 80), (96, 96)]
    served = {}
    for width, height in sizes:
        pipe.generate("a cat", width, height, 2, seed=3, silent=True)
        served[(width, height)] = pipe.last_latents.clone()
        assert graphs() == per_function(2)
    eager_calls = {fn: 2 * 3 for fn in graphs()}  # three sizes, two evaluations each
    assert tflux.EAGER_CALLS == eager_calls
    pipe.generate("a cat", 80, 64, 2, seed=3, silent=True)  # admitted: compiled, from the cache
    assert tflux.EAGER_CALLS == eager_calls
    assert torch.equal(pipe.last_latents, served[(80, 64)])
    pipe.config.compile_blocks = pipe.config.compile_extras = False
    for (width, height), latents in served.items():
        pipe.generate("a cat", width, height, 2, seed=3, silent=True)
        assert torch.equal(pipe.last_latents, latents)


def test_the_cache_dir_receives_inductors_caches(tmp_path, monkeypatch):
    """A pipeline with compilation_cache_dir and the flags points the process's inductor
    caches there (FX graphs and AOTAutograd in inductor/, Triton's kernels in triton/),
    and a graph that inductor compiles lands in it; a pipeline without the flags points
    nothing."""
    import os

    import torch._functorch.config
    import torch._inductor.config

    for var in ("TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch._inductor.config, "fx_graph_cache", torch._inductor.config.fx_graph_cache)
    monkeypatch.setattr(torch._functorch.config, "enable_autograd_cache",
                        torch._functorch.config.enable_autograd_cache)
    _tiny_pipeline(monkeypatch, compilation_cache_dir=str(tmp_path))
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == str(tmp_path / "inductor")
    assert os.environ["TRITON_CACHE_DIR"] == str(tmp_path / "triton")
    assert torch._inductor.config.fx_graph_cache and torch._functorch.config.enable_autograd_cache
    # a graph of one view: inductor caches it whole, and no C++ compiler runs
    fn = torch.compile(lambda a: a.t(), backend="inductor", fullgraph=True)
    fn(torch.arange(8, dtype=torch.float32).reshape(2, 4))
    assert any(p.is_file() for p in (tmp_path / "inductor" / "fxgraph").rglob("*"))
    _tiny_pipeline(monkeypatch, compilation_cache_dir=str(tmp_path / "other"), compile_blocks=False,
                   compile_extras=False)
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == str(tmp_path / "inductor")
