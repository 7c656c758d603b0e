"""The compiled serving path on the CPU: the kernels' ``torch.library`` ops under
``torch.library.opcheck``, and the blocks and extras through ``torch.compile``
(``models/flux.py:Compiled``, the pipeline's ``compile_blocks`` / ``compile_extras``;
through the pipeline itself in test_torch_compile_pipeline.py).

The backend is ``aot_eager`` (``models/flux.py:COMPILE_BACKEND``): dynamo traces each
function whole (``fullgraph=True``), AOTAutograd traces the graph through the ops' fake
implementations, and the graph then runs op by op as eager runs it, so the compiled
forward is held to eager's bit for bit. Inductor on the CPU fuses and keeps fp32
between ops where eager rounds, and takes tens of seconds for this model; its
rounding is measured on the card (chip_smoke phase 20). The compiled forward against
JAX's is test_torch_compile_parity.py.

On the CPU an op runs its plain version and launches nothing, so where a test needs
to see what the kernels would be given (their tile, their launch counts), it swaps the
launches for stand-ins that count as the wrappers count and compute the plain version.
"""

import numpy as np
import pytest
import torch

from flux_fp8_api_tpu.models import flux as jflux
from flux_fp8_api_tpu.ops import attention as jattn
from flux_fp8_api_tpu_torch import calibration as tcal
from flux_fp8_api_tpu_torch import offload as toffload
from flux_fp8_api_tpu_torch import sampling as tsampling
from flux_fp8_api_tpu_torch.models import flux as tflux
from flux_fp8_api_tpu_torch.ops import attention as tattn
from flux_fp8_api_tpu_torch.ops import attention_kernel as tak
from flux_fp8_api_tpu_torch.ops import packing as tpacking
from flux_fp8_api_tpu_torch.ops.schedule import get_schedule
from flux_fp8_api_tpu_torch.utils.config import FluxParams

from .torch_parity import numpy_flux_params, t

torch.set_num_threads(1)

# 3 + 3 blocks with heads of 128, the kernels' only width
FLUX = FluxParams(in_channels=16, vec_in_dim=32, context_in_dim=48, hidden_size=256, mlp_ratio=2.0, num_heads=2,
                  depth=3, depth_single_blocks=3, axes_dim=[16, 56, 56], theta=10_000, qkv_bias=True,
                  guidance_embed=True)
ALL = tflux.Compiled(blocks=True, extras=True)
FUNCTIONS = ("flux_pre", "flux_final", "_double_block", "_single_block")


@pytest.fixture(autouse=True)
def _compile_on_the_cpu(monkeypatch):
    """aot_eager, and every compiled function and dynamo cache dropped before and after."""
    monkeypatch.setattr(tflux, "COMPILE_BACKEND", "aot_eager")
    monkeypatch.setattr(jattn, "FORCE_PALLAS_INTERPRET", True)
    tflux.reset_compiled()
    yield
    tflux.reset_compiled()


def graphs():
    return {fn: tflux.COMPILES[fn] for fn in FUNCTIONS}


def per_function(n):
    return {fn: n for fn in FUNCTIONS}


@pytest.fixture(scope="module")
def jax_flux():
    cfg = jflux.FluxStatic.from_params(FLUX, compute_dtype="float32", use_pallas=True)
    return cfg, numpy_flux_params(cfg, seed=4)


@pytest.fixture(scope="module")
def port_cfg():
    return tflux.FluxStatic.from_params(FLUX, compute_dtype="float32")


def make_inputs(seed=0, h=8, w=6, txt_len=7):
    """numpy inputs of a tail-masked joint sequence (7 + h·w/4 tokens)."""
    r = np.random.default_rng(seed)
    return dict(
        img=r.normal(size=(1, h * w // 4, FLUX.in_channels)).astype(np.float32),
        img_ids=np.asarray(tpacking.make_img_ids(h, w, 1)),
        txt=r.normal(size=(1, txt_len, FLUX.context_in_dim)).astype(np.float32),
        txt_ids=np.asarray(tpacking.make_txt_ids(txt_len, 1)),
        timesteps=np.full((1,), 0.7, np.float32),
        y=r.normal(size=(1, FLUX.vec_in_dim)).astype(np.float32),
        guidance=np.full((1,), 3.5, np.float32),
    )


def port_forward(model, cfg, x, compiled=None):
    with torch.inference_mode():
        return tflux.flux_apply(model, cfg, **{k: t(v) for k, v in x.items()}, compiled=compiled)


def _rel(b, a):
    return float(np.linalg.norm(b - a) / np.linalg.norm(a))


def denoise_inputs(seed=0, h=8, w=8, txt_len=6, steps=3):
    r = np.random.default_rng(seed)
    noise = torch.from_numpy(r.normal(size=(1, FLUX.in_channels // 4, h, w)).astype(np.float32))
    x = (tpacking.pack_latents(noise), tpacking.make_img_ids(h, w, 1),
         torch.from_numpy(r.normal(size=(1, txt_len, FLUX.context_in_dim)).astype(np.float32)),
         tpacking.make_txt_ids(txt_len, 1),
         torch.from_numpy(r.normal(size=(1, FLUX.vec_in_dim)).astype(np.float32)))
    return x, get_schedule(steps, h * w // 4, shift=True)


class Launches:
    """Stand-ins for the kernels' launches on the CPU, in the place of the ops' plain
    path (``_rope_plain``, ``_k1_plain``, which take a launch's arguments): each counts
    as the launch counts (``LAUNCHES``), keeps the tile it was given, and returns the
    plain path's outputs."""

    def __init__(self, monkeypatch):
        self.tiles = []
        self._rope, self._k1 = tak._rope_plain, tak._k1_plain
        monkeypatch.setattr(tak, "_rope_plain", self.rope)
        monkeypatch.setattr(tak, "_k1_plain", self.k1)
        for key in tak.LAUNCHES:
            monkeypatch.setitem(tak.LAUNCHES, key, 0)

    def rope(self, entry, build, *args):
        tak.LAUNCHES[build] += 1
        return self._rope(entry, build, *args)

    def k1(self, q, k, v, sm_scale, tile, build):
        tak.LAUNCHES[tak.K1_BUILDS[build]] += 1
        self.tiles.append(tile[:2])
        return self._k1(q, k, v, sm_scale, tile, build)


# -------------------------------------------------------------------------- the ops


def _heads(seed, h=2, l=24, dtype=torch.float32):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.normal(size=(h, l, tak.HEAD_DIM))).to(dtype)


def _tables(l=24):
    ang = torch.arange(l * tak.HEAD_DIM, dtype=torch.float32).reshape(l, tak.HEAD_DIM) * 0.01
    return torch.cos(ang), torch.sin(ang)


OP_CASES = {
    "rope_rotate": lambda: (torch.ops.flux_fp8.rope_rotate.default,
                            (_heads(0), _heads(1), *_tables(), *_tables())),
    "rope_rotate autograd fp64": lambda: (torch.ops.flux_fp8.rope_rotate.default,
                                          (_heads(0, dtype=torch.float64).requires_grad_(),
                                           _heads(1, dtype=torch.float64).requires_grad_(), *_tables(), *_tables())),
    "rope_rotate strided q": lambda: (torch.ops.flux_fp8.rope_rotate.default,
                                      (_heads(0, l=24).transpose(0, 1).contiguous().transpose(0, 1), _heads(1),
                                       *_tables(), *_tables())),
    "rope_rotate_backward": lambda: (torch.ops.flux_fp8.rope_rotate_backward.default,
                                     (_heads(2), _heads(3), *_tables(), *_tables())),
    **{f"qknorm_attention {name}": (lambda b: lambda: (torch.ops.flux_fp8.qknorm_attention.default,
                                                       (_heads(4), _heads(5), _heads(6), 128**-0.5, 128, 128, b)))(b)
       for b, name in enumerate(tak.K1_BUILDS)},
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_opcheck(case):
    """Schema, fake implementation (shapes and strides against the plain version's
    outputs), the op under AOTAutograd with dynamic shapes, and the rope pass's
    autograd formula, which calls the backward op."""
    op, args = OP_CASES[case]()
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_k1_op_returns_token_major_and_the_wrapper_its_view():
    q, k, v = _heads(0), _heads(1), _heads(2)
    out, m = torch.ops.flux_fp8.qknorm_attention(q, k, v, 0.1, 128, 128, 0)
    assert out.shape == (24, 2, 128) and out.is_contiguous() and m.numel() == 0
    view = tak.qknorm_attention(q, k, v, 0.1)
    assert view.shape == (2, 24, 128) and view.stride() == (128, 256, 1)
    assert torch.equal(view, tak.qknorm_attention_ref(q, k, v, 0.1))
    _, m = tak.qknorm_attention(q, k, v, 0.1, return_max_logit=True)
    assert m.shape == () and m.dtype == torch.float32


# ---------------------------------------------------------------------- tiny flux


def _port_tier(cfg, kind, seed=0):
    """The heads-of-128 tiny flux at ``kind``, quantized and calibrated by the port on
    one amax pass."""
    model = tflux.init_flux_params(cfg, torch.Generator().manual_seed(seed), torch.float32)
    if kind != "float":
        tflux.quantize_flux_tree(model, kind=kind)
        with torch.inference_mode():
            _, amaxes = tflux.flux_apply(model, cfg, **{k: t(v) for k, v in make_inputs(1).items()},
                                         collect_amax=True)
        tcal.apply_input_scales(model, amaxes)
    return model


@pytest.mark.parametrize("kind", ["float", "fp8", "int8", "int4"])
def test_compiled_flux_is_eager_bit_for_bit(port_cfg, kind):
    """The whole forward of the 3 + 3 blocks with the blocks and the extras compiled:
    bit for bit the eager forward, one graph per function; the blocks alone compiled
    run the same graphs again."""
    model = _port_tier(port_cfg, kind)
    x = make_inputs(0)
    eager = port_forward(model, port_cfg, x)
    assert torch.equal(port_forward(model, port_cfg, x, ALL), eager)
    assert graphs() == per_function(1)
    assert torch.equal(port_forward(model, port_cfg, x, tflux.Compiled(blocks=True)), eager)
    assert graphs() == per_function(1)


def test_cache_indicator_compiled_as_an_extra(port_cfg):
    model = tflux.init_flux_params(port_cfg, torch.Generator().manual_seed(0), torch.float32)
    x = {k: t(v) for k, v in make_inputs(2).items()}
    args = (model, port_cfg, x["img"], x["timesteps"], x["y"], x["guidance"])
    with torch.inference_mode():
        eager = tflux.flux_cache_indicator(*args)
        assert torch.equal(tflux.flux_cache_indicator(*args, compiled=ALL), eager)
    assert tflux.COMPILES["_cache_indicator"] == 1


def test_no_compile_with_grad_calibration_or_a_runner(port_cfg):
    """Training (grad), calibration (collect_amax) and a stack runner run eagerly."""
    model = tflux.init_flux_params(port_cfg, torch.Generator().manual_seed(0), torch.float32)
    x = {k: t(v) for k, v in make_inputs(3).items()}
    tflux.flux_apply(model, port_cfg, **x, compiled=ALL)  # grad enabled
    with torch.inference_mode():
        tflux.flux_apply(model, port_cfg, **x, collect_amax=True, compiled=ALL)
        tflux.flux_apply(model, port_cfg, **x, compiled=ALL,
                         stack_runner=lambda body, carry, blocks, extras, depth: _loop(body, carry, blocks, extras))
    assert sum(tflux.COMPILES.values()) == 0


def _loop(body, carry, blocks, extras):
    for blk in blocks:
        carry = body(carry, blk, extras)
    return carry


# ------------------------------------------------------------- graphs per bucket


def test_one_graph_per_function_and_bucket_across_steps_and_retain_0_offload(port_cfg):
    """The denoise loop compiled: one graph per function for a bucket, whatever the
    number of blocks and steps (t and the guidance arrive as tensors), one more for a
    second bucket. The streamed loop at retain 0, whose blocks are fresh copies at
    every step, runs the blocks' graphs and gives the resident loop's latents bit for
    bit; its extras read the top-level entries from a dict, not the model's tree, which
    is one graph of their own per bucket."""
    model = tflux.init_flux_params(port_cfg, torch.Generator().manual_seed(1), torch.bfloat16,
                                   tflux.quant_tier("fp8"))
    with torch.inference_mode():  # as a request makes its inputs
        x, ts = denoise_inputs(steps=4)
        x2, ts2 = denoise_inputs(h=8, w=12, steps=2)

        eager = tsampling.denoise(model, port_cfg, *x, ts, 3.5)
        compiled = tsampling.denoise(model, port_cfg, *x, ts, 3.5, compiled=ALL)
        assert torch.equal(compiled, eager) and graphs() == per_function(1)
        tops, dbl, sgl = toffload.split_flow_params(model)
        streamed = toffload.streamed_denoise(toffload.tops_to_device(tops, "cpu"), dbl, sgl, torch.device("cpu"),
                                             *x, ts, 3.5, port_cfg, retain_bytes=0, compiled=ALL)
        both = {**per_function(1), "flux_pre": 2, "flux_final": 2}
        assert torch.equal(streamed, compiled) and graphs() == both
        tsampling.denoise(model, port_cfg, *x2, ts2, 3.5, compiled=ALL)
        assert graphs() == {fn: n + 1 for fn, n in both.items()}
        tsampling.denoise(model, port_cfg, *x, ts, 3.5, compiled=ALL)
        assert graphs() == {fn: n + 1 for fn, n in both.items()}


# ------------------------------------------------------------------- guards


def test_a_newly_registered_tile_recompiles_and_is_used(port_cfg, monkeypatch):
    """The tile is read from ops/attention.py's tables while dynamo traces, so a tile
    registered later for the bucket's joint length is a failed guard: the blocks
    compile again and their K1 launches run the new tile."""
    for table in ("_TUNED_BLOCKS", "_TUNED_MARGINS", "_TUNED_BLOCKS_RECT", "_QKNORM_BLOCKS_MEASURED"):
        monkeypatch.setattr(tattn, table, {})
    launches = Launches(monkeypatch)
    model = tflux.init_flux_params(port_cfg, torch.Generator().manual_seed(2), torch.float32)
    x = make_inputs(4)
    joint = x["txt"].shape[1] + x["img"].shape[1]
    eager = port_forward(model, port_cfg, x)
    first = port_forward(model, port_cfg, x, ALL)
    assert torch.equal(first, eager) and graphs() == per_function(1)
    assert set(launches.tiles) == {tak.BLOCKS}
    tattn.register_tuned_blocks(joint, (64, 64))
    launches.tiles.clear()
    again = port_forward(model, port_cfg, x, ALL)
    assert torch.equal(again, eager)
    assert tflux.COMPILES["_double_block"] == 2 and tflux.COMPILES["_single_block"] == 2
    assert launches.tiles == [(64, 64)] * (FLUX.depth + FLUX.depth_single_blocks)


def test_the_launch_count_rises_at_every_compiled_run(port_cfg, monkeypatch):
    """The counts sit in the ops' implementations, so a compiled graph counts every
    run of it, the runs from the cache too: 6 K1 and 6 rope-pass launches per
    evaluation here, and the count only rises."""
    Launches(monkeypatch)
    model = tflux.init_flux_params(port_cfg, torch.Generator().manual_seed(3), torch.float32)
    x = make_inputs(5)
    blocks = FLUX.depth + FLUX.depth_single_blocks
    seen = []
    for _ in range(3):
        port_forward(model, port_cfg, x, ALL)
        seen.append((tak.LAUNCHES["qknorm_attention"], tak.LAUNCHES["rope_rotate"]))
    assert seen == [(blocks * n, blocks * n) for n in (1, 2, 3)]
    assert graphs() == per_function(1)


def test_past_the_recompile_limit_it_raises(port_cfg, monkeypatch):
    """Past dynamo's recompile limit a compiled function raises; it never runs the
    bucket eagerly without a word."""
    import torch._dynamo

    model = tflux.init_flux_params(port_cfg, torch.Generator().manual_seed(4), torch.float32)
    port_forward(model, port_cfg, make_inputs(0, h=4, w=4), ALL)
    assert torch._dynamo.config.fail_on_recompile_limit_hit
    monkeypatch.setattr(torch._dynamo.config, "recompile_limit", 2)
    port_forward(model, port_cfg, make_inputs(0, h=4, w=8), ALL)
    with pytest.raises(Exception, match="recompile_limit|cache_size_limit|recompile limit"):
        port_forward(model, port_cfg, make_inputs(0, h=8, w=8), ALL)
