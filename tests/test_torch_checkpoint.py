"""The port's checkpoint I/O against the JAX package's, on the CPU: safetensors files
read across the two packages, BFL flow files (float and reference-prequantized, with
the rope deinterleave), the ``flux-fp8-api-tpu/prequant-v1`` files each package saves
loaded by the other, the tolerant-load reports, VAE files, HF text-encoder
directories with their tokenizers, ``flux_from_pretrained``, the CLI's
``--save-prequantized`` and a pipeline served from a checkpoint.

Tolerances: every tensor that crosses a file is compared for equality (bytes are
moved, not converted, and float32 → bf16 rounds to nearest even in both packages).
Where a file gives both packages the same tree, the forward is compared once (the BFL
file), in fp32 with the JAX side's Pallas attention in interpret mode, as
tests/test_torch_flux.py does: 1e-4 in norm. T5 and CLIP encodings: 1e-5
(fp32 summation order). The 2-step pipeline request: the float slice's tolerance of
tests/test_torch_pipeline.py, 1e-4 in norm and 1e-3 per element.
"""

import functools
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from flux_fp8_api_tpu import calibration as jcal
from flux_fp8_api_tpu.models import flux as jflux
from flux_fp8_api_tpu.ops import attention as jattn
from flux_fp8_api_tpu.utils import checkpoint as jckpt
from flux_fp8_api_tpu.utils import loader as jloader
from flux_fp8_api_tpu.utils import safetensors_io as jst
from flux_fp8_api_tpu_torch.models import flux as tflux
from flux_fp8_api_tpu_torch.ops import quant as tquant
from flux_fp8_api_tpu_torch.utils import checkpoint as tckpt
from flux_fp8_api_tpu_torch.utils import loader as tloader
from flux_fp8_api_tpu_torch.utils import safetensors_io as tst

from .helpers import TINY_AE_PARAMS, TINY_FLUX_PARAMS, tiny_spec
from .test_checkpoint import _reference_prequant_checkpoint, _synthetic_ae_checkpoint, _synthetic_bfl_checkpoint
from .test_torch_flux import make_inputs
from .torch_parity import numpy_flux_params, t, to_torch, write_bfl_checkpoint

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setattr(jattn, "FORCE_PALLAS_INTERPRET", True)


def _rel(b, a):
    return float(np.linalg.norm(b - a) / np.linalg.norm(a))


def assert_same_model(b, a):
    """Two port models with the same tensors, bit for bit (kinds included)."""
    ma, mb = dict(a.named_modules()), dict(b.named_modules())
    for name, m in mb.items():
        if isinstance(m, tquant.Linear):
            assert m.kind == ma[name].kind, name
    ba, bb = dict(a.named_buffers()), dict(b.named_buffers())
    assert sorted(ba) == sorted(bb)
    for key in ba:
        assert bb[key].dtype == ba[key].dtype and bb[key].shape == ba[key].shape, key
        assert torch.equal(bb[key].view(torch.uint8) if bb[key].element_size() == 1 else bb[key],
                           ba[key].view(torch.uint8) if ba[key].element_size() == 1 else ba[key]), key


def jcfg(dtype="float32"):
    return jflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype=dtype, use_pallas=True)


def pcfg(dtype="float32"):
    return tflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype=dtype)


def forwards(jparams, model, x=None):
    x = x or make_inputs()
    a = np.asarray(jflux.flux_apply(jparams, jcfg(), **{k: jnp.asarray(v) for k, v in x.items()}))
    b = tflux.flux_apply(model, pcfg(), **{k: t(v) for k, v in x.items()}).numpy()
    return a, b


# ---------------------------------------------------------------------- safetensors

DTYPES = {
    "F32": (np.float32, torch.float32), "F16": (np.float16, torch.float16),
    "BF16": (ml_dtypes.bfloat16, torch.bfloat16), "F8_E4M3": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn),
    "F8_E5M2": (ml_dtypes.float8_e5m2, torch.float8_e5m2), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "I32": (np.int32, torch.int32), "I64": (np.int64, torch.int64),
}


def _arrays():
    r = np.random.default_rng(0)
    out = {}
    for name, (npd, _) in DTYPES.items():
        if np.issubdtype(np.dtype(npd), np.integer):
            info = np.iinfo(npd)
            out[name] = r.integers(max(info.min, -1000), min(info.max, 1000), size=(3, 5)).astype(npd)
        else:
            out[name] = (r.normal(size=(3, 5)) * 4).astype(npd)
    out["scalar"] = np.array(2.5, np.float32)
    out["empty"] = np.zeros((0, 4), np.float32)
    return out


def _bytes(x: torch.Tensor) -> bytes:
    return x.reshape(-1).view(torch.uint8).numpy().tobytes()


def test_safetensors_written_by_jax_read_by_the_port(tmp_path):
    arrays = _arrays()
    jst.save_safetensors(str(tmp_path / "j.safetensors"), arrays, metadata={"hello": "world"})
    f = tst.SafetensorsFile(tmp_path / "j.safetensors")
    assert f.metadata == {"hello": "world"} and set(f.keys()) == set(arrays) and "F32" in f
    for name, a in arrays.items():
        b = f.get(name)
        # the JAX writer stores a 0-d array as shape [1] (np.ascontiguousarray)
        assert tuple(b.shape) == np.ascontiguousarray(a).shape, name
        assert b.dtype == DTYPES.get(name, (None, torch.float32))[1], name
        assert _bytes(b) == a.tobytes(), name
    assert set(tst.load_safetensors(tmp_path / "j.safetensors")) == set(arrays)


def test_safetensors_written_by_the_port_read_by_jax(tmp_path):
    arrays = _arrays()
    tensors = {}
    for name, a in arrays.items():
        if a.dtype.kind == "V" or str(a.dtype).startswith(("bfloat16", "float8")):
            width = {1: np.uint8, 2: np.int16}[a.dtype.itemsize]
            tensors[name] = torch.from_numpy(a.view(width).copy()).view(DTYPES[name][1])
        else:
            tensors[name] = torch.from_numpy(a.copy())
    tst.save_safetensors(tmp_path / "t.safetensors", tensors, metadata={"k": 1})
    f = jst.SafetensorsFile(str(tmp_path / "t.safetensors"), use_native=False)
    assert f.metadata == {"k": "1"}
    for name, a in arrays.items():
        b = f.get(name)
        assert b.dtype == a.dtype and b.shape == a.shape, name
        assert b.tobytes() == a.tobytes(), name


def test_safetensors_tensors_are_views_over_the_map(tmp_path):
    """A tensor is read where it lies in the file, not by reading the file whole."""
    tst.save_safetensors(tmp_path / "v.safetensors", {"a": torch.arange(6.0), "b": torch.ones(3, dtype=torch.int8)})
    f = tst.SafetensorsFile(tmp_path / "v.safetensors")
    a = f.get("a")
    a += 1  # copy-on-write map: the file is not touched
    assert torch.equal(tst.SafetensorsFile(tmp_path / "v.safetensors").get("a"), torch.arange(6.0))
    assert f.get("b").dtype == torch.int8


# ------------------------------------------------------------------------ BFL flow


def test_bfl_file_loads_like_jax(tmp_path):
    path = str(tmp_path / "flux.safetensors")
    _synthetic_bfl_checkpoint(path)
    jtree = jckpt.load_flux_checkpoint(path, jcfg())
    model = tckpt.load_flux_checkpoint(path, pcfg(), device="cpu")
    assert_same_model(model, to_torch(jtree))
    a, b = forwards(jtree, model)
    assert _rel(b, a) < 1e-4


def test_bfl_writer_round_trips_through_both_loaders(tmp_path):
    """The test writer re-interleaves the rope layout; both loaders undo it. qk-norm
    scales differ per channel, so a wrong permutation shows."""
    cfg = jcfg()
    src = to_torch(numpy_flux_params(cfg, seed=4))
    path = tmp_path / "written.safetensors"
    write_bfl_checkpoint(path, src, pcfg())
    assert_same_model(tckpt.load_flux_checkpoint(path, pcfg(), device="cpu"), src)
    assert_same_model(to_torch(jckpt.load_flux_checkpoint(str(path), cfg)), src)


def test_deinterleave_moves_q_and_k_rows_and_norms(tmp_path):
    cfg = pcfg()
    src = to_torch(numpy_flux_params(jcfg(), seed=5))
    write_bfl_checkpoint(tmp_path / "w.safetensors", src, cfg)
    raw = tst.SafetensorsFile(tmp_path / "w.safetensors")
    hs, hd = cfg.hidden_size, cfg.head_dim
    stored = raw.get("double_blocks.0.img_attn.qkv.weight")
    assert not torch.equal(stored, src["double_blocks"][0]["img_attn_qkv"].weight)
    perm = tckpt.qkv_out_permutation(hs, hd)
    np.testing.assert_array_equal(perm, jckpt.qkv_out_permutation(hs, hd))
    np.testing.assert_array_equal(tckpt.qkv_out_permutation(hs, hd, extra=7), jckpt.qkv_out_permutation(hs, hd, extra=7))
    assert torch.equal(stored[torch.as_tensor(perm)], src["double_blocks"][0]["img_attn_qkv"].weight)
    assert torch.equal(stored[2 * hs:], src["double_blocks"][0]["img_attn_qkv"].weight[2 * hs:])  # v stays


@pytest.mark.parametrize("kind", ["float", "fp8", "int8", "int4"])
def test_linear_permutations_match_jax(kind):
    """Out-axis (rows here) permutes any kind in place; in-axis permutes columns, and
    int4's half-split in axis goes through dequantize → permute → requantize. JAX
    runs that round trip eagerly, where the reciprocal scale is an exact division;
    the port forms it as the JAX package's jitted quantizer does (ops/quant.py
    _int_scales), one ulp away at most."""
    from flux_fp8_api_tpu.ops import quant as jquant

    r = np.random.default_rng(9)
    k = (r.normal(size=(32, 24)) * r.uniform(0.05, 0.5, size=(1, 24))).astype(np.float32)
    bias = r.normal(size=(24,)).astype(np.float32)
    qfn = {"float": lambda k, b: jquant.Linear(kernel=k, bias=b, kind="float"), "fp8": jquant.quantize_linear_fp8,
           "int8": jax.jit(jquant.quantize_linear_int8), "int4": jax.jit(jquant.quantize_linear_int4)}[kind]
    a = qfn(jnp.asarray(k), jnp.asarray(bias))
    if kind != "float":
        a = jquant.with_input_scale(a, jnp.float32(2.0))
    b = to_torch(a)
    stacked = jax.tree.map(lambda v: v[None], a)  # JAX permutes depth-stacked leaves

    def jax_perm(fn, perm):
        return jax.tree.map(lambda v: v[0], fn(stacked, jnp.asarray(perm)))

    out_perm, in_perm = r.permutation(24), r.permutation(32)
    for ja, tb in ((jax_perm(jckpt._permute_linear_out, out_perm), tckpt._permute_linear_out(b, out_perm)),
                   (jax_perm(jckpt._permute_linear_in, in_perm), tckpt._permute_linear_in(b, in_perm))):
        want = to_torch(ja)
        for name in ("weight", "q", "w_scale", "bias", "in_scale"):
            x, y = getattr(tb, name), getattr(want, name)
            assert (x is None) == (y is None), name
            if x is not None:
                assert torch.equal(x.view(torch.uint8) if x.element_size() == 1 else x,
                                   y.view(torch.uint8) if y.element_size() == 1 else y), name
        if tb.w_scale_inv is not None:
            torch.testing.assert_close(tb.w_scale_inv, want.w_scale_inv, rtol=2**-22, atol=0)
    with pytest.raises(ValueError, match="weight-only"):
        tckpt._permute_linear_in(tquant.quantize_linear_wo_int4(torch.ones(8, 64), None), np.arange(64))


@pytest.mark.parametrize("with_input_scales", [True, False])
def test_reference_prequantized_file_loads_like_jax(tmp_path, with_input_scales):
    path = str(tmp_path / "ref.safetensors")
    _reference_prequant_checkpoint(path, with_input_scales=with_input_scales)
    assert tckpt.is_prequantized_reference_file(path)
    assert tckpt.reference_prequant_has_input_scales(path) == with_input_scales
    jtree = jckpt.load_flux_checkpoint(path, jcfg())
    model = tckpt.load_flux_checkpoint(path, pcfg(), device="cpu")
    assert_same_model(model, to_torch(jtree))
    assert model["double_blocks"][0]["img_attn_qkv"].kind == "fp8" and model["img_in"].kind == "float"
    # the prequantized flag: the file's detection, as the JAX loader sets it
    spec = dict(ckpt_path=path, prequantized_flow=True, fp8_fast_accum=False)
    assert tloader.load_flow_model(tiny_spec(**spec))[2] == jloader.load_flow_model(tiny_spec(**spec))[2] \
        == with_input_scales


def test_missing_input_scales_calibrate_under_prequantized_flow(tmp_path, monkeypatch):
    """The repaired rule: a reference-prequantized file without input scales, under
    prequantized_flow=true, must calibrate in both packages (the port used to take
    ``prequant or config.prequantized_flow`` and served every fp8 leaf at
    in_scale 1.0)."""
    from flux_fp8_api_tpu.pipeline import FluxPipeline as JaxPipeline
    from flux_fp8_api_tpu_torch.pipeline import FluxPipeline

    path = str(tmp_path / "ref.safetensors")
    _reference_prequant_checkpoint(path, with_input_scales=False)
    spec = tiny_spec(ckpt_path=path, prequantized_flow=True, fp8_fast_accum=False, num_scale_trials=2)
    # the JAX rule, without its eager text-encoder and VAE inits (seconds each here)
    monkeypatch.setattr(jloader, "load_text_encoders", lambda config: (None, None))
    monkeypatch.setattr(jloader, "load_autoencoder", lambda config: None)
    jmodels = jloader.load_models_from_config(spec)
    assert jmodels.flow_prequantized is False
    jpipe = JaxPipeline("flux-dev", model=jmodels.flow, model_cfg=jmodels.flow_cfg, config=spec,
                        prequantized=jmodels.flow_prequantized)
    assert jpipe._needs_calibration
    models = tloader.load_models_from_config(spec)
    assert models.flow_prequantized is False
    pipe = FluxPipeline.load_pipeline_from_config(spec)
    assert pipe._needs_calibration
    pipe.generate("a cat", 64, 64, 2, seed=1)
    assert pipe._trials_done == 2 and not pipe._needs_calibration
    assert float(pipe.model_params["double_blocks"][0]["img_attn_qkv"].in_scale) != 1.0
    # with a float file and no claim, the config flag holds only without a checkpoint
    assert tloader.load_models_from_config(tiny_spec(prequantized_flow=True)).flow_prequantized is True


# ------------------------------------------------------------------ prequant-v1 files


@functools.lru_cache(maxsize=None)
def _calibrated_jax(kind):
    """A calibrated JAX tree per kind, shared by the tests that save it (JAX trees
    are immutable)."""
    cfg = jcfg()
    q = jflux.quantize_flux_tree(numpy_flux_params(cfg, seed=6), kind=kind)
    x = make_inputs(1)
    _, amaxes = jflux.flux_apply(q, cfg, **{k: jnp.asarray(v) for k, v in x.items()}, collect_amax=True)
    return jcal.apply_input_scales_jit(q, amaxes)


@pytest.mark.parametrize("kind", ["fp8", "int8", "int4"])
def test_prequant_file_saved_by_jax_loads_in_the_port(tmp_path, kind):
    q = _calibrated_jax(kind)
    path = str(tmp_path / "jax.safetensors")
    jckpt.save_prequantized(path, q, extra_meta={"quantize_modulation": "True"})
    model = tckpt.load_prequantized(path, pcfg(), device="cpu")
    # the tree the converter gives, bit for bit: its forward is held against JAX's by
    # tests/test_torch_flux.py (fp8) and tests/test_torch_quant_tiers.py (int8, int4)
    assert_same_model(model, to_torch(q))
    assert model["single_blocks"][0]["linear2"].kind == kind


@pytest.mark.parametrize("kind", ["fp8", "int8", "int4"])
def test_prequant_file_saved_by_the_port_loads_in_jax(tmp_path, kind):
    q = _calibrated_jax(kind)
    model = to_torch(q)
    path = str(tmp_path / "port.safetensors")
    tckpt.save_prequantized(path, model, extra_meta={"version": "flux-dev"})
    f = jst.SafetensorsFile(path, use_native=False)
    assert f.metadata["format"] == jckpt.PREQUANT_FORMAT and f.metadata["version"] == "flux-dev"
    jtree = jckpt.load_prequantized(path, jcfg())
    assert_same_model(to_torch(jtree), model)
    # the file itself: the JAX package's names, shapes and dtypes
    jpath = str(tmp_path / "jax.safetensors")
    jckpt.save_prequantized(jpath, q)
    g = jst.SafetensorsFile(jpath, use_native=False)
    assert set(f.keys()) == set(g.keys())
    assert json.loads(f.metadata["linears"]) == json.loads(g.metadata["linears"])
    for key in g.keys():
        assert f.get(key).tobytes() == g.get(key).tobytes(), key


def test_load_prequantized_refuses_other_files(tmp_path):
    path = str(tmp_path / "flux.safetensors")
    _synthetic_bfl_checkpoint(path)
    with pytest.raises(ValueError, match="prequant-v1"):
        tckpt.load_prequantized(path, pcfg(), device="cpu")


# ------------------------------------------------------------ tolerant loads, reports


def test_flux_missing_and_extra_keys_fill_like_jax(tmp_path):
    path = str(tmp_path / "flux.safetensors")
    sd = _synthetic_bfl_checkpoint(path)
    del sd["double_blocks.0.img_attn.qkv.bias"]
    del sd["single_blocks.0.norm.query_norm.scale"]
    del sd["final_layer.linear.weight"]
    sd["ema.shadow.0"] = np.zeros(4, np.float32)
    jst.save_safetensors(path, sd)
    model = tckpt.load_flux_checkpoint(path, pcfg(), device="cpu")
    assert_same_model(model, to_torch(jckpt.load_flux_checkpoint(path, jcfg())))
    assert torch.equal(model["double_blocks"][0]["img_attn_qkv"].bias, torch.zeros(192))
    with pytest.raises(KeyError, match="img_attn.qkv.bias"):
        tckpt.load_flux_checkpoint(path, pcfg(), strict=True, device="cpu")


@pytest.mark.parametrize("entry", ["load_flux_checkpoint", "load_ae_checkpoint", "load_prequantized",
                                   "load_clip_checkpoint", "load_t5_checkpoint", "TextEncoder",
                                   "TextEncoder.from_pretrained"])
def test_loaders_default_to_the_card(entry, tmp_path):
    """With no ``device`` the loaders and encoders build on cuda:0 (``into_device``),
    and raise where there is no CUDA, before reading anything: none of them falls
    back to the host. The CPU tests above pass ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is cuda:0 there")
    from flux_fp8_api_tpu_torch.models.clip import CLIPConfig, load_clip_checkpoint
    from flux_fp8_api_tpu_torch.models.conditioner import TextEncoder
    from flux_fp8_api_tpu_torch.models.t5 import T5Config, load_t5_checkpoint
    from flux_fp8_api_tpu_torch.utils.tree import ParamTree

    missing = str(tmp_path / "absent.safetensors")
    call = {
        "load_flux_checkpoint": lambda: tckpt.load_flux_checkpoint(missing, pcfg()),
        "load_ae_checkpoint": lambda: tckpt.load_ae_checkpoint(missing, TINY_AE_PARAMS),
        "load_prequantized": lambda: tckpt.load_prequantized(missing, pcfg()),
        "load_clip_checkpoint": lambda: load_clip_checkpoint(None, CLIPConfig()),
        "load_t5_checkpoint": lambda: load_t5_checkpoint(None, T5Config()),
        "TextEncoder": lambda: TextEncoder("clip", ParamTree({}), CLIPConfig(), None, 77),
        "TextEncoder.from_pretrained": lambda: TextEncoder.from_pretrained("t5", str(tmp_path), 16),
    }[entry]
    with pytest.raises(RuntimeError, match="needs CUDA"):
        call()


def test_load_report_fills_and_formats():
    r = tckpt.LoadReport("x")
    sd = {"a": torch.ones(2)}
    assert torch.equal(tckpt.LoadReport.fetch(sd.__getitem__, "a", (2,), report=r), torch.ones(2))
    assert torch.equal(tckpt.LoadReport.fetch(sd.__getitem__, "b", (3,), fill=1.0, report=r), torch.ones(3))
    with pytest.raises(KeyError):
        tckpt.LoadReport.fetch(sd.__getitem__, "b", (3,))
    r.finish(["a", "b", "c"])
    assert r.missing == ["b"] and r.unexpected == ["b", "c"]
    for i in range(40):
        r.miss(f"k{i:02d}")
    assert "+29 more" in tckpt.LoadReport._fmt(r.missing)
    with pytest.raises(KeyError, match="missing keys"):
        r.finish([], strict=True)


# --------------------------------------------------------------------------- the VAE


def test_ae_file_loads_like_jax(tmp_path):
    path = str(tmp_path / "ae.sft")
    _synthetic_ae_checkpoint(path, TINY_AE_PARAMS, drop=("decoder.conv_out.bias", "encoder.norm_out.weight"),
                             extra=("loss.logvar",))
    jtree = jckpt.load_ae_checkpoint(path, TINY_AE_PARAMS, jnp.float32)
    tree = tckpt.load_ae_checkpoint(path, TINY_AE_PARAMS, torch.float32, device="cpu")
    assert_same_model(tree, to_torch(jtree))
    assert "bias" not in tree["decoder"]["conv_out"]
    assert "downsample" in tree["encoder"]["down"][0] and "downsample" not in tree["encoder"]["down"][-1]


def test_ae_missing_conv_weights_raise_one_aggregate_error(tmp_path):
    path = str(tmp_path / "ae.sft")
    _synthetic_ae_checkpoint(path, TINY_AE_PARAMS, drop=("decoder.conv_in.weight", "encoder.conv_out.weight"))
    with pytest.raises(KeyError) as e:
        tckpt.load_ae_checkpoint(path, TINY_AE_PARAMS, device="cpu")
    assert "decoder.conv_in.weight" in str(e.value) and "encoder.conv_out.weight" in str(e.value)


def test_ae_checkpoint_decodes_like_jax(tmp_path):
    """A full-channel tiny VAE written by its own init, loaded by both packages."""
    from flux_fp8_api_tpu.models import autoencoder as jae
    from flux_fp8_api_tpu_torch.models import autoencoder as tae

    from .torch_parity import numpy_ae_params

    params = numpy_ae_params(TINY_AE_PARAMS, seed=3)
    port = to_torch(params)
    tst.save_safetensors(tmp_path / "ae.sft", dict(port.named_buffers()))  # module paths are ae.sft's names
    jtree = jckpt.load_ae_checkpoint(str(tmp_path / "ae.sft"), TINY_AE_PARAMS, jnp.float32)
    tree = tckpt.load_ae_checkpoint(tmp_path / "ae.sft", TINY_AE_PARAMS, torch.float32, device="cpu")
    assert_same_model(tree, port)
    z = np.random.default_rng(5).normal(size=(1, 8, 6, TINY_AE_PARAMS.z_channels)).astype(np.float32)
    a = np.asarray(jax.jit(lambda p, z: jae.ae_decode(p, TINY_AE_PARAMS, z))(jtree, jnp.asarray(z)))
    np.testing.assert_allclose(tae.ae_decode(tree, TINY_AE_PARAMS, t(z)).numpy(), a, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ text encoders


def _write_hf_dir(path, kind, seed):
    """A local HF-style directory: config.json, model.safetensors and a word-level
    tokenizer saved as tokenizer.json with a tokenizer_config.json."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from tokenizers.processors import TemplateProcessing

    path.mkdir()
    r = np.random.RandomState(seed)
    vocab = {"<pad>": 0, "<bos>": 1, "<eos>": 2, "<unk>": 3}
    for w in "a photo of cat dog red house on the hill".split():
        vocab[w] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    special = {"eos_token": "<eos>", "unk_token": "<unk>", "model_max_length": 77}
    if kind == "clip":
        tok.post_processor = TemplateProcessing(single="<bos> $A <eos>", special_tokens=[("<bos>", 1), ("<eos>", 2)])
        special.update(bos_token="<bos>", pad_token="<eos>")
        cfg = {"vocab_size": 64, "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
               "num_attention_heads": 2, "max_position_embeddings": 77, "eos_token_id": 2}
        h, inter = 32, 64
        sd = {"text_model.embeddings.token_embedding.weight": r.randn(64, h),
              "text_model.embeddings.position_embedding.weight": r.randn(77, h),
              "text_model.final_layer_norm.weight": 1 + 0.1 * r.randn(h),
              "text_model.final_layer_norm.bias": 0.1 * r.randn(h)}
        for i in range(2):
            p = f"text_model.encoder.layers.{i}."
            for n, (o, f) in {"self_attn.q_proj": (h, h), "self_attn.k_proj": (h, h), "self_attn.v_proj": (h, h),
                              "self_attn.out_proj": (h, h), "mlp.fc1": (inter, h), "mlp.fc2": (h, inter)}.items():
                sd[p + n + ".weight"] = r.randn(o, f) * 0.1
                sd[p + n + ".bias"] = r.randn(o) * 0.01
            for n in ("layer_norm1", "layer_norm2"):
                sd[p + n + ".weight"] = 1 + 0.1 * r.randn(h)
                sd[p + n + ".bias"] = 0.1 * r.randn(h)
        cfg = {"text_config": cfg, "model_type": "clip"}  # the nested form
    else:
        tok.post_processor = TemplateProcessing(single="$A <eos>", special_tokens=[("<eos>", 2)])
        special.update(pad_token="<pad>")
        cfg = {"vocab_size": 64, "d_model": 48, "d_ff": 96, "num_layers": 2, "num_heads": 3, "d_kv": 16}
        d, ff, inner = 48, 96, 48
        sd = {"shared.weight": r.randn(64, d),
              "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight": r.randn(32, 3),
              "encoder.final_layer_norm.weight": 1 + 0.1 * r.randn(d)}
        for i in range(2):
            p = f"encoder.block.{i}."
            for n, shape in {"layer.0.SelfAttention.q": (inner, d), "layer.0.SelfAttention.k": (inner, d),
                             "layer.0.SelfAttention.v": (inner, d), "layer.0.SelfAttention.o": (d, inner),
                             "layer.1.DenseReluDense.wi_0": (ff, d), "layer.1.DenseReluDense.wi_1": (ff, d),
                             "layer.1.DenseReluDense.wo": (d, ff)}.items():
                sd[p + n + ".weight"] = r.randn(*shape) * 0.1
            sd[p + "layer.0.layer_norm.weight"] = 1 + 0.1 * r.randn(d)
            sd[p + "layer.1.layer_norm.weight"] = 1 + 0.1 * r.randn(d)
        sd["decoder.junk"] = np.zeros(2)  # unexpected: reported, ignored
    tok.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "PreTrainedTokenizerFast", **special}))
    (path / "config.json").write_text(json.dumps(cfg))
    jst.save_safetensors(str(path / "model.safetensors"), {k: np.asarray(v, np.float32) for k, v in sd.items()})


@pytest.mark.parametrize("kind,tier", [("t5", None), ("t5", "qint4"), ("clip", None), ("clip", "qint8")])
def test_text_encoder_from_pretrained_matches_jax(tmp_path, kind, tier):
    from flux_fp8_api_tpu.models.conditioner import TextEncoder as JaxTextEncoder
    from flux_fp8_api_tpu_torch.models.conditioner import TextEncoder

    d = tmp_path / kind
    _write_hf_dir(d, kind, seed=1)
    max_length = 77 if kind == "clip" else 16
    a = JaxTextEncoder.from_pretrained(kind, str(d), max_length, dtype="float32", quantization_dtype=tier)
    b = TextEncoder.from_pretrained(kind, str(d), max_length, dtype="float32", quantization_dtype=tier,
                                  device="cpu")
    assert b.config == type(b.config)(**{f: getattr(a.config, f) for f in a.config.__dataclass_fields__})
    prompts = ["a photo of a red cat on the hill", "a dog"]
    ids_a = a.tokenizer(prompts, truncation=True, max_length=max_length, padding="max_length", return_tensors="np")
    ids_b = b.tokenizer(prompts, truncation=True, max_length=max_length, padding="max_length", return_tensors="np")
    np.testing.assert_array_equal(ids_b.input_ids, ids_a.input_ids)
    np.testing.assert_allclose(b(prompts).numpy(), np.asarray(a(prompts)), rtol=1e-5, atol=1e-5)
    if tier:
        assert b.params["blocks"][0]["wo" if kind == "t5" else "fc1"].kind == "wo_" + tier[1:]


def test_hf_sharded_directory_getter(tmp_path):
    from flux_fp8_api_tpu_torch.models.conditioner import _hf_state_dict_getter

    sd = {f"w{i}": np.full((2,), i, np.float32) for i in range(4)}
    jst.save_safetensors(str(tmp_path / "a.safetensors"), {k: sd[k] for k in ("w0", "w1")})
    jst.save_safetensors(str(tmp_path / "b.safetensors"), {k: sd[k] for k in ("w2", "w3")})
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {"w0": "a.safetensors", "w1": "a.safetensors", "w2": "b.safetensors", "w3": "b.safetensors"}}))
    get = _hf_state_dict_getter(tmp_path)
    assert get.all_keys == set(sd)
    assert torch.equal(get("w3"), torch.full((2,), 3.0))
    with pytest.raises(KeyError):
        get("nope")


# ------------------------------------------------------------------ loaders, CLI, pipeline


def _write_config(path, **overrides):
    path.write_text(tiny_spec(**overrides).model_dump_json())
    return str(path)


def test_flux_from_pretrained_with_overrides(tmp_path):
    ckpt = str(tmp_path / "flux.safetensors")
    _synthetic_bfl_checkpoint(ckpt)
    cfg_path = _write_config(tmp_path / "config.json", flow_dtype="float32")
    model, cfg, prequant = tloader.flux_from_pretrained(cfg_path, ckpt_path=ckpt, flow_quantization_dtype="qint8")
    jmodel, _, jprequant = jloader.flux_from_pretrained(cfg_path, ckpt_path=ckpt, flow_quantization_dtype="qint8")
    assert prequant is jprequant is False
    assert model["double_blocks"][0]["img_attn_qkv"].kind == "int8"
    assert_same_model(model, to_torch(jmodel))
    with pytest.raises(ValueError, match="unknown ModelSpec override"):
        tloader.flux_from_pretrained(cfg_path, ckpt=ckpt)
    with pytest.raises(ValueError, match="not a supported flow tier"):
        tloader.flux_from_pretrained(cfg_path, flow_quantization_dtype="qint2")


@pytest.mark.parametrize("config", ["tiny fp8", "configs/config-tiny-cpu.json"])
def test_main_save_prequantized_writes_a_file_jax_loads(tmp_path, monkeypatch, config):
    """``main.py --save-prequantized`` calibrates when it must, saves and exits; the
    file loads in both packages to the same tree (config-tiny-cpu.json has a float
    flow: nothing to calibrate, float leaves saved)."""
    from flux_fp8_api_tpu.models.flux import FluxStatic as JaxStatic
    from flux_fp8_api_tpu.utils.config import load_config_from_path
    from flux_fp8_api_tpu_torch import main as tmain
    from flux_fp8_api_tpu_torch.pipeline import FluxPipeline
    from flux_fp8_api_tpu_torch.utils.config import load_config_from_path as port_config

    def small_compile(self):
        """compile()'s calibration loop at 64x64 instead of its 768x768 recipe."""
        while self._needs_calibration:
            self.generate("calibrate", 64, 64, 2, seed=0, silent=True)

    monkeypatch.setattr(FluxPipeline, "compile", small_compile)
    quantized = config == "tiny fp8"
    if quantized:
        config = _write_config(tmp_path / "config.json", flow_quantization_dtype="qfloat8", num_scale_trials=1)
    out = tmp_path / "prequant.safetensors"
    tmain.main(["--config-path", config, "--save-prequantized", str(out)])
    f = tst.SafetensorsFile(out)
    assert f.metadata["format"] == tckpt.PREQUANT_FORMAT and f.metadata["quantize_modulation"] == "True"
    spec = load_config_from_path(config)
    jtree = jckpt.load_prequantized(str(out), JaxStatic.from_params(spec.params, compute_dtype=spec.flow_dtype))
    port_spec = port_config(config)
    port_spec.ckpt_path = str(out)
    model, _, prequant = tloader.load_flow_model(port_spec)
    assert prequant is True
    assert_same_model(model, to_torch(jtree))
    qkv = model["double_blocks"][0]["img_attn_qkv"]
    assert qkv.kind == ("fp8" if quantized else "float")
    if quantized:
        assert float(qkv.in_scale) != 1.0  # calibrated before saving


def test_pipeline_served_from_a_checkpoint_matches_jax(tmp_path):
    """A tiny config with ckpt_path and ae_path: the pipeline's denoise against JAX's
    on the same file from the same noise (two steps), and a request served."""
    from flux_fp8_api_tpu import sampling as jsampling
    from flux_fp8_api_tpu.ops import packing as jpacking
    from flux_fp8_api_tpu.ops.schedule import get_schedule
    from flux_fp8_api_tpu_torch import sampling as tsampling
    from flux_fp8_api_tpu_torch.pipeline import FluxPipeline

    from .torch_parity import numpy_ae_params

    ckpt, ae = str(tmp_path / "flux.safetensors"), tmp_path / "ae.sft"
    _synthetic_bfl_checkpoint(ckpt)
    ae_tree = to_torch(numpy_ae_params(TINY_AE_PARAMS, seed=2))
    tst.save_safetensors(ae, dict(ae_tree.named_buffers()))
    spec = tiny_spec(ckpt_path=ckpt, ae_path=str(ae), flow_quantization_dtype=None, flow_dtype="float32",
                     ae_dtype="float32")
    pipe = FluxPipeline.load_pipeline_from_config(spec)
    assert_same_model(pipe.ae_params, ae_tree)
    jparams, _, _ = jloader.load_flow_model(tiny_spec(ckpt_path=ckpt, flow_quantization_dtype=None,
                                                      flow_dtype="float32", use_pallas=True))
    r = np.random.default_rng(0)
    noise = r.normal(size=(1, 4, 8, 8)).astype(np.float32)
    img = np.asarray(jpacking.pack_latents(jnp.asarray(noise)))
    ids, txt_ids = np.asarray(jpacking.make_img_ids(8, 8, 1)), np.asarray(jpacking.make_txt_ids(6, 1))
    txt = r.normal(size=(1, 6, 48)).astype(np.float32)
    vec = r.normal(size=(1, 32)).astype(np.float32)
    steps = get_schedule(2, img.shape[1], shift=True)
    a = jsampling.denoise(jparams, jcfg(), *(jnp.asarray(v) for v in (img, ids, txt, txt_ids, vec)), steps, 3.5,
                          fused=False)
    b = tsampling.denoise(pipe.model_params, pipe.model_cfg, *(t(v) for v in (img, ids, txt, txt_ids, vec)), steps,
                          3.5, fused=True)
    a, b = np.asarray(a), b.numpy()
    assert _rel(b, a) < 1e-4
    np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-3)
    jpeg = pipe.generate("a red house", 64, 64, 2, seed=3)
    assert jpeg.getvalue()[:2] == b"\xff\xd8"
