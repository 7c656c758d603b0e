"""QLoRA adapter training in the port against ``flux_fp8_api_tpu.lora`` (its trainable
adapters) and ``parallel.train.make_lora_train_step``, on the CPU.

The model is tests/test_lora_train.py's (hidden 128, four heads of 32, 2 + 2 blocks)
in fp32, its weights from numpy, quantized on the JAX side and carried across byte for
byte. JAX's adapters and its t and ε draws are carried across as well.

Tolerances: the loss agrees to 1e-5 relative and the adapter gradients to 1e-4
relative in norm per tensor (fp32 summation order through the forward and the
backward; fp8/int8/int4 dequantize exactly into fp32 on both sides). After three SGD
steps the adapters agree to 1e-6; after three AdamW steps to lr (see the step's test
for why). The JAX adapter tests are mirrored at
their own bounds: the merged model at init is the base bit for bit; the dequantize
forward tracks the float one within 0.05 (int8 weight rounding); export, fuse and
forward agree with the merged forward to atol 2e-5, rtol 1e-4 on a float base and
within 0.05 on a calibrated int8 base (requantization). The exported state dict
equals JAX's array for array, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flux_fp8_api_tpu import lora as jlora
from flux_fp8_api_tpu.models import flux as jflux
from flux_fp8_api_tpu.parallel import train as jtrain
from flux_fp8_api_tpu_torch import lora as tlora
from flux_fp8_api_tpu_torch.calibration import apply_input_scales
from flux_fp8_api_tpu_torch.models import flux as tflux
from flux_fp8_api_tpu_torch.ops.attention_kernel import LAUNCHES
from flux_fp8_api_tpu_torch.parallel import train as ttrain
from flux_fp8_api_tpu_torch.pipeline import FluxPipeline
from flux_fp8_api_tpu_torch.utils.convert import convert_adapters

from .helpers import TINY_AE_PARAMS, TINY_FLUX_PARAMS, tiny_spec
from .test_lora import make_kohya_lora
from .test_lora_train import PARAMS
from .test_torch_lora import torch_sd
from .test_torch_train import jax_batch, jax_cfg, jax_draws, numpy_batch, port_batch, port_cfg
from .torch_parity import flatten, numpy_ae_params, numpy_flux_params, to_torch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_params():
    return numpy_flux_params(jax_cfg(), seed=3)


def jax_base(params, kind):
    return params if kind == "float" else jflux.quantize_flux_tree(params, kind=kind)


def random_jax_adapters(params, rank=4, seed=7, scale=0.02):
    """JAX adapters with every A and B drawn N(0, scale²), so gradients reach both."""
    ad = jlora.init_lora_adapters(params, rank=rank, key=jax.random.PRNGKey(1), dtype=jnp.float32)
    leaves, tree = jax.tree.flatten(ad)
    r = np.random.default_rng(seed)
    return jax.tree.unflatten(tree, [jnp.asarray(r.normal(size=x.shape).astype(np.float32) * scale) for x in leaves])


def forward(model, cfg, b):
    n = b["latents"].shape[0]
    return tflux.flux_apply(model, cfg, b["latents"], b["img_ids"], b["txt"], b["txt_ids"],
                            torch.full((n,), 0.5), b["y"], torch.full((n,), 1.0))


def base_bytes(model):
    return {n: x.clone() for n, x in model.named_buffers()}


def assert_same_bytes(model, before):
    now = dict(model.named_buffers())
    assert sorted(now) == sorted(before)
    for n, x in before.items():
        assert torch.equal(now[n].view(torch.uint8) if now[n].element_size() == 1 else now[n],
                           x.view(torch.uint8) if x.element_size() == 1 else x), n


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------------ the adapters


def test_init_is_identity_and_sized_from_true_in_widths(jax_params):
    """B = 0 at init, so the merged model is the base bit for bit; on an int4 base (in/2
    bytes per row) A is (r, in); the served tree is left without adapters."""
    cfg = port_cfg()
    base = to_torch(jflux.quantize_flux_tree(jax_params, kind="int4"))
    adapters = tlora.init_lora_adapters(base, 4, torch.Generator().manual_seed(1), dtype=torch.float32)
    a = adapters["double_blocks"][0]["img_attn_qkv"]["a"]
    b = adapters["single_blocks"][1]["linear1"]["b"]
    assert a.shape == (4, PARAMS.hidden_size) and a.requires_grad
    assert b.shape == (3 * PARAMS.hidden_size + 4 * PARAMS.hidden_size, 4) and not b.any()
    assert sorted(adapters["double_blocks"][0]) == sorted(tlora.DEFAULT_ADAPTER_TARGETS["double_blocks"])
    assert len(adapters["single_blocks"]) == PARAMS.depth_single_blocks

    model = to_torch(jax_params)
    adapters = tlora.init_lora_adapters(model, 4, torch.Generator().manual_seed(1), dtype=torch.float32)
    merged = tlora.merge_lora_adapters(model, adapters)
    bb = port_batch(numpy_batch(batch=1))
    with torch.no_grad():
        assert torch.equal(forward(merged, cfg, bb), forward(model, cfg, bb))
    lin = merged["double_blocks"][0]["img_attn_qkv"]
    served = model["double_blocks"][0]["img_attn_qkv"]
    assert lin.lora_a is adapters["double_blocks"][0]["img_attn_qkv"]["a"] and lin.weight is served.weight
    assert served.lora_a is None and served.lora_b is None
    assert merged["double_blocks"][0]["img_mod_lin"] is model["double_blocks"][0]["img_mod_lin"]


def test_dequant_forward_tracks_the_float_base(jax_params):
    cfg = port_cfg()
    bb = port_batch(numpy_batch(batch=1))
    with torch.no_grad():
        full = forward(to_torch(jax_params), cfg, bb)
        training = forward(to_torch(jflux.quantize_flux_tree(jax_params, kind="int8")),
                           dataclasses.replace(cfg, dequant_linears=True), bb)
    assert float((full - training).abs().max() / full.abs().max()) < 0.05


def test_adapters_convert_from_jax_byte_for_byte(jax_params):
    ad = random_jax_adapters(jax_params)
    got = convert_adapters(flatten(ad))
    for stack, leaves in ad.items():
        for name, ab in leaves.items():
            for i in range(ab["a"].shape[0]):
                np.testing.assert_array_equal(got[stack][i][name]["a"].detach().numpy(), np.asarray(ab["a"][i]).T)
                np.testing.assert_array_equal(got[stack][i][name]["b"].detach().numpy(), np.asarray(ab["b"][i]).T)


# ---------------------------------------------------------------- the train step


OPTIMIZERS = {
    # (JAX optimizer, the port's factory, max_grad_norm)
    "sgd": (lambda: optax.sgd(1e-2), lambda ps: torch.optim.SGD(ps, lr=1e-2), None),
    "adamw_clip": (lambda: optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3)),
                   lambda ps: ttrain.adamw(1e-3)(ps), 1.0),
}


@pytest.mark.parametrize("kind,optimizer", [
    ("float", "sgd"), ("int8", "sgd"), ("fp8", "sgd"), ("int4", "sgd"), ("int8", "adamw_clip"),
])
def test_lora_step_matches_jax(jax_params, kind, optimizer):
    """make_lora_train_step against JAX's, from JAX's adapters with its draws, three
    steps: the loss and adapter gradients of each step, and the base's bytes, which
    never change; the max-free kernel never runs. With SGD (lr 1e-2) the adapters
    after the steps agree to atol 1e-6. With train_lora's AdamW and clip, Adam divides
    each gradient element by its own running RMS, so an element whose gradient sits at
    the two sides' summation noise can step differently by up to lr: the adapters are
    held to lr, and the losses of the steps to 1e-5 (the optimizer's arithmetic is
    held to a few ulps in test_torch_train.py)."""
    jopt, factory, clip = OPTIMIZERS[optimizer]
    jb = jax_base(jax_params, kind)
    jad = random_jax_adapters(jb)
    b = numpy_batch(batch=1)
    jinit, jstep = jtrain.make_lora_train_step(jax_cfg(), jopt())
    lcfg = jax_cfg(dequant_linears=True, remat=True)

    @jax.jit
    def jax_step(ad, state, key):  # the step, and the gradients it takes
        grads = jax.grad(lambda a: jtrain.flow_matching_loss(
            jlora.merge_lora_adapters(jb, a), lcfg, jax_batch(b), key))(ad)
        return grads, jstep(ad, state, jb, jax_batch(b), key)

    base = to_torch(jb)
    before = base_bytes(base)
    adapters = convert_adapters(flatten(jad))
    init, step = ttrain.make_lora_train_step(port_cfg(use_pallas=True), factory, max_grad_norm=clip)
    opt, jstate = init(adapters), jinit(jad)
    tcfg = ttrain.train_cfg(port_cfg(), remat=True, dequant=True)
    LAUNCHES.update({k: 0 for k in LAUNCHES})
    for i in range(3):
        key = jax.random.PRNGKey(30 + i)
        tt, eps = jax_draws(key, b["latents"].shape)
        jg, (jad, jstate, jloss) = jax_step(jad, jstate, key)
        loss = ttrain.flow_matching_loss(tlora.merge_lora_adapters(base, adapters), tcfg, port_batch(b), t=tt, noise=eps)
        grads = torch.autograd.grad(loss, tlora.adapter_tensors(adapters))
        for g, w in zip(grads, tlora.adapter_tensors(convert_adapters(flatten(jg)))):
            assert rel(g.numpy(), w.detach().numpy()) < 1e-4, i
        adapters, opt, loss = step(adapters, opt, base, port_batch(b), t=tt, noise=eps)
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss)), i
    atol = 1e-6 if optimizer == "sgd" else 1e-3
    for x, y in zip(tlora.adapter_tensors(adapters), tlora.adapter_tensors(convert_adapters(flatten(jad)))):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=0, atol=atol)
    assert_same_bytes(base, before)
    assert not any(LAUNCHES.values())  # CPU tensors: plain versions only


def test_loss_decreases_on_a_frozen_int8_base(jax_params):
    """JAX's own check: five AdamW steps on one batch and one draw lower the loss; B
    leaves zero in both stacks; the base is untouched and carries no adapter."""
    base = to_torch(jflux.quantize_flux_tree(jax_params, kind="int8"))
    before = base_bytes(base)
    adapters = tlora.init_lora_adapters(base, 4, torch.Generator().manual_seed(1), dtype=torch.float32)
    init, step = ttrain.make_lora_train_step(port_cfg(), ttrain.adamw(1e-3))
    opt = init(adapters)
    b = port_batch(numpy_batch())
    losses = []
    for _ in range(5):
        adapters, opt, loss = step(adapters, opt, base, b, torch.Generator().manual_seed(10))
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    assert adapters["double_blocks"][0]["img_attn_qkv"]["b"].abs().max() > 0
    assert adapters["single_blocks"][1]["linear2"]["b"].abs().max() > 0
    assert_same_bytes(base, before)
    assert base["double_blocks"][0]["img_attn_qkv"].lora_a is None


# ---------------------------------------------------------------------- the export


def test_export_equals_jax_export_array_for_array(jax_params):
    jad = random_jax_adapters(jax_params)
    want = jlora.export_lora_adapters(jad, jax_cfg())
    got = tlora.export_lora_adapters(convert_adapters(flatten(jad)), port_cfg())
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == np.float32 and g.shape == np.shape(w), k
        assert g.tobytes() == np.asarray(w, np.float32).tobytes(), k


def test_export_fuse_equals_merged(jax_params):
    """load(export(adapters)) is the merged model: the inverse rope permutations of the
    qkv and linear1 rows undo fuse_lora's."""
    cfg = port_cfg()
    model = to_torch(jax_params)
    adapters = convert_adapters(flatten(random_jax_adapters(jax_params)))
    bb = port_batch(numpy_batch(batch=1))
    with torch.no_grad():
        merged = forward(tlora.merge_lora_adapters(model, adapters), cfg, bb)
        keys, bfl = tlora.resolve_lora_state_dict(tlora.export_lora_adapters(adapters, cfg))
        fused = forward(tlora.fuse_lora(model, cfg, bfl, keys, 1.0), cfg, bb)
    np.testing.assert_allclose(fused.numpy(), merged.numpy(), atol=2e-5, rtol=1e-4)


def test_exported_file_loads_from_disk(tmp_path, jax_params):
    cfg = port_cfg()
    model = to_torch(jax_params)
    adapters = convert_adapters(flatten(random_jax_adapters(jax_params)))
    path = tmp_path / "trained_lora.safetensors"
    tlora.save_lora_adapters(str(path), adapters, cfg)
    bb = port_batch(numpy_batch(batch=1))
    with torch.no_grad():
        merged = forward(tlora.merge_lora_adapters(model, adapters), cfg, bb)
        fused, registry = tlora.pipeline_load_lora(model, cfg, [], str(path), 1.0)
        out = forward(fused, cfg, bb)
    assert len(registry) == 1
    np.testing.assert_allclose(out.numpy(), merged.numpy(), atol=2e-5, rtol=1e-4)


def test_export_into_a_calibrated_int8_base(jax_params):
    cfg = port_cfg()
    base = to_torch(jflux.quantize_flux_tree(jax_params, kind="int8"))
    bb = port_batch(numpy_batch(batch=1))
    with torch.no_grad():
        n = 1
        _, amaxes = tflux.flux_apply(base, cfg, bb["latents"], bb["img_ids"], bb["txt"], bb["txt_ids"],
                                     torch.full((n,), 0.5), bb["y"], torch.full((n,), 1.0), collect_amax=True)
        apply_input_scales(base, amaxes)
        adapters = convert_adapters(flatten(random_jax_adapters(jax_params)))
        merged = forward(tlora.merge_lora_adapters(base, adapters), cfg, bb)
        keys, bfl = tlora.resolve_lora_state_dict(tlora.export_lora_adapters(adapters, cfg))
        fused = forward(tlora.fuse_lora(base, cfg, bfl, keys, 1.0), cfg, bb)
    assert float((fused - merged).abs().max() / merged.abs().max()) < 0.05


def test_grouped_layout_export_equals_jax_export(jax_params):
    """The grouped (tensor-parallel) layout's export, which used to raise: its rows
    and linear2's columns go back through the inverse head-major regroup, array for
    array JAX's (JAX lora.py:592-620)."""
    jad = random_jax_adapters(jax_params)
    want = jlora.export_lora_adapters(jad, jax_cfg(fused_layout="grouped"))
    got = tlora.export_lora_adapters(convert_adapters(flatten(jad)), port_cfg(fused_layout="grouped"))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].numpy().tobytes() == np.asarray(w, np.float32).tobytes(), k


# ------------------------------------------------------- training a served pipeline


@pytest.mark.parametrize("flow", ["float", "fp8"])
def test_training_after_a_generate_and_a_lora_load(flow):
    """A pipeline that has served (calibration froze its input scales under inference
    mode) and fused a LoRA (new Linears made under inference mode) trains all the same:
    finite losses, the adapters move, the served tree's bytes stay as they were."""
    cfg = jflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32", use_pallas=True)
    params = numpy_flux_params(cfg, seed=2)
    if flow == "fp8":
        params = jflux.quantize_flux_tree(params)
    spec = tiny_spec(num_scale_trials=2, flow_dtype="float32", ae_dtype="float32")
    pipe = FluxPipeline("flux-dev", model=to_torch(params),
                        model_cfg=tflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32"),
                        ae=to_torch(numpy_ae_params(TINY_AE_PARAMS)), config=spec)
    r = np.random.default_rng(6)
    vec = torch.from_numpy(r.normal(size=(1, TINY_FLUX_PARAMS.vec_in_dim)).astype(np.float32))
    txt = torch.from_numpy(r.normal(size=(1, 6, TINY_FLUX_PARAMS.context_in_dim)).astype(np.float32))
    pipe._encode_prompts = lambda prompts: {p: (vec, txt) for p in prompts}
    pipe.generate("a cat", 64, 64, 3, seed=4, silent=True)
    pipe.load_lora(torch_sd(make_kohya_lora()), 1.0, name="k")
    touched = pipe.model_params["double_blocks"][0]["img_attn_proj"]
    assert (touched.weight if flow == "float" else touched.q).is_inference()

    base = pipe.model_params
    before = base_bytes(base)
    adapters = tlora.init_lora_adapters(base, 2, torch.Generator().manual_seed(0), dtype=torch.float32)
    init, step = ttrain.make_lora_train_step(pipe.model_cfg, ttrain.adamw(1e-3))
    opt = init(adapters)
    batch = ttrain.make_dummy_batch(pipe.model_cfg, 1, 8, 8, 6, torch.Generator().manual_seed(3))
    for i in range(2):
        adapters, opt, loss = step(adapters, opt, base, batch, torch.Generator().manual_seed(i))
        assert torch.isfinite(loss)
    assert adapters["single_blocks"][0]["linear2"]["b"].abs().max() > 0
    assert_same_bytes(base, before)
    pipe.generate("a cat", 64, 64, 3, seed=4, silent=True)
    assert torch.isfinite(pipe.last_latents).all()
