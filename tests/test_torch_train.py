"""Training in the port against ``flux_fp8_api_tpu.parallel.train``, on the CPU: the rope
pass under autograd, the timestep densities, the flow-matching loss, the SGD and
optimizer steps, remat and the train state.

The model is tests/test_lora_train.py's (hidden 128, four heads of 32, 2 + 2 blocks)
in fp32 on both sides, its weights from numpy; JAX runs with ``use_pallas=False``, as
its training does. The two packages draw t and ε from different generators, so JAX's
draws are carried across.

Tolerances, each from what differs between the two sides: the rope pass's backward is
autograd's through the plain version bit for bit (the same products and sums) and
JAX's gradient of ``apply_rope`` to 1e-6 (one fp32 rounding per product and sum;
fp32 in, fp32 out). The loss agrees to 1e-5 relative (fp32 summation order in the
forward). One SGD step at lr 1e-4 moves the params by 1e-4·g, so params agree to
atol 1e-6 (JAX's own test of remat holds them to 1e-5). Remat on and off run the same
ops in the same order on the CPU: bit for bit. AdamW is optax's arithmetic in the same
order: fed the same gradients, the params agree to a few fp32 ulps after three steps
of ≈ 1e-3; the whole step's bounds are in its test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flux_fp8_api_tpu.models import flux as jflux
from flux_fp8_api_tpu.ops.packing import make_img_ids, make_txt_ids
from flux_fp8_api_tpu.ops.rope import apply_rope as jax_apply_rope
from flux_fp8_api_tpu.ops.schedule import get_lin_function, time_shift
from flux_fp8_api_tpu.parallel import train as jtrain
from flux_fp8_api_tpu_torch.models import flux as tflux
from flux_fp8_api_tpu_torch.ops import attention_kernel as tak
from flux_fp8_api_tpu_torch.ops.attention import attention_core
from flux_fp8_api_tpu_torch.parallel import train as ttrain

from .test_lora_train import PARAMS
from .test_torch_rope_pass import SHAPES, _rope_case
from .torch_parity import numpy_flux_params, t, to_torch

torch.set_num_threads(1)


def jax_cfg(**kw):
    cfg = jflux.FluxStatic.from_params(PARAMS, compute_dtype="float32", use_pallas=False)
    return dataclasses.replace(cfg, **kw) if kw else cfg


def port_cfg(**kw):
    cfg = tflux.FluxStatic.from_params(PARAMS, compute_dtype="float32", use_pallas=False)
    return dataclasses.replace(cfg, **kw) if kw else cfg


@pytest.fixture(scope="module")
def jax_params():
    return numpy_flux_params(jax_cfg(), seed=3)


def numpy_batch(batch=2, h_latent=8, w_latent=8, txt_len=16, seed=2):
    r = np.random.default_rng(seed)
    seq = (h_latent // 2) * (w_latent // 2)
    return {
        "latents": r.normal(size=(batch, seq, PARAMS.in_channels)).astype(np.float32),
        "txt": r.normal(size=(batch, txt_len, PARAMS.context_in_dim)).astype(np.float32),
        "y": r.normal(size=(batch, PARAMS.vec_in_dim)).astype(np.float32),
        "img_ids": np.asarray(make_img_ids(h_latent, w_latent, batch)),
        "txt_ids": np.asarray(make_txt_ids(txt_len, batch)),
    }


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def port_batch(b):
    return {k: t(v) for k, v in b.items()}


def jax_draws(key, x0_shape, t_sampling="uniform"):
    """The t and ε that JAX's flow_matching_loss draws from ``key``."""
    k_t, k_eps = jax.random.split(key)
    tt = jtrain.sample_timesteps(k_t, x0_shape[0], x0_shape[1], t_sampling)
    eps = jax.random.normal(k_eps, x0_shape, jnp.float32)
    return t(np.asarray(tt)), t(np.asarray(eps))


# --------------------------------------------------------------------- the rope pass


@pytest.mark.parametrize("h,lq,lkv,d", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_function_backward_is_autograd_of_the_plain_version(h, lq, lkv, d, dtype):
    """The Function's grads of q and k equal autograd's through rope_rotate_ref bit for
    bit (±0 equal), q with its own tables; the tables get none; nothing is launched."""
    q, k, _, tb = _rope_case(h, lq, lkv, d, dtype)
    r = np.random.default_rng(d + lq)
    gq, gk = t(r.normal(size=q.shape), dtype), t(r.normal(size=k.shape), dtype)
    before = dict(tak.LAUNCHES)

    qa, ka = q.clone().requires_grad_(), k.clone().requires_grad_()
    oq, ok = tak.rope_rotate(qa, ka, **tb)
    torch.autograd.backward([oq, ok], [gq, gk])

    qb, kb = q.clone().requires_grad_(), k.clone().requires_grad_()
    rq = tak.rope_rotate_ref(qb, tb["cos_q"], tb["sin_q"])
    rk = tak.rope_rotate_ref(kb, tb["cos"], tb["sin"])
    torch.autograd.backward([rq, rk], [gq, gk])

    assert torch.equal(oq, rq) and torch.equal(ok, rk)
    assert torch.equal(qa.grad, qb.grad) and torch.equal(ka.grad, kb.grad)
    dq, dk = tak.rope_rotate_backward(gq, gk, **tb)
    assert torch.equal(dq, qb.grad) and torch.equal(dk, kb.grad)
    assert tak.LAUNCHES == before


def test_rope_function_gradcheck_fp64():
    q, k, _, tb = _rope_case(2, 8, 12, 16, torch.float64)
    tb = {n: v.double() for n, v in tb.items()}
    assert torch.autograd.gradcheck(
        lambda a, b: tak.rope_rotate(a, b, **tb), (q.requires_grad_(), k.requires_grad_()))


def test_rope_function_matches_jax_grad_of_apply_rope():
    """d(Σ w·rope(x))/dx through the port's Function against jax.grad of the JAX
    package's XLA ``apply_rope`` (what JAX training differentiates), fp32, 1e-6."""
    q, k, _, tb = _rope_case(3, 40, 40, 32)
    r = np.random.default_rng(9)
    wq, wk = r.normal(size=q.shape).astype(np.float32), r.normal(size=k.shape).astype(np.float32)
    cos, sin = tb["cos"].numpy(), tb["sin"].numpy()

    def f(xq, xk):
        oq, ok = jax_apply_rope(xq, xk, cos, sin)
        return jnp.sum(oq * wq) + jnp.sum(ok * wk)

    jq, jk = jax.grad(f, argnums=(0, 1))(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()))
    qa, ka = q.clone().requires_grad_(), k.clone().requires_grad_()
    oq, ok = tak.rope_rotate(qa, ka, tb["cos"], tb["sin"])
    ((oq * t(wq)).sum() + (ok * t(wk)).sum()).backward()
    np.testing.assert_allclose(qa.grad.numpy(), np.asarray(jq), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ka.grad.numpy(), np.asarray(jk), rtol=0, atol=1e-6)


def test_attention_without_pallas_is_differentiable_and_k1_refuses_a_gradient():
    """attention_core(use_pallas=False) carries gradients to q, k and v through the
    fold's strided views; the max-free kernel raises under a gradient, naming the path
    to train with, and runs as before without one."""
    r = np.random.default_rng(4)
    q, k, v = (t(r.normal(size=(1, 24, 4, 32))).requires_grad_() for _ in range(3))
    tables = np.random.default_rng(5).uniform(-1, 1, size=(2, 24, 32)).astype(np.float32)
    cos, sin = t(tables[0]), t(tables[1])
    out = attention_core(q, k, v, cos, sin, use_pallas=False)
    out.square().sum().backward()
    assert all(x.grad is not None and torch.isfinite(x.grad).all() for x in (q, k, v))
    with pytest.raises(RuntimeError, match="use_pallas=False"):
        attention_core(q, k, v, cos, sin, use_pallas=True)
    with torch.no_grad():
        attention_core(q, k, v, cos, sin, use_pallas=True)


# ------------------------------------------------------------------- the objective


def test_sample_timesteps_against_the_schedules_warp():
    """logit-normal: time_shift(mu(seq), 1, σ(u)) of the generator's own normal draws
    (JAX's warp function, rtol 2e-5 as JAX's own test), pushed above the raw draw;
    uniform in [0, 1); an unknown density raises."""
    seq = 1024
    got = ttrain.sample_timesteps(torch.Generator().manual_seed(3), 4096, seq, "logit_normal")
    raw = torch.sigmoid(torch.randn((4096,), generator=torch.Generator().manual_seed(3))).numpy()
    np.testing.assert_allclose(got.numpy(), time_shift(get_lin_function()(seq), 1.0, raw), rtol=2e-5)
    assert got.dtype == torch.float32 and 0.0 < got.min() and got.max() < 1.0
    assert got.mean() > raw.mean()
    u = ttrain.sample_timesteps(torch.Generator().manual_seed(0), 512, 256, "uniform")
    assert torch.equal(u, torch.rand((512,), generator=torch.Generator().manual_seed(0)))
    assert 0.0 <= u.min() and u.max() < 1.0 and 0.3 < u.mean() < 0.7
    with pytest.raises(ValueError):
        ttrain.sample_timesteps(torch.Generator(), 4, 256, "nope")


def test_flow_matching_loss_matches_jax_with_its_draws(jax_params):
    b = numpy_batch()
    key = jax.random.PRNGKey(7)
    want = float(jax.jit(lambda p, bb, k: jtrain.flow_matching_loss(p, jax_cfg(), bb, k))(
        jax_params, jax_batch(b), key))
    tt, eps = jax_draws(key, b["latents"].shape)
    got = ttrain.flow_matching_loss(to_torch(jax_params), port_cfg(), port_batch(b), t=tt, noise=eps)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-5 * abs(want)


def test_flow_matching_loss_draws_t_then_noise_from_the_generator(jax_params):
    model, b = to_torch(jax_params), port_batch(numpy_batch())
    gen = torch.Generator().manual_seed(5)
    drawn = ttrain.flow_matching_loss(model, port_cfg(), b, gen, "logit_normal")
    gen = torch.Generator().manual_seed(5)
    tt = ttrain.sample_timesteps(gen, 2, b["latents"].shape[1], "logit_normal")
    eps = torch.randn(b["latents"].shape, generator=gen)
    assert torch.equal(drawn, ttrain.flow_matching_loss(model, port_cfg(), b, t=tt, noise=eps))


# ---------------------------------------------------------------------- the steps


def test_sgd_step_matches_jax_and_remat_changes_nothing(jax_params):
    """One SGD step (lr 1e-4) against JAX's make_train_step with its draws: loss 1e-5
    relative, params atol 1e-6. Remat on equals remat off bit for bit (loss and every
    updated tensor), and the step runs no max-free kernel."""
    b = numpy_batch()
    key = jax.random.PRNGKey(3)
    jp = jax.tree.map(jnp.copy, jax_params)
    new_jax, loss_jax = jtrain.make_train_step(jax_cfg(), remat=True)(jp, jax_batch(b), key)
    tt, eps = jax_draws(key, b["latents"].shape)

    runs = {}
    for remat in (True, False):
        model = to_torch(jax_params)
        model_cfg = port_cfg(use_pallas=True)  # the step must switch the kernel off itself
        model, loss = ttrain.make_train_step(model_cfg, remat=remat)(model, port_batch(b), t=tt, noise=eps)
        runs[remat] = (loss, model)
    (loss_on, on), (loss_off, off) = runs[True], runs[False]
    assert torch.equal(loss_on, loss_off)
    for (name, x), (_, y) in zip(on.named_buffers(), off.named_buffers()):
        assert torch.equal(x, y), name
    assert abs(float(loss_on) - float(loss_jax)) <= 1e-5 * abs(float(loss_jax))
    want = to_torch(new_jax)
    moved = 0
    for (name, x), (_, y), (_, x0) in zip(on.named_buffers(), want.named_buffers(),
                                           to_torch(jax_params).named_buffers()):
        np.testing.assert_allclose(x.detach().numpy(), y.numpy(), rtol=0, atol=1e-6, err_msg=name)
        moved += int(not torch.equal(x, x0))
    assert moved > 0


def test_adamw_with_clip_is_optaxs_arithmetic(jax_params):
    """optimizer_update(adamw(1e-3), max_grad_norm=1.0) fed JAX's own gradients of three
    steps against optax.chain(clip_by_global_norm(1.0), adamw(1e-3)) on JAX's params:
    the gradient norm is above 1 at every step, so the clip acts; params to rtol 5e-7
    and atol 1e-8 (the same arithmetic rounded in another order: a few fp32 ulps of the
    param, on steps of ≈ 1e-3)."""
    b = jax_batch(numpy_batch())
    jopt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3))
    jp = jax.tree.map(jnp.copy, jax_params)
    jstate = jopt.init(jp)
    model = to_torch(jax_params)
    tensors = ttrain.trainable_tensors(model)
    opt = ttrain.adamw(1e-3)(tensors)
    grad_fn = jax.jit(jax.grad(lambda p, key: jtrain.flow_matching_loss(p, jax_cfg(), b, key)))

    @jax.jit
    def update(grads, state, params):
        updates, state = jopt.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    norm = jax.jit(optax.global_norm)
    for i in range(3):
        grads = grad_fn(jp, jax.random.PRNGKey(20 + i))
        assert float(norm(grads)) > 1.0
        jp, jstate = update(grads, jstate, jp)
        by_name = dict(to_torch(grads).named_buffers())
        names = [n for n, x in model.named_buffers() if any(x is y for y in tensors)]
        ttrain.optimizer_update(opt, tensors, [by_name[n] for n in names], max_grad_norm=1.0)
    for (name, x), (_, y) in zip(model.named_buffers(), to_torch(jp).named_buffers()):
        np.testing.assert_allclose(x.detach().numpy(), y.numpy(), rtol=5e-7, atol=1e-8, err_msg=name)


def test_adamw_step_matches_optax_step_over_three_steps(jax_params):
    """make_optimizer_train_step(adamw(1e-3), max_grad_norm=1.0) against JAX's
    make_optax_train_step(optax.chain(clip_by_global_norm(1.0), adamw(1e-3))), JAX's
    draws carried each step: losses 1e-5 relative. Params: Adam divides each gradient
    element by its own running RMS, so an element whose gradient is at the level of the
    two sides' fp32 summation noise can step differently by up to lr; such elements
    stay under 0.1% of the tree and every element within lr (1e-3) of JAX's, the rest
    within 1e-6."""
    b = numpy_batch()
    jinit, jstep = jtrain.make_optax_train_step(
        jax_cfg(), optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3)))
    jp = jax.tree.map(jnp.copy, jax_params)
    jstate = jinit(jp)
    tinit, tstep = ttrain.make_optimizer_train_step(port_cfg(), ttrain.adamw(1e-3), max_grad_norm=1.0)
    model = to_torch(jax_params)
    opt = tinit(model)
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        tt, eps = jax_draws(key, b["latents"].shape)
        jp, jstate, jloss = jstep(jp, jstate, jax_batch(b), key)
        model, opt, loss = tstep(model, opt, port_batch(b), t=tt, noise=eps)
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss)), i
    off = total = 0
    for (name, x), (_, y) in zip(model.named_buffers(), to_torch(jp).named_buffers()):
        d = (x.detach() - y).abs()
        assert float(d.max()) <= 1e-3, name
        off += int((d > 1e-6).sum())
        total += d.numel()
    assert off <= 1e-3 * total, (off, total)


def test_clip_by_global_norm_is_optaxs():
    r = np.random.default_rng(0)
    for scale in (0.01, 10.0):  # under and over the bound
        gs = [r.normal(size=s).astype(np.float32) * scale for s in ((3, 4), (5,))]
        want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in gs], None)
        got = ttrain.clip_by_global_norm([t(g) for g in gs], 1.0)
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def test_adamw_factory_has_optaxs_defaults():
    opt = ttrain.adamw(1e-3)([torch.zeros(2, requires_grad=True)])
    group = opt.param_groups[0]
    assert isinstance(opt, ttrain.OptaxAdamW)
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (1e-3, (0.9, 0.999), 1e-8, 1e-4)


def test_make_dummy_batch_shapes_and_device():
    cfg = port_cfg(compute_dtype="bfloat16")
    b = ttrain.make_dummy_batch(cfg, 2, 8, 6, 5, torch.Generator().manual_seed(0))
    assert b["latents"].shape == (2, 12, PARAMS.in_channels) and b["latents"].dtype == torch.bfloat16
    assert b["txt"].shape == (2, 5, PARAMS.context_in_dim) and b["y"].shape == (2, PARAMS.vec_in_dim)
    assert b["img_ids"].shape == (2, 12, 3) and b["txt_ids"].shape == (2, 5, 3)


# --------------------------------------------------------------------- train state


def test_train_state_round_trip_resumes_the_same_steps(tmp_path, jax_params):
    """save_train_state then restore into fresh templates: the next step equals the
    one the saved run takes, bit for bit. One file, written atomically; a second save
    without overwrite raises."""
    b = port_batch(numpy_batch(batch=1))
    init, step = ttrain.make_optimizer_train_step(port_cfg(), ttrain.adamw(1e-3), max_grad_norm=1.0)
    model = to_torch(jax_params)
    opt = init(model)
    model, opt, _ = step(model, opt, b, torch.Generator().manual_seed(1))
    ttrain.save_train_state(tmp_path / "state", model, opt, step=1)
    assert sorted(p.name for p in (tmp_path / "state").iterdir()) == [ttrain.STATE_FILE]
    with pytest.raises(FileExistsError):
        ttrain.save_train_state(tmp_path / "state", model, opt, step=1)

    fresh = to_torch(jax_params)
    fresh, opt2, n = ttrain.restore_train_state(tmp_path / "state", fresh, init(fresh))
    assert n == 1
    for (name, x), (_, y) in zip(fresh.named_buffers(), model.named_buffers()):
        assert torch.equal(x, y), name
    _, _, loss_a = step(model, opt, b, torch.Generator().manual_seed(2))
    _, _, loss_b = step(fresh, opt2, b, torch.Generator().manual_seed(2))
    assert torch.equal(loss_a, loss_b)
    for (name, x), (_, y) in zip(fresh.named_buffers(), model.named_buffers()):
        assert torch.equal(x, y), name
