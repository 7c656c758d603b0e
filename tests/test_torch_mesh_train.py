"""The sharded train steps (parallel/train.py on a (dp, tp) mesh) against the JAX
package's on its mesh, on the CPU: tests/test_parallel.py's sharded, remat and AdamW
train cases, ``::test_roundtrip_on_mesh`` and
tests/test_lora_train.py::test_lora_train_under_mesh.

JAX runs here on its 8-device virtual CPU mesh (its steps jitted over
``shard_flux_params``'s placements); the port's ranks run in worlds over gloo
(tests/torch_mesh_worker.py), started at once while JAX computes: dp 2 × tp 2, a world
of one, and tp 2 (a state restored from the dp 2 × tp 2 world's file).

Tolerances: fp32 compute. Gradients atol 1e-5, rtol 1e-4, and the loss rtol 1e-5
(JAX's bounds for its pp gradients); tensors after an SGD step atol 1e-6, rtol 1e-4;
after an AdamW step the first moments atol 1e-6, rtol 1e-4, and the tensors atol 1e-6,
rtol 1e-4 wherever |g| > 1e-5: the first AdamW update is g / (|g| + 1e-8)·lr, so an
element whose gradient is within the two packages' rounding of zero may move anywhere
in ±lr, which is all that is asked of the others (one element in 10^5 reads up to
1.2e-4 at lr 1e-3); adapters after a QLoRA step atol 1e-7, rtol 1e-3, and
its loss rtol 2e-4 (JAX's own case); the world of one against the mesh at the same
bounds; remat on and off, and a restored state, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flux_fp8_api_tpu import lora as jlora
from flux_fp8_api_tpu.models import flux as jflux
from flux_fp8_api_tpu.parallel import mesh as jmesh
from flux_fp8_api_tpu.parallel import train as jtrain
from flux_fp8_api_tpu.utils.config import FluxParams

from .torch_mesh_worker import start_worlds
from .torch_parity import flatten, numpy_flux_params, to_torch

torch.set_num_threads(1)

# tests/test_parallel.py's tiny flux: hidden 128, 4 heads, 2 + 2 blocks
PARAMS = FluxParams(
    in_channels=16, vec_in_dim=64, context_in_dim=96, hidden_size=128,
    mlp_ratio=4.0, num_heads=4, depth=2, depth_single_blocks=2,
    axes_dim=[8, 12, 12], theta=10_000, qkv_bias=True, guidance_embed=True,
)
MESH = {"dp": 2, "tp": 2}
SGD_LR, ADAMW_LR, LORA_LR = 1e-4, 1e-3, 1e-3
CLIP = 0.1  # below the gradients' global norm, so the clip scales them


def jcfg():
    return jflux.FluxStatic.from_params(PARAMS, compute_dtype="float32", use_pallas=False)


def batch(b=2):
    return {k: np.asarray(v) for k, v in jtrain.make_dummy_batch(jcfg(), b, 8, 8, 16, jax.random.PRNGKey(1)).items()}


def draws(key, shape):
    """The t and ε that JAX's flow_matching_loss draws from ``key``."""
    k_t, k_eps = jax.random.split(key)
    tt = jtrain.sample_timesteps(k_t, shape[0], shape[1], "uniform")
    return np.asarray(tt), np.asarray(jax.random.normal(k_eps, shape, jnp.float32))


KEY = 3


@pytest.fixture(scope="module")
def setup():
    params = numpy_flux_params(jcfg())
    base = jflux.quantize_flux_tree(params, kind="int8")
    adapters = jlora.init_lora_adapters(base, rank=4, key=jax.random.PRNGKey(1), dtype=jnp.float32)
    # a nonzero B, so that A's gradient is not zero at the step and both are checked
    adapters = jax.tree.map(lambda a: a + 0.01 * jnp.ones_like(a), adapters)
    return params, base, adapters


def adapter_flat(adapters):
    """JAX adapters → {"stack.i.leaf.a|b": numpy} in the port's (out, in) layout."""
    out = {}
    for stack, leaves in adapters.items():
        for leaf, ab in leaves.items():
            for i in range(np.asarray(ab["a"]).shape[0]):
                out[f"{stack}.{i}.{leaf}.a"] = np.asarray(ab["a"][i]).T.copy()
                out[f"{stack}.{i}.{leaf}.b"] = np.asarray(ab["b"][i]).T.copy()
    return out


def task(tree, kind, **kw):
    b = batch()
    tt, nn = draws(jax.random.PRNGKey(KEY), b["latents"].shape)
    return ("mesh_train", {"tree": flatten(tree), "flux_params": PARAMS.model_dump(), "dtype": "float32",
                           "use_pallas": False, "batch": b, "t": tt, "noise": nn, "kind": kind,
                           "lr": {"sgd": SGD_LR, "lora": LORA_LR}.get(kind, ADAMW_LR), **kw})


@pytest.fixture(scope="module")
def results(setup, tmp_path_factory):
    params, base, adapters = setup
    root = tmp_path_factory.mktemp("mesh_train")
    state = str(root / "state")
    flat = adapter_flat(adapters)
    jobs = {
        "dp2tp2": {"mesh": MESH, "tasks": [
            task(params, "sgd"), task(params, "sgd", remat=False), task(params, "adamw", save=state),
            task(base, "lora", adapters=flat), task(params, "adamw", steps=4), task(params, "adamw", clip=CLIP),
        ]},
        "fault": {"mesh": MESH, "tasks": [task(params, "sgd", plant="dist_nn")]},
        "one": {"mesh": {"dp": 1}, "tasks": [
            task(params, "sgd"), task(params, "adamw"), task(base, "lora", adapters=flat),
            task(params, "restore", restore=state),
        ]},
        "tp2": {"mesh": {"tp": 2}, "tasks": [task(params, "restore", restore=state)]},
    }
    wait = start_worlds(root, jobs, timeout=170)
    refs = jax_refs(params, base, adapters)
    return wait(), refs


def _port(tree):
    """{port name: numpy} of a JAX tree in the port's layout."""
    return {k: v.numpy() for k, v in to_torch(tree).named_buffers()}


def jax_refs(params, base, adapters):
    """JAX's steps on its dp 2 × tp 2 mesh, from the same draws (key KEY)."""
    mesh = jmesh.make_mesh(MESH, jax.devices()[:4])
    cfg = jcfg()
    b = {k: jax.device_put(jnp.asarray(v), jmesh.batch_sharding(mesh)) for k, v in batch().items()}
    key = jax.random.PRNGKey(KEY)
    sharded = jmesh.shard_flux_params(params, mesh)
    loss, grads = jax.jit(jax.value_and_grad(jtrain.flow_matching_loss), static_argnames=("cfg",))(
        sharded, cfg, b, key)
    out = {"loss": float(loss), "grads": _port(grads)}
    new, sgd_loss = jtrain.make_train_step(cfg)(jmesh.shard_flux_params(params, mesh), b, key)
    out.update(sgd=_port(new), sgd_loss=float(sgd_loss))
    init, step = jtrain.make_optax_train_step(cfg, optax.adamw(ADAMW_LR))
    p = jmesh.shard_flux_params(params, mesh)
    opt = jax.jit(init)(p)
    new, opt, adamw_loss = step(p, opt, b, key)
    out.update(adamw=_port(new), adamw_mu=_port(opt[0].mu), adamw_loss=float(adamw_loss))
    init, step = jtrain.make_optax_train_step(cfg, optax.chain(optax.clip_by_global_norm(CLIP), optax.adamw(ADAMW_LR)))
    p = jmesh.shard_flux_params(params, mesh)
    opt = jax.jit(init)(p)
    _, opt, _ = step(p, opt, b, key)
    out.update(clip_mu=_port(opt[1][0].mu))
    init, lstep = jtrain.make_lora_train_step(cfg, optax.sgd(LORA_LR))
    base_m = jax.tree.map(lambda x, s: jax.device_put(x, s), base, jmesh.flux_param_shardings(base, mesh),
                          is_leaf=lambda x: x is None)
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(mesh, P())
    ad = jax.device_put(adapters, rep)
    ad, _, lora_loss = lstep(ad, init(ad), base_m, b, jax.device_put(key, rep))
    out.update(adapters=adapter_flat(ad), lora_loss=float(lora_loss))
    return out


def _close(got: dict, want: dict, atol, rtol, what):
    assert sorted(got) == sorted(k for k in got if k in want), what
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], atol=atol, rtol=rtol, err_msg=f"{what}: {name}")


def test_sharded_train_step_runs_and_updates(results):
    """tests/test_parallel.py::test_sharded_train_step_runs_and_updates on dp 2 ×
    tp 2: every rank's loss and gradients are JAX's on its mesh, and one SGD step moves
    the tensors as JAX's step does; the world of one computes the same."""
    res, ref = results
    for world in ("dp2tp2", "one"):
        for r, rank in enumerate(res[world]):
            out = rank[0]
            np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-5)
            _close(out["grads"], ref["grads"], 1e-5, 1e-4, f"{world} rank {r} grads")
            _close(out["params"], ref["sgd"], 1e-6, 1e-4, f"{world} rank {r} params")
            assert np.isfinite(out["loss"])


def test_megatron_pair_replaced_by_dist_nn_all_reduce_fails(results):
    """The row-parallel reduction as torch.distributed.nn's all_reduce sums a gradient
    every tp rank already holds: the forward and the loss stay right, the gradients
    upstream of a row-parallel Linear do not, so the comparison above sees it."""
    res, ref = results
    out = res["fault"][0][0]
    np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-5)
    name = "double_blocks.0.img_attn_qkv.weight"
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(out["grads"][name], ref["grads"][name], atol=1e-5, rtol=1e-4)
    with pytest.raises(AssertionError):
        _close(out["grads"], ref["grads"], 1e-5, 1e-4, "dist.nn")


def test_remat_train_step_matches(results):
    """tests/test_parallel.py::test_remat_train_step_matches and
    ::test_remat_sharded_step_runs on the mesh: remat on and off give the same loss,
    gradients and step bit for bit (the recompute runs the same ops)."""
    res, _ = results
    for rank in res["dp2tp2"]:
        on, off = rank[0], rank[1]
        assert on["loss"] == off["loss"]
        for k in on["grads"]:
            np.testing.assert_array_equal(on["grads"][k], off["grads"][k], err_msg=k)
            np.testing.assert_array_equal(on["params"][k], off["params"][k], err_msg=k)


def test_adamw_sharded_opt_state_inherits_layout(results):
    """One AdamW step on dp 2 × tp 2 against optax.adamw on JAX's mesh: the updated
    tensors and the first moments; the moments are laid out as their parameters (a
    column-parallel qkv's rows split over tp)."""
    res, ref = results
    for world in ("dp2tp2", "one"):
        for r, rank in enumerate(res[world]):
            out = rank[2] if world == "dp2tp2" else rank[1]
            np.testing.assert_allclose(out["losses"][0], ref["adamw_loss"], rtol=1e-5)
            _close(out["mu"], ref["adamw_mu"], 1e-6, 1e-4, f"{world} rank {r} mu")
            for name, p in out["params"].items():
                sure = np.abs(ref["adamw_mu"][name]) > 0.1 * 1e-5  # mu = 0.1·g after one step
                np.testing.assert_allclose(p[sure], ref["adamw"][name][sure], atol=1e-6, rtol=1e-4, err_msg=name)
                assert np.abs(p - ref["adamw"][name]).max() <= 2 * ADAMW_LR, name
    hs = PARAMS.hidden_size
    for rank in res["dp2tp2"]:
        assert rank[2]["qkv_shapes"] == ((3 * hs // 2, hs), (3 * hs // 2, hs))


def test_adamw_steps_reduce_loss(results):
    """tests/test_parallel.py::test_adamw_steps_reduce_loss on dp 2 × tp 2: four steps
    on a fixed batch and fixed draws reduce the loss."""
    res, _ = results
    for rank in res["dp2tp2"]:
        losses = rank[4]["losses"]
        assert len(losses) == 4 and all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_lora_train_under_mesh(results):
    """tests/test_lora_train.py::test_lora_train_under_mesh: an int8 base sharded over
    dp 2 × tp 2, the adapters whole on every rank, the batch over dp; the loss and the
    adapters after one SGD step are JAX's (its flat-layout adapters, carried into the
    port's grouped layout and back), and the world of one's."""
    res, ref = results
    for world in ("dp2tp2", "one"):
        for r, rank in enumerate(res[world]):
            out = rank[3] if world == "dp2tp2" else rank[2]
            np.testing.assert_allclose(out["loss"], ref["lora_loss"], rtol=2e-4)
            _close(out["adapters"], ref["adapters"], 1e-7, 1e-3, f"{world} rank {r} adapters")


def test_roundtrip_on_mesh(results):
    """tests/test_parallel.py::test_roundtrip_on_mesh: the AdamW state written on
    dp 2 × tp 2 (one file of whole, flat tensors from the first rank) restores bit for
    bit on one rank and on tp 2, the step count included, and a step from it runs."""
    res, _ = results
    saved = res["dp2tp2"][0][2]
    for world in ("one", "tp2"):
        for r, rank in enumerate(res[world]):
            out = rank[-1]
            assert out["restored_step"] == 7
            for k, v in saved["params"].items():
                np.testing.assert_array_equal(out["params"][k], v, err_msg=f"{world} rank {r} {k}")
                np.testing.assert_array_equal(out["mu"][k], saved["mu"][k], err_msg=f"{world} rank {r} mu {k}")
            assert np.isfinite(out["loss"])


def test_adamw_with_clip_on_mesh_takes_the_global_norm(results):
    """optax.chain(clip_by_global_norm, adamw) on JAX's mesh against the port's
    ``max_grad_norm`` on dp 2 × tp 2: the global norm sums the squares of every tp
    slice over tp and of every replicated tensor once, so the first moments (a tenth of
    the clipped gradients) are JAX's."""
    res, ref = results
    assert ref["clip_mu"]
    for r, rank in enumerate(res["dp2tp2"]):
        _close(rank[5]["mu"], ref["clip_mu"], 1e-7, 1e-4, f"rank {r} clipped mu")


def test_save_onto_an_existing_state_raises_on_every_rank(results):
    """save_train_state without overwrite onto the state the dp 2 × tp 2 world has
    just written: the first rank raises FileExistsError and every other rank a
    RuntimeError at the same point, so no rank waits in a gather; the world gathers
    the same tensors after it."""
    res, _ = results
    ranks = res["dp2tp2"]
    assert [rank[2]["resave"] for rank in ranks] == ["FileExistsError"] + ["RuntimeError"] * (len(ranks) - 1)
    assert all(rank[2]["after_resave"] for rank in ranks)


def test_restore_refuses_an_older_or_foreign_state(tmp_path):
    """A state of the earlier format (the optimizer's state_dict keyed by index) and a
    state whose tensors are not the template's are refused with a ValueError; the
    state written here restores."""
    from flux_fp8_api_tpu_torch.parallel import train as ptrain

    x = torch.arange(4.0)
    opt = torch.optim.SGD([x.requires_grad_()], lr=0.1)
    ptrain.save_train_state(tmp_path / "new", {"x": x}, opt, step=3)
    y = torch.zeros(4)
    _, _, step = ptrain.restore_train_state(tmp_path / "new", {"x": y}, torch.optim.SGD([y], lr=0.5))
    assert step == 3 and torch.equal(y, torch.arange(4.0))
    with pytest.raises(ValueError, match="does not match"):
        ptrain.restore_train_state(tmp_path / "new", {"x": torch.zeros(4), "z": torch.zeros(1)}, None)
    (tmp_path / "old").mkdir()
    old = {"params": {"x": torch.arange(4.0)}, "step": 3,
           "opt_state": {"state": {}, "param_groups": [{"lr": 0.1, "params": [0]}]}}
    torch.save(old, tmp_path / "old" / ptrain.STATE_FILE)
    z = torch.zeros(4)
    with pytest.raises(ValueError, match="format 1"):
        ptrain.restore_train_state(tmp_path / "old", {"x": z}, torch.optim.SGD([z], lr=0.5))
