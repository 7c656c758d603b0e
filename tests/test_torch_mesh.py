"""The port's mesh (parallel/mesh.py) against the JAX package's, on the CPU.

JAX runs here, on its 8-device virtual CPU mesh (tests/conftest.py), and computes
the references: its ``relayout_flux_tree``, its device shards
(``x.addressable_shards`` of ``shard_flux_params`` / ``shard_encoder_params``) and
``flux_apply`` on its mesh. The port's ranks run in worlds of processes that import
torch and the port only (tests/torch_mesh_worker.py), over gloo; one world per mesh,
all started at once, several checks per world.

Tolerances: the grouped layout is a permutation, so int8 is bit for bit and fp32
within 2e-5; on the mesh, the int8 tier is bit for bit against the port's world of
one (the row-parallel partials are int32, an exact sum); fp32 against JAX's mesh with
XLA attention (``use_pallas=False`` on both sides) within a relative norm of 2e-5
(summation order of the split contractions); the max-free kernel's plain version on
the mesh against the port's world of one and against JAX's Pallas kernel in interpret
mode at the flux forward's own relative norm of 1e-4 (tests/test_torch_flux.py: p is
rounded to bf16, and a logit an ulp away can round it to the neighbouring value).
Shards, frozen input scales and fused LoRA bytes are compared for equality.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_fp8_api_tpu import lora as jlora
from flux_fp8_api_tpu import sampling as jsampling
from flux_fp8_api_tpu.models import clip as jclip
from flux_fp8_api_tpu.models import flux as jflux
from flux_fp8_api_tpu.models import t5 as jt5
from flux_fp8_api_tpu.ops import attention as jattn
from flux_fp8_api_tpu.ops import packing as jpacking
from flux_fp8_api_tpu.parallel import mesh as jmesh
from flux_fp8_api_tpu.utils import checkpoint as jckpt
from flux_fp8_api_tpu.utils.config import FluxParams
from flux_fp8_api_tpu_torch import lora as tlora
from flux_fp8_api_tpu_torch.calibration import apply_input_scales
from flux_fp8_api_tpu_torch.models import flux as tflux
from flux_fp8_api_tpu_torch.ops.attention_kernel import TILES
from flux_fp8_api_tpu_torch.ops.quant import Linear, _unpack_int4
from flux_fp8_api_tpu_torch.parallel import mesh as tmesh
from flux_fp8_api_tpu_torch.utils import checkpoint as tckpt
from flux_fp8_api_tpu_torch.utils.config import FluxParams as TFluxParams
from flux_fp8_api_tpu_torch.utils.convert import convert_adapters

from .torch_mesh_worker import leaf_fields, np_, run_worlds
from .torch_parity import flatten, numpy_flux_params, t, to_torch

torch.set_num_threads(1)

# tests/test_parallel.py's tiny flux: hidden 128, 4 heads of 32, 2 + 2 blocks
PARAMS = FluxParams(
    in_channels=16, vec_in_dim=32, context_in_dim=48, hidden_size=128,
    mlp_ratio=4.0, num_heads=4, depth=2, depth_single_blocks=2,
    axes_dim=[8, 12, 12], theta=10_000, qkv_bias=True, guidance_embed=True,
)
D, S = PARAMS.depth, PARAMS.depth_single_blocks
KINDS = ("float", "int8", "int4", "fp8")
MESHES = {"tp2": {"tp": 2}, "tp4": {"tp": 4}, "sp2": {"sp": 2}, "tp2sp2": {"tp": 2, "sp": 2}, "dp2": {"dp": 2}}
T5_CFG = dict(vocab_size=64, d_model=64, d_ff=128, num_layers=2, num_heads=4, d_kv=16)
CLIP_CFG = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
                max_position_embeddings=77, eos_token_id=2)
ENC_TIERS = ("qfloat8", "qint8", "qint4", "qint2")


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setattr(jattn, "FORCE_PALLAS_INTERPRET", True)


def _rel(b, a):
    return float(np.linalg.norm(np.asarray(b, np.float64) - a) / np.linalg.norm(a))


def jcfg(use_pallas=False, layout="flat"):
    cfg = jflux.FluxStatic.from_params(PARAMS, compute_dtype="float32", use_pallas=use_pallas)
    return dataclasses.replace(cfg, fused_layout=layout)


def pcfg(use_pallas=False, layout="flat"):
    cfg = tflux.FluxStatic.from_params(TFluxParams(**PARAMS.model_dump()), compute_dtype="float32",
                                       use_pallas=use_pallas)
    return dataclasses.replace(cfg, fused_layout=layout)


def inputs(batch=1, seed=0):
    """Joint length 8 + 16 = 24, which sp 2 divides; batch rows that differ."""
    r = np.random.default_rng(seed)
    return dict(
        img=r.normal(size=(batch, 16, PARAMS.in_channels)).astype(np.float32),
        img_ids=np.asarray(jpacking.make_img_ids(8, 8, batch)),
        txt=r.normal(size=(batch, 8, PARAMS.context_in_dim)).astype(np.float32),
        txt_ids=np.asarray(jpacking.make_txt_ids(8, batch)),
        t=np.full((batch,), 0.6, np.float32),
        y=r.normal(size=(batch, PARAMS.vec_in_dim)).astype(np.float32),
        g=np.full((batch,), 3.5, np.float32),
    )


def jargs(x):
    return tuple(jnp.asarray(x[k]) for k in ("img", "img_ids", "txt", "txt_ids", "t", "y", "g"))


def pargs(x):
    return tuple(t(x[k]) if x[k].dtype != np.int32 else torch.from_numpy(x[k]) for k in
                 ("img", "img_ids", "txt", "txt_ids", "t", "y", "g"))


@pytest.fixture(scope="module")
def trees():
    """kind → the JAX flux tree (fp32 kernels, numpy-filled), quantized."""
    base = numpy_flux_params(jcfg())
    return {k: base if k == "float" else jflux.quantize_flux_tree(base, kind=k) for k in KINDS}


def jax_on_mesh(params, shape, x, use_pallas=False):
    """JAX ``flux_apply`` on its mesh: the grouped relayout under tp, GSPMD shards, the
    Pallas attention's shard axes as the JAX pipeline sets them."""
    mesh = jmesh.make_mesh(shape, jax.devices()[: int(np.prod(list(shape.values())))])
    cfg = jcfg(use_pallas, "grouped" if shape.get("tp", 1) > 1 else "flat")
    if use_pallas:
        axes = tuple(a for a in ("dp", "tp") if shape.get(a, 1) > 1)
        cfg = dataclasses.replace(cfg, attn_shard_axes=axes or None,
                                  attn_seq_axis="sp" if shape.get("sp", 1) > 1 else None)
    if cfg.fused_layout == "grouped":
        params = jckpt.relayout_flux_tree(params, cfg)
    params = jmesh.shard_flux_params(params, mesh)
    args = tuple(jax.device_put(a, jmesh.batch_sharding(mesh)) for a in jargs(x))
    with jax.set_mesh(mesh):
        return np.asarray(jax.jit(jflux.flux_apply, static_argnums=1)(params, cfg, *args))


def port_one(tree, x, use_pallas=False, layout="flat", collect=False):
    """The port's world of one: the forward (and its amaxes) on the CPU."""
    model = to_torch(tree)
    cfg = pcfg(use_pallas, layout)
    if layout == "grouped":
        model = tckpt.relayout_flux_tree(model, cfg)
    with torch.inference_mode():
        return model, tflux.flux_apply(model, cfg, *pargs(x), collect_amax=collect)


def flux_task(tree, x, use_pallas=False, calibrate=False, plant=None):
    return ("flux", {"tree": flatten(tree), "flux_params": PARAMS.model_dump(), "dtype": "float32",
                     "use_pallas": use_pallas, "inputs": x, "calibrate": calibrate, "plant": plant})


# the tasks of each world, in order: (label, kind, use_pallas, calibrate)
FLUX_TASKS = {
    "tp2": [("xla", "float", False, False), ("pallas", "float", True, False), ("int8", "int8", True, True),
            ("int4", "int4", True, False), ("fp8", "fp8", True, False), ("fp8 bias fault", "fp8", True, False)],
    "tp4": [("xla", "float", False, False), ("int8", "int8", True, False), ("int4", "int4", True, False),
            ("fp8", "fp8", True, False), ("fp8 bias fault", "fp8", True, False)],
    "sp2": [("xla", "float", False, False), ("pallas", "float", True, False), ("int8", "int8", True, False)],
    "tp2sp2": [("xla", "float", False, False), ("pallas", "float", True, False), ("int8", "int8", True, False)],
    "dp2": [("xla", "float", False, False), ("pallas", "float", True, False), ("fp8", "fp8", True, True)],
}


def lora_sd(seed=3, rank=16):
    """A rank-16 LoRA (BFL keys, lora_A/lora_B) over one qkv, linear1, linear2 and a
    projection of every block."""
    r = np.random.default_rng(seed)
    hs, mh = PARAMS.hidden_size, int(PARAMS.hidden_size * PARAMS.mlp_ratio)
    shapes = {}
    for i in range(D):
        shapes[f"double_blocks.{i}.img_attn.qkv"] = (3 * hs, hs)
        shapes[f"double_blocks.{i}.txt_attn.proj"] = (hs, hs)
        shapes[f"double_blocks.{i}.img_mlp.2"] = (hs, mh)
    for i in range(S):
        shapes[f"single_blocks.{i}.linear1"] = (3 * hs + mh, hs)
        shapes[f"single_blocks.{i}.linear2"] = (hs, hs + mh)
    sd = {}
    for key, (o, n) in shapes.items():
        sd[f"{key}.lora_A.weight"] = (r.normal(size=(rank, n)) / np.sqrt(n)).astype(np.float32)
        sd[f"{key}.lora_B.weight"] = (0.05 * r.normal(size=(o, rank))).astype(np.float32)
    return sd


def encoder_trees():
    """tier → (T5 tree, CLIP tree) from the JAX package, quantized (weight-only)."""
    t5p = jt5.init_t5_params(jax.random.PRNGKey(11), jt5.T5Config(**T5_CFG), jnp.float32)
    clp = jclip.init_clip_params(jax.random.PRNGKey(10), jclip.CLIPConfig(**CLIP_CFG), jnp.float32)
    return {tier: (jt5.quantize_t5_params(t5p, tier), jclip.quantize_clip_params(clp, tier))
            for tier in ENC_TIERS}


@pytest.fixture(scope="module")
def worlds(trees, tmp_path_factory):
    """Every world's results: {mesh name: [rank results]}, each rank's a list with one
    entry per task."""
    x1, x2 = inputs(1), inputs(2)
    jobs = {}
    for name, tasks in FLUX_TASKS.items():
        x = x2 if name == "dp2" else x1
        jobs[name] = {"mesh": MESHES[name], "tasks": [flux_task(trees[k], x, up, cal, "bias" if "fault" in lab else None)
                                                     for lab, k, up, cal in tasks]}
    jobs["tp2"]["tasks"].append(("lora", {"tree": flatten(trees["fp8"]), "flux_params": PARAMS.model_dump(),
                                          "dtype": "float32", "inputs": x1, "lora": lora_sd()}))
    jobs["tp2"]["tasks"].append(("lora", {"tree": flatten(trees["int8"]), "flux_params": PARAMS.model_dump(),
                                          "dtype": "float32", "inputs": x1, "lora": lora_sd()}))
    ids = np.random.default_rng(5).integers(0, 64, size=(1, 12)).astype(np.int64)
    enc = encoder_trees()
    for name in ("tp2", "tp4"):
        for tier in ENC_TIERS:
            t5q, clq = enc[tier]
            jobs[name]["tasks"].append(("encoders", {"t5": flatten(t5q), "clip": flatten(clq), "ids": ids,
                                                     "t5_cfg": T5_CFG, "clip_cfg": CLIP_CFG,
                                                     "t5_len": 12, "clip_len": 12}))
    jobs["dp2"]["tasks"].append(("dynamic", {"tree": flatten(trees["float"]), "flux_params": PARAMS.model_dump(),
                                             "dtype": "float32", "use_pallas": False, "inputs": x2,
                                             "timesteps": DYN_TIMESTEPS, "cache": DYN_CACHE}))
    jobs["tp2sp2"]["tasks"].append(("autotune", AUTOTUNE_JOB))
    results = run_worlds(tmp_path_factory.mktemp("mesh"), jobs, timeout=150)
    return results, enc, ids


# the tile autotuning of a warm-up bucket on tp 2 x sp 2: a joint length, the heads
AUTOTUNE_JOB = {"joint": 4608, "num_heads": 24, "head_dim": 128}


DYN_TIMESTEPS = [1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3, 0.2]
DYN_CACHE = {"mode": "dynamic", "threshold": 0.3}


def task(results, name, i, rank=0):
    return results[name][rank][i]


def label_index(name, label):
    return [lab for lab, *_ in FLUX_TASKS[name]].index(label)


# ------------------------------------------------------------------- permutations


def assert_field(got, want, kind, field, msg):
    """Equal bytes, except int4's w_scale_inv after linear2's in-permutation, which
    requantizes: JAX runs it eagerly, where the reciprocal is an exact division, the
    port as the jitted quantizer forms it (tests/test_torch_checkpoint.py), one ulp
    apart."""
    if kind == "int4" and field == "w_scale_inv":
        np.testing.assert_allclose(got, want, rtol=2**-22, atol=0, err_msg=msg)
    else:
        np.testing.assert_array_equal(got, want, err_msg=msg)


def test_permutations_and_relayout_match_jax(trees):
    hs, hd, mh = PARAMS.hidden_size, PARAMS.hidden_size // PARAMS.num_heads, int(PARAMS.hidden_size * 4)
    np.testing.assert_array_equal(tckpt.grouped_qkv_permutation(hs, hd), jckpt.grouped_qkv_permutation(hs, hd))
    np.testing.assert_array_equal(tckpt.grouped_qkv_permutation(hs, hd, mh),
                                  jckpt.grouped_qkv_permutation(hs, hd, mh))
    np.testing.assert_array_equal(tckpt.linear2_in_permutation(hs, hd, mh), jckpt.linear2_in_permutation(hs, hd, mh))
    for kind in KINDS:
        ja = jckpt.relayout_flux_tree(trees[kind], jcfg(layout="grouped"))
        pa = tckpt.relayout_flux_tree(to_torch(trees[kind]), pcfg(layout="grouped"))
        ref = leaf_fields(to_torch(ja))
        got = leaf_fields(pa)
        assert sorted(got) == sorted(ref)
        for path in ref:
            for field, want in ref[path].items():
                assert_field(got[path][field], want, kind, field, f"{kind} {path}.{field}")
        back = leaf_fields(tckpt.relayout_flux_tree(pa, pcfg(layout="grouped"), inverse=True))
        flat = leaf_fields(to_torch(trees[kind]))
        for path in flat:  # the inverse round trip: the flat tree's weights exactly
            field = "q" if "q" in flat[path] else "weight"
            np.testing.assert_array_equal(back[path][field], flat[path][field], err_msg=f"{kind} {path}")


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_grouped_forward_equals_flat(trees, kind):
    """tests/test_parallel.py:282-324 for the port: int8 bit for bit (int32 sums are
    order-free), fp32 within 2e-5."""
    x = inputs()
    _, flat = port_one(trees[kind], x, use_pallas=True)
    _, grouped = port_one(trees[kind], x, use_pallas=True, layout="grouped")
    if kind == "int8":
        assert torch.equal(grouped, flat)
    else:
        np.testing.assert_allclose(grouped.numpy(), flat.numpy(), rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------------------- shards


def jax_device_shards(tree, shape):
    """{(stack, leaf, field): [tp rank → numpy]} of JAX's flux shards on a tp mesh."""
    n = int(np.prod(list(shape.values())))
    mesh = jmesh.make_mesh(shape, jax.devices()[:n])
    params = jckpt.relayout_flux_tree(tree, jcfg(layout="grouped"))
    sharded = jmesh.shard_flux_params(params, mesh)
    devices = list(mesh.devices.flat)
    out = {}
    for stack in ("double_blocks", "single_blocks"):
        for leaf, lin in sharded[stack].items():
            if not isinstance(lin, jax.Array) and hasattr(lin, "kind"):
                for field in ("kernel", "q", "bias", "w_scale", "w_scale_inv", "in_scale"):
                    arr = getattr(lin, field)
                    if arr is None:
                        continue
                    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
                    out[(stack, leaf, field)] = [by_dev[d] for d in devices]
    return params, out


PORT_FIELD = {"kernel": "weight", "q": "q", "bias": "bias", "w_scale": "w_scale",
              "w_scale_inv": "w_scale_inv", "in_scale": "in_scale"}


@pytest.mark.parametrize("name", ["tp2", "tp4"])
@pytest.mark.parametrize("kind", KINDS)
def test_flux_shards_equal_jax_device_shards(worlds, trees, name, kind):
    """Each rank's slice of every block leaf equals the bytes of JAX's matching device
    shard; the int4 row leaves, which the port repacks, equal the unpacked values of
    the whole weight's contiguous slice."""
    results, _, _ = worlds
    i = [k for _, k, *_ in FLUX_TASKS[name]].index(kind)
    full, shards = jax_device_shards(trees[kind], MESHES[name])
    full_port = leaf_fields(to_torch(full))
    for (stack, leaf, field), per_rank in shards.items():
        for r, jshard in enumerate(per_rank):
            got = results[name][r][i]["shards"]
            for blk in range(jshard.shape[0]):
                path = f"{stack}.{blk}.{leaf}"
                val = got[path][PORT_FIELD[field]]
                if field == "q" and kind == "int4" and tmesh._BLOCK_LINEAR_KIND.get(leaf) == "row":
                    whole = _unpack_int4(torch.from_numpy(full_port[path]["q"])).numpy()
                    n = whole.shape[1] // len(per_rank)
                    np.testing.assert_array_equal(_unpack_int4(torch.from_numpy(val)).numpy(),
                                                  whole[:, r * n:(r + 1) * n], err_msg=f"{name} {path} r{r}")
                    continue
                want = to_torch_view(jshard[blk], field, kind)
                assert_field(val, want, kind, PORT_FIELD[field], f"{name} {kind} {path}.{field} rank {r}")


def to_torch_view(a, field, kind):
    """One JAX block field → the port's layout and byte view."""
    a = np.asarray(a)
    if field in ("kernel", "q"):
        a = a.T
    return np_(to_t(a))


def to_t(a):
    from flux_fp8_api_tpu_torch.utils.convert import to_tensor

    return to_tensor(a)


@pytest.mark.parametrize("name", ["tp2", "tp4"])
@pytest.mark.parametrize("tier", ENC_TIERS)
def test_encoder_shards_equal_jax_device_shards(worlds, name, tier):
    """T5 and CLIP at each weight-only tier: every block leaf's slice equals JAX's
    device shard, the guard's replicated fields included (wo_int4/int2 scales of one
    block per row, which tp does not divide), and the encoding equals the unsharded
    port's."""
    from flux_fp8_api_tpu_torch.models import clip as tclip
    from flux_fp8_api_tpu_torch.models import t5 as tt5

    results, enc, ids = worlds
    i = len(FLUX_TASKS[name]) + (2 if name == "tp2" else 0) + ENC_TIERS.index(tier)
    n = MESHES[name]["tp"]
    mesh = jmesh.make_mesh(MESHES[name], jax.devices()[:n])
    devices = list(mesh.devices.flat)
    for which, tree in zip(("t5", "clip"), enc[tier]):
        sharded = jmesh.shard_encoder_params(tree, mesh)
        for leaf, lin in sharded["blocks"].items():
            if not hasattr(lin, "kind"):
                continue
            for field in ("kernel", "q", "bias", "w_scale", "w_scale_inv"):
                arr = getattr(lin, field)
                if arr is None:
                    continue
                by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
                for r, d in enumerate(devices):
                    got = results[name][r][i][which]["shards"]
                    for blk in range(by_dev[d].shape[0]):
                        a = by_dev[d][blk]
                        if field in ("kernel", "q") or (field == "w_scale_inv" and a.ndim == 2):
                            a = a.T
                        np.testing.assert_array_equal(got[f"blocks.{blk}.{leaf}"][PORT_FIELD[field]], np_(to_t(a)),
                                                      err_msg=f"{name} {tier} {which} {leaf}.{field} r{r}")
        model = to_torch(tree)
        x = torch.from_numpy(ids[:, :12])
        with torch.inference_mode():
            if which == "t5":
                ref = tt5.t5_encode(model, tt5.T5Config(**T5_CFG), x, torch.float32).numpy()
            else:
                ref = tclip.clip_encode(model, tclip.CLIPConfig(**CLIP_CFG), x, torch.float32)[1].numpy()
        for r in range(n):
            out = results[name][r][i][which]
            np.testing.assert_allclose(out["out"], ref, rtol=1e-5, atol=1e-5, err_msg=f"{which} {tier} r{r}")
            # two all-reduces per block (o/out_proj and the down-projection)
            assert sum(out["collectives"].values()) == 2 * 2, out["collectives"]


# ------------------------------------------------------------------------ forwards


@pytest.mark.parametrize("name", list(MESHES))
def test_flux_apply_on_the_mesh_matches_jax_mesh(worlds, trees, name):
    """fp32, XLA attention on both sides (SDPA here): the port's world against JAX's
    ``flux_apply`` on its mesh with the same weights, every rank alike."""
    results, _, _ = worlds
    x = inputs(2 if name == "dp2" else 1)
    ref = jax_on_mesh(trees["float"], MESHES[name], x)
    i = label_index(name, "xla")
    for rank in results[name]:
        assert _rel(rank[i]["pred"], ref) < 2e-5
        np.testing.assert_allclose(rank[i]["pred"], ref, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("name", [n for n in MESHES if "pallas" in [lab for lab, *_ in FLUX_TASKS[n]]])
def test_kernel_path_on_the_mesh(worlds, trees, name):
    """The max-free kernel's path (its plain version here) at the mesh's local
    shapes, against the port's world of one and JAX's mesh with the Pallas kernel in
    interpret mode, both at the flux forward's relative norm of 1e-4: p is rounded to
    bf16, and a logit one fp32 ulp away (another product shape on a dp rank) can
    round it to the neighbouring value."""
    results, _, _ = worlds
    x = inputs(2 if name == "dp2" else 1)
    i = label_index(name, "pallas")
    _, one = port_one(trees["float"], x, use_pallas=True)
    ref = jax_on_mesh(trees["float"], MESHES[name], x, use_pallas=True)
    for rank in results[name]:
        assert rank[i]["cfg"]["use_pallas"]
        assert rank[i]["cfg"]["seq"] == ("sp" if "sp" in MESHES[name] else None)
        assert _rel(rank[i]["pred"], one.numpy()) < 1e-4
        assert _rel(rank[i]["pred"], ref) < 1e-4


@pytest.mark.parametrize("name", ["tp2", "tp4", "sp2", "tp2sp2"])
def test_int8_on_the_mesh_is_one_rank_bit_for_bit(worlds, trees, name):
    results, _, _ = worlds
    i = label_index(name, "int8")
    _, one = port_one(trees["int8"], inputs(), use_pallas=True)
    for rank in results[name]:
        np.testing.assert_array_equal(rank[i]["pred"], one.numpy())


@pytest.mark.parametrize("name", ["tp2", "tp4"])
def test_fp8_on_the_mesh_is_one_rank_within_its_rounding(worlds, trees, name):
    """fp8 under tp against the port's world of one in fp32 at the file's fp32
    tolerance: the row-parallel partials are summed over the ranks in another order,
    and no activation here lands on the other side of an e5m2 boundary for it. The
    same world with every row-parallel bias added on each rank
    (``plant_bias_fault``) reads outside it: the comparison sees that fault."""
    results, _, _ = worlds
    _, one = port_one(trees["fp8"], inputs(), use_pallas=True, layout="grouped")
    for rank in results[name]:
        assert _rel(rank[label_index(name, "fp8")]["pred"], one.numpy()) < 2e-5
        assert _rel(rank[label_index(name, "fp8 bias fault")]["pred"], one.numpy()) > 1e-2


def expected_budget(shape, batch=1, tokens=24, local_heads=None):
    """The collectives of one evaluation: under tp each double block all-gathers its
    two modulation vectors and all-reduces four row-parallel partials, each single
    block one of each; the int tiers reduce int32, the others fp32. Under sp each
    attention call all-gathers its output rows."""
    tp, sp = shape.get("tp", 1), shape.get("sp", 1)
    hs = PARAMS.hidden_size
    out = {}
    if tp > 1:
        out[("all_gather", "float32", (batch, 6 * hs // tp))] = 2 * D
        out[("all_gather", "float32", (batch, 3 * hs // tp))] = S
    if sp > 1:
        n = PARAMS.num_heads // tp * batch
        out[("all_gather", "float32", (n, tokens // sp, hs // PARAMS.num_heads))] = D + S
    return out


@pytest.mark.parametrize("name", list(MESHES))
def test_collective_budget_is_pinned(worlds, name):
    """The collectives of one evaluation, per kind, dtype and shape. Every one moves
    activations: no collective has the shape of a weight field."""
    results, _, _ = worlds
    tp = MESHES[name].get("tp", 1)
    for label, kind, *_ in FLUX_TASKS[name]:
        i = label_index(name, label)
        for rank in results[name]:
            got = dict(rank[i]["collectives"])
            want = expected_budget(MESHES[name])
            if tp > 1:
                red = "int32" if kind in ("int8", "int4") else "float32"
                want[("all_reduce_sum", red, (8, PARAMS.hidden_size))] = 2 * D  # the txt stream
                want[("all_reduce_sum", red, (16, PARAMS.hidden_size))] = 2 * D  # the img stream
                want[("all_reduce_sum", red, (24, PARAMS.hidden_size))] = S
            assert got == want, (name, label)
            weights = {v.shape for path, fields in rank[i]["shards"].items() for k, v in fields.items()
                       if path.split(".")[0].endswith("_blocks") and k in ("weight", "q")}
            assert not any(shape in weights for _, _, shape in got), (name, label)


def test_param_sharding_table(trees):
    """JAX tests/test_parallel.py's spec test on the slices ``shard_flux_params`` keeps
    (dims of the port's (out, in) weights): qkv column-parallel with its per-out-channel
    scales, proj row-parallel with its bias whole, the final layer, the per-tensor
    scales and everything under tp 1 replicated."""
    whole = to_torch(trees["int8"])
    model = tmesh.shard_flux_params(to_torch(trees["int8"]), tmesh.Mesh({"dp": 4, "tp": 2}, rank=3))
    qkv, qkv1 = model["double_blocks"][0]["img_attn_qkv"], whole["double_blocks"][0]["img_attn_qkv"]
    n = qkv1.q.shape[0] // 2
    assert qkv.shard.mode == "col" and torch.equal(qkv.q, qkv1.q[n:]) and torch.equal(qkv.w_scale, qkv1.w_scale[n:])
    proj, proj1 = model["double_blocks"][0]["img_attn_proj"], whole["double_blocks"][0]["img_attn_proj"]
    n = proj1.q.shape[1] // 2
    assert proj.shard.mode == "row" and torch.equal(proj.q, proj1.q[:, n:]) and torch.equal(proj.bias, proj1.bias)
    lin2, lin21 = model["single_blocks"][0]["linear2"], whole["single_blocks"][0]["linear2"]
    assert lin2.shard.mode == "row" and torch.equal(lin2.in_scale, lin21.in_scale)
    final = model["final_layer"]["linear"]
    assert final.shard is None and torch.equal(final.weight, whole["final_layer"]["linear"].weight)
    flat = tmesh.shard_flux_params(to_torch(trees["int8"]), tmesh.Mesh({"dp": 8}, rank=5))
    assert all(lin.shard is None for lin in flat.modules() if isinstance(lin, Linear))


def test_dp_batch_rows_and_heads_guard():
    """dp splits the batch rows it divides (JAX batch_sharding) and keeps an odd
    batch whole; heads that the dp × tp product does not divide run use_pallas=False
    for the whole model, as in JAX."""
    mesh = tmesh.Mesh({"dp": 2, "tp": 2}, rank=3)
    assert mesh.coords == {"dp": 1, "tp": 1}
    assert mesh.batch_rows(4) == slice(2, 4) and mesh.batch_rows(3) is None
    cfg = dataclasses.replace(pcfg(use_pallas=True), num_heads=6, hidden_size=192, mlp_hidden=768)
    _, out = tmesh.setup_flux(None, cfg, tmesh.Mesh({"dp": 4, "tp": 3}))
    assert not out.use_pallas
    _, out = tmesh.setup_flux(None, pcfg(use_pallas=True), tmesh.Mesh({"dp": 2, "tp": 2, "sp": 2}))
    assert out.use_pallas and out.attn_shard_axes == ("dp", "tp") and out.attn_seq_axis == "sp"
    with pytest.raises(ValueError, match="needs 4 ranks, have 1"):
        tmesh.make_mesh({"dp": 2, "tp": 2}, backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="gloo"):
        tmesh.check_backend("nccl", 2, torch.device("cpu"))


# --------------------------------------------------------- one decision on every rank


@pytest.mark.parametrize("name,kind", [("tp2", "int8"), ("dp2", "fp8")])
def test_calibration_freezes_one_ranks_scales(worlds, trees, name, kind):
    """Calibration reduces every amax with MAX over the mesh, so each rank freezes
    the in_scale one rank freezes: under tp on the int8 tier, whose forward on the
    mesh is one rank's bit for bit (a float tier's row-parallel sums run in another
    order, and so do its amaxes' last bits), under dp on fp8 (rows are independent).
    Without the reduction (``local_in_scales``) the ranks' scales differ from it: the
    test sees the reduction."""
    results, _, _ = worlds
    i = label_index(name, kind)
    x = inputs(2 if name == "dp2" else 1)
    layout = "grouped" if name == "tp2" else "flat"
    model, (_, amaxes) = port_one(trees[kind], x, use_pallas=True, layout=layout, collect=True)
    apply_input_scales(model, amaxes)
    want = {k: v["in_scale"] for k, v in leaf_fields(model).items() if "in_scale" in v}
    differs = 0
    for rank in results[name]:
        got = rank[i]["in_scales"]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        differs += sum(not np.array_equal(rank[i]["local_in_scales"][k], want[k]) for k in want)
    assert differs > 0


def test_dynamic_cache_takes_one_decision(worlds, trees):
    """dp 2 with rows that differ: the drift's sums reduced over dp give every rank
    JAX's decision over the whole batch, and JAX's number of evaluations; each rank's
    own rows decide otherwise (``local_evals``)."""
    results, _, _ = worlds
    x = inputs(2)
    jcf = jcfg()
    stats = {}
    jsampling.denoise(trees["float"], jcf, *(jnp.asarray(x[k]) for k in ("img", "img_ids", "txt", "txt_ids", "y")),
                      DYN_TIMESTEPS, 3.5, fused=True, cache=jsampling.CacheConfig.parse(DYN_CACHE), stats=stats)
    dyn = len(FLUX_TASKS["dp2"])
    evals = [rank[dyn]["reduced_evals"] for rank in results["dp2"]]
    assert evals == [stats["model_evals"]] * 2
    assert 3 < evals[0] < len(DYN_TIMESTEPS) - 1
    assert len({rank[dyn]["local_evals"] for rank in results["dp2"]} | {evals[0]}) > 1


def port_lora_fuse(tree, sd):
    """One rank's fuse in the grouped layout → {path: fields}, forward."""
    model = tckpt.relayout_flux_tree(to_torch(tree), pcfg(True, "grouped"))
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    keys = sorted({k.rsplit(".lora_", 1)[0] for k in tsd})
    with torch.inference_mode():
        tlora.fuse_lora(model, pcfg(True, "grouped"), tsd, keys, 1.0)
    return leaf_fields(model)


@pytest.mark.parametrize("kind", ["fp8", "int8"])
def test_lora_fuse_under_tp_is_one_rank_fuse_sliced(worlds, trees, kind):
    """A rank-16 LoRA fused under tp 2 gives the bytes of a one-rank fuse, then
    sliced: the fresh scales come from the whole weight's amax (a MAX over tp), which
    no rank's slice alone gives for fp8's per-tensor scale."""
    results, _, _ = worlds
    i = len(FLUX_TASKS["tp2"]) + ("fp8", "int8").index(kind)
    one = port_lora_fuse(trees[kind], lora_sd())
    local_scale_differs = False
    for r, rank in enumerate(results["tp2"]):
        got = rank[i]["shards"]
        for path, fields in one.items():
            leaf = path.split(".")[-1]
            mode = tmesh._BLOCK_LINEAR_KIND.get(leaf) if path.split(".")[0].endswith("blocks") else None
            for field, want in fields.items():
                if field == "kind":
                    continue
                dim = tmesh._linear_spec(mode or "rep")[field] if mode else None
                if dim is not None and want.ndim > dim:
                    n = want.shape[dim] // 2
                    want = np.take(want, range(r * n, (r + 1) * n), axis=dim)
                np.testing.assert_array_equal(got[path][field], want, err_msg=f"{kind} {path}.{field} r{r}")
            if kind == "fp8" and mode == "col" and "q" in fields:
                w = torch.from_numpy(got[path]["q"]).view(torch.float8_e4m3fn).float() * float(got[path]["w_scale_inv"])
                local_scale_differs |= not np.isclose(448.0 / float(w.abs().max()), float(got[path]["w_scale"]))
    if kind == "fp8":
        assert local_scale_differs


def test_grouped_export_matches_jax():
    """export_lora_adapters of the grouped layout (JAX lora.py:592-620): the same
    arrays as JAX's, and fusing the export into a flat tree inverts it."""
    r = np.random.default_rng(4)
    hs, mh = PARAMS.hidden_size, int(PARAMS.hidden_size * 4)
    dims = {"img_attn_qkv": (hs, 3 * hs), "linear1": (hs, 3 * hs + mh), "linear2": (hs + mh, hs)}
    adapters = {}
    for stack, leaves, depth in (("double_blocks", ["img_attn_qkv"], D), ("single_blocks", ["linear1", "linear2"], S)):
        adapters[stack] = {leaf: {"a": r.normal(size=(depth, dims[leaf][0], 4)).astype(np.float32),
                                  "b": r.normal(size=(depth, 4, dims[leaf][1])).astype(np.float32)}
                           for leaf in leaves}
    want = jlora.export_lora_adapters(jax.tree.map(jnp.asarray, adapters), jcfg(layout="grouped"))
    got = tlora.export_lora_adapters(convert_adapters(adapters), pcfg(layout="grouped"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_mesh_autotune_registers_the_first_ranks_winner(worlds):
    """autotune_mesh_blocks on tp 2 x sp 2, each rank's stubbed measure preferring
    another tile: only the first rank measures, at the local shape (L/sp q rows against
    L, heads/tp), and every rank registers its winner and margin (the broadcast), so
    the ranks run one tile and none timed another's card."""
    results = worlds[0]["tp2sp2"]
    index = len(FLUX_TASKS["tp2sp2"])
    ranks = [r[index] for r in results]
    key = (AUTOTUNE_JOB["joint"] // 2, AUTOTUNE_JOB["joint"])
    first = ranks[0]
    assert first["calls"] and all(c[:3] == (key[0], key[1], AUTOTUNE_JOB["num_heads"] // 2) for c in first["calls"])
    assert first["blocks"] == first["favourite"]
    assert len({r["favourite"] for r in ranks}) > 1  # rank 1 would have picked another tile
    for r in ranks:
        assert r["blocks"] == first["blocks"]
        assert r["rect"] == {key: first["favourite"]} and r["margins"] == first["margins"]
    assert all(r["calls"] == [] for r in ranks[1:])
    tiles = [tuple(t[:2]) for t in TILES]
    runner_up = min(2e-4 + 1e-5 * i for i, t in enumerate(tiles) if t != first["favourite"])
    assert first["margins"][key] == pytest.approx((runner_up - 1e-4) * 1e3, abs=1e-3)
