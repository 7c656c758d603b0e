"""The VAE in spatial bands and offload under a mesh, against the JAX package's mesh
VAE and the port's world of one, on the CPU: tests/test_parallel.py's ``TestMeshVAE``
cases and ``::test_offload_flow_with_mesh_roundtrip``.

JAX runs here on its 8-device virtual CPU mesh, where GSPMD partitions the VAE's convs
over the rows of its input (pipeline.py:357-369); the port's ranks run in worlds over
gloo (tests/torch_mesh_worker.py), each holding a band of rows and exchanging halo
rows, GroupNorm sums and the attention's k and v. Tolerances: fp32, the decoded and
encoded values within 1e-5 of one rank's and of JAX's mesh decode and encode (the mean:
the posterior's noise comes from other generators); the uint8 pixels within one step of
one rank's (a band's convs and GroupNorm sum in another order, and a value that lands
within 1e-6 of a step's edge floors to the neighbouring byte: one pixel channel of
12288 here); offload under tp 2 bit for bit the resident tp 2 world.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from flux_fp8_api_tpu.models import autoencoder as jae
from flux_fp8_api_tpu.models import flux as jflux
from flux_fp8_api_tpu.ops import packing as jpacking
from flux_fp8_api_tpu.ops.schedule import get_schedule
from flux_fp8_api_tpu.parallel import mesh as jmesh
from flux_fp8_api_tpu_torch.models import autoencoder as tae
from flux_fp8_api_tpu_torch.pipeline import FluxPipeline

from .helpers import TINY_AE_PARAMS, TINY_FLUX_PARAMS, tiny_spec
from .torch_mesh_worker import start_worlds
from .torch_parity import flatten, numpy_ae_params, numpy_flux_params, to_torch

torch.set_num_threads(1)

HW = (64, 64)
SEED = 9


def spec(**kw):
    return tiny_spec(flow_dtype="float32", ae_dtype="float32", **kw)


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(9)
    return dict(
        ae=numpy_ae_params(TINY_AE_PARAMS),
        latents=r.normal(size=(1, 16, TINY_FLUX_PARAMS.in_channels)).astype(np.float32),  # 64² → 4×4 patches
        image=r.uniform(-1, 1, size=(1, 64, 64, 3)).astype(np.float32),
        init=r.integers(0, 255, size=(64, 64, 3), dtype=np.uint8),
    )


def vae_task(data, mesh, **kw):
    return ("vae", {"ae": flatten(data["ae"]), "spec": spec(mesh=mesh).model_dump(), "latents": data["latents"],
                    "hw": HW, "image": data["image"], "seed": SEED, **kw})


@pytest.fixture(scope="module")
def results(data, tmp_path_factory):
    cfg = jflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32", use_pallas=False)
    tree = numpy_flux_params(cfg)
    r = np.random.default_rng(21)
    fixed = dict(noise=r.normal(size=(1, TINY_FLUX_PARAMS.in_channels // 4, 8, 8)).astype(np.float32),
                 vec=r.normal(size=(1, TINY_FLUX_PARAMS.vec_in_dim)).astype(np.float32),
                 txt=r.normal(size=(1, 6, TINY_FLUX_PARAMS.context_in_dim)).astype(np.float32),
                 timesteps=[float(x) for x in get_schedule(2, 16, shift=True)])
    gen = dict(width=64, height=64, num_steps=2, seed=1)

    def pipeline_task(**offload):
        return ("pipeline", {"tree": flatten(tree), "flux_params": TINY_FLUX_PARAMS.model_dump(), "dtype": "float32",
                             "use_pallas": False, "ae": flatten(data["ae"]),
                             "spec": spec(mesh={"dp": 1, "tp": 2}, **offload).model_dump(),
                             "generates": [gen, gen], **fixed})

    jobs = {
        "dp2tp2": {"mesh": {"dp": 2, "tp": 2}, "tasks": [vae_task(data, {"dp": 2, "tp": 2}, heights=[64, 6, 7])]},
        "tp2": {"mesh": {"dp": 1, "tp": 2}, "tasks": [
            vae_task(data, {"dp": 1, "tp": 2}, img2img=data["init"]),
            pipeline_task(),
            pipeline_task(offload_flow=True, offload_vae=True, offload_text_encoder=True),
        ]},
    }
    return start_worlds(tmp_path_factory.mktemp("mesh_vae"), jobs, timeout=170)()


def one_rank(data):
    """The port's whole decode and encode in this process."""
    ae = to_torch(data["ae"])
    lat = torch.from_numpy(data["latents"])
    pipe = FluxPipeline("flux-dev", ae=ae, config=spec())
    with torch.inference_mode():
        from flux_fp8_api_tpu_torch.ops.packing import unpack_latents

        x = unpack_latents(lat, *HW).permute(0, 2, 3, 1)
        img = torch.from_numpy(data["image"])
        gen = torch.Generator().manual_seed(SEED)
        return dict(pipe=pipe, pixels=pipe.vae_decode(lat, *HW),
                    decoded=tae.ae_decode(ae, TINY_AE_PARAMS, x).numpy(),
                    encoded=tae.ae_encode(ae, TINY_AE_PARAMS, img, gen).numpy(),
                    encoded_mean=tae.ae_encode(ae, TINY_AE_PARAMS, img, None).numpy())


def jax_mesh(data, axes):
    """JAX's decode and encode (mean) with the input's rows over ``axes`` of its
    dp 2 × tp 2 mesh."""
    mesh = jmesh.make_mesh({"dp": 2, "tp": 2}, jax.devices()[:4])
    rows = NamedSharding(mesh, P(None, axes, None, None))
    z = jnp.transpose(jpacking.unpack_latents(jnp.asarray(data["latents"]), *HW), (0, 2, 3, 1))
    dec = jax.jit(lambda p, z: jae.ae_decode(p, TINY_AE_PARAMS, z))(data["ae"], jax.device_put(z, rows))
    enc = jax.jit(lambda p, x: jae.ae_encode(p, TINY_AE_PARAMS, x, None))(
        data["ae"], jax.device_put(jnp.asarray(data["image"]), rows))
    return np.asarray(dec), np.asarray(enc)


def test_decode_matches_single_device(data, results):
    """dp 2 × tp 2, four bands of the 8 latent rows: the fp32 decode within 1e-5 of
    one rank's and of JAX's mesh decode, the uint8 pixels within a step of one rank's,
    on every rank."""
    one = one_rank(data)
    jdec, _ = jax_mesh(data, ("dp", "tp"))
    for r, rank in enumerate(results["dp2tp2"]):
        out = rank[0]
        assert out["decode_axes"] == ("dp", "tp")
        np.testing.assert_allclose(out["decoded"], one["decoded"], atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(out["decoded"], jdec, atol=1e-5, err_msg=f"rank {r}")
        assert out["pixels"].shape == (1, 64, 64, 3)
        assert np.abs(out["pixels"].astype(np.int16) - one["pixels"].astype(np.int16)).max() <= 1


def test_encode_in_bands_matches_single_device(data, results):
    """The img2img encode in bands (even ones at every stride-2 level): the sample
    within 1e-5 of one rank's from the same generator (its noise drawn whole and
    sliced), the mean within 1e-5 of JAX's mesh encode; over dp 2 × tp 2 and tp 2."""
    one = one_rank(data)
    for world, axes in (("dp2tp2", ("dp", "tp")), ("tp2", ("tp",))):
        _, jenc = jax_mesh(data, axes)
        for r, rank in enumerate(results[world]):
            out = rank[0]
            assert out["encode_axes"] == axes
            np.testing.assert_allclose(out["encoded"], one["encoded"], atol=1e-5, err_msg=f"{world} rank {r}")
            np.testing.assert_allclose(out["encoded_mean"], jenc, atol=1e-5, err_msg=f"{world} rank {r}")


def test_ae_input_sharding_picks_divisible_axes(results):
    """JAX pipeline._ae_input_sharding's choice: both axes for 64 rows, dp alone for 6,
    none for 7."""
    for rank in results["dp2tp2"]:
        assert rank[0]["axes"] == {64: ("dp", "tp"), 6: ("dp",), 7: None}


def test_img2img_generate_under_mesh(data, results):
    """The pipeline's img2img leg on tp 2 (noise, then the banded encode mixed in at
    strength 0.5) against one rank's from the same seed."""
    one = one_rank(data)["pipe"]
    gen = torch.Generator().manual_seed(SEED)
    x, _ = one.preprocess_latent(data["init"], 64, 64, 4, 0.5, gen, 1)
    for rank in results["tp2"]:
        got = rank[0]["img2img"]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, x.numpy(), atol=1e-5)


def test_offload_flow_with_mesh_roundtrip(results):
    """tp 2 with all three offload flags: each rank's shard tree stays on the host
    between requests, and two requests are the resident tp 2 world's bit for bit,
    latents and JPEG."""
    for r, rank in enumerate(results["tp2"]):
        resident, offloaded = rank[1], rank[2]
        assert offloaded["host"] and not resident["flow_bytes"] == 0
        for i in (0, 1):
            np.testing.assert_array_equal(offloaded[f"latents{i}"], resident[f"latents{i}"])
            assert offloaded[f"jpeg{i}"] == resident[f"jpeg{i}"]
        assert (offloaded["jpeg0"] is not None) == (r == 0)


def test_band_collectives_are_counted_apart_from_the_flows(results):
    """A tp 2 request's collectives: the flow's under their own kinds, the VAE bands'
    (halo rows, GroupNorm sums, k and v, the pixels) as ``band_*`` kinds, so a pinned
    budget of the flow reads the flow alone."""
    for rank in results["tp2"]:
        kinds = {k[0] for k in rank[1]["collectives0"]}
        assert {"band_all_gather", "band_all_reduce_sum", "all_gather", "all_reduce_sum"} <= kinds, kinds
        assert all(len(k[2]) == 4 for k in rank[1]["collectives0"] if k[0] == "band_all_gather")
