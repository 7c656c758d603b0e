"""img2img in the port against the JAX package, on the CPU in fp32: the VAE encode,
the init-image loaders, ``preprocess_latent``'s noise mixing and schedule cut, and a
tiny-config ``generate`` from an init image.

Tolerances: the encoder goes through a dozen convolutions whose fp32 sums run in
another order than XLA's, as the decoder does in test_torch_text_vae.py: rtol 1e-4,
atol 1e-4. ``_downsample`` is one convolution: 1e-5. The loaders and
``resize_center_crop`` run the same PIL calls: equal bytes. ``preprocess_latent`` mixes
shared noise with the encoded mean: 1e-5; the schedule cut must be equal. The tiny
generate carries the encode through four Euler steps of the flux forward, whose own
tolerance is a relative norm of 1e-4 (test_torch_pipeline.py): 1e-4 in norm here too.
"""

import base64
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from flux_fp8_api_tpu import pipeline as jpipeline
from flux_fp8_api_tpu.models import autoencoder as jae
from flux_fp8_api_tpu.models import flux as jflux
from flux_fp8_api_tpu.ops import attention as jattn
from flux_fp8_api_tpu_torch import pipeline as tpipeline
from flux_fp8_api_tpu_torch.models import autoencoder as tae
from flux_fp8_api_tpu_torch.models import flux as tflux

from .helpers import TINY_AE_PARAMS, TINY_FLUX_PARAMS, tiny_spec
from .torch_parity import numpy_ae_params, numpy_flux_params, t, to_torch

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setattr(jattn, "FORCE_PALLAS_INTERPRET", True)


@pytest.fixture(scope="module")
def ae():
    return numpy_ae_params(TINY_AE_PARAMS, seed=7)


def _image(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 3)).astype(np.uint8)


def _nhwc(seed, h, w):
    return np.random.default_rng(seed).uniform(-1, 1, size=(1, h, w, 3)).astype(np.float32)


def test_ae_encode_mean_matches_jax(ae):
    x = _nhwc(0, 64, 48)
    a = np.asarray(jax.jit(lambda p, x: jae.ae_encode(p, TINY_AE_PARAMS, x, None))(ae, jnp.asarray(x)))
    b = tae.ae_encode(to_torch(ae), TINY_AE_PARAMS, t(x))
    assert b.shape == a.shape == (1, 8, 6, TINY_AE_PARAMS.z_channels)
    np.testing.assert_allclose(b.numpy(), a, **TOL)


def test_ae_encode_sample_is_the_gaussian_formula_on_jax_moments(ae):
    """With a generator: scale·(mean + exp(logvar/2)·ε − shift), ε the generator's next
    standard normal draw of the latent's shape; mean and logvar from JAX's encoder."""
    x = _nhwc(1, 64, 64)
    moments = np.asarray(jae.encoder_apply(ae["encoder"], jnp.asarray(x), TINY_AE_PARAMS))
    mean, logvar = np.split(moments, 2, axis=-1)
    eps = torch.randn(mean.shape, generator=torch.Generator().manual_seed(5)).numpy()
    want = TINY_AE_PARAMS.scale_factor * (mean + np.exp(0.5 * logvar) * eps - TINY_AE_PARAMS.shift_factor)
    got = tae.ae_encode(to_torch(ae), TINY_AE_PARAMS, t(x), torch.Generator().manual_seed(5))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not np.allclose(got.numpy(), TINY_AE_PARAMS.scale_factor * (mean - TINY_AE_PARAMS.shift_factor), atol=1e-3)


@pytest.mark.parametrize("h,w", [(8, 8), (7, 9), (6, 5)])
def test_downsample_asymmetric_pad_matches_jax(h, w):
    r = np.random.default_rng(h * w)
    p = {"conv": {"kernel": (0.2 * r.normal(size=(3, 3, 32, 32))).astype(np.float32),
                  "bias": r.normal(size=(32,)).astype(np.float32)}}
    x = r.normal(size=(1, h, w, 32)).astype(np.float32)
    a = np.asarray(jae._downsample(p, jnp.asarray(x)))
    b = tae._downsample(to_torch(p), t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert b.shape == a.shape == (1, (h - 2) // 2 + 1, (w - 2) // 2 + 1, 32)
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size,target", [((100, 80), (64, 48)), ((64, 64), (64, 64)),
                                         ((50, 131), (48, 96)), ((37, 41), (64, 32))])
def test_resize_center_crop_bytes_equal_jax(size, target):
    img = _image(2, *size)
    a = jpipeline.FluxPipeline.resize_center_crop(None, img, *target)
    b = tpipeline.FluxPipeline.resize_center_crop(None, img, *target)
    assert b.dtype == np.uint8 and b.shape == target + (3,)
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("form", ["path", "base64", "data_url", "pil", "array", "none"])
def test_load_init_image_if_needed_matches_jax(tmp_path, form):
    img = _image(3, 40, 56)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=95)
    b64 = base64.b64encode(buf.getvalue()).decode()
    path = tmp_path / "init.jpg"
    path.write_bytes(buf.getvalue())
    arg = {"path": str(path), "base64": b64, "data_url": "data:image/jpeg;base64," + b64,
           "pil": Image.open(io.BytesIO(buf.getvalue())), "array": img, "none": None}[form]
    a = jpipeline.FluxPipeline.load_init_image_if_needed(None, arg)
    b = tpipeline.FluxPipeline.load_init_image_if_needed(None, arg)
    if form == "none":
        assert a is None and b is None
        return
    assert b.dtype == np.uint8 and b.shape == (40, 56, 3)
    np.testing.assert_array_equal(b, a)


@pytest.fixture(scope="module")
def models(ae):
    cfg = jflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32", use_pallas=True)
    return cfg, numpy_flux_params(cfg, seed=3), ae


def _pipelines(models):
    cfg, params, ae = models
    spec = tiny_spec(flow_dtype="float32", ae_dtype="float32")
    jpipe = jpipeline.FluxPipeline("flux-dev", model=params, model_cfg=cfg, ae=ae, config=spec)
    pcfg = tflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32")
    pipe = tpipeline.FluxPipeline("flux-dev", model=to_torch(params), model_cfg=pcfg, ae=to_torch(ae), config=spec)
    return jpipe, pipe


def _encode_means(monkeypatch, jpipe):
    """Both pipelines encode to the mean, so that their latents can be compared."""
    jpipe._jit_ae_encode = jax.jit(lambda p, x, key: jae.ae_encode(p, TINY_AE_PARAMS, x, None))
    monkeypatch.setattr(tpipeline, "ae_encode", lambda p, c, x, generator: tae.ae_encode(p, c, x, None))


@pytest.mark.parametrize("strength,steps", [(0.6, 28), (0.25, 10), (1.0, 4), (0.0, 4)])
def test_preprocess_latent_mixes_and_cuts_like_jax(models, monkeypatch, strength, steps):
    jpipe, pipe = _pipelines(models)
    _encode_means(monkeypatch, jpipe)
    noise = np.random.default_rng(8).normal(size=(2, 4, 8, 8)).astype(np.float32)
    jpipe.get_noise = lambda *a, **kw: jnp.asarray(noise)
    pipe.get_noise = lambda *a, **kw: t(noise)
    init = _image(4, 80, 72)
    xa, ta = jpipe.preprocess_latent(init, 64, 64, steps, strength, jax.random.PRNGKey(0), 2)
    xb, tb = pipe.preprocess_latent(init, 64, 64, steps, strength, torch.Generator(), 2)
    assert tb == list(ta) and len(tb) == steps + 1 - int((1 - strength) * steps)
    assert xb.shape == xa.shape == (2, 4, 8, 8)
    np.testing.assert_allclose(xb.numpy(), np.asarray(xa), rtol=1e-5, atol=1e-5)


def test_preprocess_latent_draws_noise_then_the_encoder_sample(models):
    """The request's generator draws the noise first and the encoder's ε second."""
    _, pipe = _pipelines(models)
    init = _image(5, 64, 64)
    x, timesteps = pipe.preprocess_latent(init, 64, 64, 10, 0.6, torch.Generator().manual_seed(9), 1)
    gen = torch.Generator().manual_seed(9)
    noise = pipe.get_noise(1, 64, 64, gen)
    nhwc = torch.from_numpy(init.astype(np.float32) / 127.5 - 1.0)[None]
    z = tae.ae_encode(pipe.ae_params, TINY_AE_PARAMS, nhwc, gen).permute(0, 3, 1, 2)
    t0 = timesteps[0]
    assert len(timesteps) == 7
    torch.testing.assert_close(x, t0 * noise + (1 - t0) * z, rtol=0, atol=0)


def test_tiny_img2img_generate_matches_jax(models, monkeypatch):
    """An init image at strength 0.5 over 4 steps: both pipelines from the same noise,
    the same encoded mean and the same text, their final latents to 1e-4 in norm."""
    jpipe, pipe = _pipelines(models)
    _encode_means(monkeypatch, jpipe)
    r = np.random.default_rng(10)
    noise = r.normal(size=(1, 4, 8, 8)).astype(np.float32)
    vec = r.normal(size=(1, TINY_FLUX_PARAMS.vec_in_dim)).astype(np.float32)
    txt = r.normal(size=(1, 6, TINY_FLUX_PARAMS.context_in_dim)).astype(np.float32)
    for p, to in ((jpipe, jnp.asarray), (pipe, t)):
        p.get_noise = lambda *a, to=to, **kw: to(noise)
        p._encode_prompts = lambda prompts, to=to: {q: (to(vec), to(txt)) for q in prompts}
    seen = []
    decode = jpipe.vae_decode
    jpipe.vae_decode = lambda lat, h, w: (seen.append(np.asarray(lat)), decode(lat, h, w))[1]
    buf = io.BytesIO()
    Image.fromarray(_image(6, 96, 64)).save(buf, format="PNG")
    init = base64.b64encode(buf.getvalue()).decode()
    jpipe.generate("a cat", 64, 64, 4, seed=1, init_image=init, strength=0.5, silent=True)
    out = pipe.generate("a cat", 64, 64, 4, seed=1, init_image=init, strength=0.5, silent=True)
    b = pipe.last_latents.numpy()
    assert b.shape == seen[0].shape == (1, 16, TINY_FLUX_PARAMS.in_channels) and np.isfinite(b).all()
    assert float(np.linalg.norm(b - seen[0]) / np.linalg.norm(seen[0])) < 1e-4
    assert pipe.timings["encode_seconds"] > 0 and Image.open(out).size == (64, 64)
