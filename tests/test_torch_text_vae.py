"""The port's text encoders, emphasis, toy tokenizer and VAE decode against the JAX
package's, through the converter, on the CPU in fp32.

Tolerances: T5, CLIP and the weighted embeddings agree to rtol/atol 1e-5 (fp32
matmuls and softmax, summation order only). The VAE decode goes through a dozen
convolutions whose fp32 sums run in another order: rtol 1e-4, atol 1e-4. Weight-only
fp8 bytes must be identical; tokenizer ids and decoded text must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_fp8_api_tpu import emphasis as jemph
from flux_fp8_api_tpu.models import autoencoder as jae
from flux_fp8_api_tpu.models import clip as jclip
from flux_fp8_api_tpu.models import t5 as jt5
from flux_fp8_api_tpu.utils.loader import _toy_tokenizer as jax_toy_tokenizer
from flux_fp8_api_tpu_torch import emphasis as temph
from flux_fp8_api_tpu_torch.models import autoencoder as tae
from flux_fp8_api_tpu_torch.models import clip as tclip
from flux_fp8_api_tpu_torch.models import t5 as tt5
from flux_fp8_api_tpu_torch.models.conditioner import TextEncoder
from flux_fp8_api_tpu_torch.utils.loader import ToyTokenizer

from .helpers import TINY_AE_PARAMS, toy_tokenizer
from .torch_parity import numpy_ae_params, t, to_torch

torch.set_num_threads(1)

T5_CFG = dict(vocab_size=64, d_model=48, d_ff=96, num_layers=2, num_heads=3, d_kv=16)
CLIP_CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
                max_position_embeddings=77, eos_token_id=2)


def ids(seed, shape, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


@pytest.fixture(scope="module")
def t5_pair():
    cfg = jt5.T5Config(**T5_CFG)
    return cfg, jt5.init_t5_params(jax.random.PRNGKey(11), cfg, jnp.float32)


@pytest.fixture(scope="module")
def clip_pair():
    cfg = jclip.CLIPConfig(**CLIP_CFG)
    return cfg, jclip.init_clip_params(jax.random.PRNGKey(10), cfg, jnp.float32)


def test_t5_encode_matches_jax(t5_pair):
    cfg, params = t5_pair
    x = ids(0, (2, 20))
    a = np.asarray(jt5.t5_encode(params, cfg, jnp.asarray(x), jnp.float32))
    b = tt5.t5_encode(to_torch(params), tt5.T5Config(**T5_CFG), torch.from_numpy(x).long(), torch.float32)
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-5)


def test_t5_qfloat8_bytes_and_encode_match_jax(t5_pair):
    cfg, params = t5_pair
    qa = jt5.quantize_t5_params(params, "qfloat8")
    qb = tt5.quantize_t5_params(to_torch(params), "qfloat8")
    conv = to_torch(qa)
    for i, blk in enumerate(qb["blocks"]):
        for name in ("q", "wo", "wi_1"):
            assert blk[name].kind == "wo_fp8"
            assert torch.equal(blk[name].q.view(torch.uint8), conv["blocks"][i][name].q.view(torch.uint8))
            assert torch.equal(blk[name].w_scale_inv, conv["blocks"][i][name].w_scale_inv)
    x = ids(1, (1, 12))
    a = np.asarray(jt5.t5_encode(qa, cfg, jnp.asarray(x), jnp.float32))
    b = tt5.t5_encode(qb, tt5.T5Config(**T5_CFG), torch.from_numpy(x).long(), torch.float32)
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-5)
    # every tier the configs name is ported (tests/test_torch_quant_tiers.py); an
    # unknown one is refused, as in the JAX package
    with pytest.raises(KeyError):
        tt5.quantize_t5_params(to_torch(params), "qint3")


@pytest.mark.parametrize("eos", [2, 5])
def test_clip_encode_matches_jax(clip_pair, eos):
    cfg, params = clip_pair
    x = ids(2, (2, 16))
    x[:, 9] = eos
    jcfg = jclip.CLIPConfig(**{**CLIP_CFG, "eos_token_id": eos})
    a_h, a_p = jclip.clip_encode(params, jcfg, jnp.asarray(x), jnp.float32)
    b_h, b_p = tclip.clip_encode(to_torch(params), tclip.CLIPConfig(**{**CLIP_CFG, "eos_token_id": eos}),
                                 torch.from_numpy(x).long(), torch.float32)
    np.testing.assert_allclose(b_h.numpy(), np.asarray(a_h), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b_p.numpy(), np.asarray(a_p), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("prompt", [
    "a photo of a cat",
    "a (beautiful:1.3) [red] house on a hill, the sun . BREAK blue sky",
    "(unbalanced image of a dog",
    " ".join(["cat dog"] * 60),  # longer than one 77-token CLIP chunk
])
def test_weighted_text_embeddings_match_jax(t5_pair, clip_pair, prompt):
    from flux_fp8_api_tpu.models.conditioner import TextEncoder as JaxTextEncoder

    t5_cfg, t5_params = t5_pair
    clip_cfg, clip_params = clip_pair
    jclip_enc = JaxTextEncoder("clip", clip_params, clip_cfg, toy_tokenizer("clip"), 77, jnp.float32)
    jt5_enc = JaxTextEncoder("t5", t5_params, t5_cfg, toy_tokenizer("t5"), 32, jnp.float32)
    tclip_enc = TextEncoder("clip", to_torch(clip_params), tclip.CLIPConfig(**CLIP_CFG),
                            toy_tokenizer("clip"), 77, torch.float32, device="cpu")
    tt5_enc = TextEncoder("t5", to_torch(t5_params), tt5.T5Config(**T5_CFG),
                          toy_tokenizer("t5"), 32, torch.float32, device="cpu")
    a_vec, a_txt = jemph.get_weighted_text_embeddings(jclip_enc, jt5_enc, prompt, 2, t5_length=32)
    b_vec, b_txt = temph.get_weighted_text_embeddings(tclip_enc, tt5_enc, prompt, 2, t5_length=32)
    assert b_vec.shape == (2, 32) and b_txt.shape == (2, 32, 48)
    np.testing.assert_allclose(b_vec.numpy(), np.asarray(a_vec), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b_txt.numpy(), np.asarray(a_txt), rtol=1e-5, atol=1e-5)
    assert temph.parse_prompt_attention(prompt) == jemph.parse_prompt_attention(prompt)


def test_population_std_in_apply_weights():
    r = np.random.default_rng(4)
    emb = r.normal(size=(1, 6, 8)).astype(np.float32)
    toks = np.array([[5, 6, 2, 0, 0, 0]])
    w = np.array([1.0, 1.4, 1.0, 1.0, 0.8, 1.0], np.float32)
    a = jemph.apply_weights(jnp.asarray(toks), jnp.asarray(w), jnp.asarray(emb), 2)
    b = temph.apply_weights(torch.from_numpy(toks), t(w), t(emb), 2)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("style,max_length", [("clip", 77), ("t5", 24)])
def test_toy_tokenizer_matches_jax_loader(style, max_length):
    """The port builds its hub-free tokenizer on the tokenizers backend alone; ids and
    decodes must equal the JAX loader's PreTrainedTokenizerFast."""
    a, b = jax_toy_tokenizer(style), ToyTokenizer(style)
    assert (b.bos_token_id, b.eos_token_id) == (a.bos_token_id, a.eos_token_id)
    prompts = ["a photo of a cat", "The sun , on a hill . unknownword", "tok7 tok200 <eos> red",
               " ".join(["blue sky"] * 30)]
    for p in prompts:
        assert b(p, add_special_tokens=False).input_ids == a(p, add_special_tokens=False).input_ids
        np.testing.assert_array_equal(
            b(p, truncation=True, max_length=max_length, padding="max_length", return_tensors="np").input_ids,
            a(p, truncation=True, max_length=max_length, padding="max_length", return_tensors="np").input_ids,
        )
        full = a(p).input_ids
        assert b(p).input_ids == full
        for skip in (True, False):
            assert b.decode(full, skip_special_tokens=skip, clean_up_tokenization_spaces=True) == \
                a.decode(full, skip_special_tokens=skip, clean_up_tokenization_spaces=True)


def test_ae_decode_matches_jax():
    params = numpy_ae_params(TINY_AE_PARAMS, seed=6)
    z = np.random.default_rng(5).normal(size=(1, 8, 6, TINY_AE_PARAMS.z_channels)).astype(np.float32)
    decode = jax.jit(lambda p, z: jae.ae_decode(p, TINY_AE_PARAMS, z))
    a = np.asarray(decode(params, jnp.asarray(z)))
    b = tae.ae_decode(to_torch(params), TINY_AE_PARAMS, t(z))
    assert b.shape == a.shape == (1, 64, 48, 3)
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=1e-4)


def test_ae_mid_attention_chunks_like_one_pass():
    """Above 4096 tokens the mid attention runs in query chunks; the result must equal
    one unchunked pass."""
    gen = torch.Generator().manual_seed(0)
    p = {"norm": {"weight": torch.ones(32), "bias": torch.zeros(32)}}
    for n in ("q", "k", "v", "proj_out"):
        p[n] = {"weight": torch.randn(32, 32, 1, 1, generator=gen) * 0.1, "bias": torch.zeros(32)}
    from flux_fp8_api_tpu_torch.utils.tree import ParamTree

    tree = ParamTree(p)
    x = torch.randn(1, 32, 64, 72, generator=gen)  # 4608 tokens → chunks of 2304
    out = tae._attn_block(tree, x)
    h = tae._group_norm(tree["norm"], x)
    q, k, v = (tae._conv(tree[n], h).reshape(1, 32, -1).transpose(1, 2) for n in ("q", "k", "v"))
    ref = torch.softmax(q @ k.transpose(1, 2) * 32**-0.5, -1) @ v
    ref = x + tae._conv(tree["proj_out"], ref.transpose(1, 2).reshape(1, 32, 64, 72))
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
