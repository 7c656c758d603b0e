"""Shared pieces of the JAX ↔ PyTorch parity tests (tests/test_torch_*.py), and the
BFL checkpoint writer that they and ``chip_smoke.py`` use.

Inputs are drawn with numpy from a seed and handed to both packages; JAX parameter
trees are flattened here into nested dicts of numpy arrays, each JAX ``Linear`` as a
dict plus ``"kind"``, which is the form ``flux_fp8_api_tpu_torch.utils.convert`` takes.
JAX is imported inside the functions that need it: ``write_bfl_checkpoint`` runs
where JAX is not installed.
"""

import dataclasses

import numpy as np
import torch


def flatten(tree):
    """JAX parameter pytree → nested dict/list of numpy arrays."""
    from flux_fp8_api_tpu.ops.quant import Linear as JaxLinear

    if isinstance(tree, JaxLinear):
        out = {"kind": tree.kind}
        for f in dataclasses.fields(tree):
            value = getattr(tree, f.name)
            if f.name != "kind" and value is not None:
                out[f.name] = np.asarray(value)
        return out
    if isinstance(tree, dict):
        return {k: flatten(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [flatten(v) for v in tree]
    if tree is None:
        return None
    return np.asarray(tree)


def to_torch(tree, device="cpu"):
    """JAX parameter pytree → the port's modules, through the converter."""
    from flux_fp8_api_tpu_torch.utils.convert import convert

    return convert(flatten(tree), device)


def numpy_flux_params(cfg, seed: int = 0):
    """The JAX flux parameter tree filled from numpy (the JAX package's eager init
    takes seconds): kernels U(±√(3/in)) as the JAX init draws them, biases U(±1/√in),
    q/k-norm scales 1 + 0.1·N(0, 1) so that they matter."""
    import jax
    import jax.numpy as jnp

    from flux_fp8_api_tpu.models.flux import init_flux_params

    shapes = jax.eval_shape(lambda k: init_flux_params(k, cfg, jnp.float32), jax.random.PRNGKey(0))
    r = np.random.default_rng(seed)

    def fill(path, s):
        name = str(path[-1])
        if "kernel" in name:
            bound = (3.0 / s.shape[-2]) ** 0.5
            return r.uniform(-bound, bound, size=s.shape).astype(np.float32)
        if "bias" in name:
            return r.uniform(-0.1, 0.1, size=s.shape).astype(np.float32)
        return (1.0 + 0.1 * r.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def numpy_ae_params(cfg, seed: int = 1):
    """The JAX VAE's parameter tree (HWIO conv kernels) filled from numpy: the JAX
    package's eager init takes seconds per call on the CPU."""
    import jax
    import jax.numpy as jnp

    from flux_fp8_api_tpu.models.autoencoder import init_autoencoder_params

    shapes = jax.eval_shape(lambda k: init_autoencoder_params(k, cfg, jnp.float32), jax.random.PRNGKey(0))
    r = np.random.default_rng(seed)

    def fill(s):
        x = r.normal(size=s.shape).astype(np.float32)
        if len(s.shape) == 4:  # He-scaled conv kernel
            return x * np.float32((2.0 / np.prod(s.shape[:-1])) ** 0.5)
        return 1.0 + 0.1 * x  # norm weights and biases

    return jax.tree.map(fill, shapes)


def t(x, dtype=torch.float32):
    """numpy → torch CPU tensor."""
    return torch.from_numpy(np.array(x, order="C")).to(dtype)


def amax_leaves(tree, prefix=""):
    """Flatten an amax tree (dicts of scalars / (depth,) arrays) to {dotted: numpy}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(amax_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, dtype=np.float32)
    return out


def write_bfl_checkpoint(path, model, cfg, reference_fp8=False, input_scale=None):
    """Write the port's float flux model as a BFL safetensors file: torch (out, in)
    weights under the BFL names, with the q/k rows of every qkv and linear1 and the
    qk-norm scales put back into the reference's interleaved rope layout (the inverse
    of the loader's deinterleave). With ``reference_fp8`` the block linears are
    written as the reference's prequantized F8Linear serialization
    (float8_quantize.py:91-193): ``float8_data`` e4m3, ``scale`` and its reciprocal,
    the 1-element ``weight`` stub, and, when ``input_scale`` is given, that tuned input
    scale with its reciprocal. Tensors are copied to the host one at a time."""
    from flux_fp8_api_tpu_torch.ops.quant import Linear, quantize_linear_fp8
    from flux_fp8_api_tpu_torch.ops.rope import deinterleave_permutation
    from flux_fp8_api_tpu_torch.utils.checkpoint import bfl_key, qkv_out_permutation
    from flux_fp8_api_tpu_torch.utils.safetensors_io import save_safetensors

    hd = cfg.head_dim
    inverse = {
        "img_attn_qkv": np.argsort(qkv_out_permutation(cfg.hidden_size, hd)),
        "txt_attn_qkv": np.argsort(qkv_out_permutation(cfg.hidden_size, hd)),
        "linear1": np.argsort(qkv_out_permutation(cfg.hidden_size, hd, extra=cfg.mlp_hidden)),
    }
    norm_inverse = np.argsort(deinterleave_permutation(hd))
    sd = {}

    def put(path, block, value):
        key = bfl_key(path, block)
        name = path[-1]
        if not isinstance(value, Linear):  # a qk-norm scale
            sd[key] = value[torch.as_tensor(norm_inverse, device=value.device)]
            return
        weight, bias = value.weight, value.bias
        if name in inverse:
            perm = torch.as_tensor(inverse[name], device=weight.device)
            weight, bias = weight[perm], (None if bias is None else bias[perm])
        if reference_fp8 and block is not None:
            q = quantize_linear_fp8(weight, None)
            sd[f"{key}.float8_data"] = q.q
            sd[f"{key}.scale"] = q.w_scale
            sd[f"{key}.scale_reciprocal"] = q.w_scale_inv
            sd[f"{key}.weight"] = torch.zeros(1)
            if input_scale is not None:
                sd[f"{key}.input_scale"] = torch.tensor(input_scale, dtype=torch.float32)
                sd[f"{key}.input_scale_reciprocal"] = 1.0 / torch.tensor(input_scale, dtype=torch.float32)
        else:
            sd[f"{key}.weight"] = weight
        if bias is not None:
            sd[f"{key}.bias"] = bias

    for key, value in model.items():
        if isinstance(value, torch.nn.ModuleList):
            for i, blk in enumerate(value):
                for name, leaf in blk.items():
                    put((key, name), i, leaf)
        elif isinstance(value, Linear):
            put((key,), None, value)
        elif value is not None:
            for name, leaf in value.items():
                put((key, name), None, leaf)
    save_safetensors(path, sd)
    return sd
