"""Shared pieces of the JAX ↔ PyTorch parity tests (tests/test_torch_*.py).

Inputs are drawn with numpy from a seed and handed to both packages; JAX parameter
trees are flattened here into nested dicts of numpy arrays, each JAX ``Linear`` as a
dict plus ``"kind"``, which is the form ``flux_fp8_api_tpu_torch.utils.convert`` takes.
"""

import dataclasses

import numpy as np
import torch

from flux_fp8_api_tpu.ops.quant import Linear as JaxLinear


def flatten(tree):
    """JAX parameter pytree → nested dict/list of numpy arrays."""
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
