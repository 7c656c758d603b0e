"""The compiled forward (``models/flux.py:Compiled``, the ``aot_eager`` backend of
test_torch_compile.py) against JAX's ``flux_apply`` on the CPU, at the parity tests'
tolerance: a relative norm of 1e-4 in fp32, the JAX side through its Pallas kernel in
interpret mode as the JAX tests run it, the port through its kernels' plain versions,
both rounding p to bf16 before P·V (test_torch_flux.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_fp8_api_tpu import calibration as jcal
from flux_fp8_api_tpu.models import flux as jflux
from flux_fp8_api_tpu_torch.models import flux as tflux

from .helpers import TINY_FLUX_PARAMS
from .test_torch_compile import ALL, _compile_on_the_cpu, _rel, graphs, per_function, port_forward  # noqa: F401
from .test_torch_flux import make_inputs as flux_inputs
from .torch_parity import numpy_flux_params, to_torch

torch.set_num_threads(1)


def _jax_tier(kind):
    """JAX's tiny flux at ``kind`` with its calibrated scales and the inputs of the
    port's parity tests of that tier: test_torch_flux.py's float and fp8 forwards
    (fp8 calibrated on the inputs it runs, where no e5m2 cast rounds differently on
    the two sides), test_torch_quant_tiers.py's int8/int4 (two trials, int4 with its
    embedders, gigaquant's rules) → (cfg, params, inputs)."""
    cfg = jflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32", use_pallas=True)

    def amaxes(params, x):
        return jflux.flux_apply(params, cfg, **{k: jnp.asarray(v) for k, v in x.items()}, collect_amax=True)[1]

    if kind == "float":
        return cfg, numpy_flux_params(cfg), flux_inputs(0)
    if kind == "fp8":
        params = jflux.quantize_flux_tree(numpy_flux_params(cfg))
        return cfg, jcal.apply_input_scales(params, amaxes(params, flux_inputs(1))), flux_inputs(1)
    params, running = jflux.quantize_flux_tree(numpy_flux_params(cfg, seed=3), True, kind == "int4", kind=kind), None
    for seed in (1, 2):
        running = jcal.merge_amax(running, amaxes(params, flux_inputs(seed)))
        params = jcal.apply_input_scales_jit(params, running)
    return cfg, params, flux_inputs(0)


@pytest.mark.parametrize("kind", ["float", "fp8", "int8", "int4"])
def test_compiled_flux_matches_jax(kind):
    """The compiled forward against JAX's ``flux_apply`` (its Pallas kernel in
    interpret mode) within the parity tests' relative norm of 1e-4, on their model and
    inputs, JAX's calibrated tree converted (the same bytes and scales)."""
    jcfg, params, x = _jax_tier(kind)
    want = np.asarray(jflux.flux_apply(params, jcfg, **{k: jnp.asarray(v) for k, v in x.items()}))
    cfg = tflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32")
    got = port_forward(to_torch(params), cfg, x, ALL).numpy()
    assert got.shape == want.shape and _rel(got, want) < 1e-4
    assert graphs() == per_function(1)
