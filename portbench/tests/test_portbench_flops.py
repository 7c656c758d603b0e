"""The work counted from the configurations' shapes."""

import json
from pathlib import Path

import pytest

from portbench import flops

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def params(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["spec"]["params"]


@pytest.mark.parametrize("config,txt,linear_t,attn_t", [
    ("flux-dev-fp8", 512, 59.49, 14.87), ("flux-schnell-fp8", 256, 56.18, 13.27)])
def test_evaluation_work_at_1024(config, txt, linear_t, attn_t):
    p = params(config)
    l_img, l_joint = flops.lengths(p, 1024, 1024, txt)
    assert (l_img, l_joint) == (4096, 4096 + txt)
    assert flops.block_linear_flops(p, l_img, txt) / 1e12 == pytest.approx(linear_t, abs=0.005)
    assert flops.block_linear_flops(p, l_img, txt) == 57 * 2 * 113_246_208 * l_joint
    assert flops.attention_flops(p, l_joint) / 1e12 == pytest.approx(attn_t, abs=0.005)


def test_least_times():
    p = params("flux-dev-fp8")
    # 59.49 TFLOP at the fp8 peak and 14.87 at bf16: 30.06 + 15.04 ms, and the small rest
    assert flops.evaluation_ms(p, 4096, 512) == pytest.approx(45.1, abs=0.1)
    # every fp8 linear is bound by its operations but the M = 1 modulation products
    mod_ms = sum(flops.bound(2 * k * n, k * n + 2 * n, flops.PEAK_FP8_FLOPS)[0]
                 for name, m, k, n in flops.block_linears(p, 4096, 512) if name == "mod")
    assert flops.fp8_linears_ms(p, 4096, 512) == pytest.approx(30.06 + mod_ms, abs=0.01)
    assert len(list(flops.block_linears(p, 4096, 512))) == 19 * 10 + 38 * 3
    ms, by = flops.attention_bound(24, 4608)
    assert by == "operations" and ms == pytest.approx(14.87e12 / 57 / 989e12 * 1e3, rel=1e-3)
