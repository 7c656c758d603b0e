"""The work counted from the configurations' shapes: the flux family's counts against
the card's peaks (``portbench/flops.py``)."""

import json
from pathlib import Path

import pytest

from portbench import flops, run

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
FLUX = run.load_family("flux")
BODY = {"width": 1024, "height": 1024, "num_steps": 28}


def spec(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.mark.parametrize("config,txt,linear_t,attn_t", [
    ("flux-dev-fp8", 512, 59.49, 14.87), ("flux-schnell-fp8", 256, 56.18, 13.27)])
def test_evaluation_work_at_1024(config, txt, linear_t, attn_t):
    s = spec(config)
    p = s["spec"]["params"]
    l_img, l_txt = FLUX.lengths(s, BODY)
    assert (l_img, l_txt) == (4096, txt)
    assert FLUX.block_linear_flops(p, l_img, txt) / 1e12 == pytest.approx(linear_t, abs=0.005)
    assert FLUX.block_linear_flops(p, l_img, txt) == 57 * 2 * 113_246_208 * (l_img + l_txt)
    assert FLUX.attention_flops(p, l_img + l_txt) / 1e12 == pytest.approx(attn_t, abs=0.005)


def test_least_times():
    s = spec("flux-dev-fp8")
    p = s["spec"]["params"]
    # 59.49 TFLOP at the fp8 peak and 14.87 at bf16: 30.06 + 15.04 ms, and the small rest
    assert FLUX.evaluation_ms(s, BODY) == pytest.approx(45.1, abs=0.1)
    # every fp8 linear is bound by its operations but the M = 1 modulation products
    mod_ms = sum(flops.bound(2 * k * n, k * n + 2 * n, flops.PEAK_FP8_FLOPS)[0]
                 for name, m, k, n in FLUX.block_linears(p, 4096, 512) if name == "mod")
    assert FLUX.fp8_linears_ms(s, BODY) == pytest.approx(30.06 + mod_ms, abs=0.01)
    assert len(list(FLUX.block_linears(p, 4096, 512))) == 19 * 10 + 38 * 3
    ms, by = flops.attention_bound(24, 4608)
    assert by == "operations" and ms == pytest.approx(14.87e12 / 57 / 989e12 * 1e3, rel=1e-3)
    assert FLUX.attention_ms(s, BODY) == pytest.approx(57 * ms, rel=1e-12)
