"""The port's quality measurements on the CPU: ``utils.fidelity`` (SSIM, PSNR) and
``bench_fidelity.latent_image`` against the JAX package's functions, the tiny runs of
``bench_fidelity`` and ``bench_cache`` and their JSON lines, the redrawn tiers of the
fidelity gate, and the sweep's policy table and evaluation counts against the JAX
sweep's.

Tolerances: SSIM and PSNR are the same float64 numpy on both sides, 1e-12; the latent
image is fp32 arithmetic over a channel mean whose summation order may differ, 1e-4 on
its 0-255 scale. A redrawn tier's weights must equal the quantization of the ground
truth's, byte for byte.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_fp8_api_tpu.utils import fidelity as jfidelity
from flux_fp8_api_tpu_torch import bench_cache, bench_fidelity
from flux_fp8_api_tpu_torch.models.flux import FluxStatic
from flux_fp8_api_tpu_torch.ops.quant import Linear, dequantize_kernel, FLOW_QUANTIZERS
from flux_fp8_api_tpu_torch.utils import fidelity as tfidelity

torch.set_num_threads(1)


def _images(seed, shape):
    r = np.random.default_rng(seed)
    a = r.uniform(0, 255, size=shape)
    return a, np.clip(a + r.normal(0, 80, size=shape), 0, 255)


@pytest.mark.parametrize("shape", [(64, 64), (48, 40, 3), (11, 11)])
def test_ssim_psnr_match_jax(shape):
    a, b = _images(sum(shape), shape)
    for x, y in ((a, b), (a, a), (a, a + 5.0), (a.astype(np.uint8), b.astype(np.float32))):
        assert tfidelity.ssim(x, y) == pytest.approx(jfidelity.ssim(x, y), abs=1e-12, rel=0)
        assert tfidelity.psnr(x, y) == pytest.approx(jfidelity.psnr(x, y), abs=1e-12, rel=0)
    assert tfidelity.ssim(a, a) == pytest.approx(1.0, abs=1e-12) and tfidelity.psnr(a, a) == float("inf")
    assert tfidelity.ssim(a, a + 5.0) > 0.95  # a small brightness shift barely moves SSIM
    assert 0 < tfidelity.ssim(a, b) < 0.9
    z = np.zeros(shape)
    assert tfidelity.psnr(z, z + 16.0) == pytest.approx(20 * np.log10(255 / 16), abs=1e-12)


def test_ssim_refuses_other_shapes():
    with pytest.raises(ValueError, match="shapes"):
        tfidelity.ssim(np.zeros((16, 16)), np.zeros((16, 17)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h_lat,w_lat", [(32, 32), (16, 24)])
def test_latent_image_matches_jax(h_lat, w_lat, dtype):
    import bench_fidelity as jbench  # the JAX package's root bench

    x = np.random.default_rng(h_lat + w_lat).normal(size=(1, (h_lat // 2) * (w_lat // 2), 64)).astype(np.float32)
    a = jbench.latent_image(jnp.asarray(x).astype(dtype), h_lat, w_lat)
    b = bench_fidelity.latent_image(torch.from_numpy(x).to(getattr(torch, dtype)), h_lat, w_lat)
    assert b.shape == a.shape == (h_lat, w_lat) and b.dtype == np.float32
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)
    assert float(b.min()) == 0.0 and float(b.max()) == pytest.approx(255.0)


def test_tiny_fidelity_run_prints_the_report(capsys):
    report = bench_fidelity.main(["--tiny"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(report))
    assert set(line) >= {"metric", "value", "unit", "gate", "pass", "detail", "psnr", "timings", "device", "card"}
    assert line["unit"] == "ssim" and line["gate"] == ">=0.95" and isinstance(line["pass"], bool)
    assert sorted(line["detail"]) == sorted(bench_fidelity.TIERS) == sorted(line["psnr"])
    assert line["value"] == line["detail"]["fp8_fast_accum"]
    assert line["pass"] == (min(line["detail"]["fp8"], line["detail"]["fp8_fast_accum"]) >= 0.95)
    assert all(-1 <= v <= 1 for v in line["detail"].values())
    assert (line["device"], line["card"]) == ("cpu", None)  # no card: no card line
    for key in ("bf16_denoise_s", "int4_draw_calibrate_s", "fp8_denoise_s"):
        assert line["timings"][key] > 0


def _leaves(model):
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, Linear):
            out[name] = m
    return out


@pytest.mark.parametrize("tier", ["fp8", "int8", "int4"])
def test_redrawn_tier_is_the_quantized_ground_truth(tier):
    """The fidelity gate redraws each tier from the seed of the bf16 ground truth: every
    quantized leaf equals the tier's quantizer applied to the ground truth's leaf, and
    the leaves the tier keeps in float (embedders, final layer) equal the ground truth's."""
    cfg = FluxStatic.from_params(bench_fidelity.TINY)
    truth = _leaves(bench_fidelity.draw_model(cfg, "cpu", seed=5))
    drawn = _leaves(bench_fidelity.draw_model(cfg, "cpu", seed=5, tier=tier))
    assert sorted(truth) == sorted(drawn)
    kinds = set()
    for name, lin in drawn.items():
        src = truth[name]
        kinds.add(lin.kind)
        if lin.kind == "float":
            assert name.startswith(("img_in", "txt_in", "time_in", "vector_in", "guidance_in", "final_layer"))
            assert torch.equal(lin.weight, src.weight) and torch.equal(lin.bias, src.bias)
            continue
        want = FLOW_QUANTIZERS[tier](src.weight, src.bias)
        assert torch.equal(lin.q.view(torch.uint8), want.q.view(torch.uint8)), name
        assert torch.equal(lin.w_scale, want.w_scale) and torch.equal(lin.bias, src.bias), name
        assert torch.equal(dequantize_kernel(lin), dequantize_kernel(want))
    assert kinds == {"float", tier}
    # the gate's calibration writes input scales in place
    model = bench_fidelity.draw_model(cfg, "cpu", seed=5, tier=tier)
    inputs, _, _ = bench_fidelity.make_inputs(cfg, 64, 64, 8, "cpu")
    bench_fidelity.calibrate(model, cfg, inputs)
    assert float(model["double_blocks"][0]["img_attn_qkv"].in_scale) != 1.0


def test_tier_cfg_sets_fast_accumulation():
    cfg = FluxStatic.from_params(bench_fidelity.TINY)
    assert [bench_fidelity.tier_cfg(cfg, t).fp8_fast_accum for t in bench_fidelity.TIERS] == [
        False, True, True, True]


def test_policies_are_the_jax_sweeps():
    import bench_cache as jbench  # the JAX package's root bench

    assert [(n, dataclasses.asdict(c)) for n, c in bench_cache.POLICIES] == [
        (n, dataclasses.asdict(c)) for n, c in jbench.POLICIES]


def test_bench_policies_filter(monkeypatch):
    monkeypatch.setenv("BENCH_POLICIES", "interval3, dynamic.4")
    assert [n for n, _ in bench_cache.selected_policies()] == ["interval3", "dynamic.4"]
    monkeypatch.delenv("BENCH_POLICIES")
    assert bench_cache.selected_policies() == bench_cache.POLICIES


@pytest.fixture(scope="module")
def tiny_sweep():
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = bench_cache.main(["--tiny"])
    return summary, [json.loads(line) for line in out.getvalue().strip().splitlines()]


def test_tiny_cache_sweep_prints_rows_and_summary(tiny_sweep):
    summary, lines = tiny_sweep
    rows, last = lines[:-1], lines[-1]
    assert last == json.loads(json.dumps(summary))
    assert [r["policy"] for r in rows] == ["uncached"] + [n for n, _ in bench_cache.POLICIES]
    assert rows[0]["evals"] == 8 and rows[0]["ssim_vs_uncached"] == 1.0
    for r in rows:
        assert set(r) == {"policy", "evals", "seconds", "it_per_s_effective", "ssim_vs_uncached"}
        assert 0 < r["evals"] <= 8 and r["seconds"] > 0 and -1 <= r["ssim_vs_uncached"] <= 1
        assert r["it_per_s_effective"] == pytest.approx(8 / r["seconds"])
    assert last["unit"] == "it/s-effective" and last["detail"]["rows"] == rows[1:]
    assert (last["device"], last["card"]) == ("cpu", None)
    eligible = [r for r in rows[1:] if r["ssim_vs_uncached"] >= 0.95]
    if eligible:
        best = max(eligible, key=lambda r: r["it_per_s_effective"])
        assert (last["best"], last["value"]) == (best["policy"], best["it_per_s_effective"])
        assert last["vs_uncached"] == pytest.approx(best["it_per_s_effective"] / rows[0]["it_per_s_effective"])


def test_tiny_sweep_interval_evals_match_jax(tiny_sweep, monkeypatch):
    """An interval policy's evaluations depend on the schedule alone, not on the model:
    the JAX scan, run over the same 8 steps with its model stubbed to a cheap function
    (a config no other test uses, so no compiled scan is shared), counts as the port's
    sweep does."""
    import jax

    from flux_fp8_api_tpu import sampling as jsampling
    from flux_fp8_api_tpu.models import flux as jflux
    from flux_fp8_api_tpu.utils.config import FluxParams

    _, lines = tiny_sweep
    port = {r["policy"]: r["evals"] for r in lines[:-1]}
    monkeypatch.setattr(jsampling, "flux_apply", lambda params, cfg, img, *a, **kw: -img)
    cfg = jflux.FluxStatic.from_params(FluxParams(
        in_channels=4, vec_in_dim=3, context_in_dim=5, hidden_size=8, mlp_ratio=1.0, num_heads=1,
        depth=0, depth_single_blocks=0, axes_dim=[2, 2, 4], theta=7, qkv_bias=False, guidance_embed=False))
    ts = jnp.linspace(1.0, 0.0, 9, dtype=jnp.float32)
    x = jnp.ones((1, 4, 4))  # every input but the latent, which the scan donates
    checked = 0
    for name, cache in bench_cache.POLICIES:
        if cache.mode != "interval":
            continue
        jcache = jsampling.CacheConfig(**dataclasses.asdict(cache))
        _, n = jsampling._denoise_scan_cached({}, cfg, jcache, jnp.ones((1, 4, 4)), x, x, x, x, ts,
                                              jnp.float32(3.5))
        assert int(jax.device_get(n)) == port[name], name
        checked += 1
    assert checked == 6
