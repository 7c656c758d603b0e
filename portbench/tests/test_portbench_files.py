"""Every piece BENCHMARK.json names loads by its name, and the file keeps to the
contract's shape."""

import json
import re
from pathlib import Path

import pytest

from portbench import run
from portbench import generator
from portbench.generator import load_mix, request
from portbench.trace import in_family, kernel_family

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
HERE_TRAFFIC = ROOT / "portbench" / "traffic"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")


def test_benchmark_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert all(NAME.fullmatch(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    assert len({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}) == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        # a metric's cells report the end-to-end metric it moves
        assert set(m.get("workloads", cells)) <= set(e2e[m["moves"]].get("workloads", cells))
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cells_load_by_name(cell):
    c = run.load_cell(cell)
    spec, mix = c["spec"], c["mix"]
    conf = next(x for x in BENCH["configs"] if x["name"] == c["cell"]["config"])
    assert spec["reduced"] == conf["reduced"] and spec["name"] == c["cell"]["config"]
    # a reduced key is never one of the widths the family holds to the published ones
    assert not set(conf["reduced"]) & set(c["family"].widths(spec))
    shipped = json.loads((ROOT / spec["shipped_as"]).read_text())
    assert spec["spec"] == shipped  # the configuration as it ships
    assert (HERE_TRAFFIC / f"{mix['loop']}.py").is_file() and len(mix["word_list"]) == 270
    assert {"first_byte_p95_s", "setup_s"} <= {m["name"] for m in c["end_to_end"]}
    reported = {m["name"] for m in c["end_to_end"]}
    assert c["per_layer"] and all(m["moves"] in reported for m in c["per_layer"])
    a, b = request(7, 3, mix), request(7, 3, mix)
    assert a == b and a != request(8, 3, mix)
    assert {k: v for k, v in request(2**40 + 1, 0, mix).items() if k not in ("prompt", "seed")} == \
        {**mix["body"], **generator.shapes(mix)[0]}
    c["family"].check_body(a)  # the reference models every field the mix sends


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_load_and_find_nothing_without_records(metric):
    c = run.load_cell("dev-1024")
    assert run.read_metric(metric, run.RunData(c["family"], c["spec"], c["mix"])) is None


@pytest.mark.parametrize("family", ["gemm_fp8", "attention_k1"])
def test_kernel_families_load(family):
    fam = kernel_family(family)
    assert fam["include"] and isinstance(fam.get("exclude", []), list)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_published_widths(config):
    conf = next(c for c in BENCH["configs"] if c["name"] == config)
    spec = json.loads((ROOT / conf["file"]).read_text())
    family = run.load_family(spec["family"])
    assert family.widths(spec) == family.PUBLISHED[conf["source"]]
    mix = load_mix("closed1-1024sq-28step")
    assert generator.shapes(mix) == [{"width": 1024, "height": 1024, "num_steps": 28}]


def test_the_flux_family_holds_the_published_widths():
    family = run.load_family("flux")
    for widths in family.PUBLISHED.values():
        p = widths["params"]
        assert (p["hidden_size"], p["num_heads"], p["depth"], p["depth_single_blocks"]) == (3072, 24, 19, 38)
        assert widths["t5"] == {"vocab_size": 32128, "d_model": 4096, "d_ff": 10240, "num_layers": 24,
                                "num_heads": 64, "d_kv": 64, "relative_attention_num_buckets": 32,
                                "relative_attention_max_distance": 128, "layer_norm_epsilon": 1e-6}
        assert (widths["clip"]["hidden_size"], widths["clip"]["num_layers"], widths["clip"]["vocab_size"]) == \
            (768, 12, 49408)


# kernel names read from traced runs of both cells on an H100 (the fp8 GEMMs, a bf16
# GEMM of the text path, float32 GEMMs, a cast whose template names an fp8 type), and
# the fp8 xmma and CUTLASS names cuBLAS and CUTLASS give
GEMM_FP8_NAMES = [
    ("nvjet_qrtst_192x192_128x4_1x2_h_bz_coopB_bias_TNN", True),
    ("nvjet_qrtst_128x8_128x12_4x1_v_bz_bias_TNT", True),
    ("sm90_xmma_gemm_e4m3e4m3_e4m3f32_f32_tn_n_tilesize128x128x128_cublas", True),
    ("cutlass3x_sm90_tensorop_gemm_e4m3_e5m2_f32_bf16_bf16_128x128x128_1x1x1_0_tnn_align16", True),
    ("nvjet_tst_128x64_64x8_1x2_h_bz_TNT", False),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_warpsize2x2x1_ffma_aligna4_alignc4", False),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nt_align1>(cutlass_80_simt_sgemm_256x128_8x4_nt_align1"
     "::Params)", False),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::"
     "{lambda()#3}::operator()() const::{lambda()#14}::operator()() const::{lambda(c10::Float8_e4m3fn)#1}>", False),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::MulFunctor<float>, "
     "std::array<char*, 3ul> >(int, c10::Float8_e5m2 const*)", False),
]


@pytest.mark.parametrize("name,member", GEMM_FP8_NAMES)
def test_gemm_fp8_family_takes_fp8_gemms_alone(name, member):
    assert in_family(name, kernel_family("gemm_fp8")) is member


@pytest.mark.parametrize("name,member", [
    ("(anonymous namespace)::qknorm_attention_kernel(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "(anonymous namespace)::Args)", True),
    ("triton_poi_fused_cat_permute_qknorm_attention_view_5", False),
    ("void (anonymous namespace)::rope_rotate_kernel<false>((anonymous namespace)::Job, (anonymous namespace)::Job, "
     "int)", False),
])
def test_attention_k1_family_takes_k1_alone(name, member):
    assert in_family(name, kernel_family("attention_k1")) is member


def test_a_mix_sends_each_seed_the_same_shapes_in_another_order():
    mix = {**load_mix("closed1-1024sq-28step"),
           "shapes": [{"width": 1024, "height": 1024, "num_steps": 28, "weight": 2},
                      {"width": 768, "height": 768, "num_steps": 20, "weight": 1}]}
    orders = set()
    for seed in (3, 2**40 + 9, 77):
        sizes = [(b["width"], b["num_steps"]) for b in (request(seed, i, mix) for i in range(30))]
        for c in range(10):  # every cycle of three holds two 1024s and one 768
            assert sorted(sizes[3 * c:3 * c + 3]) == [(768, 20), (1024, 28), (1024, 28)]
        orders.add(tuple(sizes))
    assert len(orders) > 1
    assert generator.resolutions(mix) == [[1024, 1024], [768, 768]]


def test_the_loop_is_a_module_found_by_name():
    mix = load_mix("closed1-1024sq-4step")
    with pytest.raises(FileNotFoundError):
        generator.drive(1, 1, {**mix, "loop": "no-such-loop"}, count=1)
    with pytest.raises(ValueError):
        generator.drive(1, 1, {**mix, "clients": 2}, count=1)
