"""Rates, tails and the trace's busy and idle time, from synthetic records."""

import pytest

from portbench import run
from portbench.generator import Record
from portbench.trace import Trace, family_kernels


def test_p95_is_linear_between_order_statistics():
    xs = [float(i) for i in range(1, 21)]  # 1 … 20
    assert run.p95(xs) == pytest.approx(19.05)
    assert run.p95([2.5]) == 2.5
    assert run.p95([1.0, 3.0]) == pytest.approx(2.9)


def test_rate_counts_every_request_over_the_whole_window():
    recs = [Record(i, {}, sent=10.0 + 3 * i, done=10.0 + 3 * i + 2.9, status=200, first_byte=10.0 + 3 * i + 1.5)
            for i in range(17)]
    window = recs[-1].done - recs[0].sent
    assert window == pytest.approx(50.9)
    assert len([r for r in recs if r.ok]) / window == pytest.approx(17 / 50.9)
    assert run.p95([r.first_byte - r.sent for r in recs]) == pytest.approx(1.5)


def test_trace_busy_idle_and_gap_labels():
    tr = Trace(kernels=[("a", 0, 10), ("b", 5, 20), ("gemm_e4m3", 30, 40), ("late", 95, 110)],
               spans=[("request", 0, 100), ("handler", 2, 98), ("into_bytes", 38, 90)], start=0, end=100)
    assert tr.busy_intervals() == [(0, 20), (30, 40), (95, 100)]
    assert tr.busy_s() == pytest.approx(35e-6)
    assert tr.window_s == pytest.approx(100e-6)
    gaps = dict(tr.idle_gaps())
    assert gaps["handler"] == pytest.approx(15e-6)  # 20-30 and 90-95
    assert gaps["into_bytes"] == pytest.approx(50e-6)  # 40-90
    assert "request" not in gaps

    assert sum(gaps.values()) == pytest.approx(tr.window_s - tr.busy_s())
    assert tr.kernel_seconds(lambda n: "e4m3" in n) == (pytest.approx(10e-6), 1)
    assert tr.top_kernels(1)[0][0] == "b"
    assert tr.top_kernels(None, lambda n: n != "b") == [("a", 10e-6, 1), ("gemm_e4m3", 10e-6, 1)]
    fams = family_kernels(tr)
    assert set(fams) == {"attention_k1", "gemm_fp8"} and fams["gemm_fp8"] == [("gemm_e4m3", 10e-6, 1)]
    # the handler's span, 2-98: busy 2-20, 30-40 and 95-98
    assert tr.busy_within("handler") == (pytest.approx(96e-6), pytest.approx(31e-6))
