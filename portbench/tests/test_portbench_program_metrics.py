"""The readers of the program's own spans and counters, on hand-built records, and the
trace readers untouched by the program's ``flux.`` spans in a profile."""

from types import SimpleNamespace

import pytest

from portbench import run
from portbench.generator import Record
from portbench.trace import read_profile

NEW = ("text.encode_ms", "flow.compiled_pct", "http.reply_ms", "http.reply_writes")


def _cell():
    return run.load_cell("dev-1024")


def _record(i, status=200, **timings):
    body = {"width": 1024, "height": 1024, "num_steps": 28, "prompt": "p", "seed": i}
    return Record(i, body, sent=10.0 * i, done=10.0 * i + 4.0, status=status, payload=b"x" * 100,
                  kept={"timings": {"denoise_seconds": 2.7, "denoise_it_per_s": 28 / 2.7, "decode_seconds": 0.15,
                                    **timings}, "server_seconds": 3.0},
                  first_byte=10.0 * i + 3.0)


def _read(name, records, profiled=(), trace=None):
    c = _cell()
    data = run.RunData(c["family"], c["spec"], c["mix"], list(records), list(profiled), trace)
    return run.read_metric(name, data)


def test_text_encode_ms_is_the_mean_over_requests_that_encoded():
    recs = [_record(0, text_seconds=0.040), _record(1), _record(2, text_seconds=0.070),
            _record(3, status=500, text_seconds=9.0)]
    assert _read("text.encode_ms", recs) == pytest.approx(55.0)
    assert _read("text.encode_ms", [_record(0)]) is None


def test_flow_compiled_pct_counts_graphs_built_and_eager_calls_against_it():
    warm = dict(compiled_calls=112, graphs_built=0, eager_calls=0)
    assert _read("flow.compiled_pct", [_record(0, **warm), _record(1, **warm)]) == pytest.approx(100.0)
    recs = [_record(0, **warm), _record(1, compiled_calls=100, graphs_built=4, eager_calls=12)]
    # (212 - 4) / (212 + 12)
    assert _read("flow.compiled_pct", recs) == pytest.approx(100.0 * 208 / 224)
    assert _read("flow.compiled_pct", [_record(0)]) is None


def test_reply_readers_difference_the_totals_around_the_window():
    recs = [_record(0, replies=5, reply_seconds=7.0, reply_writes=30_000),
            _record(1, replies=6, reply_seconds=8.5, reply_writes=36_100),
            _record(2, status=500),
            _record(3, replies=8, reply_seconds=11.2, reply_writes=48_000)]
    assert _read("http.reply_ms", recs) == pytest.approx(1e3 * 4.2 / 3)
    assert _read("http.reply_writes", recs) == pytest.approx(18_000 / 3)
    assert _read("http.reply_ms", recs[:1]) is None and _read("http.reply_writes", recs[:1]) is None
    # the first profiled request's totals hold the window's last reply too
    after = [_record(4, replies=9, reply_seconds=12.0, reply_writes=54_500)]
    assert _read("http.reply_ms", recs, after) == pytest.approx(1e3 * 5.0 / 4)
    assert _read("http.reply_writes", recs, after) == pytest.approx(24_500 / 4)


@pytest.mark.parametrize("name", NEW)
def test_new_readers_find_nothing_in_records_of_a_program_without_them(name):
    assert _read(name, [_record(0), _record(1)]) is None


class _Events:
    """A profile's events as ``read_profile`` reads them."""

    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _event(name, start, end, cuda=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if cuda else DeviceType.CPU, is_user_annotation=False)


BENCH = [_event("portbench.request", 0, 1000), _event("portbench.handler", 10, 900),
         _event("portbench.prepare", 20, 60), _event("portbench.denoise", 60, 500),
         _event("portbench.vae_decode", 600, 700), _event("portbench.into_bytes", 700, 880)]
KERNELS = [_event("nvjet_qrtst_192x192_128x4_1x2_h_bz_coopB_bias_TNN", 70, 300, cuda=True),
           _event("(anonymous namespace)::qknorm_attention_kernel(CUtensorMap_st)", 310, 560, cuda=True),
           _event("void at::native::vectorized_elementwise_kernel<4>", 610, 690, cuda=True)]
PROGRAM = [_event("flux.request", 5, 905), _event("flux.generate", 12, 890), _event("flux.denoise", 58, 590),
           _event("flux.step", 62, 320), _event("flux.dispatch", 62, 68), _event("flux.update", 305, 318),
           _event("flux.reply", 910, 990)]


def test_program_spans_leave_the_trace_and_its_readers_as_they_were():
    plain, both = read_profile(_Events(BENCH + KERNELS)), read_profile(_Events(BENCH + PROGRAM + KERNELS))
    assert (both.spans, both.kernels, both.start, both.end) == (plain.spans, plain.kernels, plain.start, plain.end)
    assert both.idle_gaps() == plain.idle_gaps() and both.busy_s() == plain.busy_s()
    for name in ("handler", "denoise", "request"):
        assert both.busy_within(name) == plain.busy_within(name)
    recs = [_record(i, text_seconds=0.05) for i in range(3)]
    c = _cell()
    for metric in (m["name"] for m in c["per_layer"]):
        a = run.read_metric(metric, run.RunData(c["family"], c["spec"], c["mix"], recs, recs[:1], plain))
        b = run.read_metric(metric, run.RunData(c["family"], c["spec"], c["mix"], recs, recs[:1], both))
        assert a == b, metric
