"""Compiled dispatch (the program's ``Compiled``): of the function selections the
window's denoise loops made, the share that ran a graph already built, in percent:
100 × (Σ ``compiled_calls`` − Σ ``graphs_built``) / (Σ ``compiled_calls`` + Σ
``eager_calls``), from each answered request's ``timings`` (the program's counters'
deltas over its loop). A bucket run eagerly past ``MAX_COMPILED_BUCKETS``, or a graph
built in the window, lowers it."""

KEYS = ("compiled_calls", "graphs_built", "eager_calls")


def read(run):
    ts = [r.kept["timings"] for r in run.records if r.ok and all(k in r.kept.get("timings", {}) for k in KEYS)]
    compiled, built, eager = (sum(t[k] for t in ts) for k in KEYS)
    return 100.0 * (compiled - built) / (compiled + eager) if compiled + eager > 0 else None
