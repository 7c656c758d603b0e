"""The flow model (``models/flux.py``, blocks and extras compiled): the least time of
the evaluations' work, each operation at the card's peak for its precision
(``flops.evaluation_ms`` at each request's own length), over the seconds of the
denoise loops, in percent."""

from portbench import flops


def read(run):
    timed = run.timed(run.records)
    seconds = sum(r.kept["timings"]["denoise_seconds"] for r in timed)
    if seconds <= 0:
        return None
    least_ms = sum(run.evaluations(r) * flops.evaluation_ms(run.params, run.lengths(r)[0], run.txt_len) for r in timed)
    return 100.0 * least_ms / 1e3 / seconds
