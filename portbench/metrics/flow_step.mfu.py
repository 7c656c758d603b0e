"""The flow model (blocks and extras compiled): the least time of the evaluations'
work, each operation at the card's peak for its precision (the family's
``evaluation_ms`` at each request's own length), over the seconds of the denoise
loops, in percent."""


def read(run):
    timed = run.timed(run.records)
    seconds = sum(r.kept["timings"]["denoise_seconds"] for r in timed)
    if seconds <= 0:
        return None
    least_ms = sum(run.evaluations(r) * run.family.evaluation_ms(run.spec, r.body) for r in timed)
    return 100.0 * least_ms / 1e3 / seconds
