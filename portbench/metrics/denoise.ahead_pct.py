"""The denoise loop (``sampling.py``) ahead of the card: of the window's answered
requests' schedule steps after their first, the share whose enqueue began while the
card still ran the step before, in percent: 100 × Σ ``steps_ahead`` / Σ (steps − 1)
(``timings["steps_ahead"]``, ``sampling.Lead``; a request's steps are its
``denoise_it_per_s`` times its ``denoise_seconds``). None where the program has no such
counter."""


def read(run):
    ts = [r.kept["timings"] for r in run.records
          if r.ok and all(k in r.kept.get("timings", {}) for k in ("steps_ahead", "denoise_seconds"))]
    ahead = sum(t["steps_ahead"] for t in ts)
    after_first = sum(round(t["denoise_it_per_s"] * t["denoise_seconds"]) - 1 for t in ts)
    return 100.0 * ahead / after_first if after_first > 0 else None
