"""The denoise loop (``sampling.py``): schedule steps over the seconds of the loop,
summed over the answered requests (``timings["denoise_seconds"]`` ends in a device
sync; a request's steps are its ``denoise_it_per_s`` times those seconds)."""


def read(run):
    ts = [r.kept["timings"] for r in run.records if r.ok and "denoise_seconds" in r.kept.get("timings", {})]
    seconds = sum(t["denoise_seconds"] for t in ts)
    steps = sum(round(t["denoise_it_per_s"] * t["denoise_seconds"]) for t in ts)
    return steps / seconds if seconds > 0 else None
