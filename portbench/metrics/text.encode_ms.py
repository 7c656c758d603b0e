"""The text encoders (``emphasis.py`` and the encoder models): the mean of the program's
``text`` span over the window's answered requests that encoded a prompt
(``timings["text_seconds"]``, absent on a conditioning-cache hit: the encoders, emphasis
and their offload moves), in milliseconds. Outside a profiler the span ends when the
host has enqueued the encoders' work, not in a device sync."""


def read(run):
    xs = [r.kept["timings"]["text_seconds"] for r in run.records
          if r.ok and "text_seconds" in r.kept.get("timings", {})]
    return 1e3 * sum(xs) / len(xs) if xs else None
