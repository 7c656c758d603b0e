"""The context path of an editing request (``pipeline.py:prepare_context``): the mean
of the program's ``context`` span over the window's answered requests that brought a
context image (``timings["context_seconds"]``: decode, resize, VAE encode and pack,
ending in a device sync), in milliseconds. A program without the span reports nothing."""


def read(run):
    xs = [r.kept["timings"]["context_seconds"] for r in run.records
          if r.ok and "context_seconds" in r.kept.get("timings", {})]
    return 1e3 * sum(xs) / len(xs) if xs else None
