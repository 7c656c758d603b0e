"""VAE decode and JPEG (``pipeline.py:vae_decode`` and ``into_bytes``): the mean of the
pipeline's ``timings["decode_seconds"]``, which ends in host bytes, in milliseconds."""


def read(run):
    xs = [r.kept["timings"]["decode_seconds"] for r in run.records
          if r.ok and "decode_seconds" in r.kept.get("timings", {})]
    return 1e3 * sum(xs) / len(xs) if xs else None
