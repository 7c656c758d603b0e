"""HTTP layer (``api.py`` under uvicorn over ``server.py:PipelineServer``): the mean of
each answered request's client round trip less the seconds its handler spent in
generate (``PipelineServer.metrics["last_seconds"]``), in milliseconds."""


def read(run):
    xs = [r.seconds - r.kept["server_seconds"] for r in run.records
          if r.ok and r.kept.get("server_seconds") is not None]
    return 1e3 * sum(xs) / len(xs) if xs else None
