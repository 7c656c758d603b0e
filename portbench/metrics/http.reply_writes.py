"""The HTTP reply (``api.py``, ``server.py``): the body messages that carried bytes per
reply over the window's replies, from the server's running totals ``reply_writes`` and
``replies`` in the requests' ``timings``, as ``http.reply_ms`` takes them."""


def read(run):
    ts = [r.kept["timings"] for r in run.records + run.profiled[:1] if r.ok and "replies" in r.kept.get("timings", {})]
    if len(ts) < 2 or ts[-1]["replies"] <= ts[0]["replies"]:
        return None
    return (ts[-1]["reply_writes"] - ts[0]["reply_writes"]) / (ts[-1]["replies"] - ts[0]["replies"])
