"""The HTTP reply (``api.py``, ``server.py``): the mean seconds of the program's ``reply``
span (the response's start to the return of its last body message) over the window's
replies, in milliseconds. Each request's ``timings`` carry the server's running totals
(``replies``, ``reply_seconds``) as they stood when its generate ended, so the window's
replies are the difference between its first request's totals and those of the request
after it (the first profiled one; without it the window's last, which leaves out the
last reply)."""


def read(run):
    ts = [r.kept["timings"] for r in run.records + run.profiled[:1] if r.ok and "replies" in r.kept.get("timings", {})]
    if len(ts) < 2 or ts[-1]["replies"] <= ts[0]["replies"]:
        return None
    return 1e3 * (ts[-1]["reply_seconds"] - ts[0]["reply_seconds"]) / (ts[-1]["replies"] - ts[0]["replies"])
