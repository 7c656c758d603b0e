"""The closed loop: ``clients`` clients, each sending its next request when its last
reply arrived. One client (the only count this module takes) is the honest load of a
server that serialises its generate calls.

The window is the time from the first request to the last reply: requests keep being
sent until ``seconds`` have passed, and the window ends when the last of them
completes, so every request counted was whole inside it.
"""

import time

from portbench.generator import connect, post, request


def drive(port, seed, mix, seconds=0.0, count=None, first=0, after=None, span=None, timeout=600.0):
    if mix.get("clients", 1) != 1:
        raise ValueError("traffic/closed.py drives one client; a loop of more is a module of its own")
    conn = connect(port, timeout)
    records = []
    try:
        start = time.perf_counter()
        i = first
        while (len(records) < count if count is not None
               else not records or time.perf_counter() - start < seconds):
            rec = post(conn, i, request(seed, i, mix), **({"span": span} if span else {}))
            records.append(rec)
            if after is not None:
                after(rec)
            i += 1
    finally:
        conn.close()
    return records
