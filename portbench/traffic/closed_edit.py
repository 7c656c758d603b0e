"""The closed loop of an editing mix: one client, as ``closed.py``, each request the
mix's text-to-image body (``generator.request``) with an ``input_image`` beside it,
the image the prompt edits, drawn from (run seed, i) alone (``portbench/images.py``).

``drive`` is ``closed.py``'s loop with this body; it goes once ``closed.py`` takes a
mix's body maker.
"""

import time

from portbench.generator import connect, post, request
from portbench.images import input_image


def body(seed: int, i: int, mix) -> dict:
    out = request(seed, i, mix)
    return {**out, "input_image": input_image(seed, i, out["width"], out["height"])}


def drive(port, seed, mix, seconds=0.0, count=None, first=0, after=None, span=None, timeout=600.0):
    if mix.get("clients", 1) != 1:
        raise ValueError("traffic/closed_edit.py drives one client; a loop of more is a module of its own")
    conn = connect(port, timeout)
    records = []
    try:
        start = time.perf_counter()
        i = first
        while (len(records) < count if count is not None
               else not records or time.perf_counter() - start < seconds):
            rec = post(conn, i, body(seed, i, mix), **({"span": span} if span else {}))
            records.append(rec)
            if after is not None:
                after(rec)
            i += 1
    finally:
        conn.close()
    return records
