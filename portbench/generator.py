"""The one traffic generator: reads a mix's parameters and drives the server.

A mix (``traffic/<name>.json``) is data:

- ``body``: fields every request carries as they stand (``guidance``, a ``cache``
  setting, ...);
- ``shapes``: the request shapes, each a dict of body fields (``width``, ``height``,
  ``num_steps``, ...) with an integer ``weight``. Requests take them in cycles of
  Σ weights, each shape ``weight`` times per cycle, in an order drawn from (run seed,
  cycle): every seed sends the same sizes, in another order;
- the prompt distribution: a word count range, the word list, the share of prompts
  that carry emphasis;
- ``loop``: the name of the loop module ``traffic/<loop>.py`` (its ``drive``, with
  the arguments of :func:`drive`) and what it reads (``clients``, ...);
- ``profiled_requests``, ``checked_requests``: how many requests a traced run
  profiles after the window, and how many of the window's the check judges.

Request ``i`` of a run is drawn from (run seed, i) alone: its shape, its prompt and
its image seed.
"""

import contextlib
import http.client
import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
EMPHASIS_WEIGHTS = [0.5, 0.6, 0.7, 0.8, 0.9, 1.1, 1.2, 1.3, 1.4, 1.5]


def load_mix(name: str) -> Dict:
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    mix["word_list"] = (HERE / "traffic" / mix["words"]).read_text().split()
    return mix


def prompt(rng: np.random.Generator, mix: Dict) -> str:
    """A prompt of ``prompt_words`` words from the word list; with probability
    ``emphasis_share`` one run of 1-3 of them carries A1111 emphasis: ``(…:w)``,
    ``(…)`` or ``[…]``."""
    lo, hi = mix["prompt_words"]
    words = list(rng.choice(mix["word_list"], size=int(rng.integers(lo, hi + 1))))
    if rng.random() < mix["emphasis_share"]:
        n = int(rng.integers(1, 4))
        i = int(rng.integers(0, len(words) - n + 1))
        span = " ".join(words[i:i + n])
        form = int(rng.integers(0, 3))
        if form == 0:
            span = f"({span}:{EMPHASIS_WEIGHTS[int(rng.integers(0, len(EMPHASIS_WEIGHTS)))]})"
        elif form == 1:
            span = f"({span})"
        else:
            span = f"[{span}]"
        words[i:i + n] = [span]
    return " ".join(words)


def shapes(mix: Dict) -> List[Dict]:
    """The mix's request shapes, each without its ``weight``, one entry per unit of
    weight: one cycle in the order listed."""
    return [{k: v for k, v in sh.items() if k != "weight"} for sh in mix["shapes"] for _ in range(int(sh.get("weight", 1)))]


def shape(seed: int, i: int, mix: Dict) -> Dict:
    """The shape of request ``i``: its place in its cycle, through the cycle's order."""
    cycle = shapes(mix)
    if len(cycle) == 1:
        return cycle[0]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) & (2**64 - 1), i // len(cycle), 0x5EA9]))
    return cycle[int(rng.permutation(len(cycle))[i % len(cycle)])]


def request(seed: int, i: int, mix: Dict) -> Dict:
    """The body of request ``i`` of a run seeded ``seed``."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) & (2**64 - 1), i]))
    text = prompt(rng, mix)
    return {**mix.get("body", {}), **shape(seed, i, mix), "prompt": text, "seed": int(rng.integers(0, 2**32 - 1))}


def resolutions(mix: Dict) -> List[List[int]]:
    """The (width, height) buckets the mix sends, each once, in the order listed."""
    out: List[List[int]] = []
    for sh in shapes(mix):
        if [sh["width"], sh["height"]] not in out:
            out.append([sh["width"], sh["height"]])
    return out


@dataclass
class Record:
    """One request as the client saw it, and what the harness kept of its reply."""

    index: int
    body: Dict
    sent: float
    done: float
    status: int
    payload: bytes = b""
    kept: Dict = field(default_factory=dict)
    first_byte: float = 0.0  # when the reply's status line and headers had arrived

    @property
    def seconds(self) -> float:
        return self.done - self.sent

    @property
    def ok(self) -> bool:
        return self.status == 200


def post(conn: http.client.HTTPConnection, index: int, body: Dict, span: Callable = contextlib.nullcontext) -> Record:
    """One round trip of ``POST /generate`` on ``conn``; ``span()`` is opened around it."""
    data = json.dumps(body).encode()
    with span():
        t0 = time.perf_counter()
        conn.request("POST", "/generate", body=data, headers={"content-type": "application/json"})
        resp = conn.getresponse()
        t1 = time.perf_counter()
        payload = resp.read()
        return Record(index, body, t0, time.perf_counter(), resp.status, payload, first_byte=t1)


def connect(port: int, timeout: float = 600.0) -> http.client.HTTPConnection:
    return http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)


def drive(port: int, seed: int, mix: Dict, seconds: float = 0.0, count: Optional[int] = None,
          first: int = 0, after: Optional[Callable[[Record], None]] = None,
          span: Callable = contextlib.nullcontext, timeout: float = 600.0) -> List[Record]:
    """Drive the server with the mix's loop (``traffic/<loop>.py``): requests ``first``,
    ``first + 1``, …; ``count`` of them, or else as many as the loop sends in
    ``seconds``. ``after(record)`` runs as each reply arrives; ``span()`` is a context
    opened around each round trip. → the records, in the order the replies came."""
    path = HERE / "traffic" / f"{mix['loop']}.py"
    mod_spec = importlib.util.spec_from_file_location("portbench_loop_" + mix["loop"], path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.drive(port, seed, mix, seconds=seconds, count=count, first=first, after=after, span=span,
                     timeout=timeout)


def warm(port: int, seed: int, mix: Dict, first: int, timeout: float = 600.0) -> List[Record]:
    """One 1-step request of each of the mix's resolutions, one after another: the
    HTTP path's first calls at the mix's own shapes."""
    conn = connect(port, timeout)
    try:
        out = []
        for k, (w, h) in enumerate(resolutions(mix)):
            body = {**request(seed, first + k, mix), "width": w, "height": h, "num_steps": 1}
            out.append(post(conn, first + k, body))
        return out
    finally:
        conn.close()
