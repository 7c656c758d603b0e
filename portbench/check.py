"""Whether what the served path produced is right: a sample of the window's requests,
judged by the cell's family (``families/<family>.py``: ``judge``) against its plain
reference at the same sizes.

A family's ``judge`` returns named numbers, each the largest over the sampled
requests. A cell's limits are ``limits/<cell>.json``, one per name, each set between
the readings of sound runs and of the family's control (``control.py``). The run is
correct when the numbers and the limits have the same names and every number is at
or under its limit: a number without a limit is never left unjudged, and a limit
without a number never passes unnoticed.
"""

from __future__ import annotations

import io
import json
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

JPEG_QUALITY = 99  # the served pipeline's default


def limits(cell: str) -> Dict[str, float]:
    return json.loads((Path(__file__).resolve().parent / "limits" / f"{cell}.json").read_text())


def jpeg_pixels(payload: bytes) -> torch.Tensor:
    from PIL import Image

    return torch.from_numpy(np.array(Image.open(io.BytesIO(payload)).convert("RGB")))[None]


def jpeg_round_trip(pixels: torch.Tensor) -> torch.Tensor:
    """(1, H, W, 3) uint8 pixels as the served JPEG carries them: encoded by PIL at the
    served quality, decoded again."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(pixels[0].cpu().numpy()).save(buf, format="JPEG", quality=JPEG_QUALITY)
    return jpeg_pixels(buf.getvalue())


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """‖a − b‖ / ‖b‖ in float32, ``a`` brought to ``b``'s device and shape."""
    a, b = a.float().to(b.device).reshape(b.shape), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def sample(records: List, seed: int, k: int) -> List:
    """``k`` of the window's answered requests, drawn from the seed: the one with the
    longest prompt, and others at random."""
    ok = [r for r in records if r.ok]
    if not ok:
        return []
    longest = max(ok, key=lambda r: len(r.body["prompt"]))
    rest = [r for r in ok if r is not longest]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) & (2**64 - 1), 0xC4EC]))
    picks = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if k > 1 and rest else []
    return [longest] + [rest[int(i)] for i in picks]


def verdict(numbers: Dict[str, float], lim: Dict[str, float]) -> bool:
    return (bool(numbers) and set(numbers) == set(lim)
            and all(np.isfinite(v) and v <= lim[k] for k, v in numbers.items()))


def compared(numbers: Dict[str, float], lim: Dict[str, float]) -> Dict[str, Dict]:
    """Each name of either side with its number and its limit (None where one side
    lacks it), the numbers' names first."""
    names = list(numbers) + [k for k in lim if k not in numbers]
    return {k: {"value": numbers.get(k), "limit": lim.get(k)} for k in names}
