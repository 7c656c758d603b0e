"""Whether what the served path produced is right: a sample of the window's requests,
judged against the plain reference (``portbench/reference``) at the same sizes.

Each sampled request is judged stage by stage, by four numbers:

- ``t5_rel`` and ``clip_rel``: the weighted T5 states and the pooled CLIP vector the
  served path computed for the prompt (kept from its conditioning cache as the reply
  arrived), against the reference's from the prompt text: ‖served − ref‖ / ‖ref‖.
- ``latent_rel``: the request's final latents (the pipeline's ``last_latents`` as the
  reply arrived) against the reference's, which runs the whole request itself (its
  own text encoders, its own calibration, noise from the request's seed).
- ``pixel_mad``: the returned JPEG, decoded, against the reference's VAE decode of
  the served latents encoded as the served JPEG is: mean absolute difference in
  8-bit levels.

A number is the largest over the sampled requests; the run is correct when every
number is under its limit. A cell's limits are ``limits/<cell>.json``, each set
between the readings of sound runs and of the control, which ``control.py``
computes: the reference one grid lower put in the program's place
(``reference.pipeline.Precision``).
"""

from __future__ import annotations

import io
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .reference.flux import Flux
from .reference.pipeline import Conditioner, Precision, calibrate, decode, denoise, is_schnell
from .weights import model_weights

JPEG_QUALITY = 99  # the served pipeline's default


def limits(cell: str) -> Dict[str, float]:
    return json.loads((Path(__file__).resolve().parent / "limits" / f"{cell}.json").read_text())


@dataclass
class Outputs:
    """One request's outputs at each stage: pooled CLIP (1, 768), weighted T5
    (1, L, 4096), final packed latents (1, L_img, 64), pixels (1, H, W, 3) uint8."""

    vec: torch.Tensor
    txt: torch.Tensor
    latents: torch.Tensor
    pixels: Optional[torch.Tensor] = None


def jpeg_pixels(payload: bytes) -> torch.Tensor:
    from PIL import Image

    return torch.from_numpy(np.array(Image.open(io.BytesIO(payload)).convert("RGB")))[None]


def jpeg_round_trip(pixels: torch.Tensor) -> torch.Tensor:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(pixels[0].cpu().numpy()).save(buf, format="JPEG", quality=JPEG_QUALITY)
    return jpeg_pixels(buf.getvalue())


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


@torch.no_grad()
def reference(spec: Dict, seed: int, bodies: List[Dict], device, prec: Precision,
              decode_latents: Optional[List[torch.Tensor]] = None) -> List[Outputs]:
    """The reference's outputs for ``bodies`` at ``prec``: its conditioning and its
    latents, and the decode of ``decode_latents[i]`` (default: its own latents) as the
    served JPEG carries it (PIL at the served quality, decoded again).
    Models are built one after another and dropped, so the card holds one at a time
    besides the T5 the calibration needs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights = model_weights(spec, seed, device)
    cond = Conditioner(spec, weights, prec, device)
    weights["t5"].release()
    weights["clip"].release()
    conds = [cond(b["prompt"]) for b in bodies]
    flow = Flux(spec["spec"]["params"], weights["flux"], prec.flow)
    weights["flux"].release()
    calibrate(flow, cond, spec)
    del cond
    steps = [4 if is_schnell(spec) else b["num_steps"] for b in bodies]
    lats = [denoise(flow, spec, v, t, b["seed"], b["width"], b["height"], s, b["guidance"])
            for (v, t), b, s in zip(conds, bodies, steps)]
    del flow
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    srcs = decode_latents if decode_latents is not None else lats
    pix = [jpeg_round_trip(decode(spec, weights, prec, lat, b["width"], b["height"])) for lat, b in zip(srcs, bodies)]
    return [Outputs(v, t, lat, p) for (v, t), lat, p in zip(conds, lats, pix)]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().to(b.device).reshape(b.shape), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def readings(judged: List[Outputs], ref: List[Outputs]) -> Dict[str, float]:
    """The four numbers, each the largest over the requests."""
    out = {"t5_rel": 0.0, "clip_rel": 0.0, "latent_rel": 0.0, "pixel_mad": 0.0}
    for j, r in zip(judged, ref):
        out["t5_rel"] = max(out["t5_rel"], _rel(j.txt, r.txt))
        out["clip_rel"] = max(out["clip_rel"], _rel(j.vec, r.vec))
        out["latent_rel"] = max(out["latent_rel"], _rel(j.latents, r.latents))
        diff = (j.pixels.to(r.pixels.device).int() - r.pixels.int()).abs().float().mean()
        out["pixel_mad"] = max(out["pixel_mad"], float(diff))
    return out


def judge(spec: Dict, seed: int, checked: List, device) -> Dict[str, float]:
    """The numbers for the served requests ``checked`` (generator records whose
    ``kept`` holds ``cond`` and ``latents``)."""
    served = [Outputs(r.kept["cond"][0], r.kept["cond"][1], r.kept["latents"], jpeg_pixels(r.payload))
              for r in checked]
    bodies = [r.body for r in checked]
    ref = reference(spec, seed, bodies, device, Precision.of(spec),
                    decode_latents=[o.latents.float().to(device) for o in served])
    return readings(served, ref)


def control(spec: Dict, seed: int, bodies: List[Dict], device) -> Dict[str, float]:
    """The numbers the control reads: the reference one grid lower in the program's
    place (its pixels through the served JPEG), judged like the program."""
    low = reference(spec, seed, bodies, device, Precision.of(spec, control=True))
    ref = reference(spec, seed, bodies, device, Precision.of(spec), decode_latents=[o.latents for o in low])
    return readings(low, ref)


def verdict(numbers: Dict[str, float], lim: Dict[str, float]) -> bool:
    return bool(numbers) and all(np.isfinite(v) and v <= lim[k] for k, v in numbers.items())
