"""A stand-in family that no harness file names: a toy text-to-image pipeline (seeded
noise through a 3 × 3 colour map drawn from the run's seed, once per step) served by
the program's own HTTP handler, with a reference of its own and one check number: the
names of ``families/__init__.py`` that ``run.run_cell`` calls. It exists to show that a
family lands as a file of its own."""

from __future__ import annotations

import io
from typing import Dict, List

import torch

from portbench import check
from portbench.weights import Weights


def weights(spec: Dict, seed: int, device) -> Dict[str, Weights]:
    return {"toy": Weights(1, [[("map", (3, 3), ("n", 0.5))]], seed, device)}


def image(colour_map: torch.Tensor, seed: int, width: int, height: int, steps: int, dtype) -> torch.Tensor:
    """(1, H, W, 3) uint8: the noise of ``seed`` through the map ``steps`` times."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(height * width, 3, generator=g).to(dtype)
    for _ in range(steps):
        x = torch.tanh(x @ colour_map.to(dtype))
    return ((x.float() + 1) * 127.5).round().clamp(0, 255).to(torch.uint8).reshape(1, height, width, 3)


class ToyPipeline:
    """What the program's HTTP handler calls: ``generate`` → JPEG bytes, ``timings``."""

    def __init__(self, colour_map: torch.Tensor, dtype):
        self.colour_map, self.dtype, self.timings = colour_map, dtype, {}

    def generate(self, prompt, width, height, num_steps, seed, silent=True, **_):
        pixels = image(self.colour_map, seed, width, height, num_steps, self.dtype)
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(pixels[0].numpy()).save(buf, format="JPEG", quality=check.JPEG_QUALITY)
        return buf


def build(spec: Dict, drawn: Dict, overrides: Dict, mark=lambda phase: None):
    pipeline = ToyPipeline(drawn["toy"].get("map").float().cpu(), getattr(torch, spec["dtype"]))
    mark("toy")
    return pipeline


def steps(spec: Dict, body: Dict) -> int:
    return body["num_steps"]


def check_body(body: Dict) -> None:
    if body.get("cache") is not None:
        raise ValueError("the toy reference does not model cache")


def keep(pipeline, body: Dict) -> Dict:
    return {}


def reference_pixels(spec: Dict, seed: int, body: Dict) -> torch.Tensor:
    colour_map = weights(spec, seed, "cpu")["toy"].get("map").float()
    return check.jpeg_round_trip(image(colour_map, body["seed"], body["width"], body["height"], body["num_steps"],
                                       torch.float32))


def _mad(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.int() - b.int()).abs().float().mean())


def judge(spec: Dict, seed: int, records: List, device) -> Dict[str, float]:
    return {"pixel_mad": max(_mad(check.jpeg_pixels(r.payload), reference_pixels(spec, seed, r.body))
                             for r in records)}

