"""One text-to-image request through the reference, as the served pipeline defines it:
noise from the request's seed, BFL's shifted schedule (unshifted for schnell), the
emphasis-weighted T5 and pooled CLIP conditioning, Euler steps over the flow (through
the request's step cache, where its body asks for one), and the VAE decode. A body
field whose value the reference does not model is refused by name
(``request_cache``), never judged as another computation. ``calibrate`` works the
fp8 input scales out again as the served configuration does before it serves:
``num_scale_trials`` steps of its calibration request, each step's input amaxes
folded into a running max and frozen into the scales after it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import text
from .ae import Decoder, to_pixels
from .encoders import CLIP, T5
from .flux import Flux

MAX_RAND = 2**32 - 1
# the served configuration's calibration request (its pipeline's compile())
CALIBRATION = dict(prompt="A beautiful test image used to solidify the fp8 input scales prior to compilation",
                   width=768, height=768, guidance=3.5, seed=10)


def schedule(num_steps: int, image_seq_len: int, shift: bool) -> List[float]:
    """BFL ``get_schedule``: 1 → 0 in ``num_steps``, warped by mu linear in the image
    length (0.5 at 256 tokens, 1.15 at 4096)."""
    t = np.linspace(1.0, 0.0, num_steps + 1)
    if shift:
        m = (1.15 - 0.5) / (4096 - 256)
        mu = m * image_seq_len + (0.5 - m * 256)
        with np.errstate(divide="ignore"):
            t = math.exp(mu) / (math.exp(mu) + (1 / t - 1))
        t[-1] = 0.0
    return [float(x) for x in t]


def noise(seed: int, height: int, width: int, channels: int, device) -> torch.Tensor:
    """The request's initial latents (1, channels, 2⌈h/16⌉, 2⌈w/16⌉): a standard
    normal draw of a generator on the device seeded with the request's seed, in the
    flow's bf16."""
    g = torch.Generator(device=device)
    g.manual_seed(int(abs(seed)) % MAX_RAND)
    shape = (1, channels, 2 * math.ceil(height / 16), 2 * math.ceil(width / 16))
    return torch.randn(shape, generator=g, device=device).to(torch.bfloat16).float()


def pack(x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5).reshape(b, (h // 2) * (w // 2), c * 4)


def unpack(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    b, _, f = x.shape
    h, w = math.ceil(height / 16), math.ceil(width / 16)
    return x.reshape(b, h, w, f // 4, 2, 2).permute(0, 3, 1, 4, 2, 5).reshape(b, f // 4, 2 * h, 2 * w)


def img_ids(h: int, w: int, device) -> torch.Tensor:
    ids = torch.zeros(h // 2, w // 2, 3, device=device)
    ids[..., 1] = torch.arange(h // 2, device=device)[:, None]
    ids[..., 2] = torch.arange(w // 2, device=device)[None, :]
    return ids.reshape(1, -1, 3)


# the configuration's tier of each model → the reference's grid, for the tiers it models
TIERS = {"flow": ("flow_quantization_dtype", {"qfloat8": "fp8", None: "none"}),
         "t5": ("text_enc_quantization_dtype", {"qfloat8": "wo_fp8", None: "none"}),
         "clip": ("clip_quantization_dtype", {None: "none", "qfloat8": "wo_fp8"}),
         "ae": ("ae_quantization_dtype", {None: "none", "qfloat8": "wo_fp8"})}


@dataclass
class Precision:
    """The grid of each model: the configuration's, or one step lower (the control)."""

    flow: str = "fp8"
    t5: str = "wo_fp8"
    clip: str = "none"
    ae: str = "none"

    @classmethod
    def of(cls, spec: Dict, control: bool = False) -> "Precision":
        """The configuration's grids; a tier the reference does not model (int8, int4,
        ...) is refused by name."""
        grids = {}
        for model, (key, known) in TIERS.items():
            tier = spec["spec"][key]
            if tier not in known:
                raise ValueError(f"the reference does not model {key} {tier!r}: it models "
                                 f"{sorted(str(t) for t in known)}")
            grids[model] = known[tier]
        if control:
            lower = {"fp8": "int4", "wo_fp8": "wo_int4", "none": "wo_fp8"}
            grids = {model: lower[g] for model, g in grids.items()}
        return cls(**grids)


@dataclass(frozen=True)
class StepCache:
    """A request's ``cache`` in interval mode, the one mode the reference models, with
    the served pipeline's fields and defaults (its ``sampling.CacheConfig``). Step ``i``
    of ``n`` evaluates the flow when ``i < warmup``, ``i >= n - tail`` or
    ``i % interval == 0``; a skipped step reuses the last evaluated velocity (order 0)
    or extrapolates the last two linearly in t, in float32 (order 1; as order 0 while
    fewer than two have run)."""

    interval: int = 2
    warmup: int = 2
    tail: int = 1
    order: int = 0

    def evaluates(self, i: int, n: int) -> bool:
        return i < self.warmup or i >= n - self.tail or i % self.interval == 0


# the body fields the reference models; ``strength`` at 1.0 and ``init_image`` unset only
BODY_FIELDS = {"prompt", "seed", "width", "height", "num_steps", "guidance", "strength", "init_image", "cache"}


def request_cache(body: Dict) -> Optional[StepCache]:
    """The step cache of a request body (None without one), after refusing, by name,
    every field whose value the reference does not model: a field it does not know,
    ``init_image``, ``strength`` other than 1, ``cache`` in any mode but interval."""
    unknown = sorted(set(body) - BODY_FIELDS)
    if unknown:
        raise ValueError(f"the reference does not model the body field(s) {unknown}")
    if body.get("init_image") is not None:
        raise ValueError("the reference does not model init_image (image to image)")
    if body.get("strength", 1.0) != 1.0:
        raise ValueError(f"the reference does not model strength {body['strength']!r}: only 1.0")
    spec = dict(body.get("cache") or {})
    mode = spec.pop("mode", "none")
    if mode == "none":
        return None
    if mode != "interval":
        raise ValueError(f"the reference does not model cache mode {mode!r}: only 'interval'")
    spec.pop("threshold", None)  # read by the dynamic mode alone
    spec.pop("coefficients", None)
    unknown = sorted(set(spec) - {"interval", "warmup", "tail", "order"})
    if unknown:
        raise ValueError(f"the reference does not model the cache field(s) {unknown}")
    cache = StepCache(**{k: int(v) for k, v in spec.items()})
    if cache.interval < 1 or cache.warmup < 1 or cache.tail < 0 or cache.order not in (0, 1):
        raise ValueError(f"the served pipeline refuses the cache {body['cache']!r}")
    return cache


class Conditioner:
    """Prompt → (pooled CLIP (1, 768), weighted T5 (1, L, 4096)) in float32."""

    def __init__(self, spec: Dict, weights: Dict, prec: Precision, device):
        self.t5 = T5(spec["t5"], weights["t5"].get, prec.t5)
        self.clip = CLIP(spec["clip"], weights["clip"].get, prec.clip)
        self.length = spec["spec"]["text_enc_max_length"]
        self.device = device

    @torch.no_grad()
    def __call__(self, prompt: str):
        ids_c = torch.tensor([text.clip_ids(prompt)], device=self.device)
        ids_t, w_t = text.t5_ids_and_weights(prompt, self.length)
        ids_t = torch.tensor([ids_t], device=self.device)
        hidden = self.t5(ids_t)
        return self.clip(ids_c), text.apply_weights(ids_t[0], torch.tensor(w_t, device=self.device), hidden)


def is_schnell(spec: Dict) -> bool:
    return spec["spec"]["version"] == "flux-schnell"


@torch.no_grad()
def denoise(flow: Flux, spec: Dict, vec, txt, seed: int, width: int, height: int, steps: int,
            guidance: float, cache: Optional[StepCache] = None, on_step=None) -> Tuple[torch.Tensor, int]:
    """(the request's final packed latents (1, L_img, 64), the flow evaluations run).
    ``cache``: the request's step cache, or None to evaluate every step. ``on_step(i)``
    runs after each step (calibration freezes its scales there)."""
    device = txt.device
    height, width = 16 * (height // 16), 16 * (width // 16)
    x0 = noise(seed, height, width, spec["spec"]["params"]["in_channels"] // 4, device)
    ts = schedule(steps, x0.shape[-1] * x0.shape[-2] // 4, shift=not is_schnell(spec))
    ts32 = torch.tensor(ts, dtype=torch.float32, device=device)  # the cache's times, as served
    x = pack(x0)
    ids = img_ids(x0.shape[-2], x0.shape[-1], device)
    txt_ids = torch.zeros(1, txt.shape[1], 3, device=device)
    g = torch.full((1,), guidance, device=device).to(torch.bfloat16)
    evaluated: List[Tuple[torch.Tensor, torch.Tensor]] = []  # (t, velocity) of the last two evaluations
    evaluations = 0
    for i, (tc, tp) in enumerate(zip(ts[:-1], ts[1:])):
        if cache is None or cache.evaluates(i, steps):
            # the timestep enters the flow in its compute dtype, as the served flow takes it
            t = torch.full((1,), tc, device=device).to(torch.bfloat16)
            v = flow(x, ids, txt, txt_ids, t, vec, g)
            evaluated = (evaluated + [(ts32[i], v)])[-2:]
            evaluations += 1
        elif cache.order == 1 and len(evaluated) == 2:
            (t0, v0), (t1, v1) = evaluated
            v = v1 + (ts32[i] - t1) * ((v1 - v0) / (t1 - t0))
        else:
            v = evaluated[-1][1]
        x = x + (tp - tc) * v
        if on_step is not None:
            on_step(i)
    return x, evaluations


def calibrate(flow: Flux, cond: Conditioner, spec: Dict) -> None:
    """The served configuration's calibration, replayed: until ``num_scale_trials``
    steps have run, its calibration request (4 steps for schnell, else 12) with every
    linear's input amax collected, folded and frozen into the scales after each step."""
    trials = spec["spec"]["num_scale_trials"]
    if flow.double and flow.double[0]["img_mod.lin"].grid == "none":
        return
    c = CALIBRATION
    vec, txt = cond(c["prompt"])
    lins = list(flow.linears())
    done = 0

    def freeze(_):
        nonlocal done
        if done >= trials:
            return
        for lin in lins:
            lin.set_input_amax(lin.amax)
        done += 1
        if done >= trials:
            for lin in lins:
                lin.collect = False

    while done < trials:
        for lin in lins:
            lin.collect = True
        steps = 4 if is_schnell(spec) else 12
        denoise(flow, spec, vec, txt, c["seed"], c["width"], c["height"], steps, c["guidance"], on_step=freeze)
    for lin in lins:
        lin.collect = False


@torch.no_grad()
def decode(spec: Dict, weights: Dict, prec: Precision, latents: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Packed latents → (1, H, W, 3) uint8."""
    height, width = 16 * (height // 16), 16 * (width // 16)
    dec = Decoder(spec["spec"]["ae_params"], weights["ae"], prec.ae)
    return to_pixels(dec(unpack(latents.float(), height, width)))
