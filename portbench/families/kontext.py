"""The FLUX.1 Kontext [dev] family: in-context editing as the program serves it, a
flux-dev flow whose every evaluation takes a context image's tokens after the ones it
denoises. Its weights, build, conditioning, calibration, decode and the readings it
shares with text-to-image are the FLUX family's (``families/flux.py``), by import;
what is its own is the context: the body's ``input_image``, the reference's encoder and
loop (``portbench/reference/kontext.py``), ``context_rel`` and ``context_ids_off``, the
``no_context`` control, and the image tokens that count the context in the readers'
least times.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from portbench import check, flops, images
from portbench.families import flux
from portbench.reference import kontext
from portbench.reference.flux import Flux
from portbench.reference.pipeline import Conditioner, Precision, calibrate, decode, request_cache

PUBLISHED = {"https://huggingface.co/black-forest-labs/FLUX.1-Kontext-dev":
             {"params": flux.FLOW_12B, "t5": flux.T5_XXL, "clip": flux.CLIP_L}}
widths = flux.widths
weights = flux.weights
build = flux.build  # the configuration's version makes the pipeline a Kontext one


def steps(spec: Dict, body: Dict) -> int:
    return body["num_steps"]


def _text(body: Dict) -> Dict:
    """The body without its context image: what the text-to-image reference reads."""
    return {k: v for k, v in body.items() if k != "input_image"}


def check_body(body: Dict) -> None:
    """Refuses, by name, a field the reference does not model: the text-to-image
    reference's refusals, and any step cache (the served pipeline refuses a cache beside
    an ``input_image``)."""
    if request_cache(_text(body)) is not None:
        raise ValueError("the Kontext reference does not model cache: the served pipeline refuses a step cache "
                         "beside an input_image")


def keep(pipeline, body: Dict) -> Dict:
    """The FLUX family's, and the packed context latents the served path encoded with
    the position ids it gave them."""
    return {**flux.keep(pipeline, body), "context": pipeline.last_context, "context_ids": pipeline.last_context_ids}


# ------------------------------------------------------------------------ the check


@dataclass
class Outputs(flux.Outputs):
    """The FLUX family's outputs, the request's packed context latents (1, L_ctx, 64)
    and their position ids (1, L_ctx, 3)."""

    context: Optional[torch.Tensor] = None
    context_ids: Optional[torch.Tensor] = None


def with_images(seed: int, bodies: List[Dict]) -> List[Dict]:
    """``bodies`` as requests 0, 1, … of a run seeded ``seed`` send them: each with the
    ``input_image`` the loop draws for it (``portbench/images.py``; a control's bodies come without one)."""
    return [b if "input_image" in b else {**b, "input_image": images.input_image(seed, i, b["width"], b["height"])}
            for i, b in enumerate(bodies)]


@torch.no_grad()
def reference(spec: Dict, seed: int, bodies: List[Dict], device, prec: Precision,
              decode_latents: Optional[List[torch.Tensor]] = None,
              loops: Sequence[bool] = (True,)) -> List[List[Outputs]]:
    """The reference's outputs for ``bodies`` at ``prec``, one list per entry of
    ``loops``: the denoise loop with the context (True) or without it (False), over one
    conditioning, one encode of each context image and one calibration. Pixels are the
    decode of ``decode_latents[i]`` (default: the loop's own latents) as the served JPEG
    carries them. Models are built one after another and dropped."""
    for b in bodies:  # before any model is built
        check_body(b)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    drawn = weights(spec, seed, device)
    cond = Conditioner(spec, drawn, prec, device)
    drawn["t5"].release()
    drawn["clip"].release()
    conds = [cond(b["prompt"]) for b in bodies]
    enc = kontext.Encoder(spec["spec"]["ae_params"], drawn["ae"], prec.ae)
    ctxs = [kontext.context(enc, kontext.decode_image(b["input_image"]), device) for b in bodies]
    del enc
    flow = Flux(spec["spec"]["params"], drawn["flux"], prec.flow)
    drawn["flux"].release()
    calibrate(flow, cond, spec)
    del cond
    runs = [[kontext.denoise(flow, spec, v, t, b["seed"], b["width"], b["height"], b["num_steps"], b["guidance"],
                             ctx if with_context else None)
             for (v, t), b, ctx in zip(conds, bodies, ctxs)] for with_context in loops]
    del flow
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    out = []
    for lats in runs:
        srcs = decode_latents if decode_latents is not None else lats
        pix = [check.jpeg_round_trip(decode(spec, drawn, prec, lat, b["width"], b["height"]))
               for lat, b in zip(srcs, bodies)]
        out.append([Outputs(v, t, lat, p, b["num_steps"], *ctx)
                    for (v, t), lat, p, b, ctx in zip(conds, lats, pix, bodies, ctxs)])
    return out


def _ids_off(judged: torch.Tensor, ref: torch.Tensor) -> float:
    if judged is None or judged.shape != ref.shape:
        return float("inf")
    return float((judged.float().to(ref.device) - ref).abs().max())


def readings(judged: List[Outputs], ref: List[Outputs], bodies: List[Dict]) -> Dict[str, float]:
    """The FLUX family's numbers (``latent_rel`` of the target's latents; the reference
    runs the whole request itself, its own encode of the context image included), and,
    each the largest over the requests:

    - ``context_rel``: the judged packed context latents against the reference's encode
      of the same decoded pixels, ‖judged − ref‖ / ‖ref‖;
    - ``context_ids_off``: max |judged − reference| of the context's position ids
      (exact). With drawn weights attention is near uniform, so the latents cannot show
      where the context sits: served with its ids at rope index 0, kontext-1024 read
      ``latent_rel`` 0.0256 on an H100, among sound runs' 0.0229-0.0277 (PERF.md)."""
    out = flux.readings(judged, ref, [_text(b) for b in bodies])
    out["context_rel"] = max(check.rel(j.context, r.context) for j, r in zip(judged, ref))
    out["context_ids_off"] = max(_ids_off(j.context_ids, r.context_ids) for j, r in zip(judged, ref))
    return out


def judge(spec: Dict, seed: int, records: List, device) -> Dict[str, float]:
    served = [Outputs(r.kept["check"]["cond"][0], r.kept["check"]["cond"][1], r.kept["check"]["latents"],
                      check.jpeg_pixels(r.payload), steps(spec, r.body), r.kept["check"]["context"],
                      r.kept["check"]["context_ids"]) for r in records]
    bodies = [r.body for r in records]
    (ref,) = reference(spec, seed, bodies, device, Precision.of(spec),
                       decode_latents=[o.latents.float().to(device) for o in served])
    return readings(served, ref, bodies)


# the controls of ``portbench.control``: ``lower`` sets the limits' upper readings;
# ``no_context`` is the reference that drops the context tokens, which must fail
CONTROLS = ("lower", "no_context")


def control(spec: Dict, seed: int, bodies: List[Dict], device, name: str = "lower") -> Dict[str, float]:
    """The numbers a control reads, judged like the program: the reference one grid
    lower in the program's place (``lower``: its encode and decode too), or the
    reference at the configuration's grids whose loop leaves the context out
    (``no_context``: its conditioning and encode are the reference's own, so only the
    latents and what follows them differ)."""
    bodies = with_images(seed, bodies)
    if name == "lower":
        (low,) = reference(spec, seed, bodies, device, Precision.of(spec, control=True))
        (ref,) = reference(spec, seed, bodies, device, Precision.of(spec), decode_latents=[o.latents for o in low])
    elif name == "no_context":
        ref, low = reference(spec, seed, bodies, device, Precision.of(spec), loops=(True, False))
        ref = [Outputs(r.vec, r.txt, r.latents, o.pixels, r.evaluations, r.context, r.context_ids)
               for r, o in zip(ref, low)]
    else:
        raise ValueError(f"no control {name!r}: the family's are {CONTROLS}")
    return readings(low, ref, bodies)


# ------------------------------------------------------------- work of an evaluation


def context_tokens(body: Dict) -> int:
    """The tokens of a request's context image: its preferred Kontext size over 16² (0
    without one)."""
    if body.get("input_image") is None:
        return 0
    h, w = kontext.decode_image(body["input_image"]).shape[:2]
    w, h = kontext.preferred_size(w, h)
    return (h // 16) * (w // 16)


def lengths(spec: Dict, body: Dict) -> Tuple[int, int]:
    """(image tokens: the target's and the context's, text tokens) of a request."""
    l_img, l_txt = flux.lengths(spec, body)
    return l_img + context_tokens(body), l_txt


def evaluation_ms(spec: Dict, body: Dict) -> float:
    """As the FLUX family's, with the context's tokens in every image-stream product."""
    params, (l_img, l_txt) = spec["spec"]["params"], lengths(spec, body)
    fp8 = flux.block_linear_flops(params, l_img, l_txt, modulation=True) / flops.PEAK_FP8_FLOPS
    bf16 = ((flux.attention_flops(params, l_img + l_txt) + flux.float_linear_flops(params, l_img, l_txt))
            / flops.PEAK_BF16_FLOPS)
    return (fp8 + bf16) * 1e3


def fp8_linears_ms(spec: Dict, body: Dict) -> float:
    return sum(flops.bound(2 * m * k * n, m * k + k * n + 2 * m * n, flops.PEAK_FP8_FLOPS)[0]
               for _, m, k, n in flux.block_linears(spec["spec"]["params"], *lengths(spec, body)))


def attention_ms(spec: Dict, body: Dict) -> float:
    p, (l_img, l_txt) = spec["spec"]["params"], lengths(spec, body)
    blocks, head_dim = p["depth"] + p["depth_single_blocks"], p["hidden_size"] // p["num_heads"]
    return blocks * flops.attention_bound(p["num_heads"], l_img + l_txt, head_dim)[0]
