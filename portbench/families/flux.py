"""The FLUX.1 text-to-image family: BFL's flux-dev and flux-schnell as the program
serves them, a 12B flow over weighted T5-XXL states and a pooled CLIP vector, and the
VAE. Everything the harness does that depends on the model is here, under the names
``families/__init__.py`` lists; the plain reference is ``portbench/reference/``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from portbench import check, flops, system
from portbench.reference.flux import Flux
from portbench.reference.pipeline import (Conditioner, Precision, calibrate, decode, denoise, is_schnell,
                                          request_cache)
from portbench.weights import Weights, ae_groups, clip_groups, flux_groups, t5_groups

# BFL flux/util.py's flux-dev and flux-schnell; google/t5-v1_1-xxl's encoder and
# openai/clip-vit-large-patch14's text tower (their config.json files)
T5_XXL = {"vocab_size": 32128, "d_model": 4096, "d_ff": 10240, "num_layers": 24, "num_heads": 64, "d_kv": 64,
          "relative_attention_num_buckets": 32, "relative_attention_max_distance": 128,
          "layer_norm_epsilon": 1e-6}
FLOW_12B = {"hidden_size": 3072, "num_heads": 24, "depth": 19, "depth_single_blocks": 38}
CLIP_L = {"hidden_size": 768, "num_layers": 12, "vocab_size": 49408}
PUBLISHED = {url: {"params": FLOW_12B, "t5": T5_XXL, "clip": CLIP_L}
             for url in ("https://huggingface.co/black-forest-labs/FLUX.1-dev",
                         "https://huggingface.co/black-forest-labs/FLUX.1-schnell")}


def widths(spec: Dict) -> Dict:
    """The keys of ``PUBLISHED`` as a configuration file holds them."""
    return {"params": {k: spec["spec"]["params"][k] for k in FLOW_12B}, "t5": spec["t5"],
            "clip": {k: spec["clip"][k] for k in CLIP_L}}


# ---------------------------------------------------------------------- the program


def weights(spec: Dict, seed: int, device) -> Dict[str, Weights]:
    """flux, t5, clip and ae :class:`Weights` of a configuration file's sizes, tagged
    1 to 4."""
    return {
        "flux": Weights(1, flux_groups(spec["spec"]["params"]), seed, device),
        "t5": Weights(2, t5_groups(spec["t5"]), seed, device),
        "clip": Weights(3, clip_groups(spec["clip"]), seed, device),
        "ae": Weights(4, ae_groups(spec["spec"]["ae_params"]), seed, device),
    }


def build(spec: Dict, weights: Dict, overrides: Dict, mark=lambda phase: None):
    """The configuration's ``FluxPipeline`` over the drawn weights. The flow and the VAE
    load through the program's own checkpoint path, as a BFL file would; T5 and CLIP
    are built from their published sizes through the program's config classes,
    HF-name loaders, weight-only tiers and ``TextEncoder``, with the word-level
    tokenizer the program draws for random weights. Its constructor calibrates and,
    with the compile flags, warms ``overrides["warmup_resolutions"]``. ``mark(phase)``
    is called as each phase ends: ``flow`` (drawn and quantized), ``ae``, ``text`` (T5
    and CLIP), ``calibrate``, ``warm`` (the buckets compiled or read from the cache,
    and run)."""
    from unittest import mock

    from flux_fp8_api_tpu_torch.models.clip import CLIPConfig, load_clip_checkpoint
    from flux_fp8_api_tpu_torch.models.conditioner import TextEncoder, apply_quantization
    from flux_fp8_api_tpu_torch.models.t5 import T5Config, load_t5_checkpoint
    from flux_fp8_api_tpu_torch.pipeline import FluxPipeline
    from flux_fp8_api_tpu_torch.utils import loader
    from flux_fp8_api_tpu_torch.utils.config import ModelSpec, into_device, into_dtype

    config = ModelSpec(**{**spec["spec"], "ckpt_path": system.DRAWN + "flux", "ae_path": system.DRAWN + "ae",
                          **overrides})
    with system.drawn_checkpoints(weights):
        flow, flow_cfg, _ = loader.load_flow_model(config)
        weights["flux"].release()
        mark("flow")
        ae = loader.load_autoencoder(config)
        weights["ae"].release()
        mark("ae")
    device, dtype = into_device(config.text_enc_device), into_dtype(config.text_enc_dtype)
    t5_cfg, clip_cfg = T5Config(**spec["t5"]), CLIPConfig(**spec["clip"])
    t5 = TextEncoder(
        "t5", apply_quantization("t5", load_t5_checkpoint(weights["t5"].get, t5_cfg, dtype, device=device),
                                 config.text_enc_quantization_dtype),
        t5_cfg, loader.ToyTokenizer("t5"), max_length=config.text_enc_max_length, dtype=dtype, device=device,
        offload=config.offload_text_encoder, stream=config.stream_text_encoder)
    weights["t5"].release()
    clip = TextEncoder(
        "clip", apply_quantization("clip", load_clip_checkpoint(weights["clip"].get, clip_cfg, dtype, device=device),
                                   config.clip_quantization_dtype),
        clip_cfg, loader.ToyTokenizer("clip"), max_length=77, dtype=dtype, device=device,
        offload=config.offload_text_encoder)
    weights["clip"].release()
    mark("text")
    warmup = FluxPipeline.warmup

    def timed_warmup(self, *args, **kwargs):
        mark("calibrate")
        return warmup(self, *args, **kwargs)

    with mock.patch.object(FluxPipeline, "warmup", timed_warmup):
        pipeline = FluxPipeline(name=str(getattr(config.version, "value", config.version)), clip=clip, t5=t5,
                                model=flow, model_cfg=flow_cfg, ae=ae, config=config, prequantized=False)
    mark("warm")
    return pipeline


def steps(spec: Dict, body: Dict) -> int:
    """The schedule steps a request runs: schnell's pipeline runs 4 whatever it asks."""
    return 4 if is_schnell(spec) else body["num_steps"]


def check_body(body: Dict) -> None:
    """Refuses, by name, a body field whose value the reference does not model."""
    request_cache(body)


def keep(pipeline, body: Dict) -> Dict:
    """What a reply keeps for the check, as it arrives: the pipeline's final latents,
    and the (pooled CLIP, weighted T5) the served path computed for the prompt, from its
    conditioning cache while it still holds the entry."""
    return {"latents": pipeline.last_latents,
            "cond": pipeline._cond_cache.get((body["prompt"], pipeline.config.text_enc_max_length))}


# ------------------------------------------------------------------------ the check


@dataclass
class Outputs:
    """One request's outputs at each stage: pooled CLIP (1, 768), weighted T5
    (1, L, 4096), final packed latents (1, L_img, 64), pixels (1, H, W, 3) uint8, and
    the flow evaluations its loop ran."""

    vec: torch.Tensor
    txt: torch.Tensor
    latents: torch.Tensor
    pixels: Optional[torch.Tensor] = None
    evaluations: int = 0


@torch.no_grad()
def reference(spec: Dict, seed: int, bodies: List[Dict], device, prec: Precision,
              decode_latents: Optional[List[torch.Tensor]] = None) -> List[Outputs]:
    """The reference's outputs for ``bodies`` at ``prec``: its conditioning, its latents
    and evaluations (the body's step cache applied), and the decode of
    ``decode_latents[i]`` (default: its own latents) as the served JPEG carries it (PIL
    at the served quality, decoded again). Models are built one after another and
    dropped, so the card holds one at a time besides the T5 the calibration needs."""
    caches = [request_cache(b) for b in bodies]  # before any model is built
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    drawn = weights(spec, seed, device)
    cond = Conditioner(spec, drawn, prec, device)
    drawn["t5"].release()
    drawn["clip"].release()
    conds = [cond(b["prompt"]) for b in bodies]
    flow = Flux(spec["spec"]["params"], drawn["flux"], prec.flow)
    drawn["flux"].release()
    calibrate(flow, cond, spec)
    del cond
    runs = [denoise(flow, spec, v, t, b["seed"], b["width"], b["height"], steps(spec, b), b["guidance"], cache)
            for (v, t), b, cache in zip(conds, bodies, caches)]
    del flow
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    srcs = decode_latents if decode_latents is not None else [lat for lat, _ in runs]
    pix = [check.jpeg_round_trip(decode(spec, drawn, prec, lat, b["width"], b["height"]))
           for lat, b in zip(srcs, bodies)]
    return [Outputs(v, t, lat, p, n) for (v, t), (lat, n), p in zip(conds, runs, pix)]


def readings(judged: List[Outputs], ref: List[Outputs], bodies: List[Dict]) -> Dict[str, float]:
    """The numbers, each the largest over the requests:

    - ``t5_rel`` and ``clip_rel``: the judged weighted T5 states and pooled CLIP vector
      against the reference's from the prompt text, ‖judged − ref‖ / ‖ref‖;
    - ``latent_rel``: the request's final latents against the reference's, which runs
      the whole request itself (its own text encoders, its own calibration, noise from
      the request's seed, the request's step cache);
    - ``pixel_mad``: the judged JPEG, decoded, against the reference's VAE decode of
      the judged latents encoded as the served JPEG is: mean absolute difference in
      8-bit levels;
    - ``evaluations_off``, where a body asks for a step cache: |judged − reference|
      flow evaluations of the request's loop."""
    out = {"t5_rel": 0.0, "clip_rel": 0.0, "latent_rel": 0.0, "pixel_mad": 0.0}
    if any(request_cache(b) is not None for b in bodies):
        out["evaluations_off"] = 0.0
    for j, r in zip(judged, ref):
        out["t5_rel"] = max(out["t5_rel"], check.rel(j.txt, r.txt))
        out["clip_rel"] = max(out["clip_rel"], check.rel(j.vec, r.vec))
        out["latent_rel"] = max(out["latent_rel"], check.rel(j.latents, r.latents))
        diff = (j.pixels.to(r.pixels.device).int() - r.pixels.int()).abs().float().mean()
        out["pixel_mad"] = max(out["pixel_mad"], float(diff))
        if "evaluations_off" in out:
            out["evaluations_off"] = max(out["evaluations_off"], float(abs(j.evaluations - r.evaluations)))
    return out


def judge(spec: Dict, seed: int, records: List, device) -> Dict[str, float]:
    """The numbers for the served requests ``records`` (generator records whose
    ``kept`` holds ``keep``'s ``check`` and the pipeline's ``timings``). A loop that ran
    no step cache evaluated every step."""
    served = [Outputs(r.kept["check"]["cond"][0], r.kept["check"]["cond"][1], r.kept["check"]["latents"],
                      check.jpeg_pixels(r.payload),
                      r.kept["timings"].get("cache_model_evals", steps(spec, r.body))) for r in records]
    bodies = [r.body for r in records]
    ref = reference(spec, seed, bodies, device, Precision.of(spec),
                    decode_latents=[o.latents.float().to(device) for o in served])
    return readings(served, ref, bodies)


# the controls of ``portbench.control``: ``lower`` sets the limits' upper readings;
# ``uncached`` is a second control of a cell whose body asks for a step cache
CONTROLS = ("lower", "uncached")


def control(spec: Dict, seed: int, bodies: List[Dict], device, name: str = "lower") -> Dict[str, float]:
    """The numbers a control reads, judged like the program: the reference one grid
    lower in the program's place (``lower``), or the reference at the configuration's
    grids run without the bodies' step cache (``uncached``); its pixels through the
    served JPEG."""
    if name == "lower":
        low = reference(spec, seed, bodies, device, Precision.of(spec, control=True))
    elif name == "uncached":
        low = reference(spec, seed, [{k: v for k, v in b.items() if k != "cache"} for b in bodies], device,
                        Precision.of(spec))
    else:
        raise ValueError(f"no control {name!r}: the family's are {CONTROLS}")
    ref = reference(spec, seed, bodies, device, Precision.of(spec), decode_latents=[o.latents for o in low])
    return readings(low, ref, bodies)


# ------------------------------------------------------------- work of an evaluation


def lengths(spec: Dict, body: Dict) -> Tuple[int, int]:
    """(image tokens, text tokens) of a request."""
    return (body["height"] // 16) * (body["width"] // 16), spec["spec"]["text_enc_max_length"]


def block_linears(params: Dict, l_img: int, l_txt: int) -> Iterator[Tuple[str, int, int, int]]:
    """(name, M, K, N) of every linear of the 57 blocks in one evaluation, modulation
    included (M = 1: the conditioning vector)."""
    hs = params["hidden_size"]
    mh = int(hs * params["mlp_ratio"])
    for _ in range(params["depth"]):
        for m in (l_img, l_txt):
            yield "mod", 1, hs, 6 * hs
            yield "qkv", m, hs, 3 * hs
            yield "proj", m, hs, hs
            yield "mlp0", m, hs, mh
            yield "mlp2", m, mh, hs
    for _ in range(params["depth_single_blocks"]):
        m = l_img + l_txt
        yield "mod", 1, hs, 3 * hs
        yield "linear1", m, hs, 3 * hs + mh
        yield "linear2", m, hs + mh, hs


def block_linear_flops(params: Dict, l_img: int, l_txt: int, modulation: bool = False) -> float:
    """2·M·K·N over the blocks' linears (the token-wise ones; with ``modulation`` the
    M = 1 modulation products too)."""
    return float(sum(2 * m * k * n for name, m, k, n in block_linears(params, l_img, l_txt)
                     if modulation or name != "mod"))


def attention_flops(params: Dict, l_joint: int) -> float:
    blocks = params["depth"] + params["depth_single_blocks"]
    hd = params["hidden_size"] // params["num_heads"]
    return float(blocks * 4 * params["num_heads"] * l_joint * l_joint * hd)


def float_linear_flops(params: Dict, l_img: int, l_txt: int) -> float:
    """The bf16 linears outside the blocks: img_in, txt_in, the conditioning MLPs and
    the final layer."""
    hs, c = params["hidden_size"], params["in_channels"]
    emb = 2 * (256 * hs + hs * hs) + 2 * (params["vec_in_dim"] * hs + hs * hs)
    if params["guidance_embed"]:
        emb += 2 * (256 * hs + hs * hs)
    return float(2 * l_img * c * hs + 2 * l_txt * params["context_in_dim"] * hs + emb
                 + 2 * hs * 2 * hs + 2 * l_img * hs * c)


def evaluation_ms(spec: Dict, body: Dict) -> float:
    """The least time of one flow evaluation, each operation at the peak of its
    precision: the blocks' linears at fp8, attention and the other linears at bf16."""
    params, (l_img, l_txt) = spec["spec"]["params"], lengths(spec, body)
    fp8 = block_linear_flops(params, l_img, l_txt, modulation=True) / flops.PEAK_FP8_FLOPS
    bf16 = (attention_flops(params, l_img + l_txt) + float_linear_flops(params, l_img, l_txt)) / flops.PEAK_BF16_FLOPS
    return (fp8 + bf16) * 1e3


def fp8_linears_ms(spec: Dict, body: Dict) -> float:
    """The least time of one evaluation's fp8 linears: each at the larger of its
    operations at the fp8 peak and its bytes (e5m2 activation and e4m3 weight read
    once, bf16 output written once)."""
    return sum(flops.bound(2 * m * k * n, m * k + k * n + 2 * m * n, flops.PEAK_FP8_FLOPS)[0]
               for _, m, k, n in block_linears(spec["spec"]["params"], *lengths(spec, body)))


def attention_ms(spec: Dict, body: Dict) -> float:
    """The least time of one evaluation's attention: K1's bound at the joint length,
    once per block."""
    p, (l_img, l_txt) = spec["spec"]["params"], lengths(spec, body)
    blocks, head_dim = p["depth"] + p["depth_single_blocks"], p["hidden_size"] // p["num_heads"]
    return blocks * flops.attention_bound(p["num_heads"], l_img + l_txt, head_dim)[0]
