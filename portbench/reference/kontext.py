"""FLUX.1 Kontext [dev] in-context editing in float32, after BFL's
``flux/sampling.py`` (``prepare_kontext`` and ``denoise``) and the encoder of
``flux/modules/autoencoder.py``: the context image is decoded, resized (PIL LANCZOS)
to the preferred Kontext resolution nearest its aspect ratio, encoded by the VAE's
encoder, packed 2×2 and given position ids (1, row, col); every evaluation of the flow
takes its tokens after the ones being denoised, and the prediction is cut back to
those before the Euler step. The schedule is warped by the target's tokens alone.

Departure from BFL: the encode takes the posterior's mean (diffusers'
``FluxKontextPipeline``, ``sample_mode="argmax"``), where BFL's ``AutoEncoder.encode``
samples it. The flow, the decoder and the request's other helpers are the text-to-image
reference's (``flux.py``, ``ae.py``, ``pipeline.py``), unchanged.
"""

from __future__ import annotations

import base64
import io
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .ae import Decoder
from .flux import Flux
from .pipeline import img_ids, is_schnell, noise, pack, schedule

# (width, height) pairs Kontext was trained at: BFL flux/sampling.py PREFERED_KONTEXT_RESOLUTIONS
PREFERRED_RESOLUTIONS = (
    (672, 1568), (688, 1504), (720, 1456), (752, 1392), (800, 1328), (832, 1248), (880, 1184), (944, 1104),
    (1024, 1024), (1104, 944), (1184, 880), (1248, 832), (1328, 800), (1392, 752), (1456, 720), (1504, 688),
    (1568, 672),
)


def decode_image(data: str) -> np.ndarray:
    """A base64 image (or a data URL) → (H, W, 3) uint8 RGB."""
    from PIL import Image

    return np.array(Image.open(io.BytesIO(base64.b64decode(data.split(",")[-1]))).convert("RGB"))


def preferred_size(width: int, height: int) -> Tuple[int, int]:
    """BFL ``prepare_kontext``: the preferred (width, height) nearest the image's aspect
    ratio (``min`` over (|Δ aspect|, w, h)), in multiples of 16 pixels."""
    aspect = width / height
    _, w, h = min((abs(aspect - w / h), w, h) for w, h in PREFERRED_RESOLUTIONS)
    return 16 * int(w / 16), 16 * int(h / 16)


def resize(pixels: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 → the same image at :func:`preferred_size`, PIL LANCZOS."""
    from PIL import Image

    return np.array(Image.fromarray(pixels).resize(preferred_size(pixels.shape[1], pixels.shape[0]),
                                                   Image.Resampling.LANCZOS))


class Encoder(Decoder):
    """The autoencoder's encoder (BFL ``Encoder``): conv_in; down levels of
    ``num_res_blocks`` resnets, each level but the last ending in a stride-2 3×3 conv
    after a pad of one row below and one column right; a middle of resnet / attention /
    resnet; group norm, swish and conv_out to 2·z channels (mean | log-variance). The
    convolutions, norms, resnets and attention are the decoder's, on the same grid."""

    def down(self, name, x):
        w = self._weight(f"{name}.weight")
        return F.conv2d(F.pad(x, (0, 1, 0, 1)), w, self.w.get(f"{name}.bias").float(), stride=2)

    def moments(self, x: torch.Tensor) -> torch.Tensor:
        """Image (B, 3, H, W) in [-1, 1] → (B, 2·z, H/8, W/8)."""
        a = self.a
        h = self.conv("encoder.conv_in", x.float())
        for i in range(len(a["ch_mult"])):
            for j in range(a["num_res_blocks"]):
                h = self.resnet(f"encoder.down.{i}.block.{j}", h)
            if i != len(a["ch_mult"]) - 1:
                h = self.down(f"encoder.down.{i}.downsample.conv", h)
        h = self.resnet("encoder.mid.block_1", h)
        h = self.attn("encoder.mid.attn_1", h)
        h = self.resnet("encoder.mid.block_2", h)
        return self.conv("encoder.conv_out", F.silu(self.gn("encoder.norm_out", h)))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Image (B, 3, H, W) → latents (B, z, H/8, W/8): the posterior's mean, scaled
        and shifted as ``AutoEncoder.encode`` does."""
        mean = self.moments(x).chunk(2, dim=1)[0]
        return self.a["scale_factor"] * (mean - self.a["shift_factor"])


def context_ids(h: int, w: int, device) -> torch.Tensor:
    """(1, (h/2)(w/2), 3) ids of a context of latent size h × w: (1, row, col)."""
    ids = img_ids(h, w, device)
    ids[..., 0] = 1.0
    return ids


@torch.no_grad()
def context(encoder: Encoder, pixels: np.ndarray, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A context image (H, W, 3) uint8 → (packed latents (1, L_ctx, 4·z), ids (1, L_ctx, 3))."""
    x = torch.from_numpy(resize(pixels).astype(np.float32) / 127.5 - 1.0).permute(2, 0, 1)[None].to(device)
    z = encoder(x)
    return pack(z), context_ids(z.shape[-2], z.shape[-1], device)


@torch.no_grad()
def denoise(flow: Flux, spec: Dict, vec, txt, seed: int, width: int, height: int, steps: int, guidance: float,
            ctx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """The request's final packed latents (1, L_img, 64): the text-to-image reference's
    Euler loop (noise, schedule over the target's tokens, bf16 timestep and guidance),
    each evaluation over the target's tokens then ``ctx``'s (packed latents, ids), its
    prediction cut to the target's. ``ctx`` None runs it without a context."""
    device = txt.device
    height, width = 16 * (height // 16), 16 * (width // 16)
    x0 = noise(seed, height, width, spec["spec"]["params"]["in_channels"] // 4, device)
    ts = schedule(steps, x0.shape[-1] * x0.shape[-2] // 4, shift=not is_schnell(spec))
    x = pack(x0)
    ids = img_ids(x0.shape[-2], x0.shape[-1], device)
    if ctx is not None:
        ids = torch.cat([ids, ctx[1]], dim=1)
    txt_ids = torch.zeros(1, txt.shape[1], 3, device=device)
    g = torch.full((1,), guidance, device=device).to(torch.bfloat16)
    for tc, tp in zip(ts[:-1], ts[1:]):
        t = torch.full((1,), tc, device=device).to(torch.bfloat16)
        inp = x if ctx is None else torch.cat([x, ctx[0]], dim=1)
        v = flow(inp, ids, txt, txt_ids, t, vec, g)[:, :x.shape[1]]
        x = x + (tp - tc) * v
    return x
