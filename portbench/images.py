"""Input images of an editing mix, drawn from (run seed, request index) alone, so that
the loop that sends them and the family that judges them draw the same image without
either importing the other.

Request ``i``'s image is drawn at the request's own width and height: a smooth field
(a ``GRID`` × ``GRID`` grid of uniform RGB levels upsampled bicubically) plus Gaussian
pixel noise of ``NOISE`` levels, sent as a base64 JPEG at quality ``QUALITY``. A
photograph is smooth but for edges and grain; the field keeps the served encode's work
that of a real image without any file.
"""

import base64
import io

import numpy as np

GRID = 8
NOISE = 2.0
QUALITY = 95


def input_image(seed: int, i: int, width: int, height: int) -> str:
    """The base64 JPEG of request ``i`` of a run seeded ``seed``."""
    from PIL import Image

    rng = np.random.default_rng(np.random.SeedSequence([int(seed) & (2**64 - 1), i, 0xED17]))
    field = Image.fromarray(rng.integers(0, 256, size=(GRID, GRID, 3), dtype=np.uint8))
    pixels = np.asarray(field.resize((width, height), Image.BICUBIC), dtype=np.float32)
    pixels = np.clip(np.rint(pixels + rng.normal(0.0, NOISE, pixels.shape)), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, format="JPEG", quality=QUALITY)
    return base64.b64encode(buf.getvalue()).decode()
