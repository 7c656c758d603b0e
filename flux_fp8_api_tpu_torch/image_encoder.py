"""Image array → JPEG bytes (JAX counterpart: ``flux_fp8_api_tpu.image_encoder``;
reference ``image_encoder.py:1-35`` + the normalization at ``flux_pipeline.py:373-397``).

Host-side PIL encoding of NHWC arrays: uint8, or float in [-1, 1].
"""

from __future__ import annotations

import io
from typing import List

import numpy as np
from PIL import Image


class ImageEncoder:
    def encode_array(self, x: np.ndarray, quality: int = 95) -> io.BytesIO:
        """(H, W, 3) or (B, H, W, 3) float in [-1, 1] — or already-normalized uint8 —
        → JPEG bytes.

        The pipeline's decode emits uint8 on the device (4× less transfer than fp32);
        floats are normalized here for direct callers. Multiple images stack
        vertically, matching the reference's ``torch.vstack``
        (flux_pipeline.py:390-393).
        """
        x = np.asarray(x)
        if x.dtype != np.uint8:
            x = np.asarray(x, dtype=np.float32)
        if x.ndim == 3:
            x = x[None]
        if x.dtype == np.uint8:
            imgs: List[np.ndarray] = list(x)
        else:
            imgs = [
                np.clip((np.clip(x[i], -1.0, 1.0) + 1.0) * 127.5, 0, 255).astype(np.uint8)
                for i in range(x.shape[0])
            ]
        stacked = imgs[0] if len(imgs) == 1 else np.vstack(imgs)
        im = Image.fromarray(stacked)
        buf = io.BytesIO()
        im.save(buf, format="JPEG", quality=quality)
        buf.seek(0)
        return buf
