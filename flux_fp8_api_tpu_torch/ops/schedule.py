"""Flow-matching timestep schedule (reference ``flux_pipeline.py:314-344``).

Pure NumPy/Python host-side metadata, identical to ``flux_fp8_api_tpu.ops.schedule``.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np


def time_shift(mu: float, sigma: float, t):
    """Sigma-shifted schedule warp (reference ``flux_pipeline.py:315-316``)."""
    t = np.asarray(t, dtype=np.float64)
    return math.exp(mu) / (math.exp(mu) + (1 / t - 1) ** sigma)


def get_lin_function(
    x1: float = 256, y1: float = 0.5, x2: float = 4096, y2: float = 1.15
):
    """Linear mu estimator in image_seq_len (reference ``flux_pipeline.py:318-324``)."""
    m = (y2 - y1) / (x2 - x1)
    b = y1 - m * x1
    return lambda x: m * x + b


def get_schedule(
    num_steps: int,
    image_seq_len: int,
    base_shift: float = 0.5,
    max_shift: float = 1.15,
    shift: bool = True,
) -> List[float]:
    """Timesteps 1→0, optionally warped toward high t for large images
    (reference ``flux_pipeline.py:326-344``). Returns ``num_steps + 1`` floats.
    """
    timesteps = np.linspace(1.0, 0.0, num_steps + 1)
    if shift:
        mu = get_lin_function(y1=base_shift, y2=max_shift)(image_seq_len)
        with np.errstate(divide="ignore"):
            timesteps = time_shift(mu, 1.0, timesteps)
        timesteps[-1] = 0.0  # t=0 endpoint maps through the warp to exactly 0
    return [float(t) for t in timesteps]
