"""Image fidelity metrics: SSIM and PSNR in numpy, float64 (JAX counterpart:
``flux_fp8_api_tpu.utils.fidelity``, copied so that the port imports nothing of the
JAX package).

The fidelity gate (fp8 output SSIM ≥ 0.95 against bf16, ``bench_fidelity``) and the
step-cache sweep (``bench_cache``) use them. SSIM is Wang et al. 2004 with an 11×11
Gaussian window (σ = 1.5), channel-averaged.
"""

from __future__ import annotations

import numpy as np


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-0.5 * (ax / sigma) ** 2)
    k2 = np.outer(k, k)
    return k2 / k2.sum()


def _filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Valid-mode 2-D correlation per channel over sliding windows."""
    kh, kw = kernel.shape
    windows = np.lib.stride_tricks.sliding_window_view(img, (kh, kw), axis=(0, 1))
    # windows: (out_h, out_w, [C,] kh, kw)
    return np.einsum("...ij,ij->...", windows, kernel)


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Mean SSIM between two (H, W) or (H, W, C) images."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"ssim of images of shapes {a.shape} and {b.shape}")
    if a.ndim == 3:
        return float(np.mean([ssim(a[..., c], b[..., c], data_range) for c in range(a.shape[-1])]))
    k = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _filter2d(a, k)
    mu_b = _filter2d(b, k)
    mu_a2, mu_b2, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sigma_a2 = _filter2d(a * a, k) - mu_a2
    sigma_b2 = _filter2d(b * b, k) - mu_b2
    sigma_ab = _filter2d(a * b, k) - mu_ab
    num = (2 * mu_ab + c1) * (2 * sigma_ab + c2)
    den = (mu_a2 + mu_b2 + c1) * (sigma_a2 + sigma_b2 + c2)
    return float(np.mean(num / den))


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB; inf for identical images."""
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(data_range**2 / mse))
