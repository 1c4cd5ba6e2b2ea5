"""Image quality metrics (numpy, host-side).

The reference ships no metrics at all (SURVEY.md section 4) -- its
verification is visual diff against `Pictures/` goldens.  The port
quantifies parity: PSNR and SSIM (Wang et al. 2004, gaussian-windowed) on
u8 images, used by the golden gate (>=0.999 SSIM vs the reference
binary) in the tests and in ``chip_smoke.py``.  A copy of
``libsrcnn_tpu/eval/metrics.py``: that module cannot be imported without
running ``libsrcnn_tpu/__init__``, which imports jax.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0, win: int = 7) -> float:
    """Mean SSIM with a uniform window (scikit-image default style).

    Accepts [H,W] or [H,W,C]; channels are averaged.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.ndim == 3:
        return float(np.mean([ssim(a[..., c], b[..., c], data_range, win)
                              for c in range(a.shape[-1])]))

    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_a = uniform_filter(a, win)
    mu_b = uniform_filter(b, win)
    mu_aa = uniform_filter(a * a, win)
    mu_bb = uniform_filter(b * b, win)
    mu_ab = uniform_filter(a * b, win)

    # unbiased covariance correction as in scikit-image
    np_ = win * win
    cov_norm = np_ / (np_ - 1)
    var_a = cov_norm * (mu_aa - mu_a * mu_a)
    var_b = cov_norm * (mu_bb - mu_b * mu_b)
    cov = cov_norm * (mu_ab - mu_a * mu_b)

    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    s = num / den

    pad = (win - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean()) if pad else float(s.mean())
