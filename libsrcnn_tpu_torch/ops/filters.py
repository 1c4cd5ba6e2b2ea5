"""The five classical interpolation filter kernels.

Pure scalar math evaluated host-side (numpy float64) when building resize
contribution tables; never traced.  Formulas replicate `frawscale.h:60-172`:

* box      -- width 0.5, ``1 if |x| <= 0.5 else 0``            (`:60-70`)
* bilinear -- width 1,   ``1-|x| if |x| < 1``                  (`:72-84`)
* bicubic  -- width 2,   Mitchell-Netravali b=c=1/3            (`:86-121`)
* lanczos3 -- width 3,   ``sinc(x)*sinc(x/3)``                 (`:123-151`)
* bspline  -- width 2,   cubic B-spline                        (`:153-172`)
"""

from __future__ import annotations

import numpy as np

from ..config import FilterType


def box(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x <= 0.5, 1.0, 0.0)


def bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _mitchell_coeffs(b: float = 1.0 / 3.0, c: float = 1.0 / 3.0):
    # `frawscale.h:95-105`
    p0 = (6.0 - 2.0 * b) / 6.0
    p2 = (-18.0 + 12.0 * b + 6.0 * c) / 6.0
    p3 = (12.0 - 9.0 * b - 6.0 * c) / 6.0
    q0 = (8.0 * b + 24.0 * c) / 6.0
    q1 = (-12.0 * b - 48.0 * c) / 6.0
    q2 = (6.0 * b + 30.0 * c) / 6.0
    q3 = (-b - 6.0 * c) / 6.0
    return p0, p2, p3, q0, q1, q2, q3


def bicubic(x: np.ndarray) -> np.ndarray:
    p0, p2, p3, q0, q1, q2, q3 = _mitchell_coeffs()
    x = np.abs(x)
    inner = p0 + x * x * (p2 + x * p3)
    outer = q0 + x * (q1 + x * (q2 + x * q3))
    return np.where(x < 1.0, inner, np.where(x < 2.0, outer, 0.0))


def lanczos3(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)

    def sinc(v):
        vp = v * np.pi
        return np.where(v != 0.0, np.divide(np.sin(vp), np.where(vp == 0, 1.0, vp)), 1.0)

    return np.where(x < 3.0, sinc(x) * sinc(x / 3.0), 0.0)


def bspline(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    t = 2.0 - x
    inner = (4.0 + x * x * (-6.0 + 3.0 * x)) / 6.0
    outer = t * t * t / 6.0
    return np.where(x < 1.0, inner, np.where(x < 2.0, outer, 0.0))


#: filter function and support width per FilterType (`frawscale.h` defaults)
FILTERS = {
    FilterType.NEAREST: (box, 0.5),
    FilterType.BILINEAR: (bilinear, 1.0),
    FilterType.BICUBIC: (bicubic, 2.0),
    FilterType.LANCZOS3: (lanczos3, 3.0),
    FilterType.BSPLINE: (bspline, 2.0),
}
