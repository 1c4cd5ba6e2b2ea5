"""FreeImage-style separable-resampling contribution tables.

Host-side (numpy float64) replica of `FRawScaleWeightsTable`
(`frawscale.cpp:8-112`), producing a *band* form (per-output left index +
fixed-width weight window) that the device resampler consumes as one
``index_select`` and multiply-add per tap.  The math must match the reference's double-precision
construction exactly:

* ``scale = dst/src``; downscale widens the filter support by ``1/scale``
  and pre-scales the argument (`frawscale.cpp:25-29`).
* window size ``2*ceil(width)+1`` (`:35`).
* center ``u/scale + (0.5/scale - 0.5)`` (`:46-50`).
* boundary clamp to ``[0, src-1]`` with window-overflow nudge (`:52-65`).
  NOTE: the reference's overflow test ``iLeft < (int(uSrcSize) - 1 / 2)``
  parses as ``iLeft < uSrcSize`` (integer ``1/2 == 0``), which is always
  true, so overflow always increments the left edge -- replicated here.
* weight ``fscale * Filter(fscale * (center - i))`` then normalization when
  the sum is > 0 and != 1 (`:75-93`).  The zero-trim of trailing zero
  weights (`:95-107`) only shrinks the loop bound and is numerically
  irrelevant, so it is not replicated.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from ..config import FilterType
from .filters import FILTERS


@functools.lru_cache(maxsize=256)
def contribution_table(filter_type: FilterType, dst_size: int, src_size: int):
    """Build the band-form contribution table.

    Returns:
      left:    int32 [dst]   -- leftmost source index per output coordinate
      weights: float64 [dst, window] -- normalized weights; entries past the
               right boundary are zero.
    """
    filt, fwidth = FILTERS[FilterType(filter_type)]
    scale = float(dst_size) / float(src_size)
    if scale < 1.0:
        width = fwidth / scale
        fscale = scale
    else:
        width = fwidth
        fscale = 1.0

    window = 2 * int(math.ceil(width)) + 1
    offset = (0.5 / scale) - 0.5

    left = np.zeros((dst_size,), dtype=np.int32)
    weights = np.zeros((dst_size, window), dtype=np.float64)

    for u in range(dst_size):
        center = u / scale + offset
        ileft = max(0, int(math.floor(center - width)))
        iright = min(int(math.ceil(center + width)), src_size - 1)
        if (iright - ileft + 1) > window:
            # reference quirk: condition is effectively always true
            ileft += 1

        taps = np.arange(ileft, iright + 1, dtype=np.float64)
        w = fscale * filt(fscale * (center - taps))
        total = w.sum()
        if total > 0.0 and total != 1.0:
            w = w / total

        left[u] = ileft
        weights[u, : w.size] = w

    return left, weights

