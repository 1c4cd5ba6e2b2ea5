"""The yardstick's arithmetic: a model's FLOPs, the bytes its conv stack
must move, and the least time the chip needs for them at its published
peaks.

The model's work is counted once, from the configuration's own numbers
(``macs_per_out_px``, ``n_params``, ``halo``, worked out from its
published widths), whatever implements it: K1's three TF32 products per
multiply-add, a kernel's re-reads of its halo, or cuDNN's algorithm do
not change it.
"""

from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
F32 = 4


def peaks() -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


def flops(config: dict, out_px: int) -> int:
    """Model FLOPs (two per multiply-add) of ``out_px`` output pixels."""
    return 2 * config["macs_per_out_px"] * out_px


def conv_bytes(config: dict, planes: int, h: int, w: int) -> int:
    """Bytes the conv stack must move for ``planes`` output planes of h x w
    in one call: its f32 input plane (with the ``halo`` the stack reads
    on each side), its f32 output plane and its f32 weights, each once."""
    p = config["halo"]
    return F32 * (planes * ((h + 2 * p) * (w + 2 * p) + h * w) + config["n_params"])


def least_seconds(config: dict, flop: float, nbytes: float) -> float:
    """The least time the chip needs: the larger of the work at the tier's
    peak and the bytes at the memory's peak."""
    pk = peaks()
    return max(flop / pk["flops"][config["peak"]], nbytes / pk["hbm_bytes_per_s"])
