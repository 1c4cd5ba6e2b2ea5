"""Inputs made from the seed: frames with structure at several scales.

Everything is drawn with a ``torch.Generator`` on the run's device, in a
few large calls per clip, so a seed gives the same frames on the same
card and set-up stays short.  A configuration's weights are drawn by its
own loader in ``weights/`` with :func:`generator`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

#: (cells across the short side, amplitude in u8 levels) of each octave of
#: smooth noise; the finest is per pixel
OCTAVES = ((3, 55.0), (12, 35.0), (48, 22.0), (192, 12.0))
PIXEL_NOISE = 5.0
#: straight edges per frame and their step height
EDGES, EDGE_STEP = 6, 40.0


def generator(seed: int, stream: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` for one use (``stream``) of ``seed``."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (2 ** 63))


def frames(n: int, h: int, w: int, seed: int, stream: int,
           device: torch.device) -> torch.Tensor:
    """``n`` u8 RGB frames ``[n, h, w, 3]``: smooth noise at four scales,
    sharp straight edges and a little per-pixel noise, around mid-grey."""
    g = generator(seed, stream, device)
    acc = torch.full((n, 3, h, w), 128.0, device=device)
    for cells, amp in OCTAVES:
        ch = max(2, cells * h // min(h, w))
        cw = max(2, cells * w // min(h, w))
        coarse = torch.randn((n, 3, ch, cw), generator=g, device=device)
        acc += amp * F.interpolate(coarse, size=(h, w), mode="bicubic",
                                   align_corners=False)
    acc += PIXEL_NOISE * torch.randn((n, 3, h, w), generator=g, device=device)
    # edges: a step across a random line, of a random signed height per channel
    yy = torch.linspace(-1.0, 1.0, h, device=device)[:, None]
    xx = torch.linspace(-1.0, 1.0, w, device=device)[None, :]
    lines = torch.rand((n, EDGES, 3), generator=g, device=device)
    heights = torch.randn((n, EDGES, 3), generator=g, device=device) * EDGE_STEP
    for e in range(EDGES):
        ang = lines[:, e, 0, None, None] * np.pi
        off = lines[:, e, 1, None, None] * 1.6 - 0.8
        side = (torch.cos(ang) * xx + torch.sin(ang) * yy > off).to(torch.float32)
        acc += side[:, None] * heights[:, e, :, None, None]
    return acc.clamp_(0.0, 255.0).round_().to(torch.uint8).permute(0, 2, 3, 1).contiguous()
