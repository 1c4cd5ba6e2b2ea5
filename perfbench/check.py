"""The comparison that decides ``correct``.

Once the window has closed, each request that the run's reservoir kept
(drawn from the seed over the whole window) is recomputed by the plain
reference (:mod:`.reference.plain`) from the same input and weights, and
its outputs, as the timed entry returned them, are compared frame by
frame:

* ``rgb_off``: the worst frame's share of RGB values that differ;
* ``conv_off``: the worst frame's share of conv-map pixels that differ;
* ``conv_gap``: the largest conv-map difference, in u8 levels.

The conv-map numbers exist only where the entry returns a conv map.  A
cell's file (``cells/<cell>.json``) gives under ``limits`` the numbers it
compares and the limit of each; a number at or under its limit passes,
and one that is missing fails.  An output of the wrong shape or type
reads infinite on every number.
"""

from __future__ import annotations

import torch

from .reference import plain

NUMBERS = ("rgb_off", "conv_off", "conv_gap")


def frame_numbers(out: torch.Tensor, conv, ref_out: torch.Tensor,
                  ref_conv: torch.Tensor) -> dict:
    """The numbers of one frame's outputs against the reference's; the
    conv map's only where ``conv`` is not None."""
    nums = {"rgb_off": (out != ref_out).float().mean().item()}
    if conv is not None:
        dc = (conv.to(torch.int16) - ref_conv.to(torch.int16)).abs()
        nums.update(conv_off=(dc > 0).float().mean().item(),
                    conv_gap=float(dc.max().item()))
    return nums


def worst(a: dict, b: dict) -> dict:
    return {k: max(a.get(k, 0.0), b[k]) for k in b}


def compare(outputs: tuple, ref: tuple, batched: bool) -> dict:
    """The numbers of one request: the worst over its frames."""
    ref_out, ref_conv = ref
    dev = ref_out.device

    def on_ref(o):
        if o is None:
            return None
        t = torch.as_tensor(o).to(dev)
        return t if batched else t[None]

    out, conv = (on_ref(o) for o in outputs)
    if (out.shape != ref_out.shape or out.dtype != torch.uint8
            or conv is not None and (conv.shape != ref_conv.shape
                                     or conv.dtype != torch.uint8)):
        raise ValueError(f"outputs {tuple(out.shape)} {out.dtype} / "
                         f"{None if conv is None else (tuple(conv.shape), conv.dtype)}; "
                         f"the reference's are {tuple(ref_out.shape)} / "
                         f"{tuple(ref_conv.shape)} u8")
    nums = {}
    for f in range(ref_out.shape[0]):
        nums = worst(nums, frame_numbers(out[f], None if conv is None else conv[f],
                                         ref_out[f], ref_conv[f]))
    return nums


def reference(config: dict, params: dict, x, scale: float, batched: bool,
              device: torch.device, precision: str | None = None) -> tuple:
    """The plain reference's (out, conv) for input ``x`` (a clip tensor or a
    host still)."""
    frames = torch.as_tensor(x).to(device)
    if not batched:
        frames = frames[None]
    return plain.upscale(frames, config["model"], params, scale,
                         precision or config["reference_precision"])


def saturation(ref_conv: torch.Tensor) -> float:
    """Share of the reference's conv-map pixels at 0 or 255, where the
    [0, 255] clamp may have cut the model's value."""
    return ((ref_conv == 0) | (ref_conv == 255)).float().mean().item()


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """``(correct, [(name, value, limit), ...])`` over the numbers that
    have a limit; a number that is missing fails."""
    rows = [(k, numbers.get(k, float("inf")), float(v)) for k, v in limits.items()]
    return all(v <= lim for _, v, lim in rows), rows
