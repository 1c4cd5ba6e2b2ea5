"""VDSR (Kim et al. 2016) on the Y plane resized with bicubic: ``depth``
3x3 convs on edge-replicated planes, ReLU between them, the residual
added in f32 to the resized plane, clamp to [0, 255].  ``params``:
``in_w [C,1,3,3]``, ``mid_w [L,C,C,3,3]``, ``out_w [1,C,3,3]`` and their
biases."""

import torch

from . import plain


def y_path(params: dict, y: torch.Tensor, dst_h: int, dst_w: int,
           precision: str) -> torch.Tensor:
    y = plain.resize(y, dst_h, dst_w, "bicubic")
    x = y[:, None]
    with plain.precision_context(x.device, precision):
        h = torch.relu(plain.conv(x, params["in_w"], params["in_b"], 1, precision))
        for w, b in zip(params["mid_w"], params["mid_b"]):
            h = torch.relu(plain.conv(h, w, b, 1, precision))
        res = plain.conv(h, params["out_w"], params["out_b"], 1, precision)
    return torch.clamp(y + res[:, 0], 0.0, 255.0)
