"""SRCNN 9-1-5 (Dong et al. 2014) on the Y plane resized with bicubic:
conv1 9x9 on the plane replicate-padded by 4, ReLU; conv2 1x1, ReLU;
conv3 5x5 on conv2's output replicate-padded by 2 (the clamp of conv2's
ring to the image); clamp to [0, 255].  ``params`` are OIHW ``w1 b1 w2
b2 w3 b3``."""

import torch

from . import plain


def y_path(params: dict, y: torch.Tensor, dst_h: int, dst_w: int,
           precision: str) -> torch.Tensor:
    x = plain.resize(y, dst_h, dst_w, "bicubic")[:, None]
    with plain.precision_context(x.device, precision):
        h1 = torch.relu(plain.conv(x, params["w1"], params["b1"], 4, precision))
        h2 = torch.relu(plain.conv(h1, params["w2"], params["b2"], 0, precision))
        out = plain.conv(h2, params["w3"], params["b3"], 2, precision)
    return torch.clamp(out[:, 0], 0.0, 255.0)
