"""VDSR's weights drawn from the seed on the device, OIHW f32: He init
(std sqrt(2 / fan_in)) in one draw, zero biases, the residual head times
the config's ``weights.residual_head_scale``; ``depth`` and ``ch`` are
the config's."""

import numpy as np
import torch

from perfbench import inputs


def load(config, seed, device):
    depth, ch = config["depth"], config["ch"]
    head_scale = config["weights"]["residual_head_scale"]
    n_mid = depth - 2
    sizes = (ch * 9, n_mid * ch * ch * 9, ch * 9)
    flat = torch.randn(sum(sizes), generator=inputs.generator(seed, 7, device),
                       device=device)
    w_in, w_mid, w_out = torch.split(flat, sizes)
    return {
        "in_w": (w_in * np.sqrt(2.0 / 9)).reshape(ch, 1, 3, 3),
        "in_b": torch.zeros(ch, device=device),
        "mid_w": (w_mid * np.sqrt(2.0 / (9 * ch))).reshape(n_mid, ch, ch, 3, 3),
        "mid_b": torch.zeros(n_mid, ch, device=device),
        "out_w": (w_out * (np.sqrt(2.0 / (9 * ch)) * head_scale)).reshape(1, ch, 3, 3),
        "out_b": torch.zeros(1, device=device),
    }
