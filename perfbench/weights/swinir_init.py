"""SwinIR's weights drawn from the seed on the device, f32, in the layout of
``libsrcnn_tpu_torch/models/swinir.py`` (the Swin layers' tensors stacked
over the ``sum(depths)`` layers, the groups' convs over the groups): Linear
weights and the relative-position bias tables truncated normal, std 0.02;
Linear biases N(0, 0.02^2); LayerNorm gains 1 + N(0, 0.1^2) and shifts
N(0, 0.1^2); convs uniform within 1 / sqrt(fan_in), biases too;
``conv_last``'s bias 0.5.  The widths are the config's published ones:
``embed_dim``, ``depths``, ``num_heads``, ``window_size``, ``mlp_ratio``,
``num_feat``, ``upscale``, ``in_chans``."""

import math

import torch

from perfbench import inputs


def load(config, seed, device):
    e, f, c_in = config["embed_dim"], config["num_feat"], config["in_chans"]
    depths, heads = config["depths"], config["num_heads"]
    if len(set(depths)) != 1 or len(set(heads)) != 1:
        raise ValueError("the stacked layout takes equal depths and heads per group")
    layers, groups, m = sum(depths), len(depths), int(e * config["mlp_ratio"])
    ws, scale = config["window_size"], config["upscale"]
    r, n_up = (3, 1) if scale == 3 else (2, int(math.log2(scale)))
    g = inputs.generator(seed, 11, device)

    def trunc(*shape):
        return torch.nn.init.trunc_normal_(torch.empty(shape, device=device), std=0.02,
                                           generator=g)

    def normal(std, *shape):
        return torch.randn(shape, generator=g, device=device) * std

    def uniform(fan_in, *shape):
        return (torch.rand(shape, generator=g, device=device) * 2 - 1) / math.sqrt(fan_in)

    def conv(o, i, *lead):
        return uniform(9 * i, *lead, o, i, 3, 3), uniform(9 * i, *lead, o)

    p = {}
    p["conv_first_w"], p["conv_first_b"] = conv(e, c_in)
    p["patch_norm_w"], p["patch_norm_b"] = 1 + normal(0.1, e), normal(0.1, e)
    for name in ("norm1", "norm2"):
        p[f"stl.{name}_w"] = 1 + normal(0.1, layers, e)
        p[f"stl.{name}_b"] = normal(0.1, layers, e)
    for name, o, i in (("qkv", 3 * e, e), ("proj", e, e), ("fc1", m, e), ("fc2", e, m)):
        p[f"stl.{name}_w"], p[f"stl.{name}_b"] = trunc(layers, o, i), normal(0.02, layers, o)
    p["stl.bias_table"] = trunc(layers, (2 * ws - 1) ** 2, heads[0])
    p["group.conv_w"], p["group.conv_b"] = conv(e, e, groups)
    p["norm_w"], p["norm_b"] = 1 + normal(0.1, e), normal(0.1, e)
    p["conv_after_body_w"], p["conv_after_body_b"] = conv(e, e)
    p["conv_before_up_w"], p["conv_before_up_b"] = conv(f, e)
    p["up.conv_w"], p["up.conv_b"] = conv(r * r * f, f, n_up)
    p["conv_last_w"], _ = conv(c_in, f)
    p["conv_last_b"] = torch.full((c_in,), 0.5, device=device)
    return p
