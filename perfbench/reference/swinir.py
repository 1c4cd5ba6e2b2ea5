"""SwinIR (Liang et al. 2021, arXiv 2108.10257), classical SR with a
pixel-shuffle head, on the LR Y plane, written from the paper's and the
official ``network_swinir.py``'s equations: ``x = y / 255`` reflect-padded
at the bottom and right to a multiple of the window; a 3x3 conv; the patch
embed's LayerNorm; residual groups of Swin layers (LayerNorm, windowed
multi-head attention with the relative-position bias and, on every second
layer, the cyclic shift by half a window and its -100 mask; LayerNorm, a
GELU MLP), each group closed by a 3x3 conv and its input; a final
LayerNorm and a 3x3 conv plus the first conv's features; a 3x3 conv and
LeakyReLU(0.01); conv and pixel shuffle per upscale step; a 3x3 conv to
one channel; crop, times 255, clamp to [0, 255].  Every conv pads with
zeros.  One frame at a time; tokens ``[H, W, C]``.

``params``: the program's layout (``libsrcnn_tpu_torch/models/swinir.py``),
read here by name and shape alone.  ``precision``: ``"f32"``; ``"bf16"``,
the operands of every matmul and conv (the attention's products included)
rounded to bf16 with f32 sums; ``"tf32"``, TF32 allowed on the card and
its operand rounding emulated on the CPU.
"""

import math

import torch
import torch.nn.functional as F

from . import plain

EPS = 1e-5


def _round(t, precision):
    if precision == "bf16":
        return plain.round_bf16(t)
    if precision == "tf32" and t.device.type != "cuda":
        return plain.round_tf32(t)
    return t


def _matmul(a, b, precision):
    return _round(a, precision) @ _round(b, precision)


def _linear(x, w, b, precision):
    return _matmul(x, w.t(), precision) + b


def _conv3(x, w, b, precision):
    """3x3 conv with zero padding of ``[C, H, W]`` -> ``[O, H, W]``."""
    x = F.pad(_round(x, precision), (1, 1, 1, 1))
    return F.conv2d(x[None], _round(w, precision))[0] + b[:, None, None]


def layer_norm(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + EPS) * g + b


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def relative_index(ws):
    """``[ws^2, ws^2]``: for tokens p, q of a window, the bias table's row
    of their offset, ``(dy + ws - 1) (2 ws - 1) + dx + ws - 1``."""
    r = torch.arange(ws * ws)
    dy = (r // ws)[:, None] - (r // ws)[None, :]
    dx = (r % ws)[:, None] - (r % ws)[None, :]
    return (dy + ws - 1) * (2 * ws - 1) + dx + ws - 1


def shift_mask(hp, wp, ws, s):
    """``[windows, ws^2, ws^2]``: 0 between tokens of one region of the
    shifted plane, -100 between tokens of two (on each axis the regions
    are the lines before ``n - ws``, before ``n - s``, and the rest)."""
    def region(n):
        i = torch.arange(n)
        return (i >= n - ws).long() + (i >= n - s).long()

    reg = region(hp)[:, None] * 3 + region(wp)[None, :]
    win = windows(reg[..., None], ws)[..., 0]
    return torch.where(win[:, :, None] == win[:, None, :], 0.0, -100.0)


def windows(t, ws):
    """``[H, W, C]`` -> ``[windows, ws^2, C]``, windows row-major."""
    h, w, c = t.shape
    return t.reshape(h // ws, ws, w // ws, ws, c).transpose(1, 2).reshape(-1, ws * ws, c)


def unwindow(t, h, w, ws):
    c = t.shape[-1]
    return t.reshape(h // ws, w // ws, ws, ws, c).transpose(1, 2).reshape(h, w, c)


def attention(p, i, t, heads, ws, s, precision):
    """Layer ``i``'s windowed attention on tokens ``t`` ``[H, W, C]``,
    shifted by ``s``; its output, before the residual."""
    h, w, c = t.shape
    hd, n = c // heads, ws * ws
    x = layer_norm(t, p["stl.norm1_w"][i], p["stl.norm1_b"][i])
    x = windows(torch.roll(x, (-s, -s), (0, 1)), ws)
    qkv = _linear(x, p["stl.qkv_w"][i], p["stl.qkv_b"][i], precision)

    def split(z):
        return z.reshape(-1, n, heads, hd).transpose(1, 2)     # [windows, heads, n, hd]

    q, k, v = (split(qkv[..., j * c:(j + 1) * c]) for j in range(3))
    scores = _matmul(q * hd ** -0.5, k.transpose(-1, -2), precision)
    table = p["stl.bias_table"][i]
    scores = scores + table[relative_index(ws).to(t.device)].permute(2, 0, 1)
    if s:
        scores = scores + shift_mask(h, w, ws, s).to(t.device)[:, None]
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    o = _matmul(e / e.sum(-1, keepdim=True), v, precision)
    o = _linear(o.transpose(1, 2).reshape(-1, n, c), p["stl.proj_w"][i],
                p["stl.proj_b"][i], precision)
    return torch.roll(unwindow(o, h, w, ws), (s, s), (0, 1))


def mlp(p, i, t, precision):
    x = _linear(layer_norm(t, p["stl.norm2_w"][i], p["stl.norm2_b"][i]),
                p["stl.fc1_w"][i], p["stl.fc1_b"][i], precision)
    return _linear(gelu(x), p["stl.fc2_w"][i], p["stl.fc2_b"][i], precision)


def pixel_shuffle(x, r):
    """``[r^2 C, H, W]`` -> ``[C, r H, r W]``: channel ``c r^2 + dy r + dx``
    is sub-pixel (dy, dx) of output channel c."""
    rc, h, w = x.shape
    c = rc // (r * r)
    return x.reshape(c, r, r, h, w).permute(0, 3, 1, 4, 2).reshape(c, h * r, w * r)


def y_path(params, y, dst_h, dst_w, precision):
    p = params
    layers, _, c = p["stl.qkv_w"].shape
    table, heads = p["stl.bias_table"].shape[1:]
    groups = p["group.conv_w"].shape[0]
    ws = (math.isqrt(table) + 1) // 2
    up_w, up_b = p["up.conv_w"], p["up.conv_b"]
    r = math.isqrt(up_w.shape[1] // up_w.shape[2])
    scale = r ** up_w.shape[0]
    _, h, w = y.shape
    if (dst_h, dst_w) != (scale * h, scale * w):
        raise ValueError(f"SwinIR x{scale} maps {h}x{w} to {scale * h}x{scale * w}, "
                         f"not {dst_h}x{dst_w}")
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    with plain.precision_context(y.device, precision):
        x = F.pad(y[:, None] / 255.0, (0, wp - w, 0, hp - h), mode="reflect")[0]
        f = _conv3(x, p["conv_first_w"], p["conv_first_b"], precision)
        t = layer_norm(f.permute(1, 2, 0), p["patch_norm_w"], p["patch_norm_b"])
        depth = layers // groups
        for g in range(groups):
            t0 = t
            for i in range(g * depth, (g + 1) * depth):
                s = ws // 2 if i % 2 else 0
                t = t + attention(p, i, t, heads, ws, s, precision)
                t = t + mlp(p, i, t, precision)
            res = _conv3(t.permute(2, 0, 1), p["group.conv_w"][g], p["group.conv_b"][g],
                         precision)
            t = t0 + res.permute(1, 2, 0)
        t = layer_norm(t, p["norm_w"], p["norm_b"])
        f = _conv3(t.permute(2, 0, 1), p["conv_after_body_w"], p["conv_after_body_b"],
                   precision) + f
        f = F.leaky_relu(_conv3(f, p["conv_before_up_w"], p["conv_before_up_b"],
                                precision), 0.01)
        for k in range(up_w.shape[0]):
            f = pixel_shuffle(_conv3(f, up_w[k], up_b[k], precision), r)
        out = _conv3(f, p["conv_last_w"], p["conv_last_b"], precision)
    return torch.clamp(out[:, :dst_h, :dst_w] * 255.0, 0.0, 255.0)
