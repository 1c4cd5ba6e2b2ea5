"""SwinIR (Liang et al., "SwinIR: Image Restoration Using Swin Transformer",
ICCV Workshops 2021, arXiv 2108.10257), classical SR, an LR-domain family.

It follows ``models/network_swinir.py`` of the official code with
``upsampler='pixelshuffle'``, ``resi_connection='1conv'``, ``img_range``
1 and one input channel (the Y plane, mean 0), on [H, W] planes in
[0, 255]:

1. ``x = y / 255``, reflect-padded at the bottom and right to a multiple
   of the window;
2. ``f = conv_first(x)`` (3x3, 1 -> embed), then the patch embed's
   LayerNorm over the tokens;
3. ``n_groups`` residual groups, each ``depth`` Swin layers, a 3x3 conv
   and the group's input added; then a final LayerNorm;
4. Swin layer ``i`` (0-based over the whole body) shifts by ``s = 0`` for
   even ``i`` and ``window // 2`` for odd ``i``:
   ``t += proj(WA(roll(LN1(t), -s)))`` rolled back by ``+s``, then
   ``t += fc2(GELU(fc1(LN2(t))))`` (GELU in its erf form).  ``WA`` is
   multi-head self-attention inside each ``window`` x ``window`` window:
   ``q`` scaled by ``head_dim ** -0.5``, scores plus the learned relative
   position bias (a ``(2 window - 1)^2`` x heads table gathered to
   ``window^2`` x ``window^2`` per head) and, on the shifted layers,
   SwinIR's ``calculate_mask`` for the padded size (-100 between tokens
   that the shift brought together from different regions), softmax;
5. ``f = conv_after_body(body) + f``; 3x3 conv embed -> num_feat and
   LeakyReLU(0.01); per x2 (or the one x3) step a 3x3 conv num_feat ->
   r^2 num_feat and a pixel shuffle by r; ``conv_last`` 3x3 num_feat -> 1.
   Every conv pads with zeros, as published;
6. crop to ``scale H`` x ``scale W``, times 255, clamped to [0, 255].

Parameters are one flat dict of f32 tensors, the Swin layers' and the
groups' stacked along a leading axis (layer ``i`` of group ``g`` is entry
``g * depth + i``); Linear weights are ``[out, in]``, convs OIHW:

* ``conv_first_w [E, 1, 3, 3]``, ``conv_first_b [E]``;
* ``patch_norm_w``, ``patch_norm_b [E]`` (the patch embed's LayerNorm);
* ``stl.norm1_w``, ``stl.norm1_b``, ``stl.norm2_w``, ``stl.norm2_b`` ``[L, E]``;
* ``stl.qkv_w [L, 3E, E]``, ``stl.qkv_b [L, 3E]`` (q, k, v in that order,
  heads inside each);
* ``stl.bias_table [L, (2 window - 1)^2, heads]``;
* ``stl.proj_w [L, E, E]``, ``stl.proj_b [L, E]``;
* ``stl.fc1_w [L, M, E]``, ``stl.fc1_b [L, M]``, ``stl.fc2_w [L, E, M]``,
  ``stl.fc2_b [L, E]``;
* ``group.conv_w [G, E, E, 3, 3]``, ``group.conv_b [G, E]``;
* ``norm_w``, ``norm_b [E]`` (the final LayerNorm);
* ``conv_after_body_w [E, E, 3, 3]``, ``conv_after_body_b [E]``;
* ``conv_before_up_w [F, E, 3, 3]``, ``conv_before_up_b [F]``;
* ``up.conv_w [n, r^2 F, F, 3, 3]``, ``up.conv_b [n, r^2 F]``;
* ``conv_last_w [1, F, 3, 3]``, ``conv_last_b [1]``.

Only the ``float32`` tier exists: every matmul, attention product and conv
runs in exact f32 (TF32 off in cuBLAS and cuDNN, :func:`.srcnn.exact_f32`),
whatever the process's global flags say; the 3x3 convs go through
:func:`..ops.conv.conv` after a zero pad.  No trained Y-plane SwinIR
ships, so :func:`load_params` raises: pass ``params``.  No hand kernel runs
this family.

A band or tile of the frame is not the frame: the window grid is anchored
at the frame's corner and the shifted windows chain every window to its
neighbours through all the layers, so no finite halo gives the frame's
values back (``upscale_chunked`` and the tiled path refuse the family).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from ..ops.conv import conv
from ..utils.profiling import counts, span
from .srcnn import exact_f32

#: LayerNorm's epsilon, as published
LN_EPS = 1e-5
#: LeakyReLU slope of the head, PyTorch's default as published
LEAKY_SLOPE = 0.01
#: the shift mask's value between tokens of different regions
MASK_VALUE = -100.0


@dataclasses.dataclass(frozen=True)
class SwinIRSpec:
    """Classical SR x2 as published: ``embed_dim`` 180, ``depths`` [6] * 6,
    ``num_heads`` [6] * 6, ``window_size`` 8, ``mlp_ratio`` 2, ``num_feat``
    64."""
    embed: int = 180
    n_groups: int = 6
    depth: int = 6
    heads: int = 6
    window: int = 8
    mlp: int = 360
    num_feat: int = 64
    scale: int = 2

    @property
    def layers(self) -> int:
        return self.n_groups * self.depth

    @property
    def shift(self) -> int:
        return self.window // 2


def upsample_steps(scale: int) -> tuple[int, int]:
    """(r, n): SwinIR's ``Upsample`` is ``n`` conv + pixel-shuffle-by-``r``
    steps, ``log2(scale)`` x2 steps for a power of two, one x3 step for 3."""
    if scale == 3:
        return 3, 1
    if scale >= 2 and scale & (scale - 1) == 0:
        return 2, scale.bit_length() - 1
    raise ValueError(f"SwinIR's pixel-shuffle head takes scale 2^n or 3, got {scale}")


def spec_of(params: dict) -> SwinIRSpec:
    """The SwinIRSpec of the parameters, from their shapes: the window and
    the heads from the bias table's ``[(2 window - 1)^2, heads]``, the
    scale from the upsampler's steps."""
    layers, _, embed = params["stl.qkv_w"].shape
    table, heads = params["stl.bias_table"].shape[1:]
    n_groups = params["group.conv_w"].shape[0]
    num_feat = params["conv_before_up_w"].shape[0]
    n_up, up_out = params["up.conv_w"].shape[:2]
    return SwinIRSpec(embed=embed, n_groups=n_groups, depth=layers // n_groups,
                      heads=heads, window=(math.isqrt(table) + 1) // 2,
                      mlp=params["stl.fc1_w"].shape[1], num_feat=num_feat,
                      scale=math.isqrt(up_out // num_feat) ** n_up)


def init_params(spec: SwinIRSpec = SwinIRSpec(), generator: torch.Generator | None = None,
                device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """Seeded parameters after SwinIR's ``_init_weights``: Linear weights
    and the bias tables truncated normal, std 0.02; convs PyTorch's default
    (uniform within ``1 / sqrt(fan_in)``, biases too).  Three departures,
    so that a dropped or swapped term shows in a comparison: Linear biases
    N(0, 0.02^2) where SwinIR sets 0, LayerNorm gains 1 + N(0, 0.1^2) and
    shifts N(0, 0.1^2) where SwinIR sets 1 and 0; ``conv_last``'s bias is
    0.5, mid-grey.  Drawn on the CPU from ``generator``, then moved."""
    e, m, f, ln, g = spec.embed, spec.mlp, spec.num_feat, spec.layers, spec.n_groups
    r, n_up = upsample_steps(spec.scale)

    def trunc(*shape):
        return torch.nn.init.trunc_normal_(torch.empty(shape), std=0.02,
                                           generator=generator)

    def normal(std, *shape):
        return torch.randn(shape, generator=generator) * std

    def conv_w(*shape):
        bound = 1.0 / math.sqrt(shape[-3] * shape[-2] * shape[-1])
        return (torch.rand(shape, generator=generator) * 2 - 1) * bound

    def conv_b(fan_in, *shape):
        return (torch.rand(shape, generator=generator) * 2 - 1) / math.sqrt(fan_in)

    params = {
        "conv_first_w": conv_w(e, 1, 3, 3), "conv_first_b": conv_b(9, e),
        "patch_norm_w": 1 + normal(0.1, e), "patch_norm_b": normal(0.1, e),
        "stl.norm1_w": 1 + normal(0.1, ln, e), "stl.norm1_b": normal(0.1, ln, e),
        "stl.qkv_w": trunc(ln, 3 * e, e), "stl.qkv_b": normal(0.02, ln, 3 * e),
        "stl.bias_table": trunc(ln, (2 * spec.window - 1) ** 2, spec.heads),
        "stl.proj_w": trunc(ln, e, e), "stl.proj_b": normal(0.02, ln, e),
        "stl.norm2_w": 1 + normal(0.1, ln, e), "stl.norm2_b": normal(0.1, ln, e),
        "stl.fc1_w": trunc(ln, m, e), "stl.fc1_b": normal(0.02, ln, m),
        "stl.fc2_w": trunc(ln, e, m), "stl.fc2_b": normal(0.02, ln, e),
        "group.conv_w": conv_w(g, e, e, 3, 3), "group.conv_b": conv_b(9 * e, g, e),
        "norm_w": 1 + normal(0.1, e), "norm_b": normal(0.1, e),
        "conv_after_body_w": conv_w(e, e, 3, 3), "conv_after_body_b": conv_b(9 * e, e),
        "conv_before_up_w": conv_w(f, e, 3, 3), "conv_before_up_b": conv_b(9 * e, f),
        "up.conv_w": conv_w(n_up, r * r * f, f, 3, 3),
        "up.conv_b": conv_b(9 * f, n_up, r * r * f),
        "conv_last_w": conv_w(1, f, 3, 3), "conv_last_b": torch.full((1,), 0.5),
    }
    return {k: v.to(device) for k, v in params.items()}


def load_params(scale: int = 2, path: str | None = None,
                device: str | torch.device = "cpu"):
    """No trained Y-plane SwinIR ships (the published checkpoints are RGB):
    raises ``ValueError`` asking for ``params``."""
    raise ValueError(
        "no trained SwinIR weights ship with libsrcnn_tpu_torch: pass "
        "params=<a dict of models.swinir's layout> (e.g. "
        "models.swinir.init_params(spec, generator)) to upscale")


@functools.lru_cache(maxsize=8)
def _geometry(hp: int, wp: int, window: int, shift: int, device: torch.device):
    """The relative-position index ``[window^2 * window^2]`` into the bias
    table and SwinIR's shift mask ``[windows, window^2, window^2]`` for a
    padded ``hp`` x ``wp`` plane, built once per size and device."""
    counts["swinir.masks_built"] += 1
    ws = window
    yy, xx = torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij")
    coords = torch.stack([yy.flatten(), xx.flatten()])          # [2, N]
    rel = coords[:, :, None] - coords[:, None, :] + (ws - 1)    # [2, N, N]
    index = (rel[0] * (2 * ws - 1) + rel[1]).flatten()

    region = torch.zeros(hp, wp)
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for a, hs in enumerate(cuts):
        for b, wsl in enumerate(cuts):
            region[hs, wsl] = 3 * a + b
    win = _partition(region[None, :, :, None], ws)[..., 0]       # [windows, N]
    mask = (win[:, None, :] != win[:, :, None]).float() * MASK_VALUE
    return index.to(device), mask.to(device)


def _partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[n, H, W, C] -> [n * windows, ws * ws, C], windows row-major."""
    n, h, w, c = x.shape
    x = x.view(n, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def _reverse(x: torch.Tensor, n: int, h: int, w: int, ws: int) -> torch.Tensor:
    """:func:`_partition`'s inverse: [n * windows, ws * ws, C] -> [n, H, W, C]."""
    c = x.shape[-1]
    x = x.view(n, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h, w, c)


def _conv3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3 conv with zero padding, NCHW."""
    return conv(F.pad(x, (1, 1, 1, 1)), w, "exact", b)


def _image(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _layer_norm(t: torch.Tensor, params: dict, name: str, i: int | None = None):
    w, b = params[name + "_w"], params[name + "_b"]
    if i is not None:
        w, b = w[i], b[i]
    return F.layer_norm(t, (t.shape[-1],), w, b, LN_EPS)


def _attention(params: dict, i: int, t: torch.Tensor, bias: torch.Tensor,
               mask: torch.Tensor, spec: SwinIRSpec) -> torch.Tensor:
    """``t + `` layer ``i``'s shifted-window attention, on tokens
    ``[n, H, W, E]``; ``bias`` is the layer's gathered ``[heads, N, N]``."""
    n, hp, wp, e = t.shape
    ws, heads = spec.window, spec.heads
    hd, tok = e // heads, ws * ws
    s = spec.shift if i % 2 else 0
    x = _layer_norm(t, params, "stl.norm1", i)
    if s:
        x = torch.roll(x, (-s, -s), (1, 2))
    x = F.linear(_partition(x, ws), params["stl.qkv_w"][i], params["stl.qkv_b"][i])
    q, k, v = x.view(-1, tok, 3, heads, hd).permute(2, 0, 3, 1, 4)
    a = (q * hd ** -0.5) @ k.transpose(-2, -1) + bias
    if s:
        a = (a.view(n, -1, heads, tok, tok) + mask[:, None]).view(-1, heads, tok, tok)
    o = (a.softmax(-1) @ v).transpose(1, 2).reshape(-1, tok, e)
    o = _reverse(F.linear(o, params["stl.proj_w"][i], params["stl.proj_b"][i]),
                 n, hp, wp, ws)
    if s:
        o = torch.roll(o, (s, s), (1, 2))
    counts["swinir.windows"] += n * (hp // ws) * (wp // ws)
    return t + o


def _mlp(params: dict, i: int, t: torch.Tensor) -> torch.Tensor:
    """``t + `` layer ``i``'s MLP."""
    x = F.linear(_layer_norm(t, params, "stl.norm2", i), params["stl.fc1_w"][i],
                 params["stl.fc1_b"][i])
    return t + F.linear(F.gelu(x), params["stl.fc2_w"][i], params["stl.fc2_b"][i])


def forward_lr(params: dict, lr_y: torch.Tensor, spec: SwinIRSpec | None = None,
               precision: str = "exact") -> torch.Tensor:
    """LR Y plane(s) [H, W] or [N, H, W] in [0, 255] -> [.., scale H, scale W]
    in [0, 255].  ``precision``: ``"exact"`` only (the ``float32`` tier)."""
    if precision != "exact":
        raise ValueError(f"swinir runs exact f32 only (the float32 tier), got "
                         f"precision={precision!r}")
    spec = spec or spec_of(params)
    squeeze = lr_y.dim() == 2
    y = (lr_y[None] if squeeze else lr_y).to(torch.float32)
    n, h, w = y.shape
    ws = spec.window
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    if hp - h >= h or wp - w >= w:
        raise ValueError(f"swinir's reflect pad to a multiple of {ws} needs more "
                         f"rows and columns than it adds, got {h}x{w}")
    with exact_f32(y.device):
        with span("sr.swinir.conv"):
            x = F.pad(y[:, None] / 255.0, (0, wp - w, 0, hp - h), mode="reflect")
            f = _conv3(x, params["conv_first_w"], params["conv_first_b"])
            t = _layer_norm(_tokens(f), params, "patch_norm")
            index, mask = _geometry(hp, wp, ws, spec.shift, y.device)
            tok = ws * ws
            bias = params["stl.bias_table"][:, index].view(
                spec.layers, tok, tok, spec.heads).permute(0, 3, 1, 2).contiguous()
        for g in range(spec.n_groups):
            t0 = t
            for i in range(g * spec.depth, (g + 1) * spec.depth):
                with span("sr.swinir.attn"):
                    t = _attention(params, i, t, bias[i], mask, spec)
                with span("sr.swinir.mlp"):
                    t = _mlp(params, i, t)
            with span("sr.swinir.conv"):
                t = t0 + _tokens(_conv3(_image(t), params["group.conv_w"][g],
                                        params["group.conv_b"][g]))
        with span("sr.swinir.conv"):
            f = _conv3(_image(_layer_norm(t, params, "norm")),
                       params["conv_after_body_w"], params["conv_after_body_b"]) + f
            f = F.leaky_relu(_conv3(f, params["conv_before_up_w"],
                                    params["conv_before_up_b"]), LEAKY_SLOPE)
            r, n_up = upsample_steps(spec.scale)
            for k in range(n_up):
                f = F.pixel_shuffle(_conv3(f, params["up.conv_w"][k],
                                           params["up.conv_b"][k]), r)
            out = _conv3(f, params["conv_last_w"], params["conv_last_b"])
            out = torch.clamp(out[:, 0, :h * spec.scale, :w * spec.scale] * 255.0,
                              0.0, 255.0)
    return out[0] if squeeze else out
