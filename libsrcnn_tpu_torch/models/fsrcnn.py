"""FSRCNN (Dong et al., ECCV 2016), an LR-domain family (PyTorch port of
``libsrcnn_tpu/models/fsrcnn.py``).

It runs its feature stack at LOW resolution and upscales at the end with a
learned transposed convolution: feature extraction 5x5 (d) -> shrink 1x1
(s) -> m mapping 3x3 (s) -> expand 1x1 (d) -> deconv k x k, stride =
scale, d -> 1.  PReLU activations (per-channel alpha), edge-replicate SAME
padding on the convs, the [0, 255] domain.  One checkpoint per integer
factor (x2, x3, x4), read by path from
``libsrcnn_tpu/models/weights/fsrcnn_x{scale}.npz``.

The deconv runs as the JAX package runs it: its dense sub-pixel form
(:func:`_subpixel_plan`), one stride-1 L x L conv emitting the scale^2
sub-pixel phases, zero-padded asymmetrically ``(P, L-1-P)`` on each axis,
then the pixel shuffle.  A head whose kernel is smaller than its stride
(none ships) runs the transposed conv itself
(:func:`..ops.conv.conv_transpose_same`).

No hand kernel runs this family: its convs are :mod:`..ops.conv`'s at the
tier's precision.  Tensors are NCHW / OIHW.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv import conv, conv_same, conv_transpose_same
from .espcn import pixel_shuffle
from .srcnn import tensors_from_jax, weights_path


@dataclasses.dataclass(frozen=True)
class FSRCNNSpec:
    scale: int = 2
    d: int = 56   # feature dim
    s: int = 12   # shrink dim
    m: int = 4    # mapping depth

    @property
    def name(self) -> str:
        return f"fsrcnn-x{self.scale}-d{self.d}s{self.s}m{self.m}"


def default_spec() -> FSRCNNSpec:
    return FSRCNNSpec()


def param_keys(m: int) -> tuple[str, ...]:
    layers = ("feat", "shrink", *(f"map{i}" for i in range(m)), "expand")
    return (*(f"{n}_{p}" for n in layers for p in "wba"), "deconv_w", "deconv_b")


def spec_of(params: dict, scale: int = 2) -> FSRCNNSpec:
    """The FSRCNNSpec of OIHW parameters: d, s and m from their shapes and
    keys; the scale is not in them (``scale``)."""
    m = sum(1 for k in params if k.startswith("map") and k.endswith("_w"))
    return FSRCNNSpec(scale=scale, d=params["feat_w"].shape[0],
                      s=params["shrink_w"].shape[0], m=m)


def params_from_jax(np_params: dict) -> dict[str, torch.Tensor]:
    """The JAX package's params pytree (HWIO, ``deconv_w [k,k,d,1]``) ->
    f32 CPU tensors, OIHW (``deconv_w [1,d,k,k]``)."""
    m = sum(1 for k in np_params if k.startswith("map") and k.endswith("_w"))
    return tensors_from_jax(np_params, param_keys(m))


@functools.lru_cache(maxsize=4)
def _load_npz(path: str):
    with np.load(path) as z:
        spec = FSRCNNSpec(scale=int(z["meta_scale"]), d=int(z["meta_d"]),
                          s=int(z["meta_s"]), m=int(z["meta_m"]))
        return {k: z[k] for k in param_keys(spec.m)}, spec


def load_params(scale: int = 2, path: str | None = None,
                device: str | torch.device = "cpu"):
    """The shipped x``scale`` checkpoint (or the one at ``path``) ->
    (params on ``device``, spec from the file's ``meta_*`` entries)."""
    if path is None:
        path = weights_path(f"fsrcnn_x{scale}.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no shipped FSRCNN weights for x{scale} ({path})")
    np_params, spec = _load_npz(path)
    return ({k: v.to(device) for k, v in params_from_jax(np_params).items()},
            spec)


def _prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, x * alpha.reshape(1, -1, 1, 1))


@functools.lru_cache(maxsize=8)
def _subpixel_plan(k: int, r: int):
    """Static scatter plan turning a stride-``r`` transposed-conv kernel
    [k,k] into a stride-1 kernel [L,L] with r*r output channels, whose
    conv + depth-to-space computes the SAME ``lax.conv_transpose``
    (`fsrcnn.py:114-141` of the JAX package, copied: it is pure Python).

    conv_transpose SAME is an lhs-dilated conv with top / left pad
    ``pa = k-1-(k-r)//2``; output residue d (mod r) only sees kernel taps
    ``i = i0 + r*t`` with ``i0 = (pa-d) % r``, each reading input offset
    ``(d+i0-pa)//r + t``: a plain stride-1 conv per residue class.
    Returns (L, P, [(channel, sy, sx, wy, wx)]) tap placements."""
    pa = k - 1 - (k - r) // 2
    subs = []
    for d in range(r):
        i0 = (pa - d) % r
        subs.append((i0, (d + i0 - pa) // r, (k - i0 + r - 1) // r))
    P = max(-o for _, o, _ in subs)
    L = max(P + o + t for _, o, t in subs)
    taps = []
    for dy, (iy, oy, ty) in enumerate(subs):
        for dx, (ix, ox, tx) in enumerate(subs):
            for t_y in range(ty):
                for t_x in range(tx):
                    taps.append((dy * r + dx, P + oy + t_y, P + ox + t_x,
                                 iy + r * t_y, ix + r * t_x))
    return L, P, tuple(taps)


def _deconv_subpixel(h: torch.Tensor, w: torch.Tensor, r: int,
                     precision: str) -> torch.Tensor:
    """[N,C,H,W] x OIHW [1,C,k,k] -> [N,H*r,W*r], equal to the JAX
    package's ``lax.conv_transpose(h, w, (r, r), "SAME")``: for k >= r the
    dense stride-1 conv of :func:`_subpixel_plan` on the ZERO-padded plane
    (``(P, L-1-P)`` on each axis), then the pixel shuffle; for k < r the
    transposed conv itself."""
    k, cin = w.shape[-1], w.shape[1]
    if k < r:
        return conv_transpose_same(h, w, r, precision)[:, 0]
    L, P, taps = _subpixel_plan(k, r)
    c, sy, sx, wy, wx = (torch.tensor(a, device=w.device) for a in zip(*taps))
    w2 = w.new_zeros(r * r, cin, L, L)
    w2[c, :, sy, sx] = w[0][:, wy, wx].t()
    up = conv(F.pad(h, (P, L - 1 - P, P, L - 1 - P), mode="constant"), w2, precision)
    return pixel_shuffle(up, r)


def lr_halo_width(spec: FSRCNNSpec = FSRCNNSpec(), params: dict | None = None) -> int:
    """LR-domain receptive radius of the whole stack: how many REAL
    neighbour LR rows a band needs on each side so that its cropped output
    rows equal the full frame's.  feat 5x5 -> 2, the m mapping convs -> m,
    and the sub-pixel deconv's L x L conv -> max(P, L-1-P); the 1x1 layers
    add nothing.  The deconv's kernel size comes from ``params`` when
    given (9 otherwise)."""
    k = 9 if params is None else params["deconv_w"].shape[-1]
    L, P, _ = _subpixel_plan(k, spec.scale)
    return 2 + spec.m + max(P, L - 1 - P)


def forward_lr(params: dict, lr_y: torch.Tensor, spec: FSRCNNSpec | None = None,
               *, clamp: bool = True, precision: str = "exact") -> torch.Tensor:
    """LR Y plane(s) [H, W] or [N, H, W] -> HR [.., scale*H, scale*W].
    ``precision``: ``"exact"`` or ``"bf16"`` (:mod:`..ops.conv`)."""
    spec = spec or spec_of(params)
    squeeze = lr_y.dim() == 2
    h = (lr_y[None] if squeeze else lr_y)[:, None].to(torch.float32)
    for name in ("feat", "shrink", *(f"map{i}" for i in range(spec.m)), "expand"):
        h = _prelu(conv_same(h, params[f"{name}_w"], precision, params[f"{name}_b"]),
                   params[f"{name}_a"])
    out = _deconv_subpixel(h, params["deconv_w"], spec.scale, precision) + params["deconv_b"]
    if clamp:
        out = torch.clamp(out, 0.0, 255.0)
    return out[0] if squeeze else out
