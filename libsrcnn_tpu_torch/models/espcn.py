"""ESPCN (Shi et al., CVPR 2016), an LR-domain family (PyTorch port of
``libsrcnn_tpu/models/espcn.py``).

It runs at LOW resolution and ends with a sub-pixel convolution: 5x5 (f1)
tanh -> 3x3 (f2) tanh -> 3x3 (scale^2) linear -> pixel shuffle, all
edge-replicate SAME.  The [0, 255] input is mapped to [-1, 1] first, as a
multiply and a subtract (``x * (1/127.5) - 1``), and the linear head maps
back.  One checkpoint per integer factor (x2, x3, x4), read by path from
``libsrcnn_tpu/models/weights/espcn_x{scale}.npz``.

No hand kernel runs this family: its convs are
:func:`..ops.conv.conv_same` at the tier's precision.  Tensors are NCHW /
OIHW.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os

import numpy as np
import torch

from ..ops.conv import conv_same
from .ring import HaloForward, edge_counts, replicate_ring
from .srcnn import normal, tensors_from_jax, tensors_to_jax, to_float, weights_path

PARAM_KEYS = ("c1_w", "c1_b", "c2_w", "c2_b", "c3_w", "c3_b")


@dataclasses.dataclass(frozen=True)
class ESPCNSpec:
    scale: int = 2
    f1: int = 64   # feature channels, 5x5 layer
    f2: int = 32   # mapping channels, 3x3 layer

    @property
    def name(self) -> str:
        return f"espcn-x{self.scale}-f{self.f1}-{self.f2}"


def default_spec() -> ESPCNSpec:
    return ESPCNSpec()


def spec_of(params: dict) -> ESPCNSpec:
    """The ESPCNSpec of OIHW parameters, from their shapes (the head's
    scale^2 output channels give the scale)."""
    return ESPCNSpec(scale=math.isqrt(params["c3_w"].shape[0]),
                     f1=params["c1_w"].shape[0], f2=params["c2_w"].shape[0])


def params_from_jax(np_params: dict) -> dict[str, torch.Tensor]:
    """The JAX package's params pytree (HWIO) -> f32 CPU tensors, OIHW."""
    return tensors_from_jax(np_params, PARAM_KEYS)


def params_to_jax(params: dict) -> dict[str, np.ndarray]:
    """OIHW tensors -> the JAX package's params pytree as numpy (HWIO)."""
    return tensors_to_jax(params, PARAM_KEYS)


def init_params(generator: torch.Generator, spec: ESPCNSpec = ESPCNSpec(),
                device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """Glorot init (std sqrt(2 / (fan_in + fan_out))) for the tanh layers;
    the linear sub-pixel head scaled by 127.5 with its bias at mid-gray, so
    that a unit feature moves the output O(100) in the [0, 255] domain;
    OIHW (JAX ``espcn.init_params``: the form, not its key's draws)."""
    def glorot(cout, cin, k):
        return normal(generator, (cout, cin, k, k),
                      float(np.sqrt(2.0 / (k * k * cin + k * k * cout))))

    r2 = spec.scale * spec.scale
    params = {
        "c1_w": glorot(spec.f1, 1, 5), "c1_b": torch.zeros(spec.f1),
        "c2_w": glorot(spec.f2, spec.f1, 3), "c2_b": torch.zeros(spec.f2),
        "c3_w": glorot(r2, spec.f2, 3) * 127.5, "c3_b": torch.full((r2,), 127.5),
    }
    return {k: v.to(device) for k, v in params.items()}


@functools.lru_cache(maxsize=4)
def _load_npz(path: str):
    with np.load(path) as z:
        spec = ESPCNSpec(scale=int(z["meta_scale"]), f1=int(z["meta_f1"]),
                         f2=int(z["meta_f2"]))
        return {k: z[k] for k in PARAM_KEYS}, spec


def load_params(scale: int = 2, path: str | None = None,
                device: str | torch.device = "cpu"):
    """The shipped x``scale`` checkpoint (or the one at ``path``) ->
    (params on ``device``, spec)."""
    if path is None:
        path = weights_path(f"espcn_x{scale}.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no shipped ESPCN weights for x{scale} ({path})")
    np_params, spec = _load_npz(path)
    return ({k: v.to(device) for k, v in params_from_jax(np_params).items()},
            spec)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """[N, r*r, H, W] -> [N, H*r, W*r]; channel k = dy * r + dx is sub-pixel
    (dy, dx), the JAX package's order (`espcn.py:111-122`) and
    ``torch.pixel_shuffle``'s."""
    if x.shape[1] != r * r:
        raise ValueError(f"pixel_shuffle: {x.shape[1]} channels for scale {r}")
    return torch.pixel_shuffle(x, r)[:, 0]


def lr_halo_width(spec: ESPCNSpec = ESPCNSpec(), params: dict | None = None) -> int:
    """LR-domain receptive radius: c1 5x5 -> 2, c2 and c3 3x3 -> 1 each (the
    shuffle is local); from the checkpoint's kernel sizes when ``params``
    is given."""
    if params is None:
        return 4
    return sum(params[k].shape[-1] // 2 for k in ("c1_w", "c2_w", "c3_w"))


def forward_lr(params: dict, lr_y: torch.Tensor, spec: ESPCNSpec | None = None,
               *, clamp: bool = True, precision: str = "exact") -> torch.Tensor:
    """LR Y plane(s) [H, W] or [N, H, W] -> HR [.., scale*H, scale*W].
    ``precision``: ``"exact"`` or ``"bf16"`` (:mod:`..ops.conv`)."""
    spec = spec or spec_of(params)
    squeeze = lr_y.dim() == 2
    x = to_float((lr_y[None] if squeeze else lr_y)[:, None], params["c1_w"])
    x = x * (1.0 / 127.5) - 1.0               # [0,255] -> [-1,1]
    h = torch.tanh(conv_same(x, params["c1_w"], precision, params["c1_b"]))
    h = torch.tanh(conv_same(h, params["c2_w"], precision, params["c2_b"]))
    h = conv_same(h, params["c3_w"], precision, params["c3_b"])
    out = pixel_shuffle(h, spec.scale)
    if clamp:
        out = torch.clamp(out, 0.0, 255.0)
    return out[0] if squeeze else out


def forward_lr_halo(params: dict, ext: torch.Tensor, flags,
                    spec: ESPCNSpec | None = None, *, halo: int | None = None,
                    clamp: bool = True, precision: str = "exact") -> torch.Tensor:
    """Halo-aware forward for the tiled mesh path
    (`libsrcnn_tpu/models/espcn.py:164-191`; the scheme of
    :func:`.fsrcnn.forward_lr_halo`, whose ``ext``, ``flags`` and
    ``clamp`` it takes): replicate padding is re-imposed on the
    out-of-image ring at the true edges before every spatial conv reads it
    (the input map is pointwise, so normalising first changes nothing).
    The pixel-shuffle head is local and the ring is cropped, so c3 needs
    no fix-up."""
    spec = spec or spec_of(params)
    if halo is None:
        halo = lr_halo_width(spec, params)
    return _forward_ring(params, ext, edge_counts(flags, halo), spec, halo, clamp,
                         precision)


def _forward_ring(params: dict, ext: torch.Tensor, edges, spec: ESPCNSpec, halo: int,
                  clamp: bool, precision: str) -> torch.Tensor:
    """:func:`forward_lr_halo` with ``edges`` counting each side's
    out-of-image rows / columns (:func:`.vdsr._forward_ring`)."""
    r = spec.scale
    squeeze = ext.dim() == 2
    x = to_float((ext[None] if squeeze else ext)[:, None], params["c1_w"])
    x = x * (1.0 / 127.5) - 1.0
    x = replicate_ring(x, edges)
    h = torch.tanh(conv_same(x, params["c1_w"], precision, params["c1_b"]))
    h = replicate_ring(h, edges)
    h = torch.tanh(conv_same(h, params["c2_w"], precision, params["c2_b"]))
    h = replicate_ring(h, edges)
    h = conv_same(h, params["c3_w"], precision, params["c3_b"])
    out = pixel_shuffle(h, r)
    c = halo * r
    out = out[:, c:out.shape[1] - c, c:out.shape[2] - c]
    if clamp:
        out = torch.clamp(out, 0.0, 255.0)
    return out[0] if squeeze else out


def make_loss_forward(spec: ESPCNSpec) -> HaloForward:
    """Adapter for :func:`..train.trainer.loss_fn`: (lr, hr) pairs with hr
    ``spec.scale`` times lr, built by :func:`.fsrcnn.make_lr_patch_batch`
    (which reads only ``spec.scale``).  It carries :func:`forward_lr_halo`'s
    ring form as its halo form, in LR pixels."""
    def forward(params, lr_y, clamp=False):
        return forward_lr(params, lr_y, spec, clamp=clamp)

    def forward_halo(params, ext, edges, clamp=False):
        return _forward_ring(params, ext, edges, spec, lr_halo_width(spec, params),
                             clamp, "exact")

    return HaloForward(forward, lambda params: lr_halo_width(spec, params), forward_halo)