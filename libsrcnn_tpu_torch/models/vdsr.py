"""VDSR (Kim et al., CVPR 2016), the zoo's deep HR-domain family (PyTorch
port of ``libsrcnn_tpu/models/vdsr.py``).

Like the reference's SRCNN it refines the classically interpolated plane,
so one checkpoint serves every factor (fractional scales, step-scale
chains).  The network predicts the interpolation residual: ``depth``
edge-replicate SAME 3x3 convs (1 -> ch, then ``depth - 2`` interior ch ->
ch layers, then ch -> 1), ReLU between them, and the residual is added in
f32 to the interpolated input plane itself, never to a rounded copy.  The
JAX package drives the interior layers with ``lax.scan`` over their
stacked weights; here they are a Python loop over the same stack
(``mid_w [L, ch, ch, 3, 3]``, ``mid_b [L, ch]``).

No hand kernel runs this family: its convs are
:func:`..ops.conv.conv_same` at the tier's precision.  Tensors are NCHW /
OIHW.  Shipped weights: ``libsrcnn_tpu/models/weights/vdsr.npz`` (depth
16, 32 channels), read by path.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops.conv import conv_same
from .srcnn import tensors_from_jax, weights_path

PARAM_KEYS = ("in_w", "in_b", "mid_w", "mid_b", "out_w", "out_b")


@dataclasses.dataclass(frozen=True)
class VDSRSpec:
    depth: int = 12   # total conv layers (>= 3): in + (depth-2) interior + out
    ch: int = 32      # interior feature channels

    @property
    def name(self) -> str:
        return f"vdsr-d{self.depth}c{self.ch}"


def default_spec() -> VDSRSpec:
    return VDSRSpec()


def spec_of(params: dict) -> VDSRSpec:
    """The VDSRSpec of OIHW parameters, from their shapes."""
    return VDSRSpec(depth=params["mid_w"].shape[0] + 2, ch=params["in_w"].shape[0])


def halo_width(spec: VDSRSpec) -> int:
    """Pixels of context one output pixel needs per side: ``depth`` SAME
    3x3 convs each consume one."""
    return spec.depth


def params_from_jax(np_params: dict) -> dict[str, torch.Tensor]:
    """The JAX package's params pytree (HWIO, ``mid_w [L,3,3,c,c]``) -> f32
    CPU tensors, OIHW (``mid_w [L,c,c,3,3]``)."""
    return tensors_from_jax(np_params, PARAM_KEYS)


@functools.lru_cache(maxsize=2)
def _load_npz(path: str):
    with np.load(path) as z:
        spec = VDSRSpec(depth=int(z["meta_depth"]), ch=int(z["meta_ch"]))
        return {k: z[k] for k in PARAM_KEYS}, spec


def load_params(scale: int | None = None, path: str | None = None,
                device: str | torch.device = "cpu"):
    """The shipped checkpoint (or the one at ``path``) -> (params on
    ``device``, spec).  ``scale`` is taken for the zoo's protocol and
    ignored: the checkpoint was trained on mixed factors."""
    np_params, spec = _load_npz(path or weights_path("vdsr.npz"))
    return ({k: v.to(device) for k, v in params_from_jax(np_params).items()},
            spec)


def _residual(params: dict, x: torch.Tensor, precision: str, refresh) -> torch.Tensor:
    """The residual net on [N,1,H,W] -> [N,H,W]; ``refresh`` runs before
    each conv."""
    h = torch.relu(conv_same(refresh(x), params["in_w"], precision, params["in_b"]))
    for w, b in zip(params["mid_w"], params["mid_b"]):
        h = torch.relu(conv_same(refresh(h), w, precision, b))
    return conv_same(refresh(h), params["out_w"], precision, params["out_b"])[:, 0]


def forward_hr(params: dict, y_hr: torch.Tensor, spec: VDSRSpec | None = None,
               *, clamp: bool = True, precision: str = "exact") -> torch.Tensor:
    """Interpolated HR Y plane(s) [H, W] or [N, H, W] -> refined, same
    shape: ``y + residual``.  ``precision``: ``"exact"`` or ``"bf16"``
    (:mod:`..ops.conv`)."""
    squeeze = y_hr.dim() == 2
    y = (y_hr[None] if squeeze else y_hr).to(torch.float32)
    out = y + _residual(params, y[:, None], precision, lambda t: t)
    if clamp:
        out = torch.clamp(out, 0.0, 255.0)
    return out[0] if squeeze else out


def _edge_refresh(x: torch.Tensor, flags, halo: int) -> torch.Tensor:
    """Re-impose replicate padding on the TRUE image edges of an extended
    [N, C, E_h, E_w] activation: where a side's flag (top, bottom, left,
    right) is set, its ``halo`` border rows / columns take the first
    interior row / column (rows first, then columns).  Run before every
    conv: each layer replicate-pads its own activations, which is not the
    same as padding the input once.  Unflagged sides keep their real
    neighbour pixels."""
    if not any(flags):
        return x
    x = x.clone()
    e_h, e_w = x.shape[-2:]
    if flags[0]:
        x[..., :halo, :] = x[..., halo:halo + 1, :]
    if flags[1]:
        x[..., e_h - halo:, :] = x[..., e_h - halo - 1:e_h - halo, :]
    if flags[2]:
        x[..., :halo] = x[..., halo:halo + 1]
    if flags[3]:
        x[..., e_w - halo:] = x[..., e_w - halo - 1:e_w - halo]
    return x


def forward_hr_halo(params: dict, ext: torch.Tensor, flags,
                    spec: VDSRSpec | None = None, *, halo: int | None = None,
                    clamp: bool = True, precision: str = "exact") -> torch.Tensor:
    """VDSR on an extended [E_h, E_w] plane carrying ``halo`` px of context
    per side -> the interior [E_h-2h, E_w-2h] result, bit-identical to the
    same rows and columns of :func:`forward_hr` on the whole plane.
    ``flags`` (top, bottom, left, right) mark the true image edges, where
    :func:`_edge_refresh` re-imposes each layer's replicate padding."""
    spec = spec or spec_of(params)
    halo = halo_width(spec) if halo is None else halo
    if halo < spec.depth:
        raise ValueError(f"halo {halo} < depth {spec.depth} convs")
    y = ext[None].to(torch.float32)
    out = y + _residual(params, y[:, None], precision,
                        lambda t: _edge_refresh(t, flags, halo))
    if clamp:
        out = torch.clamp(out, 0.0, 255.0)
    return out[0, halo:ext.shape[0] - halo, halo:ext.shape[1] - halo]
