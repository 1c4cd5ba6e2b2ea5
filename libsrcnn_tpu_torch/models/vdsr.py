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
OIHW.  Shipped weights: the port's own ``models/weights/vdsr.npz`` (depth
16, 32 channels), a copy of the JAX package's.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops.conv import conv_same
from .ring import HaloForward, edge_counts, replicate_ring
from .srcnn import normal, tensors_from_jax, tensors_to_jax, to_float, weights_path

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


def params_to_jax(params: dict) -> dict[str, np.ndarray]:
    """OIHW tensors -> the JAX package's params pytree as numpy (HWIO,
    ``mid_w [L,3,3,c,c]``)."""
    return tensors_to_jax(params, PARAM_KEYS)


def init_params(generator: torch.Generator, spec: VDSRSpec = VDSRSpec(),
                device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """He init (std sqrt(2 / fan_in)), zero biases, the residual head
    scaled by 0.1 so that the net starts near the identity; OIHW (JAX
    ``vdsr.init_params``: the form, not its key's draws)."""
    if spec.depth < 3:
        raise ValueError(f"VDSR depth must be >= 3, got {spec.depth}")
    c, n_mid = spec.ch, spec.depth - 2

    def he(shape, fan_in):
        return normal(generator, shape, float(np.sqrt(2.0 / fan_in)))

    params = {
        "in_w": he((c, 1, 3, 3), 9),
        "in_b": torch.zeros(c),
        "mid_w": he((n_mid, c, c, 3, 3), 9 * c),
        "mid_b": torch.zeros(n_mid, c),
        "out_w": he((1, c, 3, 3), 9 * c) * 0.1,
        "out_b": torch.zeros(1),
    }
    return {k: v.to(device) for k, v in params.items()}


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
    y = to_float(y_hr[None] if squeeze else y_hr, params["in_w"])
    out = y + _residual(params, y[:, None], precision, lambda t: t)
    if clamp:
        out = torch.clamp(out, 0.0, 255.0)
    return out[0] if squeeze else out


def forward_hr_halo(params: dict, ext: torch.Tensor, flags,
                    spec: VDSRSpec | None = None, *, halo: int | None = None,
                    clamp: bool = True, precision: str = "exact") -> torch.Tensor:
    """VDSR on an extended [E_h, E_w] plane, or [N, E_h, E_w] planes,
    carrying ``halo`` px of context per side -> the interior [.., E_h-2h,
    E_w-2h] result, bit-identical to the same rows and columns of
    :func:`forward_hr` on the whole plane.  ``flags`` (top, bottom, left,
    right) mark the true image edges, where :func:`.ring.replicate_ring`
    re-imposes each layer's replicate padding on the ring (the JAX
    package's ``vdsr._edge_refresh``)."""
    spec = spec or spec_of(params)
    halo = halo_width(spec) if halo is None else halo
    if halo < spec.depth:
        raise ValueError(f"halo {halo} < depth {spec.depth} convs")
    return _forward_ring(params, ext, edge_counts(flags, halo), halo, clamp, precision)


def _forward_ring(params: dict, ext: torch.Tensor, edges, halo: int, clamp: bool,
                  precision: str) -> torch.Tensor:
    """:func:`forward_hr_halo` with ``edges`` counting each side's
    out-of-image rows / columns (fewer than ``halo`` on a training share
    whose context reaches partly past the image edge)."""
    squeeze = ext.dim() == 2
    y = to_float(ext[None] if squeeze else ext, params["in_w"])
    out = y + _residual(params, y[:, None], precision,
                        lambda t: replicate_ring(t, edges))
    if clamp:
        out = torch.clamp(out, 0.0, 255.0)
    out = out[:, halo:y.shape[1] - halo, halo:y.shape[2] - halo]
    return out[0] if squeeze else out


def make_loss_forward(spec: VDSRSpec, lane_pack: int = 1) -> HaloForward:
    """Adapter for :func:`..train.trainer.loss_fn`: VDSR refines the
    already interpolated plane, so its training pairs (interp_y, hr_y) are
    the same size.  ``lane_pack`` is taken for the JAX signature and
    ignored: Hopper has no MXU lanes to pack (:mod:`..ops.conv`).  It
    carries :func:`forward_hr_halo`'s ring form as its halo form."""
    halo = halo_width(spec)

    def forward(params, interp_y, clamp=False):
        return forward_hr(params, interp_y, spec, clamp=clamp)

    def forward_halo(params, ext, edges, clamp=False):
        return _forward_ring(params, ext, edges, halo, clamp, "exact")

    return HaloForward(forward, lambda params: halo, forward_halo)
