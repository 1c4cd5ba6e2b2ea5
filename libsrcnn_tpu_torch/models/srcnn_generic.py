"""The generalized SRCNN family f1-n1-f2-n2-f3 (PyTorch port of
``libsrcnn_tpu/models/srcnn_generic.py``), served as the ``"srcnn955"``
model: Dong et al.'s 9-5-5 variant, with its shipped checkpoint.

Semantics generalize the reference's: edge-replicate padding on every
layer's INPUT, ReLU after layers 1 and 2, clamp to [0, 255] at the end.
That is not the 9-1-5 reference's border rule, which replicate-pads
conv2's OUTPUT (`libsrcnn.cpp:463-489`, :mod:`.srcnn`); for f2 == 1 the
two differ only in a 2 px border ring.

Like the reference's 9-1-5 and vdsr, the model refines the classically
interpolated HR plane, so one checkpoint serves every factor;
:func:`halo_width` / :func:`forward_hr_halo` give the chunked path its
halo plan.  No hand kernel runs this family: its convs are
:func:`..ops.conv.conv_same` at the tier's precision, as the JAX package
runs XLA convolutions.  Tensors are NCHW / OIHW.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn

from ..ops.conv import conv_same
from . import srcnn
from .ring import HaloForward, edge_counts, replicate_ring
from .srcnn import normal, tensors_from_jax, tensors_to_jax, to_float, weights_path

PARAM_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    f1: int = 9   # layer-1 kernel size (patch extraction)
    n1: int = 64  # layer-1 filters
    f2: int = 1   # layer-2 kernel size (non-linear mapping)
    n2: int = 32  # layer-2 filters
    f3: int = 5   # layer-3 kernel size (reconstruction)

    @property
    def name(self) -> str:
        return f"srcnn-{self.f1}{self.f2}{self.f3}-{self.n1}x{self.n2}"

    def param_count(self) -> int:
        return (self.f1**2 * self.n1 + self.n1
                + self.f2**2 * self.n1 * self.n2 + self.n2
                + self.f3**2 * self.n2 + 1)


SRCNN_915 = ModelSpec()
SRCNN_955 = ModelSpec(f2=5)
SRCNN_935 = ModelSpec(f2=3)


def default_spec() -> ModelSpec:
    return SRCNN_955


def spec_of(params: dict) -> ModelSpec:
    """The ModelSpec of OIHW parameters, from their shapes."""
    w1, w2, w3 = params["w1"], params["w2"], params["w3"]
    return ModelSpec(f1=w1.shape[-1], n1=w1.shape[0], f2=w2.shape[-1],
                     n2=w2.shape[0], f3=w3.shape[-1])


def halo_width(spec: ModelSpec) -> int:
    """Pixels of context per side: each SAME conv consumes k // 2."""
    return spec.f1 // 2 + spec.f2 // 2 + spec.f3 // 2


def params_from_jax(np_params: dict) -> dict[str, torch.Tensor]:
    """The JAX package's params pytree (HWIO) -> f32 CPU tensors, OIHW."""
    return tensors_from_jax(np_params, PARAM_KEYS)


def params_to_jax(params: dict) -> dict[str, np.ndarray]:
    """OIHW tensors -> the JAX package's params pytree as numpy (HWIO)."""
    return tensors_to_jax(params, PARAM_KEYS)


def init_params(generator: torch.Generator, spec: ModelSpec = SRCNN_915,
                device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """Gaussian init (std 1e-3), zero biases -- the paper's scheme; OIHW
    (JAX ``srcnn_generic.init_params``: the form, not its key's draws)."""
    params = {
        "w1": normal(generator, (spec.n1, 1, spec.f1, spec.f1), 1e-3),
        "b1": torch.zeros(spec.n1),
        "w2": normal(generator, (spec.n2, spec.n1, spec.f2, spec.f2), 1e-3),
        "b2": torch.zeros(spec.n2),
        "w3": normal(generator, (1, spec.n2, spec.f3, spec.f3), 1e-3),
        "b3": torch.zeros(1),
    }
    return {k: v.to(device) for k, v in params.items()}


def from_pretrained(spec: ModelSpec = SRCNN_915,
                    device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """The reference's pre-trained 9-1-5 weights; no other spec has any."""
    if spec != SRCNN_915:
        raise ValueError(f"pre-trained weights exist only for 9-1-5, not {spec.name}")
    return srcnn.load_params(device)


@functools.lru_cache(maxsize=2)
def _load_npz(path: str):
    with np.load(path) as z:
        spec = ModelSpec(f1=int(z["meta_f1"]), n1=int(z["meta_n1"]),
                         f2=int(z["meta_f2"]), n2=int(z["meta_n2"]),
                         f3=int(z["meta_f3"]))
        return {k: z[k] for k in PARAM_KEYS}, spec


def load_params(scale: int | None = None, path: str | None = None,
                device: str | torch.device = "cpu"):
    """The shipped 9-5-5 checkpoint (or the one at ``path``) -> (params on
    ``device``, spec), the spec from the file's ``meta_*`` entries.
    ``scale`` is taken for the zoo's protocol and ignored: the HR head
    serves every factor."""
    np_params, spec = _load_npz(path or weights_path("srcnn955.npz"))
    return ({k: v.to(device) for k, v in params_from_jax(np_params).items()},
            spec)


def _stack(params: dict, x: torch.Tensor, precision: str, refresh) -> torch.Tensor:
    """The three layers on [N,1,H,W]; ``refresh`` runs before each conv."""
    h = torch.relu(conv_same(refresh(x), params["w1"], precision, params["b1"]))
    h = torch.relu(conv_same(refresh(h), params["w2"], precision, params["b2"]))
    return conv_same(refresh(h), params["w3"], precision, params["b3"])[:, 0]


def forward_hr(params: dict, y_hr: torch.Tensor, spec: ModelSpec | None = None,
               *, clamp: bool = True, precision: str = "exact") -> torch.Tensor:
    """Interpolated HR Y plane(s) [H, W] or [N, H, W] -> reconstructed, same
    shape.  ``precision``: ``"exact"`` or ``"bf16"`` (:mod:`..ops.conv`).
    ``spec`` is implied by the parameters' shapes."""
    squeeze = y_hr.dim() == 2
    x = to_float((y_hr[None] if squeeze else y_hr)[:, None], params["w1"])
    out = _stack(params, x, precision, lambda t: t)
    if clamp:
        out = torch.clamp(out, 0.0, 255.0)
    return out[0] if squeeze else out


def forward_y(params: dict, y: torch.Tensor, spec: ModelSpec | None = None,
              *, clamp: bool = True) -> torch.Tensor:
    """The generic 3-layer forward in exact f32; equal to
    :func:`forward_hr` (`srcnn_generic.py:169-176` of the JAX package)."""
    return forward_hr(params, y, spec, clamp=clamp)


def forward_hr_halo(params: dict, ext: torch.Tensor, flags,
                    spec: ModelSpec | None = None, *, halo: int | None = None,
                    clamp: bool = True, precision: str = "exact") -> torch.Tensor:
    """Forward on an [E_h, E_w] plane, or [N, E_h, E_w] planes, carrying
    ``halo`` px of context per side -> the interior result, bit-identical
    to the same rows and columns of :func:`forward_hr` on the whole plane.
    ``flags`` (top, bottom, left, right) mark the true image edges, where
    :func:`.ring.replicate_ring` re-imposes each layer's replicate
    padding; the other borders keep their real neighbour pixels."""
    spec = spec or spec_of(params)
    need = halo_width(spec)
    halo = need if halo is None else halo
    if halo < need:
        raise ValueError(f"halo {halo} < required {need}")
    return _forward_ring(params, ext, edge_counts(flags, halo), halo, clamp, precision)


def _forward_ring(params: dict, ext: torch.Tensor, edges, halo: int, clamp: bool,
                  precision: str) -> torch.Tensor:
    """:func:`forward_hr_halo` with ``edges`` counting each side's
    out-of-image rows / columns (:func:`.vdsr._forward_ring`)."""
    squeeze = ext.dim() == 2
    x = to_float((ext[None] if squeeze else ext)[:, None], params["w1"])
    h = _stack(params, x, precision, lambda t: replicate_ring(t, edges))
    if clamp:
        h = torch.clamp(h, 0.0, 255.0)
    h = h[:, halo:x.shape[-2] - halo, halo:x.shape[-1] - halo]
    return h[0] if squeeze else h


def make_loss_forward(spec: ModelSpec, lane_pack: int = 1) -> HaloForward:
    """Adapter for :func:`..train.trainer.loss_fn`: HR-domain pairs
    (interp_y, hr_y) at the same size, like vdsr's.  ``lane_pack`` is taken
    for the JAX signature and ignored, as ``SRCNNConfig.lane_pack`` is:
    Hopper has no MXU lanes to pack.  It carries :func:`forward_hr_halo`'s
    ring form as its halo form."""
    halo = halo_width(spec)

    def forward(params, interp_y, clamp=False):
        return forward_hr(params, interp_y, spec, clamp=clamp)

    def forward_halo(params, ext, edges, clamp=False):
        return _forward_ring(params, ext, edges, halo, clamp, "exact")

    return HaloForward(forward, lambda params: halo, forward_halo)


class SRCNNGeneric(nn.Module):
    """A generic SRCNN's parameters (OIHW, f32, frozen: serving needs no
    gradients; :mod:`..train` trains through :func:`make_loss_forward`) and
    its forward.  The default is the shipped 9-5-5 checkpoint."""

    def __init__(self, params: dict[str, torch.Tensor] | None = None):
        super().__init__()
        params = load_params()[0] if params is None else params
        for k in PARAM_KEYS:
            t = torch.as_tensor(params[k], dtype=torch.float32)
            self.register_parameter(
                k, nn.Parameter(t.detach().clone(), requires_grad=False))
        self.spec = spec_of(params)

    def params(self) -> dict:
        """The parameters with their spec under ``"__spec__"``, as
        :func:`..pipeline.load_model_params` gives them."""
        return {**{k: getattr(self, k) for k in PARAM_KEYS}, "__spec__": self.spec}

    def forward(self, y_hr: torch.Tensor, precision: str = "exact") -> torch.Tensor:
        return forward_hr(self.params(), y_hr, precision=precision)
