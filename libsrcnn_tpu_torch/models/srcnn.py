"""SRCNN 9-1-5 model (Dong et al., ECCV 2014) -- PyTorch port of
``libsrcnn_tpu/models/srcnn.py``.

Behavioral contract (golden path, SURVEY.md section 3.1):

* conv1: 9x9, 1->64, replicate-pad 4 (`libsrcnn.cpp:362-392`), bias, ReLU.
* conv2: 1x1, 64->32, bias, ReLU (`libsrcnn.cpp:424-447`).
* conv3: 5x5, 32->1, replicate-pad 2 on conv2's output, bias, clamp to
  [0, 255] (`libsrcnn.cpp:449-529`).

This module holds the plain PyTorch version (``F.conv2d``): the CPU path,
and the reference the hand-written kernels in :mod:`..kernels.fused_conv`
are held against.  On CUDA it runs with TF32 off in cuDNN and cuBLAS:
cuDNN's default TF32 convolutions keep ~3 decimal digits, enough to break
the reference's <=1 u8 LSB gate.

The bf16 forms emulate bf16 operands: each operand is rounded to bf16
(round to nearest even) and back to f32, and the conv runs in f32.  A
product of two bf16 values is exact in f32, so only the summation order
differs from a bf16 GEMM with f32 accumulation.  ``F.conv2d`` is never run
on bf16 tensors: cuDNN and oneDNN round its output to bf16 before the bias
and the ReLU, which the JAX package never does.  Parameters stay f32;
rounding them inside the forward is idempotent on weights that are
already bf16 (the JAX package's bf16 tiers store them so,
``libsrcnn_tpu/models/srcnn.py:42-54``).

Weights come from the port's own ``models/weights/srcnn_915.npz``, a
byte-for-byte copy of the JAX package's shipped file.  Tensors here are
OIHW (PyTorch's layout); :func:`params_from_jax` converts the JAX
package's HWIO pytree and :func:`params_to_jax` converts back (a checkpoint moves both ways).
:func:`init_params` draws the paper's random init for training
(:mod:`libsrcnn_tpu_torch.train`), which runs :func:`forward_y` with
``clamp=False`` under autograd: the hand kernels have no backward.
"""

from __future__ import annotations

import contextlib
import functools
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

PARAM_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")


def weights_path(name: str) -> str:
    """Path of the shipped weights file ``name`` in the port's own
    ``models/weights/`` (copies of the JAX package's files, shipped as
    package data).  Loading a missing file raises ``FileNotFoundError``."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights", name)


@functools.lru_cache(maxsize=1)
def _load_npz() -> dict[str, np.ndarray]:
    with np.load(weights_path("srcnn_915.npz")) as z:
        return {k: z[k] for k in PARAM_KEYS}


def tensors_from_jax(np_params: dict, keys) -> dict[str, torch.Tensor]:
    """The entries ``keys`` of a JAX params pytree (numpy, or anything
    ``np.asarray`` takes) -> f32 CPU tensors: HWIO weights (4-D, or 5-D
    with a leading stack axis) in OIHW, the rest as they are."""
    out = {}
    for k in keys:
        a = np.asarray(np_params[k], dtype=np.float32)
        if a.ndim >= 4:
            a = np.moveaxis(a, (-4, -3, -2, -1), (-2, -1, -3, -4))   # HWIO -> OIHW
        out[k] = torch.tensor(np.ascontiguousarray(a))
    return out


def tensors_to_jax(params: dict, keys) -> dict[str, np.ndarray]:
    """Inverse of :func:`tensors_from_jax`: the entries ``keys`` of OIHW
    tensors -> f32 numpy arrays, 4-D (or 5-D stacked) weights in HWIO."""
    out = {}
    for k in keys:
        a = torch.as_tensor(params[k]).detach().to("cpu", torch.float32).numpy()
        if a.ndim >= 4:
            a = np.moveaxis(a, (-2, -1, -3, -4), (-4, -3, -2, -1))   # OIHW -> HWIO
        out[k] = np.ascontiguousarray(a)
    return out


def params_from_jax(np_params: dict) -> dict[str, torch.Tensor]:
    """The JAX package's params pytree (HWIO ``w1 [9,9,1,64]``,
    ``w2 [1,1,64,32]``, ``w3 [5,5,32,1]`` and the biases, as numpy or
    anything ``np.asarray`` takes) -> f32 CPU tensors in OIHW.

    The result feeds both the plain convs here and the fused kernel, which
    packs it with :func:`..kernels.fused_conv.pack_params`."""
    return tensors_from_jax(np_params, PARAM_KEYS)


def params_to_jax(params: dict) -> dict[str, np.ndarray]:
    """OIHW tensors -> the JAX package's params pytree as numpy (HWIO)."""
    return tensors_to_jax(params, PARAM_KEYS)


def load_params(device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """The pre-trained 8,129 SRCNN parameters, f32 OIHW, on ``device``."""
    return {k: v.to(device) for k, v in params_from_jax(_load_npz()).items()}


def normal(generator: torch.Generator, shape, std: float) -> torch.Tensor:
    """Gaussian f32 draws of ``std`` from ``generator`` (a CPU generator:
    the same seed gives the same values whatever device they go to)."""
    return torch.randn(shape, generator=generator, dtype=torch.float32) * std


def init_params(generator: torch.Generator,
                device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """Random init with the SRCNN paper's scheme (Gaussian, std 1e-3; zero
    biases) for training from scratch, OIHW with :func:`load_params`'s
    shapes (JAX ``srcnn.init_params``; its key's draws cannot be
    reproduced in torch, so the form matches, not the values)."""
    params = {"w1": normal(generator, (64, 1, 9, 9), 1e-3), "b1": torch.zeros(64),
              "w2": normal(generator, (32, 64, 1, 1), 1e-3), "b2": torch.zeros(32),
              "w3": normal(generator, (1, 32, 5, 5), 1e-3), "b3": torch.zeros(1)}
    return {k: v.to(device) for k, v in params.items()}


class SRCNN915(nn.Module):
    """The 9-1-5 stack's parameters (OIHW, f32) and its plain forward.

    The parameters are frozen (``requires_grad=False``): serving needs no
    gradients (``requires_grad_(True)`` unfreezes them; the trainer keeps
    its own parameters, :mod:`libsrcnn_tpu_torch.train.trainer`)."""

    def __init__(self, params: dict[str, torch.Tensor] | None = None):
        super().__init__()
        params = load_params() if params is None else params
        for k in PARAM_KEYS:
            t = torch.as_tensor(params[k], dtype=torch.float32)
            self.register_parameter(
                k, nn.Parameter(t.detach().clone(), requires_grad=False))

    def params(self) -> dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in PARAM_KEYS}

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return forward_y(self.params(), y)


def exact_f32(device: torch.device):
    """Context that keeps cuDNN and cuBLAS off TF32 on CUDA, with cuDNN's
    autotuner off and only its deterministic algorithms (no-op on CPU).

    A training step runs its forward, backward and update inside it, so
    two runs from one seed end on equal weights, as the JAX trainer's do:
    cuDNN's default weight and data gradients may sum with atomics."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled, benchmark=False, deterministic=True,
        allow_tf32=False))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    stack.callback(setattr, torch.backends.cuda.matmul, "allow_tf32", prev)
    return stack


#: GEMM precisions of the fused kernel's modes (the JAX package's
#: ``fused_conv.MODE_PRECISIONS`` names): exact f32, split-bf16x2, bf16x1
PRECISIONS = ("exact", "split", "bf16x1")

#: srcnn compute tier -> precision of the plain convs (the XLA twin of the
#: JAX package, ``libsrcnn_tpu/models/srcnn.py:88-118`` with bf16-stored
#: weights: input, h1 and h2 rounded to bf16, f32 accumulation and biases;
#: both bf16 tiers compute this there)
TIER_PRECISION = {"float32": "exact", "bfloat16": "bf16x1",
                  "bfloat16_fast": "bf16x1"}


def to_float(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``t`` in the dtype the plain forwards compute in with weights ``w``:
    f32, or float64 with float64 weights (the f64 reference that training's
    gradients are held to).  A plane of any dtype, float64 included, meets
    f32 weights in f32."""
    return t.to(torch.promote_types(w.dtype, torch.float32))


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """Round f32 to the nearest bf16 (ties to even), kept as f32."""
    return t.to(torch.bfloat16).to(torch.float32)


def conv(x: torch.Tensor, w: torch.Tensor, precision: str = "exact") -> torch.Tensor:
    """Valid conv, no bias, in one of :data:`PRECISIONS`.  ``split`` sums
    two convs of ``hi = bf16(x)`` and ``lo = bf16(x - hi)`` against
    ``bf16(w)`` (``fused_conv._dot``, `:121-152`); ``bf16x1`` is one conv
    of ``bf16(x)`` against ``bf16(w)``."""
    if precision == "exact":
        return F.conv2d(x, w)
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    wb = round_bf16(w)
    hi = round_bf16(x)
    out = F.conv2d(hi, wb)
    if precision == "split":
        out = out + F.conv2d(round_bf16(x - hi), wb)
    return out


def _bias(b: torch.Tensor) -> torch.Tensor:
    return b.reshape(1, -1, 1, 1)


def _conv1x1(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """1x1 conv [N,C,H,W] x [O,C,1,1] -> [N,O,H,W] as one channels-last
    matmul.  oneDNN's 1x1 convolution sums the channels in another order
    when the plane is small, so a band of a plane would not equal the
    plane's rows; a matmul's rows do not depend on how many there are.
    The result is contiguous NCHW, the layout conv3 is tuned for."""
    out = h.permute(0, 2, 3, 1) @ w.reshape(w.shape[0], -1).t()
    return out.permute(0, 3, 1, 2).contiguous()


def conv1(params: dict, x: torch.Tensor, precision: str = "exact") -> torch.Tensor:
    """conv1 (9x9, valid) + ReLU on [N,1,H,W] -> h1 [N,64,H-8,W-8]."""
    if precision == "exact":
        return torch.relu(F.conv2d(x, params["w1"], params["b1"]))
    return torch.relu(conv(x, params["w1"], precision) + _bias(params["b1"]))


def conv2(params: dict, h1: torch.Tensor, precision: str = "exact") -> torch.Tensor:
    """conv2 (1x1) + ReLU on h1 [N,64,H,W] -> c2 [N,32,H,W].  The exact
    form gives each position the same sums whatever the plane's height
    (the chunked path's bands rely on it)."""
    if precision == "exact":
        return torch.relu(_conv1x1(h1, params["w2"]) + _bias(params["b2"]))
    return torch.relu(conv(h1, params["w2"], precision) + _bias(params["b2"]))


def conv12(params: dict, x: torch.Tensor, precision: str = "exact") -> torch.Tensor:
    """conv1 (9x9, valid) + ReLU, conv2 (1x1) + ReLU on [N,1,H,W] -> c2
    [N,32,H-8,W-8]."""
    return conv2(params, conv1(params, x, precision), precision)


def conv3(params: dict, c2: torch.Tensor, precision: str = "exact",
          clamp: bool = True) -> torch.Tensor:
    """conv3 (5x5, valid) + clamp to [0, 255] (unless not ``clamp``):
    [N,32,H,W] -> [N,H-4,W-4]."""
    if precision == "exact":
        h3 = F.conv2d(c2, params["w3"], params["b3"])
    else:
        h3 = conv(c2, params["w3"], precision) + _bias(params["b3"])
    return torch.clamp(h3[:, 0], 0.0, 255.0) if clamp else h3[:, 0]


def _fold(g: torch.Tensor, p: int, dim: int) -> torch.Tensor:
    """The adjoint of replicate padding by ``p`` along ``dim``: each edge
    strip of ``g`` summed with the edge it copies, one ``sum`` per side."""
    n = g.shape[dim] - 2 * p
    if n == 1:
        return g.sum(dim, keepdim=True)
    return torch.cat([g.narrow(dim, 0, p + 1).sum(dim, keepdim=True),
                      g.narrow(dim, p + 1, n - 2),
                      g.narrow(dim, p + n - 1, p + 1).sum(dim, keepdim=True)], dim)


class _EdgePad(torch.autograd.Function):
    """``F.pad(x, (p, p, p, p), mode="replicate")`` with a backward that
    sums in a fixed order: the columns' edge strips first, then the rows'
    (:func:`_fold`).  ``F.pad``'s own CUDA backward adds with atomics, in
    another order from run to run."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, p: int) -> torch.Tensor:
        ctx.p = p
        return F.pad(x, (p, p, p, p), mode="replicate")

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _fold(_fold(g, ctx.p, -1), ctx.p, -2), None


def edge_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Replicate-pad H and W of an NCHW tensor by ``p`` pixels each side,
    the reference's clamp-to-edge expansion (`libsrcnn.cpp:362-392`; the
    JAX package's ``srcnn.edge_pad``, which pads NHWC).  The values are
    ``F.pad``'s; the gradient sums in a fixed order (:class:`_EdgePad`),
    so a training step on the card gives the same weights every run."""
    return _EdgePad.apply(x, p) if p else x


def forward_y(params: dict, y: torch.Tensor, tier: str = "float32", *,
              clamp: bool = True) -> torch.Tensor:
    """Run the 9-1-5 stack on [H, W] or [N, H, W] Y planes in [0, 255].

    ``tier`` is the srcnn compute tier: ``"float32"`` is exact f32; the two
    bf16 tiers run the JAX package's XLA twin (see :data:`TIER_PRECISION`),
    which is not the split math kernel K2 computes on the card.  ``clamp``:
    the reference's final clamp to [0, 255] (`libsrcnn.cpp:521-522`); the
    trainer turns it off, as the JAX package's does."""
    if tier not in TIER_PRECISION:
        raise ValueError(f"tier must be one of {tuple(TIER_PRECISION)}, got {tier!r}")
    precision = TIER_PRECISION[tier]
    squeeze = y.dim() == 2
    x = to_float((y[None] if squeeze else y)[:, None], params["w1"])
    with exact_f32(x.device):
        c2 = conv12(params, edge_pad(x, 4), precision)
        out = conv3(params, edge_pad(c2, 2), precision, clamp)
    return out[0] if squeeze else out
