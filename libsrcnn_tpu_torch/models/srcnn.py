"""SRCNN 9-1-5 model (Dong et al., ECCV 2014) -- PyTorch port of
``libsrcnn_tpu/models/srcnn.py``.

Behavioral contract (golden path, SURVEY.md section 3.1):

* conv1: 9x9, 1->64, replicate-pad 4 (`libsrcnn.cpp:362-392`), bias, ReLU.
* conv2: 1x1, 64->32, bias, ReLU (`libsrcnn.cpp:424-447`).
* conv3: 5x5, 32->1, replicate-pad 2 on conv2's output, bias, clamp to
  [0, 255] (`libsrcnn.cpp:449-529`).

This module holds the plain PyTorch version (``F.conv2d``): the CPU path,
and the reference the hand-written kernel in :mod:`..kernels.fused_conv` is
held against.  On CUDA it runs with TF32 off in cuDNN and cuBLAS: cuDNN's
default TF32 convolutions keep ~3 decimal digits, enough to break the
reference's <=1 u8 LSB gate.

Weights come from ``libsrcnn_tpu/models/weights/srcnn_915.npz``, read by
path so that jax is never imported.  Tensors here are OIHW (PyTorch's
layout); :func:`params_from_jax` converts the JAX package's HWIO pytree.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

PARAM_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")


@functools.lru_cache(maxsize=1)
def _load_npz() -> dict[str, np.ndarray]:
    # find_spec locates the JAX package without running its __init__
    # (which imports jax)
    spec = importlib.util.find_spec("libsrcnn_tpu")
    if spec is None or not spec.submodule_search_locations:
        raise FileNotFoundError(
            "the shipped SRCNN weights live in the libsrcnn_tpu package "
            "(models/weights/srcnn_915.npz), which is not on the path")
    path = os.path.join(spec.submodule_search_locations[0], "models",
                        "weights", "srcnn_915.npz")
    with np.load(path) as z:
        return {k: z[k] for k in PARAM_KEYS}


def params_from_jax(np_params: dict) -> dict[str, torch.Tensor]:
    """The JAX package's params pytree (HWIO ``w1 [9,9,1,64]``,
    ``w2 [1,1,64,32]``, ``w3 [5,5,32,1]`` and the biases, as numpy or
    anything ``np.asarray`` takes) -> f32 CPU tensors in OIHW.

    The result feeds both the plain convs here and the fused kernel, which
    packs it with :func:`..kernels.fused_conv.pack_params`."""
    out = {}
    for k in PARAM_KEYS:
        a = np.asarray(np_params[k], dtype=np.float32)
        if k.startswith("w"):
            a = a.transpose(3, 2, 0, 1)              # HWIO -> OIHW
        out[k] = torch.tensor(a)
    return out


def load_params(device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """The pre-trained 8,129 SRCNN parameters, f32 OIHW, on ``device``."""
    return {k: v.to(device) for k, v in params_from_jax(_load_npz()).items()}


class SRCNN915(nn.Module):
    """The 9-1-5 stack's parameters (OIHW, f32) and its plain forward.

    The parameters are frozen (``requires_grad=False``): the port serves
    inference; training is ROADMAP item M12."""

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
    """Context that keeps cuDNN and cuBLAS off TF32 on CUDA (no-op on CPU)."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled, allow_tf32=False))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    stack.callback(setattr, torch.backends.cuda.matmul, "allow_tf32", prev)
    return stack


def conv12(params: dict, x: torch.Tensor) -> torch.Tensor:
    """conv1 (9x9, valid) + ReLU, conv2 (1x1) + ReLU on [N,1,H,W] -> c2
    [N,32,H-8,W-8]."""
    h1 = torch.relu(F.conv2d(x, params["w1"], params["b1"]))
    return torch.relu(F.conv2d(h1, params["w2"], params["b2"]))


def conv3(params: dict, c2: torch.Tensor) -> torch.Tensor:
    """conv3 (5x5, valid) + clamp to [0, 255]: [N,32,H,W] -> [N,H-4,W-4]."""
    h3 = F.conv2d(c2, params["w3"], params["b3"])
    return torch.clamp(h3[:, 0], 0.0, 255.0)


def forward_y(params: dict, y: torch.Tensor) -> torch.Tensor:
    """Run the 9-1-5 stack on [H, W] or [N, H, W] Y planes in [0, 255]."""
    squeeze = y.dim() == 2
    x = (y[None] if squeeze else y)[:, None].to(torch.float32)
    with exact_f32(x.device):
        c2 = conv12(params, F.pad(x, (4, 4, 4, 4), mode="replicate"))
        out = conv3(params, F.pad(c2, (2, 2, 2, 2), mode="replicate"))
    return out[0] if squeeze else out
