"""int8-quantized SRCNN 9-1-5 forward -- PyTorch port of
``libsrcnn_tpu/models/srcnn_int8.py``: the plain version of the int8 tier.

Scheme (``tools/calibrate_int8.py``): symmetric per-output-channel int8
weights, per-channel activation requantization with each layer's scale
folded into the next layer's weights, int32 accumulation.  Between layers
the dequant / bias / ReLU / requant chain is one folded epilogue per
element, ``clip(round(acc * s + t), 0, 127)`` (the clip's lower bound is
the ReLU); conv3's output is ``clip(acc * d3 + b3, 0, 255)``.

Exactness.  The codes and weights are integers, and every partial sum of
a conv is bounded by the sum of its terms' magnitudes: 81*127*127 =
1,306,449 for conv1, 64*127*127 for conv2, 25*32*127*127 = 12,903,200 for
conv3, all below 2**24.  So the convs here run as f32 GEMMs on
integer-valued tensors (TF32 off) and are exact in any summation order, on
the CPU and on CUDA alike; ``F.conv2d`` is not used, because cuDNN may
pick FFT or Winograd algorithms, whose transforms are not exact.  The
epilogues are unfused f32 ops: a multiply, then an add, then
``torch.round`` (ties to even, as ``jnp.round``).  This equals the JAX
package's XLA twin bit for bit, and the CUDA kernel K4
(``kernels/csrc/fused_srcnn_int8.cu``) equals it bit for bit too.

Tensors are channels-last (``[N, H, W, C]``) so that the per-channel
scales broadcast as in the JAX package.  The pack is read from
``libsrcnn_tpu/models/weights/srcnn_915_int8.npz`` by path, so that jax is
never imported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .srcnn import exact_f32, weights_path

#: the runtime pack's keys (the calibration's ``a1`` / ``a2`` are dropped)
INT8_KEYS = ("w1q", "s1", "t1", "w2q", "s2", "t2", "w3q", "d3", "b3")
#: key -> shape; ``w*q`` are int8, the rest f32.  ``w3q`` is tap-major with
#: tap k = 5*dx + dy (the TPU kernel's layout, see :func:`w3_taps`)
SHAPES = {"w1q": (81, 64), "s1": (64,), "t1": (64,), "w2q": (64, 32),
          "s2": (32,), "t2": (32,), "w3q": (25, 32), "d3": (1,), "b3": (1,)}

#: conv1 input scale: the resized Y plane lives in [0, 255]
INPUT_SCALE = 127.0 / 255.0


@functools.lru_cache(maxsize=1)
def _load_npz() -> dict[str, np.ndarray]:
    with np.load(weights_path("srcnn_915_int8.npz")) as z:
        return {k: z[k] for k in INT8_KEYS}


def params_from_jax(np_pack: dict) -> dict[str, torch.Tensor]:
    """The JAX package's int8 pack (numpy, or anything ``np.asarray``
    takes) -> CPU tensors: ``w1q``, ``w2q``, ``w3q`` int8, the scales f32,
    layouts unchanged.  Keys other than :data:`INT8_KEYS` are dropped."""
    out = {}
    for k in INT8_KEYS:
        a = np.asarray(np_pack[k])
        dtype = np.int8 if k.endswith("q") else np.float32
        if a.shape != SHAPES[k]:
            raise ValueError(f"int8 pack {k}: shape {a.shape}, expected {SHAPES[k]}")
        out[k] = torch.tensor(a.astype(dtype))
    return out


def load_params(device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """The shipped quantized pack on ``device``."""
    return {k: v.to(device) for k, v in params_from_jax(_load_npz()).items()}


def check_params(qparams: dict) -> None:
    """Raise unless ``qparams`` is an int8 pack (the keys, dtypes and
    shapes of :data:`SHAPES`)."""
    missing = [k for k in INT8_KEYS if k not in qparams]
    if missing:
        raise ValueError(f"the int8 tier takes the quantized pack "
                         f"(models/srcnn_int8.load_params); missing {missing}")
    for k in INT8_KEYS:
        v = qparams[k]
        dtype = torch.int8 if k.endswith("q") else torch.float32
        if not isinstance(v, torch.Tensor) or v.dtype != dtype or tuple(v.shape) != SHAPES[k]:
            raise ValueError(f"int8 pack {k} must be a {dtype} tensor of shape "
                             f"{SHAPES[k]}")


def w3_taps(w3q: torch.Tensor) -> torch.Tensor:
    """conv3's weights from the pack's tap order k = 5*dx + dy
    (`srcnn_int8.py:94-98` of the JAX package) to k = 5*dy + dx, the order
    of the plain convs here and of the kernel's packed layout.  The only
    place the two orders meet."""
    return w3q.reshape(5, 5, -1).transpose(0, 1).reshape(25, -1)


def quantize_input(y: torch.Tensor) -> torch.Tensor:
    """[..., H, W] f32 Y plane in [0, 255] -> int8 codes in [0, 127].  The
    multiply is in f32 by the f32 value of 127/255, as in the JAX package."""
    scale = torch.tensor(INPUT_SCALE, dtype=torch.float32)
    return torch.clamp(torch.round(y.to(torch.float32) * scale), 0, 127).to(torch.int8)


def fold_requant(acc: torch.Tensor, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """int32 (or integer-valued f32) accumulators, channels last -> the
    next layer's int8 codes: ``clip(round(acc * s + t), 0, 127)``, the
    multiply and the add rounded separately."""
    return torch.clamp(torch.round(acc.to(torch.float32) * s + t), 0, 127).to(torch.int8)


def conv1(qparams: dict, xq: torch.Tensor) -> torch.Tensor:
    """conv1 (9x9, valid) with its folded requant on int8 codes [N, H, W]
    -> h1q codes [N, H-8, W-8, 64] (int8)."""
    n, hh, ww = xq.shape
    ho, wo = hh - 8, ww - 8
    x = xq.to(torch.float32)
    with exact_f32(x.device):
        cols = torch.stack([x[:, dy:dy + ho, dx:dx + wo]
                            for dy in range(9) for dx in range(9)], dim=-1)
        acc1 = cols @ qparams["w1q"].to(torch.float32)           # [N,ho,wo,64]
    return fold_requant(acc1, qparams["s1"], qparams["t1"])


def conv12(qparams: dict, xq: torch.Tensor) -> torch.Tensor:
    """conv1 (9x9, valid) with its folded requant, then conv2 (1x1) on
    int8 codes [N, H, W] -> conv2's accumulators [N, H-8, W-8, 32]
    (integer-valued f32, exact)."""
    h1q = conv1(qparams, xq)
    with exact_f32(h1q.device):
        return h1q.to(torch.float32) @ qparams["w2q"].to(torch.float32)


def conv3(qparams: dict, c2q: torch.Tensor) -> torch.Tensor:
    """conv3 (5x5, valid) on int8 codes [N, H, W, 32] -> [N, H-4, W-4] f32
    in [0, 255]: the tap GEMM against the 25 weight vectors, a fixed-order
    shift-add of the tap planes (integer sums, exact), then one f32 scale."""
    n, hh, ww, _ = c2q.shape
    ho, wo = hh - 4, ww - 4
    with exact_f32(c2q.device):
        g = c2q.to(torch.float32) @ w3_taps(qparams["w3q"]).to(torch.float32).t()
    acc = None
    for dy in range(5):
        for dx in range(5):
            tap = g[:, dy:dy + ho, dx:dx + wo, 5 * dy + dx]
            acc = tap if acc is None else acc + tap
    return torch.clamp(acc * qparams["d3"][0] + qparams["b3"][0], 0.0, 255.0)


def edge_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Replicate-pad dims 1 and 2 of [N, H, W, ...] by ``p`` (any dtype)."""
    for dim in (1, 2):
        n = x.shape[dim]
        idx = torch.arange(-p, n + p, device=x.device).clamp(0, n - 1)
        x = x.index_select(dim, idx)
    return x


def forward_y(qparams: dict, y: torch.Tensor) -> torch.Tensor:
    """int8 9-1-5 stack on [H, W] or [N, H, W] Y planes in [0, 255]: the
    plain version of the int8 tier (port of the XLA twin
    ``libsrcnn_tpu/models/srcnn_int8.forward_y``), replicate padding at
    the borders as the reference's model does."""
    squeeze = y.dim() == 2
    x = y[None] if squeeze else y
    xq = edge_pad(quantize_input(x), 4)
    c2q = fold_requant(conv12(qparams, xq), qparams["s2"], qparams["t2"])
    out = conv3(qparams, edge_pad(c2q, 2))
    return out[0] if squeeze else out
