"""Edge-replicate SAME convolution for the model zoo (PyTorch port of the
direct branch of ``libsrcnn_tpu/ops/packed_conv.py:109-134``).

:func:`conv_same` pads a plane by ``k // 2`` on each side with its edge
values and runs a VALID conv; :func:`conv` is the VALID conv alone.  Both
work on NCHW activations and OIHW weights and accumulate in f32; a bias
is added to the conv's f32 result, and the activations and the output
stay f32 in the callers.

Lane packing (``packed_conv.packed_conv_same``, DESIGN.md section 4c) is
not ported: it packs adjacent output columns into the TPU MXU's 128 output
lanes, which a narrow conv stack would leave idle.  Hopper's tensor cores
have no such lanes to fill, so the transform would only add zero MACs.

Precision (the families' tiers, :func:`..pipeline.family_precision`):

* ``"exact"``: f32 operands and products, f32 accumulation; on CUDA with
  TF32 off in cuDNN and cuBLAS.
* ``"bf16"``: every conv's input and weights are rounded to bf16 (round to
  nearest even, kept as f32); the products are exact and the accumulation
  is f32.  This is what the JAX package's ``Precision.DEFAULT`` computes on
  the TPU, on every device: the JAX package's CPU backend computes exact
  f32 for it instead.  ``F.conv2d`` is never run on bf16 tensors: cuDNN
  and oneDNN round its output to bf16 before the bias.  A bf16 value is
  exact in TF32, so cuDNN with TF32 allowed would compute the same
  products on the tensor cores (:data:`BF16_TF32`); on the H100 it picks
  another algorithm for a band than for the whole frame, so the tier runs
  with TF32 off (PERF.md).

Form.  A conv's per-pixel sums must not depend on the plane's shape: the
chunked path's bands and the one-shot frame share the conv, and their
outputs are held equal bit for bit.  ``F.conv2d`` lets the library pick
its algorithm by shape (oneDNN on the CPU picks another one for small
planes, and its 3x3 convs then sum in another order).  So each device
type runs one of two forms (:data:`FORMS`):

* ``"conv2d"``: ``F.conv2d`` with cuDNN's autotuner off and its
  deterministic algorithms only;
* ``"taps"``: the taps summed in a fixed order (row by row, column by
  column), each a matmul over C_in of the channels-last plane, with at
  least :data:`MIN_GEMM_N` output columns (a zero-padded matrix-vector
  product would take the library's GEMV, whose sums depend on the row
  count).  A matmul's row does not depend on how many rows there are.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..models.srcnn import edge_pad, exact_f32, round_bf16

PRECISIONS = ("exact", "bf16")

#: the conv form each device type runs (see the module docstring); on the
#: H100 cuDNN's f32 convs with TF32 off gave every zoo layer the same sums
#: in a band as in the frame
FORMS = {"cpu": "taps", "cuda": "conv2d"}
#: whether the ``bf16`` tier runs with TF32 allowed on CUDA.  Off: cuDNN's
#: TF32 algorithms sum a band in another order than the frame, which breaks
#: the chunked path's bit-identity (chip_smoke.py times both)
BF16_TF32 = False
#: the least output width of a tap's matmul in the ``taps`` form
MIN_GEMM_N = 8


def _context(device: torch.device, precision: str):
    """TF32 off for ``exact`` (and for ``bf16`` unless :data:`BF16_TF32`),
    cuDNN's autotuner off and only its deterministic algorithms; a no-op
    on the CPU."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    if precision == "exact" or not BF16_TF32:
        return exact_f32(device)
    stack = contextlib.ExitStack()
    stack.enter_context(torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled, benchmark=False, deterministic=True,
        allow_tf32=True))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    stack.callback(setattr, torch.backends.cuda.matmul, "allow_tf32", prev)
    return stack


def _taps(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID conv [N,C,H,W] x [O,C,kh,kw] -> [N,O,H-kh+1,W-kw+1] as the
    kh*kw taps' channels-last matmuls, summed in row-major tap order."""
    n, c, hp, wp = x.shape
    o, _, kh, kw = w.shape
    h, wd = hp - kh + 1, wp - kw + 1
    xl = x.permute(0, 2, 3, 1).contiguous()
    wt = w.permute(2, 3, 1, 0)                       # [kh, kw, C, O]
    if o < MIN_GEMM_N:
        wt = torch.cat([wt, wt.new_zeros(kh, kw, c, MIN_GEMM_N - o)], -1)
    wt = wt.contiguous()
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            t = xl[:, dy:dy + h, dx:dx + wd].reshape(-1, c) @ wt[dy, dx]
            acc = t if acc is None else acc + t
    return acc[:, :o].reshape(n, h, wd, o).permute(0, 3, 1, 2).contiguous()


def conv(x: torch.Tensor, w: torch.Tensor, precision: str = "exact",
         bias: torch.Tensor | None = None) -> torch.Tensor:
    """VALID conv of [N,C,H,W] with [O,C,kh,kw] at ``precision``, plus
    ``bias`` [O] (f32, never rounded), in the device type's form
    (:data:`FORMS`)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if precision == "bf16":
        x, w = round_bf16(x), round_bf16(w)
    with _context(x.device, precision):
        out = _taps(x, w) if FORMS[x.device.type] == "taps" else F.conv2d(x, w)
    return out if bias is None else out + bias.reshape(1, -1, 1, 1)


def conv_same(x: torch.Tensor, w: torch.Tensor, precision: str = "exact",
              bias: torch.Tensor | None = None) -> torch.Tensor:
    """SAME conv with edge-replicate padding (odd square kernels,
    :func:`..models.srcnn.edge_pad`), plus ``bias``: [N,C,H,W] ->
    [N,O,H,W]."""
    return conv(edge_pad(x, w.shape[-1] // 2), w, precision, bias)


def conv_transpose_same(x: torch.Tensor, w: torch.Tensor, r: int,
                        precision: str = "exact") -> torch.Tensor:
    """``lax.conv_transpose(x, w, (r, r), "SAME")`` of the JAX package (no
    kernel flip): [N,C,H,W] with OIHW [O,C,k,k] -> [N,O,H*r,W*r].

    ``lax.conv_transpose`` correlates the r-dilated input, zero-padded by
    ``(pad_a, pad_b)``, with ``w``; ``F.conv_transpose2d`` with the
    flipped kernel is the full correlation, so the SAME output is its rows
    from ``k - 1 - pad_a`` on, with ``output_padding`` zero rows appended
    where the full one is shorter (a stride beyond the kernel, k < r).
    This form is not held to :data:`FORMS`: no shipped head reaches it."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if precision == "bf16":
        x, w = round_bf16(x), round_bf16(w)
    k = w.shape[-1]
    h, wd = x.shape[-2:]
    pad_a = k - 1 if r > k - 1 else -(-(k + r - 2) // 2)
    start = k - 1 - pad_a
    extra = max(0, start + r - k)
    with _context(x.device, precision):
        full = F.conv_transpose2d(x, w.transpose(0, 1).flip(-2, -1), stride=r,
                                  output_padding=extra)
    return full[..., start:start + h * r, start:start + wd * r]
