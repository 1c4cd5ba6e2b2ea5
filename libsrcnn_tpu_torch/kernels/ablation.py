"""Stage cuts of the fused conv stack: which phase of a kernel takes its time.

Port of the JAX package's ablation kernels: K6, ``kern`` of
``benchmarks/kernel_ablation.py`` (`:48-75`, cuts of K1, K2 and K3), and
K7, ``kern`` of ``benchmarks/int8_ablation.py`` (`:43-97`, cuts of K4).
A cut is the kernel instantiated to stop after one of its phases (the
``STAGE`` template argument of the ``csrc`` sources, built into the
profiling libraries, ``_build.PROFILING``).  Stages are cumulative:

=========  ==============================================================
``load``   the window (rounded to bf16 for K2 / K3, quantized for K4)
           and the weights in shared memory
``conv1``  + conv1 9x9 1->64 with its epilogue (K4: the requant to h1q)
``conv2``  + conv2 1x1 64->32 with its epilogue (K4: c2q)
``taps``   + conv3's tap GEMM
``full``   the whole kernel: the production instance, built again
=========  ==============================================================

The TPU tools' ``dma``, ``roll``, ``quant`` and ``im2col`` stages are
Mosaic's; on Hopper there is no lane rotate and conv1's im2col is done in
registers, so the cuts follow the CUDA kernels' own phases.

What a cut writes.  The JAX cuts keep one channel; nvcc would then delete
the other channels' work.  A cut here writes, per output pixel, one value
that needs all of its last stage's work at that pixel's own c2 ring
position: ``load`` the pixel's centre tap as the kernel holds it (tf32 hi
+ lo for K1, which is the f32 value to ~2^-22 and whose plain version is
the f32 value; the bf16 value for K3, bf16 hi + lo for K2, the int8 code
for K4);
``conv1`` the sum of the 64 h1 channels (h1q codes for K4); ``conv2`` the
sum of the 32 c2 channels before the ring clamp (c2q codes for K4);
``taps`` the sum of the 25 taps of G.  So a cut's image is not an upscale
of anything; ``full`` is.  The K4 cuts are integer sums below 2**24,
exact in f32, and equal their plain versions bit for bit.

:func:`forward_y_cut` launches a cut on a CUDA tensor and runs its plain
version, :func:`forward_y_cut_reference`, on a CPU tensor.  Launches count
in ``fused_conv.launches_by["K6"]`` (cuts of K1-K3) and ``["K7"]`` (K4).
"""

from __future__ import annotations

import torch

from ..models import srcnn, srcnn_int8
from . import fused_conv
from .fused_conv import HALO

_FLOAT_STAGES = ("load", "conv1", "conv2", "taps", "full")
#: the stages of each kernel's cuts, in order
STAGES = {"K1": _FLOAT_STAGES, "K2": _FLOAT_STAGES, "K3": _FLOAT_STAGES,
          "K4": _FLOAT_STAGES}
#: stage -> the code the kernels take (``srcnn::Stage``, srcnn_common.cuh)
STAGE_CODES = {"load": 0, "conv1": 1, "conv2": 2, "taps": 3, "full": 4}
#: stage -> the MACs per output pixel it keeps (the ring's recomputation
#: not counted): what its bound is computed from
STAGE_MACS = {"load": 0, "conv1": 81 * 64, "conv2": 81 * 64 + 64 * 32,
              "taps": 81 * 64 + 64 * 32 + 25 * 32,
              "full": 81 * 64 + 64 * 32 + 25 * 32}
#: the GEMM precision of K1-K3 (``fused_conv.PRECISIONS``)
PRECISION = {"K1": "exact", "K2": "split", "K3": "bf16x1"}
#: kernel -> (profiling library, int arguments before the stage, counted as)
_CUTS = {"K1": ("fused_srcnn_prof", (), "K6"),
         "K2": ("fused_srcnn_bf16_prof", (0,), "K6"),
         "K3": ("fused_srcnn_bf16_prof", (1,), "K6"),
         "K4": ("fused_srcnn_int8_prof", (), "K7")}


def _check(kernel: str, stage: str) -> None:
    if kernel not in STAGES:
        raise ValueError(f"no cuts of {kernel!r}; the cut kernels are {tuple(STAGES)}")
    if stage not in STAGES[kernel]:
        raise ValueError(f"{kernel} has no stage {stage!r}; its stages are "
                         f"{STAGES[kernel]}")


def _int_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim of integer-valued values, exactly, as f32
    (the sums lie below 2**24)."""
    return t.to(torch.int64).sum(-1).to(torch.float32)


def _float_cut(kernel: str, stage: str, params: dict, y: torch.Tensor, h: int,
               w: int) -> torch.Tensor:
    precision = PRECISION[kernel]
    if stage == "load":
        x = y[:, HALO:HALO + h, HALO:HALO + w]
        if precision == "exact":
            return x.clone()
        hi = srcnn.round_bf16(x)
        return hi if precision == "bf16x1" else hi + srcnn.round_bf16(x - hi)
    # the 9x9 windows of the output pixels' own ring positions
    x = y[:, None, 2:h + 10, 2:w + 10]
    with srcnn.exact_f32(y.device):
        if stage == "conv1":
            return srcnn.conv1(params, x, precision).sum(1)
        c2 = srcnn.conv12(params, x, precision)              # [N,32,h,w]
        if stage == "conv2":
            return c2.sum(1)
        # taps: conv3's GEMM against the 25 tap vectors, tap k = 5 dy + dx
        w3 = params["w3"][0].reshape(32, 25).t().reshape(25, 32, 1, 1)
        return srcnn.conv(c2, w3.contiguous(), precision).sum(1)


def _int8_cut(stage: str, qparams: dict, y: torch.Tensor, h: int,
              w: int) -> torch.Tensor:
    xq = srcnn_int8.quantize_input(y)
    if stage == "load":
        return xq[:, HALO:HALO + h, HALO:HALO + w].to(torch.float32)
    xq = xq[:, 2:h + 10, 2:w + 10]
    if stage == "conv1":
        return _int_sum(srcnn_int8.conv1(qparams, xq))
    c2q = srcnn_int8.fold_requant(srcnn_int8.conv12(qparams, xq), qparams["s2"],
                                  qparams["t2"])
    if stage == "conv2":
        return _int_sum(c2q)
    with srcnn.exact_f32(y.device):
        g = c2q.to(torch.float32) @ srcnn_int8.w3_taps(qparams["w3q"]).to(torch.float32).t()
    return _int_sum(g)


def forward_y_cut_reference(kernel: str, stage: str, params: dict,
                            y_padded: torch.Tensor, h: int, w: int,
                            edge_flags=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`forward_y_cut`: the ``models``
    pieces (``srcnn.conv1`` / ``conv12`` / ``conv`` in the kernel's
    precision; ``srcnn_int8.quantize_input`` / ``conv1`` / ``conv12`` /
    ``fold_requant`` and an exact tap GEMM for K4) on the halo plane.
    ``full`` is the kernel's plain version; the edge flags change nothing
    a cut writes (its positions are output pixels, which the ring clamp
    never moves)."""
    _check(kernel, stage)
    fused_conv._check_plane(y_padded, h, w)
    flags = fused_conv._flags(edge_flags)
    if stage == "full":
        if kernel == "K4":
            return fused_conv.forward_y_int8_reference(params, y_padded, h, w, flags)
        return fused_conv.forward_y_reference(params, y_padded, h, w, flags,
                                              precision=PRECISION[kernel])
    if kernel == "K4":
        srcnn_int8.check_params(params)
    squeeze = y_padded.dim() == 2
    y = y_padded[None] if squeeze else y_padded
    out = (_int8_cut(stage, params, y, h, w) if kernel == "K4"
           else _float_cut(kernel, stage, params, y, h, w))
    return out[0] if squeeze else out


def launch_cut(kernel: str, stage: str, packed: torch.Tensor,
               y_padded: torch.Tensor, out: torch.Tensor,
               flags=(1, 1, 1, 1)) -> None:
    """Launch ``kernel``'s cut at ``stage`` on CUDA tensors, as
    ``fused_conv.launch`` launches the kernel (``packed`` from
    ``fused_conv.pack_params``, K4: ``pack_int8_params``), and count it
    as K6 (K1-K3) or K7 (K4)."""
    _check(kernel, stage)
    name, lead, counted = _CUTS[kernel]
    fused_conv.run(name, "cut_forward", counted, packed, y_padded, out, flags,
                   *lead, STAGE_CODES[stage])


def forward_y_cut(kernel: str, stage: str, params: dict, y_padded: torch.Tensor,
                  h: int, w: int, edge_flags=None) -> torch.Tensor:
    """``kernel`` (K1-K4) cut after ``stage`` (:data:`STAGES`) on halo
    planes ``[h+12, w+12]`` or ``[N, h+12, w+12]`` f32 -> ``[h, w]`` or
    ``[N, h, w]``; ``params`` is the int8 pack for K4.  On a CUDA tensor
    this launches the cut (K6 for K1-K3, K7 for K4; built at first use)
    and counts it; on a CPU tensor it runs :func:`forward_y_cut_reference`.
    Any other device raises."""
    _check(kernel, stage)
    fused_conv._check_plane(y_padded, h, w)
    flags = fused_conv._flags(edge_flags)
    dev = y_padded.device
    if dev.type == "cpu":
        return forward_y_cut_reference(kernel, stage, params, y_padded, h, w, flags)
    if dev.type != "cuda":
        raise ValueError(f"ablation.forward_y_cut takes CPU or CUDA tensors, got {dev}")
    if not y_padded.is_contiguous():
        raise ValueError("y_padded must be contiguous")
    packed = (fused_conv.pack_int8_params(params).to(dev) if kernel == "K4"
              else fused_conv.pack_params(params).to(dev).contiguous())
    out = torch.empty(y_padded.shape[:-2] + (h, w), dtype=torch.float32, device=dev)
    launch_cut(kernel, stage, packed, y_padded, out, flags)
    return out
