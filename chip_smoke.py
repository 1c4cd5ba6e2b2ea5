"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths on the card through its hand-written CUDA kernels
(SRCNN 9-1-5 at its full width, shipped weights), in phases:

1. require a CUDA device; print the card's name and power limit; print
   the directory the shipped weights are read from, which must be the
   port's own ``models/weights`` (the JAX package is blocked in
   ``sys.modules`` from the top of this file, so nothing of it can be
   found or imported in any phase);
2. build the six kernel libraries from ``libsrcnn_tpu_torch/kernels/csrc``
   (one nvcc each, started together, sm_90a): the main path's three and
   their profiling builds (``-DSRCNN_PROFILING``: K5 and the stage cuts K6
   / K7); print each kernel instance's ptxas line (registers, spills) under
   its kernel's name; dump each cut instance's SASS (``cuobjdump``) and
   check that its count of HMMA / IMMA / HGMMA / IGMMA / FFMA instructions
   grows with each stage the cut keeps, so that no cut has been optimised
   away (the full kernel adds only adds, so its count equals or passes the
   last cut's).  Every kernel is a ``wgmma`` kernel: check that the
   production K1, K2, K3, K3h, K3n and K4, and K5 in the profiling build,
   hold HGMMA / IGMMA (``wgmma`` on tf32 or bf16 / s8) and no HMMA / IMMA
   (``mma.sync``), that K1 holds no FFMA, and that no production kernel
   spills;
3. hold every kernel against its plain PyTorch version on the card at the
   listed plane shapes and edge flags, and a batch of 3 planes in one
   launch: K1 (exact) max abs error <= 2e-3; K2 (split) and K3h (split,
   hi/lo-packed conv1) <= 5e-3; K3 (bf16x1) at every pixel within its flip
   bound (``tests/bf16x1_gate.py``: what bf16 roundings of h1 and c2 that
   another f32 sum order can flip allow there, ~1e-4 where no rounding is
   near a midpoint, up to ~1 where one is) and max <= 2.0, each case's
   worst gap / bound printed; K3n equal to K3 bit for bit; K4 (int8)
   equal to its plain version bit for bit; a batched launch equal to the
   planes launched one at a time; on the same planes K5 (row bands) equal
   to K3 bit for bit at ``tile_h`` 64 and at the recommended
   ``fused_conv.BAND_TILE_H``; every cut (``kernels/ablation``) against
   its plain version: K7 (the cuts of K4) bit for bit, K6 (of K1, K2, K3)
   at its kernel's gate after scaling the error by 255 / max(255, max
   |value|) (K3's cuts: each stage's flip bound, scaled alike); each
   ``full`` cut equal to the production kernel bit for bit;
4. the main path, exact tier: ``upscale(..., device="cuda")`` on four
   seeded 1024x1024 RGB frames at x2, the 29 reference-binary golden
   configs and one ``process_srcnn`` call -- K1 launched once per pass,
   each frame within 1 u8 LSB of the plain path on the card, each golden
   within 1 u8 LSB of the reference binary;
5. the throughput tiers on the same path: the four frames and the tier
   quality inputs of ``benchmarks/tier_quality.py`` (butterfly, castle96,
   noise33 at x2 and x3) at ``bfloat16`` (K2), at ``bfloat16`` with the
   hi/lo pack switched on (K3h), at ``bfloat16_fast`` (K3) and at
   ``bfloat16_fast`` with the narrow tile switched on (K3n) -- each kernel
   launched once per pass, within the JAX package's envelope of the exact
   tier (split <= 2 u8, bf16x1 <= 3 u8, SSIM >= 0.995), K3h within 1 u8 of
   K2, K3n equal to K3, and K3 within 1 u8 of the plain bf16 path;
   then the int8 tier on the same inputs: K4 launched once per pass, each
   output within 1 u8 of the plain int8 path on the card (the count of
   differing pixels printed; 0 expected), butterfly256 x2 >= 38 dB PSNR
   against the exact tier;
6. serving at every tier, int8 included: ``upscale_frames`` on the
   4-frame clip equals ``upscale`` per frame bit for bit with one launch
   per clip, ``VideoUpscaler.stream`` likewise, and the flip ensemble of a
   frame through ``upscale`` equals ``upscale_frames`` of it;
7. the chunked path at ``float32``, ``bfloat16`` and ``bfloat16_fast``:
   ``upscale_chunked`` of a 1024^2 frame at x2 with 256- and 13-row bands,
   output and conv map equal to ``upscale``'s; the band-wise ensemble equal
   to ``upscale(self_ensemble=True)``; a 4096x2048 frame at x2 in 512-row
   bands equal to the one-shot pass, at no more than half its peak device
   memory (both peaks and the chunked MP/s printed);
8. time at 2048x2048 each kernel (its launch on weights packed once, and
   through its wrapper) beside its plain version, its bound (K1: 3xTF32 on
   the tensor cores, and the f32 FMA bound beside it), the figures of K2,
   K3, K3h, K3n, K4 and K5 before their redesign on ``wgmma`` and a
   library yardstick
   (K1, K2, K3h: the cuDNN f32 conv stack; K3, K3n: the cuDNN bf16 conv
   stack; K4: ``torch._int_mm`` on the three im2col'd layers), the frame
   pass and ``upscale_frames`` per frame at each tier (medians of
   CUDA-event timings after a warm-up); K5 at ``tile_h`` 12, 64 and the
   recommended ``BAND_TILE_H`` beside K3, its plain version and the cuDNN
   bf16 stack;
9. the kernel-profiling path, which launches K5-K7: with the launch
   counts at 0, the port's ``tools.kernel_ablation`` tables of K1, K2 and
   K3 and ``tools.int8_ablation``'s of K4 at 2048^2 (each stage's
   CUDA-event median, its delta, MP/s and the production launch), and
   ``tools.trace_kernel`` on K5 at both band heights; each of K5, K6 and
   K7 launched in that run;
10. the model zoo at full width with the shipped weights (vdsr depth 16 /
    32 channels, srcnn955 9-5-5 64 / 32, fsrcnn d 56 s 12 m 4, espcn
    64 / 32), at ``float32`` and ``bfloat16``, through library convs (no
    hand kernel: the JAX package runs XLA convs for them; no srcnn kernel
    may launch): each family's ``upscale`` on the card against the CPU on
    butterfly 256^2 (x2; x3 and x4 for the LR heads; x2.5 and step-scale
    x4 for the HR families, pass by pass), within 1 u8 (``float32``) or
    3 u8 (``bfloat16``: flipped bf16 roundings) on fewer than 2% of the
    pixels;
    ``upscale_chunked`` in 256- and 13-row bands, ``upscale_frames`` of
    the 4-frame clip, ``VideoUpscaler.stream`` and the ensemble (through
    ``upscale_frames`` and in bands) equal to ``upscale`` bit for bit on
    a 1024^2 frame; ``bfloat16`` with TF32 allowed against TF32 off (both
    timed; a gate while the tier runs with TF32 allowed, and the count of
    values by which TF32-allowed bands miss the frame); each family's
    1024^2 -> 2048^2 frame pass and conv stack beside its bound; vdsr's
    chunked rate and peak memory on a 4096x2048 frame at x2 (at most half
    the one-shot pass's);
11. the CLI, I/O, eval and debug dumps, in a temporary directory: which
    image / video codecs the host has (Pillow, which the CLI's PNG files
    need, is a check; OpenCV drives the mp4 path when present); the native
    host library built from ``native/srcnn_host.cpp``; ``cli.main`` on a
    seeded 1024^2 PNG at each srcnn tier (default K1, ``--bf16`` K2,
    ``--bf16-fast`` K3, ``--int8`` K4: one launch of the tier's kernel,
    its ``Test Ok`` line printed) and on butterfly 256^2 with
    ``--model=fsrcnn --scale=3`` (no srcnn kernel), ``--chunked=256`` (one
    K1 launch per band) and ``--ensemble`` (its launches printed), each
    output PNG and conv map read back equal to ``upscale`` on the card bit
    for bit; ``--debug-dir`` writing 100 planes, and
    ``debug_intermediates`` on the card within 5e-3 of the CPU's;
    ``evaluate_image`` of butterfly x2 on the card within 0.01 dB / 1e-4
    SSIM of the CPU's; ``io.video.upscale_stream`` of the 4-frame clip at
    ``batch=2`` and ``batch=None`` and ``upscale_video`` APNG -> APNG equal
    to ``upscale`` per frame, GIF -> GIF and mp4 -> mp4 by frame count
    and size; the port's ``FrameRing`` fed by a producer thread into
    ``VideoUpscaler.stream_from_ring``, equal to ``upscale`` per frame.
    The launches made by these entry points are added to K1-K4's counts in
    the kernels record; every path not driven is named on one line;
12. training on the card (``libsrcnn_tpu_torch.train``, the JAX CLI's
    defaults: batch 16 of 32^2 patches of butterfly 256^2 at x2, Adam at
    lr 1e-4): the step-0 gradients of a seeded init, card against CPU,
    within 1e-4 of each parameter's largest; 50 steps on the card and on
    the CPU from that init, per-step losses within 1e-3 relative, the last
    below the first, TF32 off in every forward and backward (read inside
    them), and a second card run from that init whose losses and weights
    equal the first's bit for bit; the first-step card gradient of every
    leaf of the 9-1-5, vdsr, srcnn955, fsrcnn x2 and espcn x2 (shipped
    weights, batch 16 of 32^2 patches of butterfly, LR patches for the LR
    heads, seed 0) against the same loss's float64 gradient on the CPU
    along the card's own ReLU / PReLU branches (``tests/grad_gate.py``),
    each leaf within min(1e-3, max(1e-4, 256 * 2**-24 * kappa)) of its
    largest entry, kappa being how far its sum cancels, each gap, kappa
    and limit printed, every branch the card takes where f64 takes the
    other within 1e-4 of its activation's largest magnitude, and the same
    step in float64 on the card within 1e-9 of the CPU's; 10 steps from the
    shipped weights (``--from-pretrained``),
    whose first loss is below the random init's; 10 steps of fsrcnn x2 at
    full width through ``make_loss_forward`` / ``make_lr_patch_batch``,
    whose loss falls; no kernel launched by training; both 9-1-5 runs
    saved, reloaded with ``load_checkpoint`` and served on a 1024^2 frame
    through ``upscale(..., params=)``, one K1 launch each, within 1 u8 of
    the plain path (the random init's outputs mostly clamp to a constant
    after 50 steps, so it exercises K1's clamp; the fine-tuned weights
    exercise the whole stack); the median ms per step at batch 16 x 32^2 and 128 x
    33^2;
13. the C ABI on the card: ``capi.build()`` (g++, embedding this
    Python), ``tests/capi_driver.c`` linked against it and run in its own
    process with ``LIBSRCNN_TORCH_DEVICE=cuda`` on a 1024^2 RGB frame
    (bicubic) and a 256^2 RGBA frame (lanczos3) at x2, its output and conv
    map equal byte for byte to the in-process ``process_srcnn`` on the
    card (one K1 launch each), and the same through ``ctypes.PyDLL`` in
    this process (one K1 launch each); ``ProcessSRCNN`` at d = 2 -> -1 and
    multiply 0 -> -2; the driver processes load the kernel libraries phase
    2 built (``kernels/_build`` unchanged); the C call's wall time beside
    the in-process call's.  Phases 12 and 13 add their K1 launches to the
    kernels record;
14. the multi-device serving paths (``libsrcnn_tpu_torch.parallel``) on
    meshes over this one card (``["cuda:0"] * n``: the halo exchange, the
    edge flags and one launch per shard run as on n cards, the copies
    between cards do not): ``halo.forward_y_tiled`` of a 2048^2 Y plane
    over 2x2 and 4x2 at ``exact``, ``split`` and ``bf16x1``, equal to the
    whole plane's K1 / K2 / K3 bit for bit with one launch per tile;
    ``upscale_tiled`` of a 1024^2 frame at x2 over 2x2 and 4x2 at
    ``float32``, ``bfloat16`` and ``bfloat16_fast`` (one K1 / K2 / K3
    launch per tile) and its ensemble over 2x2 (16 K1 launches), output and
    conv map equal to ``upscale`` on the card; vdsr, srcnn955, fsrcnn x2 /
    x3 and espcn x2 tiled over 2x2 at ``float32`` and ``bfloat16``, equal
    to ``upscale``, no srcnn kernel; ``upscale_batch`` and
    ``upscale_frames(mesh=)`` of the 4-frame clip over data 2 and 4 at
    all four tiers, equal to ``upscale_frames``, one K1 / K2 / K3 / K4
    launch per shard; ``upscale_spatial`` over 2x2 and 4x2 equal to
    ``upscale(use_kernel=False)``, ``use_kernel=True`` refused;
    ``upscale_pipelined`` of the clip (srcnn at 2, 3, 4 stages, srcnn955
    at 2, vdsr at 2 and 4) equal to ``upscale(use_kernel=False)`` per
    frame (srcnn within 1 u8 of K1), no kernel; the tiled plane, tiled
    frame and batch timed against their single-device twins.  The mesh
    paths' launches are added to the kernels record;
15. the multi-process mesh and training on a mesh: two ranks in their own
    processes (``chip_smoke.py --mesh-rank``), joined by ``gloo`` on a free
    local port (NCCL refuses two ranks on one GPU; a line says that NCCL
    between cards is not driven on a one-card host), each over
    ``["cuda:0"] * 2`` and loading the kernel libraries phase 2 built
    (``kernels/_build`` unchanged after them): ``upscale_tiled`` of a
    1024^2 frame at x2 over ``global_mesh(data=1, row=2, col=2)`` (rows
    across the ranks) at ``float32``, ``bfloat16`` and ``bfloat16_fast``,
    each rank's tiles and conv map equal to ``upscale`` on the card, one
    K1 / K2 / K3 launch per local tile; ``upscale_batch`` and
    ``upscale_frames(mesh=)`` of the 4-frame clip over data 2 across the
    ranks at all four tiers, each rank's frames equal to
    ``upscale_frames``, one K1-K4 launch per local shard;
    ``process_local_batch(4) == 2``; ``upscale_pipelined`` of the clip
    with its two stages on the two ranks, equal to
    ``upscale(use_kernel=False)``; one dp / sp step over
    ``global_mesh(data=2, row=2, col=1)`` against the single-process step
    on the card (loss within 1e-4 relative, every weight within 1e-6,
    the JAX worker's gates) and a sharded checkpoint written and
    reloaded; one step of fsrcnn x2 (shipped weights) with its rows
    across the ranks (``global_mesh(data=1, row=4, col=1)``) and of
    srcnn955 with ``col`` across them (``(1, 1, 2)``: whole weights, no
    tp cut), each against the single-process step within the same gates,
    every gradient within 1e-3 of its largest entry; every one of these
    steps taken twice from the same weights, equal bit for bit; each
    rank prints one ``MESH-RANK`` line with its launches and times, and
    the phase fails unless both exit 0 with it.  In this process the
    2x2x2 mesh trainer over ``["cuda:0"] * 8``: 3 steps at batch 16 x
    32^2 against the unsharded trainer (losses within 1e-4 relative,
    ``w1`` within 1e-5, the first step's gradients within 1e-3 of their
    largest entry (each also printed against the CPU's), the replicas
    equal bit for bit and equal to a second run's, TF32 read off in every
    forward and backward), the weights served through one K1
    launch within 1 u8 of the plain path; then each zoo family's shipped
    weights at full width (vdsr and srcnn955 on batch 16 x 32^2
    interpolated pairs, fsrcnn x2 and espcn x2 on 16 x 16^2 LR patches)
    trained 5 steps at lr 1e-5 on the same 2x2x2 mesh, and vdsr also over
    row 4 (shares of 8 rows, shorter than its halo of 16), under the same
    gates (the first weight, the first step's gradients), every replica
    whole and equal to a second run's, each trained family
    served on butterfly x2 on the card within 1 u8 of the CPU on fewer
    than 2% of the pixels, no kernel launched; every path's time beside
    its single-rank twin.  The ranks' launches are added to the kernels
    record;
16. the training recipes, the int8 calibration and the eval report
    (``libsrcnn_tpu_torch.tools``) on the card.  Each recipe at its
    published width (fsrcnn and espcn x2 at their defaults, vdsr at depth
    12 / 32 channels, srcnn955 9-5-5) on the goldens' inputs other than
    the butterfly's that hold its HR patch (castle 96^2, gray 64^2 as RGB,
    RGBA 48^2's RGB), the goldens' butterfly validating: a pool of 1024
    built once on the card; 20 steps (``--steps 20``) on the card and on
    the CPU from the same seeded init on that pool, per-step losses within
    1e-3 relative (phase 12's gate); two card runs of those 20 steps at
    the recipe's own rate (vdsr's 1e-3 included), whose losses and
    weights are equal bit for bit; then the published run, ``--steps
    200 --eval-every 100``, batch 64, whose last loss is below its first,
    TF32 read off inside every card step's forward and backward; the best
    checkpoint written with its ``meta_*`` entries, reloaded by the
    family's ``load_params(path=)`` and served at x2 within 1 u8 of the
    CPU on fewer than 2% of the values, no kernel launched; ms per step.
    ``calibrate_int8`` on the card (its default set, the goldens'
    butterfly and castle 96^2 with seeded noise and a gradient) against
    the CPU's calibration (``w1q`` equal, ``w2q`` / ``w3q`` within 1 code on at most 0.1% of
    the entries, the scales within 1e-5 relative), its pack served on
    butterfly x2 at ``int8`` through one K4 launch equal to the plain int8
    path bit for bit, its PSNR against the exact tier beside the shipped
    pack's.  ``gen_eval_report`` on butterfly 256^2 and castle 96^2
    (every model and factor of the JAX tool's report), its Markdown
    written to a temporary file, K1 launched once per pass of the srcnn,
    srcnn+step and srcnn+ens rows and nothing else launched, each
    srcnn row's PSNR equal to ``upscale``'s on the protocol's LR input.
    The phase's launches are added to the kernels record.

The second-to-last line is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device the script exits non-zero before printing a result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# the port stands alone: run as a script (phase 15's ranks re-run this file
# too), this process can neither find nor import the JAX package, so every
# phase runs on the port's own code and its own copy of the shipped weights.
# A test that imports this module for its helpers is left as it is.
if __name__ == "__main__":
    sys.modules["libsrcnn_tpu"] = None

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(ROOT, "tests", "goldens", "goldens.npz")

# max abs error of each kernel against its plain version on [0, 255] planes:
# f32 (K1) or f32 accumulation of exact bf16 products (K2, K3h) in another
# order than cuDNN's; bf16x1 (K3) adds flips of bf16 roundings of h1 / c2,
# and is held at every pixel to tests/bf16x1_gate.py's bound besides
KERNEL_TOL = {"K1": 2e-3, "K2": 5e-3, "K3h": 5e-3, "K3": 2.0}
# each throughput tier's u8 distance from the exact tier (the JAX package's
# TPU envelope, PERF.md / benchmarks/tier_quality.py)
TIER_LSB = {"bfloat16": 2, "bfloat16_fast": 3}
TIER_SSIM = 0.995

# kernel -> (forward_y mode, source, the TPU kernel it replaces); K4 runs
# through forward_y_int8
KERNELS = {
    "K1": (dict(precision="exact"), "fused_srcnn.cu", "libsrcnn_tpu/kernels/fused_conv.py:199"),
    "K2": (dict(precision="split"), "fused_srcnn_bf16.cu", "libsrcnn_tpu/kernels/fused_conv.py:121"),
    "K3": (dict(precision="bf16x1"), "fused_srcnn_bf16.cu", "libsrcnn_tpu/kernels/fused_conv.py:213"),
    "K3h": (dict(precision="split", pack_im2col=True), "fused_srcnn_bf16.cu",
            "libsrcnn_tpu/kernels/fused_conv.py:243"),
    "K3n": (dict(precision="bf16x1", geom="narrow"), "fused_srcnn_bf16.cu",
            "libsrcnn_tpu/kernels/fused_conv.py:73"),
    "K4": (None, "fused_srcnn_int8.cu", "libsrcnn_tpu/kernels/fused_conv.py:325"),
}
# the kernel-profiling path's kernels -> (source, the TPU kernel it replaces)
PROFILING_KERNELS = {
    "K5": ("fused_srcnn_bf16.cu", "libsrcnn_tpu/kernels/fused_conv.py:530"),
    "K6": ("fused_srcnn.cu", "benchmarks/kernel_ablation.py:48"),
    "K7": ("fused_srcnn_int8.cu", "benchmarks/int8_ablation.py:43"),
}
# 2048^2 launch times on the mma.sync designs, before each kernel's
# redesign on wgmma (PERF.md; K5 at tile_h 12; an H100 SXM at 700 W)
BEFORE_WGMMA_MS = {"K2": 0.984, "K4": 0.755, "K3": 0.606, "K3n": 0.696, "K5": 0.963,
                   "K3h": 0.899}
# the cut that stands for K6 / K7 in the kernels record, the same in every
# run so that the record compares across versions: K1's conv2 and K4's taps
# (every cut's time is printed in phase 9)
RECORD_CUT = {"K6": ("K1", "conv2"), "K7": ("K4", "taps")}
INT8_PSNR = 38.0     # butterfly x2 against the exact tier (tests/test_int8.py)
# H100 SXM dense peak rates at 700 W (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
MACS_PER_PIXEL = 81 * 64 + 64 * 32 + 25 * 32        # 8,032
N_PARAMS = 8129
INT8_PACK_BYTES = 8812


def smooth_plane(rng, h: int, w: int) -> np.ndarray:
    """A seeded [h, w] f32 plane in [0, 255]: a few random sinusoids plus
    noise, so the conv stack's output is mostly unclamped."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = np.zeros((h, w), np.float32)
    for _ in range(4):
        fy, fx = rng.uniform(0.002, 0.08, 2)
        f += np.sin(fy * yy + fx * xx + rng.uniform(0, 2 * np.pi))
    f = 128.0 + 25.0 * f + rng.normal(0.0, 6.0, (h, w)).astype(np.float32)
    return np.clip(f, 0.0, 255.0).astype(np.float32)


def frame(seed: int, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([smooth_plane(rng, h, w) for _ in range(3)],
                    axis=-1).astype(np.uint8)


def cuda_ms(fn, runs: int = 5, warmup: int = 2) -> list[float]:
    """CUDA-event times of ``runs`` single calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return times


def timed(fns: dict, runs: int = 5) -> dict:
    """Median CUDA-event ms of each callable, run in turns a, b, ..., b, a
    so that both orders share the card."""
    names = list(fns)
    times = {k: [] for k in names}
    for k in names + names[::-1]:
        times[k] += cuda_ms(fns[k], runs)
    return {k: float(np.median(v)) for k, v in times.items()}


def check(cond, what) -> None:
    """Raise unless ``cond`` (not ``assert``: it must hold under -O too)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def lsb(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def bound(kernel: str, n: int, h: int, w: int,
          macs_per_pixel: int = MACS_PER_PIXEL, fma: bool = False) -> tuple[float, str]:
    """Least time (ms) the card could take for the kernel's work on n
    [h, w] planes, and what sets it: the useful MACs (``macs_per_pixel``:
    all of them, or the stages a cut keeps) at the tensor-core bf16 rate
    (two passes for the split forms), the TF32 rate (K1: three passes,
    3xTF32; with ``fma``, the f32 FMA rate that K1 ran at before it moved
    to the tensor cores), or the int8 rate (K4), or the planes in and out
    plus the parameters at the memory rate."""
    macs = macs_per_pixel * n * h * w
    if kernel == "K1":
        ops_s = 2 * macs / PEAK_F32_FLOPS if fma else 3 * 2 * macs / PEAK_TF32_FLOPS
    elif kernel == "K4":
        ops_s = 2 * macs / PEAK_INT8_OPS
    else:
        ops_s = (2 if kernel in ("K2", "K3h") else 1) * 2 * macs / PEAK_BF16_FLOPS
    param_bytes = INT8_PACK_BYTES if kernel == "K4" else 4 * N_PARAMS
    bytes_s = (4 * (n * (h + 12) * (w + 12) + n * h * w) + param_bytes) / PEAK_BYTES
    return (1e3 * max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes")


SASS_OPS = ("HMMA", "IMMA", "HGMMA", "IGMMA", "FFMA")
PROFILING_LIBS = ("fused_srcnn_prof", "fused_srcnn_bf16_prof", "fused_srcnn_int8_prof")
MAIN_LIBS = ("fused_srcnn", "fused_srcnn_bf16", "fused_srcnn_int8")
# the bf16 wgmma kernel's (MODE, TW) -> kernel; MODE 0 SPLIT, 1 BF16X1, 2 HILO
WGMMA_BF16 = {(0, 60): "K2", (1, 60): "K3", (1, 28): "K3n", (2, 60): "K3h"}


def kernel_of(symbol: str):
    """(kernel, stage) of a kernel instance from its mangled name, or None.
    Instances are told apart by their mangled template arguments:
    ``fused_srcnn_kernel<STAGE>`` (K1),
    ``fused_srcnn_wgmma_bf16_kernel<MODE, TW, STAGE>`` (K2, K3, K3h, K3n:
    :data:`WGMMA_BF16`), ``fused_srcnn_int8_kernel<STAGE>`` (K4); K5 is
    ``fused_srcnn_band_kernel``."""
    from libsrcnn_tpu_torch.kernels import ablation

    stage_of = {code: name for name, code in ablation.STAGE_CODES.items()}
    if "fused_srcnn_band_kernel" in symbol:
        return ("K5", "full")
    m = re.search(r"(fused_srcnn(?:_wgmma_bf16|_int8)?)_kernelI((?:Li\d+E)+)E", symbol)
    if not m:
        return None
    args = tuple(int(a) for a in re.findall(r"Li(\d+)E", m.group(2)))
    if m.group(1) == "fused_srcnn_wgmma_bf16":
        kernel, stage = WGMMA_BF16.get(args[:2]), args[2]
    else:
        kernel = {"fused_srcnn": "K1", "fused_srcnn_int8": "K4"}[m.group(1)]
        stage = args[0]
    return None if kernel is None else (kernel, stage_of[stage])


def sass_counts(_build, libs=PROFILING_LIBS) -> dict:
    """(kernel, stage) -> {op: count} of the HMMA / IMMA (``mma.sync``),
    HGMMA / IGMMA (``wgmma``: float / integer) and FFMA instructions in
    each kernel instance of ``libs`` (the profiling libraries' cuts by
    default), from ``cuobjdump -sass`` (the toolkit nvcc came from);
    instances are named by :func:`kernel_of`."""
    counts = {}
    for lib in libs:
        sass = subprocess.run([_build.tool("cuobjdump"), "-sass", _build.library_path(lib)],
                              capture_output=True, text=True, check=True).stdout
        key = None
        for line in sass.splitlines():
            if "Function :" in line:
                key = kernel_of(line)
                if key:
                    counts[key] = dict.fromkeys(SASS_OPS, 0)
            elif key and (op := re.search(r"\s(HMMA|IMMA|HGMMA|IGMMA|FFMA)[.\s]", line)):
                counts[key][op.group(1)] += 1
    return counts


def ptxas_lines(log: str) -> list[tuple[str, str]]:
    """(instance, line) of each registers or spill line of a ptxas -v log:
    the instance is its kernel and stage (:func:`kernel_of`), or the
    function's mangled name."""
    out, fn = [], "?"
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            key = kernel_of(m.group(1))
            fn = f"{key[0]} {key[1]}" if key else m.group(1)
        elif "registers" in line or "spill" in line:
            out.append((fn, line.strip()))
    return out


# the model zoo (phase 10): family -> the factors held card against CPU on
# butterfly 256^2, as (scale, step_scale)
ZOO_SCALES = {"vdsr": [(2.0, False), (2.5, False), (4.0, True)],
              "srcnn955": [(2.0, False), (2.5, False), (4.0, True)],
              "fsrcnn": [(2.0, False), (3.0, False), (4.0, False)],
              "espcn": [(2.0, False), (3.0, False), (4.0, False)]}
ZOO_TIERS = ("float32", "bfloat16")
# card against CPU, u8 distance on fewer than 2% of the pixels: float32 F2;
# bfloat16 3, as a flipped bf16 rounding of an activation (the card and the
# CPU sum each conv in another order) moves the plane by up to 2.0
# (tests/test_torch_zoo_models.py) and the u8 cast truncates
ZOO_CARD_LSB = {"float32": 1, "bfloat16": 3}
# bfloat16 with TF32 allowed against the same bf16 operands with TF32 off, on
# each family's plane: the mean (the same products, summed in another order)
# and the max (a flipped bf16 rounding of an activation moves a pixel by up
# to ~2, tests/test_torch_zoo_models.py); a gate only while the tier runs
# with TF32 allowed (ops.conv.BF16_TF32)
ZOO_TF32_MEAN, ZOO_TF32_MAX = 1e-3, 2.0


def zoo_macs_per_pixel(model: str, params: dict, spec) -> float:
    """Useful MACs per output pixel of a family's conv stack, from its
    parameters' shapes: every conv's C_out * C_in * k^2 per pixel of its
    plane; an LR family's LR-plane MACs (its deconv as the dense L x L
    sub-pixel conv it runs) over scale^2."""
    from libsrcnn_tpu_torch.models import fsrcnn

    if model == "fsrcnn":
        L, _, _ = fsrcnn._subpixel_plan(params["deconv_w"].shape[-1], spec.scale)
        convs = [v for k, v in params.items() if k.endswith("_w") and k != "deconv_w"]
        macs = sum(w[0].numel() * w.shape[0] for w in convs)
        macs += L * L * params["deconv_w"].shape[1] * spec.scale ** 2
        return macs / spec.scale ** 2
    ws = [v for k, v in params.items() if k != "__spec__" and v.dim() >= 4]
    macs = sum(w.numel() for w in ws)            # O * I * k^2 (vdsr: L of them)
    return macs / (spec.scale ** 2 if model == "espcn" else 1)


def zoo_phase(card: str, z, frames: list) -> None:
    """Phase 10: the model zoo's four families at full width (shipped
    weights) through upscale, serving and the chunked path, at ``float32``
    and ``bfloat16``, with no hand kernel (library convs, ``ops/conv``)."""
    import libsrcnn_tpu_torch as lt
    from libsrcnn_tpu_torch import api, pipeline
    from libsrcnn_tpu_torch.kernels import fused_conv
    from libsrcnn_tpu_torch.ops import conv as zconv

    dev = torch.device("cuda")
    print(f"zoo: conv form on the card {zconv.FORMS['cuda']!r}, on the CPU "
          f"{zconv.FORMS['cpu']!r}; bfloat16 with TF32 allowed: {zconv.BF16_TF32}")
    fused_conv.launches = 0
    butterfly = z["in_butterfly_full"]
    # 1. card against CPU on butterfly 256^2.  A step-scale chain is held
    # pass by pass, each CPU pass from the card's input: the u8 round trip
    # between passes turns a 1 u8 difference of the first pass into 2 u8
    # (float32, srcnn955) or 7 u8 (bfloat16, vdsr) after the second; two
    # CPU conv forms, which differ only in their sum order, differ so too
    def gate(card_out, cpu_out, what, tier):
        check(card_out.shape == cpu_out.shape, f"zoo {what}: shape")
        d = np.abs(card_out.astype(int) - cpu_out.astype(int))
        frac = float((d > 0).mean())
        check(d.max() <= ZOO_CARD_LSB[tier] and frac < 0.02, f"zoo {what}: card "
              f"{d.max()} u8 off the CPU on {100 * frac:.3f}% of the pixels")
        return int(d.max()), frac

    for model, scales in ZOO_SCALES.items():
        for tier in ZOO_TIERS:
            worst, chain = (0, 0.0), ""
            for scale, step in scales:
                what = f"{model} {tier} x{scale:g}{' step' if step else ''}"
                cfg = lt.SRCNNConfig(model=model, compute_dtype=tier, step_scale=step)
                card_out = lt.upscale(butterfly, scale, cfg, device="cuda")
                if step:
                    one = dataclasses.replace(cfg, step_scale=False)
                    src, passes = butterfly, []
                    while len(passes) < int(scale) // 2:
                        passes.append((src, lt.upscale(src, 2.0, one, device="cuda")))
                        src = passes[-1][1]
                    check(np.array_equal(card_out, src), f"zoo {what}: the chain differs "
                          f"from its x2 passes on the card")
                    for i, (x, y) in enumerate(passes):
                        r = gate(y, lt.upscale(x, 2.0, one, device="cpu"), f"{what} pass {i}",
                                 tier)
                        worst = (max(worst[0], r[0]), max(worst[1], r[1]))
                    cpu_out = lt.upscale(butterfly, scale, cfg, device="cpu")
                    d = np.abs(card_out.astype(int) - cpu_out.astype(int))
                    chain = (f"; the whole x{scale:g} chain card vs CPU max {d.max()} u8 on "
                             f"{100 * float((d > 0).mean()):.3f}% of the pixels")
                    continue
                r = gate(card_out, lt.upscale(butterfly, scale, cfg, device="cpu"), what, tier)
                worst = (max(worst[0], r[0]), max(worst[1], r[1]))
            print(f"zoo {model} {tier}: butterfly 256^2 at "
                  + ", ".join(f"x{s:g}{' step (per pass)' if st else ''}" for s, st in scales)
                  + f": card vs CPU max {worst[0]} u8 on {100 * worst[1]:.4f}% of the "
                  f"pixels{chain}")
    # 2. bit-identity on the card: chunked, serving, ensemble
    f0, clip = frames[0], np.stack(frames)
    for model in ZOO_SCALES:
        for tier in ZOO_TIERS:
            cfg = lt.SRCNNConfig(model=model, compute_dtype=tier)
            ref, refc = lt.upscale(f0, 2.0, cfg, return_conv_map=True, device="cuda")
            for band in (256, 13):
                out, conv = lt.upscale_chunked(f0, 2.0, cfg, band_rows=band, device="cuda")
                check(np.array_equal(out, ref) and np.array_equal(conv, refc),
                      f"zoo {model} {tier}: chunked in {band}-row bands differs from "
                      f"upscale on {int((out != ref).sum())} values")
            served = lt.upscale_frames(clip, 2.0, cfg, device="cuda")
            singles = [ref] + [lt.upscale(f, 2.0, cfg, device="cuda") for f in frames[1:]]
            check(all(np.array_equal(o, s) for o, s in zip(served, singles)),
                  f"zoo {model} {tier}: upscale_frames differs from its frames")
            streamed = list(lt.VideoUpscaler(2.0, cfg, device="cuda").stream(frames[:2]))
            check(all(np.array_equal(o, s) for o, s in zip(streamed, singles)),
                  f"zoo {model} {tier}: VideoUpscaler.stream differs from its frames")
            ens = dataclasses.replace(cfg, self_ensemble=True)
            e_ref, e_refc = lt.upscale(f0, 2.0, ens, return_conv_map=True, device="cuda")
            e_frames = lt.upscale_frames(clip[:1], 2.0, ens, device="cuda")[0]
            e_out, e_conv = lt.upscale_chunked(f0, 2.0, ens, band_rows=256, device="cuda")
            check(np.array_equal(e_frames, e_ref), f"zoo {model} {tier}: ensemble "
                  f"upscale_frames differs from upscale")
            check(np.array_equal(e_out, e_ref) and np.array_equal(e_conv, e_refc),
                  f"zoo {model} {tier}: band-wise ensemble differs from upscale's")
            print(f"zoo {model} {tier}: 1024^2 x2 chunked in 256- and 13-row bands, "
                  f"upscale_frames of 4 frames, VideoUpscaler.stream, the ensemble "
                  f"through upscale_frames and in 256-row bands == upscale bit for bit")
    check(fused_conv.launches == 0, f"the zoo launched srcnn kernels: "
          f"{dict(fused_conv.launches_by)}")
    # why the bf16 tier runs with TF32 off: with it allowed, cuDNN sums a band
    # in another order than the frame
    prev, zconv.BF16_TF32 = zconv.BF16_TF32, True
    try:
        for model in ("srcnn955", "fsrcnn"):
            cfg = lt.SRCNNConfig(model=model, compute_dtype="bfloat16")
            ref = lt.upscale(f0, 2.0, cfg, device="cuda")
            out, _ = lt.upscale_chunked(f0, 2.0, cfg, band_rows=13, device="cuda")
            print(f"zoo {model} bfloat16 with TF32 allowed: 13-row bands differ from "
                  f"upscale on {int((out != ref).sum())} values")
    finally:
        zconv.BF16_TF32 = prev
    # 3. timing, the TF32 check, bounds
    rng = np.random.default_rng(10)
    img = torch.tensor(frames[1], device=dev)
    for model in ZOO_SCALES:
        mod = pipeline.FAMILY_MODULES[model]
        hr = model in pipeline.HR_FAMILIES
        p = api._params_on(None, lt.SRCNNConfig(model=model), dev, 2.0)
        spec = p["__spec__"]
        params = {k: v for k, v in p.items() if k != "__spec__"}
        n = 2048 if hr else 1024
        y = torch.from_numpy(smooth_plane(rng, n, n)).to(dev)

        def stack(prec):
            if hr:
                return mod.forward_hr(params, y, spec, precision=prec)
            return mod.forward_lr(params, y, spec, precision=prec)

        def bf16_with(tf32: bool):
            prev, zconv.BF16_TF32 = zconv.BF16_TF32, tf32
            try:
                return stack("bf16")
            finally:
                zconv.BF16_TF32 = prev

        d = (bf16_with(True) - bf16_with(False)).abs()
        dmax, dmean = float(d.max()), float(d.mean())
        t = timed({"on": lambda: bf16_with(True), "off": lambda: bf16_with(False)})
        print(f"zoo {model}: bfloat16 on the {n}^2 plane, TF32 allowed vs off: max "
              f"{dmax:.4g}, mean {dmean:.4g}, {100 * float((d > 1e-3).float().mean()):.3f}% "
              f"of the pixels beyond 1e-3; conv stack {t['on']:.3f} ms with TF32 allowed, "
              f"{t['off']:.3f} ms with TF32 off (median of 10); the tier runs with TF32 "
              f"{'allowed' if zconv.BF16_TF32 else 'off'}")
        if zconv.BF16_TF32:
            check(dmean <= ZOO_TF32_MEAN and dmax <= ZOO_TF32_MAX,
                  f"zoo {model}: bfloat16 with TF32 allowed is not the bf16-operand math: "
                  f"max {dmax}, mean {dmean}")
        del d
        macs = zoo_macs_per_pixel(model, p, spec)
        for tier in ZOO_TIERS:
            cfg = lt.SRCNNConfig(model=model, compute_dtype=tier)
            prec = pipeline.family_precision(tier)
            t = timed({"frame": lambda: pipeline.run_pass(img, p, 2.0, cfg),
                       "stack": lambda: stack(prec)}, runs=5)
            tf32 = tier == "bfloat16" and zconv.BF16_TF32
            peak = PEAK_TF32_FLOPS if tf32 else PEAK_F32_FLOPS
            ops_ms = 1e3 * 2 * macs * 2048 * 2048 / peak
            bytes_ms = 1e3 * 4 * (n * n + 2048 * 2048) / PEAK_BYTES
            print(f"timing on {card}, median of 10: zoo {model} {tier}: 1024^2 -> 2048^2 "
                  f"frame pass {t['frame']:.3f} ms; conv stack ({n}^2 plane -> 2048^2) "
                  f"{t['stack']:.3f} ms; bound {max(ops_ms, bytes_ms):.3f} ms "
                  f"({'operations' if ops_ms >= bytes_ms else 'bytes'}: {macs:,.0f} MACs "
                  f"per output pixel at the {'TF32' if tf32 else 'FP32'} peak)")
        del y
    # 4. the chunked rate and peak memory of vdsr on 4096x2048 at x2
    big = frame(300, 2048, 4096)
    cfg = lt.SRCNNConfig(model="vdsr")
    api._params_on(None, cfg, dev, 2.0)            # weights resident before the peaks

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, torch.cuda.max_memory_allocated() - base, time.perf_counter() - t0

    one, one_peak, one_s = peak(lambda: lt.upscale(big, 2.0, cfg, device="cuda"))
    chk, chk_peak, chk_s = peak(lambda: lt.upscale_chunked(big, 2.0, cfg, band_rows=512,
                                                           device="cuda")[0])
    check(np.array_equal(chk, one), "zoo vdsr: chunked 4096x2048 differs from the one-shot "
          "pass")
    _, _, chk_s2 = peak(lambda: lt.upscale_chunked(big, 2.0, cfg, band_rows=512,
                                                   device="cuda"))
    mp = 8192 * 4096 / 1e6
    print(f"zoo vdsr float32: 4096x2048 -> 8192x4096 in 512-row bands == the one-shot pass; "
          f"peak device memory {chk_peak / 2**20:.1f} MiB vs one-shot {one_peak / 2**20:.1f} "
          f"MiB ({chk_peak / one_peak:.3f}x); chunked {mp / chk_s2:.1f} MP/s "
          f"({chk_s2 * 1e3:.1f} ms; first call {chk_s * 1e3:.1f} ms), one-shot "
          f"{mp / one_s:.1f} MP/s, host clock, fetches included")
    check(chk_peak <= 0.5 * one_peak, f"zoo vdsr chunked peak {chk_peak} B > half the "
          f"one-shot {one_peak} B")


# phase 11: the CLI tiers on a 1024^2 PNG -> (flags, the kernel they run)
CLI_TIERS = {"float32": ([], "K1"), "bfloat16": (["--bf16"], "K2"),
             "bfloat16_fast": (["--bf16-fast"], "K3"), "int8": (["--int8"], "K4")}
# debug_intermediates on the card against the CPU (f32 convs summed in
# other orders; the JAX test's conv tolerance against its oracle)
DEBUG_PLANE_TOL = 5e-3
EVAL_PSNR_TOL = 0.01        # dB, card against CPU
EVAL_SSIM_TOL = 1e-4


def io_phase(card: str, z, frames: list, frame_outs: list) -> dict:
    """Phase 11: the CLI, image / video / native I/O, the eval runner and
    the debug dumps on the card, in a temporary directory.  Returns the
    launches of K1-K4 made by the entry points it drove."""
    import contextlib
    import importlib.util
    import io as stdio
    import tempfile
    import threading

    import libsrcnn_tpu_torch as lt
    from libsrcnn_tpu_torch import api, cli
    from libsrcnn_tpu_torch.eval.runner import evaluate_image
    from libsrcnn_tpu_torch.io import load_image, native, save_png, video
    from libsrcnn_tpu_torch.kernels import fused_conv

    t_phase = time.perf_counter()
    codecs = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "cv2")}
    print(f"{card}: codecs on this host: Pillow "
          f"{'present' if codecs['PIL'] else 'absent'}, OpenCV "
          f"{'present' if codecs['cv2'] else 'absent'}")
    check(codecs["PIL"], "Pillow is absent: the CLI's PNG files need it")
    check(native.available(), f"the native host library did not build: {native.build_error}")
    print(f"native host library: built {os.path.basename(native.library_path())} "
          f"from native/srcnn_host.cpp ({' '.join(native.CXX_FLAGS)})")
    driven = {k: 0 for k in fused_conv.launches_by}

    def take(count: bool = True) -> dict:
        """The launches since the last call (added to the phase's count
        when ``count``), and the counts set to 0."""
        got = dict(fused_conv.launches_by)
        if count:
            for k, v in got.items():
                driven[k] += v
        fused_conv.launches = 0
        for k in fused_conv.launches_by:
            fused_conv.launches_by[k] = 0
        return got

    def run_cli(argv) -> str:
        buf = stdio.StringIO()
        with contextlib.redirect_stdout(buf):
            check(cli.main(argv) == 0, f"cli {argv}")
        return buf.getvalue()

    not_driven = []
    with tempfile.TemporaryDirectory() as tmp:
        # 1. the CLI at each srcnn tier on a 1024^2 PNG: one launch of the
        # tier's kernel, outputs equal to upscale on the card
        big = frame(400, 1024, 1024)
        small = np.ascontiguousarray(z["in_butterfly_full"])
        src, src_s = os.path.join(tmp, "big.png"), os.path.join(tmp, "bf.png")
        save_png(src, big)
        save_png(src_s, small)
        for tier, (flags, kernel) in CLI_TIERS.items():
            dst = os.path.join(tmp, f"big_{tier}.png")
            take(False)
            text = run_cli([src, dst, *flags])
            got = take()
            check(got[kernel] == 1 and sum(got.values()) == 1,
                  f"cli {tier}: launches {got}, expected one {kernel}")
            cfg = lt.SRCNNConfig(compute_dtype=tier)
            ref, refc = lt.upscale(big, 2.0, cfg, return_conv_map=True, device="cuda")
            take(False)
            out = load_image(dst)
            conv = load_image(os.path.join(tmp, "big_convolution.png"))[..., 0]
            check(np.array_equal(out, ref) and np.array_equal(conv, refc),
                  f"cli {tier}: output or conv map differs from upscale")
            ok = [ln for ln in text.splitlines() if "Test Ok, took" in ln]
            check(len(ok) == 1, f"cli {tier}: no 'Test Ok' line in {text!r}")
            print(f"cli {' '.join(flags) or '(default)'} on 1024^2 -> 2048^2 on {card}: "
                  f"1 {kernel} launch, output and conv map == upscale; {ok[0]}")
        # the zoo, the chunked path and the ensemble on butterfly 256^2
        bands = -(-512 // 256)
        for flags, cfg, scale, want in (
                (["--model=fsrcnn", "--scale=3"], lt.SRCNNConfig(model="fsrcnn"), 3.0, {}),
                (["--chunked=256"], lt.SRCNNConfig(), 2.0, {"K1": bands}),
                (["--ensemble"], lt.SRCNNConfig(self_ensemble=True), 2.0, None)):
            dst = os.path.join(tmp, "bf_out.png")
            take(False)
            run_cli([src_s, dst, *flags])
            got = {k: v for k, v in take().items() if v}
            if want is None:
                check(set(got) == {"K1"}, f"cli {flags}: launches {got}")
                print(f"cli --ensemble: a single-frame ensemble pass launches "
                      f"{got.get('K1', 0)} K1 (the 4 flips in one batched pass)")
            else:
                check(got == want, f"cli {flags}: launches {got}, expected {want}")
            ref, refc = lt.upscale(small, scale, cfg, return_conv_map=True, device="cuda")
            take(False)
            check(np.array_equal(load_image(dst), ref) and np.array_equal(
                load_image(os.path.join(tmp, "bf_convolution.png"))[..., 0], refc),
                f"cli {flags}: output or conv map differs from upscale")
            print(f"cli {' '.join(flags)} on butterfly 256^2: launches "
                  f"{got or 'none (no srcnn kernel runs a family)'}; output and "
                  f"conv map == upscale")

        # 2. --debug-dir: 100 planes; the card's planes against the CPU's
        dbg = os.path.join(tmp, "dbg")
        prev = os.environ.get("LIBSRCNN_TPU_DEBUG_DIR")
        try:
            text = run_cli([src_s, os.path.join(tmp, "bf_dbg.png"), f"--debug-dir={dbg}"])
        finally:
            if prev is None:
                os.environ.pop("LIBSRCNN_TPU_DEBUG_DIR", None)
            else:
                os.environ["LIBSRCNN_TPU_DEBUG_DIR"] = prev
        take()
        n_png = len([f for f in os.listdir(dbg) if f.endswith(".png")])
        check(n_png == 100, f"--debug-dir wrote {n_png} planes")
        on_card = api.debug_intermediates(small, 2.0, device="cuda")
        on_cpu = api.debug_intermediates(small, 2.0, device="cpu")
        err = {k: float(np.abs(on_card[k] - on_cpu[k]).max()) for k in on_cpu}
        worst = max(err, key=err.get)
        check(set(on_card) == set(on_cpu) and err[worst] <= DEBUG_PLANE_TOL,
              f"debug_intermediates card vs CPU: {worst} {err[worst]}")
        print(f"--debug-dir on butterfly 256^2 x2: {n_png} planes written; "
              f"debug_intermediates on the card vs the CPU max abs err "
              f"{err[worst]:.3g} ({worst}), resized planes "
              f"{max(v for k, v in err.items() if k.startswith('resized')):.3g}")

        # 3. the eval runner, card against CPU
        r_card = evaluate_image(small, 2.0, name="butterfly", device="cuda")
        take()
        r_cpu = evaluate_image(small, 2.0, name="butterfly", device="cpu")
        print(f"evaluate_image(butterfly 256^2, x2): card interp "
              f"{r_card.psnr_interp:.4f} dB / {r_card.ssim_interp:.6f}, srcnn "
              f"{r_card.psnr_srcnn:.4f} dB / {r_card.ssim_srcnn:.6f}; CPU interp "
              f"{r_cpu.psnr_interp:.4f} dB / {r_cpu.ssim_interp:.6f}, srcnn "
              f"{r_cpu.psnr_srcnn:.4f} dB / {r_cpu.ssim_srcnn:.6f}")
        for a, b, tol, what in (
                (r_card.psnr_interp, r_cpu.psnr_interp, EVAL_PSNR_TOL, "interp PSNR"),
                (r_card.psnr_srcnn, r_cpu.psnr_srcnn, EVAL_PSNR_TOL, "srcnn PSNR"),
                (r_card.ssim_interp, r_cpu.ssim_interp, EVAL_SSIM_TOL, "interp SSIM"),
                (r_card.ssim_srcnn, r_cpu.ssim_srcnn, EVAL_SSIM_TOL, "srcnn SSIM")):
            check(abs(a - b) <= tol, f"evaluate_image {what}: card {a}, CPU {b}")

        # 4. upscale_stream (no codec) and upscale_video (lossless APNG, GIF,
        # mp4 when OpenCV is present)
        for batch, n_launch in ((2, 2), (None, 4)):
            outs = list(video.upscale_stream(iter(frames), 2.0, batch=batch,
                                             device="cuda"))
            got = take()
            check(got["K1"] == n_launch and sum(got.values()) == n_launch,
                  f"upscale_stream batch={batch}: launches {got}")
            check(len(outs) == 4 and all(np.array_equal(o, r) for o, r in
                                         zip(outs, frame_outs)),
                  f"upscale_stream batch={batch} differs from upscale per frame")
            print(f"upscale_stream of the 4 1024^2 frames, batch={batch}: "
                  f"{n_launch} K1 launches, == upscale per frame")
        clip = [np.ascontiguousarray(small[32 * i:32 * i + 128, 24 * i:24 * i + 160])
                for i in range(4)]
        from PIL import Image

        ims = [Image.fromarray(f) for f in clip]
        for ext in ("png", "gif"):
            path = os.path.join(tmp, f"clip.{ext}")
            ims[0].save(path, save_all=True, append_images=ims[1:], duration=40, loop=0)
            src_frames, _ = video.read_frames(path)
            dst = os.path.join(tmp, f"clip_up.{ext}")
            n = video.upscale_video(path, dst, 2.0, batch=2, device="cuda")
            take()
            outs, dur = video.read_frames(dst)
            check(n == 4 and len(outs) == 4 and dur == 40 and
                  outs[0].shape == (256, 320, 3), f"upscale_video {ext}: {n} frames")
            if ext == "png":        # lossless: equal to upscale per frame
                check(all(np.array_equal(o, lt.upscale(f, 2.0, device="cuda"))
                          for o, f in zip(outs, src_frames)),
                      "upscale_video APNG differs from upscale per frame")
                take(False)
        print("upscale_video APNG -> APNG (batch 2) == upscale per frame; "
              "GIF -> GIF 4 frames at 256x320")
        if codecs["cv2"]:
            mp4 = os.path.join(tmp, "clip.mp4")
            sink = video.VideoSink(mp4, 20.0)
            for f in clip:
                sink.write(f)
            sink.close()
            dst = os.path.join(tmp, "clip_up.mp4")
            n = video.upscale_video(mp4, dst, 2.0, batch=None, device="cuda")
            take()
            back = list(video.iter_video(dst))
            check(n == 4 and len(back) == 4 and back[0].shape == (256, 320, 3),
                  f"upscale_video mp4: {n} frames")
            print("upscale_video mp4 -> mp4 (OpenCV, batch=None): 4 frames at 256x320")
        else:
            not_driven.append("upscale_video on mp4 (OpenCV absent)")

    # 5. the port's FrameRing fed by a producer thread
    ring = native.FrameRing(frames[0].nbytes, 3)
    done = threading.Event()

    def producer():
        for f in frames:
            while not ring.push(f):
                time.sleep(0.001)
        done.set()

    t = threading.Thread(target=producer)
    t.start()
    try:
        outs = list(lt.VideoUpscaler(2.0, device="cuda").stream_from_ring(
            ring, frames[0].shape, stop=done.is_set))
    finally:
        t.join(timeout=60)
        ring.close()
    got = take()
    check(not t.is_alive() and got["K1"] == 4 and len(outs) == 4 and
          all(np.array_equal(o, r) for o, r in zip(outs, frame_outs)),
          f"stream_from_ring: {len(outs)} frames, launches {got}")
    print("VideoUpscaler.stream_from_ring fed by a producer thread through the "
          "port's FrameRing (3 slots): 4 K1 launches, == upscale per frame")
    print(f"phase 11 in {time.perf_counter() - t_phase:.1f} s; paths not driven: "
          + ("; ".join(not_driven) or "none"))
    print(f"phase 11 launches by the driven entry points: "
          f"{ {k: v for k, v in driven.items() if v} }")
    return driven


# phase 12: training.  The JAX CLI's defaults (batch 16, patch 32, x2,
# lr 1e-4); the card against the CPU in true f32 (TF32 off), summed in
# other orders: the step-0 gradients per parameter within 1e-4 of its
# largest gradient, the per-step losses within 1e-3 relative over 50 steps
# (Adam moves an element whose gradient sign differs by 2 lr,
# tests/test_torch_train.py)
TRAIN_STEPS, TRAIN_LR = 50, 1e-4
TRAIN_GRAD_RTOL, TRAIN_LOSS_RTOL = 1e-4, 1e-3
# the first-step card gradient of the 9-1-5 and of each family against the
# same loss's gradient in float64 on the CPU along the card's own ReLU /
# PReLU branches (tests/grad_gate.py): shipped weights, the goldens'
# butterfly, batch 16 of 32^2 patches (LR patches for the LR heads), seed 0.
# Each leaf within min(1e-3, max(1e-4, 256 * 2**-24 * kappa)) of its largest
# entry, kappa being how far the leaf's sum cancels; a branch the card takes
# where f64 takes the other within 1e-4 of its activation's largest
# magnitude.  The same step in float64 on the card equals the CPU's within
# F64_CARD_RTOL
F64_GRAD_FAMILIES = ("srcnn", "vdsr", "srcnn955", "fsrcnn", "espcn")
F64_CARD_RTOL = 1e-9
# step timing shapes: the CLI's default batch, and the SRCNN paper's 33^2
# sub-images at batch 128
TRAIN_TIMED = ((16, 32), (128, 33))


def load_gate(name: str):
    """``tests/<name>.py``, loaded by path: ``grad_gate``, the gate that
    ``tests/test_torch_determinism.py`` holds the card's training gradients
    to, or ``bf16x1_gate``, the per-pixel gate that the ``cuda`` tests hold
    K3 to."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tests", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module              # dataclasses resolve the module by name
    spec.loader.exec_module(module)
    return module


def f64_gradient_gaps(img: np.ndarray) -> None:
    """Phase 12's gradient check: for the 9-1-5 and each family
    (:data:`F64_GRAD_FAMILIES`, shipped weights, full width), the
    first-step card gradient of every leaf held to :func:`grad_gate`'s
    gate, each leaf's gap, kappa and limit printed with the pinned flips.
    Fails if a leaf passes its limit, a pinned flip fails the guard, or the
    same step in float64 on the card is off the CPU's by more than
    :data:`F64_CARD_RTOL`."""
    from libsrcnn_tpu_torch import pipeline
    from libsrcnn_tpu_torch.models import fsrcnn, srcnn
    from libsrcnn_tpu_torch.train import make_patch_batch

    gate = load_gate("grad_gate")
    for model in F64_GRAD_FAMILIES:
        if model == "srcnn":
            params, forward = srcnn.load_params(), None
        else:
            mod = pipeline.FAMILY_MODULES[model]
            params, spec = mod.load_params(2)
            forward = mod.make_loss_forward(spec)
        if model in pipeline.LR_FAMILIES:
            batch = fsrcnn.make_lr_patch_batch([img], 16, 32, spec, seed=0, device="cpu")
        else:
            batch = make_patch_batch([img], 16, 32, 2.0, seed=0, device="cpu")
        grads, masks = gate.gradient(params, forward, batch, "cuda")
        ref = gate.reference(params, forward, batch, masks)
        card64 = gate.gaps(gate.gradient(params, forward, batch, "cuda", torch.float64)[0],
                           ref.plain)
        missed = gate.misses(grads, ref)
        print(f"training: {model} (shipped weights) first-step card gradient against the "
              f"f64 CPU gradient on the card's branches, batch 16 x {batch[0].shape[1]}^2 of "
              f"butterfly, max abs diff / max |g64| per leaf: {gate.describe(grads, ref)}; "
              f"against the plain f64 gradient: "
              f"{worst(gate.gaps(grads, ref.plain))}; the same step in f64 on the card: "
              f"{worst(card64)} off; " + ("every leaf within its limit" if not missed
                                          else f"MISSED {missed}"))
        check(max(card64.values()) <= F64_CARD_RTOL,
              f"{model}: the card's f64 gradient is off the CPU's: {card64}")
        check(not missed, f"{model}: the card gradient fails the f64 gate: {missed}")


def train_phase(card: str, z) -> dict:
    """Phase 12: training on the card.  Returns the launches of K1-K4 made
    by the entry points it drove (the trained weights' serving)."""
    import tempfile

    import libsrcnn_tpu_torch as lt
    from libsrcnn_tpu_torch.kernels import fused_conv
    from libsrcnn_tpu_torch.models import fsrcnn, srcnn
    from libsrcnn_tpu_torch.models.srcnn import exact_f32
    from libsrcnn_tpu_torch.train import (Trainer, load_checkpoint, loss_fn,
                                          make_patch_batch, save_checkpoint,
                                          train_step)

    t_phase = time.perf_counter()
    img = np.ascontiguousarray(z["in_butterfly_full"])
    batches = [make_patch_batch([img], 16, 32, 2.0, seed=s, device="cpu")
               for s in range(TRAIN_STEPS)]
    init = srcnn.init_params(torch.Generator().manual_seed(0))
    fused_conv.launches = 0
    for k in fused_conv.launches_by:
        fused_conv.launches_by[k] = 0

    # 1. the step-0 gradients, card against CPU
    def grads(dev):
        p = {k: v.to(dev).requires_grad_() for k, v in init.items()}
        with exact_f32(dev):
            loss_fn(p, *(torch.from_numpy(b).to(dev) for b in batches[0])).backward()
        return {k: v.grad.cpu() for k, v in p.items()}

    g_card, g_cpu = grads(torch.device("cuda")), grads(torch.device("cpu"))
    rel = {k: float((g_card[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max())
           for k in g_cpu}
    print(f"training: step-0 gradients card vs CPU, max abs diff / max |g| per "
          f"parameter: " + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()))
    check(all(v <= TRAIN_GRAD_RTOL for v in rel.values()),
          f"step-0 gradients card vs CPU: {rel}")
    f64_gradient_gaps(img)

    # 2. 50 Adam steps on the card and on the CPU from the same init; TF32
    # read inside the forward and the backward of every card step
    tf32 = []

    def watched(params, y, clamp=False):
        def seen(*_):
            tf32.append(torch.backends.cudnn.allow_tf32 or
                        torch.backends.cuda.matmul.allow_tf32)
        seen()
        pred = srcnn.forward_y(params, y, clamp=clamp)
        pred.register_hook(seen)
        return pred

    on_card = Trainer(params=init, learning_rate=TRAIN_LR, forward=watched, device="cuda")
    losses = on_card.fit(batches)
    torch.cuda.synchronize()
    # a second card run from the same init on the same batches: equal weights
    again = Trainer(params=init, learning_rate=TRAIN_LR, device="cuda")
    check(again.fit(batches) == losses and all(
        torch.equal(again.params[k], on_card.params[k]) for k in init),
        f"two card runs of {TRAIN_STEPS} steps from one seed ended on other weights")
    print(f"training: a second card run of {TRAIN_STEPS} steps from the same init: losses "
          f"and every weight equal bit for bit")
    losses_cpu = Trainer(params=init, learning_rate=TRAIN_LR, device="cpu").fit(batches)
    worst = max(abs(a - b) / b for a, b in zip(losses, losses_cpu))
    print(f"training: {TRAIN_STEPS} Adam steps (lr {TRAIN_LR}) from a seeded init on the "
          f"card and the CPU: loss {losses[0]:.3f} -> {losses[-1]:.3f} (CPU "
          f"{losses_cpu[0]:.3f} -> {losses_cpu[-1]:.3f}), per-step max rel diff "
          f"{worst:.3g}; TF32 read {len(tf32)} times in forwards and backwards, "
          f"allowed {sum(tf32)} times")
    check(len(tf32) == 2 * TRAIN_STEPS and not any(tf32),
          f"TF32 in a training step: {len(tf32)} reads, {sum(tf32)} allowed")
    check(worst <= TRAIN_LOSS_RTOL, f"training losses card vs CPU: {worst}")
    check(losses[-1] < losses[0] and losses_cpu[-1] < losses_cpu[0],
          f"training loss did not fall: {losses[0]} -> {losses[-1]}")

    # 3. --from-pretrained and the fsrcnn x2 family
    tuned = Trainer(params=srcnn.load_params(), learning_rate=TRAIN_LR, device="cuda")
    tuned_losses = tuned.fit(batches[:10])
    print(f"training --from-pretrained, 10 steps: loss {tuned_losses[0]:.3f} -> "
          f"{tuned_losses[-1]:.3f} (random init's first {losses[0]:.3f})")
    check(tuned_losses[0] < losses[0], "pretrained first loss not below random init's")
    spec = fsrcnn.FSRCNNSpec()
    lr_batches = [fsrcnn.make_lr_patch_batch([img], 16, 16, spec, seed=s, device="cuda")
                  for s in range(10)]
    fam = Trainer(params=fsrcnn.init_params(torch.Generator().manual_seed(1), spec),
                  learning_rate=TRAIN_LR, forward=fsrcnn.make_loss_forward(spec),
                  device="cuda")
    fam_losses = fam.fit(lr_batches)
    print(f"training fsrcnn x2 (d 56 s 12 m 4) through make_loss_forward and "
          f"make_lr_patch_batch, 10 steps: loss {fam_losses[0]:.3f} -> {fam_losses[-1]:.3f}")
    check(fam_losses[-1] < fam_losses[0], f"fsrcnn training loss did not fall: {fam_losses}")
    check(fused_conv.launches == 0, f"training launched a kernel: "
          f"{dict(fused_conv.launches_by)}")

    # 4. checkpoints of both 9-1-5 runs, reloaded and served through K1 (the
    # random init's outputs are mostly clamped; the fine-tuned ones are not)
    frame_in = frame(500, 1024, 1024)
    served = {k: 0 for k in fused_conv.launches_by}
    with tempfile.TemporaryDirectory() as tmp:
        for what, trainer in (("random init", on_card), ("fine-tuned", tuned)):
            path = os.path.join(tmp, "ckpt.npz")
            save_checkpoint(path, trainer.params, trainer.step)
            params, step = load_checkpoint(path, device="cuda")
            check(step == trainer.step and all(
                torch.equal(params[k], trainer.params[k].detach()) for k in params),
                f"{what} checkpoint did not reload")
            fused_conv.launches = 0
            for k in fused_conv.launches_by:
                fused_conv.launches_by[k] = 0
            out = lt.upscale(frame_in, 2.0, params=params, device="cuda")
            got = dict(fused_conv.launches_by)
            check(got["K1"] == 1 and sum(got.values()) == 1,
                  f"serving the {what} weights: launches {got}")
            for k, v in got.items():
                served[k] += v
            plain = lt.upscale(frame_in, 2.0, lt.SRCNNConfig(use_kernel=False),
                               params=params, device="cuda")
            d = lsb(out, plain)
            print(f"training: {what} checkpoint (step {step}) reloaded and served on "
                  f"1024^2 -> 2048^2: 1 K1 launch, {d} LSB off the plain path on "
                  f"{100 * float((out != plain).mean()):.4f}% of the values")
            check(out.shape == (2048, 2048, 3) and d <= 1,
                  f"served {what} weights: {d} LSB off the plain path")

    # 5. median ms per step
    for n, p in TRAIN_TIMED:
        lr_y, hr_y = (torch.from_numpy(b).to("cuda") for b in
                      make_patch_batch([img], n, p, 2.0, seed=0, device="cpu"))
        t = Trainer(params=init, learning_rate=TRAIN_LR, device="cuda")
        ms = float(np.median(cuda_ms(lambda: train_step(t.params, t.optimizer,
                                                          (lr_y, hr_y)), runs=10, warmup=3)))
        print(f"training step (9-1-5, Adam, f32 with TF32 off) at batch {n} x {p}^2 on "
              f"{card}: {ms:.3f} ms median of 10")
    print(f"phase 12 in {time.perf_counter() - t_phase:.1f} s")
    return served


# phase 13: the C ABI.  (frame, filter) cases of the C client against the
# in-process shim, on the card
CAPI_CASES = (((1024, 1024, 3), "BICUBIC"), ((256, 256, 4), "LANCZOS3"))


def capi_phase(card: str) -> dict:
    """Phase 13: the C ABI on the card.  Returns the launches of K1-K4 made
    in this process by the shim and by the C entry points called through
    ``ctypes.PyDLL``."""
    import ctypes
    import tempfile

    import libsrcnn_tpu_torch as lt
    from libsrcnn_tpu_torch import api, capi
    from libsrcnn_tpu_torch.kernels import _build, fused_conv

    t_phase = time.perf_counter()
    t = time.perf_counter()
    lib = capi.build()
    print(f"C ABI: built {os.path.basename(lib)} from libsrcnn_tpu_torch/capi/capi.cpp "
          f"in {time.perf_counter() - t:.1f} s ({' '.join(capi.CXX_FLAGS)} "
          f"{' '.join(sum(capi.python_flags(), []))})")
    os.environ["LIBSRCNN_TORCH_DEVICE"] = "cuda"
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    libs_before = {f: os.stat(os.path.join(_build.BUILD_DIR, f)).st_mtime_ns
                   for f in os.listdir(_build.BUILD_DIR) if f.endswith(".so")}
    dll = ctypes.PyDLL(lib)
    dll.ProcessSRCNN.restype = ctypes.c_int
    dll.ProcessSRCNN.argtypes = [
        ctypes.c_char_p, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)), ctypes.POINTER(ctypes.c_uint),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)), ctypes.POINTER(ctypes.c_uint)]
    dll.SRCNN_FreeBuffer.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
    dll.SRCNN_Version.restype = ctypes.c_uint
    check(dll.SRCNN_Version() == 0x00010A28, "SRCNN_Version")

    def c_call(img, multiply=2.0):
        """ProcessSRCNN on ``img`` -> (rc, out, conv, the call's wall
        seconds: the copies out of its buffers and their release after)."""
        h, w, d = img.shape
        buf = img.tobytes()
        out, conv = ctypes.POINTER(ctypes.c_ubyte)(), ctypes.POINTER(ctypes.c_ubyte)()
        osz, csz = ctypes.c_uint(0), ctypes.c_uint(0)
        t = time.perf_counter()
        rc = dll.ProcessSRCNN(buf, w, h, d, multiply, ctypes.byref(out),
                              ctypes.byref(osz), ctypes.byref(conv), ctypes.byref(csz))
        secs = time.perf_counter() - t
        if rc != 0:
            return rc, None, None, secs
        res = (np.ctypeslib.as_array(out, (osz.value,)).copy(),
               np.ctypeslib.as_array(conv, (csz.value,)).copy())
        dll.SRCNN_FreeBuffer(out)
        dll.SRCNN_FreeBuffer(conv)
        return rc, *res, secs

    def take() -> dict:
        got = dict(fused_conv.launches_by)
        fused_conv.launches = 0
        for k in fused_conv.launches_by:
            fused_conv.launches_by[k] = 0
        return got

    driven = {k: 0 for k in fused_conv.launches_by}
    with tempfile.TemporaryDirectory() as tmp:
        exe = os.path.join(tmp, "capi_driver")
        subprocess.run(["gcc", "-O2", "-pthread", "-o", exe,
                        os.path.join(ROOT, "tests", "capi_driver.c"), lib,
                        "-Wl,-rpath," + os.path.dirname(lib)],
                       capture_output=True, text=True, timeout=120, check=True)
        for i, ((h, w, d), filt) in enumerate(CAPI_CASES):
            img = frame(600 + i, h, w)
            if d == 4:
                img = np.concatenate([img, frame(700 + i, h, w)[..., :1]], axis=-1)
            ftype = int(lt.FilterType[filt])
            # the in-process shim on the card: one K1 launch
            take()
            api.configure_filter_srcnn(ftype, False, device="cuda")
            rc, want, want_conv = api.process_srcnn(img.tobytes(), w, h, d, 2.0)
            got = take()
            check(rc == 0 and got["K1"] == 1 and sum(got.values()) == 1,
                  f"process_srcnn {w}x{h}x{d}: rc {rc}, launches {got}")
            # the C entry points in this process (ctypes.PyDLL): one K1 launch,
            # the same bytes; the C call's wall time against the shim's
            dll.ConfigureFilterSRCNN(ftype, 0)
            rc, out, conv, _ = c_call(img)
            got_c = take()
            check(rc == 0 and got_c["K1"] == 1 and sum(got_c.values()) == 1 and
                  np.array_equal(out, want) and np.array_equal(conv, want_conv),
                  f"ProcessSRCNN (PyDLL) {w}x{h}x{d}: rc {rc}, launches {got_c}")
            for k in driven:
                driven[k] += got[k] + got_c[k]
            # the wall time of the C call and of the shim's call, in turns;
            # both end with the bytes on the host
            buf = img.tobytes()
            c_s, py_s = [], []
            for _ in range(3):
                c_s.append(c_call(img)[3])
                t = time.perf_counter()
                api.process_srcnn(buf, w, h, d, 2.0)
                py_s.append(time.perf_counter() - t)
            for k, v in take().items():
                driven[k] += v
            # a C client in its own process (tests/capi_driver.c, unchanged):
            # -1 / -2 probes, the call, two worker threads repeating it
            raw, out_f, conv_f = (os.path.join(tmp, n) for n in ("in.raw", "o.raw", "c.raw"))
            img.tofile(raw)
            t = time.perf_counter()
            proc = subprocess.run([exe, raw, str(w), str(h), str(d), "2.0", str(ftype),
                                   out_f, conv_f], capture_output=True, text=True,
                                  timeout=300, env=env)
            sub_s = time.perf_counter() - t
            check(proc.returncode == 0, f"capi_driver {w}x{h}x{d}: rc {proc.returncode}\n"
                  f"{proc.stderr[-2000:]}")
            check(np.array_equal(np.fromfile(out_f, np.uint8), want) and
                  np.array_equal(np.fromfile(conv_f, np.uint8), want_conv),
                  f"capi_driver {w}x{h}x{d}: output or conv map differs from process_srcnn")
            plain = lt.upscale(img, 2.0, lt.SRCNNConfig(filter=lt.FilterType[filt],
                                                        use_kernel=False),
                               device="cuda").ravel()
            take()
            print(f"C ABI {w}x{h}x{d} {filt} x2 on {card}: the C client "
                  f"(capi_driver, own process, {proc.stdout.strip()}) and ProcessSRCNN "
                  f"through PyDLL == process_srcnn byte for byte, 1 K1 launch each in "
                  f"this process; the plain path differs on {int((plain != want).sum())} "
                  f"values; ProcessSRCNN {1e3 * float(np.median(c_s)):.3f} ms vs "
                  f"process_srcnn {1e3 * float(np.median(py_s)):.3f} ms (host clock, "
                  f"median of 3); the driver process {sub_s:.1f} s end to end")
    # error codes through the C entry points
    img = frame(650, 16, 24)
    for what, rc, want_rc in (("d = 2", c_call(np.ascontiguousarray(img[..., :2]))[0], -1),
                              ("multiply 0", c_call(img, multiply=0.0)[0], -2)):
        check(rc == want_rc, f"ProcessSRCNN {what}: rc {rc}, expected {want_rc}")
    check(sum(take().values()) == 0, "an error case launched a kernel")
    libs_after = {f: os.stat(os.path.join(_build.BUILD_DIR, f)).st_mtime_ns
                  for f in os.listdir(_build.BUILD_DIR) if f.endswith(".so")}
    check(libs_after == libs_before, "the C client's process rebuilt a library: "
          f"{set(libs_after.items()) ^ set(libs_before.items())}")
    print("C ABI: ProcessSRCNN d = 2 -> -1, multiply 0 -> -2; the driver processes "
          "loaded the kernels phase 2 built (kernels/_build unchanged)")
    api.configure_filter_srcnn(2, False, device="cuda")
    print(f"phase 13 in {time.perf_counter() - t_phase:.1f} s")
    return driven


# phase 14: the multi-device serving paths on meshes over one card.  Mesh
# shapes (row, col) of the spatial paths; data sizes of the batch path;
# (model, factor) cases of the zoo on the tiled path
MESH_RC = ((2, 2), (4, 2))
MESH_DATA = (2, 4)
TILED_ZOO = (("vdsr", 2.0), ("srcnn955", 2.0), ("fsrcnn", 2.0), ("fsrcnn", 3.0),
             ("espcn", 2.0))
# stage counts of the pipelined path per model
PIPE_STAGES = {"srcnn": (2, 3, 4), "srcnn955": (2,), "vdsr": (2, 4)}


def parallel_phase(card: str, frames: list) -> dict:
    """Phase 14: the multi-device serving paths (``libsrcnn_tpu_torch.parallel``)
    on meshes whose devices are all this card (``["cuda:0"] * n``): the
    halo exchange, the per-tile edge flags and one kernel launch per shard
    run as they would on n cards; only the copies between cards do not.
    Returns the launches of K1-K4 made by the mesh paths."""
    import libsrcnn_tpu_torch as lt
    from libsrcnn_tpu_torch.kernels import fused_conv
    from libsrcnn_tpu_torch.models import srcnn
    from libsrcnn_tpu_torch.parallel import halo, make_mesh, sharding, upscale_pipelined
    from libsrcnn_tpu_torch.parallel import upscale_tiled

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    driven = {k: 0 for k in fused_conv.launches_by}

    def take(count: bool = True) -> dict:
        """The launches since the last call (added to the phase's count
        when ``count``), and the counts set to 0."""
        got = {k: v for k, v in fused_conv.launches_by.items() if v}
        if count:
            for k, v in got.items():
                driven[k] += v
        fused_conv.launches = 0
        for k in fused_conv.launches_by:
            fused_conv.launches_by[k] = 0
        return got

    def mesh_rc(r: int, c: int):
        return make_mesh({"data": 1, "row": r, "col": c}, ["cuda:0"] * (r * c))

    def same(a, b) -> bool:
        return a.shape == b.shape and np.array_equal(a, b)

    tier_kernel = {"float32": "K1", "bfloat16": "K2", "bfloat16_fast": "K3", "int8": "K4"}
    mode_kernel = {"exact": "K1", "split": "K2", "bf16x1": "K3"}
    params = srcnn.load_params(dev)
    take(False)

    # 1. forward_y_tiled on a 2048^2 Y plane: equal to the whole plane's
    # kernel, one launch per tile
    y = torch.from_numpy(smooth_plane(np.random.default_rng(14), 2048, 2048)).to(dev)
    y_pad = torch.nn.functional.pad(y[None, None], (6, 6, 6, 6), mode="replicate")[0, 0]
    plane_ms = {}
    for mode, kernel in mode_kernel.items():
        whole = fused_conv.forward_y(params, y_pad.contiguous(), 2048, 2048, precision=mode)
        ref = whole.cpu()
        take(False)
        for r, c in MESH_RC:
            mesh = mesh_rc(r, c)
            out = halo.forward_y_tiled(params, y, mesh, precision=mode)
            got = take()
            check(got == {kernel: r * c}, f"forward_y_tiled {mode} over {r}x{c}: "
                  f"launches {got}, expected {r * c} of {kernel}")
            check(torch.equal(out, ref), f"forward_y_tiled {mode} over {r}x{c} differs "
                  f"from the whole plane's {kernel}: max "
                  f"{float((out - ref).abs().max())}")
            grid = halo.shard(y, mesh)
            plane_ms[(mode, r, c)] = timed({
                "tiled": lambda: halo.forward_y_tiles(params, grid, True, mode),
                "whole": lambda: fused_conv.forward_y(params, y_pad, 2048, 2048,
                                                      precision=mode)})
            take(False)
        print(f"mesh: forward_y_tiled {mode} on a 2048^2 plane over 2x2 and 4x2 == "
              f"the whole plane's {kernel} bit for bit; one {kernel} launch per tile")
    del y, y_pad

    # 2. upscale_tiled of a 1024^2 frame at x2 at the srcnn float tiers, and the
    # ensemble: equal to upscale on the card, R*C launches of the tier's kernel
    img = frames[0]
    frame_ms = {}
    for tier in ("float32", "bfloat16", "bfloat16_fast"):
        cfg = lt.SRCNNConfig(compute_dtype=tier)
        ref, refc = lt.upscale(img, 2.0, cfg, return_conv_map=True, device="cuda")
        take(False)
        kernel = tier_kernel[tier]
        for r, c in MESH_RC:
            mesh = mesh_rc(r, c)
            out, conv = upscale_tiled(img, None, 2.0, cfg, mesh)
            got = take()
            check(got == {kernel: r * c}, f"upscale_tiled {tier} over {r}x{c}: "
                  f"launches {got}, expected {r * c} of {kernel}")
            check(same(out, ref) and same(conv, refc),
                  f"upscale_tiled {tier} over {r}x{c} differs from upscale: "
                  f"{lsb(out, ref)} u8, conv {lsb(conv, refc)} u8")
            frame_ms[(tier, r, c)] = timed({
                "tiled": lambda: upscale_tiled(img, None, 2.0, cfg, mesh),
                "single": lambda: lt.upscale(img, 2.0, cfg, return_conv_map=True,
                                             device="cuda")}, runs=3)
            take(False)
        print(f"mesh: upscale_tiled {tier} 1024^2 x2 over 2x2 and 4x2 == upscale on "
              f"the card (output and conv map); one {kernel} launch per tile")
    ens = lt.SRCNNConfig(self_ensemble=True)
    ref, refc = lt.upscale(img, 2.0, ens, return_conv_map=True, device="cuda")
    take(False)
    out, conv = upscale_tiled(img, None, 2.0, ens, mesh_rc(2, 2))
    got = take()
    check(got == {"K1": 16}, f"tiled ensemble over 2x2: launches {got}, expected 16 K1")
    check(same(out, ref) and same(conv, refc),
          f"tiled ensemble differs from upscale's: {lsb(out, ref)} u8")
    print("mesh: upscale_tiled self_ensemble over 2x2 == upscale(self_ensemble=True) "
          "(16 K1 launches: 4 passes x 4 tiles)")

    # 3. the zoo on the tiled path: no srcnn kernel
    for model, scale in TILED_ZOO:
        for tier in ("float32", "bfloat16"):
            cfg = lt.SRCNNConfig(model=model, compute_dtype=tier)
            ref, refc = lt.upscale(img, scale, cfg, return_conv_map=True, device="cuda")
            take(False)
            out, conv = upscale_tiled(img, None, scale, cfg, mesh_rc(2, 2))
            got = take()
            check(not got, f"upscale_tiled {model} launched srcnn kernels: {got}")
            check(same(out, ref) and same(conv, refc),
                  f"upscale_tiled {model} x{scale} {tier} over 2x2 differs from "
                  f"upscale: {lsb(out, ref)} u8 on "
                  f"{int((out != ref).any(-1).sum()) if out.shape == ref.shape else -1} px")
        print(f"mesh: upscale_tiled {model} x{scale:g} 1024^2 over 2x2 at float32 and "
              f"bfloat16 == upscale on the card; no srcnn kernel")

    # 4. upscale_batch and upscale_frames(mesh=) on the 4-frame clip: one launch
    # of the tier's kernel per data shard
    clip = np.stack(frames)
    batch_ms = {}
    for tier, kernel in tier_kernel.items():
        cfg = lt.SRCNNConfig(compute_dtype=tier)
        ref = lt.upscale_frames(clip, 2.0, cfg, device="cuda")
        take(False)
        for dp in MESH_DATA:
            mesh = make_mesh({"data": dp, "row": 1, "col": 1}, ["cuda:0"] * dp)
            out, conv = sharding.upscale_batch(clip, None, 2.0, cfg, mesh)
            got = take()
            check(got == {kernel: dp}, f"upscale_batch {tier} over data {dp}: "
                  f"launches {got}, expected {dp} of {kernel}")
            check(same(out, ref) and conv.shape == (4, 2048, 2048),
                  f"upscale_batch {tier} over data {dp} differs from upscale_frames")
            served = lt.upscale_frames(clip, 2.0, cfg, mesh=mesh)
            got = take()
            check(got == {kernel: dp} and same(served, ref),
                  f"upscale_frames(mesh=) {tier} over data {dp}: launches {got}, "
                  f"{lsb(served, ref)} u8 from upscale_frames")
        batch_ms[tier] = timed({
            "batch": lambda: sharding.upscale_batch(clip, None, 2.0, cfg, mesh),
            "single": lambda: lt.upscale_frames(clip, 2.0, cfg, device="cuda")}, runs=3)
        take(False)
        print(f"mesh: upscale_batch and upscale_frames(mesh=) {tier} on the 4-frame "
              f"clip over data 2 and 4 == upscale_frames; one {kernel} launch per shard")

    # 5. upscale_spatial: the plain bodies, equal to upscale(use_kernel=False)
    plain = lt.SRCNNConfig(use_kernel=False)
    ref, refc = lt.upscale(img, 2.0, plain, return_conv_map=True, device="cuda")
    for r, c in MESH_RC:
        out, conv = sharding.upscale_spatial(img, None, 2.0, lt.SRCNNConfig(),
                                             mesh_rc(r, c))
        check(same(out, ref) and same(conv, refc),
              f"upscale_spatial over {r}x{c} differs from upscale(use_kernel=False): "
              f"{lsb(out, ref)} u8")
    check(not take(), "upscale_spatial launched a kernel")
    try:
        sharding.upscale_spatial(img, None, 2.0, lt.SRCNNConfig(use_kernel=True),
                                 mesh_rc(2, 2))
    except ValueError:
        pass
    else:
        check(False, "upscale_spatial took use_kernel=True")
    print("mesh: upscale_spatial float32 over 2x2 and 4x2 == upscale(use_kernel=False) "
          "on the card, no kernel launched; use_kernel=True raises")

    # 6. upscale_pipelined on the 4-frame clip: the plain f32 atoms
    k1 = [lt.upscale(f, 2.0, device="cuda") for f in frames]
    take(False)
    for model, counts in PIPE_STAGES.items():
        cfg = lt.SRCNNConfig(model=model, use_kernel=False)
        refs = [lt.upscale(f, 2.0, cfg, return_conv_map=True, device="cuda") for f in frames]
        for s in counts:
            mesh = make_mesh({"stage": s}, ["cuda:0"] * s)
            out, conv = upscale_pipelined(clip, None, 2.0, cfg, mesh)
            check(all(same(out[i], o) and same(conv[i], c) for i, (o, c) in enumerate(refs)),
                  f"upscale_pipelined {model} at {s} stages differs from "
                  f"upscale(use_kernel=False)")
            if model == "srcnn":
                check(max(lsb(o, r) for o, r in zip(out, k1)) <= 1,
                      f"upscale_pipelined srcnn at {s} stages: more than 1 u8 from K1's upscale")
        check(not take(), f"upscale_pipelined {model} launched a kernel")
        print(f"mesh: upscale_pipelined {model} at {'/'.join(map(str, counts))} stages "
              f"== upscale(use_kernel=False) per frame"
              f"{' and within 1 u8 of K1' if model == 'srcnn' else ''}; no kernel")

    # 7. times (CUDA-event medians around the calls; the tiled frame and the
    # batch include their host copies, as the single-device calls do)
    for (mode, r, c), t in plane_ms.items():
        print(f"timing on {card}, median of 10: forward_y_tiles {mode} 2048^2 plane over "
              f"{r}x{c} on one card {t['tiled']:.3f} ms ({r * c} {mode_kernel[mode]} "
              f"launches), whole plane {t['whole']:.3f} ms (1 launch)")
    for (tier, r, c), t in frame_ms.items():
        print(f"timing on {card}, median of 6: upscale_tiled {tier} 1024^2 -> 2048^2 over "
              f"{r}x{c} on one card {t['tiled']:.3f} ms, upscale {t['single']:.3f} ms")
    for tier, t in batch_ms.items():
        print(f"timing on {card}, median of 6: upscale_batch {tier} 4 x 1024^2 -> 2048^2 "
              f"over data 4 on one card {t['batch']:.3f} ms, upscale_frames "
              f"{t['single']:.3f} ms")
    print(f"phase 14 in {time.perf_counter() - t_phase:.1f} s; mesh launches "
          f"{ {k: v for k, v in driven.items() if v} }")
    return driven

# phase 15: the multi-process mesh and training on a mesh.  Two ranks share
# the card (each mesh entry cuda:0), joined by gloo (NCCL refuses two ranks
# on one GPU); the gates of the JAX package's two-process worker
# (tests/distributed_worker.py:100-113) and of its mesh trainer test
# (tests/test_train.py:65-75)
RANK_TIMEOUT = 300
RANK_LOSS_RTOL, RANK_W1_ATOL = 1e-4, 1e-6
MESH_TRAIN_STEPS, MESH_TRAIN_LR = 3, 1e-5
MESH_LOSS_RTOL, MESH_W1_ATOL = 1e-4, 1e-5
# the zoo's families on a mesh, shipped weights at full width: the one-card
# cases (family, mesh axes), the 2x2x2 mesh for each and vdsr over row 4 (8
# of its 32 rows per share, shorter than its halo of 16), 5 steps each at
# MESH_TRAIN_LR under the mesh trainer's gates; the two-rank cases (family
# -> global mesh axes, devices per rank): fsrcnn's rows and srcnn955's col
# across the ranks, one step under the ranks' gates on every weight.  Every
# mesh case also runs a second time from the same weights on the same
# batches and must end on weights equal bit for bit.  Adam's
# steps do not change when a gradient is scaled, so each case, and the
# 9-1-5's mesh trainer, also holds every parameter's gradient after its
# first step to the unsharded one's on the card: the largest difference
# over the largest entry.  A lost or scaled gradient is off by order 1;
# the library's own error is not: cuDNN's weight gradient of fsrcnn's 9x9
# sub-pixel deconv over the whole batch was 4.0e-4 of its largest entry
# off the CPU's, where the mesh's sharded one was 5e-6 off, so each report
# line also prints both against the CPU's gradient
MESH_GRAD_RTOL = 1e-3
FAMILY_MESH_CASES = [(m, {"data": 2, "row": 2, "col": 2})
                     for m in ("vdsr", "srcnn955", "fsrcnn", "espcn")]
FAMILY_MESH_CASES.append(("vdsr", {"data": 2, "row": 4, "col": 1}))
FAMILY_TRAIN_STEPS = 5
RANK_FAMILY_STEPS = {"fsrcnn": ((1, 4, 1), 2), "srcnn955": ((1, 1, 2), 1)}


def host_ms(fn, runs: int = 3) -> float:
    """Median host-clock ms of ``runs`` calls that end on the host (their
    copies and the gloo exchange included), after one warm-up call."""
    fn()
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return float(np.median(times))


def grad_gaps(t, want: dict) -> dict:
    """For each parameter, the largest difference between the gradient any
    of this process's replicas of the mesh trainer ``t`` took in its last
    step (its col slice of a cut parameter) and the same slice of
    ``want``, over the largest entry of ``want``."""
    from libsrcnn_tpu_torch.train import trainer as tr

    C = t.mesh.size("col")
    gaps = {}
    for (_, _, c), rep in zip(tr._local_positions(t.mesh), t.replicas):
        for k, g in want.items():
            scale = float(g.abs().max())
            if k in t._cuts:
                n = g.shape[t._cuts[k]] // C
                g = g.narrow(t._cuts[k], c * n, n)
            gap = float((rep[k].grad.cpu() - g.cpu()).abs().max()) / scale
            gaps[k] = max(gaps.get(k, 0.0), gap)
    return gaps


def rel_gaps(got: dict, want: dict) -> dict:
    """For each parameter, the largest difference of ``got`` from ``want``
    over the largest entry of ``want``."""
    return {k: float((got[k].cpu() - w.cpu()).abs().max() / w.abs().max())
            for k, w in want.items()}


def worst(gaps: dict) -> str:
    """The largest of ``gaps`` and its parameter, for a report line."""
    k = max(gaps, key=gaps.get)
    return f"{gaps[k]:.3g} ({k})"


def step_grads(t) -> dict:
    """The gradients an unsharded trainer took in its last step."""
    return {k: v.grad.clone() for k, v in t._params.items()}


def first_step_grads(params, forward, batch, device: str) -> dict:
    """The gradients of one unsharded step on ``batch`` on ``device``."""
    from libsrcnn_tpu_torch.train import trainer as tr

    t = tr.Trainer(params=params, learning_rate=MESH_TRAIN_LR, forward=forward,
                   device=device)
    t.fit([batch])
    return step_grads(t)


def rank_family_steps(rank: int, rng, ms: dict) -> dict:
    """Phase 15's family steps in a rank (:data:`RANK_FAMILY_STEPS`): one
    step of a zoo family (shipped weights, full width) on each global mesh
    against the single-process step on the card, fsrcnn x2 with its rows
    across the ranks, srcnn955 with col across them (whole weights: its
    keys are the 9-1-5's, and no tp cut applies): the loss and every
    weight within the 9-1-5's gates, every gradient within
    :data:`MESH_GRAD_RTOL`, and a second mesh step from the same weights
    equal to the first bit for bit.  Adds the step times to ``ms``;
    returns each family's loss, drift and gradient gap."""
    from libsrcnn_tpu_torch import pipeline
    from libsrcnn_tpu_torch.parallel import distributed
    from libsrcnn_tpu_torch.train import trainer as tr

    family = {}
    for model, (axes, per_rank) in RANK_FAMILY_STEPS.items():
        mod = pipeline.FAMILY_MODULES[model]
        params, spec = mod.load_params(2)
        fwd = mod.make_loss_forward(spec)
        hr = 24 * (spec.scale if model in pipeline.LR_FAMILIES else 1)
        fb = (rng.uniform(0, 255, (8, 24, 24)).astype(np.float32),
              rng.uniform(0, 255, (8, hr, hr)).astype(np.float32))
        fmesh = distributed.global_mesh(*axes, devices=["cuda:0"] * per_rank)
        single = tr.Trainer(params=params, learning_rate=1e-4, forward=fwd, device="cuda")
        loss_single = single.fit([fb])[0]
        runs = [tr.Trainer(params=params, learning_rate=1e-4, forward=fwd, mesh=fmesh,
                           device="cuda") for _ in range(2)]
        losses = [t.fit([fb])[0] for t in runs]
        ft = runs[0]
        gaps = grad_gaps(ft, step_grads(single))
        gap = max(gaps.values())
        fw = ft.params
        drifts = {k: float((fw[k] - single.params[k].detach()).abs().max()) for k in params}
        check(abs(losses[0] - loss_single) <= RANK_LOSS_RTOL * max(1.0, abs(loss_single))
              and max(drifts.values()) <= RANK_W1_ATOL and gap <= MESH_GRAD_RTOL,
              f"rank {rank} {model} step on {axes}: loss {losses[0]} vs {loss_single}, "
              f"weight drifts {drifts}, gradient gap {gap}")
        check(losses[1] == losses[0] and all(
            torch.equal(a[k], b[k]) for a, b in zip(runs[0].replicas, runs[1].replicas)
            for k in a), f"rank {rank} {model} on {axes}: two steps from the same weights "
              f"differ")
        every = [None, None]
        torch.distributed.all_gather_object(
            every, [{k: v.detach().cpu() for k, v in r.items()} for r in ft.replicas])
        reps = [r for part in every for r in part]
        check(all(r[k].shape == params[k].shape and torch.equal(r[k], reps[0][k])
                  for r in reps for k in params),
              f"rank {rank} {model} on {axes}: a replica was cut or differs")
        family[model] = {"axes": axes, "loss": losses[0], "loss_single": loss_single,
                         "drift": max(drifts.values()), "grad_gap": worst(gaps)}
        ms[f"family {model}"] = host_ms(lambda: ft.fit([fb]))
        ms[f"family {model} single"] = host_ms(lambda: single.fit([fb]))
    return family


def mesh_rank(rank: int, port: int, ck_dir: str) -> int:
    """One of phase 15's two ranks (``chip_smoke.py --mesh-rank RANK PORT
    DIR``): the multi-process serving paths, one dp / sp step and one step
    of two zoo families on global meshes whose entries on this rank are
    ``["cuda:0"] * 2`` (or one), each held against its single-process twin
    on the card.  Prints one ``MESH-RANK`` JSON line: the launches of K1-K4
    by the mesh paths, the family steps and the times."""
    import libsrcnn_tpu_torch as lt
    from libsrcnn_tpu_torch.kernels import fused_conv
    from libsrcnn_tpu_torch.models import srcnn
    from libsrcnn_tpu_torch.parallel import distributed, sharding, upscale_pipelined
    from libsrcnn_tpu_torch.parallel import upscale_tiled
    from libsrcnn_tpu_torch.train import trainer as tr

    distributed.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    check(distributed.process_count() == 2, "the process group")
    driven = {k: 0 for k in fused_conv.launches_by}
    ms = {}

    def take(count: bool = True) -> dict:
        got = {k: v for k, v in fused_conv.launches_by.items() if v}
        if count:
            for k, v in got.items():
                driven[k] += v
        fused_conv.launches = 0
        for k in fused_conv.launches_by:
            fused_conv.launches_by[k] = 0
        return got

    def same(shards, ref) -> bool:
        return all(np.array_equal(s.data, ref[s.index]) for s in shards)

    tier_kernel = {"float32": "K1", "bfloat16": "K2", "bfloat16_fast": "K3", "int8": "K4"}
    frames = [frame(100 + i, 1024, 1024) for i in range(4)]
    clip = np.stack(frames)
    take(False)

    # 1. upscale_tiled, rows across the ranks: one launch per local tile
    mesh = distributed.global_mesh(data=1, row=2, col=2, devices=["cuda:0"] * 2)
    check([c["row"] for c in mesh.local_coords()] == [rank, rank], "tiled mesh")
    for tier in ("float32", "bfloat16", "bfloat16_fast"):
        cfg = lt.SRCNNConfig(compute_dtype=tier)
        ref, refc = lt.upscale(frames[0], 2.0, cfg, return_conv_map=True, device="cuda")
        take(False)
        out, conv = upscale_tiled(frames[0], None, 2.0, cfg, mesh)
        got = take()
        check(got == {tier_kernel[tier]: 2}, f"rank {rank} tiled {tier}: launches {got}")
        check(len(out) == 2 and same(out, ref) and same(conv, refc),
              f"rank {rank} tiled {tier}: its tiles differ from upscale")
        ms[f"tiled {tier}"] = host_ms(lambda: upscale_tiled(frames[0], None, 2.0, cfg, mesh))
        ms[f"single {tier}"] = host_ms(lambda: lt.upscale(frames[0], 2.0, cfg,
                                                          return_conv_map=True, device="cuda"))
        take(False)

    # 2. upscale_batch / upscale_frames(mesh=), data across the ranks: one
    # launch per local data shard
    bmesh = distributed.global_mesh(data=2, row=2, col=1, devices=["cuda:0"] * 2)
    for tier, kernel in tier_kernel.items():
        cfg = lt.SRCNNConfig(compute_dtype=tier)
        ref = lt.upscale_frames(clip, 2.0, cfg, device="cuda")
        take(False)
        out, conv = sharding.upscale_batch(clip, None, 2.0, cfg, bmesh)
        got = take()
        check(got == {kernel: 1} and len(out) == 1 and same(out, ref) and
              out[0].index[0] == slice(2 * rank, 2 * rank + 2) and
              conv[0].data.shape == (2, 2048, 2048),
              f"rank {rank} upscale_batch {tier}: launches {got}, or its frames differ")
        served = lt.upscale_frames(clip, 2.0, cfg, mesh=bmesh)
        got = take()
        check(got == {kernel: 1} and same(served, ref),
              f"rank {rank} upscale_frames(mesh=) {tier}: launches {got}, or frames differ")
        ms[f"batch {tier}"] = host_ms(lambda: sharding.upscale_batch(clip, None, 2.0, cfg,
                                                                     bmesh))
        ms[f"frames {tier}"] = host_ms(lambda: lt.upscale_frames(clip, 2.0, cfg,
                                                                 device="cuda"))
        take(False)
    check(distributed.process_local_batch(4) == 2, "process_local_batch")

    # 3. upscale_pipelined, stage 0 here and stage 1 there (the stage axis is
    # row): the plain f32 atoms, the last stage's rank returns the frames
    plain = lt.SRCNNConfig(use_kernel=False)
    t = time.perf_counter()
    res = upscale_pipelined(clip, None, 2.0, plain, mesh, axis="row")
    ms["pipelined"] = 1e3 * (time.perf_counter() - t)
    check((res is None) == (rank == 0), f"rank {rank}: pipelined returned {type(res)}")
    if res is not None:
        for i, f in enumerate(frames):
            o, c = lt.upscale(f, 2.0, plain, return_conv_map=True, device="cuda")
            check(np.array_equal(res[0][i], o) and np.array_equal(res[1][i], c),
                  f"pipelined frame {i} differs from upscale(use_kernel=False)")
    check(not take(), "upscale_pipelined launched a kernel")

    # 4. one dp / sp step (data across the ranks, row within) against the
    # single-process step on the card; then the sharded checkpoint
    rng = np.random.default_rng(11)
    batch = (rng.uniform(0, 255, (8, 24, 24)).astype(np.float32),
             rng.uniform(0, 255, (8, 24, 24)).astype(np.float32))
    twin = tr.Trainer(params=srcnn.load_params(), learning_rate=1e-4, device="cuda")
    loss_local = twin.fit([batch])[0]
    tmesh = distributed.global_mesh(data=2, row=2, col=1, devices=["cuda:0"] * 2)
    runs = [tr.Trainer(params=srcnn.load_params(), learning_rate=1e-4, mesh=tmesh,
                       device="cuda") for _ in range(2)]
    loss, loss_again = (t.fit([batch])[0] for t in runs)
    trainer = runs[0]
    whole = trainer.params
    dw = max(float((whole[k] - twin.params[k].detach()).abs().max()) for k in whole)
    check(abs(loss - loss_local) <= RANK_LOSS_RTOL * max(1.0, abs(loss_local)) and
          dw <= RANK_W1_ATOL, f"rank {rank} dp / sp step: loss {loss} vs {loss_local}, "
          f"weight drift {dw}")
    check(loss_again == loss and all(torch.equal(a[k], b[k]) for a, b in
                                     zip(runs[0].replicas, runs[1].replicas) for k in a),
          f"rank {rank} dp / sp step: two steps from the same weights differ")
    tr.save_checkpoint_sharded(ck_dir, trainer.param_shards(), step=trainer.step)
    torch.distributed.barrier()
    back, step = tr.load_checkpoint_sharded(ck_dir, device="cuda")
    check(step == 1 and all(torch.equal(back[k], whole[k]) for k in whole),
          "sharded checkpoint round trip")

    family = rank_family_steps(rank, rng, ms)
    check(not take(), "training launched a kernel")
    check("jax" not in sys.modules and sys.modules.get("libsrcnn_tpu") is None,
          "a rank imported jax or the JAX package")
    torch.distributed.destroy_process_group()
    print("MESH-RANK " + json.dumps({
        "rank": rank, "launches": {k: v for k, v in driven.items() if v}, "ms": ms,
        "loss": loss, "loss_single": loss_local, "drift": dw, "family": family}),
        flush=True)
    return 0


def family_mesh_phase(card: str, img: np.ndarray) -> None:
    """Phase 15's zoo families on a mesh over one card
    (:data:`FAMILY_MESH_CASES`): shipped weights at full width on batches
    of ``img`` (16 x 32^2 interpolated pairs, or 16 x 16^2 LR patches),
    against the unsharded trainer on the card; TF32 read inside every
    position's forward and backward; each trained family served on ``img``
    x2 on the card against the CPU within the zoo's float32 gate; no
    kernel launched."""
    import libsrcnn_tpu_torch as lt
    from libsrcnn_tpu_torch import pipeline
    from libsrcnn_tpu_torch.kernels import fused_conv
    from libsrcnn_tpu_torch.models import fsrcnn
    from libsrcnn_tpu_torch.models.ring import HaloForward
    from libsrcnn_tpu_torch.parallel import make_mesh
    from libsrcnn_tpu_torch.train import make_patch_batch, trainer as tr

    fam_s = time.perf_counter()
    for model, axes in FAMILY_MESH_CASES:
        t_case = time.perf_counter()
        mod = pipeline.FAMILY_MODULES[model]
        params, spec = mod.load_params(2)
        fwd = mod.make_loss_forward(spec)
        if model in pipeline.LR_FAMILIES:
            fb = [fsrcnn.make_lr_patch_batch([img], 16, 16, spec, seed=s, device="cpu")
                  for s in range(FAMILY_TRAIN_STEPS)]
        else:
            fb = [make_patch_batch([img], 16, 32, 2.0, seed=s, device="cpu")
                  for s in range(FAMILY_TRAIN_STEPS)]
        plain_f = tr.Trainer(params=params, learning_rate=MESH_TRAIN_LR, forward=fwd,
                             device="cuda")
        losses_plain = plain_f.fit(fb[:1])
        first_grads = step_grads(plain_f)
        losses_plain += plain_f.fit(fb[1:])
        cpu_grads = first_step_grads(params, fwd, fb[0], "cpu")
        tf32 = []

        def watch(fn):
            def seen(*_):
                tf32.append(torch.backends.cudnn.allow_tf32 or
                            torch.backends.cuda.matmul.allow_tf32)

            def run(*args, **kwargs):
                seen()
                out = fn(*args, **kwargs)
                out.register_hook(seen)
                return out
            return run

        n = int(np.prod(list(axes.values())))
        ft = tr.Trainer(params=params, learning_rate=MESH_TRAIN_LR, device="cuda",
                        forward=HaloForward(watch(fwd.forward), fwd.halo_width,
                                            watch(fwd.forward_halo)),
                        mesh=make_mesh(axes, ["cuda:0"] * n))
        fused_conv.launches = 0
        losses = ft.fit(fb[:1])
        gaps = grad_gaps(ft, first_grads)
        cpu_gaps = (rel_gaps(first_grads, cpu_grads), grad_gaps(ft, cpu_grads))
        losses += ft.fit(fb[1:])
        again = tr.Trainer(params=params, learning_rate=MESH_TRAIN_LR, device="cuda",
                           forward=fwd, mesh=ft.mesh)
        repeat = again.fit(fb) == losses and all(
            torch.equal(a[k], b[k]) for a, b in zip(ft.replicas, again.replicas) for k in a)
        rel = max(abs(a - b) / b for a, b in zip(losses, losses_plain))
        first = next(iter(params))
        dw = float((ft.params[first] - plain_f.params[first].detach()).abs().max())
        whole = all(rep[k].shape == params[k].shape and torch.equal(rep[k], ft.replicas[0][k])
                    for rep in ft.replicas for k in params)
        shape = "x".join(str(v) for v in axes.values())
        print(f"mesh trainer: {model} (shipped weights) {FAMILY_TRAIN_STEPS} steps (lr "
              f"{MESH_TRAIN_LR}) of batch 16 x {fb[0][0].shape[1]}^2 on {shape} over one "
              f"card (halo {fwd.halo_width(params)} rows) against the unsharded trainer: "
              f"losses max rel diff {rel:.3g}, {first} max abs diff {dw:.3g}, the first "
              f"step's gradients {worst(gaps)} of their largest entry off (against the "
              f"CPU's: the unsharded card's {worst(cpu_gaps[0])}, the mesh's "
              f"{worst(cpu_gaps[1])}); replicas whole and equal: {whole}; a second run "
              f"equal bit for bit: {repeat}; TF32 read {len(tf32)} times, allowed "
              f"{sum(tf32)} times")
        check(rel <= MESH_LOSS_RTOL and dw <= MESH_W1_ATOL and
              max(gaps.values()) <= MESH_GRAD_RTOL,
              f"{model} mesh trainer on {shape} vs unsharded: losses {rel}, {first} {dw}, "
              f"gradients {worst(gaps)}")
        check(whole, f"{model} mesh trainer on {shape}: a replica was cut or differs")
        check(repeat, f"{model} mesh trainer on {shape}: a second run from the same "
              f"weights ended on other weights")
        check(len(tf32) == 2 * n * FAMILY_TRAIN_STEPS and not any(tf32),
              f"TF32 in a {model} mesh step: {len(tf32)} reads, {sum(tf32)} allowed")
        cfg = lt.SRCNNConfig(model=model)
        trained = ft.params
        served = lt.upscale(img, 2.0, cfg, params=dict(trained, __spec__=spec),
                            device="cuda")
        host = lt.upscale(img, 2.0, cfg, device="cpu",
                          params={**{k: v.cpu() for k, v in trained.items()},
                                  "__spec__": spec})
        gap = np.abs(served.astype(int) - host.astype(int))
        frac = float((gap > 0).mean())
        print(f"mesh trainer: {model} trained on {shape} served on butterfly 256^2 x2: "
              f"card {gap.max()} u8 off the CPU on {100 * frac:.3f}% of the pixels")
        check(gap.max() <= ZOO_CARD_LSB["float32"] and frac < 0.02,
              f"{model} mesh-trained weights: card {gap.max()} u8 off the CPU on "
              f"{100 * frac:.3f}% of the pixels")
        check(fused_conv.launches == 0, f"{model} training or serving launched a kernel")
        step_ms = {name: host_ms(lambda t=t: t.fit(fb[:1]))
                   for name, t in (("mesh", ft), ("unsharded", plain_f))}
        print(f"timing on {card}, host clock, median of 3: a {model} training step at "
              f"batch 16 x {fb[0][0].shape[1]}^2 on {shape} over one card "
              f"{step_ms['mesh']:.3f} ms, unsharded {step_ms['unsharded']:.3f} ms; the "
              f"case in {time.perf_counter() - t_case:.1f} s")
    print(f"mesh trainer: the zoo's families in {time.perf_counter() - fam_s:.1f} s")


def mesh_phase(card: str, z, frames: list) -> dict:
    """Phase 15: the multi-process mesh (two ranks on this card) and the
    mesh trainer in this process, for the 9-1-5 and the zoo's families.
    Returns the launches of K1-K4 by the ranks' mesh paths and by serving
    the mesh-trained 9-1-5."""
    import socket
    import tempfile

    import libsrcnn_tpu_torch as lt
    from libsrcnn_tpu_torch.kernels import _build, fused_conv
    from libsrcnn_tpu_torch.models import srcnn
    from libsrcnn_tpu_torch.parallel import make_mesh
    from libsrcnn_tpu_torch.train import make_patch_batch, trainer as tr

    t_phase = time.perf_counter()
    driven = {k: 0 for k in fused_conv.launches_by}
    if torch.cuda.device_count() < 2:
        print(f"mesh: NCCL between cards not driven: this host has "
              f"{torch.cuda.device_count()} card (the two ranks share it over gloo)")

    # 1. two ranks in their own processes; they load the libraries phase 2
    # built (checked: kernels/_build unchanged)
    libs = {f: os.stat(os.path.join(_build.BUILD_DIR, f)).st_mtime_ns
            for f in os.listdir(_build.BUILD_DIR) if f.endswith(".so")}
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    results = []
    with tempfile.TemporaryDirectory() as ck:
        t = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank",
                                   str(rank), str(port), ck], env=env, cwd=ROOT,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for rank in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        ranks_s = time.perf_counter() - t
    for rank, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln[len("MESH-RANK "):] for ln in out.splitlines()
                 if ln.startswith("MESH-RANK ")]
        check(p.returncode == 0 and len(lines) == 1,
              f"mesh rank {rank}: rc {p.returncode}\n{out[-4000:]}")
        results.append(json.loads(lines[0]))
    check({f: os.stat(os.path.join(_build.BUILD_DIR, f)).st_mtime_ns
           for f in os.listdir(_build.BUILD_DIR) if f.endswith(".so")} == libs,
          "a mesh rank rebuilt a kernel library")
    for r in results:
        for k, v in r["launches"].items():
            driven[k] += v
        ms = r["ms"]
        print(f"mesh rank {r['rank']} of 2 on {card} (gloo, ['cuda:0'] * 2 each): "
              f"launches {r['launches']}; dp / sp step loss {r['loss']:.4f} vs single "
              f"{r['loss_single']:.4f}, weight drift {r['drift']:.2e}, a second step from "
              f"the same weights equal bit for bit; sharded checkpoint reloaded")
        for tier in ("float32", "bfloat16", "bfloat16_fast"):
            print(f"timing on {card}, host clock, median of 3: rank {r['rank']} "
                  f"upscale_tiled {tier} 1024^2 -> 2048^2 over global (1, 2, 2), its 2 "
                  f"tiles {ms['tiled ' + tier]:.3f} ms, upscale (whole frame, 1 rank) "
                  f"{ms['single ' + tier]:.3f} ms")
        for tier in ("float32", "bfloat16", "bfloat16_fast", "int8"):
            print(f"timing on {card}, host clock, median of 3: rank {r['rank']} "
                  f"upscale_batch {tier} 4 x 1024^2 over global data 2, its 2 frames "
                  f"{ms['batch ' + tier]:.3f} ms, upscale_frames (4 frames, 1 rank) "
                  f"{ms['frames ' + tier]:.3f} ms")
        print(f"timing on {card}, host clock: rank {r['rank']} upscale_pipelined of the "
              f"4-frame clip over 2 stages on 2 ranks (one call) {ms['pipelined']:.1f} ms")
        for model, f in r["family"].items():
            print(f"mesh rank {r['rank']}: {model} step over global {tuple(f['axes'])} "
                  f"loss {f['loss']:.4f} vs single {f['loss_single']:.4f}, weight drift "
                  f"{f['drift']:.3g}, gradient gap {f['grad_gap']}, a second step equal "
                  f"bit for bit")
            print(f"timing on {card}, host clock, median of 3: rank {r['rank']} {model} "
                  f"step over global {tuple(f['axes'])} {ms['family ' + model]:.3f} ms, "
                  f"single-process {ms['family ' + model + ' single']:.3f} ms")
    print(f"mesh: 2 ranks on one card: upscale_tiled (rows across the ranks) at float32, "
          f"bfloat16, bfloat16_fast == upscale tile by tile, one K1 / K2 / K3 launch per "
          f"local tile; upscale_batch and upscale_frames(mesh=) (data across the ranks) "
          f"at all four tiers == upscale_frames, one K1-K4 launch per local shard; "
          f"upscale_pipelined across the ranks == upscale(use_kernel=False); the dp / sp "
          f"step within {RANK_LOSS_RTOL} / {RANK_W1_ATOL} of the single-process step, "
          f"and so fsrcnn's (rows across the ranks) and srcnn955's (col across them, "
          f"whole weights); both ranks in {ranks_s:.1f} s")

    # 2. the mesh trainer in this process, 2x2x2 over one card, against the
    # unsharded trainer; TF32 read inside every step's forward and backward
    img = np.ascontiguousarray(z["in_butterfly_full"])
    batches = [make_patch_batch([img], 16, 32, 2.0, seed=s, device="cpu")
               for s in range(MESH_TRAIN_STEPS)]
    plain_t = tr.Trainer(params=srcnn.load_params(), learning_rate=MESH_TRAIN_LR,
                         device="cuda")
    losses_plain = plain_t.fit(batches[:1])
    first_grads = step_grads(plain_t)
    losses_plain += plain_t.fit(batches[1:])
    cpu_grads = first_step_grads(srcnn.load_params(), None, batches[0], "cpu")
    tf32 = []
    forward = tr._forward_915_mesh

    def watched(*args):
        def seen(*_):
            tf32.append(torch.backends.cudnn.allow_tf32 or
                        torch.backends.cuda.matmul.allow_tf32)
        seen()
        pred = forward(*args)
        next(iter(pred.values())).register_hook(seen)
        return pred

    mesh = make_mesh({"data": 2, "row": 2, "col": 2}, ["cuda:0"] * 8)
    tr._forward_915_mesh = watched
    try:
        mt = tr.Trainer(params=srcnn.load_params(), learning_rate=MESH_TRAIN_LR,
                        mesh=mesh, device="cuda")
        losses = mt.fit(batches[:1])
        gaps = grad_gaps(mt, first_grads)
        cpu_gaps = (rel_gaps(first_grads, cpu_grads), grad_gaps(mt, cpu_grads))
        losses += mt.fit(batches[1:])
    finally:
        tr._forward_915_mesh = forward
    again = tr.Trainer(params=srcnn.load_params(), learning_rate=MESH_TRAIN_LR, mesh=mesh,
                       device="cuda")
    check(again.fit(batches) == losses and all(
        torch.equal(a[k], b[k]) for a, b in zip(mt.replicas, again.replicas) for k in a),
        "a second 2x2x2 mesh trainer from the same weights ended on other weights")
    rel = max(abs(a - b) / b for a, b in zip(losses, losses_plain))
    dw = float((mt.params["w1"] - plain_t.params["w1"].detach()).abs().max())
    reps = {}
    for (_, _, c), rep in zip(tr._local_positions(mesh), mt.replicas):
        for k, v in rep.items():
            key = (k, c if tr.TP_DIMS[k] is not None else 0)
            check(torch.equal(reps.setdefault(key, v), v), f"mesh trainer replica of {k} differs")
    print(f"mesh trainer: {MESH_TRAIN_STEPS} steps (lr {MESH_TRAIN_LR}) of batch 16 x 32^2 "
          f"on data 2 x row 2 x col 2 over one card against the unsharded trainer: losses "
          f"max rel diff {rel:.3g}, w1 max abs diff {dw:.3g}, the first step's "
          f"gradients {worst(gaps)} of their largest entry off (against the CPU's: the "
          f"unsharded card's {worst(cpu_gaps[0])}, the mesh's {worst(cpu_gaps[1])}); "
          f"replicas equal bit for bit, and to a second run's; TF32 read {len(tf32)} "
          f"times, allowed {sum(tf32)} times")
    check(rel <= MESH_LOSS_RTOL and dw <= MESH_W1_ATOL and
          max(gaps.values()) <= MESH_GRAD_RTOL,
          f"mesh trainer vs unsharded: losses {rel}, w1 {dw}, gradients {worst(gaps)}")
    check(len(tf32) == 2 * MESH_TRAIN_STEPS and not any(tf32),
          f"TF32 in a mesh training step: {len(tf32)} reads, {sum(tf32)} allowed")
    step_ms = {name: host_ms(lambda t=t: t.fit(batches[:1]))
               for name, t in (("mesh", mt), ("unsharded", plain_t))}
    print(f"timing on {card}, host clock, median of 3: a training step at batch 16 x "
          f"32^2 on the 2x2x2 mesh over one card {step_ms['mesh']:.3f} ms, unsharded "
          f"{step_ms['unsharded']:.3f} ms")

    # 3. the mesh-trained weights served through K1
    fused_conv.launches = 0
    for k in fused_conv.launches_by:
        fused_conv.launches_by[k] = 0
    out = lt.upscale(frames[0], 2.0, params=mt.params, device="cuda")
    got = {k: v for k, v in fused_conv.launches_by.items() if v}
    check(got == {"K1": 1}, f"serving the mesh-trained weights: launches {got}")
    driven["K1"] += 1
    plain_out = lt.upscale(frames[0], 2.0, lt.SRCNNConfig(use_kernel=False),
                           params=mt.params, device="cuda")
    d = lsb(out, plain_out)
    check(d <= 1, f"mesh-trained weights through K1: {d} u8 off the plain path")
    print(f"mesh trainer: its weights served on 1024^2 -> 2048^2 through 1 K1 launch, "
          f"{d} u8 off the plain path")

    family_mesh_phase(card, img)
    print(f"phase 15 in {time.perf_counter() - t_phase:.1f} s; launches "
          f"{ {k: v for k, v in driven.items() if v} }")
    return driven


# phase 16: the training recipes, the int8 calibration and the eval report
# (libsrcnn_tpu_torch.tools).  Each recipe at its published width (vdsr at
# its recipe's depth 12 / 32 channels, the LR heads at x2) on the goldens'
# inputs that hold an HR patch; the card against the CPU over 20 steps at
# phase 12's gate; the pack and the report rows at the CPU tests' gates
RECIPE_ARGS = ["--pool", "1024", "--batch", "64"]
RECIPE_STEPS, RECIPE_EVAL_EVERY, RECIPE_CHECK_STEPS = 200, 100, 20
RECIPE_LOSS_RTOL = 1e-3
# the card-vs-CPU comparison runs at phase 12's rate.  At vdsr's own 1e-3
# its trajectory is unstable: a start 2 ulp away, or another f32 sum order,
# parts its losses by 1e-3 to 1e-2 within a dozen steps (measured once, card
# against card, PERF.md), so a trajectory gate there would test nothing past
# the first steps.  Two card runs at each recipe's own rate, vdsr's 1e-3
# included, must still end on equal weights: the card's steps are
# deterministic
RECIPE_CHECK_LR = "1e-4"
RECIPE_SERVE_LSB, RECIPE_SERVE_FRAC = 1, 0.02
CALIB_CODE_FRAC, CALIB_RTOL = 1e-3, 1e-5
CALIB_FLOATS = ("s1", "t1", "s2", "t2", "d3", "b3", "a1", "a2")


def recipe_corpus(z, hr_patch: int) -> list:
    """The goldens' inputs other than the butterfly's (the validation
    image) that hold an ``hr_patch`` crop, as RGB u8."""
    imgs = [z["in_castle96"], np.stack([z["in_gray64"]] * 3, -1),
            z["in_rgba48"][..., :3], z["in_noise33"]]
    return [np.ascontiguousarray(i) for i in imgs if min(i.shape[:2]) >= hr_patch]


def step_passes(scale: float) -> int:
    """The chained passes of a step-scale upscale by ``scale`` (the count
    ``api.upscale`` decomposes a factor into; a remainder of exactly 1
    would end the chain early, as no factor of the report has)."""
    multiply = np.float32(scale)
    return int(multiply / np.float32(2.0)) + int(np.fmod(multiply, np.float32(2.0)) > 0.0)


def recipes_phase(card: str, z) -> dict:
    """Phase 16: the four recipes, the int8 calibration and the eval report
    on the card.  Returns the launches of K1-K4 its entry points made."""
    import tempfile
    from fractions import Fraction

    import libsrcnn_tpu_torch as lt
    from libsrcnn_tpu_torch.config import FilterType
    from libsrcnn_tpu_torch.eval import psnr
    from libsrcnn_tpu_torch.eval.runner import _resize_rgb
    from libsrcnn_tpu_torch.kernels import fused_conv
    from libsrcnn_tpu_torch.models import espcn, fsrcnn, srcnn_generic, srcnn_int8, vdsr
    from libsrcnn_tpu_torch.tools import (calibrate_int8, gen_eval_report, train_espcn,
                                          train_fsrcnn, train_srcnn955, train_vdsr)
    from libsrcnn_tpu_torch.train import trainer

    t_phase = time.perf_counter()
    driven = {k: 0 for k in fused_conv.launches_by}

    def reset():
        fused_conv.launches = 0
        for k in fused_conv.launches_by:
            fused_conv.launches_by[k] = 0

    def take():
        for k, v in fused_conv.launches_by.items():
            driven[k] += v
        got = dict(fused_conv.launches_by)
        reset()
        return got

    butterfly = np.ascontiguousarray(z["in_butterfly_full"])
    # recipe -> (tool, family, its parser, extra flags, LR head?)
    recipes = {
        "fsrcnn": (train_fsrcnn, fsrcnn, train_fsrcnn.lr_parser("", "fsrcnn"), [], True),
        "espcn": (train_espcn, espcn, train_fsrcnn.lr_parser("", "espcn"), [], True),
        "vdsr": (train_vdsr, vdsr, train_vdsr.parser(), ["--depth", "12", "--ch", "32"], False),
        "srcnn955": (train_srcnn955, srcnn_generic, train_srcnn955.parser(), [], False),
    }
    # TF32 read inside the forward and the backward of every step
    tf32 = []

    def seen(*_):
        tf32.append(torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)

    real_loss = trainer.loss_fn

    def watched_loss(params, lr_y, hr_y, forward=None):
        if lr_y.is_cuda:
            seen()
        loss = real_loss(params, lr_y, hr_y, forward)
        if lr_y.is_cuda:
            loss.register_hook(seen)
        return loss

    reset()
    trainer.loss_fn = watched_loss
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name, (tool, family, parser, extra, lr_head) in recipes.items():
                t0 = time.perf_counter()
                out = os.path.join(tmp, f"{name}.npz")

                def args(steps, eval_every, device, lr=()):
                    return parser.parse_args(
                        RECIPE_ARGS + extra + ["--steps", str(steps), "--eval-every",
                                               str(eval_every), "--out", out,
                                               "--device", device, *lr])

                a = args(RECIPE_STEPS, RECIPE_EVAL_EVERY, "cuda")
                if lr_head:
                    hr_patch = a.patch * a.scale
                    pool = train_fsrcnn.build_patch_pool(recipe_corpus(z, hr_patch), a.pool,
                                                         a.patch, a.scale, a.seed, a.base_frac,
                                                         "cuda")
                else:
                    hr_patch = a.patch
                    pool = train_vdsr.build_pair_pool(recipe_corpus(z, hr_patch), a.pool,
                                                      a.patch, a.seed, (), a.base_frac, "cuda")
                n_imgs = len(recipe_corpus(z, hr_patch))
                # the first 20 steps, card against CPU, on the same pool and init
                tf32.clear()
                n = RECIPE_CHECK_STEPS
                lr = ("--lr", RECIPE_CHECK_LR)
                short = tool.run(args(n, n, "cuda", lr), pool=pool)
                short_cpu = tool.run(args(n, n, "cpu", lr), pool=pool)
                gaps = [abs(x - y) / y for x, y in zip(short.losses, short_cpu.losses)]
                worst = max(gaps)
                check(worst <= RECIPE_LOSS_RTOL,
                      f"{name} recipe: card vs CPU losses over {n} steps: {worst}")
                # two card runs of 20 steps at the recipe's own rate: equal
                own = [tool.run(args(n, n, "cuda"), pool=pool) for _ in range(2)]
                check(own[0].losses == own[1].losses and own[0].best.keys() ==
                      own[1].best.keys() and all(
                          torch.equal(torch.from_numpy(v), torch.from_numpy(own[1].best[k]))
                          for k, v in own[0].best.items()),
                      f"{name} recipe: two card runs of {n} steps at lr {a.lr} ended on "
                      f"other weights")
                # the published run
                run = tool.run(a, pool=pool)
                torch.cuda.synchronize()
                ms = 1e3 * run.step_seconds / len(run.losses)
                check(len(tf32) == 2 * (3 * n + RECIPE_STEPS) and not any(tf32),
                      f"{name} recipe: TF32 in a step: {len(tf32)} reads, {sum(tf32)} allowed")
                check(run.losses[-1] < run.losses[0],
                      f"{name} recipe: loss {run.losses[0]} -> {run.losses[-1]}")
                # the best checkpoint: its meta, reloaded and served card vs CPU
                with np.load(out) as ck:
                    keys = set(ck.files)
                meta = {"meta_step", "meta_val_psnr"} | ({"meta_scale"} if lr_head else set())
                check(meta <= keys, f"{name} recipe: checkpoint keys {sorted(keys)}")
                served = {}
                for dev in ("cuda", "cpu"):
                    p, spec = family.load_params(path=out, device=dev)
                    served[dev] = lt.upscale(butterfly, 2.0, lt.SRCNNConfig(model=name),
                                             params={**p, "__spec__": spec}, device=dev)
                d = np.abs(served["cuda"].astype(int) - served["cpu"].astype(int))
                check(d.max() <= RECIPE_SERVE_LSB and (d > 0).mean() < RECIPE_SERVE_FRAC,
                      f"{name} recipe: served card vs CPU {d.max()} u8 on "
                      f"{(d > 0).mean():.4f}")
                got = take()
                check(not any(got.values()), f"{name} recipe launched a kernel: {got}")
                print(f"recipe {name} ({n_imgs} corpus images, pool {a.pool}, batch "
                      f"{a.batch}): {n} steps at lr {RECIPE_CHECK_LR} card vs CPU, loss max "
                      f"rel diff {worst:.3g}; two card runs of {n} steps at lr {a.lr} equal "
                      f"bit for bit; {a.steps} steps loss {run.losses[0]:.2f} -> {run.losses[-1]:.2f}, best "
                      f"validation {run.best_score:.3f} dB at step {run.best_step}, "
                      f"{ms:.3f} ms per step{'' if lr_head else ' (clipped)'} (mean of {a.steps}, "
                      f"host clock, each step ends reading its loss)")
                print(f"recipe {name}: checkpoint {sorted(k for k in keys if k.startswith('meta_'))}"
                      f" served x2 card vs CPU {d.max()} u8 on {100 * (d > 0).mean():.4f}% of "
                      f"the values; {time.perf_counter() - t0:.1f} s on {card}")

            # the int8 calibration: on the card, its pack against the CPU's
            t0 = time.perf_counter()
            path = os.path.join(tmp, "int8.npz")
            calibrate_int8.main(["--out", path, "--device", "cuda"])
            with np.load(path) as f:
                pack = {k: f[k] for k in f.files}
            want = calibrate_int8.quantize(*calibrate_int8.calibrate(device="cpu"))
            check(np.array_equal(pack["w1q"], want["w1q"]), "int8 pack: w1q differs")
            codes = {}
            for k in ("w2q", "w3q"):
                dq = np.abs(pack[k].astype(int) - want[k].astype(int))
                codes[k] = (int(dq.max()), float((dq > 0).mean()))
                check(dq.max() <= 1 and (dq > 0).mean() <= CALIB_CODE_FRAC,
                      f"int8 pack {k}: {codes[k]}")
            rel = {k: float(np.max(np.abs(pack[k].astype(np.float64) - want[k])
                                   / np.maximum(np.abs(want[k]), 1e-30)))
                   for k in CALIB_FLOATS}
            check(max(rel.values()) <= CALIB_RTOL, f"int8 pack card vs CPU: {rel}")
            take()
            qp = srcnn_int8.params_from_jax(pack)
            int8 = lt.SRCNNConfig(compute_dtype="int8")
            new = lt.upscale(butterfly, 2.0, int8, params=qp, device="cuda")
            got = take()
            check(got["K4"] == 1 and sum(got.values()) == 1,
                  f"the recalibrated pack at int8: launches {got}")
            plain = lt.upscale(butterfly, 2.0, lt.SRCNNConfig(compute_dtype="int8",
                                                                use_kernel=False),
                               params=qp, device="cuda")
            check(np.array_equal(new, plain), "the recalibrated pack: K4 differs from the "
                  "plain int8 path")
            exact = lt.upscale(butterfly, 2.0, device="cuda")
            shipped = lt.upscale(butterfly, 2.0, int8, device="cuda")
            take()
            print(f"int8 calibration on the card ({len(calibrate_int8._calib_set())} images): "
                  f"w1q equal to the CPU's, w2q / w3q (max, share) differing "
                  f"{codes}, scales max rel diff {max(rel.values()):.3g}; served butterfly x2 "
                  f"through 1 K4 launch, equal to the plain int8 path; PSNR against the exact "
                  f"tier {psnr(new, exact):.2f} dB (the shipped pack's "
                  f"{psnr(shipped, exact):.2f} dB); {time.perf_counter() - t0:.1f} s on {card}")

            # the eval report on two images; srcnn rows through K1
            t0 = time.perf_counter()
            images = [("butterfly.png", "held out", butterfly),
                      ("castle.jpg", "trained on*", np.ascontiguousarray(z["in_castle96"]))]
            rows = gen_eval_report.evaluate(images, "cuda")
            report = os.path.join(tmp, "EVAL.md")
            with open(report, "w") as f:
                f.write(gen_eval_report.render(rows))
            got = take()
            # one K1 launch per srcnn pass (a step-scale row chains its
            # passes, an ensemble row batches its 4 flips into one)
            want_k1 = 0
            for model, scales in gen_eval_report.models():
                if model == "srcnn" or model == "srcnn+ens":
                    want_k1 += len(scales)
                elif model == "srcnn+step":
                    want_k1 += sum(step_passes(s) for s in scales)
            want_k1 *= len(images)
            check(got["K1"] == want_k1 and sum(got.values()) == want_k1,
                  f"the eval report's K1 launches: {got}, want {want_k1}")
            n_srcnn = 0
            for model, s, name, _, r in rows:
                check(all(np.isfinite([r.psnr_interp, r.psnr_srcnn, r.ssim_interp,
                                       r.ssim_srcnn])), f"report row {model} x{s} {name}")
                if model != "srcnn":
                    continue
                # the row's PSNR against upscale on the protocol's LR input
                hr = dict((n, i) for n, _, i in images)[name]
                frac = Fraction(s).limit_denominator(8)
                p = frac.numerator
                hr = hr[:hr.shape[0] // p * p, :hr.shape[1] // p * p]
                h, w = hr.shape[:2]
                lr = _resize_rgb(torch.tensor(hr, device="cuda"), h * frac.denominator // p,
                                 w * frac.denominator // p, FilterType.BICUBIC,
                                 FilterType.BICUBIC)
                up = lt.upscale(lr, float(frac), device="cuda")[:h, :w]
                check(psnr(up, hr) == r.psnr_srcnn,
                      f"report row srcnn x{s} {name}: {r.psnr_srcnn} != {psnr(up, hr)}")
                n_srcnn += 1
            take()
            print(f"eval report on the card: {len(rows)} rows on butterfly 256^2 and castle "
                  f"96^2, {got['K1']} K1 launches (srcnn, srcnn+step, srcnn+ens rows), "
                  f"{n_srcnn} srcnn rows equal to upscale's PSNR; "
                  f"{time.perf_counter() - t0:.1f} s on {card}")
    finally:
        trainer.loss_fn = real_loss
    print(f"phase 16 in {time.perf_counter() - t_phase:.1f} s on {card}; launches "
          f"{ {k: v for k, v in driven.items() if v} }")
    return driven


def main() -> int:
    # --- 1. the card ------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    import libsrcnn_tpu_torch as lt
    from libsrcnn_tpu_torch import pipeline
    from libsrcnn_tpu_torch.eval import psnr, ssim
    from libsrcnn_tpu_torch.kernels import _build, ablation, fused_conv
    from libsrcnn_tpu_torch.tools import int8_ablation, kernel_ablation, trace_kernel
    from libsrcnn_tpu_torch.models import srcnn, srcnn_int8

    weights_dir = os.path.dirname(srcnn.weights_path("srcnn_915.npz"))
    print(f"weights: {weights_dir}")
    check(weights_dir == os.path.join(os.path.dirname(os.path.abspath(lt.__file__)),
                                      "models", "weights"),
          f"the shipped weights are read from {weights_dir}, outside the port")

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # --- 2. build ---------------------------------------------------------
    t = time.perf_counter()
    fused_conv.build_all()
    print(f"build: fused_srcnn.cu + fused_srcnn_bf16.cu + fused_srcnn_int8.cu, "
          f"each also with {' '.join(_build.PROFILING_FLAGS)}, in "
          f"{time.perf_counter() - t:.1f} s ({' '.join(_build.NVCC_FLAGS)})")
    for name, log in _build.build_logs.items():
        for fn, line in ptxas_lines(log):
            print(f"  {name}: {fn}: {line}")
            # no production kernel spills (the main libraries hold only those)
            spill = re.findall(r"(\d+) bytes spill", line)
            check(name not in MAIN_LIBS or not any(int(b) for b in spill),
                  f"{name}: {fn} spills: {line}")
    # no cut may have lost the work it names: the count of tensor-core and
    # FMA instructions grows with each stage a cut keeps
    counts = sass_counts(_build)
    for kernel, stages in ablation.STAGES.items():
        seq = [counts.get((kernel, st)) for st in stages]
        check(None not in seq, f"{kernel}: a cut instance is missing from the SASS")
        seq = [sum(c.values()) for c in seq]
        print(f"SASS HMMA/IMMA/HGMMA/IGMMA/FFMA of {kernel}'s cuts: "
              + ", ".join(f"{st} {c}" for st, c in zip(stages, seq)))
        check(all(a < b for a, b in zip(seq[:-2], seq[1:-1])) and seq[-1] >= seq[-2],
              f"{kernel}: a cut's SASS count does not grow with its stages: {seq}")
    # the production K1, K2, K3, K3h, K3n and K4, and K5 in the profiling
    # build, are wgmma kernels with no mma.sync left; K1 runs no product on
    # the FMA units
    prod = sass_counts(_build, MAIN_LIBS)
    prod[("K5", "full")] = counts.get(("K5", "full"))
    for kernel in ("K1", "K2", "K3", "K3h", "K3n", "K4", "K5"):
        c = prod.get((kernel, "full"))
        print(f"SASS of the production {kernel}: {c}")
        check(c is not None, f"the production {kernel} is missing from the SASS")
        check(c["HGMMA"] + c["IGMMA"] > 0 and c["HMMA"] == c["IMMA"] == 0,
              f"the production {kernel} is not a wgmma kernel: {c}")
    check(prod[("K1", "full")]["FFMA"] == 0, "the production K1 holds FFMA")

    # --- 3. kernels vs plain versions on the card --------------------------
    t_phase = time.perf_counter()
    gate = load_gate("bf16x1_gate")
    k3_worst = {"ratio": 0.0, "over": 0}     # K3 and its cuts, over every case
    params = srcnn.load_params(dev)
    qparams = srcnn_int8.load_params(dev)
    rng = np.random.default_rng(0)
    max_err = {k: 0.0 for k in list(KERNELS) + list(PROFILING_KERNELS)}
    cases = [((3, 3), None), ((33, 47), None), ((37, 53), None),
             ((130, 250), None), ((2048, 2048), None), ((130, 250), (0, 1, 0, 1)),
             ((130, 250), (0, 0, 0, 0))]
    planes = [torch.from_numpy(smooth_plane(rng, h + 12, w + 12)).to(dev)
              for (h, w), _ in cases]
    batch = torch.stack([torch.from_numpy(smooth_plane(rng, 142, 262))
                         for _ in range(3)]).to(dev)

    def k3_verdict(what, v):
        print(f"{what}: {v}")
        k3_worst["ratio"] = max(k3_worst["ratio"], v.ratio)
        k3_worst["over"] += v.n_over
        check(v.ok, f"{what}: {v}")

    for ((h, w), flags), y in list(zip(cases, planes)) + [(((130, 250), None), batch)]:
        bounds = gate.flip_bound(params, y, h, w, flags)
        got = {}
        for name, (mode, _, _) in KERNELS.items():
            if name == "K4":
                got[name] = fused_conv.forward_y_int8(qparams, y, h, w, flags)
                torch.cuda.synchronize()
                ref = fused_conv.forward_y_int8_reference(qparams, y, h, w, flags)
                err = float((got[name] - ref).abs().max())
                print(f"K4 vs plain {'3 planes ' if y.dim() == 3 else ''}{h}x{w} "
                      f"flags={flags or (1, 1, 1, 1)}: max abs err {err:.3g}, "
                      f"bit-equal {torch.equal(got[name], ref)}")
                check(torch.equal(got[name], ref), f"K4 differs from its plain "
                      f"version at {h}x{w} flags={flags}")
                max_err[name] = max(max_err[name], err)
                continue
            got[name] = fused_conv.forward_y(params, y, h, w, flags, **mode)
            torch.cuda.synchronize()
            if name == "K3n":
                check(torch.equal(got["K3n"], got["K3"]),
                      f"K3n differs from K3 at {h}x{w}")
                continue
            ref = fused_conv.forward_y_reference(
                params, y, h, w, flags,
                **{k: v for k, v in mode.items() if k != "geom"})
            err = float((got[name] - ref).abs().max())
            what = (f"{name} vs plain {'3 planes ' if y.dim() == 3 else ''}"
                    f"{h}x{w} flags={flags or (1, 1, 1, 1)}")
            if name == "K3":
                k3_verdict(what, gate.judge(got[name], ref, bounds))
            else:
                print(f"{what}: max abs err {err:.3g}")
            check(err <= KERNEL_TOL[name], f"{name} disagrees at {h}x{w}: {err}")
            max_err[name] = max(max_err[name], err)
        what = f"{'3 planes ' if y.dim() == 3 else ''}{h}x{w} flags={flags or (1, 1, 1, 1)}"
        # K5 computes K3's pixels in row bands: equal bit for bit
        for th in (64, fused_conv.BAND_TILE_H):
            band = fused_conv.forward_y_band(params, y, h, w, flags, tile_h=th)
            torch.cuda.synchronize()
            check(torch.equal(band, got["K3"]), f"K5 (tile_h={th}) differs from K3 at {what}")
        # every stage cut against its plain version; full is the kernel
        scaled_max = {}
        for kernel, stages in ablation.STAGES.items():
            p = qparams if kernel == "K4" else params
            rec = "K7" if kernel == "K4" else "K6"
            for stage in stages:
                cut = ablation.forward_y_cut(kernel, stage, p, y, h, w, flags)
                torch.cuda.synchronize()
                if stage == "full":
                    check(torch.equal(cut, got[kernel]),
                          f"{kernel}'s full cut differs from the kernel at {what}")
                    continue
                ref = ablation.forward_y_cut_reference(kernel, stage, p, y, h, w, flags)
                d = (cut - ref).abs()
                max_err[rec] = max(max_err[rec], float(d.max()))
                if kernel == "K4":
                    check(torch.equal(cut, ref), f"K4's {stage} cut differs from its "
                          f"plain version at {what}")
                    continue
                # the kernel's gate on [0, 255] planes, on the scaled error
                scale = 255.0 / max(255.0, float(ref.abs().max()))
                sm = float(d.max()) * scale
                scaled_max[kernel] = max(scaled_max.get(kernel, 0.0), sm)
                if kernel == "K3":
                    k3_verdict(f"K3's {stage} cut at {what}",
                               gate.judge(cut, ref, bounds, stage, scale))
                else:
                    check(sm <= KERNEL_TOL[kernel], f"{kernel}'s {stage} cut at {what}: "
                          f"scaled max {sm}")
        print(f"{what}: K5 == K3 at tile_h 64 and {fused_conv.BAND_TILE_H}; cuts vs "
              f"plain, scaled max error "
              + ", ".join(f"{k} {v:.3g}" for k, v in scaled_max.items())
              + "; K4's cuts bit-equal; every full cut == its kernel")
        if y.dim() == 3:
            for name, (mode, _, _) in KERNELS.items():
                for i in range(y.shape[0]):
                    one = (fused_conv.forward_y_int8(qparams, y[i], h, w, flags)
                           if name == "K4" else
                           fused_conv.forward_y(params, y[i], h, w, flags, **mode))
                    check(torch.equal(got[name][i], one),
                          f"{name}: batched launch differs from plane {i}")
            print("batched launch of 3 planes == 3 single launches, every kernel")
    max_err["K3n"] = max_err["K3"]      # equal to K3 on every case above
    max_err["K5"] = max_err["K3"]       # likewise, and its plain version is K3's
    torch.cuda.synchronize()
    print(f"phase 3 in {time.perf_counter() - t_phase:.1f} s on {card}: K3 and its cuts "
          f"within their flip bounds at every pixel of every case, worst gap / bound "
          f"{k3_worst['ratio']:.4g}, {k3_worst['over']} pixels over")

    # --- 4. the main path, exact tier ---------------------------------------
    passes = 0
    run_pass = pipeline.run_pass

    def counted_run_pass(*args, **kwargs):
        nonlocal passes
        passes += 1
        return run_pass(*args, **kwargs)

    def reset_counts():
        nonlocal passes
        passes = 0
        fused_conv.launches = 0
        for k in fused_conv.launches_by:
            fused_conv.launches_by[k] = 0

    frames = [frame(100 + i, 1024, 1024) for i in range(4)]
    z = np.load(GOLDENS)
    launches = {}
    pipeline.run_pass = counted_run_pass
    try:
        reset_counts()
        t = time.perf_counter()
        frame_outs = [lt.upscale(f, 2.0, device="cuda") for f in frames]
        golden_outs = []
        for meta in z["meta"]:
            key, name, mult, filt, step, _ = str(meta).split(",")
            cfg = lt.SRCNNConfig(filter=lt.FilterType(int(filt)),
                                 step_scale=bool(int(step)))
            golden_outs.append((key, lt.upscale(
                z[f"in_{name}"], float(mult), cfg, return_conv_map=True,
                device="cuda")))
        lt.configure_filter_srcnn(lt.FilterType.BICUBIC, False, device="cuda")
        rc, shim_out, shim_conv = lt.process_srcnn(frames[0].tobytes(),
                                                   1024, 1024, 3, 2.0)
        torch.cuda.synchronize()
        served_s = time.perf_counter() - t
        launches["K1"] = fused_conv.launches_by["K1"]
        check(fused_conv.launches == passes == launches["K1"],
              f"{dict(fused_conv.launches_by)} launches for {passes} passes")
    finally:
        pipeline.run_pass = run_pass
    print(f"exact tier: 4 frames + {len(golden_outs)} goldens + 1 "
          f"process_srcnn in {served_s:.2f} s: {passes} passes, "
          f"{launches['K1']} K1 launches")

    for i, (f, out) in enumerate(zip(frames, frame_outs)):
        check(out.shape == (2048, 2048, 3) and out.dtype == np.uint8,
              f"frame {i}: output {out.shape} {out.dtype}")
        plain = lt.upscale(f, 2.0, lt.SRCNNConfig(use_kernel=False), device="cuda")
        d = lsb(out, plain)
        print(f"frame {i}: 1024^2 -> 2048^2, kernel vs plain path on the card "
              f"max {d} LSB, {100 * float((out != plain).mean()):.4f}% differ")
        check(d <= 1, f"frame {i}: kernel path {d} LSB off the plain path")
    check(rc == 0 and np.array_equal(shim_out, frame_outs[0].ravel()),
          f"process_srcnn rc={rc} or its output differs from upscale's")
    check(shim_conv.size == 2048 * 2048, "process_srcnn conv map size")

    worst = (0, 0.0, 1.0)
    for key, (out, conv) in golden_outs:
        gout, gconv = z[f"out_{key}"], z[f"conv_{key}"]
        check(out.shape == gout.shape and conv.shape == gconv.shape,
              f"{key}: shape {out.shape} vs {gout.shape}")
        d = lsb(out, gout)
        frac = float((out != gout).mean())
        s = ssim(out, gout)
        check(d <= 1 and frac < 0.02 and s >= 0.999,
              f"{key}: {d} LSB, {frac:.4f} differ, SSIM {s}")
        check(psnr(out, gout) >= 60.0 and lsb(conv, gconv) <= 1,
              f"{key}: PSNR or conv map")
        worst = (max(worst[0], d), max(worst[1], frac), min(worst[2], s))
    print(f"goldens: {len(golden_outs)}/29 within {worst[0]} LSB of the "
          f"reference binary, worst {100 * worst[1]:.3f}% pixels differ, "
          f"min SSIM {worst[2]:.6f}")
    check(len(golden_outs) == 29, f"{len(golden_outs)} goldens")

    # --- 5. the throughput tiers on the main path ----------------------------
    quality = [(n, z[f"in_{k}"], s) for n, k in (("butterfly256", "butterfly_full"),
                                                   ("castle96", "castle96"),
                                                   ("noise33", "noise33"))
               for s in (2.0, 3.0)]
    exact_q = [lt.upscale(img, s, device="cuda") for _, img, s in quality]
    # (tier, kernel, module flag that routes the tier to it)
    runs = [("bfloat16", "K2", None), ("bfloat16", "K3h", "PACK_IM2COL_SPLIT_DEFAULT"),
            ("bfloat16_fast", "K3", None), ("bfloat16_fast", "K3n", "NARROW_DEFAULT")]
    tier_outs = {}
    for tier, kernel, flag in runs:
        cfg = lt.SRCNNConfig(compute_dtype=tier)
        pipeline.run_pass = counted_run_pass
        if flag:
            setattr(fused_conv, flag, True)
        try:
            reset_counts()
            outs = [lt.upscale(f, 2.0, cfg, device="cuda") for f in frames]
            outs += [lt.upscale(img, s, cfg, device="cuda") for _, img, s in quality]
            torch.cuda.synchronize()
            launches[kernel] = fused_conv.launches_by[kernel]
            check(fused_conv.launches == passes == launches[kernel],
                  f"{tier} via {kernel}: {dict(fused_conv.launches_by)} "
                  f"launches for {passes} passes")
        finally:
            pipeline.run_pass = run_pass
            if flag:
                setattr(fused_conv, flag, False)
        tier_outs[kernel] = outs
        worst_lsb, worst_ssim = 0, 1.0
        for out, ref in zip(outs, frame_outs + exact_q):
            check(out.shape == ref.shape, f"{kernel}: shape {out.shape}")
            worst_lsb = max(worst_lsb, lsb(out, ref))
            worst_ssim = min(worst_ssim, ssim(out, ref))
        print(f"{tier} via {kernel}: {passes} passes, {launches[kernel]} "
              f"launches; vs the exact tier max {worst_lsb} u8, min SSIM "
              f"{worst_ssim:.6f} (4 frames at x2, "
              f"{', '.join(f'{n} x{s:g}' for n, _, s in quality)})")
        check(worst_lsb <= TIER_LSB[tier] and worst_ssim >= TIER_SSIM,
              f"{kernel} outside the {tier} envelope: {worst_lsb} u8, SSIM {worst_ssim}")
    d = max(lsb(a, b) for a, b in zip(tier_outs["K3h"], tier_outs["K2"]))
    print(f"K3h vs K2 on the tier inputs: max {d} u8")
    check(d <= 1, f"K3h {d} u8 off K2")
    check(all(np.array_equal(a, b) for a, b in zip(tier_outs["K3n"], tier_outs["K3"])),
          "K3n's frames differ from K3's")
    plain_fast = lt.SRCNNConfig(compute_dtype="bfloat16_fast", use_kernel=False)
    d = max(lsb(out, lt.upscale(f, 2.0, plain_fast, device="cuda"))
            for f, out in zip(frames, tier_outs["K3"]))
    print(f"bfloat16_fast: K3 path vs plain bf16 path on the card max {d} LSB")
    check(d <= 1, f"K3 path {d} LSB off the plain bf16 path")

    # the int8 tier on the same inputs: K4 once per pass, within 1 u8 of the
    # plain int8 path, and the quantization's cost against the exact tier
    int8 = lt.SRCNNConfig(compute_dtype="int8")
    pipeline.run_pass = counted_run_pass
    try:
        reset_counts()
        outs = [lt.upscale(f, 2.0, int8, device="cuda") for f in frames]
        outs += [lt.upscale(img, s, int8, device="cuda") for _, img, s in quality]
        torch.cuda.synchronize()
        launches["K4"] = fused_conv.launches_by["K4"]
        check(fused_conv.launches == passes == launches["K4"],
              f"int8 via K4: {dict(fused_conv.launches_by)} launches for "
              f"{passes} passes")
    finally:
        pipeline.run_pass = run_pass
    tier_outs["K4"] = outs
    plain_int8 = lt.SRCNNConfig(compute_dtype="int8", use_kernel=False)
    names = [f"frame {i}" for i in range(4)] + [f"{n} x{s:g}" for n, _, s in quality]
    inputs = [(f, 2.0) for f in frames] + [(img, s) for _, img, s in quality]
    worst, n_diff, psnrs = 0, 0, {}
    for name, (img, s), out, ref in zip(names, inputs, outs, frame_outs + exact_q):
        check(out.shape == ref.shape and out.dtype == np.uint8, f"int8 {name}: shape")
        plain = lt.upscale(img, s, plain_int8, device="cuda")
        worst = max(worst, lsb(out, plain))
        n_diff += int((out != plain).sum())
        psnrs[name] = psnr(out, ref)
    print(f"int8 via K4: {passes} passes, {launches['K4']} launches; kernel path "
          f"vs plain int8 path on the card max {worst} u8, {n_diff} values differ "
          f"in all; PSNR vs the exact tier "
          + ", ".join(f"{k} {v:.2f} dB" for k, v in psnrs.items()))
    check(worst <= 1, f"int8 kernel path {worst} u8 off the plain int8 path")
    check(psnrs["butterfly256 x2"] >= INT8_PSNR,
          f"int8 butterfly256 x2 at {psnrs['butterfly256 x2']:.2f} dB")

    # --- 6. serving at every tier -------------------------------------------
    clip = np.stack(frames)
    per_frame = {"float32": frame_outs, "bfloat16": tier_outs["K2"][:4],
                 "bfloat16_fast": tier_outs["K3"][:4], "int8": tier_outs["K4"][:4]}
    for tier, singles in per_frame.items():
        cfg = lt.SRCNNConfig(compute_dtype=tier)
        reset_counts()
        out = lt.upscale_frames(clip, 2.0, cfg, device="cuda")
        check(fused_conv.launches == 1, f"{tier}: {fused_conv.launches} "
              f"launches for one clip")
        check(all(np.array_equal(o, s) for o, s in zip(out, singles)),
              f"{tier}: upscale_frames differs from upscale per frame")
        streamed = list(lt.VideoUpscaler(2.0, cfg, device="cuda").stream(frames))
        check(len(streamed) == 4 and all(np.array_equal(o, s) for o, s in
                                         zip(streamed, singles)),
              f"{tier}: VideoUpscaler.stream differs from upscale per frame")
        ens = dataclasses.replace(cfg, self_ensemble=True)
        e1 = lt.upscale(frames[0], 2.0, ens, device="cuda")
        e2 = lt.upscale_frames(clip[:1], 2.0, ens, device="cuda")[0]
        check(np.array_equal(e1, e2), f"{tier}: ensemble upscale != upscale_frames")
        print(f"serving {tier}: upscale_frames (1 launch for 4 frames) and "
              f"stream == upscale per frame; ensemble == upscale_frames, "
              f"{lsb(e1, singles[0])} u8 from the plain pass")

    # --- 7. the chunked path through K1-K3 -------------------------------------
    big = frame(200, 2048, 4096)            # 4096 wide, 2048 tall: 8192x4096 out
    chunk_kernels = {"float32": "K1", "bfloat16": "K2", "bfloat16_fast": "K3"}

    def run_peak(fn):
        """fn's result, its peak device memory above what was allocated
        before it (bytes), and its host seconds, ended by a synchronize."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, torch.cuda.max_memory_allocated() - base, time.perf_counter() - t0

    for tier, kernel in chunk_kernels.items():
        cfg = lt.SRCNNConfig(compute_dtype=tier)
        ref, refc = lt.upscale(frames[0], 2.0, cfg, return_conv_map=True, device="cuda")
        counts = []
        for band in (256, 13):
            reset_counts()
            out, conv = lt.upscale_chunked(frames[0], 2.0, cfg, band_rows=band,
                                           device="cuda")
            counts.append(fused_conv.launches_by[kernel])
            check(fused_conv.launches == counts[-1] > 0,
                  f"chunked {tier}: {dict(fused_conv.launches_by)} launches")
            check(np.array_equal(out, ref) and np.array_equal(conv, refc),
                  f"chunked {tier} with {band}-row bands differs from upscale")
        ens = dataclasses.replace(cfg, self_ensemble=True)
        e_ref, e_refc = lt.upscale(frames[0], 2.0, ens, return_conv_map=True,
                                   device="cuda")
        e_out, e_conv = lt.upscale_chunked(frames[0], 2.0, ens, band_rows=256,
                                           device="cuda")
        check(np.array_equal(e_out, e_ref) and np.array_equal(e_conv, e_refc),
              f"chunked {tier} ensemble differs from upscale's")
        (one, one_c), one_peak, one_s = run_peak(
            lambda: lt.upscale(big, 2.0, cfg, return_conv_map=True, device="cuda"))
        reset_counts()
        (chk, chk_c), chk_peak, _ = run_peak(
            lambda: lt.upscale_chunked(big, 2.0, cfg, band_rows=512, device="cuda"))
        n_big = fused_conv.launches_by[kernel]
        check(fused_conv.launches == n_big == 8,
              f"chunked {tier} 4096x2048: {dict(fused_conv.launches_by)} launches")
        check(np.array_equal(chk, one) and np.array_equal(chk_c, one_c),
              f"chunked {tier} 4096x2048 differs from the one-shot pass")
        _, _, chk_s = run_peak(
            lambda: lt.upscale_chunked(big, 2.0, cfg, band_rows=512, device="cuda"))
        mp = 8192 * 4096 / 1e6
        print(f"chunked {tier} via {kernel}: 1024^2 x2 in 256- and 13-row bands "
              f"({counts[0]} and {counts[1]} launches) and the band-wise ensemble "
              f"== upscale bit for bit; 4096x2048 -> 8192x4096 in 512-row bands "
              f"({n_big} launches) == the one-shot pass, peak device memory "
              f"{chk_peak / 2**20:.1f} MiB vs one-shot {one_peak / 2**20:.1f} MiB "
              f"({chk_peak / one_peak:.3f}x), chunked {chk_s * 1e3:.1f} ms = "
              f"{mp / chk_s:.1f} MP/s (one-shot {one_s * 1e3:.1f} ms = "
              f"{mp / one_s:.1f} MP/s, first call), host clock, fetches included")
        check(chk_peak <= 0.5 * one_peak,
              f"chunked {tier} peak {chk_peak} B > half the one-shot {one_peak} B")
    del big, one, one_c, chk, chk_c

    # --- 8. timing -----------------------------------------------------------
    # a kernel's time is its launch on weights packed once; the wrapper's
    # adds packing the 8,129 weights on every call
    y = torch.from_numpy(smooth_plane(rng, 2060, 2060)).to(dev)
    packed = fused_conv.pack_params(params).to(dev)
    packed_int8 = fused_conv.pack_int8_params(qparams)
    y_out = torch.empty(2048, 2048, device=dev)
    # the nearest library computations: cuDNN's bf16 convs for K3, K3n and
    # K5, its f32 ones for K1, K2, K3h (valid on the halo plane, no ring
    # clamp; the bf16 ones' outputs are bf16); the port never calls them
    pb = {k: v.to(torch.bfloat16) for k, v in params.items()}
    yb = y[None, None].to(torch.bfloat16)

    def cudnn_bf16():
        h1 = torch.relu(torch.nn.functional.conv2d(yb, pb["w1"], pb["b1"]))
        c2 = torch.relu(torch.nn.functional.conv2d(h1, pb["w2"], pb["b2"]))
        return torch.nn.functional.conv2d(c2, pb["w3"], pb["b3"]).clamp(0, 255)

    y4 = y[None, None]

    def cudnn_f32():
        with srcnn.exact_f32(dev):
            h1 = torch.relu(torch.nn.functional.conv2d(y4, params["w1"], params["b1"]))
            c2 = torch.relu(torch.nn.functional.conv2d(h1, params["w2"], params["b2"]))
            return torch.nn.functional.conv2d(c2, params["w3"], params["b3"]).clamp(0, 255)

    lib = timed({"bf16": cudnn_bf16, "f32": cudnn_f32})
    print(f"timing on {card}, median of 10: 2048^2 cuDNN conv stacks (valid "
          f"convs on the halo plane, no ring clamp): bf16 {lib['bf16']:.3f} ms "
          f"(library yardstick for K3, K3n, K5), f32 with TF32 off "
          f"{lib['f32']:.3f} ms (for K1, K2, K3h)")
    kern_ms, plain_ms = {}, {}
    for name, (mode, _, _) in KERNELS.items():
        if name == "K4":
            fns = {"plain": lambda: fused_conv.forward_y_int8_reference(qparams, y, 2048, 2048),
                   "kernel": lambda: fused_conv.launch("K4", packed_int8, y, y_out),
                   "wrapper": lambda: fused_conv.forward_y_int8(qparams, y, 2048, 2048)}
        else:
            pmode = {k: v for k, v in mode.items() if k != "geom"}
            fns = {"plain": lambda: fused_conv.forward_y_reference(params, y, 2048, 2048, **pmode),
                   "kernel": lambda: fused_conv.launch(name, packed, y, y_out),
                   "wrapper": lambda: fused_conv.forward_y(params, y, 2048, 2048, **mode)}
        t = timed(fns)
        kern_ms[name], plain_ms[name] = t["kernel"], t["plain"]
        bms, by = bound(name, 1, 2048, 2048)
        extra = (f"; f32 FMA bound {bound(name, 1, 2048, 2048, fma=True)[0]:.3f} ms"
                 if name == "K1" else
                 f"; {BEFORE_WGMMA_MS[name]:.3f} ms before its redesign on wgmma"
                 if name in BEFORE_WGMMA_MS else "")
        if name != "K4":
            extra += (f"; cuDNN {'bf16' if name in ('K3', 'K3n') else 'f32'} stack "
                      f"{lib['bf16' if name in ('K3', 'K3n') else 'f32']:.3f} ms")
        print(f"timing on {card}, median of 10: 2048^2 conv stack {name} "
              f"{t['kernel']:.3f} ms (through its wrapper {t['wrapper']:.3f} "
              f"ms), its plain version {t['plain']:.3f} ms; bound {bms:.3f} ms "
              f"({by}){extra}")
    # the nearest library computation to K4: cuBLAS int8 GEMMs on the three
    # layers' im2col'd operands (conv1 over the 2052^2 c2 ring region, K
    # padded to 96; conv2; conv3 as a K=800 GEMM, N padded to 8).  It leaves
    # out the im2col itself, the quantize and requant epilogues and the
    # ring clamp; the codes are random, which does not change its time.
    # The weights go in column-major: cuBLASLt's int8 GEMM takes only the
    # "TN" layout, which a row-major second operand does not give.
    lib_int8, lib_int8_why = None, ""
    try:
        m1, m3 = 2052 * 2052, 2048 * 2048
        w1m = torch.zeros(96, 64, dtype=torch.int8, device=dev)
        w1m[:81] = qparams["w1q"]
        w3m = torch.zeros(800, 8, dtype=torch.int8, device=dev)
        w3m[:, 0] = srcnn_int8.w3_taps(qparams["w3q"]).reshape(-1)
        gemms = [(torch.randint(0, 128, (m1, 96), dtype=torch.int8, device=dev), w1m),
                 (torch.randint(0, 128, (m1, 64), dtype=torch.int8, device=dev),
                  qparams["w2q"]),
                 (torch.randint(0, 128, (m3, 800), dtype=torch.int8, device=dev), w3m)]
        gemms = [(a, b.t().contiguous().t()) for a, b in gemms]

        def int_mm_stack():
            return [torch._int_mm(a, b) for a, b in gemms]

        int_mm_stack()
        torch.cuda.synchronize()
        lib_int8 = timed({"lib": int_mm_stack})["lib"]
        print(f"timing on {card}, median of 10: 2048^2 torch._int_mm on the three "
              f"im2col'd int8 layers (library yardstick for K4; no im2col, "
              f"epilogues or ring clamp) {lib_int8:.3f} ms")
        del gemms
    except RuntimeError as e:
        lib_int8_why = str(e).strip().splitlines()[0]
        print(f"timing on {card}: torch._int_mm yardstick for K4: — ({lib_int8_why})")
    library_ms = {"K1": lib["f32"], "K2": lib["f32"], "K3h": lib["f32"],
                  "K3": lib["bf16"], "K3n": lib["bf16"], "K4": lib_int8,
                  "K5": lib["bf16"], "K6": None, "K7": None}

    # K5 beside K3 (the same work in row bands), in turns on one card, at the
    # recommended band height, the JAX package's default 64, and 12 (the
    # height of the mma.sync figure it is compared with)
    th = fused_conv.BAND_TILE_H
    heights = sorted({12, th, 64})
    band_t = timed({"K3": lambda: fused_conv.launch("K3", packed, y, y_out)}
                   | {f"K5 {b}": (lambda b=b: fused_conv.launch("K5", packed, y, y_out,
                                                                 tile_h=b))
                      for b in heights}
                   | {"plain": lambda: fused_conv.forward_y_band_reference(
                       params, y, 2048, 2048, tile_h=th)})
    kern_ms["K5"], plain_ms["K5"] = band_t[f"K5 {th}"], band_t["plain"]
    print(f"timing on {card}, median of 10: 2048^2 K5 (row bands) at tile_h "
          + ", ".join(f"{b} {band_t[f'K5 {b}']:.3f}" for b in heights)
          + f" ms (recommended BAND_TILE_H {th}; mma.sync design at 12: "
          f"{BEFORE_WGMMA_MS['K5']:.3f}); K3 {band_t['K3']:.3f} ms; its plain version "
          f"(K3's) {band_t['plain']:.3f} ms; cuDNN bf16 stack {lib['bf16']:.3f} ms")
    # the plain versions of the cuts that stand for K6 and K7
    for rec, (kernel, stage) in RECORD_CUT.items():
        p = qparams if kernel == "K4" else params
        plain_ms[rec] = timed({"plain": lambda: ablation.forward_y_cut_reference(
            kernel, stage, p, y, 2048, 2048)})["plain"]
        print(f"timing on {card}, median of 10: 2048^2 plain version of {kernel}'s "
              f"{stage} cut ({rec}) {plain_ms[rec]:.3f} ms")

    img = torch.tensor(frames[1], device=dev)
    tiers = ("float32", "bfloat16", "bfloat16_fast", "int8")
    tier_params = {t_: qparams if t_ == "int8" else params for t_ in tiers}
    fns = {t_: (lambda c=lt.SRCNNConfig(compute_dtype=t_), p=tier_params[t_]:
                pipeline.run_pass(img, p, 2.0, c))
           for t_ in tiers}
    fns["float32 plain"] = lambda: pipeline.run_pass(
        img, params, 2.0, lt.SRCNNConfig(use_kernel=False))
    frame_ms = timed(fns)
    clip_ms = timed({t_: (lambda c=lt.SRCNNConfig(compute_dtype=t_):
                          lt.upscale_frames(clip, 2.0, c, device="cuda"))
                     for t_ in tiers}, runs=3)
    clip_dev = torch.tensor(clip, device=dev)
    parts = timed({"upload": lambda: torch.tensor(clip, device=dev),
                   "download": lambda: torch.empty(4, 2048, 2048, 3, dtype=torch.uint8,
                                                   device=dev).cpu().numpy()}
                  | {t_: (lambda c=lt.SRCNNConfig(compute_dtype=t_), p=tier_params[t_]:
                          pipeline.run_pass(clip_dev, p, 2.0, c))
                     for t_ in tiers}, runs=3)
    for t_ in tiers:
        print(f"timing on {card}: 1024^2 -> 2048^2 frame pass {t_} "
              f"{frame_ms[t_]:.3f} ms (median of 10); upscale_frames of 4 "
              f"frames {clip_ms[t_] / 4:.3f} ms per frame, host copies "
              f"included (median of 6), of which the batched pass "
              f"{parts[t_] / 4:.3f} ms")
    print(f"timing on {card}: per 1024^2 frame, upload of the u8 frame "
          f"{parts['upload'] / 4:.3f} ms, download of its 2048^2 u8 output "
          f"{parts['download'] / 4:.3f} ms (pageable host memory, median of 6)")
    print(f"timing on {card}: frame pass float32 plain path "
          f"{frame_ms['float32 plain']:.3f} ms (median of 10)")

    # --- 9. the kernel-profiling path: K5, K6, K7 ---------------------------
    # the port's own tools, as a user runs them, with the counts at 0
    reset_counts()
    tables = {kernel: kernel_ablation.main(["2048", "--mode", mode])
              for mode, kernel in kernel_ablation.MODES.items()}
    tables["K4"] = int8_ablation.main(["2048"])
    trace_dir = os.path.join(_build.BUILD_DIR, "traces")    # git-ignored
    for mode, th in (("bf16x1band", 64), ("bf16x1bandf", fused_conv.BAND_TILE_H)):
        trace_kernel.main(["--mode", mode, "--th", str(th), "--logdir",
                           os.path.join(trace_dir, f"{mode}_{th}")])
    torch.cuda.synchronize()
    for rec in PROFILING_KERNELS:
        launches[rec] = fused_conv.launches_by[rec]
        check(launches[rec] > 0, f"the profiling path launched {rec} no time: "
              f"{dict(fused_conv.launches_by)}")
    print(f"profiling path: {launches['K5']} K5, {launches['K6']} K6 and "
          f"{launches['K7']} K7 launches ({dict(fused_conv.launches_by)})")
    for kernel, rows in tables.items():
        print(f"{kernel} cuts' bounds at 2048^2: " + ", ".join(
            "{} {:.4f} ms ({})".format(r["stage"], *bound(
                kernel, 1, 2048, 2048, ablation.STAGE_MACS[r["stage"]]))
            for r in rows if r["stage"] != "production"))
    for rec, (kernel, stage) in RECORD_CUT.items():
        kern_ms[rec] = next(r["ms"] for r in tables[kernel] if r["stage"] == stage)

    # --- 10. the model zoo ---------------------------------------------------
    zoo_phase(card, z, frames)

    # --- 11. the CLI, I/O, eval and debug dumps --------------------------------
    for name, n in io_phase(card, z, frames, frame_outs).items():
        if name in KERNELS:
            launches[name] += n

    # --- 12. training, 13. the C ABI, 14. the mesh paths, 15. across processes,
    # 16. the recipes, the int8 calibration and the eval report ------------------
    for driven in (train_phase(card, z), capi_phase(card), parallel_phase(card, frames),
                   mesh_phase(card, z, frames), recipes_phase(card, z)):
        for name, n in driven.items():
            if name in KERNELS:
                launches[name] += n
    print(f"chip_smoke ran in {time.perf_counter() - t_start:.1f} s")

    check("jax" not in sys.modules and sys.modules.get("libsrcnn_tpu") is None,
          "the port imported jax or the JAX package")
    records = []
    sources = {k: (src, rep) for k, (_, src, rep) in KERNELS.items()} | PROFILING_KERNELS
    for name, (src, replaces) in sources.items():
        if name in RECORD_CUT:
            kernel, stage = RECORD_CUT[name]
            bms, by = bound(kernel, 1, 2048, 2048, ablation.STAGE_MACS[stage])
        else:
            bms, by = bound("K3" if name == "K5" else name, 1, 2048, 2048)
        record = {
            "name": name, "route": "cuda",
            "source": f"libsrcnn_tpu_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name], "ms": kern_ms[name],
            "plain_ms": plain_ms[name], "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms[name],
        }
        if name in RECORD_CUT:
            # the record's numbers are this cut's; every cut's time is here
            kernel, stage = RECORD_CUT[name]
            record["cut"] = f"{kernel} {stage}"
            record["stage_ms"] = {k: {r["stage"]: r["ms"] for r in rows}
                                  for k, rows in tables.items()
                                  if (k == "K4") == (name == "K7")}
        records.append(record)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
