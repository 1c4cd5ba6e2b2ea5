"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths on the card through its hand-written CUDA kernels
(SRCNN 9-1-5 at its full width, shipped weights), in phases:

1. require a CUDA device; print the card's name and power limit;
2. build the six kernel libraries from ``libsrcnn_tpu_torch/kernels/csrc``
   (one nvcc each, started together, sm_90a): the main path's three and
   their profiling builds (``-DSRCNN_PROFILING``: K5 and the stage cuts K6
   / K7); print each kernel's registers and spills; dump each cut
   instance's SASS (``cuobjdump``) and check that its count of HMMA / IMMA
   / FFMA instructions grows with each stage the cut keeps, so that no cut
   has been optimised away (the full kernel adds only adds, so its count
   equals or passes the last cut's);
3. hold every kernel against its plain PyTorch version on the card at the
   listed plane shapes and edge flags, and a batch of 3 planes in one
   launch: K1 (exact) max abs error <= 2e-3; K2 (split) and K3h (split,
   hi/lo-packed conv1) <= 5e-3; K3 (bf16x1) 99.9th percentile <= 0.05 and
   max <= 2.0 (a rare flipped bf16 rounding of h1 moves a pixel by up to
   ~1); K3n equal to K3 bit for bit; K4 (int8) equal to its plain version
   bit for bit; a batched launch equal to the planes launched one at a
   time; on the same planes K5 (row bands) equal to K3 bit for bit at
   ``tile_h`` 64 and at the recommended ``fused_conv.BAND_TILE_H``; every
   cut (``kernels/ablation``) against its plain version: K7 (the cuts of
   K4) bit for bit, K6 (of K1, K2, K3) at its kernel's gate after scaling
   the error by 255 / max(255, max |value|); each ``full`` cut equal to
   the production kernel bit for bit;
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
   through its wrapper) beside its plain version and a library yardstick
   (K1, K2, K3h: the cuDNN f32 conv stack; K3, K3n: the cuDNN bf16 conv
   stack; K4: ``torch._int_mm`` on the three im2col'd layers), the frame
   pass and ``upscale_frames`` per frame at each tier (medians of
   CUDA-event timings after a warm-up); K5 at both band heights beside
   K3, its plain version and the cuDNN bf16 stack;
9. the kernel-profiling path, which launches K5-K7: with the launch
   counts at 0, the port's ``tools.kernel_ablation`` tables of K1, K2 and
   K3 and ``tools.int8_ablation``'s of K4 at 2048^2 (each stage's
   CUDA-event median, its delta, MP/s and the production launch), and
   ``tools.trace_kernel`` on K5 at both band heights; each of K5, K6 and
   K7 launched in that run.

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

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(ROOT, "tests", "goldens", "goldens.npz")

# max abs error of each kernel against its plain version on [0, 255] planes:
# f32 (K1) or f32 accumulation of exact bf16 products (K2, K3h) in another
# order than cuDNN's; bf16x1 (K3) adds flips of bf16 roundings of h1 / c2
KERNEL_TOL = {"K1": 2e-3, "K2": 5e-3, "K3h": 5e-3, "K3": 2.0}
BF16X1_P999 = 0.05
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
# the cut that stands for K6 / K7 in the kernels record: each one's last
# cut of its first kernel (every cut's time is printed in phase 9)
RECORD_CUT = {"K6": ("K1", "conv2"), "K7": ("K4", "taps")}
INT8_PSNR = 38.0     # butterfly x2 against the exact tier (tests/test_int8.py)
# H100 SXM dense peak rates at 700 W (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
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
          macs_per_pixel: int = MACS_PER_PIXEL) -> tuple[float, str]:
    """Least time (ms) the card could take for the kernel's work on n
    [h, w] planes, and what sets it: the useful MACs (``macs_per_pixel``:
    all of them, or the stages a cut keeps) at the tensor-core bf16 rate
    (two passes for the split forms), the int8 rate (K4) or the f32 FMA
    rate (K1), or the planes in and out plus the parameters at the memory
    rate."""
    macs = macs_per_pixel * n * h * w
    if kernel == "K1":
        ops_s = 2 * macs / PEAK_F32_FLOPS
    elif kernel == "K4":
        ops_s = 2 * macs / PEAK_INT8_OPS
    else:
        ops_s = (2 if kernel in ("K2", "K3h") else 1) * 2 * macs / PEAK_BF16_FLOPS
    param_bytes = INT8_PACK_BYTES if kernel == "K4" else 4 * N_PARAMS
    bytes_s = (4 * (n * (h + 12) * (w + 12) + n * h * w) + param_bytes) / PEAK_BYTES
    return (1e3 * max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes")


def sass_counts(_build) -> dict:
    """(kernel, stage) -> the count of HMMA / IMMA / FFMA instructions in
    each cut instance of the profiling libraries, from ``cuobjdump -sass``
    (the toolkit nvcc came from).  Instances are told apart by their
    mangled template arguments: ``fused_srcnn_kernel<STAGE>`` (K1),
    ``fused_srcnn_bf16_kernel<MODE, TW, STAGE>`` (MODE 0 K2, 1 K3, at TW
    60), ``fused_srcnn_int8_kernel<STAGE>`` (K4)."""
    from libsrcnn_tpu_torch.kernels import ablation

    stage_of = {code: name for name, code in ablation.STAGE_CODES.items()}
    counts = {}
    for lib in ("fused_srcnn_prof", "fused_srcnn_bf16_prof", "fused_srcnn_int8_prof"):
        sass = subprocess.run([_build.tool("cuobjdump"), "-sass", _build.library_path(lib)],
                              capture_output=True, text=True, check=True).stdout
        key = None
        for line in sass.splitlines():
            m = re.search(r"Function : \S*?(fused_srcnn(?:_bf16|_int8)?)_kernelI((?:Li\d+E)+)E", line)
            if m:
                args = [int(a) for a in re.findall(r"Li(\d+)E", m.group(2))]
                if m.group(1) == "fused_srcnn_bf16":
                    mode, tw, stage = args
                    kernel = {(0, 60): "K2", (1, 60): "K3"}.get((mode, tw))
                else:
                    kernel, stage = ("K1" if m.group(1) == "fused_srcnn" else "K4"), args[0]
                key = None if kernel is None else (kernel, stage_of[stage])
                if key:
                    counts[key] = 0
                continue
            if "Function :" in line:
                key = None
            elif key and re.search(r"\s(HMMA|IMMA|FFMA)[.\s]", line):
                counts[key] += 1
    return counts


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

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # --- 2. build ---------------------------------------------------------
    t = time.perf_counter()
    fused_conv.build_all()
    print(f"build: fused_srcnn.cu + fused_srcnn_bf16.cu + fused_srcnn_int8.cu, "
          f"each also with {' '.join(_build.PROFILING_FLAGS)}, in "
          f"{time.perf_counter() - t:.1f} s ({' '.join(_build.NVCC_FLAGS)})")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    # no cut may have lost the work it names: the count of tensor-core and
    # FMA instructions grows with each stage a cut keeps
    counts = sass_counts(_build)
    for kernel, stages in ablation.STAGES.items():
        seq = [counts.get((kernel, st)) for st in stages]
        print(f"SASS HMMA/IMMA/FFMA of {kernel}'s cuts: "
              + ", ".join(f"{st} {c}" for st, c in zip(stages, seq)))
        check(None not in seq, f"{kernel}: a cut instance is missing from the SASS")
        check(all(a < b for a, b in zip(seq[:-2], seq[1:-1])) and seq[-1] >= seq[-2],
              f"{kernel}: a cut's SASS count does not grow with its stages: {seq}")

    # --- 3. kernels vs plain versions on the card --------------------------
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
    for ((h, w), flags), y in list(zip(cases, planes)) + [(((130, 250), None), batch)]:
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
            d = (got[name] - ref).abs()
            err = float(d.max())
            msg = (f"{name} vs plain {'3 planes ' if y.dim() == 3 else ''}"
                   f"{h}x{w} flags={flags or (1, 1, 1, 1)}: max abs err {err:.3g}")
            if name == "K3":
                p999 = float(torch.quantile(d.flatten()[:1_000_000], 0.999))
                msg += f", p99.9 {p999:.3g}"
                check(p999 <= BF16X1_P999, f"K3 p99.9 {p999} at {h}x{w}")
            print(msg)
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
                d = d * 255.0 / max(255.0, float(ref.abs().max()))
                sm = float(d.max())
                scaled_max[kernel] = max(scaled_max.get(kernel, 0.0), sm)
                if kernel == "K3":
                    p999 = float(torch.quantile(d.flatten()[:1_000_000], 0.999))
                    check(sm <= KERNEL_TOL["K3"] and p999 <= BF16X1_P999,
                          f"K3's {stage} cut at {what}: scaled max {sm}, p99.9 {p999}")
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
        print(f"timing on {card}, median of 10: 2048^2 conv stack {name} "
              f"{t['kernel']:.3f} ms (through its wrapper {t['wrapper']:.3f} "
              f"ms), its plain version {t['plain']:.3f} ms")
    # the nearest library computation to K3: cuDNN's bf16 convs (valid on the
    # halo plane, no ring clamp; their outputs are bf16); the port never calls it
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
          f"(library yardstick for K3, K3n), f32 with TF32 off "
          f"{lib['f32']:.3f} ms (for K1, K2, K3h)")
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

    # K5 beside K3 (the same work in row bands), in turns on one card
    th = fused_conv.BAND_TILE_H
    band_t = timed({"K3": lambda: fused_conv.launch("K3", packed, y, y_out),
                    "K5 64": lambda: fused_conv.launch("K5", packed, y, y_out, tile_h=64),
                    f"K5 {th}": lambda: fused_conv.launch("K5", packed, y, y_out, tile_h=th),
                    "plain": lambda: fused_conv.forward_y_band_reference(
                        params, y, 2048, 2048, tile_h=th)})
    kern_ms["K5"], plain_ms["K5"] = band_t[f"K5 {th}"], band_t["plain"]
    print(f"timing on {card}, median of 10: 2048^2 K5 (row bands) at tile_h 64 "
          f"{band_t['K5 64']:.3f} ms, at tile_h {th} {band_t[f'K5 {th}']:.3f} ms; K3 "
          f"{band_t['K3']:.3f} ms; its plain version (K3's) {band_t['plain']:.3f} ms; "
          f"cuDNN bf16 stack {lib['bf16']:.3f} ms")
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
    print(f"chip_smoke ran in {time.perf_counter() - t_start:.1f} s")

    check("jax" not in sys.modules and "libsrcnn_tpu" not in sys.modules,
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
    sys.exit(main())
