"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (``libsrcnn_tpu_torch.upscale`` with the
default config: srcnn 9-1-5 at its full width, bicubic, the exact float32
tier) on the card, through the hand-written CUDA kernel, in phases:

1. require a CUDA device; print the card's name and power limit;
2. build the kernel from ``libsrcnn_tpu_torch/kernels/csrc`` (nvcc, sm_90a);
3. hold the kernel against its plain PyTorch version on the card (TF32 off)
   at the listed plane shapes and edge flags: max abs error <= 2e-3;
4. serve requests through ``upscale(..., device="cuda")``: four seeded
   1024x1024 RGB frames at x2, the 29 reference-binary golden configs, one
   ``process_srcnn`` call -- and check that the kernel was launched once per
   pass, that each frame is within 1 u8 LSB of the plain path on the card
   and each golden within 1 u8 LSB of the reference binary;
5. time a 2048x2048 output frame and the conv stack alone, kernel path and
   plain path (median of CUDA-event timings after a warm-up).

The second-to-last line is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device the script exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(ROOT, "tests", "goldens", "goldens.npz")
KERNEL_TOL = 2e-3   # f32 sums in another order than cuDNN's (~4e-4 seen)


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


def check(cond, what) -> None:
    """Raise unless ``cond`` (not ``assert``: it must hold under -O too)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def lsb(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.astype(int) - b.astype(int)).max())


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
    from libsrcnn_tpu_torch.kernels import _build, fused_conv
    from libsrcnn_tpu_torch.models import srcnn

    dev = torch.device("cuda")

    # --- 2. build ---------------------------------------------------------
    t = time.perf_counter()
    fused_conv._lib()
    print(f"build: fused_srcnn.cu in {time.perf_counter() - t:.1f} s "
          f"({' '.join(_build.NVCC_FLAGS)})")
    for line in _build.build_logs.get("fused_srcnn", "").splitlines():
        if "sm_90a" in line or "registers" in line or "spill" in line:
            print(f"  {line.strip()}")

    # --- 3. kernel vs plain version on the card ----------------------------
    params = srcnn.load_params(dev)
    rng = np.random.default_rng(0)
    max_err = 0.0
    cases = [((3, 3), None), ((33, 47), None), ((37, 53), None),
             ((130, 250), None), ((2048, 2048), None), ((130, 250), (0, 1, 0, 1))]
    for (h, w), flags in cases:
        y = torch.from_numpy(smooth_plane(rng, h + 12, w + 12)).to(dev)
        got = fused_conv.forward_y(params, y, h, w, flags)
        torch.cuda.synchronize()
        ref = fused_conv.forward_y_reference(params, y, h, w, flags)
        err = float((got - ref).abs().max())
        unclamped = float(((ref > 0) & (ref < 255)).float().mean())
        print(f"kernel vs plain {h}x{w} flags={flags or (1, 1, 1, 1)}: "
              f"max abs err {err:.3g} ({100 * unclamped:.1f}% unclamped)")
        check(err <= KERNEL_TOL, f"kernel disagrees at {h}x{w}: {err}")
        max_err = max(max_err, err)

    # --- 4. serve requests through the main path ---------------------------
    passes = 0
    run_pass = pipeline.run_pass

    def counted_run_pass(*args, **kwargs):
        nonlocal passes
        passes += 1
        return run_pass(*args, **kwargs)

    frames = [frame(100 + i, 1024, 1024) for i in range(4)]
    z = np.load(GOLDENS)
    pipeline.run_pass = counted_run_pass
    fused_conv.launches = 0
    t = time.perf_counter()
    try:
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
    finally:
        pipeline.run_pass = run_pass
    torch.cuda.synchronize()
    served_s = time.perf_counter() - t
    launches = fused_conv.launches
    print(f"served 4 frames + {len(golden_outs)} goldens + 1 process_srcnn "
          f"in {served_s:.2f} s: {passes} passes, {launches} kernel launches")
    check(launches == passes, f"{launches} launches for {passes} passes")

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

    # --- 5. timing ---------------------------------------------------------
    img = torch.tensor(frames[1], device=dev)
    kern_cfg = lt.SRCNNConfig()
    plain_cfg = lt.SRCNNConfig(use_kernel=False)
    y = torch.from_numpy(smooth_plane(rng, 2060, 2060)).to(dev)
    frame_kernel = lambda: pipeline.run_pass(img, params, 2.0, kern_cfg)
    frame_plain = lambda: pipeline.run_pass(img, params, 2.0, plain_cfg)
    conv_kernel = lambda: fused_conv.forward_y(params, y, 2048, 2048)
    conv_plain = lambda: fused_conv.forward_y_reference(params, y, 2048, 2048)
    times = {fn: [] for fn in (frame_kernel, frame_plain, conv_kernel, conv_plain)}
    # plain, kernel, kernel, plain: both orders on the same card
    for fn in (frame_plain, frame_kernel, conv_plain, conv_kernel,
               conv_kernel, conv_plain, frame_kernel, frame_plain):
        times[fn] += cuda_ms(fn)
    fk, fp, ck, cp = (float(np.median(times[fn])) for fn in
                      (frame_kernel, frame_plain, conv_kernel, conv_plain))
    print(f"timing on {card}, median of 10 runs each: 1024^2 -> 2048^2 frame "
          f"pass, kernel path {fk:.3f} ms, plain path {fp:.3f} ms")
    print(f"timing on {card}, median of 10 runs each: 2048^2 conv stack, "
          f"fused kernel {ck:.3f} ms, plain cuDNN f32 {cp:.3f} ms")

    check("jax" not in sys.modules and "libsrcnn_tpu" not in sys.modules,
          "the port imported jax or the JAX package")
    print(json.dumps({"kernels": [{
        "name": "fused_srcnn",
        "route": "cuda",
        "source": "libsrcnn_tpu_torch/kernels/csrc/fused_srcnn.cu",
        "replaces": "libsrcnn_tpu/kernels/fused_conv.py:199",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ck,
        "plain_ms": cp,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
