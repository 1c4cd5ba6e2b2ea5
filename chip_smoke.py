"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths on the card through its hand-written CUDA kernels
(SRCNN 9-1-5 at its full width, shipped weights), in phases:

1. require a CUDA device; print the card's name and power limit;
2. build both kernel libraries from ``libsrcnn_tpu_torch/kernels/csrc``
   (one nvcc each, started together, sm_90a);
3. hold every kernel against its plain PyTorch version on the card at the
   listed plane shapes and edge flags, and a batch of 3 planes in one
   launch: K1 (exact) max abs error <= 2e-3; K2 (split) and K3h (split,
   hi/lo-packed conv1) <= 5e-3; K3 (bf16x1) 99.9th percentile <= 0.05 and
   max <= 2.0 (a rare flipped bf16 rounding of h1 moves a pixel by up to
   ~1); K3n equal to K3 bit for bit; a batched launch equal to the planes
   launched one at a time;
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
6. serving at every tier: ``upscale_frames`` on the 4-frame clip equals
   ``upscale`` per frame bit for bit with one launch per clip,
   ``VideoUpscaler.stream`` likewise, and the flip ensemble of a frame
   through ``upscale`` equals ``upscale_frames`` of it;
7. time at 2048x2048 each kernel (its launch on weights packed once, and
   through ``forward_y``) beside its plain version (and, for K3 / K3n, the
   cuDNN bf16 conv stack as a library yardstick), the frame pass
   and ``upscale_frames`` per frame at each tier (medians of CUDA-event
   timings after a warm-up).

The second-to-last line is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device the script exits non-zero before printing a result.
"""

from __future__ import annotations

import dataclasses
import json
import os
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

# kernel -> (forward_y mode, source, the TPU kernel it replaces)
KERNELS = {
    "K1": (dict(precision="exact"), "fused_srcnn.cu", "libsrcnn_tpu/kernels/fused_conv.py:199"),
    "K2": (dict(precision="split"), "fused_srcnn_bf16.cu", "libsrcnn_tpu/kernels/fused_conv.py:121"),
    "K3": (dict(precision="bf16x1"), "fused_srcnn_bf16.cu", "libsrcnn_tpu/kernels/fused_conv.py:213"),
    "K3h": (dict(precision="split", pack_im2col=True), "fused_srcnn_bf16.cu",
            "libsrcnn_tpu/kernels/fused_conv.py:243"),
    "K3n": (dict(precision="bf16x1", geom="narrow"), "fused_srcnn_bf16.cu",
            "libsrcnn_tpu/kernels/fused_conv.py:73"),
}
# H100 SXM dense peak rates at 700 W (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
MACS_PER_PIXEL = 81 * 64 + 64 * 32 + 25 * 32        # 8,032
N_PARAMS = 8129


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


def bound(kernel: str, n: int, h: int, w: int) -> tuple[float, str]:
    """Least time (ms) the card could take for the kernel's work on n
    [h, w] planes, and what sets it: the useful MACs at the tensor-core
    bf16 rate (two passes for the split forms) or the f32 FMA rate (K1),
    or the planes in and out plus the parameters at the memory rate."""
    macs = MACS_PER_PIXEL * n * h * w
    if kernel == "K1":
        ops_s = 2 * macs / PEAK_F32_FLOPS
    else:
        ops_s = (2 if kernel in ("K2", "K3h") else 1) * 2 * macs / PEAK_BF16_FLOPS
    bytes_s = 4 * (n * (h + 12) * (w + 12) + n * h * w + N_PARAMS) / PEAK_BYTES
    return (1e3 * max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes")


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
    t_start = time.perf_counter()

    # --- 2. build ---------------------------------------------------------
    t = time.perf_counter()
    fused_conv.build_all()
    print(f"build: fused_srcnn.cu + fused_srcnn_bf16.cu in "
          f"{time.perf_counter() - t:.1f} s ({' '.join(_build.NVCC_FLAGS)})")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # --- 3. kernels vs plain versions on the card --------------------------
    params = srcnn.load_params(dev)
    rng = np.random.default_rng(0)
    max_err = {k: 0.0 for k in KERNELS}
    cases = [((3, 3), None), ((33, 47), None), ((37, 53), None),
             ((130, 250), None), ((2048, 2048), None), ((130, 250), (0, 1, 0, 1))]
    planes = [torch.from_numpy(smooth_plane(rng, h + 12, w + 12)).to(dev)
              for (h, w), _ in cases]
    batch = torch.stack([torch.from_numpy(smooth_plane(rng, 142, 262))
                         for _ in range(3)]).to(dev)
    for ((h, w), flags), y in list(zip(cases, planes)) + [(((130, 250), None), batch)]:
        got = {}
        for name, (mode, _, _) in KERNELS.items():
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
        if y.dim() == 3:
            for name, (mode, _, _) in KERNELS.items():
                for i in range(y.shape[0]):
                    one = fused_conv.forward_y(params, y[i], h, w, flags, **mode)
                    check(torch.equal(got[name][i], one),
                          f"{name}: batched launch differs from plane {i}")
            print("batched launch of 3 planes == 3 single launches, every kernel")
    max_err["K3n"] = max_err["K3"]      # equal to K3 on every case above
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

    # --- 6. serving at every tier -------------------------------------------
    clip = np.stack(frames)
    per_frame = {"float32": frame_outs, "bfloat16": tier_outs["K2"][:4],
                 "bfloat16_fast": tier_outs["K3"][:4]}
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

    # --- 7. timing -----------------------------------------------------------
    # a kernel's time is its launch on weights packed once; the wrapper's
    # adds packing the 8,129 weights on every call
    y = torch.from_numpy(smooth_plane(rng, 2060, 2060)).to(dev)
    packed = fused_conv.pack_params(params).to(dev)
    y_out = torch.empty(2048, 2048, device=dev)
    kern_ms, plain_ms = {}, {}
    for name, (mode, _, _) in KERNELS.items():
        pmode = {k: v for k, v in mode.items() if k != "geom"}
        t = timed({"plain": lambda: fused_conv.forward_y_reference(params, y, 2048, 2048, **pmode),
                   "kernel": lambda: fused_conv.launch(name, packed, y, y_out),
                   "wrapper": lambda: fused_conv.forward_y(params, y, 2048, 2048, **mode)})
        kern_ms[name], plain_ms[name] = t["kernel"], t["plain"]
        print(f"timing on {card}, median of 10: 2048^2 conv stack {name} "
              f"{t['kernel']:.3f} ms (through forward_y {t['wrapper']:.3f} "
              f"ms), its plain version {t['plain']:.3f} ms")
    # the nearest library computation to K3: cuDNN's bf16 convs (valid on the
    # halo plane, no ring clamp; their outputs are bf16); the port never calls it
    pb = {k: v.to(torch.bfloat16) for k, v in params.items()}
    yb = y[None, None].to(torch.bfloat16)

    def cudnn_bf16():
        h1 = torch.relu(torch.nn.functional.conv2d(yb, pb["w1"], pb["b1"]))
        c2 = torch.relu(torch.nn.functional.conv2d(h1, pb["w2"], pb["b2"]))
        return torch.nn.functional.conv2d(c2, pb["w3"], pb["b3"]).clamp(0, 255)

    lib_ms = timed({"lib": cudnn_bf16})["lib"]
    print(f"timing on {card}, median of 10: 2048^2 cuDNN bf16 conv stack "
          f"(library yardstick for K3) {lib_ms:.3f} ms")

    img = torch.tensor(frames[1], device=dev)
    tiers = ("float32", "bfloat16", "bfloat16_fast")
    fns = {t_: (lambda c=lt.SRCNNConfig(compute_dtype=t_): pipeline.run_pass(img, params, 2.0, c))
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
                  | {t_: (lambda c=lt.SRCNNConfig(compute_dtype=t_):
                          pipeline.run_pass(clip_dev, params, 2.0, c))
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
    print(f"chip_smoke ran in {time.perf_counter() - t_start:.1f} s")

    check("jax" not in sys.modules and "libsrcnn_tpu" not in sys.modules,
          "the port imported jax or the JAX package")
    records = []
    for name, (_, src, replaces) in KERNELS.items():
        bms, by = bound(name, 1, 2048, 2048)
        records.append({
            "name": name, "route": "cuda",
            "source": f"libsrcnn_tpu_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name], "ms": kern_ms[name],
            "plain_ms": plain_ms[name], "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms if name in ("K3", "K3n") else None,
        })
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
