"""Where a fused kernel's time goes: its stage cuts (K6), timed in turn.

Port of ``benchmarks/kernel_ablation.py``, for the card:

    python -m libsrcnn_tpu_torch.tools.kernel_ablation [size] [--mode exact|split|bf16x1]

``--mode`` picks the kernel: ``exact`` K1, ``split`` K2, ``bf16x1`` K3.
For each stage of ``kernels.ablation.STAGES`` the tool launches the cut on
a seeded ``[size+12]^2`` halo plane (uniform in [0, 255], the shipped
weights packed once) and prints its CUDA-event median, its delta over the
stage before, the output rate, and last the production launch
(``fused_conv.launch``).  The cuts write sums, not images
(``kernels/ablation.py``).  It needs a CUDA device and raises without
one.  :func:`ablate` returns the rows for other scripts.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..kernels import ablation, fused_conv
from ..models import srcnn, srcnn_int8
from ..utils import profiling

MODES = {"exact": "K1", "split": "K2", "bf16x1": "K3"}


def cuda_device(device: torch.device | str = "cuda") -> torch.device:
    """``device`` if it is a CUDA device and one is present; else raise."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the profiling tools time CUDA kernels and need a "
                           f"CUDA device; got {device}, CUDA available: "
                           f"{torch.cuda.is_available()}")
    return device


def ablate(kernel: str, size: int = 2048, *, runs: int = 10,
           device: torch.device | str = "cuda", seed: int = 0) -> list[dict]:
    """Time ``kernel``'s cuts (K1-K3: K6; K4: K7) and its production
    launch at ``size``^2: one row per stage and a last one, ``production``,
    each ``{"stage", "ms", "delta_ms", "mp_per_s"}`` (``delta_ms`` over the
    row before, None for the first)."""
    dev = cuda_device(device)
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.uniform(0, 255, (size + 12, size + 12))
                         .astype(np.float32)).to(dev)
    if kernel == "K4":
        packed = fused_conv.pack_int8_params(srcnn_int8.load_params(dev))
    else:
        packed = fused_conv.pack_params(srcnn.load_params(dev)).to(dev)
    out = torch.empty(size, size, dtype=torch.float32, device=dev)
    fns = {stage: (lambda s=stage: ablation.launch_cut(kernel, s, packed, y, out))
           for stage in ablation.STAGES[kernel]}
    fns["production"] = lambda: fused_conv.launch(kernel, packed, y, out)
    rows, prev = [], None
    for stage, fn in fns.items():
        ms = profiling.median_ms(fn, dev, runs)
        rows.append({"stage": stage, "ms": ms,
                     "delta_ms": None if prev is None else ms - prev,
                     "mp_per_s": size * size / 1e3 / ms})
        prev = ms
    return rows


def report(kernel: str, size: int, rows: list[dict], card: str, runs: int = 10) -> str:
    """The table of :func:`ablate`'s rows."""
    lines = [f"{kernel} stage cuts at {size}x{size} on {card}: CUDA-event "
             f"median of {runs} single launches"]
    for r in rows:
        delta = "" if r["delta_ms"] is None else f"  (+{r['delta_ms']:.3f})"
        lines.append(f"  {r['stage']:10s} {r['ms']:8.3f} ms{delta:12s} "
                     f"{r['mp_per_s']:9.1f} MP/s")
    return "\n".join(lines)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("size", type=int, nargs="?", default=2048)
    ap.add_argument("--mode", choices=tuple(MODES), default="exact")
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args(argv)
    kernel = MODES[args.mode]
    rows = ablate(kernel, args.size, runs=args.runs)
    print(report(kernel, args.size, rows, profiling.card(), args.runs))
    return rows


if __name__ == "__main__":
    main()
