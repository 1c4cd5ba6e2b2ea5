"""A ``torch.profiler`` trace of one fused kernel, with its device time.

Port of ``benchmarks/trace_kernel.py``, for the card:

    python -m libsrcnn_tpu_torch.tools.trace_kernel [--size 2048] [--mode exact] [--iters 4] [--th N]

The modes are the JAX tool's; each names the kernel the port runs for it:
``exact`` K1, ``split`` K2, ``bf16x1`` and ``bf16x1pk`` K3 (the pair pack
is a Mosaic store workaround), ``splitpk`` K3h, ``int8`` K4, ``bf16x1nw``
K3n, ``bf16x1band`` and ``bf16x1bandf`` K5 (``--th`` is its band height,
64 by default as in the JAX tool).  The tool launches the kernel once per
iteration, each on its own seeded ``[size+12]^2`` halo plane, under the
profiler, and prints the device time of each CUDA kernel the trace holds
(ms per iteration, share, launches per iteration) beside the CUDA-event
time of the same launches.  The trace goes to ``--logdir/trace.json``.
It needs a CUDA device and raises without one.
"""

from __future__ import annotations

import argparse
import collections
import tempfile

import numpy as np
import torch

from ..kernels import fused_conv
from ..models import srcnn, srcnn_int8
from ..utils import profiling
from .kernel_ablation import cuda_device

#: JAX tool mode -> the kernel the port runs for it
MODES = {"exact": "K1", "split": "K2", "bf16x1": "K3", "bf16x1pk": "K3",
         "splitpk": "K3h", "int8": "K4", "bf16x1nw": "K3n",
         "bf16x1band": "K5", "bf16x1bandf": "K5"}


def _device_us(evt) -> float:
    # the attribute's name moved between torch versions
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def capture(size: int = 2048, mode: str = "exact", iters: int = 4,
            tile_h: int | None = None, *, device: torch.device | str = "cuda",
            logdir: str | None = None, seed: int = 0) -> dict:
    """Profile ``iters`` launches of ``mode``'s kernel at ``size``^2.
    Returns ``{"kernel", "event_ms", "kernels": [(name, ms per iteration,
    launches per iteration)], "logdir"}``; ``event_ms`` is the CUDA-event
    time of all launches over ``iters``, ``kernels`` the profiler's device
    time by CUDA kernel name (empty if the profiler saw no device time)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    kernel = MODES[mode]
    if kernel != "K5" and tile_h is not None:
        raise ValueError(f"--th is K5's band height; mode {mode!r} runs {kernel}")
    dev = cuda_device(device)
    rng = np.random.default_rng(seed)
    ys = [torch.from_numpy(rng.uniform(0, 255, (size + 12, size + 12))
                           .astype(np.float32)).to(dev) for _ in range(iters)]
    if kernel == "K4":
        packed = fused_conv.pack_int8_params(srcnn_int8.load_params(dev))
    else:
        packed = fused_conv.pack_params(srcnn.load_params(dev)).to(dev)
    out = torch.empty(size, size, dtype=torch.float32, device=dev)
    th = 64 if tile_h is None else tile_h

    def run(y):
        fused_conv.launch(kernel, packed, y, out, tile_h=th)

    run(ys[0])                                    # build, load, warm up
    torch.cuda.synchronize(dev)
    logdir = logdir or tempfile.mkdtemp(prefix="srcnn_trace_")
    timer = profiling.StageTimer(dev)
    with profiling.trace(logdir) as prof:
        with timer.stage("launches"):
            for y in ys:
                run(y)
    totals = collections.defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            totals[evt.key][0] += us
            totals[evt.key][1] += evt.count
    kernels = sorted(((k, us / 1e3 / iters, n // iters) for k, (us, n) in totals.items()),
                     key=lambda r: -r[1])
    return {"kernel": kernel, "event_ms": timer.times["launches"][0] / iters,
            "kernels": kernels, "logdir": logdir}


def report(size: int, mode: str, res: dict, card: str) -> str:
    lines = [f"{mode} ({res['kernel']}) at {size}x{size} on {card}: "
             f"{res['event_ms']:.3f} ms per launch by CUDA events; trace "
             f"{res['logdir']}/trace.json"]
    total = sum(ms for _, ms, _ in res["kernels"])
    if not total:
        lines.append("  the profiler recorded no device time")
    for name, ms, n in res["kernels"]:
        lines.append(f"  {ms:8.3f} ms/iter {100 * ms / total:5.1f}% {n:3d}x  {name[:90]}")
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--mode", choices=tuple(MODES), default="exact")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--th", type=int, default=None,
                    help="K5's band height (band modes only; default 64)")
    ap.add_argument("--logdir", default=None)
    args = ap.parse_args(argv)
    res = capture(args.size, args.mode, args.iters, args.th, logdir=args.logdir)
    print(report(args.size, args.mode, res, profiling.card()))
    return res


if __name__ == "__main__":
    main()
