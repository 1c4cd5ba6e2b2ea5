"""Profiling and timing -- port of ``libsrcnn_tpu/utils/profiling.py``.

* :func:`trace` -- a ``torch.profiler`` run around a block, written as a
  Chrome trace file (view it in Perfetto or ``chrome://tracing``);
* :func:`sync` -- wait for the work queued on every CUDA device that the
  given tensors live on;
* :class:`StageTimer` -- per-stage times: CUDA events on a CUDA device,
  the host clock on the CPU;
* :func:`median_ms` -- the median time of single calls, by StageTimer;
* :func:`card` -- the card's name and power limit, to print beside times;
* :func:`flops_estimate` -- the FLOPs of one SRCNN 9-1-5 pass.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block: ``with trace("tb") as prof: run()``.  Records
    CPU ops, and CUDA kernels when a card is present; on exit writes
    ``<logdir>/trace.json``.  ``prof.key_averages()`` sums the events by
    name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def sync(tensors) -> None:
    """Wait until each CUDA device that a tensor of ``tensors`` (a tensor,
    or lists, tuples and dicts of them) lives on has finished its queued
    work.  CUDA calls return before the device is done, so a host clock
    read without this measures the enqueue.  CPU tensors need nothing."""
    for dev in {t.device for t in _tensors(tensors) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class StageTimer:
    """Per-stage times over iterations, in ms.

    On a CUDA device each stage is timed by CUDA events recorded on the
    current stream around the block (the device's time for the work the
    block queued); on the CPU by the host clock around the block.

    >>> t = StageTimer(torch.device("cuda"))
    >>> with t.stage("resize"):
    ...     out = resize(...)
    >>> print(t.report())
    """

    def __init__(self, device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"StageTimer times CPU or CUDA work, got {self.device}")
        self._events: dict[str, list] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.device.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record(torch.cuda.current_stream(self.device))
            try:
                yield
            finally:
                t1.record(torch.cuda.current_stream(self.device))
                self._events.setdefault(name, []).append((t0, t1))
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._events.setdefault(name, []).append(
                    1e3 * (time.perf_counter() - t0))

    @property
    def times(self) -> dict[str, list[float]]:
        """Stage -> its times in ms (waits for the device first)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            return {k: [a.elapsed_time(b) for a, b in v]
                    for k, v in self._events.items()}
        return {k: list(v) for k, v in self._events.items()}

    def report(self) -> str:
        clock = "CUDA events" if self.device.type == "cuda" else "host clock"
        return "\n".join(f"{name:20s} {float(np.median(ts)):8.3f} ms "
                         f"(median of {len(ts)}, {clock})"
                         for name, ts in self.times.items())


def card(device: torch.device | str = "cuda") -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them, for printing
    beside a time; the name alone where nvidia-smi cannot be run."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        res = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, check=True)
        return res.stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"


def median_ms(fn, device: torch.device | str = "cuda", runs: int = 10,
              warmup: int = 2) -> float:
    """Median ms of ``runs`` single calls of ``fn``, after ``warmup``
    calls, timed by :class:`StageTimer` on ``device``: CUDA events on its
    current stream, or the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    timer = StageTimer(device)
    for _ in range(runs):
        with timer.stage("call"):
            fn()
    return float(np.median(timer.times["call"]))


def flops_estimate(out_h: int, out_w: int) -> int:
    """FLOPs of one SRCNN 9-1-5 pass at the given output size (the convs
    only; resize and color are O(pixels))."""
    per_pixel = 2 * (81 * 64 + 64 * 32 + 25 * 32)
    return out_h * out_w * per_pixel
