"""A ``torch.profiler`` trace of a sub-window, reduced to what the
per-layer metrics read: each device activity (kernel, copy, set) with its
name and interval, the host's operations, the device's busy time and the
length of the window.

The trace is written as Chrome JSON under ``TMPDIR``, read back and
deleted.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile as tprofile

DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "copy", "gpu_memset": "copy"}
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
#: longest name kept in a breakdown entry
NAME_CHARS = 120


class DeviceTrace:
    """Device activities ``(kind, name, start_us, dur_us)`` and host
    operations ``(name, start_us, dur_us)`` of one traced sub-window."""

    def __init__(self, device: list, host: list):
        self.device = sorted(device, key=lambda e: e[2])
        self.host = host

    @classmethod
    def from_chrome(cls, path: str) -> "DeviceTrace":
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        device, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                device.append((DEVICE_CATS[cat], e.get("name", "?"),
                               float(e["ts"]), float(e["dur"])))
            elif cat in HOST_CATS:
                host.append((e.get("name", "?"), float(e["ts"]), float(e["dur"])))
        return cls(device, host)

    def busy(self) -> list:
        """The union of the device activities' intervals, merged, in us."""
        merged = []
        for _, _, t, d in self.device:
            if merged and t <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t + d)
            else:
                merged.append([t, t + d])
        return merged

    def window_s(self) -> float:
        """From the first device activity's start to the last one's end."""
        if not self.device:
            return 0.0
        return (max(t + d for _, _, t, d in self.device) - self.device[0][2]) * 1e-6

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def seconds(self, kind: str, patterns=None) -> float:
        """Summed seconds of the activities of ``kind`` whose names match
        one of ``patterns`` (all when None)."""
        inc = [re.compile(p) for p in patterns] if patterns is not None else None
        total = 0.0
        for k, name, _, d in self.device:
            if k == kind and (inc is None or any(p.search(name) for p in inc)):
                total += d
        return total * 1e-6

    def top_ops(self, n: int = 10) -> list:
        """The ``n`` device activities that took most time, summed by name."""
        by = collections.Counter()
        for _, name, _, d in self.device:
            by[name[:NAME_CHARS]] += d * 1e-6
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle time between device activities, summed by what the host
        was doing at each gap's midpoint (its innermost traced operation),
        the ``n`` largest."""
        busy = self.busy()
        host = sorted(self.host, key=lambda e: e[1])
        starts = [h[1] for h in host]
        longest = max((d for _, _, d in host), default=0.0)
        by = collections.Counter()
        for (_, a), (b, _) in zip(busy, busy[1:]):
            mid = 0.5 * (a + b)
            best = None
            k = bisect.bisect_right(starts, mid) - 1
            while k >= 0 and starts[k] >= mid - longest:
                name, t, d = host[k]
                if mid <= t + d and (best is None or d < best[1]):
                    best = (name, d)
                k -= 1
            by[(best[0] if best else "no traced host op")[:NAME_CHARS]] += (b - a) * 1e-6
        return [[k, v] for k, v in by.most_common(n)]


def profile(fn):
    """Run ``fn()`` under ``torch.profiler`` (CPU and CUDA activities) and
    return ``(fn's result, DeviceTrace)``."""
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        trace = DeviceTrace.from_chrome(path)
    finally:
        os.unlink(path)
    return result, trace
