"""The program's own spans and counters, read beside the benchmark's
trace: each device activity of a traced sub-window put down to the
innermost ``sr.*`` span of ``libsrcnn_tpu_torch`` that launched it, and
the program's counters (``utils.profiling.counts_snapshot``) over a
measured window.

A kernel or copy is put down through its ``correlation`` to the runtime
call that launched it: the innermost ``sr.*`` range open on that
thread at the call's time.  An activity whose launch is not in the trace
(a library that brings its own CUDA runtime) is put down through the
device-side ``gpu_user_annotation`` ranges that Kineto draws for each
range around the work it launched: the shortest ``sr.*`` one that holds
it.

:func:`span_fields` gives the keys that the readers of
:data:`METRICS` read beside :func:`.bench.summary`'s.  Run as a script,

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s>

it runs one cell as ``run.py`` does (set-up, the measured window, a
traced sub-window; no check) and prints one JSON line: every per-layer
metric of the cell, the metrics of :data:`METRICS` that apply to it, the
span and counter figures they read, the share of kernel time put down
to a span, the device time of every span outside the conv stack's own
kernels per output MP (what ``ops_ms_per_mp`` reads, by span), the
breakdown's idle gaps, the same by span, and the host time per traced
request.  A program without spans or counters gives
None for the metrics that read them.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

from perfbench import tracing  # noqa: E402

PREFIX = "sr."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: the readers of the program's spans and counters, by the end-to-end
#: metric of the cells they apply to
METRICS = {"out_mp_s": ("resize_ms_per_mp", "color_ms_per_mp", "kernels_per_req",
                        "rebuilds_per_req"),
           "out_mp_s.stills": ("kernels_per_req.stills", "copy_mb_per_mp.stills")}


class _Ranges:
    """The ``sr.*`` ranges ``(start, stop, name)`` of one timeline."""

    def __init__(self, ranges: list):
        self.ranges = sorted(ranges)
        self.starts = [r[0] for r in self.ranges]
        self.longest = max((b - a for a, b, _ in self.ranges), default=0.0)

    def innermost(self, t: float, end: float | None = None):
        """The name of the shortest range that holds ``t`` (and ``end``,
        when given), or None."""
        end = t if end is None else end
        best = None
        k = bisect.bisect_right(self.starts, t) - 1
        while k >= 0 and self.starts[k] >= t - self.longest:
            a, b, name = self.ranges[k]
            if b >= end and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
            k -= 1
        return best[2] if best else None


def attribute(events: list) -> list:
    """Chrome trace events -> every device activity as ``(kind, name,
    start_us, dur_us, span)``, ``span`` the innermost ``sr.*`` span that
    launched it, or None."""
    host = collections.defaultdict(list)        # (pid, tid) -> sr.* ranges
    gpu = collections.defaultdict(list)         # device pid -> sr.* ranges
    launches = {}                               # correlation -> (pid, tid), ts
    acts = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "?")
        ts, dur = float(e["ts"]), float(e["dur"])
        where = (e.get("pid"), e.get("tid"))
        corr = (e.get("args") or {}).get("correlation")
        if cat in tracing.DEVICE_CATS:
            acts.append((tracing.DEVICE_CATS[cat], name, ts, dur, corr, e.get("pid")))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = (where, ts)
        elif cat == "user_annotation" and name.startswith(PREFIX):
            host[where].append((ts, ts + dur, name))
        elif cat == "gpu_user_annotation" and name.startswith(PREFIX):
            gpu[e.get("pid")].append((ts, ts + dur, name))
    host = {k: _Ranges(v) for k, v in host.items()}
    gpu = {k: _Ranges(v) for k, v in gpu.items()}
    out = []
    for kind, name, ts, dur, corr, pid in sorted(acts, key=lambda a: a[2]):
        span = None
        if corr in launches:
            where, t = launches[corr]
            span = host[where].innermost(t) if where in host else None
        elif pid in gpu:
            span = gpu[pid].innermost(ts, ts + dur)
        out.append((kind, name, ts, dur, span))
    return out


def span_fields(events: list) -> dict:
    """What the span readers read from a traced sub-window's events:
    ``span_device_s`` (span -> summed seconds of the kernels and copies
    put down to it), ``span_kernels`` (span -> kernels), and the seconds
    of every kernel, ``kernel_s``, and of those put down to no span,
    ``unattributed_kernel_s``."""
    device_s, kernels = collections.Counter(), collections.Counter()
    total = lost = 0.0
    for kind, _, _, dur, span in attribute(events):
        if kind == "kernel":
            total += dur
            if span is None:
                lost += dur
        if span is None:
            continue
        device_s[span] += dur * 1e-6
        if kind == "kernel":
            kernels[span] += 1
    return {"span_device_s": dict(device_s), "span_kernels": dict(kernels),
            "kernel_s": total * 1e-6, "unattributed_kernel_s": lost * 1e-6}


def profile(fn):
    """:func:`.tracing.profile` that also keeps the span fields of the
    same trace: ``(fn's result, DeviceTrace, span_fields)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        trace = tracing.DeviceTrace.from_chrome(path)
        with open(path) as f:
            fields = span_fields(json.load(f).get("traceEvents", []))
    finally:
        os.unlink(path)
    return result, trace, fields


def span_gaps(trace: tracing.DeviceTrace, n: int = 16) -> list:
    """The device's idle gaps summed by the innermost ``sr.*`` span (or
    ``perfbench.*`` range) the host was in at each gap's midpoint: the
    breakdown's ``idle_gaps`` with the ATen operations left out."""
    ranges = [h for h in trace.host if h[0].startswith((PREFIX, "perfbench."))]
    return tracing.DeviceTrace(trace.device, ranges).idle_gaps(n)


def counts_snapshot():
    """The program's counters, or None where the program has none."""
    from libsrcnn_tpu_torch.utils import profiling

    snap = getattr(profiling, "counts_snapshot", None)
    return snap() if snap else None


def run_cell(cell, seed: int, seconds: float, device):
    """Set-up, the measured window with the counters read around it, and
    the traced sub-window: ``(summary, DeviceTrace, host seconds of each
    traced call)``, the summary :func:`.bench.summary`'s with the span
    fields, ``counts`` (the counters that moved over the measured window,
    by how much; None where the program has no counters),
    ``main_requests``, ``main_out_px`` and ``trace_requests``."""
    import torch

    from perfbench import bench, drive

    _, plan, call = bench.prepare(cell, seed, device)
    torch.cuda.synchronize()
    before = counts_snapshot()
    main = drive.run(call, plan, device, seconds=seconds)
    after = counts_snapshot()
    counts = None if before is None else {
        k: after[k] - before[k] for k in after if after[k] != before[k]}
    sub, trace, fields = profile(lambda: drive.run(
        call, plan, device, count=cell.traffic["trace_requests"],
        start=len(main.done), annotate=True))
    s = bench.summary(cell, plan, main, sub, trace)
    s.update(fields, counts=counts,
             main_requests=len(main.done),
             main_out_px=sum(d.out_px for d in main.done),
             trace_requests=len(sub.done))
    return s, trace, [d.t_called - d.t_issue for d in sub.done]


def main(argv=None) -> int:
    import argparse
    import statistics

    import torch

    from perfbench import spec

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    cell = spec.load(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    s, trace, traced_call_s = run_cell(cell, args.seed, args.seconds,
                                       torch.device("cuda", 0))
    names = [m["name"] for m in cell.per_layer]
    for m in cell.end_to_end:
        names += METRICS.get(m["name"], ())
    metrics = {n: spec.reader(n)(s) for n in names}
    spans = s["span_device_s"]
    ops_s = (sum(v for k, v in spans.items() if k.startswith(("sr.resize", "sr.color")))
             + spans.get("sr.conv_stack", 0.0) - s["conv_device_s"])
    line = {"workload": cell.name, "seed": args.seed, "metrics": metrics,
            "kernel_cover": (1 - s["unattributed_kernel_s"] / s["kernel_s"]
                             if s["kernel_s"] else None),
            "ops_by_spans_ms_per_mp": (1e3 * ops_s / (s["out_px"] / 1e6)
                                       if s["out_px"] else None),
            "traced_call_ms_median": 1e3 * statistics.median(traced_call_s),
            "traced_call_ms_mean": 1e3 * statistics.fmean(traced_call_s),
            "idle_gaps": trace.idle_gaps(16), "idle_gaps_by_span": span_gaps(trace),
            **{k: v for k, v in s.items() if k != "host_call_s"}}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
