"""One run of one cell: set-up, the measured window, the traced
sub-window, the check, and the result line's fields.

Set-up makes the inputs and weights from the seed on the card, builds and
loads the program's kernels and warms every shape the cell's traffic
uses.  The window then sends the traffic for ``seconds`` and waits for
every request it sent.  With ``trace``, a fixed number of further
requests runs under ``torch.profiler``, after the window, so that the
profiler's cost enters no end-to-end number and no host span.  The check
runs last, once the peak memory has been read.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from . import check, drive, spec, tracing, work

FORBIDDEN = ("jax", "jaxlib", "flax", "libsrcnn_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_sample() -> str:
    """nvidia-smi's name, power limit, SM clock and power draw."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"


def params_for(config: dict, seed: int, device: torch.device,
               weights: dict | None = None) -> dict:
    """The weights both sides get, from ``weights/<kind>.py`` of the
    config's ``weights`` (or of ``weights``, a control's own)."""
    w = weights or config["weights"]
    return spec.module("weights", w["kind"]).load(dict(config, weights=w), seed, device)


def program_call(cell: spec.Cell, params: dict, device: torch.device,
                 tier: str | None = None):
    """The program's entry that the cell's traffic drives
    (``entries/<entry>.py``), on ``params`` at the config's tier or at
    ``tier``."""
    from libsrcnn_tpu_torch import SRCNNConfig

    cfg = SRCNNConfig(model=cell.config["model"],
                      compute_dtype=tier or cell.config["tier"])
    return spec.module("entries", cell.traffic["entry"]).make(
        cell.traffic, cfg, params, device)


def e2e(window: drive.Window, t_setup: float) -> dict:
    """The end-to-end quantities, by the part of a metric's name before
    its first dot (``out_mp_s.stills`` is ``out_mp_s`` in its cells)."""
    lat = np.array([d.t_done - d.t_issue for d in window.done])
    return {"out_mp_s": sum(d.out_px for d in window.done) / 1e6 / window.seconds,
            "req_ms_p95": float(np.percentile(lat * 1e3, 95)),
            "setup_s": t_setup}


def summary(cell: spec.Cell, plan: drive.Plan, main: drive.Window,
            sub: drive.Window, trace: tracing.DeviceTrace) -> dict:
    """What the per-layer readers read: the measured window's host spans
    and work on the host clock, and the traced sub-window's device time."""
    cfg = cell.config
    peak = work.peaks()["flops"][cfg["peak"]]
    out_px = sum(d.out_px for d in sub.done)
    conv_bytes = 0
    for d in sub.done:
        oh, ow = plan.out_shape(d.key)
        conv_bytes += work.conv_bytes(cfg, cell.traffic["frames"], oh, ow)
    conv_s = trace.seconds("kernel", cfg["conv_kernels"])
    return {
        "host_call_s": [d.t_called - d.t_issue for d in main.done],
        "main_flops": work.flops(cfg, sum(d.out_px for d in main.done)),
        "main_s": main.seconds, "peak_flops": peak,
        "out_px": out_px,
        "window_s": trace.window_s(), "busy_s": trace.busy_s(),
        "conv_device_s": conv_s,
        "ops_device_s": trace.seconds("kernel") - conv_s,
        "conv_least_s": work.least_seconds(cfg, work.flops(cfg, out_px), conv_bytes),
    }


def check_sample(cell: spec.Cell, plan: drive.Plan, items: list, params: dict,
                 device: torch.device) -> tuple[dict, float]:
    """The worst numbers over the kept requests, and the reference's
    saturation share."""
    batched = plan.traffic["inputs"] == "device"
    worst, sat = {}, []
    for done, outputs in items:
        ref = check.reference(cell.config, params, plan.pool[done.key], plan.scale,
                              batched, device)
        sat.append(check.saturation(ref[1]))
        try:
            nums = check.compare(outputs, ref, batched)
        except ValueError as e:
            log(f"request {done.index}: {e}")
            nums = {k: float("inf") for k in check.NUMBERS}
        log(f"request {done.index} {done.key}: " +
            " ".join(f"{k}={v!r}" for k, v in nums.items()))
        worst = check.worst(worst, nums)
        del ref
    return worst, (float(np.mean(sat)) if sat else 0.0)


def prepare(cell: spec.Cell, seed: int, device: torch.device, call=None):
    """Weights, inputs and the entry of one seed, warmed: ``(params,
    plan, call)``.  ``call`` replaces the program's entry."""
    params = params_for(cell.config, seed, device)
    plan = drive.Plan(cell.traffic, seed, device)
    call = call or program_call(cell, params, device)
    drive.run(call, plan, device, count=cell.traffic["warm_requests"])
    return params, plan, call


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_process: float, call=None) -> dict:
    """One run of ``cell``; returns the result line's fields.  ``call``
    replaces the program's entry (a test's broken path)."""
    on_card = device.type == "cuda"
    params, plan, call = prepare(cell, seed, device, call)
    if on_card:
        torch.cuda.synchronize()
        log("card before the window:", card_sample())
        torch.cuda.reset_peak_memory_stats()
    res = drive.Reservoir(cell.traffic["sample"], seed)
    t_start = time.perf_counter()
    main = drive.run(call, plan, device, seconds=seconds, reservoir=res)
    metrics_e2e = e2e(main, t_start - t_process)
    device_info = {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": 1}
    if on_card:
        log("card after the window:", card_sample())
        device_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        log(f"peak device memory: {device_info['memory_peak_bytes']} bytes")
        from libsrcnn_tpu_torch.kernels import fused_conv

        log("launches per kernel:",
            {k: v for k, v in fused_conv.launches_by.items() if v})
    log(f"window: {len(main.done)} requests in {main.seconds!r} s")
    result = {"correct": False, "attempted": len(main.done), "failed": 0}
    if trace:
        sub, tr = tracing.profile(lambda: drive.run(
            call, plan, device, count=cell.traffic["trace_requests"],
            start=len(main.done), annotate=True))
        s = summary(cell, plan, main, sub, tr)
        log("trace:", {k: v for k, v in s.items() if k != "host_call_s"})
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"])(s)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"], device_info["window_s"] = s["busy_s"], s["window_s"]
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        metrics = {m["name"]: {"value": metrics_e2e[m["name"].split(".")[0]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    numbers, sat = check_sample(cell, plan, res.items, params, device)
    log(f"saturation share (reference conv map at 0 or 255): {sat!r}")
    correct, rows = check.judge(numbers, cell.limits["limits"])
    result.update(correct=correct and len(res.items) > 0, metrics=metrics,
                  device=device_info)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    for k, v, lim in rows:
        log(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}")
    return result
