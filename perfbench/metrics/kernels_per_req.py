"""Kernels per request that the program's ``sr.*`` spans launched in the
traced sub-window, each counted once, under its innermost span."""


def read(summary):
    kernels = summary.get("span_kernels") or {}
    n = summary.get("trace_requests") or 0
    if not kernels or n <= 0:
        return None
    return sum(kernels.values()) / n
