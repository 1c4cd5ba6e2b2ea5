"""The whole pass's share of the chip's peak, in %: the model FLOPs of
every request of the measured window, over the window's seconds on the
host clock (outside the profiler), over the tier's peak."""


def read(summary):
    if summary["main_s"] <= 0 or summary["main_flops"] <= 0:
        return None
    return 100.0 * summary["main_flops"] / summary["main_s"] / summary["peak_flops"]
