"""The device's idle share of the traced sub-window, in %: one minus the
union of its kernel, copy and set intervals over the window from the
first activity's start to the last one's end."""


def read(summary):
    if summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
