"""The conv stack's share of its roofline, in %: the least time the chip
needs for the model's conv work of the traced sub-window (the larger of
its FLOPs at the tier's peak and its input plane, output plane and
weights at the memory's peak), over the device time of the kernels that
the configuration names as its conv stack."""


def read(summary):
    if summary["conv_device_s"] <= 0:
        return None
    return 100.0 * summary["conv_least_s"] / summary["conv_device_s"]
