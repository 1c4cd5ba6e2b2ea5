"""Device milliseconds of every kernel that is not the conv stack's (the
color split and merge, the resizes, and whatever else the pass runs
beside the stack), per output megapixel of the traced sub-window."""


def read(summary):
    if summary["out_px"] <= 0 or summary["ops_device_s"] <= 0:
        return None
    return 1e3 * summary["ops_device_s"] / (summary["out_px"] / 1e6)
