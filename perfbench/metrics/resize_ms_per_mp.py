"""Device milliseconds of the program's resizes (its ``sr.resize`` spans:
the band gathers of each chroma plane and of the Y plane with its halo),
per output megapixel of the traced sub-window."""


def read(summary):
    spans = summary.get("span_device_s") or {}
    if summary["out_px"] <= 0 or "sr.resize" not in spans:
        return None
    return 1e3 * spans["sr.resize"] / (summary["out_px"] / 1e6)
