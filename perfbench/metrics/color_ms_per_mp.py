"""Device milliseconds of the program's color conversions (its
``sr.color.split`` and ``sr.color.merge`` spans: u8 RGB to planar YCbCr,
and back to u8 with the conv map's cast), per output megapixel of the
traced sub-window."""

SPANS = ("sr.color.split", "sr.color.merge")


def read(summary):
    spans = summary.get("span_device_s") or {}
    if summary["out_px"] <= 0 or not any(s in spans for s in SPANS):
        return None
    return 1e3 * sum(spans.get(s, 0.0) for s in SPANS) / (summary["out_px"] / 1e6)
