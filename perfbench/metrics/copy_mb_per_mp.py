"""Megabytes copied between the host and the card per output megapixel
over the measured window: the program's ``copy.h2d_bytes`` and
``copy.d2h_bytes`` counters (its uploads and downloads)."""

KEYS = ("copy.h2d_bytes", "copy.d2h_bytes")


def read(summary):
    counts = summary.get("counts")
    px = summary.get("main_out_px") or 0
    if counts is None or px <= 0 or not any(k in counts for k in KEYS):
        return None
    return sum(counts.get(k, 0) for k in KEYS) / px
