"""Device milliseconds of the program's SwinIR MLPs (its ``sr.swinir.mlp``
spans: LN2, fc1, GELU, fc2 and the residual add, one per Swin layer), per
output megapixel of the traced sub-window."""


def read(summary):
    spans = summary.get("span_device_s") or {}
    if summary["out_px"] <= 0 or "sr.swinir.mlp" not in spans:
        return None
    return 1e3 * spans["sr.swinir.mlp"] / (summary["out_px"] / 1e6)
