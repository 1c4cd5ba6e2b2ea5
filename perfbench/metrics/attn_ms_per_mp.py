"""Device milliseconds of the program's SwinIR attention (its
``sr.swinir.attn`` spans: LN1, roll, window partition, qkv, scores, bias,
mask, softmax, AV, proj, reverse, roll back and the residual add, one per
Swin layer), per output megapixel of the traced sub-window."""


def read(summary):
    spans = summary.get("span_device_s") or {}
    if summary["out_px"] <= 0 or "sr.swinir.attn" not in spans:
        return None
    return 1e3 * spans["sr.swinir.attn"] / (summary["out_px"] / 1e6)
