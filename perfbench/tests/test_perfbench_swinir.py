"""The SwinIR configuration's files: the benchmark's reference
(``reference/swinir.py``) equal to the repository's own copy
(``tests/plain_swinir.py``) on the CPU at every precision; the config's
work and parameter counts against a count from the spec; the weights
loader's shapes against the program's layout and the config's spec; the
cell's reference path end to end at a small size; and the two SwinIR span
readers on a synthetic summary."""

import json
import math
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import plain_swinir  # noqa: E402
from perfbench import bench, spec  # noqa: E402
from perfbench.reference import plain  # noqa: E402
from perfbench.reference import swinir as ref  # noqa: E402

CELL = "swinir-x2-e180-f32.stills"
CONFIG = next(c for c in spec.benchmark(ROOT)["configs"] if c["name"] == "swinir-x2-e180")
SMALL = {"embed_dim": 48, "depths": [2, 2], "num_heads": [6, 6], "num_feat": 16}


def _config(**over):
    with open(os.path.join(ROOT, CONFIG["file"])) as f:
        return dict(json.load(f), **over)


def _spec_of(params):
    from libsrcnn_tpu_torch.models import swinir

    return swinir.spec_of(params)


@pytest.mark.parametrize("precision", plain.PRECISIONS)
@pytest.mark.parametrize("hw", [(16, 24), (13, 21)])
def test_reference_equals_the_repository_copy(precision, hw):
    params = bench.params_for(_config(**SMALL), 5, torch.device("cpu"))
    y = torch.rand(1, *hw, generator=torch.Generator().manual_seed(3)) * 255.0
    h, w = hw
    a = ref.y_path(params, y, 2 * h, 2 * w, precision)
    b = plain_swinir.y_path(params, y, 2 * h, 2 * w, precision)
    assert a.shape == (1, 2 * h, 2 * w)
    assert torch.equal(a, b)


def test_counts_from_the_spec():
    """Per LR pixel: each Swin layer's qkv, proj, fc1, fc2 and the two
    attention products over its 64-token window; conv_first, the groups'
    convs, conv_after_body, conv_before_up and the x2 conv at LR, conv_last
    at HR.  The parameters are the loader's, counted."""
    cfg = _config()
    params = bench.params_for(cfg, 1, torch.device("cpu"))
    s = _spec_of(params)
    e, m, f, c = s.embed, s.mlp, s.num_feat, cfg["in_chans"]
    layer = 3 * e * e + e * e + 2 * e * m + 2 * s.window ** 2 * e
    convs = (9 * c * e + (s.n_groups + 1) * 9 * e * e + 9 * e * f
             + 9 * f * 4 * f + s.scale ** 2 * 9 * f * c)
    macs_lr = s.layers * layer + convs
    assert macs_lr == 12_456_900
    assert macs_lr == cfg["macs_per_out_px"] * s.scale ** 2
    assert round(100 * s.layers * layer / macs_lr, 1) == 81.6
    assert sum(v.numel() for v in params.values()) == cfg["n_params"] == 11_748_093


def test_loader_gives_the_program_layout_and_the_config_spec():
    from libsrcnn_tpu_torch.models import swinir

    cfg = _config()
    params = bench.params_for(cfg, 2 ** 31 + 77, torch.device("cpu"))
    s = _spec_of(params)
    assert s == swinir.SwinIRSpec(
        embed=cfg["embed_dim"], n_groups=len(cfg["depths"]), depth=cfg["depths"][0],
        heads=cfg["num_heads"][0], window=cfg["window_size"],
        mlp=int(cfg["mlp_ratio"] * cfg["embed_dim"]), num_feat=cfg["num_feat"],
        scale=cfg["upscale"])
    program = swinir.init_params(s, torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in params.items()} == {k: v.shape
                                                       for k, v in program.items()}
    assert params["conv_last_b"].tolist() == [0.5]
    assert float(params["stl.qkv_w"].std()) == pytest.approx(0.02, rel=0.01)
    assert math.isclose(float(params["stl.norm1_w"].mean()), 1.0, abs_tol=0.01)


def test_cell_reference_path_at_a_small_size():
    """The check's reference on a host still of the cell's kind: u8 RGB at
    x2, Y through the model, a conv map."""
    params = bench.params_for(_config(**SMALL), 9, torch.device("cpu"))
    frames = torch.randint(0, 256, (1, 12, 20, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(4))
    out, conv = plain.upscale(frames, "swinir", params, 2.0)
    assert out.shape == (1, 24, 40, 3) and conv.shape == (1, 24, 40)
    assert out.dtype == conv.dtype == torch.uint8


SUMMARY = {"host_call_s": [0.3], "main_flops": 1e13, "main_s": 10.0, "peak_flops": 495e12,
           "out_px": 4_000_000, "window_s": 2.0, "busy_s": 1.9,
           "conv_device_s": 0.8, "ops_device_s": 1.0, "conv_least_s": 0.1}


@pytest.mark.parametrize("metric,span,value", [
    ("attn_ms_per_mp", "sr.swinir.attn", 150.0), ("mlp_ms_per_mp", "sr.swinir.mlp", 50.0)])
def test_swinir_span_readers(metric, span, value):
    spans = {"sr.swinir.attn": 0.6, "sr.swinir.mlp": 0.2, "sr.swinir.conv": 0.3,
             "sr.resize": 0.01}
    read = spec.reader(metric)
    assert read(dict(SUMMARY, span_device_s=spans)) == pytest.approx(value)
    assert read(dict(SUMMARY)) is None, "the parent's summary"
    assert read(dict(SUMMARY, span_device_s={"sr.resize": 0.01})) is None, "another model"
    assert read(dict(SUMMARY, out_px=0, span_device_s=spans)) is None
