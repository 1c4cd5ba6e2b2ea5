"""SwinIR (``models/swinir``) on the CPU at a small spec (embed 48, 6
heads, 2 groups of 2 layers, window 8, num_feat 16), on seeded weights:
``forward_lr`` against the repository's plain reference
(``tests/plain_swinir.py``) and the reference's altered forms; the pass
through ``api.upscale`` against the benchmark's plain reference on u8 RGB;
step-scale, clips, the refusals, and the spans and counters.

Tolerance: the port and the reference compute the same f32 products and
sums in other orders (cuBLAS / oneDNN blockings, ``F.layer_norm``'s
Welford against the two-pass mean and variance, a fused softmax), and the
gaps stay at a few f32 ulps of the [0, 255] output (<= 6e-5 u8 levels
over three seeds and three sizes); :data:`TOL` is 3e-4 levels, 20 ulps at
128.  A reference on bf16-rounded operands misses by 0.3-0.45 levels,
without the shift mask by 0.06-0.15, and with the relative-position bias
zeroed by 1.6e-3-2.2e-3: each at least five times :data:`TOL`.
"""

import os
import sys

import numpy as np
import pytest
import torch

import libsrcnn_tpu_torch as T
from libsrcnn_tpu_torch import api, pipeline, serve
from libsrcnn_tpu_torch.models import swinir
from libsrcnn_tpu_torch.parallel import make_mesh, upscale_tiled
from libsrcnn_tpu_torch.utils import profiling

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import plain_swinir  # noqa: E402
from perfbench.reference import plain  # noqa: E402

SPEC = swinir.SwinIRSpec(embed=48, n_groups=2, depth=2, heads=6, window=8, mlp=96,
                         num_feat=16)
#: max |port - reference| on the Y plane, in u8 levels (see the module's notes)
TOL = 3e-4
CFG = T.SRCNNConfig(model="swinir")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs, as the zoo's tests pin
    it: many small matmuls with every worker's threads on the same cores
    take many times longer than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return swinir.init_params(SPEC, torch.Generator().manual_seed(0))


def _plane(h, w, seed=1):
    return torch.rand(h, w, generator=torch.Generator().manual_seed(seed)) * 255.0


def _image(h, w, seed=2):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _gap(params, y, **ref_args):
    out = swinir.forward_lr(params, y, SPEC)
    ref = plain_swinir.y_path(ref_args.get("ref_params", params), y[None],
                              2 * y.shape[0], 2 * y.shape[1],
                              ref_args.get("precision", "f32"))[0]
    assert out.shape == ref.shape == (2 * y.shape[0], 2 * y.shape[1])
    return (out - ref).abs().max().item()


def test_spec_of_and_param_count(params):
    assert swinir.spec_of(params) == SPEC
    full = swinir.init_params(swinir.SwinIRSpec(), torch.Generator().manual_seed(0))
    assert swinir.spec_of(full) == swinir.SwinIRSpec()
    assert sum(v.numel() for v in full.values()) == 11_748_093
    assert full["stl.qkv_w"].shape == (36, 540, 180)
    assert full["stl.bias_table"].shape == (36, 225, 6)
    assert full["group.conv_w"].shape == (6, 180, 180, 3, 3)


@pytest.mark.parametrize("hw", [(16, 16), (24, 40), (21, 30)])
def test_forward_matches_reference(params, hw):
    """16x16 and 24x40 fill the windows; 21x30 takes the reflect pad to
    24x32 and the crop."""
    assert _gap(params, _plane(*hw)) <= TOL


@pytest.mark.parametrize("control", ["bf16", "no_shift_mask", "no_relative_bias"])
def test_altered_reference_fails(params, control, monkeypatch):
    y = _plane(21, 30)
    if control == "bf16":
        gap = _gap(params, y, precision="bf16")
    elif control == "no_shift_mask":
        monkeypatch.setattr(plain_swinir, "shift_mask",
                            lambda hp, wp, ws, s: torch.zeros(1, ws * ws, ws * ws))
        gap = _gap(params, y)
    else:
        zeroed = dict(params, **{"stl.bias_table": torch.zeros_like(
            params["stl.bias_table"])})
        gap = _gap(params, y, ref_params=zeroed)
    assert gap > 5 * TOL, gap


def test_upscale_matches_the_benchmark_reference(params):
    """The whole pass (color split, chroma resize, the model, merge) on u8
    RGB against ``perfbench/reference/plain.upscale``: the color and resize
    are equal bit for bit, so only a Y value within :data:`TOL` of a level
    boundary can flip; none does here."""
    img = _image(21, 30)
    out, conv = T.upscale(img, 2.0, CFG, params=params, return_conv_map=True,
                          device="cpu")
    ref_out, ref_conv = plain.upscale(torch.tensor(img)[None], "swinir", params, 2.0)
    assert out.shape == (42, 60, 3) and conv.shape == (42, 60)
    assert (out == ref_out[0].numpy()).all()
    assert (conv == ref_conv[0].numpy()).all()


def test_step_scale_and_clips(params):
    """x4 under step-scale is two chained x2 passes; a clip through
    ``upscale_frames`` equals its frames one by one."""
    img = _image(10, 12)
    step = T.SRCNNConfig(model="swinir", step_scale=True)
    x4 = T.upscale(img, 4.0, step, params=params, device="cpu")
    x2x2 = T.upscale(T.upscale(img, 2.0, CFG, params=params, device="cpu"), 2.0, CFG,
                     params=params, device="cpu")
    assert x4.shape == (40, 48, 3)
    assert (x4 == x2x2).all()
    clip = np.stack([img, img[::-1].copy()])
    outs = serve.upscale_frames(clip, 2.0, CFG, params=params, device="cpu")
    for frame, out in zip(clip, outs):
        assert (out == T.upscale(frame, 2.0, CFG, params=params, device="cpu")).all()


@pytest.mark.parametrize("case", ["bfloat16", "bf16_precision", "no_params", "scale_3",
                                  "chunked", "tiled", "tiny"])
def test_refusals(params, case):
    img = _image(16, 16)
    with pytest.raises(ValueError) as e:
        if case == "bfloat16":
            T.upscale(img, 2.0, T.SRCNNConfig(model="swinir", compute_dtype="bfloat16"),
                      params=params, device="cpu")
        elif case == "bf16_precision":
            swinir.forward_lr(params, _plane(16, 16), SPEC, precision="bf16")
        elif case == "no_params":
            T.upscale(img, 2.0, CFG, device="cpu")
        elif case == "scale_3":
            T.upscale(img, 3.0, CFG, params=params, device="cpu")
        elif case == "chunked":
            T.upscale_chunked(img, 2.0, CFG, params=params, band_rows=8, device="cpu")
        elif case == "tiled":
            upscale_tiled(img, params, 2.0, CFG, make_mesh({"row": 2}, ["cpu"] * 2))
        else:
            swinir.forward_lr(params, _plane(4, 12), SPEC)
    want = {"bfloat16": "float32", "bf16_precision": "exact f32",
            "no_params": "pass params", "scale_3": "scale 2 exactly",
            "chunked": "no finite halo", "tiled": "no finite halo",
            "tiny": "reflect pad"}[case]
    assert want in str(e.value)


def test_counters(params):
    """``swinir.windows`` adds each layer's windows; the index and mask are
    built on a size's first call only."""
    swinir._geometry.cache_clear()
    before = profiling.counts_snapshot()
    swinir.forward_lr(params, _plane(21, 30), SPEC)          # padded 24x32: 3x4 windows
    mid = profiling.counts_snapshot()
    swinir.forward_lr(params, _plane(21, 30, seed=3), SPEC)
    after = profiling.counts_snapshot()
    assert mid["swinir.windows"] - before["swinir.windows"] == SPEC.layers * 12
    assert after["swinir.windows"] - mid["swinir.windows"] == SPEC.layers * 12
    assert mid["swinir.masks_built"] - before["swinir.masks_built"] == 1
    assert after["swinir.masks_built"] == mid["swinir.masks_built"]


def test_spans_inside_the_conv_stack(params):
    """One ``sr.swinir.attn`` and one ``sr.swinir.mlp`` per layer, and
    ``sr.swinir.conv`` around the rest, all inside ``sr.conv_stack``."""
    from torch.profiler import ProfilerActivity, profile

    img = torch.tensor(_image(16, 16))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipeline.run_pass(img, params, 2.0, CFG)
    events = [e for e in prof.events() if e.name.startswith("sr.")]
    names = [e.name for e in events]
    assert names.count("sr.swinir.attn") == names.count("sr.swinir.mlp") == SPEC.layers
    assert names.count("sr.swinir.conv") == SPEC.n_groups + 2
    stack = next(e for e in events if e.name == "sr.conv_stack")
    for e in events:
        if e.name.startswith("sr.swinir."):
            assert stack.time_range.start <= e.time_range.start
            assert e.time_range.end <= stack.time_range.end
