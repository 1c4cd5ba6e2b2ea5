"""The port's spans and counters (``utils.profiling``): under a profiler a
still request and a pass emit exactly the documented ``sr.*`` spans,
nested and in order; without one a span is the one shared null context;
the counters count each copy, table, pack and library once.  The
``cuda``-marked cases need an NVIDIA GPU and skip without one: the copy
counts, the pack per launch and every kernel of a pass put down to a
span.

This file imports no jax; on a machine without it:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -q
"""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import libsrcnn_tpu_torch as lt
from libsrcnn_tpu_torch import api, pipeline, serve
from libsrcnn_tpu_torch.kernels import fused_conv
from libsrcnn_tpu_torch.models import srcnn, srcnn_int8
from libsrcnn_tpu_torch.ops import resize
from libsrcnn_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "libsrcnn_tpu_torch")
#: model -> the resizes of one RGB pass: the two chroma planes, and the Y
#: plane unless an LR family's head upscales it
MODELS = {"srcnn": 3, "vdsr": 3, "fsrcnn": 2}
PASS = "sr.pipeline.pass"


def _image(shape, seed=5):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _spans(prof) -> list:
    """The profile's ``sr.*`` ranges as a tree: ``[name, [children]]`` in
    the order they opened, nested by time."""
    events = sorted((e for e in prof.events() if e.name.startswith("sr.")),
                    key=lambda e: (e.time_range.start, -e.time_range.end))
    roots, stack = [], []
    for e in events:
        while stack and e.time_range.start >= stack[-1][0].time_range.end:
            stack.pop()
        node = [e.name, []]
        (stack[-1][1][1] if stack else roots).append(node)
        stack.append((e, node))
    return roots


def _pass_tree(model: str) -> list:
    return [PASS, [["sr.color.split", []]] + [["sr.resize", []]] * MODELS[model] +
            [["sr.conv_stack", []], ["sr.color.merge", []]]]


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof)


@pytest.mark.parametrize("model", list(MODELS))
def test_still_request_emits_its_spans(model):
    cfg = lt.SRCNNConfig(model=model)
    img = _image((10, 12, 3))
    tree = _traced(lambda: api.upscale(img, 2.0, cfg, device="cpu"))
    assert tree == [["sr.api.upscale", [["sr.api.params", []], ["sr.api.upload", []],
                                        _pass_tree(model),
                                        ["sr.api.download", []]]]]


@pytest.mark.parametrize("model", list(MODELS))
def test_clip_pass_emits_its_spans(model):
    cfg = lt.SRCNNConfig(model=model)
    params = pipeline.load_model_params(cfg, 2.0, "cpu")
    clip = torch.from_numpy(_image((2, 8, 10, 3)))
    tree = _traced(lambda: pipeline.run_pass(clip, params, 2.0, cfg))
    assert tree == [_pass_tree(model)]


def test_serving_emits_its_spans():
    clip = _image((2, 8, 10, 3))
    tree = _traced(lambda: serve.upscale_frames(clip, 2.0, device="cpu"))
    assert [n for n, _ in tree] == ["sr.api.params", "sr.serve.upload", PASS,
                                    "sr.serve.download"]
    up = serve.VideoUpscaler(2.0, device="cpu")
    tree = _traced(lambda: list(up.stream(iter(clip))))
    assert [n for n, _ in tree] == ["sr.serve.upload", PASS] * 2 + [
        "sr.serve.download"] * 2


def test_every_span_is_listed():
    """The span names the program's modules hold are exactly
    :data:`profiling.SPANS`."""
    named = set()
    for d, _, files in os.walk(PACKAGE):
        for f in files:
            path = os.path.join(d, f)
            if f.endswith(".py") and path != profiling.__file__:
                with open(path) as fh:
                    named |= set(re.findall(r'"(sr\.[\w.]+)"', fh.read()))
    assert named == set(profiling.SPANS)
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) made with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("sr.resize") is profiling.NO_SPAN
    assert profiling.span("sr.conv_stack") is profiling.NO_SPAN
    api.upscale(_image((6, 6, 3)), 2.0, device="cpu")     # no span is made
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("sr.resize") is not profiling.NO_SPAN


def _tables_missed() -> int:
    return resize._band_stack.cache_info().misses


@pytest.mark.parametrize("shape,scale", [((9, 11, 3), 2.0), ((9, 11, 4), 1.5),
                                         ((8, 8, 3), 1.0)])
def test_tables_built_counts_each_new_table_once(shape, scale):
    resize._band_stack.cache_clear()
    img = _image(shape)
    before = profiling.counts["resize.tables_built"]
    api.upscale(img, scale, device="cpu")
    built = profiling.counts["resize.tables_built"] - before
    assert built == _tables_missed()
    assert built > 0 or scale == 1.0
    api.upscale(img, scale, device="cpu")
    assert profiling.counts["resize.tables_built"] - before == built


@pytest.mark.parametrize("tier", ["float32", "int8"])
def test_each_pack_counts_once(tier):
    if tier == "int8":
        params, pack = srcnn_int8.load_params("cpu"), fused_conv.pack_int8_params
    else:
        params, pack = srcnn.load_params("cpu"), fused_conv.pack_params
    before = profiling.counts["kernels.packs"]
    pack(params)
    pack(params)
    assert profiling.counts["kernels.packs"] - before == 2


def test_copies_on_the_cpu_count_nothing():
    before = profiling.counts_snapshot()
    api.upscale(_image((6, 7, 3)), 2.0, device="cpu", return_conv_map=True)
    serve.upscale_frames(_image((2, 6, 7, 3)), 2.0, device="cpu")
    after = profiling.counts_snapshot()
    for key in ("copy.h2d_bytes", "copy.d2h_bytes", "kernels.packs"):
        assert after[key] == before[key], key


def test_snapshot_holds_the_launches_and_is_a_copy():
    snap = profiling.counts_snapshot()
    for kernel, n in fused_conv.launches_by.items():
        assert snap[f"kernels.launch.{kernel}"] == n
    snap["copy.h2d_bytes"] += 10 ** 9
    assert profiling.counts["copy.h2d_bytes"] < 10 ** 9
    assert not any(k.startswith("kernels.launch.") for k in profiling.counts)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("want_conv", [False, True])
def test_copy_bytes_of_a_still_on_the_card(cuda, want_conv):
    """The still goes up once; the output and the conv map come down,
    the conv map whether or not the caller asked for it."""
    h, w = 40, 52
    img = _image((h, w, 3))
    api.upscale(img, 2.0, device=cuda)                      # warm
    before = profiling.counts_snapshot()
    api.upscale(img, 2.0, return_conv_map=want_conv, device=cuda)
    after = profiling.counts_snapshot()
    assert after["copy.h2d_bytes"] - before["copy.h2d_bytes"] == h * w * 3
    assert after["copy.d2h_bytes"] - before["copy.d2h_bytes"] == 4 * h * w * (3 + 1)
    assert after["resize.tables_built"] == before["resize.tables_built"]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["exact", "bf16x1"])
def test_one_pack_per_forward_y(cuda, precision):
    params = srcnn.load_params(cuda)
    y = torch.rand(2, 20 + 2 * fused_conv.HALO, 24 + 2 * fused_conv.HALO,
                   device=cuda) * 255
    fused_conv.forward_y(params, y, 20, 24, precision=precision)   # loads the library
    before = profiling.counts_snapshot()
    for _ in range(3):
        fused_conv.forward_y(params, y, 20, 24, precision=precision)
    after = profiling.counts_snapshot()
    kernel = fused_conv.kernel_for(precision)
    assert after["kernels.packs"] - before["kernels.packs"] == 3
    assert after[f"kernels.launch.{kernel}"] - before[f"kernels.launch.{kernel}"] == 3
    assert after["kernels.libs_loaded"] == before["kernels.libs_loaded"]


@pytest.mark.cuda
@pytest.mark.parametrize("model,tier", [("srcnn", "float32"),
                                        ("srcnn", "bfloat16_fast"),
                                        ("vdsr", "float32")])
def test_every_kernel_of_a_pass_has_a_span(cuda, model, tier, tmp_path):
    sys.path.insert(0, ROOT)
    from perfbench import spans

    cfg = lt.SRCNNConfig(model=model, compute_dtype=tier)
    params = pipeline.load_model_params(cfg, 2.0, cuda)
    clip = torch.from_numpy(_image((2, 30, 44, 3))).to(cuda)
    pipeline.run_pass(clip, params, 2.0, cfg)               # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipeline.run_pass(clip, params, 2.0, cfg)
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        acts = spans.attribute(json.load(f)["traceEvents"])
    kernels = [a for a in acts if a[0] == "kernel"]
    assert kernels
    assert [a[1] for a in kernels if a[4] is None] == []
    by = {a[4] for a in kernels}
    assert {"sr.color.split", "sr.resize", "sr.conv_stack", "sr.color.merge"} <= by
    assert by <= set(profiling.SPANS) - {PASS}
