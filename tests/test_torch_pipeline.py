"""The port's main path (``upscale`` / the C-style shim) on the CPU vs the
JAX package and vs the reference binary's goldens.

The port's plain convs sum in another order than XLA's, so outputs are
held to <=1 u8 LSB (a truncating cast can flip one step where the f32
values straddle an integer), not bit-equality."""

import os
import subprocess
import sys

import numpy as np
import pytest

import libsrcnn_tpu as J
import libsrcnn_tpu_torch as T
from libsrcnn_tpu_torch import pipeline
from libsrcnn_tpu_torch.eval import psnr, ssim

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "goldens.npz")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lsb(a, b):
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def _image(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("shape,scale,filt,step", [
    ((24, 31, 4), 2.0, 2, False),    # RGBA
    ((26, 22), 2.0, 1, False),       # gray -> RGB
    ((23, 30, 3), 1.37, 3, False),   # fractional, lanczos
    ((40, 36, 3), 0.5, 2, False),    # downscale
    ((17, 19, 3), 4.0, 2, True),     # step-scale x2 x2
    ((17, 19, 3), 2.5, 0, True),     # step-scale x2 then x1.25, nearest
    ((15, 13, 3), 3.0, 4, False),    # bspline
])
def test_upscale_matches_jax(shape, scale, filt, step):
    img = _image(shape, 21)
    jcfg = J.SRCNNConfig(filter=J.FilterType(filt), step_scale=step)
    tcfg = T.SRCNNConfig(filter=T.FilterType(filt), step_scale=step)
    jout, jconv = J.upscale(img, scale, jcfg, return_conv_map=True)
    tout, tconv = T.upscale(img, scale, tcfg, return_conv_map=True, device="cpu")
    assert tout.shape == jout.shape and tout.dtype == np.uint8
    assert _lsb(tout, jout) <= 1
    assert (jconv is None) == (tconv is None)
    if jconv is not None:
        assert _lsb(tconv, jconv) <= 1


def test_step_scale_exact_remainder_has_no_conv_map():
    img = _image((12, 10, 3), 22)
    cfg = T.SRCNNConfig(step_scale=True)
    out, conv = T.upscale(img, 2.0, cfg, return_conv_map=True, device="cpu")
    assert out.shape == (24, 20, 3) and conv is not None
    out, conv = T.upscale(img, 1.0, cfg, return_conv_map=True, device="cpu")
    assert conv is None and np.array_equal(out, img)


@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDENS)


@pytest.mark.parametrize("idx", range(29))
def test_against_reference_binary(goldens, idx):
    key, name, mult, filt, step, _ms = goldens["meta"][idx].split(",")
    img = goldens[f"in_{name}"]
    cfg = T.SRCNNConfig(filter=T.FilterType(int(filt)), step_scale=bool(int(step)))
    out, conv = T.upscale(img, float(mult), cfg, return_conv_map=True,
                          device="cpu")
    gout, gconv = goldens[f"out_{key}"], goldens[f"conv_{key}"]
    assert out.shape == gout.shape and conv.shape == gconv.shape
    d = np.abs(out.astype(int) - gout.astype(int))
    assert d.max() <= 1, f"{key}: max u8 diff {d.max()}"
    assert (d > 0).mean() < 0.02, f"{key}: {100 * (d > 0).mean():.2f}% pixels differ"
    assert ssim(out, gout) >= 0.999
    assert psnr(out, gout) >= 60.0
    assert _lsb(conv, gconv) <= 1


@pytest.mark.parametrize("args", [
    (None, 30, 40, 3, 2.0),
    ("img", 0, 40, 3, 2.0),
    ("img", 30, -40, 3, 2.0),
    ("short", 30, 40, 3, 2.0),
    ("f32", 30, 40, 3, 2.0),
    ("img", 30, 40, 3, -1.0),
    ("img", 30, 40, 3, 0.01),
    ("d2", 30, 40, 2, 2.0),
    ("img", 30, 40, 3, 2.0),
    ("img", 30, 40, 3, 1.5),
], ids=["null", "zero_w", "neg_h", "short", "f32", "neg_scale",
        "empty_out", "depth2", "ok", "ok_frac"])
@pytest.mark.parametrize("step", [False, True], ids=["plain", "step"])
def test_process_srcnn_codes_match_jax(args, step):
    img = _image((40, 30, 3), 23)
    bufs = {None: None, "img": img.tobytes(), "short": img.tobytes()[:-1],
            "f32": img.astype(np.float32), "d2": _image((40, 30, 2), 24)}
    buf, w, h, d, m = bufs[args[0]], *args[1:]
    J.configure_filter_srcnn(2, step)
    T.configure_filter_srcnn(2, step, device="cpu")
    try:
        jrc, jout, jconv = J.process_srcnn(buf, w, h, d, m)
        trc, tout, tconv = T.process_srcnn(buf, w, h, d, m)
    finally:
        J.configure_filter_srcnn(2, False)
        T.configure_filter_srcnn(2, False, device="cpu")
    assert trc == jrc
    assert (tout is None) == (jout is None) and (tconv is None) == (jconv is None)
    if jout is not None:
        assert tout.shape == jout.shape and _lsb(tout, jout) <= 1
        assert _lsb(tconv, jconv) <= 1


def test_process_srcnn_step_scale_unit_multiply():
    img = _image((8, 8, 3), 25)
    T.configure_filter_srcnn(2, True, device="cpu")
    try:
        assert T.process_srcnn(img.tobytes(), 8, 8, 3, 1.0) == (-100, None, None)
    finally:
        T.configure_filter_srcnn(2, False, device="cpu")


@pytest.mark.parametrize("cfg,item", [
    (dict(model="fsrcnn"), "M9"),
    (dict(model="vdsr"), "M9"),
])
def test_unported_options_raise(cfg, item):
    """The zoo's families raised NotImplementedError until ROADMAP ``item``
    ported them; now they run (tests/test_torch_zoo*.py hold them against
    the JAX package)."""
    out = T.upscale(_image((8, 8, 3), 26), 2.0, T.SRCNNConfig(**cfg), device="cpu")
    assert out.shape == (16, 16, 3) and out.dtype == np.uint8


def test_rejects_what_jax_rejects():
    img = _image((8, 8, 3), 27)
    with pytest.raises(ValueError):
        T.upscale(img, 2.0, T.SRCNNConfig(compute_dtype="float16"), device="cpu")
    with pytest.raises(ValueError):
        T.upscale(img, 2.0, T.SRCNNConfig(model="nope"), device="cpu")
    with pytest.raises(ValueError):
        T.upscale(img, 0.0, device="cpu")
    with pytest.raises(TypeError):
        T.upscale(img.astype(np.float32), 2.0, device="cpu")


def test_no_cpu_stand_in_for_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = _image((8, 8, 3), 28)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.upscale(img, 2.0, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.configure_filter_srcnn(2, device="cuda")
    with pytest.raises(ValueError, match="use_kernel=True"):
        T.upscale(img, 2.0, T.SRCNNConfig(use_kernel=True), device="cpu")
    assert pipeline.resolve_kernel(None, torch.device("cpu")) is False
    assert pipeline.resolve_kernel(None, torch.device("cuda")) is True


def test_import_leaves_jax_out():
    code = ("import sys, libsrcnn_tpu_torch, libsrcnn_tpu_torch.kernels.fused_conv, "
            "libsrcnn_tpu_torch.kernels._build, libsrcnn_tpu_torch.eval, "
            "libsrcnn_tpu_torch.serve; "
            "from libsrcnn_tpu_torch.models import srcnn, srcnn_int8; "
            "srcnn.load_params(); srcnn_int8.load_params(); "
            "libsrcnn_tpu_torch.upscale_chunked; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'libsrcnn_tpu' not in sys.modules, 'libsrcnn_tpu imported'")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# --- the shim's allocation-failure codes (tests/test_api.py:177-214) ---------


@pytest.mark.parametrize("exc", [MemoryError("host allocation failed"), "cuda_oom"],
                         ids=["host", "device"])
def test_process_srcnn_alloc_failure_is_minus_11(monkeypatch, exc):
    """Reference parity: an output-buffer allocation failure returns -11
    (`libsrcnn.cpp:883`), on the host or on the card."""
    import torch
    from libsrcnn_tpu_torch import api

    if exc == "cuda_oom":
        exc = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 1 TiB")

    def oom(*a, **k):
        raise exc

    monkeypatch.setattr(api, "upscale", oom)
    img = _image((20, 24, 3), 29)
    assert T.process_srcnn(img.tobytes(), 24, 20, 3, 2.0) == (-11, None, None)


def test_process_srcnn_conv_alloc_failure_is_minus_12(monkeypatch):
    """Reference parity: a conv-map buffer allocation failure returns -12
    and KEEPS the output buffer (`libsrcnn.cpp:895-912`)."""
    from libsrcnn_tpu_torch import api

    img = _image((20, 24, 3), 30)
    real_out = T.upscale(img, 2.0, device="cpu")

    class FailingConv:
        def ravel(self):
            raise MemoryError("conv buffer allocation failed")

    monkeypatch.setattr(api, "upscale", lambda *a, **k: (real_out, FailingConv()))
    rc, out, conv = T.process_srcnn(img.tobytes(), 24, 20, 3, 2.0)
    assert rc == -12 and conv is None
    np.testing.assert_array_equal(out, real_out.ravel())


def test_process_srcnn_other_errors_propagate(monkeypatch):
    """Only allocation failures map to codes; other errors stay exceptions."""
    from libsrcnn_tpu_torch import api

    def boom(*a, **k):
        raise RuntimeError("not an allocation failure")

    monkeypatch.setattr(api, "upscale", boom)
    img = _image((20, 24, 3), 31)
    with pytest.raises(RuntimeError, match="not an allocation"):
        T.process_srcnn(img.tobytes(), 24, 20, 3, 2.0)


# --- SRCNNConfig takes every field of the JAX package's ----------------------

#: the port's one rename of a JAX config field (the TPU's Pallas kernel is
#: the card's CUDA kernel here)
RENAMED = {"use_pallas": "use_kernel"}


def test_config_has_every_jax_field():
    import dataclasses

    jfields = {RENAMED.get(f.name, f.name): f.default for f in dataclasses.fields(J.SRCNNConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(T.SRCNNConfig)}
    assert tfields.keys() == jfields.keys()
    assert tfields["lane_pack"] is None and jfields["lane_pack"] is None


@pytest.mark.parametrize("lane_pack", [None, False, True])
def test_config_built_for_jax_runs_in_the_port(lane_pack):
    """A config written with every JAX field (use_pallas under its port
    name) builds in the port; for srcnn lane_pack changes nothing."""
    kw = dict(filter=2, step_scale=False, compute_dtype="float32", self_ensemble=False,
              emit_conv_map=False, use_pallas=None, model="srcnn", lane_pack=lane_pack)
    jcfg = J.SRCNNConfig(**kw)
    tcfg = T.SRCNNConfig(**{RENAMED.get(k, k): v for k, v in kw.items()})
    assert tcfg.lane_pack is lane_pack
    img = _image((21, 18, 3), 32)
    tout = T.upscale(img, 2.0, tcfg, device="cpu")
    np.testing.assert_array_equal(tout, T.upscale(img, 2.0, device="cpu"))
    assert _lsb(tout, J.upscale(img, 2.0, jcfg)) <= 1


def test_chunked_refuses_lane_pack_as_jax_does():
    img = _image((24, 20, 3), 33)
    with pytest.raises(ValueError, match="lane_pack"):
        J.upscale_chunked(img, 2.0, J.SRCNNConfig(lane_pack=True), band_rows=16)
    with pytest.raises(ValueError, match="lane_pack"):
        T.upscale_chunked(img, 2.0, T.SRCNNConfig(lane_pack=True), band_rows=16,
                          device="cpu")
    out, _ = T.upscale_chunked(img, 2.0, T.SRCNNConfig(lane_pack=False), band_rows=16,
                               device="cpu")
    np.testing.assert_array_equal(out, T.upscale(img, 2.0, device="cpu"))
