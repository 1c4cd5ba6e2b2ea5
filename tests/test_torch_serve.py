"""The port's bf16 tiers end to end, its serving layer (``serve``) and the
flip self-ensemble, on the CPU, vs the JAX package.

On the CPU both packages run the plain convs (the JAX package's XLA path),
which sum in other orders, so outputs are held to <=1 u8 LSB.  Within the
port, the batched and streaming paths are bit-identical to ``upscale`` per
frame.  Inputs come from ``tests/goldens/goldens.npz``."""

import os
import threading
from collections import deque

import numpy as np
import pytest
import torch

import libsrcnn_tpu as J
import libsrcnn_tpu.serve as jserve
import libsrcnn_tpu_torch as T
from libsrcnn_tpu_torch import pipeline, serve

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "goldens.npz")
TIERS = ("float32", "bfloat16", "bfloat16_fast")


def _lsb(a, b):
    return int(np.abs(a.astype(int) - b.astype(int)).max())


@pytest.fixture(scope="module")
def butterfly():
    with np.load(GOLDENS) as z:
        return z["in_butterfly_full"][64:192, 64:192]   # 128x128 RGB


@pytest.fixture(scope="module")
def clip(butterfly):
    return np.stack([butterfly[:32, :40], butterfly[32:64, :40],
                     butterfly[64:96, 40:80]])


@pytest.mark.parametrize("tier", ["bfloat16", "bfloat16_fast"])
@pytest.mark.parametrize("crop,scale,filt,step", [
    ((0, 40, 0, 36), 2.0, 2, False),
    ((10, 33, 5, 30), 1.37, 3, False),
    ((0, 24, 0, 20), 4.0, 2, True),
    ((40, 80, 40, 76), 0.5, 1, False),
])
def test_bf16_tiers_match_jax(butterfly, tier, crop, scale, filt, step):
    """upscale at each bf16 tier vs the JAX package's CPU (XLA) path."""
    r0, r1, c0, c1 = crop
    img = np.ascontiguousarray(butterfly[r0:r1, c0:c1])
    jcfg = J.SRCNNConfig(compute_dtype=tier, filter=J.FilterType(filt),
                         step_scale=step)
    tcfg = T.SRCNNConfig(compute_dtype=tier, filter=T.FilterType(filt),
                         step_scale=step)
    jout, jconv = J.upscale(img, scale, jcfg, return_conv_map=True)
    tout, tconv = T.upscale(img, scale, tcfg, return_conv_map=True, device="cpu")
    assert tout.shape == jout.shape and _lsb(tout, jout) <= 1
    assert (tconv is None) == (jconv is None)
    if jconv is not None:
        assert _lsb(tconv, jconv) <= 1


@pytest.mark.parametrize("tier", TIERS)
def test_upscale_frames_matches_jax_and_single(clip, tier):
    cfg = T.SRCNNConfig(compute_dtype=tier)
    out = T.upscale_frames(clip, 2.0, cfg, device="cpu")
    assert out.shape == (3, 64, 80, 3) and out.dtype == np.uint8
    jout = jserve.upscale_frames(clip, 2.0, J.SRCNNConfig(compute_dtype=tier))
    assert _lsb(out, np.asarray(jout)) <= 1
    for f, o in zip(clip, out):
        np.testing.assert_array_equal(o, T.upscale(f, 2.0, cfg, device="cpu"))


@pytest.mark.parametrize("tier", TIERS)
def test_ensemble_matches_jax(butterfly, tier):
    img = np.ascontiguousarray(butterfly[:30, :36])
    jcfg = J.SRCNNConfig(compute_dtype=tier, self_ensemble=True)
    tcfg = T.SRCNNConfig(compute_dtype=tier, self_ensemble=True)
    jout, jconv = J.upscale(img, 2.0, jcfg, return_conv_map=True)
    tout, tconv = T.upscale(img, 2.0, tcfg, return_conv_map=True, device="cpu")
    assert tout.shape == (60, 72, 3) and _lsb(tout, jout) <= 1
    assert _lsb(tconv, jconv) <= 1
    # the batched ensemble of a clip holding the frame is the same pass
    frames = T.upscale_frames(img[None], 2.0, tcfg, device="cpu")
    np.testing.assert_array_equal(frames[0], tout)
    # and it is not the plain pass
    assert not np.array_equal(
        tout, T.upscale(img, 2.0, T.SRCNNConfig(compute_dtype=tier),
                        device="cpu"))


@pytest.mark.parametrize("scale", [4.0, 2.5])
def test_ensemble_step_scale_matches_jax(butterfly, scale):
    img = np.ascontiguousarray(butterfly[:17, :19])
    jcfg = J.SRCNNConfig(step_scale=True, self_ensemble=True)
    tcfg = T.SRCNNConfig(step_scale=True, self_ensemble=True)
    jout, jconv = J.upscale(img, scale, jcfg, return_conv_map=True)
    tout, tconv = T.upscale(img, scale, tcfg, return_conv_map=True, device="cpu")
    assert tout.shape == jout.shape and _lsb(tout, jout) <= 1
    assert _lsb(tconv, jconv) <= 1


def test_ensemble_degenerate_chain_has_no_conv_map(butterfly):
    img = np.ascontiguousarray(butterfly[:12, :10])
    cfg = T.SRCNNConfig(step_scale=True, self_ensemble=True)
    out, conv = T.upscale(img, 1.0, cfg, return_conv_map=True, device="cpu")
    jout, jconv = J.upscale(img, 1.0, J.SRCNNConfig(step_scale=True,
                                                    self_ensemble=True),
                            return_conv_map=True)
    assert conv is None and jconv is None
    np.testing.assert_array_equal(out, jout)


def test_ensemble_rounds_ties_to_even(monkeypatch):
    """The f32 mean of four u8 values lands on quarter steps; the u8
    result rounds half to even like jnp.round / np.rint."""
    calls = {"n": 0}

    def fake(x, params, scale, cfg):
        calls["n"] += 1
        n = x.shape[0]
        # constant planes per flip variant: the output's average 1.75, the
        # conv map's 2.5 (a tie: half-to-even gives 2, half-up 3)
        vals = torch.tensor([1, 2, 2, 2], dtype=torch.uint8).repeat(n // 4)
        out = vals.view(-1, 1, 1, 1).expand(n, 2, 2, 3).contiguous()
        cvals = torch.tensor([2, 3, 2, 3], dtype=torch.uint8).repeat(n // 4)
        conv = cvals.view(-1, 1, 1).expand(n, 2, 2).contiguous()
        return out, conv

    monkeypatch.setattr(pipeline, "run_pass", fake)
    out, conv = serve._ensemble_pass(torch.zeros(2, 2, 2, 3, dtype=torch.uint8),
                                     {}, 2.0, T.SRCNNConfig())
    assert calls["n"] == 1                       # one batched pass of 4N
    assert out.shape == (2, 2, 2, 3) and bool((out == 2).all())   # 1.75 -> 2
    assert bool((conv == 2).all())               # 2.5 -> 2 (even)


def test_serving_rejects_step_scale_and_mesh(clip):
    with pytest.raises(ValueError, match="step_scale"):
        T.upscale_frames(clip, 2.0, T.SRCNNConfig(step_scale=True), device="cpu")
    with pytest.raises(ValueError, match="step_scale"):
        T.VideoUpscaler(2.0, T.SRCNNConfig(step_scale=True), device="cpu")
    with pytest.raises(NotImplementedError, match="M14"):
        T.upscale_frames(clip, 2.0, mesh=object(), device="cpu")
    out = T.upscale_frames(clip, 2.0, T.SRCNNConfig(model="fsrcnn"),
                           device="cpu")                   # the zoo runs (M9)
    assert out.shape == (3, 64, 80, 3)
    with pytest.raises(TypeError):
        T.upscale_frames(clip.astype(np.float32), 2.0, device="cpu")
    with pytest.raises(ValueError):
        T.upscale_frames(clip[0], 2.0, device="cpu")


@pytest.mark.parametrize("tier", TIERS)
def test_video_stream_matches_single(butterfly, tier):
    cfg = T.SRCNNConfig(compute_dtype=tier)
    frames = [butterfly[i:i + 24, :28] for i in range(0, 72, 24)]
    up = T.VideoUpscaler(scale=2.0, config=cfg, device="cpu")
    outs = list(up.stream(iter(frames)))
    assert len(outs) == 3
    for f, o in zip(frames, outs):
        np.testing.assert_array_equal(o, T.upscale(f, 2.0, cfg, device="cpu"))


def test_video_stream_ensemble(butterfly):
    cfg = T.SRCNNConfig(compute_dtype="bfloat16_fast", self_ensemble=True)
    frames = [butterfly[:20, :24], butterfly[20:40, :24]]
    outs = list(T.VideoUpscaler(2.0, cfg, device="cpu").stream(frames))
    for f, o in zip(frames, outs):
        np.testing.assert_array_equal(o, T.upscale(f, 2.0, cfg, device="cpu"))


class _Ring:
    """A Python ring with the native FrameRing's pop() / len() surface."""

    def __init__(self):
        self._q = deque()
        self._lock = threading.Lock()

    def push(self, buf):
        with self._lock:
            self._q.append(np.frombuffer(buf.tobytes(), np.uint8))

    def pop(self):
        with self._lock:
            return self._q.popleft() if self._q else None

    def __len__(self):
        with self._lock:
            return len(self._q)


def test_video_stream_from_ring(butterfly):
    frame = np.ascontiguousarray(butterfly[:16, :16])
    ring = _Ring()
    done = threading.Event()

    def producer():
        for _ in range(5):
            ring.push(frame)
        done.set()

    t = threading.Thread(target=producer)
    t.start()
    up = T.VideoUpscaler(scale=2.0, device="cpu")
    outs = list(up.stream_from_ring(ring, frame.shape, stop=done.is_set))
    t.join()
    assert len(outs) == 5
    for o in outs:
        np.testing.assert_array_equal(o, T.upscale(frame, 2.0, device="cpu"))


def test_stream_retries_accelerator_errors(butterfly, monkeypatch):
    up = T.VideoUpscaler(scale=2.0, device="cpu")
    up.retry_backoff_s = 0.0
    real = pipeline.run_pass
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.AcceleratorError("transient device error")
        return real(*a, **kw)

    monkeypatch.setattr(pipeline, "run_pass", flaky)
    outs = list(up.stream(iter([butterfly[:16, :16]])))
    assert len(outs) == 1 and calls["n"] == 2


def test_stream_retry_exhaustion_propagates(butterfly, monkeypatch):
    up = T.VideoUpscaler(scale=2.0, device="cpu")
    up.retry_backoff_s = 0.0
    calls = {"n": 0}

    def dead(*a, **kw):
        calls["n"] += 1
        raise torch.AcceleratorError("device gone")

    monkeypatch.setattr(pipeline, "run_pass", dead)
    with pytest.raises(torch.AcceleratorError, match="device gone"):
        list(up.stream(iter([butterfly[:16, :16]])))
    assert calls["n"] == up.max_retries + 1


@pytest.mark.parametrize("exc", [NotImplementedError, ValueError])
def test_stream_does_not_retry_deterministic_errors(butterfly, monkeypatch, exc):
    up = T.VideoUpscaler(scale=2.0, device="cpu")
    up.retry_backoff_s = 0.0
    calls = {"n": 0}

    def broken(*a, **kw):
        calls["n"] += 1
        raise exc("not a device error")

    monkeypatch.setattr(pipeline, "run_pass", broken)
    with pytest.raises(exc):
        list(up.stream(iter([butterfly[:16, :16]])))
    assert calls["n"] == 1


def test_stream_retries_failure_at_fetch(butterfly, monkeypatch):
    """A failure that surfaces only when the result is fetched re-runs the
    frame synchronously through the retry loop."""
    up = T.VideoUpscaler(scale=2.0, device="cpu")
    real = pipeline.run_pass
    calls = {"n": 0}

    class Poisoned:
        def cpu(self):
            raise torch.AcceleratorError("execution failed")

    def first_poisoned(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            return Poisoned(), None
        return real(*a, **kw)

    monkeypatch.setattr(pipeline, "run_pass", first_poisoned)
    frame = butterfly[:16, :16]
    outs = list(up.stream(iter([frame])))
    assert calls["n"] == 2
    monkeypatch.setattr(pipeline, "run_pass", real)
    np.testing.assert_array_equal(outs[0], T.upscale(frame, 2.0, device="cpu"))
