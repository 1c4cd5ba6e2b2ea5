"""The port's native host library (``libsrcnn_tpu_torch.io.native``, built
at first use from the port's own copy of native/srcnn_host.cpp) against the port's torch / numpy
ops and the JAX package's color and table ops, its FrameRing, and the ring
feeding ``VideoUpscaler.stream_from_ring`` on the CPU.  The JAX package's
own native module is left alone: it runs ``make`` in native/ when its
library is missing, which tests/test_native.py may be doing at the same
time in another worker."""

import os
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libsrcnn_tpu.ops.color as jcolor
import libsrcnn_tpu.ops.weights_table as jtable
import libsrcnn_tpu_torch as T
from libsrcnn_tpu_torch.config import FilterType
from libsrcnn_tpu_torch.io import native
from libsrcnn_tpu_torch.ops import color
from libsrcnn_tpu_torch.ops.weights_table import contribution_table as py_table

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "goldens.npz")


def test_builds_from_source_into_build_dir():
    """The library is the port's own build of its copy of native/srcnn_host.cpp (never
    the binary in native/), keyed by a hash of the source and flags."""
    assert native.available(), native.build_error
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path).endswith(os.path.join("kernels", "_build"))
    assert "-march=native" not in native.CXX_FLAGS
    assert native._lib()._name == path


def test_source_is_a_copy_of_the_jax_side():
    """The port builds from a copy inside its own package (shipped as
    package data), byte-equal to the JAX side's native/srcnn_host.cpp."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert native.SOURCE == os.path.join(os.path.dirname(os.path.abspath(native.__file__)),
                                         "csrc", "srcnn_host.cpp")
    with open(native.SOURCE, "rb") as a, \
            open(os.path.join(root, "native", "srcnn_host.cpp"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("depth", [3, 4])
def test_color_pack_exact(depth):
    img = np.random.default_rng(20 + depth).integers(0, 256, (21, 17, depth), np.uint8)
    got = native.rgb_to_ycbcr(img)
    np.testing.assert_array_equal(got, color.rgb_to_ycbcr(torch.tensor(img)).numpy())
    back = native.ycbcr_to_rgb(got)
    np.testing.assert_array_equal(back, color.ycbcr_to_rgb(torch.tensor(got)).numpy())
    np.testing.assert_array_equal(got, np.asarray(jcolor.rgb_to_ycbcr(jnp.asarray(img))))
    np.testing.assert_array_equal(back, np.asarray(jcolor.ycbcr_to_rgb(jnp.asarray(got))))


@pytest.mark.parametrize("ft", list(FilterType))
def test_contribution_tables_exact(ft):
    for dst, src in [(64, 32), (48, 64), (96, 33), (10, 100)]:
        l1, w1 = native.contribution_table(int(ft), dst, src)
        l2, w2 = py_table(ft, dst, src)
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_allclose(w1, w2, atol=1e-15)
        l3, w3 = jtable.contribution_table(ft, dst, src)
        np.testing.assert_array_equal(l1, l3)
        np.testing.assert_allclose(w1, w3, atol=1e-15)


def test_frame_ring_basic():
    ring = native.FrameRing(256, 4)
    assert len(ring) == 0 and ring.pop() is None
    assert ring.push(np.arange(100, dtype=np.uint8))
    assert len(ring) == 1
    out = ring.pop()
    np.testing.assert_array_equal(out, np.arange(100, dtype=np.uint8))
    ring.close()


def test_frame_ring_full_and_oversize():
    for bad in ((0, 2), (64, 0)):
        with pytest.raises(ValueError, match="FrameRing needs"):
            native.FrameRing(*bad)
    ring = native.FrameRing(64, 2)
    assert not ring.push(np.zeros(100, np.uint8))  # oversize
    assert ring.push(np.zeros(10, np.uint8))
    assert ring.push(np.zeros(10, np.uint8))
    assert not ring.push(np.zeros(10, np.uint8))  # full
    ring.close()


def test_frame_ring_threaded():
    """SPSC contract: one producer thread, one consumer thread."""
    ring = native.FrameRing(128, 8)
    n = 200
    got = []

    def producer():
        i = 0
        while i < n:
            if ring.push(np.full((16,), i % 256, np.uint8)):
                i += 1

    t = threading.Thread(target=producer)
    t.start()
    while len(got) < n:
        f = ring.pop()
        if f is not None:
            got.append(int(f[0]))
    t.join(timeout=60)
    assert not t.is_alive()
    assert got == [i % 256 for i in range(n)]
    ring.close()


def test_stream_from_native_ring_matches_upscale():
    """A producer thread pushes 6 frames through the port's FrameRing (3
    slots, so it waits on a full ring); VideoUpscaler.stream_from_ring
    yields each frame's ``upscale`` bit for bit, in order."""
    with np.load(GOLDENS) as z:
        bf = z["in_butterfly_full"]
    frames = [np.ascontiguousarray(bf[16 * i:16 * i + 16, 20:40]) for i in range(6)]
    ring = native.FrameRing(frames[0].nbytes, 3)
    done = threading.Event()

    def producer():
        for f in frames:
            while not ring.push(f):
                time.sleep(0.001)
        done.set()

    t = threading.Thread(target=producer)
    t.start()
    up = T.VideoUpscaler(scale=2.0, device="cpu")
    outs = list(up.stream_from_ring(ring, frames[0].shape, stop=done.is_set))
    t.join(timeout=60)
    assert not t.is_alive()
    ring.close()
    assert len(outs) == len(frames)
    for o, f in zip(outs, frames):
        np.testing.assert_array_equal(o, T.upscale(f, 2.0, device="cpu"))


def test_unavailable_library_raises(monkeypatch, tmp_path):
    """When the build fails (here: no source), available() is False and
    every entry point raises; nothing else is loaded in its place."""
    monkeypatch.setattr(native, "SOURCE", str(tmp_path / "missing.cpp"))
    native._lib.cache_clear()
    try:
        assert not native.available()
        assert "missing.cpp" in native.build_error
        with pytest.raises(RuntimeError, match="native library unavailable"):
            native.FrameRing(64, 2)
        with pytest.raises(RuntimeError, match="native host library unavailable"):
            native.rgb_to_ycbcr(np.zeros((2, 2, 3), np.uint8))
    finally:
        monkeypatch.undo()
        native._lib.cache_clear()
    assert native.available()
