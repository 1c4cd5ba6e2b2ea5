"""The band-resample kernel (``kernels/resample.py``, ``csrc/resample.cu``)
against the resize's plain version, ``ops.resize`` on the CPU.

The CPU cases hold what surrounds the kernel: a CPU plane never reaches
it, its stacked tables hold the band table and a same-size axis is the
replicate-padded copy, its wrapper refuses what it does not take, and its symbols are not taken for
the conv stack's.  The ``cuda`` cases skip without a card and compare the
kernel with the plain version bit for bit (the f32 bits, not a
tolerance): every filter, up, down and non-integer factors, one axis, the
same-size axis, the padded halo, batches, one-row and one-column planes,
a 1080p-like odd size, and the chunked and tiled paths' own band taps.
This file imports no jax; on a card:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_resample.py -q
"""

import glob
import json
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from libsrcnn_tpu_torch import api, chunked
from libsrcnn_tpu_torch.config import FilterType
from libsrcnn_tpu_torch.kernels import _build, resample
from libsrcnn_tpu_torch.ops import resize
from libsrcnn_tpu_torch.parallel import tiled
from libsrcnn_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILTERS = list(FilterType)
FACTORS = [2.0, 1.7, 0.5, 0.25]


def _plane(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 255, shape).astype(np.float32))


def _size(n, f):
    return max(1, int(n * f))


def _assert_bits_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    got, want = got.cpu().view(torch.int32), want.cpu().view(torch.int32)
    n = int((got != want).sum())
    assert n == 0, f"{n} of {got.numel()} values differ in their bits"


# --- CPU --------------------------------------------------------------------

def test_cpu_planes_never_reach_the_kernel(monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU plane reached the resample kernel")

    monkeypatch.setattr(resample, "resample", refuse)
    before = resample.launches
    plane = _plane((2, 13, 17), 0)
    resize.resize_plane(plane, 26, 34, FilterType.BICUBIC)
    resize.resize_plane(plane, 9, 40, FilterType.LANCZOS3)
    resize.resize_plane_padded(plane, 26, 17, FilterType.BILINEAR, 6, 38, 29)
    resize._resize_axis(plane, 5, FilterType.NEAREST, 1)
    api.upscale(np.zeros((7, 9, 3), np.uint8), 2.0, device="cpu")
    assert resample.launches == before


def test_snapshot_shows_the_resample_launches():
    snap = profiling.counts_snapshot()
    assert snap["kernels.launch.resample"] == resample.launches
    assert "kernels.launch.resample" not in profiling.counts


# (dst, src, pad_lo, out): up, non-integer up, down by 2 and 4, the halo
AXES = [(46, 23, 0, 46), (39, 23, 0, 39), (12, 24, 0, 12), (9, 37, 0, 9),
        (46, 23, 6, 58), (12, 24, 6, 24), (1, 5, 0, 1), (5, 1, 6, 17)]


@pytest.mark.parametrize("ft", FILTERS, ids=lambda f: f.name)
@pytest.mark.parametrize("axis", AXES, ids=lambda a: "-".join(map(str, a)))
def test_stacked_tables_hold_the_band_table(ft, axis):
    dst, src, pad_lo, out = axis
    cpu = torch.device("cpu")
    idx, w = resize._band_stack(ft, dst, src, pad_lo, out, cpu)
    want_idx, want_w = resize._band_table(ft, dst, src, pad_lo, out)
    assert idx.dtype == torch.int32 and w.dtype == torch.float32
    assert idx.shape == w.shape == (want_idx.shape[1], out)
    assert idx.is_contiguous() and w.is_contiguous()
    assert np.array_equal(idx.numpy(), want_idx.T)
    _assert_bits_equal(w, torch.from_numpy(np.ascontiguousarray(want_w.T)))
    assert int(idx.min()) >= 0 and int(idx.max()) < src


@pytest.mark.parametrize("src,pad_lo,out", [(7, 0, 7), (7, 6, 19), (1, 6, 13)])
def test_same_size_axis_is_the_replicate_padded_copy(src, pad_lo, out):
    idx, w = resize._band_stack(None, src, src, pad_lo, out, torch.device("cpu"))
    assert w is None and idx.dtype == torch.int32 and idx.shape == (1, out)
    plane = _plane((2, src, 5), 3)
    pad_hi = out - pad_lo - src
    want = torch.cat([plane[:, :1].expand(2, pad_lo, 5), plane,
                      plane[:, -1:].expand(2, pad_hi, 5)], dim=1)
    _assert_bits_equal(resize._resize_axis(plane, src, FilterType.BICUBIC, 0,
                                           pad_lo, out), want)


def _args(**change):
    idx = torch.zeros(3, 8, dtype=torch.int32)
    args = dict(plane=torch.zeros(2, 5, 6), idx=idx, w=torch.ones(3, 8), axis=0)
    args.update(change)
    return args


@pytest.mark.parametrize("change,error", [
    (dict(plane=torch.zeros(2, 5, 6, dtype=torch.float64)), TypeError),
    (dict(plane=torch.zeros(2, 5, 6, dtype=torch.float16)), TypeError),
    (dict(plane=torch.zeros(2, 5, 6, dtype=torch.int32)), TypeError),
    (dict(plane=torch.zeros(2, 5, 6, requires_grad=True)), ValueError),
    (dict(plane=torch.zeros(6)), ValueError),
    (dict(plane=torch.zeros(2, 0, 6)), ValueError),
    (dict(idx=torch.zeros(3, 8, dtype=torch.int64)), ValueError),
    (dict(idx=torch.zeros(8, dtype=torch.int32)), ValueError),
    (dict(idx=torch.zeros(8, 3, dtype=torch.int32).t()), ValueError),
    (dict(w=torch.ones(3, 8, dtype=torch.float64)), ValueError),
    (dict(w=torch.ones(2, 8)), ValueError),
    (dict(w=None), ValueError),
    (dict(axis=2), ValueError),
    (dict(axis=-1), ValueError),
], ids=lambda v: v if isinstance(v, type) else None)
def test_check_args_refuses_what_the_kernel_does_not_take(change, error):
    resample.check_args(**_args())                 # the unchanged set passes
    with pytest.raises(error):
        resample.check_args(**_args(**change))


def test_check_args_takes_a_copy_and_a_batch():
    resample.check_args(torch.zeros(5, 6), torch.zeros(1, 8, dtype=torch.int32),
                        None, 1)
    resample.check_args(torch.zeros(2, 3, 5, 6), torch.zeros(4, 9, dtype=torch.int32),
                        torch.ones(4, 9), 1)


def test_resample_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        resample.resample(**_args())


def test_kernel_symbols_match_no_conv_pattern():
    """``conv_roofline`` counts every kernel whose name holds one of a
    config's ``conv_kernels`` patterns as the conv stack's."""
    with open(os.path.join(_build.CSRC, "resample.cu")) as f:
        names = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                               f.read()))
    assert names == {"band_resample_rows", "band_resample_cols"}
    patterns = set()
    for path in glob.glob(os.path.join(ROOT, "perfbench", "configs", "*.json")):
        with open(path) as f:
            patterns.update(json.load(f).get("conv_kernels", []))
    assert patterns
    assert not [(n, p) for n in names for p in patterns if p in n]


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _both(fn, plane, cuda):
    """fn on the card (the kernel) and on the CPU (the plain version)."""
    got = fn(plane.to(cuda))
    torch.cuda.synchronize()
    return got, fn(plane)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [(), (3,)], ids=["HW", "NHW"])
@pytest.mark.parametrize("f", FACTORS)
@pytest.mark.parametrize("ft", FILTERS, ids=lambda f: f.name)
def test_kernel_resize_equals_plain(cuda, ft, f, batch):
    h, w = 37, 53
    plane = _plane(batch + (h, w), 1)
    dh, dw = _size(h, f), _size(w, f)
    before = resample.launches
    got, want = _both(lambda p: resize.resize_plane(p, dh, dw, ft), plane, cuda)
    assert resample.launches == before + 2
    _assert_bits_equal(got, want)
    got, want = _both(lambda p: resize.resize_plane_padded(
        p, dh, dw, ft, 6, dh + 12, dw + 12), plane, cuda)
    _assert_bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("ft", FILTERS, ids=lambda f: f.name)
@pytest.mark.parametrize("dst", [(74, 53), (37, 90), (37, 13), (9, 53), (37, 53)],
                         ids=lambda s: "x".join(map(str, s)))
def test_one_axis_and_same_size_axis(cuda, ft, dst):
    plane = _plane((2, 37, 53), 2)
    dh, dw = dst
    got, want = _both(lambda p: resize.resize_plane(p, dh, dw, ft), plane, cuda)
    _assert_bits_equal(got, want)
    # padded, a same-size axis is the clamped identity gather
    got, want = _both(lambda p: resize.resize_plane_padded(
        p, dh, dw, ft, 6, dh + 12, dw + 12), plane, cuda)
    _assert_bits_equal(got, want)
    for axis, n in ((0, dh), (1, dw)):
        got, want = _both(lambda p: resize._resize_axis(p, n, ft, axis, 6, n + 12),
                          plane, cuda)
        _assert_bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("ft", FILTERS, ids=lambda f: f.name)
@pytest.mark.parametrize("shape,dst", [((1, 53), (2, 106)), ((37, 1), (74, 2)),
                                       ((1, 1), (3, 5)), ((1, 53), (1, 13)),
                                       ((37, 1), (9, 1))],
                         ids=lambda s: "x".join(map(str, s)))
def test_one_row_and_one_column_planes(cuda, ft, shape, dst):
    plane = _plane(shape, 3)
    got, want = _both(lambda p: resize.resize_plane(p, *dst, ft), plane, cuda)
    _assert_bits_equal(got, want)
    got, want = _both(lambda p: resize.resize_plane_padded(
        p, *dst, ft, 6, dst[0] + 12, dst[1] + 12), plane, cuda)
    _assert_bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("ft", [FilterType.BICUBIC, FilterType.BILINEAR])
def test_odd_1080p_like_clip(cuda, ft):
    """Two frames of 1079 x 1917 to twice the size: the 16-byte row loads
    cannot take the odd width, the 4-column stores the padded output can."""
    plane = _plane((2, 1079, 1917), 4)
    got, want = _both(lambda p: resize.resize_plane_padded(
        p, 2158, 3834, ft, 6, 2170, 3846), plane, cuda)
    _assert_bits_equal(got, want)
    got, want = _both(lambda p: resize.resize_plane(p, 2158, 3834, ft), plane, cuda)
    _assert_bits_equal(got, want)


@pytest.mark.cuda
def test_non_contiguous_plane_and_the_counters(cuda):
    plane = _plane((40, 64), 5)
    view = plane.to(cuda)[3:37, 2:61]
    got = resize.resize_plane(view, 68, 118, FilterType.BICUBIC)
    _assert_bits_equal(got, resize.resize_plane(plane[3:37, 2:61], 68, 118,
                                                FilterType.BICUBIC))
    before = profiling.counts_snapshot()
    resize.resize_plane(view, 68, 118, FilterType.BICUBIC)
    resize.resize_plane(view, 34, 59, FilterType.BICUBIC)       # same size: no launch
    after = profiling.counts_snapshot()
    assert after["kernels.launch.resample"] - before["kernels.launch.resample"] == 2
    assert after["resize.tables_built"] == before["resize.tables_built"]


@pytest.mark.cuda
def test_refuses_what_it_does_not_take_on_the_card(cuda):
    with pytest.raises(TypeError, match="float32"):
        resize.resize_plane(torch.zeros(8, 8, dtype=torch.float64, device=cuda),
                            16, 16, FilterType.BICUBIC)
    with pytest.raises(ValueError, match="gradient"):
        resize.resize_plane(torch.zeros(8, 8, device=cuda, requires_grad=True),
                            16, 16, FilterType.BICUBIC)


@pytest.mark.cuda
@pytest.mark.parametrize("ft", [FilterType.BICUBIC, FilterType.LANCZOS3])
@pytest.mark.parametrize("scale", [2.0, 0.5])
def test_chunked_band_rows_equal_the_kernel_resize(cuda, ft, scale):
    """``chunked``'s band resize (its own vertical taps, the kernel's
    horizontal pass) against rows of the one-shot kernel resize."""
    h, w = 60, 84
    dh, dw = int(h * scale), int(w * scale)
    plane = _plane((h, w), 6).to(cuda)
    gidx, gw = chunked._global_band_tables(ft, dh, h)
    full = resize.resize_plane(plane, dh, dw, ft)
    padded = resize.resize_plane_padded(plane, dh, dw, ft, 6, dh + 12, dw + 12)
    for r0, r1 in ((0, 7), (7, dh // 2), (dh // 2, dh)):
        idx = torch.from_numpy(np.ascontiguousarray(gidx[r0:r1].T)).to(cuda)
        wt = torch.from_numpy(np.ascontiguousarray(gw[r0:r1].T)).to(cuda)
        band = chunked._band_resize(plane, idx, wt, w, dw, ft)
        _assert_bits_equal(band, full[r0:r1])
        band = chunked._band_resize(plane, idx, wt, w, dw, ft, (6, dw + 12))
        _assert_bits_equal(band, padded[6 + r0:6 + r1])


@pytest.mark.cuda
@pytest.mark.parametrize("ft", [FilterType.BICUBIC, FilterType.BILINEAR])
@pytest.mark.parametrize("scale", [2.0, 1.5, 0.5])
def test_tiled_grid_resize_equals_the_kernel_resize(cuda, ft, scale):
    """``parallel/tiled``'s grid resize (its own torch taps after a halo
    exchange) on 2 x 2 card tiles against the one-shot kernel resize."""
    h, w = 48, 64
    dh, dw = int(h * scale), int(w * scale)
    plane = _plane((h, w), 7).to(cuda)
    grid = [[plane[i * h // 2:(i + 1) * h // 2, j * w // 2:(j + 1) * w // 2]
             for j in range(2)] for i in range(2)]
    out = tiled._resize_grid(grid, ft, dh, dw, h, w)
    got = torch.cat([torch.cat(row, dim=-1) for row in out], dim=-2)
    _assert_bits_equal(got, resize.resize_plane(plane, dh, dw, ft))


@pytest.mark.cuda
def test_a_pass_on_the_card_resizes_through_the_kernel(cuda):
    """Three planes, two axes each."""
    img = np.random.default_rng(8).integers(0, 256, (30, 41, 3), np.uint8)
    before = resample.launches
    api.upscale(img, 2.0, device=cuda)
    assert resample.launches - before == 6


@pytest.mark.cuda
def test_library_holds_no_fma(cuda):
    """Products and sums round on their own: no FFMA in the SASS."""
    resample._lib()
    sass = subprocess.run([_build.tool("cuobjdump"), "-sass",
                           _build.library_path(resample.LIBRARY)],
                          capture_output=True, text=True, check=True).stdout
    assert "band_resample_rows" in sass and "band_resample_cols" in sass
    assert "FMUL" in sass and "FADD" in sass
    assert "FFMA" not in sass
