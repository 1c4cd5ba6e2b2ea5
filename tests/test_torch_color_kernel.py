"""The color kernels (``kernels/color.py``, ``csrc/color.cu``) against the
color op's plain version, ``ops.color``'s torch expressions.

The CPU cases hold what surrounds the kernels: a CPU tensor never reaches
them, their wrapper refuses what they do not take, their coefficients are
the f32 roundings of the plain version's Python scalars, their arithmetic
(emulated in numpy, one rounding per operation) equals the plain version,
their symbols are not taken for the conv stack's, and the launch counter
is in the snapshot.  The ``cuda`` cases skip without a card and compare
each kernel with the torch expressions run on the same card bit for bit:
one frame and a batch, D 3 and 4, odd sizes, a 1080p-like clip, one-row
and one-column planes, non-contiguous inputs, NaN, infinities and values
out of range; then the callers: chunked bands, a tiled grid and a mesh
pipeline equal to the frame pass, two launches a pass, one kernel in each
color span, and no FMA in the library.  This file imports no jax; on a
card:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_color_kernel.py -q
"""

import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import libsrcnn_tpu_torch as lt
from libsrcnn_tpu_torch import api, chunked, pipeline
from libsrcnn_tpu_torch.kernels import _build, color as color_kernel
from libsrcnn_tpu_torch.ops import color
from libsrcnn_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_build.CSRC, "color.cu")


def _rgb(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, shape, dtype=np.uint8))


def _planes(d, shape, seed=1):
    """Y, Cb, Cr(, A) planes as a pass's merge sees them: values around
    [0, 255], some beyond it."""
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.uniform(-40, 300, shape).astype(np.float32))
            for _ in range(d)]


# --- CPU --------------------------------------------------------------------

def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU tensor reached a color kernel")

    monkeypatch.setattr(color_kernel, "split", refuse)
    monkeypatch.setattr(color_kernel, "merge", refuse)
    before = color_kernel.launches
    planes = color.rgb_to_ycbcr(_rgb((2, 5, 7, 4)))
    color.ycbcr_to_rgb(planes)
    color.merge(planes[0], list(planes[1:]))
    api.upscale(_rgb((7, 9, 3)).numpy(), 2.0, device="cpu")
    assert color_kernel.launches == before


@pytest.mark.parametrize("d", [3, 4])
def test_plain_merge_is_the_stack_and_the_cast(d):
    """``merge`` on the CPU is today's pair: ``ycbcr_to_rgb`` of the
    stacked planes and the conv map's floor and cast."""
    y, *rest = _planes(d, (2, 6, 5))
    out, conv = color.merge(y, rest)
    assert torch.equal(out, color.ycbcr_to_rgb(torch.stack([y, *rest])))
    assert torch.equal(conv, torch.floor(y).to(torch.uint8))
    assert out.shape == (2, 6, 5, d) and conv.shape == (2, 6, 5)


def _merge_args(**change):
    args = dict(y=torch.zeros(2, 5, 6), rest=[torch.zeros(2, 5, 6)] * 2)
    args.update(change)
    return args


_HUGE = torch.zeros(1).expand(2 ** 16, 2 ** 15 + 1)


@pytest.mark.parametrize("change,error", [
    (dict(y=torch.zeros(2, 5, 6, dtype=torch.float64)), TypeError),
    (dict(y=torch.zeros(2, 5, 6, dtype=torch.float16)), TypeError),
    (dict(rest=[torch.zeros(2, 5, 6), torch.zeros(2, 5, 6, dtype=torch.bfloat16)]),
     TypeError),
    (dict(rest=[torch.zeros(2, 5, 6, dtype=torch.int32)] * 2), TypeError),
    (dict(y=torch.zeros(2, 5, 6, requires_grad=True)), ValueError),
    (dict(rest=[torch.zeros(2, 5, 6, requires_grad=True), torch.zeros(2, 5, 6)]),
     ValueError),
    (dict(rest=[torch.zeros(2, 5, 6)]), ValueError),
    (dict(rest=[torch.zeros(2, 5, 6)] * 4), ValueError),
    (dict(rest=[torch.zeros(2, 5, 7)] * 2), ValueError),
    (dict(rest=[torch.zeros(5, 6)] * 2), ValueError),
    (dict(rest=[torch.zeros(2, 5, 6), torch.zeros(2, 5, 6, device="meta")]),
     ValueError),
    (dict(y=_HUGE, rest=[_HUGE] * 2), ValueError),
], ids=lambda v: v if isinstance(v, type) else None)
def test_check_merge_args_refuses_what_the_kernel_does_not_take(change, error):
    color_kernel.check_merge_args(**_merge_args())       # the unchanged set passes
    with pytest.raises(error):
        color_kernel.check_merge_args(**_merge_args(**change))


@pytest.mark.parametrize("rgb,error", [
    (torch.zeros(5, 6, 3, dtype=torch.float32), TypeError),
    (torch.zeros(5, 6, 3, dtype=torch.int16), TypeError),
    (torch.zeros(5, 6, 3, dtype=torch.int8), TypeError),
    (torch.zeros(5, 6, 2, dtype=torch.uint8), ValueError),
    (torch.zeros(5, 6, 5, dtype=torch.uint8), ValueError),
    (torch.zeros((), dtype=torch.uint8), ValueError),
    (torch.zeros(1, dtype=torch.uint8).expand(2 ** 16, 2 ** 15 + 1, 3), ValueError),
], ids=lambda v: v if isinstance(v, type) else None)
def test_check_split_args_refuses_what_the_kernel_does_not_take(rgb, error):
    for ok in (torch.zeros(5, 6, 3, dtype=torch.uint8),
               torch.zeros(2, 5, 6, 4, dtype=torch.uint8)):
        color_kernel.check_split_args(ok)
    with pytest.raises(error):
        color_kernel.check_split_args(rgb)


def test_check_args_take_a_batch_and_an_alpha_plane():
    color_kernel.check_split_args(torch.zeros(3, 1, 1, 4, dtype=torch.uint8))
    color_kernel.check_merge_args(torch.zeros(3, 1, 7), [torch.zeros(3, 1, 7)] * 3)


def test_kernels_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        color_kernel.split(torch.zeros(5, 6, 3, dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        color_kernel.merge(**_merge_args())


def test_coefficients_are_the_plain_versions_scalars():
    """Each ``static_cast<float>(c)`` of the kernel is a scalar of the plain
    split, and every fractional scalar of the plain split is one of them."""
    import inspect

    with open(SOURCE) as f:
        kernel = set(re.findall(r"static_cast<float>\(([0-9.]+)\)", f.read()))
    plain = set(re.findall(r"\b(0\.[0-9]+)\b",
                           inspect.getsource(color.plain_rgb_to_ycbcr))) - {"0.5"}
    assert kernel == plain and len(kernel) == 7


def _f32(x):
    return np.float32(x)


def _emulated_merge(y, cb, cr):
    """The merge kernel's arithmetic in numpy f32, one rounding per
    operation: the divisions as products by 2**-5 and 2**-6, the clamps
    keeping NaN, the cast through int64."""
    with np.errstate(all="ignore"):
        cb, cr = cb - _f32(128), cr - _f32(128)
        r = y + (_f32(45) * cr) * _f32(2 ** -5)
        g = y - (_f32(11) * cb + _f32(23) * cr) * _f32(2 ** -5)
        b = y + (_f32(113) * cb) * _f32(2 ** -6)

        def trunc(v):
            v = np.where(v > 255, _f32(255), v)
            v = np.where(v < 0, _f32(0), v)
            return np.floor(v).astype(np.int64).astype(np.uint8)

        return (np.stack([trunc(r), trunc(g), trunc(b)], -1),
                np.floor(y).astype(np.int64).astype(np.uint8))


def _special_planes(shape, seed):
    """Planes mixing NaN, +-inf, negatives, values above 255 and values on
    integers and halves with ordinary ones."""
    g = np.random.default_rng(seed)
    special = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, -1.5, -300.0, 255.0,
                        255.5, 256.0, 300.25, 1e9, -1e9, 127.5, 128.0, 3.0,
                        0.5, 254.99998], np.float32)
    planes = []
    for _ in range(3):
        p = g.uniform(-50, 310, shape).astype(np.float32)
        pick = g.random(shape) < 0.3
        p[pick] = g.choice(special, int(pick.sum()))
        half = g.random(shape) < 0.1
        p[half] = np.round(p[half] * 2) / 2
        planes.append(p)
    return planes


def test_kernel_arithmetic_emulated_equals_plain():
    """The products by 2**-5 and 2**-6 equal the plain version's divisions,
    and the clamps keep NaN as torch.clamp does, on the special values."""
    y, cb, cr = _special_planes((37, 41), 4)
    out, conv = _emulated_merge(y, cb, cr)
    want_out, want_conv = color.merge(torch.from_numpy(y),
                                      [torch.from_numpy(cb), torch.from_numpy(cr)])
    assert np.array_equal(out, want_out.numpy())
    assert np.array_equal(conv, want_conv.numpy())


def test_kernel_symbols_match_no_conv_pattern():
    """``conv_roofline`` counts every kernel whose name holds one of a
    config's ``conv_kernels`` patterns as the conv stack's; the color
    kernels count under ``ops_ms_per_mp``."""
    with open(SOURCE) as f:
        names = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                               f.read()))
    assert names == {"color_split", "color_merge"}
    patterns = set()
    for path in glob.glob(os.path.join(ROOT, "perfbench", "configs", "*.json")):
        with open(path) as f:
            patterns.update(json.load(f).get("conv_kernels", []))
    assert {"fused_srcnn", "fprop", "implicit_gemm", "gemm"} <= patterns
    assert not [(n, p) for n in names for p in patterns if p in n]


def test_snapshot_shows_the_color_launches():
    snap = profiling.counts_snapshot()
    assert snap["kernels.launch.color"] == color_kernel.launches
    assert "kernels.launch.color" not in profiling.counts


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _bits_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    got, want = got.cpu(), want.cpu()
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    n = int((got != want).sum())
    assert n == 0, f"{n} of {got.numel()} values differ in their bits"


def _check_split(rgb, cuda):
    before = color_kernel.launches
    got = color.rgb_to_ycbcr(rgb)
    assert color_kernel.launches == before + 1
    _bits_equal(got, color.plain_rgb_to_ycbcr(rgb))
    _bits_equal(got, color.plain_rgb_to_ycbcr(rgb.cpu()).to(cuda))


def _check_merge(y, rest):
    before = color_kernel.launches
    out, conv = color.merge(y, rest)
    assert color_kernel.launches == before + 1
    want_out, want_conv = color.plain_merge(y, rest)
    _bits_equal(out, want_out)
    _bits_equal(conv, want_conv)
    _bits_equal(color.ycbcr_to_rgb(torch.stack([y, *rest])), want_out)


# (shape of the pixels): one frame, a batch, odd sizes, one row, one column,
# fewer pixels than a thread's run
SHAPES = [(30, 44), (3, 30, 44), (37, 53), (2, 17, 29), (1, 97), (97, 1),
          (1, 1), (3, 5), (1, 1, 13)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_equals_plain(cuda, shape, d):
    _check_split(_rgb(shape + (d,), 2).to(cuda), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_merge_equals_plain(cuda, shape, d):
    y, *rest = [p.to(cuda) for p in _planes(d, shape, 3)]
    _check_merge(y, rest)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 4])
def test_1080p_like_clip(cuda, d):
    """Two frames of 1079 x 1917 (an odd pixel count: the last run is cut)
    and the 8-frame 1080p clip the benchmark sends, at its 4K output."""
    _check_split(_rgb((2, 1079, 1917, d), 4).to(cuda), cuda)
    _check_split(_rgb((8, 1080, 1920, d), 5).to(cuda), cuda)
    y, *rest = [p.to(cuda) for p in _planes(d, (2, 2158, 3834), 6)]
    _check_merge(y, rest)
    g = torch.Generator(device=cuda).manual_seed(7)
    y, *rest = [torch.rand((8, 2160, 3840), generator=g, device=cuda) * 300 - 20
                for _ in range(d)]
    _check_merge(y, rest)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 4])
def test_non_contiguous_and_unaligned_inputs(cuda, d):
    rgb = _rgb((40, 64, d), 8).to(cuda)
    _check_split(rgb[3:37, 2:61], cuda)                  # strided rows
    _check_split(rgb.transpose(0, 1), cuda)               # transposed
    flat = _rgb((1, 1 + 16 * 9 * d), 9).to(cuda)[0, 1:].view(16, 9, d)
    _check_split(flat, cuda)                              # 1 byte off 16
    y, *rest = [p.to(cuda) for p in _planes(d, (40, 64), 10)]
    _check_merge(y[3:37, 2:61], [p[3:37, 2:61] for p in rest])
    _check_merge(y.t(), [p.t() for p in rest])
    off = [p.flatten()[1:1 + 16 * 9].view(16, 9) for p in (y, *rest)]
    _check_merge(off[0], off[1:])                         # 4 bytes off 16
    stacked = torch.stack([y, *rest])
    _check_merge(stacked[0, :, :63], list(stacked[1:, :, :63]))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 4])
def test_merge_of_special_values(cuda, d):
    """NaN, +-inf, negatives, values above 255, integers and halves: the
    clamps keep NaN as torch.clamp does, and the casts give torch's bytes,
    in the conv map too."""
    planes = _special_planes((2, 37, 64), 11)
    planes += _special_planes((2, 37, 64), 12)[:d - 3]
    y, *rest = [torch.from_numpy(p).to(cuda) for p in planes]
    _check_merge(y, rest)
    _check_merge(y[:, :, :61], [p[:, :, :61] for p in rest])


@pytest.mark.cuda
def test_refuses_what_it_does_not_take_on_the_card(cuda):
    with pytest.raises(TypeError, match="uint8"):
        color.rgb_to_ycbcr(torch.zeros(8, 8, 3, device=cuda))
    with pytest.raises(TypeError, match="float32"):
        color.ycbcr_to_rgb(torch.zeros(3, 8, 8, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="gradient"):
        color.merge(torch.zeros(8, 8, device=cuda, requires_grad=True),
                    [torch.zeros(8, 8, device=cuda)] * 2)


@pytest.mark.cuda
@pytest.mark.parametrize("model,tier", [("srcnn", "float32"), ("srcnn", "bfloat16_fast"),
                                        ("vdsr", "float32"), ("fsrcnn", "float32")])
def test_a_pass_on_the_card_launches_two_color_kernels(cuda, model, tier):
    cfg = lt.SRCNNConfig(model=model, compute_dtype=tier)
    img = _rgb((30, 41, 3), 13).numpy()
    api.upscale(img, 2.0, cfg, device=cuda)                   # warm
    before = profiling.counts_snapshot()
    api.upscale(img, 2.0, cfg, device=cuda)
    params = pipeline.load_model_params(cfg, 2.0, cuda)
    pipeline.run_pass(_rgb((2, 30, 41, 4), 14).to(cuda), params, 2.0, cfg)
    after = profiling.counts_snapshot()
    assert after["kernels.launch.color"] - before["kernels.launch.color"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["srcnn", "fsrcnn"])
@pytest.mark.parametrize("d", [3, 4])
def test_chunked_bands_equal_the_frame_pass(cuda, model, d):
    cfg = lt.SRCNNConfig(model=model)
    img = _rgb((61, 47, d), 15).numpy()
    out, conv = api.upscale(img, 2.0, cfg, return_conv_map=True, device=cuda)
    band, bconv = chunked.upscale_chunked(img, 2.0, cfg, band_rows=16, device=cuda)
    assert np.array_equal(band, out) and np.array_equal(bconv, conv)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["srcnn", "vdsr"])
def test_tiled_grid_equals_the_frame_pass(cuda, model):
    from libsrcnn_tpu_torch.parallel import make_mesh, upscale_tiled

    cfg = lt.SRCNNConfig(model=model)
    img = _rgb((48, 64, 3), 16).numpy()
    mesh = make_mesh({"data": 1, "row": 2, "col": 2}, [cuda] * 4)
    got = upscale_tiled(img, None, 2.0, cfg, mesh)
    want = api.upscale(img, 2.0, cfg, return_conv_map=True, device=cuda)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_mesh_pipeline_equals_the_frame_pass(cuda):
    from libsrcnn_tpu_torch.parallel import make_mesh, upscale_pipelined

    cfg = lt.SRCNNConfig()
    clip = _rgb((3, 24, 36, 3), 17).numpy()
    out, conv = upscale_pipelined(clip, None, 2.0, cfg,
                                  make_mesh({"stage": 4}, [cuda] * 4))
    plain = lt.SRCNNConfig(use_kernel=False)
    for i, frame in enumerate(clip):
        o, c = api.upscale(frame, 2.0, plain, return_conv_map=True, device=cuda)
        assert np.array_equal(out[i], o) and np.array_equal(conv[i], c)


@pytest.mark.cuda
def test_color_spans_hold_one_kernel_each(cuda, tmp_path):
    """No torch elementwise or cat kernel runs under ``sr.color.*``: the
    split's and the merge's one launch each."""
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, ROOT)
    from perfbench import spans

    cfg = lt.SRCNNConfig(compute_dtype="bfloat16_fast")
    params = pipeline.load_model_params(cfg, 2.0, cuda)
    clip = _rgb((2, 30, 44, 3), 18).to(cuda)
    pipeline.run_pass(clip, params, 2.0, cfg)                 # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipeline.run_pass(clip, params, 2.0, cfg)
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        acts = spans.attribute(json.load(f)["traceEvents"])
    by_span = {}
    for a in acts:
        if a[0] == "kernel":
            by_span.setdefault(a[4], []).append(a[1])
    assert len(by_span["sr.color.split"]) == 1
    assert "color_split" in by_span["sr.color.split"][0]
    assert len(by_span["sr.color.merge"]) == 1
    assert "color_merge" in by_span["sr.color.merge"][0]


@pytest.mark.cuda
def test_library_holds_no_fma(cuda):
    """Products and sums round on their own: no FFMA in the SASS."""
    color_kernel._lib()
    sass = subprocess.run([_build.tool("cuobjdump"), "-sass",
                           _build.library_path(color_kernel.LIBRARY)],
                          capture_output=True, text=True, check=True).stdout
    assert "color_split" in sass and "color_merge" in sass
    assert "FMUL" in sass and "FADD" in sass
    assert "FFMA" not in sass
