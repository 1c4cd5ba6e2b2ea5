"""The port on the card: the CUDA kernels against their plain versions
(K4 bit for bit), the kernel path against the plain path, batched and
multi-stream launches, the serving paths against ``upscale``, and the
chunked path against ``upscale`` at every float tier.

Every test here needs an NVIDIA GPU and skips without one; the CUDA kernel
has no CPU mode.  This file imports no jax, so it also runs where jax is
not installed (tests/conftest.py does import it; skip it there):

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q -m cuda
"""

import os

import numpy as np
import pytest
import torch

import bf16x1_gate
import libsrcnn_tpu_torch as lt
from libsrcnn_tpu_torch.kernels import _build, fused_conv
from libsrcnn_tpu_torch.models import srcnn
from libsrcnn_tpu_torch.utils import profiling
from torch_threads import torch_threads  # noqa: F401  (the thread rule)

pytestmark = pytest.mark.cuda

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "goldens.npz")
ATOL = 2e-3  # f32 sums in another order than cuDNN's
# the bf16 kernels vs their plain versions (tests/test_torch_kernel.py says
# why): split forms atol 5e-3; bf16x1 every pixel within the flip bound of
# tests/bf16x1_gate.py, and max 2.0
SPLIT_ATOL = 5e-3
BF16_MODES = {"K2": dict(precision="split"),
              "K3": dict(precision="bf16x1"),
              "K3h": dict(precision="split", pack_im2col=True),
              "K3n": dict(precision="bf16x1", geom="narrow")}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _fused_since(before) -> dict:
    """The fused kernels' launches (K1-K7) since the snapshot ``before``,
    by kernel: the resize's and the color kernels' left out."""
    return {k: n for k, n in profiling.launches_since(before).items()
            if k not in ("resample", "color")}


def _plane(h, w, seed, device):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = 128 + 60 * np.sin(0.05 * yy + 0.03 * xx) + rng.normal(0, 8, (h, w))
    return torch.from_numpy(np.clip(f, 0, 255).astype(np.float32)).to(device)


@pytest.mark.parametrize("shape,flags", [
    ((3, 3), None), ((1, 70), None), ((70, 1), None), ((5, 2), None),
    ((33, 47), None), ((130, 250), None), ((130, 250), (0, 1, 0, 1)),
    ((67, 45), (1, 0, 1, 0)), ((40, 40), (0, 0, 0, 0)),
    ((61, 181), (1, 0, 0, 1)),
])
def test_kernel_matches_plain_version(cuda, shape, flags):
    h, w = shape
    p = srcnn.load_params(cuda)
    y = _plane(h + 12, w + 12, 10, cuda)
    before = profiling.counts_snapshot()
    got = fused_conv.forward_y(p, y, h, w, flags)
    torch.cuda.synchronize()
    assert profiling.launches_since(before) == {"K1": 1}
    ref = fused_conv.forward_y_reference(p, y, h, w, flags)
    assert got.shape == (h, w)
    assert float((got - ref).abs().max()) <= ATOL


def test_kernel_rejects_non_contiguous_plane(cuda):
    p = srcnn.load_params(cuda)
    y = _plane(32, 64, 11, cuda)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv.forward_y(p, y, 20, 20)


@pytest.mark.parametrize("scale,filt,step", [(2.0, 2, False), (1.37, 3, False),
                                             (4.0, 2, True), (0.5, 1, False)])
def test_kernel_path_matches_plain_path(cuda, scale, filt, step):
    img = np.random.default_rng(12).integers(0, 256, (61, 47, 3), dtype=np.uint8)
    cfg = lt.SRCNNConfig(filter=lt.FilterType(filt), step_scale=step)
    plain = lt.SRCNNConfig(filter=lt.FilterType(filt), step_scale=step,
                           use_kernel=False)
    before = profiling.counts_snapshot()
    out, conv = lt.upscale(img, scale, cfg, return_conv_map=True, device=cuda)
    assert profiling.launches_since(before)["K1"] > 0
    pout, pconv = lt.upscale(img, scale, plain, return_conv_map=True, device=cuda)
    assert np.abs(out.astype(int) - pout.astype(int)).max() <= 1
    assert np.abs(conv.astype(int) - pconv.astype(int)).max() <= 1


@pytest.mark.parametrize("idx", [0, 10, 14, 23])
def test_goldens_through_kernel(cuda, idx):
    z = np.load(GOLDENS)
    key, name, mult, filt, step, _ms = str(z["meta"][idx]).split(",")
    cfg = lt.SRCNNConfig(filter=lt.FilterType(int(filt)), step_scale=bool(int(step)))
    out, conv = lt.upscale(z[f"in_{name}"], float(mult), cfg,
                           return_conv_map=True, device=cuda)
    d = np.abs(out.astype(int) - z[f"out_{key}"].astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 0.02
    assert np.abs(conv.astype(int) - z[f"conv_{key}"].astype(int)).max() <= 1


def _plain(kw):
    return {k: v for k, v in kw.items() if k != "geom"}


def _assert_close(kernel, got, ref, case):
    """A bf16 kernel against its plain version on ``case`` = (params,
    y_padded, h, w, edge_flags): K3 and K3n at every pixel within the flip
    bound, the split forms within SPLIT_ATOL."""
    if kernel in ("K3", "K3n"):
        v = bf16x1_gate.judge(got, ref, bf16x1_gate.flip_bound(*case))
        print(f"{kernel}: {v}")
        assert v.ok, str(v)
    else:
        assert float((got - ref).abs().max()) <= SPLIT_ATOL


@pytest.mark.parametrize("kernel", list(BF16_MODES))
@pytest.mark.parametrize("shape,flags", [
    ((3, 3), None), ((1, 70), None), ((70, 1), None), ((33, 47), None),
    ((130, 250), None), ((130, 250), (0, 1, 0, 1)), ((67, 45), (1, 0, 1, 0)),
    ((40, 40), (0, 0, 0, 0)),
])
def test_bf16_kernel_matches_plain_version(cuda, kernel, shape, flags):
    h, w = shape
    p = srcnn.load_params(cuda)
    y = _plane(h + 12, w + 12, 20, cuda)
    kw = BF16_MODES[kernel]
    before = profiling.counts_snapshot()
    got = fused_conv.forward_y(p, y, h, w, flags, **kw)
    torch.cuda.synchronize()
    assert profiling.launches_since(before)[kernel] == 1
    ref = fused_conv.forward_y_reference(p, y, h, w, flags, **_plain(kw))
    assert got.shape == (h, w)
    _assert_close(kernel, got, ref, (p, y, h, w, flags))


@pytest.mark.parametrize("shape,flags", [((130, 250), None), ((61, 181), (1, 0, 0, 1)),
                                         ((300, 517), None)])
def test_narrow_kernel_bit_identical_to_wide(cuda, shape, flags):
    h, w = shape
    p = srcnn.load_params(cuda)
    y = _plane(h + 12, w + 12, 21, cuda)
    wide = fused_conv.forward_y(p, y, h, w, flags, precision="bf16x1")
    narrow = fused_conv.forward_y(p, y, h, w, flags, precision="bf16x1",
                                  geom="narrow")
    assert torch.equal(wide, narrow)


@pytest.mark.parametrize("kernel", ["K1", *BF16_MODES])
def test_batched_launch_equals_per_plane(cuda, kernel):
    p = srcnn.load_params(cuda)
    kw = BF16_MODES.get(kernel, {})
    ys = torch.stack([_plane(75, 101, 22 + i, cuda) for i in range(3)])
    before = profiling.counts_snapshot()
    got = fused_conv.forward_y(p, ys, 63, 89, **kw)
    assert profiling.launches_since(before) == {kernel: 1} and got.shape == (3, 63, 89)
    for i in range(3):
        assert torch.equal(got[i], fused_conv.forward_y(p, ys[i], 63, 89, **kw))


def test_k1_persistent_grid_walks_many_tiles(cuda):
    """K1 runs at most one block per SM slot, each walking segments of
    tiles down column strips and prefetching its next window: a batch of
    612 tiles (segments of 6, carried rows) equals its plain version, and
    each plane (102 tiles, one per block, nothing carried) launched
    alone."""
    p = srcnn.load_params(cuda)
    ys = torch.stack([_plane(269, 313, 60 + i, cuda) for i in range(6)])
    got = fused_conv.forward_y(p, ys, 257, 301, (1, 0, 0, 1))
    ref = fused_conv.forward_y_reference(p, ys, 257, 301, (1, 0, 0, 1))
    assert float((got - ref).abs().max()) <= ATOL
    for i in range(6):
        assert torch.equal(got[i], fused_conv.forward_y(p, ys[i], 257, 301, (1, 0, 0, 1)))


def _walk(n, h, w, cuda):
    return fused_conv.k1_walk(n, h, w, fused_conv._sm_count(cuda))


def test_k1_plane_alone_equals_plane_in_a_batch_of_16(cuda):
    """K1's strip walk cuts a 1100 x 240 plane into other segments alone
    than in a batch of 16: equal bits all the same."""
    p = srcnn.load_params(cuda)
    ys = torch.stack([_plane(1112, 252, 70 + i, cuda) for i in range(16)])
    assert _walk(1, 1100, 240, cuda).seg != _walk(16, 1100, 240, cuda).seg
    got = fused_conv.forward_y(p, ys, 1100, 240)
    for i in (0, 7, 15):
        assert torch.equal(got[i], fused_conv.forward_y(p, ys[i], 1100, 240))


@pytest.mark.parametrize("flags", [None, (1, 0, 0, 1)])
def test_k1_tall_plane_matches_plain_version(cuda, flags):
    """A 1100 x 300 plane, many segments of several tiles, each later tile
    starting from the rows of the one above; and the two ring-row counters
    advance by the walk's numbers on the launch."""
    p = srcnn.load_params(cuda)
    y = _plane(1112, 312, 71, cuda)
    walk = _walk(1, 1100, 300, cuda)
    assert walk.rows_carried > 0
    before = profiling.counts_snapshot()
    got = fused_conv.forward_y(p, y, 1100, 300, flags)
    torch.cuda.synchronize()
    assert profiling.launches_since(before) == {"K1": 1}
    for name in ("computed", "carried"):
        key = f"k1.ring_rows_{name}"
        assert profiling.counts[key] - before[key] == getattr(walk, f"rows_{name}")
    ref = fused_conv.forward_y_reference(p, y, 1100, 300, flags)
    assert float((got - ref).abs().max()) <= ATOL


def test_k1_launch_plans_the_walk_of_its_mirror(cuda):
    """The C launch's segment length is ``fused_conv.k1_walk``'s."""
    sms = fused_conv._sm_count(cuda)
    seg = _build.library("fused_srcnn")["segment_tiles"]
    for n, h, w in [(8, 2160, 3840), (1, 1024, 1024), (1, 2048, 2048), (1, 13, 1000),
                    (16, 1100, 240), (1, 1100, 240), (3, 1000, 250), (1, 5, 7),
                    (8, 1080, 1920), (2, 70000, 61)]:
        for s in (sms, 114, 7, 1):
            assert seg(n, h, w, s) == fused_conv.k1_walk(n, h, w, s).seg, (n, h, w, s)


@pytest.mark.parametrize("flags", [None, (0, 1, 1, 0)])
def test_k1_cuts_follow_the_strip_walk(cuda, flags):
    """K1's cuts store each output row from the ring row that computes it,
    carried or not: on planes whose walk carries, each cut equals its plain
    version, and the full cut the production kernel."""
    from libsrcnn_tpu_torch.kernels import ablation

    p = srcnn.load_params(cuda)
    ys = torch.stack([_plane(1112, 252, 72 + i, cuda) for i in range(2)])
    assert _walk(2, 1100, 240, cuda).rows_carried > 0
    for stage in ablation.STAGES["K1"]:
        got = ablation.forward_y_cut("K1", stage, p, ys, 1100, 240, flags)
        if stage == "full":
            assert torch.equal(got, fused_conv.forward_y(p, ys, 1100, 240, flags))
        _assert_cut_close("K1", stage, got, ablation.forward_y_cut_reference(
            "K1", stage, p, ys, 1100, 240, flags), (p, ys, 1100, 240, flags))


@pytest.mark.parametrize("kernel", ["K1", *BF16_MODES])
def test_two_streams_two_parameter_sets(cuda, kernel):
    """Launches with different weights alternate on two streams; each
    result equals its own plain version (no parameter state is shared
    between launches)."""
    kw = BF16_MODES.get(kernel, {})
    pa = srcnn.load_params(cuda)
    pb = {k: v * (0.9 if k.startswith("w") else 1.1) for k, v in pa.items()}
    y = _plane(140, 260, 23, cuda)
    sa, sb = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    outs = []
    for i in range(8):
        s, p = (sa, pa) if i % 2 == 0 else (sb, pb)
        with torch.cuda.stream(s):
            outs.append(fused_conv.forward_y(p, y, 128, 248, **kw))
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        p = pa if i % 2 == 0 else pb
        ref = fused_conv.forward_y_reference(p, y, 128, 248, **_plain(kw))
        if kernel == "K1":
            assert float((got - ref).abs().max()) <= ATOL
        else:
            _assert_close(kernel, got, ref, (p, y, 128, 248, None))


@pytest.mark.parametrize("tier", ["float32", "bfloat16", "bfloat16_fast"])
def test_upscale_frames_bit_identical_to_upscale(cuda, tier):
    z = np.load(GOLDENS)
    b = z["in_butterfly_full"]
    clip = np.stack([b[:96, :128], b[96:192, :128], b[160:256, 128:]])
    cfg = lt.SRCNNConfig(compute_dtype=tier)
    before = profiling.counts_snapshot()
    out = lt.upscale_frames(clip, 2.0, cfg, device=cuda)
    assert sum(_fused_since(before).values()) == 1
    for f, o in zip(clip, out):
        np.testing.assert_array_equal(o, lt.upscale(f, 2.0, cfg, device=cuda))
    ens = lt.SRCNNConfig(compute_dtype=tier, self_ensemble=True)
    np.testing.assert_array_equal(lt.upscale_frames(clip[:1], 2.0, ens, device=cuda)[0],
                                  lt.upscale(clip[0], 2.0, ens, device=cuda))
    streamed = list(lt.VideoUpscaler(2.0, cfg, device=cuda).stream(clip))
    for o, s in zip(out, streamed):
        np.testing.assert_array_equal(o, s)


def test_tiers_route_to_their_kernels(cuda):
    img = np.random.default_rng(24).integers(0, 256, (40, 52, 3), dtype=np.uint8)
    for tier, kernel in (("float32", "K1"), ("bfloat16", "K2"),
                         ("bfloat16_fast", "K3")):
        before = profiling.counts_snapshot()
        lt.upscale(img, 2.0, lt.SRCNNConfig(compute_dtype=tier), device=cuda)
        assert _fused_since(before) == {kernel: 1}


# --- the int8 tier: K4 ----------------------------------------------------


@pytest.fixture
def qpack(cuda):
    from libsrcnn_tpu_torch.models import srcnn_int8

    return srcnn_int8.load_params(cuda)


@pytest.mark.parametrize("shape,flags", [
    ((3, 3), None), ((1, 70), None), ((70, 1), None), ((33, 47), None),
    ((130, 250), None), ((130, 250), (0, 1, 0, 1)), ((67, 45), (1, 0, 1, 0)),
    ((40, 40), (0, 0, 0, 0)), ((61, 181), (1, 0, 0, 1)),
])
def test_int8_kernel_equals_plain_version(cuda, qpack, shape, flags):
    """K4's integer GEMMs are exact and its epilogues round as the plain
    version's torch ops do: equal bit for bit."""
    h, w = shape
    y = _plane(h + 12, w + 12, 30, cuda)
    before = profiling.counts_snapshot()
    got = fused_conv.forward_y_int8(qpack, y, h, w, flags)
    torch.cuda.synchronize()
    assert profiling.launches_since(before)["K4"] == 1
    ref = fused_conv.forward_y_int8_reference(qpack, y, h, w, flags)
    assert got.shape == (h, w)
    assert torch.equal(got, ref)


def test_int8_batched_launch_equals_per_plane(cuda, qpack):
    ys = torch.stack([_plane(75, 101, 31 + i, cuda) for i in range(3)])
    before = profiling.counts_snapshot()
    got = fused_conv.forward_y_int8(qpack, ys, 63, 89, (0, 1, 1, 0))
    assert profiling.launches_since(before) == {"K4": 1} and got.shape == (3, 63, 89)
    for i in range(3):
        assert torch.equal(got[i], fused_conv.forward_y_int8(qpack, ys[i], 63, 89,
                                                             (0, 1, 1, 0)))


def test_int8_two_streams_two_packs(cuda, qpack):
    """Launches with two int8 packs alternate on two streams; each result
    equals its own plain version."""
    pb = dict(qpack, w2q=torch.flip(qpack["w2q"], [0]).contiguous(),
              s1=qpack["s1"] * 0.9)
    y = _plane(140, 260, 32, cuda)
    sa, sb = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    outs = []
    for i in range(8):
        s, p = (sa, qpack) if i % 2 == 0 else (sb, pb)
        with torch.cuda.stream(s):
            outs.append(fused_conv.forward_y_int8(p, y, 128, 248))
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        p = qpack if i % 2 == 0 else pb
        assert torch.equal(got, fused_conv.forward_y_int8_reference(p, y, 128, 248))
    assert not torch.equal(outs[0], outs[1])


def test_int8_tier_routes_to_k4(cuda):
    img = np.random.default_rng(33).integers(0, 256, (40, 52, 3), dtype=np.uint8)
    cfg = lt.SRCNNConfig(compute_dtype="int8")
    before = profiling.counts_snapshot()
    out = lt.upscale(img, 2.0, cfg, device=cuda)
    assert _fused_since(before) == {"K4": 1}
    plain = lt.upscale(img, 2.0, lt.SRCNNConfig(compute_dtype="int8",
                                                use_kernel=False), device=cuda)
    assert np.abs(out.astype(int) - plain.astype(int)).max() <= 1


def test_int8_serving_equals_upscale(cuda):
    z = np.load(GOLDENS)
    b = z["in_butterfly_full"]
    clip = np.stack([b[:96, :128], b[96:192, :128], b[160:256, 128:]])
    cfg = lt.SRCNNConfig(compute_dtype="int8")
    before = profiling.counts_snapshot()
    out = lt.upscale_frames(clip, 2.0, cfg, device=cuda)
    assert profiling.launches_since(before)["K4"] == 1
    for f, o in zip(clip, out):
        np.testing.assert_array_equal(o, lt.upscale(f, 2.0, cfg, device=cuda))
    streamed = list(lt.VideoUpscaler(2.0, cfg, device=cuda).stream(clip))
    for o, s in zip(out, streamed):
        np.testing.assert_array_equal(o, s)
    ens = lt.SRCNNConfig(compute_dtype="int8", self_ensemble=True)
    np.testing.assert_array_equal(lt.upscale_frames(clip[:1], 2.0, ens, device=cuda)[0],
                                  lt.upscale(clip[0], 2.0, ens, device=cuda))


# --- the chunked path through K1-K3 ---------------------------------------


@pytest.mark.parametrize("tier", ["float32", "bfloat16", "bfloat16_fast"])
@pytest.mark.parametrize("scale,filt,band", [(2.0, 2, 13), (2.0, 2, 1),
                                             (1.37, 3, 40), (0.5, 1, 7)])
def test_chunked_bit_identical_on_card(cuda, tier, scale, filt, band):
    """Bands start their tiles at other rows than the one-shot plane does;
    every kernel's per-pixel sums are independent of that, so the chunked
    output and conv map equal ``upscale``'s bit for bit."""
    img = np.random.default_rng(34).integers(0, 256, (97, 83, 3), dtype=np.uint8)
    cfg = lt.SRCNNConfig(filter=lt.FilterType(filt), compute_dtype=tier)
    ref, refc = lt.upscale(img, scale, cfg, return_conv_map=True, device=cuda)
    before = profiling.counts_snapshot()
    out, conv = lt.upscale_chunked(img, scale, cfg, band_rows=band, device=cuda)
    assert sum(_fused_since(before).values()) > 0
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(conv, refc)


@pytest.mark.parametrize("tier", ["float32", "bfloat16_fast"])
def test_chunked_ensemble_on_card(cuda, tier):
    img = np.random.default_rng(35).integers(0, 256, (61, 70, 4), dtype=np.uint8)
    cfg = lt.SRCNNConfig(compute_dtype=tier, self_ensemble=True)
    ref, refc = lt.upscale(img, 2.0, cfg, return_conv_map=True, device=cuda)
    out, conv = lt.upscale_chunked(img, 2.0, cfg, band_rows=17, device=cuda)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(conv, refc)


# --- the kernel-profiling path: K5 and the stage cuts (K6, K7) -------------


@pytest.mark.parametrize("tile_h", [64, fused_conv.BAND_TILE_H, 7])
@pytest.mark.parametrize("shape,flags", [
    ((3, 3), None), ((1, 70), None), ((33, 47), None), ((130, 250), None),
    ((130, 250), (0, 0, 0, 0)), ((61, 181), (1, 0, 0, 1)), ((300, 517), (0, 1, 0, 1)),
])
def test_band_kernel_equals_k3(cuda, tile_h, shape, flags):
    """K5 runs K3's per-pixel arithmetic in row bands: equal bit for bit,
    ragged bands and the interior-ring flags included."""
    h, w = shape
    p = srcnn.load_params(cuda)
    y = _plane(h + 12, w + 12, 40, cuda)
    before = profiling.counts_snapshot()
    got = fused_conv.forward_y_band(p, y, h, w, flags, tile_h=tile_h)
    torch.cuda.synchronize()
    assert profiling.launches_since(before)["K5"] == 1
    assert torch.equal(got, fused_conv.forward_y(p, y, h, w, flags, precision="bf16x1"))


@pytest.mark.parametrize("band_impl", fused_conv.BAND_IMPLS)
def test_band_kernel_batch_equals_k3(cuda, band_impl):
    p = srcnn.load_params(cuda)
    ys = torch.stack([_plane(75, 101, 41 + i, cuda) for i in range(3)])
    got = fused_conv.forward_y_band(p, ys, 63, 89, (0, 1, 1, 0), tile_h=24,
                                    band_impl=band_impl)
    assert got.shape == (3, 63, 89)
    assert torch.equal(got, fused_conv.forward_y(p, ys, 63, 89, (0, 1, 1, 0),
                                                 precision="bf16x1"))


def _assert_cut_close(kernel, stage, got, ref, case):
    """A cut against its plain version on ``case`` = (params, y_padded, h,
    w, edge_flags): K4's integer sums exactly; a float cut at its kernel's
    gate after scaling the error by 255 / max(255, max |value|)
    (tests/test_torch_ablation.py), K3's at every pixel within its stage's
    flip bound, scaled alike."""
    if kernel == "K4":
        assert torch.equal(got, ref)
        return
    scale = 255.0 / max(255.0, float(ref.abs().max()))
    if kernel == "K3":
        v = bf16x1_gate.judge(got, ref, bf16x1_gate.flip_bound(*case), stage, scale)
        print(f"K3 {stage} cut: {v}")
        assert v.ok, f"{stage}: {v}"
    else:
        d = (got - ref).abs() * scale
        assert float(d.max()) <= (ATOL if kernel == "K1" else SPLIT_ATOL)


def _cut_cases():
    from libsrcnn_tpu_torch.kernels import ablation

    return [(k, s) for k, stages in ablation.STAGES.items() for s in stages]


@pytest.mark.parametrize("kernel,stage", _cut_cases())
@pytest.mark.parametrize("shape", [(33, 47), (130, 250)])
def test_cut_matches_plain_version(cuda, kernel, stage, shape):
    from libsrcnn_tpu_torch.kernels import ablation
    from libsrcnn_tpu_torch.models import srcnn_int8

    h, w = shape
    p = srcnn_int8.load_params(cuda) if kernel == "K4" else srcnn.load_params(cuda)
    ys = torch.stack([_plane(h + 12, w + 12, 42 + i, cuda) for i in range(2)])
    counted = "K7" if kernel == "K4" else "K6"
    before = profiling.counts_snapshot()
    got = ablation.forward_y_cut(kernel, stage, p, ys, h, w)
    torch.cuda.synchronize()
    assert profiling.launches_since(before)[counted] == 1 and got.shape == (2, h, w)
    _assert_cut_close(kernel, stage, got, ablation.forward_y_cut_reference(
        kernel, stage, p, ys, h, w), (p, ys, h, w, None))


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4"])
def test_full_cut_equals_production_kernel(cuda, kernel):
    """The profiling build's FULL instance is the production kernel."""
    from libsrcnn_tpu_torch.kernels import ablation
    from libsrcnn_tpu_torch.models import srcnn_int8

    p = srcnn_int8.load_params(cuda) if kernel == "K4" else srcnn.load_params(cuda)
    y = _plane(142, 262, 43, cuda)
    for flags in (None, (0, 1, 0, 1)):
        got = ablation.forward_y_cut(kernel, "full", p, y, 130, 250, flags)
        ref = (fused_conv.forward_y_int8(p, y, 130, 250, flags) if kernel == "K4" else
               fused_conv.forward_y(p, y, 130, 250, flags,
                                    precision=ablation.PRECISION[kernel]))
        assert torch.equal(got, ref)


# --- K2, K3, K3h, K3n and K4 on wgmma: the persistent grid ----------------

WGMMA_KERNELS = ["K2", "K3", "K3h", "K3n", "K4"]


def _k2_or_k4(kernel, p, y, h, w, flags=None):
    """The kernel's output and its plain version's (K2, K3, K3h, K3n, K4)."""
    if kernel == "K4":
        return (fused_conv.forward_y_int8(p, y, h, w, flags),
                fused_conv.forward_y_int8_reference(p, y, h, w, flags))
    kw = BF16_MODES[kernel]
    return (fused_conv.forward_y(p, y, h, w, flags, **kw),
            fused_conv.forward_y_reference(p, y, h, w, flags, **_plain(kw)))


def _params_of(kernel, device):
    from libsrcnn_tpu_torch.models import srcnn_int8

    return srcnn_int8.load_params(device) if kernel == "K4" else srcnn.load_params(device)


def _assert_k2_k4(kernel, got, ref, case):
    if kernel == "K4":
        assert torch.equal(got, ref)
    else:
        _assert_close(kernel, got, ref, case)


@pytest.mark.parametrize("kernel", WGMMA_KERNELS)
def test_k2_k4_persistent_grid_walks_many_tiles(cuda, kernel):
    """One block per SM walks the tiles with a static stride: a 500x1000
    plane (K2, K3h: 21 x 17 = 357 tiles of 24 x 60; K3: 22 x 17 = 374 of
    23 x 60; K3n: 756 of 24 x 28; K4: 340 of 26 x 60; each more than two
    per SM) equals its plain version, ragged edges included."""
    p = _params_of(kernel, cuda)
    y = _plane(512, 1012, 70, cuda)
    before = profiling.counts_snapshot()
    got, ref = _k2_or_k4(kernel, p, y, 500, 1000, (1, 0, 0, 1))
    torch.cuda.synchronize()
    assert profiling.launches_since(before)[kernel] == 1
    _assert_k2_k4(kernel, got, ref, (p, y, 500, 1000, (1, 0, 0, 1)))


@pytest.mark.parametrize("kernel", WGMMA_KERNELS)
def test_k2_k4_batch_with_zero_flags(cuda, kernel):
    """A batch of 3 planes with every edge flag 0 (the ring keeps the real
    halo) equals its plain version and each plane launched alone."""
    p = _params_of(kernel, cuda)
    ys = torch.stack([_plane(269, 313, 71 + i, cuda) for i in range(3)])
    got, ref = _k2_or_k4(kernel, p, ys, 257, 301, (0, 0, 0, 0))
    _assert_k2_k4(kernel, got, ref, (p, ys, 257, 301, (0, 0, 0, 0)))
    for i in range(3):
        assert torch.equal(got[i], _k2_or_k4(kernel, p, ys[i], 257, 301, (0, 0, 0, 0))[0])


def test_bf16_row_limit_is_the_tile_arithmetic(cuda):
    """The bf16 kernels walk their tiles with a 64-bit stride: no grid
    dimension limits the rows (K3h's old grid of one block row per 12 rows
    stopped at 65535 * 12)."""
    assert _build.constants("fused_srcnn_bf16")["max_rows"] > 65535 * 12


@pytest.mark.parametrize("tile_h", [1, 5, 12, 13, 64])
def test_k3n_and_k5_equal_k3_over_many_tiles(cuda, tile_h):
    """K3n (24 x 28 tiles) and K5 (row bands of ``tile_h``, the last tile
    of a band cut) run K3's per-tile body: on the many-tile plane and on
    the zero-flag batch above, both equal K3 bit for bit."""
    p = srcnn.load_params(cuda)
    for y, h, w, flags in ((_plane(512, 1012, 70, cuda), 500, 1000, (1, 0, 0, 1)),
                           (torch.stack([_plane(269, 313, 71 + i, cuda) for i in range(3)]),
                            257, 301, (0, 0, 0, 0))):
        k3 = fused_conv.forward_y(p, y, h, w, flags, precision="bf16x1")
        assert torch.equal(fused_conv.forward_y(p, y, h, w, flags, precision="bf16x1",
                                                geom="narrow"), k3)
        assert torch.equal(fused_conv.forward_y_band(p, y, h, w, flags, tile_h=tile_h), k3)


@pytest.mark.parametrize("kernel", ["K2", "K3", "K4"])
@pytest.mark.parametrize("stage", ["load", "conv1", "conv2", "taps", "full"])
def test_k2_k4_launch_cut_matches_plain_version(cuda, kernel, stage):
    """``ablation.launch_cut`` on weights packed once, over many tiles,
    against the cut's plain version (``full``: the production kernel)."""
    from libsrcnn_tpu_torch.kernels import ablation

    p = _params_of(kernel, cuda)
    packed = (fused_conv.pack_int8_params(p) if kernel == "K4"
              else fused_conv.pack_params(p).to(cuda))
    y = _plane(412, 712, 72, cuda)
    out = torch.empty(400, 700, device=cuda)
    ablation.launch_cut(kernel, stage, packed, y, out, (1, 1, 0, 0))
    torch.cuda.synchronize()
    if stage == "full":
        ref = _k2_or_k4(kernel, p, y, 400, 700, (1, 1, 0, 0))[0]
        assert torch.equal(out, ref)
    else:
        _assert_cut_close(kernel, stage, out, ablation.forward_y_cut_reference(
            kernel, stage, p, y, 400, 700, (1, 1, 0, 0)), (p, y, 400, 700, (1, 1, 0, 0)))
