"""The port's out-of-core chunked path (``upscale_chunked``) on the CPU:
bit-identity to the port's own ``upscale`` per case, and <=1 LSB of the
JAX package's ``upscale_chunked`` (the port's resize and color ops differ
from XLA's by <=1 LSB end to end, tests/test_torch_pipeline.py).

Ported from tests/test_chunked.py for srcnn.  Its
``test_chunked_shares_one_program_across_interior_bands`` checks JAX's
compile cache; PyTorch runs eagerly and compiles nothing per band, so it
has no counterpart here.  The zoo's band plans are held in
tests/test_torch_zoo_paths.py.  The kernel
path (every float tier through K1-K3) is checked on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import libsrcnn_tpu as J
import libsrcnn_tpu_torch as T
from libsrcnn_tpu import chunked as jchunked
from libsrcnn_tpu_torch import chunked
from libsrcnn_tpu_torch.config import FilterType
from libsrcnn_tpu_torch.kernels import fused_conv
from libsrcnn_tpu_torch.ops import resize


@pytest.fixture(scope="module")
def img():
    return np.random.default_rng(44).integers(0, 256, (45, 38, 3), np.uint8)


CASES = [
    (2.0, FilterType.BICUBIC, 16),
    (3.0, FilterType.LANCZOS3, 7),
    (1.5, FilterType.NEAREST, 45),   # one band covering everything
    (0.5, FilterType.BICUBIC, 5),    # downscale: horizontal-first ordering
    (2.3, FilterType.BSPLINE, 64),   # fractional scale, ragged last band
]


@pytest.mark.parametrize("scale,ft,band", CASES)
def test_chunked_bitexact(img, scale, ft, band):
    cfg = T.SRCNNConfig(filter=ft)
    ref, refc = T.upscale(img, scale, cfg, return_conv_map=True, device="cpu")
    out, conv = T.upscale_chunked(img, scale, cfg, band_rows=band, device="cpu")
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(conv, refc)


@pytest.mark.parametrize("scale,ft,band", CASES[:2] + CASES[3:])
def test_chunked_matches_jax_chunked(img, scale, ft, band):
    jcfg = J.SRCNNConfig(filter=J.FilterType(int(ft)), use_pallas=False)
    jout, jconv = J.upscale_chunked(img, scale, jcfg, band_rows=band)
    out, conv = T.upscale_chunked(img, scale, T.SRCNNConfig(filter=ft),
                                  band_rows=band, device="cpu")
    assert out.shape == jout.shape and conv.shape == jconv.shape
    assert np.abs(out.astype(int) - jout.astype(int)).max() <= 1
    assert np.abs(conv.astype(int) - jconv.astype(int)).max() <= 1


def test_chunked_rgba_and_tiny_bands():
    img4 = np.random.default_rng(45).integers(0, 256, (33, 29, 4), np.uint8)
    ref = T.upscale(img4, 2.0, device="cpu")
    out, _ = T.upscale_chunked(img4, 2.0, band_rows=1, device="cpu")  # one-row bands
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("band", [1, 5, 13])
def test_chunked_ring_never_crosses_unflagged_edges(band):
    """A band cut at row 1 or dst_h-1 would put the conv2-output ring past
    the true image edge with the edge flag off (66 % 5 == 1 would leave a
    1-row tail band ending exactly there)."""
    img4 = np.random.default_rng(46).integers(0, 256, (33, 29, 4), np.uint8)
    ref, refc = T.upscale(img4, 2.0, return_conv_map=True, device="cpu")  # dst_h = 66
    out, conv = T.upscale_chunked(img4, 2.0, band_rows=band, device="cpu")
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(conv, refc)


@pytest.mark.parametrize("depth", [1, 4])
def test_chunked_inflight_window_invariant(img, depth):
    """The in-flight window changes when results are fetched, never what
    they are."""
    ref, refc = T.upscale(img, 2.0, return_conv_map=True, device="cpu")
    out, conv = T.upscale_chunked(img, 2.0, band_rows=11, inflight_bands=depth,
                                  device="cpu")
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(conv, refc)


def test_chunked_edge_flags_per_band(img, monkeypatch):
    """Each band's conv stack gets flags (r0 == 0, r1 == dst_h, 1, 1) on
    its [bh+12, dst_w+12] halo plane; no cut lands on row 1 or dst_h-1."""
    seen = []
    plain = fused_conv.forward_y_reference

    def spy(params, y, h, w, flags=None, **kw):
        seen.append((tuple(y.shape), h, w, flags))
        return plain(params, y, h, w, flags, **kw)

    monkeypatch.setattr(fused_conv, "forward_y_reference", spy)
    out, _ = T.upscale_chunked(img, 2.0, band_rows=30, device="cpu")  # dst_h = 90
    assert out.shape == (90, 76, 3)
    assert seen == [((42, 88), 30, 76, (1, 0, 1, 1)), ((42, 88), 30, 76, (0, 0, 1, 1)),
                    ((42, 88), 30, 76, (0, 1, 1, 1))]
    cuts = chunked._cuts(66, 5, 6, "srcnn")
    assert 65 not in cuts and cuts[-1] == 60
    assert chunked._cuts(40, 1, 6, "srcnn") == list(range(2, 39))
    assert chunked._cuts(40, 5, 16, "vdsr") == [20]    # the HR rule: >= halo from the edges


@pytest.mark.parametrize("ft", [FilterType.BICUBIC, FilterType.LANCZOS3])
@pytest.mark.parametrize("dst,src", [(90, 45), (22, 45), (45, 45)])
def test_band_tables_rebuild_the_resize(ft, dst, src):
    """The global band tables equal the JAX package's, and gathering all
    rows with them equals the one-shot vertical resize bit for bit."""
    idx, w = chunked._global_band_tables(ft, dst, src)
    jidx, jw = jchunked._global_band_tables(J.FilterType(int(ft)), dst, src)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(w, jw)
    plane = torch.from_numpy(np.random.default_rng(47).uniform(
        0, 255, (src, 17)).astype(np.float32))
    got = chunked._apply_band_axis0(plane, torch.from_numpy(np.ascontiguousarray(idx.T)),
                                    torch.from_numpy(np.ascontiguousarray(w.T)))
    assert torch.equal(got, resize.resize_plane(plane, dst, 17, ft))


def test_chunked_validates():
    img = np.zeros((16, 16, 3), np.uint8)
    with pytest.raises(ValueError, match="unknown model"):
        T.upscale_chunked(img, 2.0, T.SRCNNConfig(model="nope"), device="cpu")
    out, conv = T.upscale_chunked(img, 2.0, T.SRCNNConfig(model="fsrcnn"),
                                  device="cpu")            # the zoo runs (M9)
    assert out.shape == (32, 32, 3) and conv.shape == (32, 32)
    with pytest.raises(ValueError, match="step_scale"):
        T.upscale_chunked(img, 4.0, T.SRCNNConfig(step_scale=True), device="cpu")
    for tier in ("bfloat16", "bfloat16_fast"):     # kernel-only tiers
        with pytest.raises(ValueError, match="tiers"):
            T.upscale_chunked(img, 2.0, T.SRCNNConfig(compute_dtype=tier),
                              device="cpu")
    with pytest.raises(ValueError, match="one-shot"):
        T.upscale_chunked(img, 2.0, T.SRCNNConfig(compute_dtype="int8"),
                          device="cpu")
    with pytest.raises(ValueError, match="not a tier"):
        T.upscale_chunked(img, 2.0, T.SRCNNConfig(compute_dtype="float16"),
                          device="cpu")
    with pytest.raises(ValueError, match="band_rows"):
        T.upscale_chunked(img, 2.0, band_rows=0, device="cpu")
    with pytest.raises(ValueError, match="inflight_bands"):
        T.upscale_chunked(img, 2.0, inflight_bands=0, device="cpu")
    with pytest.raises(ValueError, match="scale"):
        T.upscale_chunked(img, 0.01, device="cpu")
    with pytest.raises(ValueError, match="use_kernel=True"):
        T.upscale_chunked(img, 2.0, T.SRCNNConfig(use_kernel=True), device="cpu")
    with pytest.raises(TypeError):
        T.upscale_chunked(img.astype(np.float32), 2.0, device="cpu")
    with pytest.raises(ValueError):
        T.upscale_chunked(img[..., 0], 2.0, device="cpu")


def test_chunked_needs_a_card_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.upscale_chunked(np.zeros((8, 8, 3), np.uint8), 2.0)


def test_chunked_ensemble_matches_api(img):
    """Band-wise flip ensemble: per output band the four flip variants'
    bands (the mirrored plan for vertical flips), flipped back and
    averaged, equal the one-shot ensemble bit for bit."""
    cfg = T.SRCNNConfig(self_ensemble=True)
    ref, refc = T.upscale(img, 2.0, cfg, return_conv_map=True, device="cpu")
    out, conv = T.upscale_chunked(img, 2.0, cfg, band_rows=13, device="cpu")
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(conv, refc)


def test_chunked_ensemble_fractional_and_rgba():
    img4 = np.random.default_rng(47).integers(0, 256, (30, 26, 4), np.uint8)
    cfg = T.SRCNNConfig(self_ensemble=True)
    ref = T.upscale(img4, 2.4, cfg, device="cpu")
    out, _ = T.upscale_chunked(img4, 2.4, cfg, band_rows=11, device="cpu")
    np.testing.assert_array_equal(out, ref)
