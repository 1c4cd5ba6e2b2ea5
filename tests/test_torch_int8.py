"""The port's int8 tier (``models/srcnn_int8``, ``fused_conv.forward_y_int8``
and the pipeline around them) on the CPU vs the JAX package.

The int8 convs are integer GEMMs, exact in any order, and the epilogues
are the JAX twin's unfused f32 multiply / add / round, so the port's plain
version equals JAX ``srcnn_int8.forward_y`` bit for bit.  The Pallas kernel
(interpret mode) may round a borderline requant to the neighbouring code
(the JAX package's own <=1 u8 contract, tests/test_int8.py), so the port is
held to <=1 u8 against it.  End to end the port's resize and color ops
differ from XLA's by <=1 LSB (tests/test_torch_pipeline.py), so ``upscale``
at int8 is held to <=1 LSB of JAX.  The CUDA kernel K4 is held to its
plain version bit for bit by tests/test_torch_cuda.py and chip_smoke.py.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libsrcnn_tpu as J
from libsrcnn_tpu.kernels import fused_conv as jfused
from libsrcnn_tpu.models import srcnn_int8 as jint8
import libsrcnn_tpu_torch as T
from libsrcnn_tpu_torch import pipeline
from libsrcnn_tpu_torch.eval import psnr
from libsrcnn_tpu_torch.kernels import fused_conv
from libsrcnn_tpu_torch.models import srcnn_int8

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "goldens.npz")
INT8 = T.SRCNNConfig(compute_dtype="int8")


@pytest.fixture(scope="module")
def jpack():
    return jint8.load_params()


@pytest.fixture(scope="module")
def qp():
    return srcnn_int8.load_params()


@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDENS)


def _lsb(a, b):
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def _image(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _halo_plane(y):
    return torch.nn.functional.pad(torch.as_tensor(y)[None, None],
                                   (6, 6, 6, 6), mode="replicate")[0, 0]


def test_pack_layout(qp):
    """Key inventory, dtypes and layouts of tools/calibrate_int8.py's pack
    (tests/test_int8.py:42-53); the calibration's a1 / a2 are dropped."""
    assert qp["w1q"].dtype == torch.int8 and qp["w1q"].shape == (81, 64)
    assert qp["w2q"].dtype == torch.int8 and qp["w2q"].shape == (64, 32)
    assert qp["w3q"].dtype == torch.int8 and qp["w3q"].shape == (25, 32)
    for k in ("s1", "t1"):
        assert qp[k].dtype == torch.float32 and qp[k].shape == (64,)
    for k in ("s2", "t2"):
        assert qp[k].dtype == torch.float32 and qp[k].shape == (32,)
    assert qp["d3"].shape == (1,) and qp["b3"].shape == (1,)
    assert "a1" not in qp and "a2" not in qp
    assert set(qp) == set(srcnn_int8.INT8_KEYS)


def test_pack_equals_jax_pack(qp, jpack):
    again = srcnn_int8.params_from_jax({k: np.asarray(v) for k, v in jpack.items()})
    assert set(jpack) == set(qp)
    for k in srcnn_int8.INT8_KEYS:
        assert torch.equal(qp[k], again[k])
        np.testing.assert_array_equal(qp[k].numpy(), np.asarray(jpack[k]))


def test_w3_tap_order_is_converted_once(qp, jpack):
    """The pack's w3q is tap-major with k = 5*dx + dy; ``w3_taps`` gives
    k = 5*dy + dx, which is the JAX twin's HWIO kernel (`srcnn_int8.py:98`)
    and the kernel's packed layout."""
    hwio = np.asarray(jpack["w3q"]).reshape(5, 5, 32).transpose(1, 0, 2)
    taps = srcnn_int8.w3_taps(qp["w3q"])
    np.testing.assert_array_equal(taps.numpy().reshape(5, 5, 32), hwio)
    # a marked weight lands where it should: dx = 1, dy = 3, channel 7
    w = torch.zeros(25, 32, dtype=torch.int8)
    w[5 * 1 + 3, 7] = 1
    assert srcnn_int8.w3_taps(w)[5 * 3 + 1, 7] == 1
    assert int(srcnn_int8.w3_taps(w).sum()) == 1


def test_pack_int8_params_layout(qp):
    packed = fused_conv.pack_int8_params(qp)
    assert packed.dtype == torch.uint8 and packed.numel() == 8812
    b = packed.numpy()
    np.testing.assert_array_equal(b[:5184].view(np.int8), qp["w1q"].numpy().ravel())
    np.testing.assert_array_equal(b[5184:7232].view(np.int8), qp["w2q"].numpy().ravel())
    np.testing.assert_array_equal(b[7232:8032].view(np.int8),
                                  srcnn_int8.w3_taps(qp["w3q"]).numpy().ravel())
    sc = b[8032:].view(np.float32)
    np.testing.assert_array_equal(sc[:64], qp["s1"].numpy())
    np.testing.assert_array_equal(sc[64:128], qp["t1"].numpy())
    np.testing.assert_array_equal(sc[128:160], qp["s2"].numpy())
    np.testing.assert_array_equal(sc[160:192], qp["t2"].numpy())
    assert sc[192] == qp["d3"][0] and sc[193] == qp["b3"][0]
    assert sc[194] == np.float32(127.0 / 255.0)


@pytest.mark.parametrize("shape", [(96, 124), (48, 48), (100, 140)])
def test_plain_twin_equals_jax_twin(qp, jpack, shape):
    """The integer convs are exact and the epilogues unfused in both, so
    the plain version equals JAX's XLA twin bit for bit."""
    y = np.random.default_rng(23).uniform(0, 255, shape).astype(np.float32)
    ref = np.asarray(jint8.forward_y(jpack, jnp.asarray(y)))
    got = srcnn_int8.forward_y(qp, torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_plain_twin_batched(qp):
    ys = torch.from_numpy(np.random.default_rng(24).uniform(0, 255, (2, 30, 41))
                          .astype(np.float32))
    got = srcnn_int8.forward_y(qp, ys)
    assert got.shape == (2, 30, 41)
    for i in range(2):
        assert torch.equal(got[i], srcnn_int8.forward_y(qp, ys[i]))


@pytest.mark.parametrize("shape", [(96, 124), (48, 48), (100, 140)])
def test_within_one_u8_of_pallas_int8_kernel(qp, jpack, shape):
    """vs the Pallas int8 kernel in interpret mode, as tests/test_int8.py
    runs it: <=1 u8 after output quantization, border pixels included."""
    y = np.random.default_rng(23).uniform(0, 255, shape).astype(np.float32)
    ref = np.asarray(jfused.forward_y_int8(jpack, jnp.asarray(y)))
    got = fused_conv.forward_y_int8(qp, _halo_plane(y), *shape).numpy()
    d = np.abs(np.floor(got).astype(int) - np.floor(ref).astype(int))
    assert d.max() <= 1


@pytest.mark.parametrize("shape", [(37, 53), (5, 2), (1, 30)])
def test_reference_with_all_flags_equals_twin(qp, shape):
    y = np.random.default_rng(25).uniform(0, 255, shape).astype(np.float32)
    twin = srcnn_int8.forward_y(qp, torch.from_numpy(y))
    got = fused_conv.forward_y_int8_reference(qp, _halo_plane(y), *shape)
    assert torch.equal(got, twin)


@pytest.mark.parametrize("r0,c0,h,w", [
    (10, 12, 20, 25),    # interior on every side: flags (0, 0, 0, 0)
    (0, 0, 17, 21),      # top-left corner
    (23, 5, 17, 30),     # bottom edge
    (3, 40, 9, 20),      # right edge
])
def test_reference_with_flags_equals_cropped_twin(qp, r0, c0, h, w):
    """A window of a larger plane, its halo taken from the real
    neighbours (replicated only past the image): with the edge flags of
    the window's true edges it equals the twin on the whole plane,
    cropped."""
    big_h, big_w = 40, 60
    y = np.random.default_rng(26).uniform(0, 255, (big_h, big_w)).astype(np.float32)
    twin = srcnn_int8.forward_y(qp, torch.from_numpy(y))
    yp = _halo_plane(y)
    flags = (int(r0 == 0), int(r0 + h == big_h), int(c0 == 0), int(c0 + w == big_w))
    got = fused_conv.forward_y_int8_reference(
        qp, yp[r0:r0 + h + 12, c0:c0 + w + 12].contiguous(), h, w, flags)
    assert torch.equal(got, twin[r0:r0 + h, c0:c0 + w])
    if flags != (1, 1, 1, 1) and 0 in flags[:2]:
        # the flags matter: claiming every border is an edge changes pixels
        edges = fused_conv.forward_y_int8_reference(
            qp, yp[r0:r0 + h + 12, c0:c0 + w + 12].contiguous(), h, w)
        assert not torch.equal(edges, got)


def test_wrapper_on_cpu_runs_plain_version(qp):
    ys = torch.from_numpy(np.random.default_rng(27).uniform(0, 255, (3, 32, 41))
                          .astype(np.float32))
    before = dict(fused_conv.launches_by)
    got = fused_conv.forward_y_int8(qp, ys, 20, 29, (1, 0, 1, 0))
    assert got.shape == (3, 20, 29)
    for i in range(3):
        assert torch.equal(got[i], fused_conv.forward_y_int8_reference(
            qp, ys[i], 20, 29, (1, 0, 1, 0)))
    assert fused_conv.launches_by == before and fused_conv.launches == 0


def test_wrapper_rejects_bad_input(qp):
    y = torch.zeros(32, 32)
    with pytest.raises(ValueError):
        fused_conv.forward_y_int8(qp, torch.zeros(30, 30), 20, 20)
    with pytest.raises(ValueError):
        fused_conv.forward_y_int8(qp, y, 20, 20, (1, 1, 1))
    with pytest.raises(ValueError, match="quantized pack"):
        fused_conv.forward_y_int8({"w1": torch.zeros(1)}, y, 20, 20)
    bad = dict(qp, w1q=qp["w1q"].to(torch.float32))
    with pytest.raises(ValueError, match="w1q"):
        fused_conv.forward_y_int8(bad, y, 20, 20)
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv.launch("K4", fused_conv.pack_int8_params(qp), y,
                          torch.empty(20, 20))
    with pytest.raises(ValueError, match="uint8"):
        fused_conv.launch("K4", torch.zeros(8812), y, torch.empty(20, 20))


@pytest.mark.parametrize("shape,scale,filt", [
    ((24, 31, 4), 2.0, 2),     # RGBA
    ((23, 30, 3), 1.37, 3),    # fractional, lanczos
    ((40, 36, 3), 0.5, 2),     # downscale
    ((15, 13, 3), 3.0, 4),     # bspline
])
def test_upscale_int8_matches_jax(shape, scale, filt):
    img = _image(shape, 28)
    jcfg = J.SRCNNConfig(filter=J.FilterType(filt), compute_dtype="int8",
                         use_pallas=False)
    tcfg = T.SRCNNConfig(filter=T.FilterType(filt), compute_dtype="int8")
    jout, jconv = J.upscale(img, scale, jcfg, return_conv_map=True)
    tout, tconv = T.upscale(img, scale, tcfg, return_conv_map=True, device="cpu")
    assert tout.shape == jout.shape and tout.dtype == np.uint8
    assert _lsb(tout, jout) <= 1 and _lsb(tconv, jconv) <= 1


def test_upscale_int8_quality_vs_exact(goldens):
    """butterfly 256^2 at x2: >= 38 dB PSNR against the exact tier
    (tests/test_int8.py:88-98; the shipped pack measures ~40 dB)."""
    b = goldens["in_butterfly_full"]
    exact = T.upscale(b, 2.0, device="cpu")
    q = T.upscale(b, 2.0, INT8, device="cpu")
    assert q.shape == exact.shape and psnr(q, exact) >= 38.0


def test_step_scale_int8(goldens):
    """Chained x2 passes at int8: quantization error compounds, so >= 33 dB
    against the exact chain (tests/test_int8.py:101-110), and <=1 LSB of
    the JAX package."""
    b = goldens["in_butterfly64"]
    cfg = T.SRCNNConfig(compute_dtype="int8", step_scale=True)
    out = T.upscale(b, 4.0, cfg, device="cpu")
    assert out.shape == (256, 256, 3)
    exact = T.upscale(b, 4.0, T.SRCNNConfig(step_scale=True), device="cpu")
    assert psnr(out, exact) >= 33.0
    jout = J.upscale(b, 4.0, J.SRCNNConfig(compute_dtype="int8", step_scale=True,
                                           use_pallas=False))
    assert _lsb(out, jout) <= 1


def test_serving_int8_equals_upscale(goldens):
    b = goldens["in_butterfly64"]
    clip = np.stack([b[:32, :40], b[32:, :40], b[16:48, 24:]])
    out = T.upscale_frames(clip, 2.0, INT8, device="cpu")
    singles = [T.upscale(f, 2.0, INT8, device="cpu") for f in clip]
    for o, s in zip(out, singles):
        np.testing.assert_array_equal(o, s)
    streamed = list(T.VideoUpscaler(2.0, INT8, device="cpu").stream(clip))
    for o, s in zip(streamed, singles):
        np.testing.assert_array_equal(o, s)


def test_ensemble_int8_equals_upscale(goldens):
    b = goldens["in_butterfly64"]
    clip = np.stack([b[:24, :30], b[30:54, 20:50]])
    ens = T.SRCNNConfig(compute_dtype="int8", self_ensemble=True)
    out = T.upscale_frames(clip, 2.0, ens, device="cpu")
    for f, o in zip(clip, out):
        np.testing.assert_array_equal(o, T.upscale(f, 2.0, ens, device="cpu"))
    assert not np.array_equal(out[0], T.upscale(clip[0], 2.0, INT8, device="cpu"))


def test_int8_params_keep_their_dtypes(jpack):
    """The tier loads its own pack by default, takes a user's pack (numpy
    or tensors) with its int8 dtypes, and refuses f32 weights."""
    img = _image((20, 18, 3), 29)
    ref = T.upscale(img, 2.0, INT8, device="cpu")
    user = {k: np.asarray(v) for k, v in jpack.items()}
    np.testing.assert_array_equal(T.upscale(img, 2.0, INT8, params=user,
                                            device="cpu"), ref)
    with pytest.raises(ValueError, match="quantized pack"):
        T.upscale(img, 2.0, INT8, params=T.api.SRCNN915(), device="cpu")
    p = pipeline.load_model_params(INT8)
    assert p["w1q"].dtype == torch.int8 and p["s1"].dtype == torch.float32
    f = pipeline.load_model_params(T.SRCNNConfig(compute_dtype="bfloat16"))
    assert f["w1"].dtype == torch.float32 and f["w1"].shape == (64, 1, 9, 9)
