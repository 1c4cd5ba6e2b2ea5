"""The model zoo (vdsr, srcnn955, fsrcnn, espcn) through every entry point
of the port on the CPU: ``upscale`` (step-scale, a fractional factor for
the HR families, the flip ensemble), ``process_srcnn``,
``upscale_frames``, ``VideoUpscaler`` and ``upscale_chunked``.

Against the JAX package: ``float32`` within 1 u8 on fewer than 2% of the
pixels (its convs and the port's sum in other orders, F2), and
``bfloat16`` likewise against the JAX package's own pipeline with every
conv's operands rounded to bf16 (its CPU backend computes that tier in
exact f32; see tests/test_torch_zoo_models.py).  Within the port, bit for
bit: the chunked path (the HR merge rule, LR bands on whole LR rows),
serving and the ensemble equal ``upscale``.  The validation errors match
the JAX package's.  Inputs are crops of the goldens' butterfly.
"""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import libsrcnn_tpu as J
import libsrcnn_tpu.models.fsrcnn as jfsrcnn
import libsrcnn_tpu.ops.packed_conv as jpacked
import libsrcnn_tpu.pipeline as jpipeline
import libsrcnn_tpu_torch as T
from libsrcnn_tpu_torch import api, pipeline

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "goldens.npz")
FAMILIES = ("vdsr", "srcnn955", "fsrcnn", "espcn")
TIERS = ("float32", "bfloat16")



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its convs are many small
    matmuls, and with the test workers' threads all spinning on the same
    cores they take many times longer than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def butterfly():
    with np.load(GOLDENS) as z:
        return z["in_butterfly_full"]


@pytest.fixture(scope="module")
def img(butterfly):
    return np.ascontiguousarray(butterfly[100:124, 90:110])        # 24x20


def _f2(a, b):
    """Within 1 u8, on fewer than 2% of the pixels."""
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 0.02, (d.max(), (d > 0).mean())


UPSCALE_CASES = ([(f, s, False) for f in ("vdsr", "srcnn955") for s in (2.0, 2.5)]
                 + [(f, s, False) for f in ("fsrcnn", "espcn") for s in (2.0, 3.0, 4.0)]
                 + [(f, 4.0, True) for f in FAMILIES])


@pytest.mark.parametrize("family,scale,step", UPSCALE_CASES)
def test_upscale_matches_jax(img, family, scale, step):
    jout, jconv = J.upscale(img, scale, J.SRCNNConfig(model=family, step_scale=step),
                            return_conv_map=True)
    tout, tconv = T.upscale(img, scale, T.SRCNNConfig(model=family, step_scale=step),
                            return_conv_map=True, device="cpu")
    _f2(tout, jout)
    _f2(tconv, jconv)


@pytest.mark.parametrize("family", FAMILIES)
def test_ensemble_matches_jax(img, family):
    jout = J.upscale(img, 2.0, J.SRCNNConfig(model=family, self_ensemble=True))
    tout = T.upscale(img, 2.0, T.SRCNNConfig(model=family, self_ensemble=True),
                     device="cpu")
    _f2(tout, jout)


def test_step_scale_ensemble_matches_jax(img):
    cfg = dict(model="vdsr", self_ensemble=True, step_scale=True)
    _f2(T.upscale(img, 4.0, T.SRCNNConfig(**cfg), device="cpu"),
        J.upscale(img, 4.0, J.SRCNNConfig(**cfg)))


def _bf16(a):
    return a.astype(jnp.bfloat16).astype(jnp.float32)


@pytest.fixture
def jax_bf16_pipeline(monkeypatch):
    """The JAX pipeline with every family conv's operands rounded to bf16 and
    run at HIGHEST; its compiled passes are dropped before and after, so
    that no other test sees them."""
    same = jpacked.conv_same

    def conv_same(x, w, precision=None, lane_pack=False):
        return same(_bf16(x), _bf16(w), lax.Precision.HIGHEST, False)

    def dilated(lhs, rhs, *a, **kw):
        kw["precision"] = lax.Precision.HIGHEST
        return lax.conv_general_dilated(_bf16(lhs), _bf16(rhs), *a, **kw)

    monkeypatch.setattr(jpacked, "conv_same", conv_same)
    monkeypatch.setattr(jfsrcnn, "lax", types.SimpleNamespace(
        conv_general_dilated=dilated, conv_transpose=lax.conv_transpose,
        Precision=lax.Precision))
    jpipeline.compiled_pass.cache_clear()
    yield
    jpipeline.compiled_pass.cache_clear()


@pytest.mark.parametrize("family,scale", [("vdsr", 2.0), ("srcnn955", 2.5),
                                          ("fsrcnn", 3.0), ("espcn", 2.0)])
def test_bfloat16_matches_bf16_operand_pipeline(img, jax_bf16_pipeline, family, scale):
    cfg = dict(model=family, compute_dtype="bfloat16")
    jout, jconv = J.upscale(img, scale, J.SRCNNConfig(**cfg), return_conv_map=True)
    tout, tconv = T.upscale(img, scale, T.SRCNNConfig(**cfg), return_conv_map=True,
                            device="cpu")
    _f2(tout, jout)
    _f2(tconv, jconv)
    # the tier is not float32 on the CPU either
    assert not np.array_equal(tconv, T.upscale(img, scale, T.SRCNNConfig(model=family),
                                               return_conv_map=True, device="cpu")[1])


# --- bit-identity within the port ------------------------------------------


@pytest.fixture(scope="module")
def frame(butterfly):
    return np.ascontiguousarray(butterfly[40:85, 60:98])               # 45x38


CHUNK_CASES = [
    ("vdsr", 2.0, 20), ("vdsr", 1.7, 9), ("vdsr", 0.5, 33),
    ("vdsr", 2.0, 5),          # cuts inside the 16 px halo merge into a neighbour
    ("srcnn955", 2.0, 13), ("srcnn955", 1.5, 7),
    ("fsrcnn", 2.0, 24), ("fsrcnn", 2.0, 4), ("fsrcnn", 3.0, 27),
    ("fsrcnn", 2.0, 7),        # rounded down to whole LR rows
    ("espcn", 2.0, 16), ("espcn", 2.0, 2), ("espcn", 4.0, 32), ("espcn", 3.0, 5),
]


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("family,scale,band", CHUNK_CASES)
def test_chunked_bitexact(frame, family, scale, band, tier):
    cfg = T.SRCNNConfig(model=family, compute_dtype=tier)
    ref, refc = T.upscale(frame, scale, cfg, return_conv_map=True, device="cpu")
    out, conv = T.upscale_chunked(frame, scale, cfg, band_rows=band, device="cpu")
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(conv, refc)


@pytest.mark.parametrize("family", FAMILIES)
def test_chunked_ensemble_bitexact(frame, family):
    cfg = T.SRCNNConfig(model=family, self_ensemble=True)
    ref, refc = T.upscale(frame, 2.0, cfg, return_conv_map=True, device="cpu")
    out, conv = T.upscale_chunked(frame, 2.0, cfg, band_rows=13, device="cpu")
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(conv, refc)


def test_chunked_rgba_and_inflight_window(butterfly):
    img4 = np.concatenate([butterfly[:30, :26], butterfly[30:60, :26, :1]], axis=-1)
    for family in ("vdsr", "espcn"):
        cfg = T.SRCNNConfig(model=family)
        ref = T.upscale(img4, 2.0, cfg, device="cpu")
        for depth in (1, 3):
            out, _ = T.upscale_chunked(img4, 2.0, cfg, band_rows=12,
                                       inflight_bands=depth, device="cpu")
            np.testing.assert_array_equal(out, ref)


def test_chunked_matches_jax_chunked(frame):
    for family, scale, band in (("vdsr", 2.0, 20), ("fsrcnn", 2.0, 24)):
        jout, _ = J.upscale_chunked(frame, scale, J.SRCNNConfig(model=family, lane_pack=False),
                                    band_rows=band)
        out, _ = T.upscale_chunked(frame, scale, T.SRCNNConfig(model=family),
                                   band_rows=band, device="cpu")
        _f2(out, jout)


@pytest.fixture(scope="module")
def clip(butterfly):
    return np.stack([butterfly[:20, :24], butterfly[30:50, 40:64], butterfly[90:110, 7:31]])


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("family", FAMILIES)
def test_serving_equals_frames(clip, family, tier):
    cfg = T.SRCNNConfig(model=family, compute_dtype=tier)
    singles = [T.upscale(f, 2.0, cfg, device="cpu") for f in clip]
    out = T.upscale_frames(clip, 2.0, cfg, device="cpu")
    assert out.shape == (3, 40, 48, 3)
    for o, s in zip(out, singles):
        np.testing.assert_array_equal(o, s)
    streamed = list(T.VideoUpscaler(2.0, cfg, device="cpu").stream(iter(clip)))
    assert len(streamed) == 3
    for o, s in zip(streamed, singles):
        np.testing.assert_array_equal(o, s)
    ens = T.SRCNNConfig(model=family, compute_dtype=tier, self_ensemble=True)
    e = T.upscale_frames(clip[:2], 2.0, ens, device="cpu")
    for o, f in zip(e, clip[:2]):
        np.testing.assert_array_equal(o, T.upscale(f, 2.0, ens, device="cpu"))
    assert not np.array_equal(e[0], singles[0])


@pytest.mark.parametrize("family", FAMILIES)
def test_process_srcnn_runs_the_configured_model(img, family):
    h, w, d = img.shape
    ref, refc = T.upscale(img, 2.0, T.SRCNNConfig(model=family), return_conv_map=True,
                          device="cpu")
    T.configure_filter_srcnn(T.FilterType.BICUBIC, False, device="cpu", model=family)
    try:
        rc, out, conv = T.process_srcnn(img.tobytes(), w, h, d, 2.0)
    finally:
        T.configure_filter_srcnn(T.FilterType.BICUBIC, False, device="cpu")
    assert rc == 0
    np.testing.assert_array_equal(out, ref.ravel())
    np.testing.assert_array_equal(conv, refc.ravel())


def test_default_params_keyed_by_model_tier_and_head(img):
    dev = api._device("cpu")
    fs = T.SRCNNConfig(model="fsrcnn")
    p2, p3 = api._params_on(None, fs, dev, 2.0), api._params_on(None, fs, dev, 3.0)
    assert (p2["__spec__"].scale, p3["__spec__"].scale) == (2, 3)
    step = T.SRCNNConfig(model="fsrcnn", step_scale=True)
    assert api._params_on(None, step, dev, 4.0) is p2     # chains the x2 head
    assert api._params_on(None, T.SRCNNConfig(model="vdsr"), dev, 3.0)["__spec__"].depth == 16
    assert "w1" in api._params_on(None, T.SRCNNConfig(), dev, 2.0)
    # a user's parameters, with their spec or without it (then from their shapes)
    es = T.SRCNNConfig(model="espcn")
    ep = pipeline.load_model_params(es, 3.0)
    ref = T.upscale(img, 3.0, es, device="cpu")
    np.testing.assert_array_equal(T.upscale(img, 3.0, es, params=ep, device="cpu"), ref)
    bare = {k: v for k, v in ep.items() if k != "__spec__"}
    np.testing.assert_array_equal(T.upscale(img, 3.0, es, params=bare, device="cpu"), ref)
    with pytest.raises(ValueError, match="scale 2 exactly"):
        # an fsrcnn head's scale is not in its shapes: without a spec it is
        # taken for x2, as the JAX package takes it
        T.upscale(img, 3.0, fs, params={k: v for k, v in p3.items() if k != "__spec__"},
                  device="cpu")


# --- validation: the JAX package's errors ----------------------------------


def _jax_error(fn):
    with pytest.raises(Exception) as e:
        fn()
    return e.value


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("tier", ["int8", "bfloat16_fast"])
def test_srcnn_only_tiers_raise(img, family, tier):
    jerr = _jax_error(lambda: J.upscale(img, 2.0, J.SRCNNConfig(model=family,
                                                                compute_dtype=tier)))
    cfg = T.SRCNNConfig(model=family, compute_dtype=tier)
    for call in (lambda: T.upscale(img, 2.0, cfg, device="cpu"),
                 lambda: T.upscale_frames(img[None], 2.0, cfg, device="cpu"),
                 lambda: T.VideoUpscaler(2.0, cfg, device="cpu"),
                 lambda: T.upscale_chunked(img, 2.0, cfg, device="cpu")):
        with pytest.raises(ValueError) as e:
            call()
        assert type(jerr) is ValueError and str(e.value) == str(jerr)


@pytest.mark.parametrize("family,scale,step", [("fsrcnn", 2.5, False), ("espcn", 3.5, False),
                                               ("fsrcnn", 5.0, True), ("espcn", 6.0, True)])
def test_lr_head_scale_errors_match_jax(img, family, scale, step):
    """An LR head takes its own scale exactly; under step-scale a
    fractional remainder pass raises the same error (test_zoo_scales.py)."""
    jerr = _jax_error(lambda: J.upscale(img, scale, J.SRCNNConfig(model=family,
                                                                  step_scale=step)))
    with pytest.raises(ValueError) as e:
        T.upscale(img, scale, T.SRCNNConfig(model=family, step_scale=step), device="cpu")
    assert type(jerr) is ValueError and str(e.value) == str(jerr)
    assert "exactly" in str(e.value)


def test_chunked_validates_families(img):
    with pytest.raises(ValueError, match="exactly"):
        T.upscale_chunked(img, 2.5, T.SRCNNConfig(model="fsrcnn"), device="cpu")
    with pytest.raises(ValueError, match="lane_pack"):
        T.upscale_chunked(img, 2.0, T.SRCNNConfig(model="espcn", lane_pack=True),
                          device="cpu")
    with pytest.raises(ValueError, match="step_scale"):
        T.upscale_chunked(img, 4.0, T.SRCNNConfig(model="vdsr", step_scale=True),
                          device="cpu")
    with pytest.raises(FileNotFoundError):
        T.upscale(img, 5.0, T.SRCNNConfig(model="espcn"), device="cpu")   # no x5 head
    with pytest.raises(ValueError, match="unknown model"):
        T.configure_filter_srcnn(2, device="cpu", model="nope")
    # lane_pack is the MXU's; the one-shot pass ignores it, as for srcnn
    np.testing.assert_array_equal(
        T.upscale(img, 2.0, T.SRCNNConfig(model="vdsr", lane_pack=True), device="cpu"),
        T.upscale(img, 2.0, T.SRCNNConfig(model="vdsr"), device="cpu"))
