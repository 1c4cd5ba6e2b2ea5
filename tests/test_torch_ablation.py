"""The stage cuts (``kernels/ablation``: K6 cuts of K1-K3, K7 cuts of K4)
vs the JAX package, and ``utils/profiling`` on the CPU.

The JAX ablation kernels cannot run here (their ``pallas_call`` takes no
``interpret``), so each cut's plain version is compared with values built
from the JAX package's own functions:

* K1: ``models.srcnn._conv`` / ``edge_pad`` (f32 HIGHEST) and, for the
  ``taps`` cut, ``kernels.fused_conv._dot`` at HIGHEST, the channels
  summed in numpy (f64);
* K2 / K3: ``kernels.fused_conv._dot`` in the kernel's precision (split /
  BF16X1) on the im2col'd window, the same sums;
* K4: ``models.srcnn_int8.quantize_input`` / ``_conv_i8`` /
  ``fold_requant``, integer sums: bit for bit.

A cut's values are sums of up to 64 channels, up to ~1e4, not pixels in
[0, 255].  So each float cut is held to its kernel's gate on [0, 255]
planes (tests/test_torch_kernel.py) after scaling the plane's error by
255 / max(255, max |value|): K1 2e-3; K2 5e-3; K3 p99.9 0.05 and max 2.0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libsrcnn_tpu.kernels import fused_conv as jfused
from libsrcnn_tpu.models import srcnn as jsrcnn
from libsrcnn_tpu.models import srcnn_int8 as jint8
from libsrcnn_tpu_torch.kernels import ablation, fused_conv
from libsrcnn_tpu_torch.models import srcnn, srcnn_int8
from libsrcnn_tpu_torch.tools import int8_ablation, kernel_ablation, trace_kernel
from libsrcnn_tpu_torch.utils import profiling

H, W = 29, 37
GATE = {"K1": 2e-3, "K2": 5e-3}
BF16X1_MAX, BF16X1_P999 = 2.0, 0.05
JAX_PRECISION = {"K2": jax.lax.Precision.DEFAULT, "K3": jfused.BF16X1}


@pytest.fixture(scope="module")
def jparams():
    return jsrcnn.load_params()


@pytest.fixture(scope="module")
def params(jparams):
    return srcnn.params_from_jax({k: np.asarray(v) for k, v in jparams.items()})


@pytest.fixture(scope="module")
def jpack():
    return jint8.load_params()


@pytest.fixture(scope="module")
def qp():
    return srcnn_int8.load_params()


@pytest.fixture(scope="module")
def plane():
    """A seeded Y plane with a replicate halo (JAX ``edge_pad``): [H+12,
    W+12] f32."""
    y = np.random.default_rng(41).uniform(0, 255, (1, H, W, 1)).astype(np.float32)
    return np.array(jsrcnn.edge_pad(jnp.asarray(y), 6))[0, :, :, 0]


def _windows(yh):
    """The 9x9 windows of each output pixel's own c2 ring position,
    im2col'd: [H*W, 81], tap k = 9 dy + dx."""
    x = yh[2:H + 10, 2:W + 10]
    return np.stack([x[dy:dy + H, dx:dx + W] for dy in range(9) for dx in range(9)],
                    -1).reshape(H * W, 81)


def _jax_float_cut(kernel, stage, jparams, yh):
    """The cut's values from the JAX package's functions."""
    if stage == "load":
        x = yh[6:6 + H, 6:6 + W]
        if kernel == "K1":
            return x
        hi = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
        if kernel == "K3":
            return hi
        lo = np.asarray(jnp.asarray(x - hi).astype(jnp.bfloat16).astype(jnp.float32))
        return hi + lo
    p = {k: jnp.asarray(v, jnp.float32) for k, v in jparams.items()}
    prec = JAX_PRECISION.get(kernel, jax.lax.Precision.HIGHEST)
    dims = (((1,), (0,)), ((), ()))
    if kernel == "K1":
        x = jnp.asarray(yh[2:H + 10, 2:W + 10])[None, :, :, None]
        h1 = jnp.maximum(jsrcnn._conv(x, p["w1"]) + p["b1"], 0.0)
        c2 = jnp.maximum(jsrcnn._conv(h1, p["w2"]) + p["b2"], 0.0)
    else:
        cols = jnp.asarray(_windows(yh))
        h1 = jnp.maximum(jfused._dot(cols, p["w1"].reshape(81, 64), dims, prec)
                         + p["b1"], 0.0)
        c2 = jnp.maximum(jfused._dot(h1, p["w2"].reshape(64, 32), dims, prec)
                         + p["b2"], 0.0)
    if stage == "taps":
        # conv3's GEMM against the 25 tap vectors (K1: at HIGHEST)
        w3 = p["w3"][:, :, :, 0].reshape(25, 32).T              # [32, 25]
        g = jfused._dot(c2, w3, (((c2.ndim - 1,), (0,)), ((), ())), prec)
        return np.asarray(g, np.float64).sum(-1).reshape(H, W)
    v = h1 if stage == "conv1" else c2
    return np.asarray(v, np.float64).sum(-1).reshape(H, W)


def _assert_cut_close(kernel, got, ref):
    d = np.abs(np.asarray(got, np.float64) - ref) * 255.0 / max(255.0, np.abs(ref).max())
    if kernel == "K3":
        assert d.max() <= BF16X1_MAX, d.max()
        assert np.quantile(d, 0.999) <= BF16X1_P999, np.quantile(d, 0.999)
    else:
        assert d.max() <= GATE[kernel], d.max()


@pytest.mark.parametrize("kernel,stage", [
    (k, s) for k in ("K1", "K2", "K3") for s in ablation.STAGES[k] if s != "full"])
def test_float_cut_reference_matches_jax(params, jparams, plane, kernel, stage):
    got = ablation.forward_y_cut_reference(kernel, stage, params,
                                           torch.from_numpy(plane), H, W)
    assert got.shape == (H, W) and got.dtype == torch.float32
    _assert_cut_close(kernel, got.numpy(), _jax_float_cut(kernel, stage, jparams, plane))


def _jax_int8_cut(stage, jpack, yh):
    xq = jint8.quantize_input(jnp.asarray(yh))
    if stage == "load":
        return np.asarray(xq[6:6 + H, 6:6 + W]).astype(np.int64)
    x = xq[2:H + 10, 2:W + 10][None, :, :, None]
    h1q = jint8.fold_requant(jint8._conv_i8(x, jpack["w1q"].reshape(9, 9, 1, 64)),
                             jpack["s1"], jpack["t1"])
    if stage == "conv1":
        return np.asarray(h1q, np.int64).sum(-1)[0]
    c2q = jint8.fold_requant(jint8._conv_i8(h1q, jpack["w2q"].reshape(1, 1, 64, 32)),
                             jpack["s2"], jpack["t2"])
    if stage == "conv2":
        return np.asarray(c2q, np.int64).sum(-1)[0]
    # the 25 tap products at the pixel's own position (the sum is the same
    # in either tap order)
    g = jint8._conv_i8(c2q, jpack["w3q"].T.reshape(1, 1, 32, 25))
    return np.asarray(g, np.int64).sum(-1)[0]


@pytest.mark.parametrize("stage", [s for s in ablation.STAGES["K4"] if s != "full"])
def test_int8_cut_reference_equals_jax(qp, jpack, plane, stage):
    got = ablation.forward_y_cut_reference("K4", stage, qp, torch.from_numpy(plane), H, W)
    ref = _jax_int8_cut(stage, jpack, plane)
    assert np.abs(ref).max() < 2 ** 24
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.float32))


@pytest.mark.parametrize("kernel", list(ablation.STAGES))
def test_full_cut_is_the_kernels_plain_version(params, qp, plane, kernel):
    """``full`` is the kernel: its plain version is the kernel's, edge
    flags included; the cuts' values do not depend on the flags."""
    p = qp if kernel == "K4" else params
    y = torch.from_numpy(plane)
    for flags in (None, (0, 1, 0, 1)):
        got = ablation.forward_y_cut(kernel, "full", p, y, H, W, flags)
        ref = (fused_conv.forward_y_int8_reference(p, y, H, W, flags) if kernel == "K4"
               else fused_conv.forward_y_reference(
                   p, y, H, W, flags, precision=ablation.PRECISION[kernel]))
        assert torch.equal(got, ref)
    for stage in ablation.STAGES[kernel][:-1]:
        assert torch.equal(ablation.forward_y_cut(kernel, stage, p, y, H, W),
                           ablation.forward_y_cut(kernel, stage, p, y, H, W, (0, 0, 0, 0)))


@pytest.mark.parametrize("kernel", list(ablation.STAGES))
def test_cuts_batch_and_count_nothing_on_cpu(params, qp, kernel):
    """A batch of planes equals the planes one at a time, and the CPU
    wrapper launches nothing."""
    p = qp if kernel == "K4" else params
    ys = torch.from_numpy(np.random.default_rng(42).uniform(
        0, 255, (2, 32, 41)).astype(np.float32))
    before = dict(fused_conv.launches_by)
    for stage in ablation.STAGES[kernel]:
        got = ablation.forward_y_cut(kernel, stage, p, ys, 20, 29)
        assert got.shape == (2, 20, 29)
        for i in range(2):
            assert torch.equal(got[i], ablation.forward_y_cut_reference(
                kernel, stage, p, ys[i], 20, 29))
    assert fused_conv.launches_by == before


@pytest.mark.parametrize("kernel,stage,match", [
    ("K1", "dma", "stage"), ("K2", "dma", "stage"), ("K4", "quant", "stage"),
    ("K3h", "load", "cut kernels"), ("K5", "full", "cut kernels"),
])
def test_cut_rejects_bad_kernel_or_stage(params, kernel, stage, match):
    y = torch.zeros(32, 32)
    with pytest.raises(ValueError, match=match):
        ablation.forward_y_cut(kernel, stage, params, y, 20, 20)
    with pytest.raises(ValueError, match=match):
        ablation.forward_y_cut_reference(kernel, stage, params, y, 20, 20)


@pytest.mark.parametrize("y,h,w", [(torch.zeros(30, 30), 20, 20),
                                   (torch.zeros(32, 32, dtype=torch.float64), 20, 20)])
def test_cut_rejects_non_halo_planes(params, y, h, w):
    with pytest.raises((ValueError, TypeError)):
        ablation.forward_y_cut("K1", "conv1", params, y, h, w)


def test_cut_launch_takes_cuda_tensors_only(params, qp):
    y, out = torch.zeros(32, 41), torch.empty(20, 29)
    with pytest.raises(ValueError, match="CUDA"):
        ablation.launch_cut("K3", "conv2", fused_conv.pack_params(params), y, out)
    with pytest.raises(ValueError, match="CUDA"):
        ablation.launch_cut("K4", "taps", fused_conv.pack_int8_params(qp), y, out)


def test_int8_cut_takes_the_int8_pack(params):
    with pytest.raises(ValueError, match="pack"):
        ablation.forward_y_cut("K4", "conv1", params, torch.zeros(32, 32), 20, 20)


# --- utils/profiling --------------------------------------------------------


def test_stage_timer_on_cpu_uses_the_host_clock():
    t = profiling.StageTimer("cpu")
    for _ in range(3):
        with t.stage("a"):
            sum(range(1000))
    with t.stage("b"):
        pass
    assert list(t.times) == ["a", "b"] and len(t.times["a"]) == 3
    assert all(v >= 0 for v in t.times["a"])
    assert "host clock" in t.report() and "median of 3" in t.report()
    assert profiling.median_ms(lambda: None, "cpu", runs=4) >= 0
    with pytest.raises(ValueError, match="CPU or CUDA"):
        profiling.StageTimer("meta")


def test_sync_and_trace_on_cpu(tmp_path):
    x = torch.ones(8)
    with profiling.trace(str(tmp_path / "tb")) as prof:
        (x * 2).sum()
    assert (tmp_path / "tb" / "trace.json").stat().st_size > 0
    assert any("mul" in e.key for e in prof.key_averages())


def test_profiling_tools_need_a_card():
    """The tools time CUDA kernels: without a card they raise, and they
    check their arguments first."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_ablation.ablate("K1", 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        int8_ablation.main(["64"])
    with pytest.raises(RuntimeError, match="CUDA"):
        trace_kernel.capture(64, "bf16x1band", 1, 12)
    with pytest.raises(ValueError, match="mode"):
        trace_kernel.capture(64, "fast")
    with pytest.raises(ValueError, match="band height"):
        trace_kernel.capture(64, "exact", 1, 12)
    assert set(trace_kernel.MODES.values()) == set(fused_conv._KERNELS)
    assert kernel_ablation.MODES == {"exact": "K1", "split": "K2", "bf16x1": "K3"}
