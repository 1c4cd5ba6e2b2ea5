"""The arithmetic of K1 (``kernels/csrc/fused_srcnn.cu``), 3xTF32, on the CPU.

K1 runs every GEMM of the exact tier on the tensor cores in tf32: each f32
operand x is split into ``hi = tf32_rna(x)`` and ``lo = tf32_rna(x - hi)``
and each GEMM is three passes summed in f32, lo*hi + hi*lo + hi*hi (lo*lo,
~2^-22 relative, is dropped).  This file holds a test-only emulator of that
arithmetic in PyTorch on the CPU -- conv1 as an im2col GEMM, conv2, conv3's
tap GEMM into 25 tap planes, the ring clamp on the tap planes as in
``fused_conv.forward_y_reference``, and the kernel's fixed-order shift-add
-- and holds it to the exact tier's gates:

* within 2e-3 of ``fused_conv.forward_y_reference`` (exact f32) on [0, 255]
  planes, edge flags included (K1's gate against its plain version on the
  card);
* within 2e-3 of the JAX package's exact ``_kernel`` in Pallas interpret
  mode;
* the port's CPU ``upscale`` with its conv stack swapped for the emulator
  keeps all 29 reference-binary goldens at <=1 u8 LSB (<2% of pixels).

The CUDA kernel itself is held to the same gates on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from libsrcnn_tpu.kernels import fused_conv as jfused
from libsrcnn_tpu.models import srcnn as jsrcnn
import libsrcnn_tpu_torch as lt
from libsrcnn_tpu_torch import pipeline
from libsrcnn_tpu_torch.kernels import fused_conv
from libsrcnn_tpu_torch.models import srcnn

ATOL = 2e-3
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "goldens.npz")
CHUNK = 1 << 15           # ring positions per GEMM chunk: bounds the memory


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """Round f32 to tf32 as ``cvt.rna.tf32.f32`` does: to nearest, ties away
    from zero, the low 13 mantissa bits cleared; kept as f32."""
    bits = t.contiguous().view(torch.int32).to(torch.int64)
    return ((bits + 0x1000) & ~0x1FFF).to(torch.int32).view(torch.float32)


def split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(t)
    return hi, tf32_rna(t - hi)


def gemm_3xtf32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., K] x [K, N] as K1 computes it: lo*hi, then hi*lo, then hi*hi,
    summed in f32."""
    xh, xl = split(x)
    wh, wl = split(w)
    return (xl @ wh + xh @ wl) + xh @ wh


def forward_y_tf32x3(params: dict, y_padded: torch.Tensor, h: int, w: int,
                     edge_flags=None) -> torch.Tensor:
    """K1's arithmetic on a halo plane [h+12, w+12] (or a batch) -> [h, w]."""
    top, bottom, left, right = fused_conv._flags(edge_flags)
    squeeze = y_padded.dim() == 2
    y = y_padded[None] if squeeze else y_padded
    n = y.shape[0]
    w1 = params["w1"].reshape(64, 81).t()              # [81, 64], tap 9 dy + dx
    w2 = params["w2"].reshape(32, 64).t()              # [64, 32]
    w3 = params["w3"].reshape(32, 25)                  # [32, 25], tap 5 dy + dx
    # the c2 ring: positions (h+4) x (w+4), each a 9x9 window of the plane
    cols = F.unfold(y[:, None], 9).transpose(1, 2)           # [N, P, 81]
    g = torch.empty(n, cols.shape[1], 25)
    for p0 in range(0, cols.shape[1], CHUNK):
        x = cols[:, p0:p0 + CHUNK]
        h1 = torch.relu(gemm_3xtf32(x, w1) + params["b1"])
        c2 = torch.relu(gemm_3xtf32(h1, w2) + params["b2"])
        g[:, p0:p0 + CHUNK] = gemm_3xtf32(c2, w3)
    g = g.transpose(1, 2).reshape(n, 25, h + 4, w + 4)
    # the ring clamp on the tap planes (a tap plane is a per-position
    # function of c2, so this equals clamping c2)
    g = g.index_select(2, fused_conv._ring_index(h, top, bottom, "cpu"))
    g = g.index_select(3, fused_conv._ring_index(w, left, right, "cpu"))
    out = torch.zeros(n, h, w)
    for dy in range(5):
        for dx in range(5):
            out = out + g[:, 5 * dy + dx, dy:dy + h, dx:dx + w]
    out = torch.clamp(out + params["b3"], 0.0, 255.0)
    return out[0] if squeeze else out


@pytest.fixture(scope="module")
def jparams():
    return jsrcnn.load_params()


@pytest.fixture(scope="module")
def params(jparams):
    return srcnn.params_from_jax({k: np.asarray(v) for k, v in jparams.items()})


def _halo_plane(y):
    return F.pad(torch.from_numpy(y)[None, None], (6, 6, 6, 6), mode="replicate")[0, 0]


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                        # tf32 keeps 10 mantissa bits
    # at 255 the tf32 step is 2^7 * ulp = 0.125
    x = torch.tensor([one, one + ulp / 2, one + ulp / 4, one + 3 * ulp / 4,
                      -(one + ulp / 2), 255.0 + 2.0 ** -4, 255.0 + 2.0 ** -5,
                      0.0, -0.0], dtype=torch.float32)
    got = tf32_rna(x)
    # ties (1 + ulp/2, 255 + 2^-4) go away from zero; to even they would
    # stay at 1 and 255
    want = [one, one + ulp, one, one + ulp, -(one + ulp), 255.125, 255.0, 0.0, -0.0]
    assert got.tolist() == want
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(torch.signbit(got[-1]))


def test_split_keeps_f32_to_2_pow_minus_21():
    x = torch.from_numpy(np.random.default_rng(51).uniform(-300, 300, 100000)
                         .astype(np.float32))
    hi, lo = split(x)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    rel = ((x.double() - hi.double() - lo.double()).abs() / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -21
    # and hi alone (one TF32 pass) is far coarser: what the split buys
    assert float(((x - hi).abs() / x.abs()).max()) > 2.0 ** -12


@pytest.mark.parametrize("shape,flags", [
    ((37, 53), None), ((96, 124), None), ((40, 61), (0, 1, 0, 1)),
    ((29, 33), (0, 0, 0, 0)),
])
def test_emulator_matches_exact_plain_version(params, shape, flags):
    h, w = shape
    yh = torch.from_numpy(np.random.default_rng(52).uniform(
        0, 255, (h + 12, w + 12)).astype(np.float32))
    got = forward_y_tf32x3(params, yh, h, w, flags)
    ref = fused_conv.forward_y_reference(params, yh, h, w, flags)
    assert got.shape == (h, w)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)


def test_emulator_batch_equals_planes(params):
    ys = torch.from_numpy(np.random.default_rng(53).uniform(
        0, 255, (3, 32, 41)).astype(np.float32))
    got = forward_y_tf32x3(params, ys, 20, 29)
    for i in range(3):
        assert torch.equal(got[i], forward_y_tf32x3(params, ys[i], 20, 29))


@pytest.mark.parametrize("shape", [(37, 53), (96, 124)])
def test_emulator_matches_pallas_interpret(params, jparams, shape):
    """Against the JAX package's exact ``_kernel`` (Precision.HIGHEST) in
    Pallas interpret mode, as tests/test_torch_kernel.py runs it."""
    y = np.random.default_rng(54).uniform(0, 255, shape).astype(np.float32)
    ref = np.asarray(jfused.forward_y(jparams, jnp.asarray(y), interpret=True))
    got = forward_y_tf32x3(params, _halo_plane(y), *shape)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def test_emulator_matches_pallas_halo_mode(params, jparams):
    """Edge flags (0,1,0,1) against the Pallas kernel's halo mode: top and
    left are interior borders whose ring comes from the real halo."""
    h, w = 37, 53
    yh = np.random.default_rng(55).uniform(0, 255, (h + 12, w + 12)).astype(np.float32)
    p = {k: jnp.asarray(v) for k, v in jparams.items()}
    ref = jfused._fused(
        jnp.asarray(yh), p["w1"].reshape(81, 64), p["b1"],
        p["w2"].reshape(64, 32), p["b2"],
        p["w3"][:, :, :, 0].transpose(1, 0, 2).reshape(25, 32),
        p["b3"].reshape(1), jnp.asarray([0, 1, 0, 1], jnp.int32),
        th=jfused.DEFAULT_TH, interpret=True, pad_mode="halo",
        precision=jax.lax.Precision.HIGHEST)
    got = forward_y_tf32x3(params, torch.from_numpy(yh), h, w, (0, 1, 0, 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDENS)


def _emulated_forward_y(params, y, tier="float32"):
    """``srcnn.forward_y``'s signature, through K1's arithmetic: a replicate
    halo and all four flags, which is what the exact tier computes."""
    assert tier == "float32"
    y = y.to(torch.float32)
    squeeze = y.dim() == 2
    yb = y[None] if squeeze else y
    halo = F.pad(yb[:, None], (6, 6, 6, 6), mode="replicate")[:, 0]
    out = forward_y_tf32x3(params, halo, *yb.shape[-2:])
    return out[0] if squeeze else out


@pytest.mark.parametrize("idx", range(29))
def test_goldens_through_emulated_k1(goldens, monkeypatch, idx):
    """The CPU main path with its conv stack swapped for K1's arithmetic
    keeps every reference-binary golden at <=1 u8 LSB (<2% of pixels)."""
    monkeypatch.setattr(pipeline.srcnn, "forward_y", _emulated_forward_y)
    key, name, mult, filt, step, _ms = str(goldens["meta"][idx]).split(",")
    cfg = lt.SRCNNConfig(filter=lt.FilterType(int(filt)), step_scale=bool(int(step)))
    out, conv = lt.upscale(goldens[f"in_{name}"], float(mult), cfg,
                           return_conv_map=True, device="cpu")
    gout, gconv = goldens[f"out_{key}"], goldens[f"conv_{key}"]
    assert out.shape == gout.shape and conv.shape == gconv.shape
    d = np.abs(out.astype(int) - gout.astype(int))
    assert d.max() <= 1, f"{key}: max u8 diff {d.max()}"
    assert (d > 0).mean() < 0.02, f"{key}: {100 * (d > 0).mean():.2f}% pixels differ"
    assert np.abs(conv.astype(int) - gconv.astype(int)).max() <= 1
