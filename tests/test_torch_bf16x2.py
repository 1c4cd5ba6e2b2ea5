"""The arithmetic and index math of K2 (``kernels/csrc/fused_srcnn_bf16.cu``,
split-bf16x2 on ``wgmma``), on the CPU.

K2 runs every GEMM of the ``bfloat16`` tier on the tensor cores in bf16:
each activation x (the window, h1, c2) is split into ``hi = bf16(x)`` and
``lo = bf16(x - hi)``, the weights are rounded to bf16 once, and each GEMM
is two passes into one f32 accumulator, the lo pass over all of K first,
then the hi pass, k16 step by k16 step.  conv1's K order is the kernel's:
GEMM rows 2p and 2p + 1 are the taps (dy, dx) and (dy, dx + 1) of pair
p = 5 dy + dx / 2 (45 pairs, padded with zero rows to 96), so that one
32-bit shared load feeds an A register; a ring column of odd parity reads
the window planes that start one element later.  This file holds a
test-only emulator of that arithmetic -- conv1 as an im2col GEMM in the
pair order, conv2, conv3's tap GEMM into 25 tap planes, the ring clamp on
the tap planes and the fixed-order shift-add -- and holds it to K2's gate:

* within 5e-3 of ``fused_conv.forward_y_reference(precision="split")`` on
  [0, 255] planes, edge flags included (K2's gate against its plain
  version on the card);
* within 5e-3 of the JAX package's ``_kernel`` at ``precision=DEFAULT`` in
  Pallas interpret mode, in its full and halo modes.

The kernel's window addressing is checked against the planes it reads.
The CUDA kernel itself is held to the same gate on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from libsrcnn_tpu.kernels import fused_conv as jfused
from libsrcnn_tpu.models import srcnn as jsrcnn
from libsrcnn_tpu_torch.kernels import fused_conv
from libsrcnn_tpu_torch.models import srcnn

ATOL = 5e-3
NPAIR, K1P = 45, 96       # conv1's tap pairs (9 rows x 5) and its padded K
WW = 72                   # the kernel's window width: a 64-column ring + 8


def bf16(t: torch.Tensor) -> torch.Tensor:
    """Round f32 to bf16, to nearest even (``__float2bfloat16_rn``); kept
    as f32."""
    return t.to(torch.bfloat16).to(torch.float32)


def split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = bf16(t)
    return hi, bf16(t - hi)


def conv1_taps() -> list[int]:
    """conv1's GEMM row k -> tap 9 dy + dx, or -1 for a zero row: pair
    p = k // 2 holds (p // 5, 2 (p % 5)) and (p // 5, 2 (p % 5) + 1)."""
    taps = []
    for k in range(K1P):
        p, e = divmod(k, 2)
        dx = 2 * (p % 5) + e
        taps.append((p // 5) * 9 + dx if p < NPAIR and dx < 9 else -1)
    return taps


def gemm_split(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., K] x [K, N] as K2 computes it: the lo pass, then the hi pass,
    each k16 step by k16 step, into one f32 accumulator; ``w`` is bf16
    already."""
    xh, xl = split(x)
    acc = torch.zeros(x.shape[:-1] + (w.shape[1],))
    for part in (xl, xh):
        for k in range(0, x.shape[-1], 16):
            acc = acc + part[..., k:k + 16] @ w[k:k + 16]
    return acc


def forward_y_bf16x2(params: dict, y_padded: torch.Tensor, h: int, w: int,
                     edge_flags=None) -> torch.Tensor:
    """K2's arithmetic on a halo plane [h+12, w+12] (or a batch) -> [h, w]."""
    top, bottom, left, right = fused_conv._flags(edge_flags)
    squeeze = y_padded.dim() == 2
    y = y_padded[None] if squeeze else y_padded
    n = y.shape[0]
    taps = conv1_taps()
    w1 = params["w1"].reshape(64, 81).t()                  # [81, 64], tap 9 dy + dx
    w1k = torch.stack([w1[t] if t >= 0 else torch.zeros(64) for t in taps])
    w2 = bf16(params["w2"].reshape(32, 64).t())            # [64, 32]
    w3 = bf16(params["w3"].reshape(32, 25))                # [32, 25], tap 5 dy + dx
    # the c2 ring: positions (h+4) x (w+4), each a 9x9 window of the plane,
    # in the pair order (a zero row reads tap 0: finite, weight zero)
    cols = F.unfold(y[:, None], 9).transpose(1, 2)[..., [max(t, 0) for t in taps]]
    h1 = torch.relu(gemm_split(cols, bf16(w1k)) + params["b1"])
    c2 = torch.relu(gemm_split(h1, w2) + params["b2"])
    g = gemm_split(c2, w3).transpose(1, 2).reshape(n, 25, h + 4, w + 4)
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


def _plane(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 255, shape).astype(np.float32))


def test_pair_order_holds_every_tap_once():
    taps = conv1_taps()
    assert sorted(t for t in taps if t >= 0) == list(range(81))
    assert taps.count(-1) == K1P - 81
    # the two rows of a register (k, k + 1, k even) are adjacent columns of
    # one window row
    for k in range(0, K1P, 2):
        a, b = taps[k], taps[k + 1]
        if a >= 0 and b >= 0:
            assert b == a + 1 and a // 9 == b // 9


@pytest.mark.parametrize("mrow", range(64))
def test_im2col_words_hold_the_pair_at_the_ring_column(mrow):
    """The kernel's conv1 A registers, read as it reads them: 32-bit words
    of a bf16 plane (the one from element 1 on where the ring column is
    odd), at word base (a WW + mrow - parity) / 2 + toff, toff = (dy WW +
    dx) / 2 of pair 8s + q + 4i, and four words on for the row 8 columns
    to the right.  Each word holds the two taps of its GEMM rows."""
    wh = 9 + 8                                       # ring rows 0..8 suffice
    win = np.arange(wh * WW, dtype=np.int64)         # each element its index
    planes = [win, np.append(win[1:], -1)]           # from element 0 and 1
    taps = conv1_taps()
    par = mrow & 1
    words = planes[par].reshape(-1, 2)
    for a in range(9):
        base = (a * WW + mrow - par) // 2
        for s in range(K1P // 16):
            for q in range(4):
                for i in range(2):
                    p = 8 * s + q + 4 * i
                    pp = p if p < NPAIR else 0       # a padding pair reads pair 0
                    toff = ((pp // 5) * WW + 2 * (pp % 5)) // 2
                    k = 16 * s + 2 * q + 8 * i       # the register's first row
                    for col, word in ((mrow, base + toff), (mrow + 8, base + toff + 4)):
                        if col > 63:
                            continue
                        for e in range(2):
                            dy, dx = pp // 5, 2 * (pp % 5) + e
                            idx = (a + dy) * WW + col + dx
                            # past the plane only at dx 9 (a zero row), where
                            # the kernel's shifted plane ends in a 0 (here -1)
                            assert words[word][e] == (idx if idx < win.size else -1)
                            assert idx < win.size or dx == 9
                            # GEMM row k + e is that tap, or a zero row
                            assert taps[k + e] == (9 * dy + dx if p < NPAIR and dx < 9
                                                   else -1)


@pytest.mark.parametrize("shape,flags", [
    ((37, 53), None), ((96, 124), None), ((40, 61), (0, 1, 0, 1)),
    ((29, 33), (0, 0, 0, 0)), ((3, 3), None), ((1, 70), (1, 0, 1, 0)),
])
def test_emulator_matches_split_plain_version(params, shape, flags):
    h, w = shape
    yh = _plane((h + 12, w + 12), 61)
    got = forward_y_bf16x2(params, yh, h, w, flags)
    ref = fused_conv.forward_y_reference(params, yh, h, w, flags, precision="split")
    assert got.shape == (h, w)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)


def test_one_bf16_pass_misses_the_gate(params):
    """What the lo pass buys: without it (the hi pass alone, K3's bf16x1
    arithmetic on the same K order) the plane is far outside 5e-3."""
    h, w = 48, 64
    yh = _plane((h + 12, w + 12), 62)
    ref = fused_conv.forward_y_reference(params, yh, h, w, precision="split")
    hi_only = fused_conv.forward_y_reference(params, yh, h, w, precision="bf16x1")
    assert float((hi_only - ref).abs().max()) > 20 * ATOL
    assert float((forward_y_bf16x2(params, yh, h, w) - ref).abs().max()) <= ATOL


def test_emulator_batch_equals_planes(params):
    ys = _plane((3, 32, 41), 63)
    got = forward_y_bf16x2(params, ys, 20, 29, (0, 0, 0, 0))
    for i in range(3):
        assert torch.equal(got[i], forward_y_bf16x2(params, ys[i], 20, 29, (0, 0, 0, 0)))


@pytest.mark.parametrize("shape", [(37, 53), (96, 124)])
def test_emulator_matches_pallas_interpret(params, jparams, shape):
    """Against the JAX package's ``_kernel`` at ``precision=DEFAULT`` (the
    split-bf16x2 tier on the TPU) in Pallas interpret mode."""
    y = np.random.default_rng(64).uniform(0, 255, shape).astype(np.float32)
    ref = np.asarray(jfused.forward_y(jparams, jnp.asarray(y), interpret=True,
                                      precision=jax.lax.Precision.DEFAULT))
    got = forward_y_bf16x2(params, _halo_plane(y), *shape)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def test_emulator_matches_pallas_halo_mode(params, jparams):
    """Edge flags (0,1,0,1) against the Pallas kernel's halo mode at
    ``precision=DEFAULT``: top and left are interior borders whose ring
    comes from the real halo."""
    h, w = 37, 53
    yh = np.random.default_rng(65).uniform(0, 255, (h + 12, w + 12)).astype(np.float32)
    p = {k: jnp.asarray(v) for k, v in jparams.items()}
    ref = jfused._fused(
        jnp.asarray(yh), p["w1"].reshape(81, 64), p["b1"],
        p["w2"].reshape(64, 32), p["b2"],
        p["w3"][:, :, :, 0].transpose(1, 0, 2).reshape(25, 32),
        p["b3"].reshape(1), jnp.asarray([0, 1, 0, 1], jnp.int32),
        th=jfused.BF16_TH, interpret=True, pad_mode="halo",
        precision=jax.lax.Precision.DEFAULT)
    got = forward_y_bf16x2(params, torch.from_numpy(yh), h, w, (0, 1, 0, 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
