"""The arithmetic and index math of K3h (``kernels/csrc/fused_srcnn_bf16.cu``,
the ``HILO`` mode of the bf16 ``wgmma`` kernel), on the CPU.

K3h is the ``bfloat16`` tier with the JAX package's hi/lo pack
(``fused_conv.py::_kernel``, ``pack="hilo"``): the window is rounded once
to 32-bit words ``bf16(x) | bf16(x - bf16(x)) << 16``, hi in the low half,
and conv1 contracts them as one GEMM whose rows 2t and 2t + 1 are hi and lo
of tap t (81 taps padded to 88: K 176, 11 k16 steps) against ``bf16(w1)``
with each row duplicated (rows 162..175 zero).  On ``wgmma`` such a word is
exactly one bf16 A register.  conv2 and conv3's tap GEMM are K2's two
passes (``gemm_split``), then the ring clamp on the 25 tap planes and the
fixed-order shift-add.  This file holds a test-only emulator of that
arithmetic and holds it to K2's gate, 5e-3 (conv1 sums hi and lo products
inside each k16 step, so it is not bit-equal to K2):

* against ``fused_conv.forward_y_reference(precision="split")``, K3h's
  plain version, on [0, 255] planes, edge flags included;
* against the JAX package's ``_kernel`` with the hi/lo pack in Pallas
  interpret mode, in its full and halo modes.

The kernel's word layout is checked as the kernel reads it: every A
register's halves at the offsets it loads, and the B operand as
``stage_params`` writes it and ``wgmma`` addresses it.  The CUDA kernel
itself is held to the same gate on the card by tests/test_torch_cuda.py and
chip_smoke.py.
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
from test_torch_bf16x1_wgmma import _dot_k16, shift_add
from test_torch_bf16x2 import ATOL, bf16, gemm_split

K1H = 176                 # conv1's K: 81 taps x (hi, lo), padded to 88 taps
KS1 = K1H // 16           # its k16 steps
RH, WH, WW = 28, 36, 72   # K3h's c2 ring rows, window rows and columns


def bf16_bits(x) -> np.ndarray:
    """The bf16 bits of f32 values (round to nearest even), as uint32."""
    t = torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16).astype(np.uint32)


def hilo_words(x) -> np.ndarray:
    """f32 -> the kernel's window words: bf16(x) in the low half, bf16(x -
    bf16(x)) in the high half (x - bf16(x) is exact in f32)."""
    x = np.asarray(x, np.float32)
    hi = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()
    return bf16_bits(x) | (bf16_bits(x - hi) << 16)


def word_halves(words: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's words -> (hi, lo) as f32: GEMM rows 2t and 2t + 1."""
    words = words.astype(np.uint32)
    return (words << 16).view(np.float32), (words & 0xFFFF0000).view(np.float32)


def kernel_w1(params: dict) -> torch.Tensor:
    """conv1's B operand as K3h stages it: [176, 64], row k = bf16(w1) of
    tap k // 2 (both the hi and the lo row), zero past tap 80."""
    w1 = bf16(params["w1"].reshape(64, 81).t())            # [81, 64], tap 9 dy + dx
    return torch.cat([w1.repeat_interleave(2, 0), torch.zeros(K1H - 162, 64)])


def conv1_cols(y: torch.Tensor, lo: bool = True) -> torch.Tensor:
    """Halo planes [N, H, W] -> conv1's A operand at every ring position,
    [N, (H-8)(W-8), 176]: the 9x9 window's words split into their hi and lo
    rows; taps past 80 read tap 80 (finite, weight zero).  ``lo=False``
    zeroes the lo rows."""
    hi, lo_ = (torch.from_numpy(p.copy()) for p in word_halves(hilo_words(y.numpy())))
    if not lo:
        lo_ = torch.zeros_like(lo_)
    taps = [min(t, 80) for t in range(K1H // 2)]
    cols = [F.unfold(p[:, None], 9).transpose(1, 2)[..., taps] for p in (hi, lo_)]
    return torch.stack(cols, -1).reshape(cols[0].shape[:2] + (K1H,))


def forward_y_hilo(params: dict, y_padded: torch.Tensor, h: int, w: int,
                   edge_flags=None, *, lo: bool = True) -> torch.Tensor:
    """K3h's arithmetic on a halo plane [h+12, w+12] (or a batch) -> [h, w]:
    conv1 as one GEMM over K 176 in k16 steps, conv2 and the tap GEMM as
    K2's two passes, the ring clamp on the tap planes, the shift-add."""
    top, bottom, left, right = fused_conv._flags(edge_flags)
    squeeze = y_padded.dim() == 2
    y = y_padded[None] if squeeze else y_padded
    h1 = torch.relu(_dot_k16(conv1_cols(y, lo), kernel_w1(params)) + params["b1"])
    c2 = torch.relu(gemm_split(h1, bf16(params["w2"].reshape(32, 64).t())) + params["b2"])
    g = gemm_split(c2, bf16(params["w3"].reshape(32, 25)))
    g = g.transpose(1, 2).reshape(y.shape[0], 25, h + 4, w + 4)
    g = g.index_select(2, fused_conv._ring_index(h, top, bottom, "cpu"))
    g = g.index_select(3, fused_conv._ring_index(w, left, right, "cpu"))
    out = shift_add(g, h, w, params["b3"])
    return out[0] if squeeze else out


@pytest.fixture(scope="module")
def jparams():
    return jsrcnn.load_params()


@pytest.fixture(scope="module")
def params(jparams):
    return srcnn.params_from_jax({k: np.asarray(v) for k, v in jparams.items()})


def _plane(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 255, shape).astype(np.float32))


# --- the word layout --------------------------------------------------------


def test_words_hold_hi_low_and_lo_high():
    """A word's low half is bf16(x) and its high half bf16(x - bf16(x));
    hi + lo is x to within 2^-16 relative, and lo is not zero."""
    x = _plane((500,), 90).numpy()
    hi, lo = word_halves(hilo_words(x))
    assert np.array_equal(hi, bf16(torch.from_numpy(x)).numpy())
    assert np.array_equal(hilo_words(x) & 0xFFFF, bf16_bits(x))
    assert np.array_equal(lo, bf16(torch.from_numpy(x - hi)).numpy())
    assert np.abs(lo).max() > 0
    assert np.abs(hi + lo - x).max() <= 2.0 ** -16 * np.abs(x).max()


@pytest.mark.parametrize("mrow", range(64))
def test_a_registers_hold_hi_and_lo_of_their_tap(params, mrow):
    """The kernel's conv1 A registers, read as it reads them.  m64 row
    mrow is ring column mrow (K3h's ring is 64 wide: one ring row per m64
    tile), held by warp mrow // 16 as row g = mrow % 8 (col = 16 warp + g)
    or g + 8 (col + 8, eight words on).  Register 2i (+1 for row g + 8) of
    k16 step s is the word of tap 8s + q + 4i (tap 80 past the taps) at
    word (a WW + col) + (dy WW + dx): its low half, GEMM row 16s + 2q + 8i,
    is hi of that tap at the ring position, its high half, the next row,
    is lo; the weight rows of both are that tap's, or zero past tap 80."""
    win = _plane((WH, WW), 91).numpy()
    words = hilo_words(win)
    flat = words.reshape(-1)
    his, los = word_halves(words)
    bits = bf16_bits(win)
    wk = kernel_w1(params)
    w1 = bf16(params["w1"].reshape(64, 81).t())
    warp, g, upper = mrow // 16, mrow % 8, (mrow % 16) >= 8
    col = 16 * warp + g
    assert col + 8 * upper == mrow
    for s in range(KS1):
        for q in range(4):
            for i in range(2):
                t = 8 * s + q + 4 * i
                k = 16 * s + 2 * q + 8 * i              # the register's first row
                want = w1[t] if t < 81 else torch.zeros(64)
                assert torch.equal(wk[k], want) and torch.equal(wk[k + 1], want)
                dy, dx = divmod(min(t, 80), 9)
                for a in range(RH):
                    word = flat[a * WW + col + (dy * WW + dx) + 8 * upper]
                    r, c = a + dy, mrow + dx
                    assert r < WH and c < WW
                    assert word == words[r, c] and word & 0xFFFF == bits[r, c]
                    assert abs(his[r, c] + los[r, c] - win[r, c]) <= 2 ** -16 * win[r, c]


def b_word2(kc: int, k: int, n: int) -> int:
    """fused_srcnn_bf16.cu's b_word2<KC>: the word of elements (k, k + 1),
    k even, of a K-major bf16 B operand with KC core matrices along K."""
    return (((n >> 3) * kc + (k >> 3)) << 5) + ((n & 7) << 2) + ((k & 7) >> 1)


def test_w1_operand_as_staged_and_addressed(params):
    """``stage_params``' HILO loop over the 88 x 64 row-pair words fills
    every word of the 22,528-byte operand once, the zero rows 162..175 too;
    read back at the bytes the descriptor addresses (core matrix (n / 8,
    k / 8) at (n / 8) SBO + (k / 8) 128, SBO = 22 x 128, row n % 8 at 16
    bytes, element k % 8 at 2), element (k, n) is ``kernel_w1``'s: both
    rows of tap t are bf16(w1[t]), and no row past 161 reads anything but
    zero."""
    kc, sbo = K1H // 8, (K1H // 8) * 128
    w1 = params["w1"].reshape(64, 81).t().numpy()
    smem = np.full(K1H * 64 // 2, -1, np.int64)
    for i in range(K1H // 2 * 64):
        p, n = divmod(i, 64)
        v = bf16_bits(w1[p, n] if p < 81 else 0.0)
        idx = b_word2(kc, 2 * p, n)
        assert smem[idx] == -1
        smem[idx] = v | (v << 16)
    assert (smem >= 0).all() and 4 * smem.size == 22528
    halves = smem.astype(np.uint32).view(np.uint16)             # little-endian
    got = np.empty((K1H, 64), np.float32)
    for k in range(K1H):
        for n in range(64):
            byte = (n // 8) * sbo + (k // 8) * 128 + (n % 8) * 16 + (k % 8) * 2
            got[k, n] = (halves[byte // 2].astype(np.uint32) << 16).view(np.float32)
    assert np.array_equal(got, kernel_w1(params).numpy())
    assert not got[162:].any()


# --- the arithmetic --------------------------------------------------------


@pytest.mark.parametrize("shape,flags", [
    ((37, 53), None), ((96, 124), None), ((40, 61), (0, 1, 0, 1)),
    ((29, 33), (0, 0, 0, 0)), ((3, 3), None), ((1, 70), (1, 0, 1, 0)),
])
def test_emulator_matches_split_plain_version(params, shape, flags):
    h, w = shape
    yh = _plane((h + 12, w + 12), 92)
    got = forward_y_hilo(params, yh, h, w, flags)
    ref = fused_conv.forward_y_reference(params, yh, h, w, flags, precision="split",
                                         pack_im2col=True)
    assert got.shape == (h, w)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)


def test_dropping_lo_misses_the_gate(params):
    """What the lo rows buy: with the lo halves zeroed (conv1 on bf16(x)
    alone) the plane is far outside 5e-3."""
    h, w = 48, 64
    yh = _plane((h + 12, w + 12), 93)
    ref = fused_conv.forward_y_reference(params, yh, h, w, precision="split")
    assert float((forward_y_hilo(params, yh, h, w, lo=False) - ref).abs().max()) > 20 * ATOL
    assert float((forward_y_hilo(params, yh, h, w) - ref).abs().max()) <= ATOL


def test_emulator_batch_equals_planes(params):
    ys = _plane((3, 32, 41), 94)
    got = forward_y_hilo(params, ys, 20, 29, (0, 0, 0, 0))
    for i in range(3):
        assert torch.equal(got[i], forward_y_hilo(params, ys[i], 20, 29, (0, 0, 0, 0)))


@pytest.mark.parametrize("shape", [(37, 53), (96, 124)])
def test_emulator_matches_pallas_interpret(params, jparams, shape):
    """Against the JAX package's ``_kernel`` at ``precision=DEFAULT`` with
    the hi/lo pack in Pallas interpret mode."""
    y = np.random.default_rng(95).uniform(0, 255, shape).astype(np.float32)
    ref = np.asarray(jfused.forward_y(jparams, jnp.asarray(y), interpret=True,
                                      precision=jax.lax.Precision.DEFAULT,
                                      pack_im2col=True))
    yh = F.pad(torch.from_numpy(y)[None, None], (6, 6, 6, 6), mode="replicate")[0, 0]
    got = forward_y_hilo(params, yh, *shape)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def test_emulator_matches_pallas_halo_mode(params, jparams):
    """Edge flags (0,1,0,1) against the Pallas kernel's halo mode with the
    hi/lo pack: top and left are interior borders whose ring comes from
    the real halo."""
    h, w = 37, 53
    yh = np.random.default_rng(96).uniform(0, 255, (h + 12, w + 12)).astype(np.float32)
    p = {k: jnp.asarray(v) for k, v in jparams.items()}
    ref = jfused._fused(
        jnp.asarray(yh), p["w1"].reshape(81, 64), p["b1"],
        p["w2"].reshape(64, 32), p["b2"],
        p["w3"][:, :, :, 0].transpose(1, 0, 2).reshape(25, 32),
        p["b3"].reshape(1), jnp.asarray([0, 1, 0, 1], jnp.int32),
        th=jfused.BF16_TH, interpret=True, pad_mode="halo",
        precision=jax.lax.Precision.DEFAULT, pack_im2col=True)
    got = forward_y_hilo(params, torch.from_numpy(yh), h, w, (0, 1, 0, 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
