"""The index math and integer arithmetic of K4 (``kernels/csrc/
fused_srcnn_int8.cu``, int8 on ``wgmma``), and the persistent tile walk of
K1, K2 and K4, on the CPU.

K4's choices, mirrored here:

* conv1's K order: 9 window rows x 12 columns in groups of 4 taps (group
  m = 3 dy + dx / 4; dx 9..11 and groups past 26 are zero rows), 128 rows,
  so that an A register's 4 bytes are 4 adjacent bytes of one window row,
  read as two aligned 32-bit words joined by a funnel shift;
* conv2 and the tap GEMM contract over the permuted channel order
  ``perm_ch`` in which a lane's requantized accumulators pack straight
  into s8 A registers;
* the requant ``clip(rint(acc * s + t), 0, 127)`` and the int -> f32
  conversion of the accumulators run with the 1.5 * 2^23 trick on the FMA
  pipe instead of ``cvt``.

An emulator with those orders gives int32 accumulators and an output equal
to ``fused_conv.forward_y_int8_reference`` and to the JAX package's int8
XLA twin, bit for bit.  The CUDA kernel is held to its plain version bit
for bit on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from libsrcnn_tpu.models import srcnn_int8 as jint8
from libsrcnn_tpu_torch.kernels import fused_conv
from libsrcnn_tpu_torch.models import srcnn_int8

NGRP, K1P = 27, 128       # conv1's tap groups (9 rows x 3) and its padded K
WW = 72                   # the kernel's window width: a 64-column ring + 8
MAGIC = np.float32(12582912.0)
MAGIC_BITS = np.uint32(0x4B400000)


def conv1_taps() -> list[int]:
    """conv1's GEMM row k -> tap 9 dy + dx, or -1 for a zero row: group
    m = k // 4 holds (m // 3, 4 (m % 3) + k % 4)."""
    taps = []
    for k in range(K1P):
        m = k // 4
        dx = 4 * (m % 3) + k % 4
        taps.append((m // 3) * 9 + dx if m < NGRP and dx < 9 else -1)
    return taps


def perm_ch(k: int) -> int:
    """The channel of logical GEMM row k of conv2 and of the tap GEMM."""
    s, h, q, u = k // 32, (k // 16) % 2, (k // 4) % 4, (k // 2) % 2
    return 8 * (4 * s + 2 * h + u) + 2 * q + k % 2


def int_to_float(acc: np.ndarray) -> np.ndarray:
    """The kernel's exact int -> f32 for |acc| < 2^22: the bits
    MAGIC_BITS + acc as an f32, less MAGIC."""
    bits = (MAGIC_BITS.astype(np.int64) + acc.astype(np.int64)).astype(np.uint32)
    return bits.view(np.float32) - MAGIC


def code_of(x: np.ndarray) -> np.ndarray:
    """The kernel's clip(rint(x), 0, 127): clip, add MAGIC (rounds half to
    even), take the low byte."""
    v = np.clip(x.astype(np.float32), np.float32(0), np.float32(127)) + MAGIC
    return (v.view(np.uint32) & 0xFF).astype(np.int64)


def requant(acc: np.ndarray, s: np.ndarray, t: np.ndarray) -> np.ndarray:
    return code_of(int_to_float(acc) * s.astype(np.float32) + t.astype(np.float32))


def forward_y_int8_wgmma(qp: dict, y_padded: torch.Tensor, h: int, w: int,
                         edge_flags=None, accs: dict | None = None) -> torch.Tensor:
    """K4's arithmetic on a halo plane [h+12, w+12] (or a batch) -> [h, w];
    ``accs`` receives conv1's and conv2's int accumulators [N, P, C]."""
    top, bottom, left, right = fused_conv._flags(edge_flags)
    squeeze = y_padded.dim() == 2
    y = y_padded[None] if squeeze else y_padded
    n = y.shape[0]
    xq = srcnn_int8.quantize_input(y).to(torch.float64)
    taps = conv1_taps()
    w1q = qp["w1q"].to(torch.float64)                         # [81, 64]
    w1k = torch.stack([w1q[t] if t >= 0 else torch.zeros(64, dtype=torch.float64)
                       for t in taps])                        # [128, 64]
    perm = [perm_ch(k) for k in range(64)]
    w2k = qp["w2q"].to(torch.float64)[perm]                   # [64, 32]
    w3k = srcnn_int8.w3_taps(qp["w3q"]).to(torch.float64).t()[perm[:32]]  # [32, 25]
    np_ = {k: v.numpy() for k, v in qp.items()}
    # integer GEMMs in f64 (exact: every sum is below 2^53)
    cols = F.unfold(xq[:, None], 9).transpose(1, 2)[..., [max(t, 0) for t in taps]]
    acc1 = (cols @ w1k).round().to(torch.int64).numpy()       # [N, P, 64]
    h1q = requant(acc1, np_["s1"], np_["t1"])
    acc2 = (torch.from_numpy(h1q[..., perm]).to(torch.float64) @ w2k).round() \
        .to(torch.int64).numpy()                              # [N, P, 32]
    c2q = requant(acc2, np_["s2"], np_["t2"])
    g = (torch.from_numpy(c2q[..., perm[:32]]).to(torch.float64) @ w3k).round() \
        .to(torch.int64)                                      # [N, P, 25]
    if accs is not None:
        accs.update(acc1=acc1, acc2=acc2)
    g = g.transpose(1, 2).reshape(n, 25, h + 4, w + 4)
    g = g.index_select(2, fused_conv._ring_index(h, top, bottom, "cpu"))
    g = g.index_select(3, fused_conv._ring_index(w, left, right, "cpu"))
    acc = torch.zeros(n, h, w, dtype=torch.int64)
    for dy in range(5):
        for dx in range(5):
            acc = acc + g[:, 5 * dy + dx, dy:dy + h, dx:dx + w]
    out = acc.numpy().astype(np.float32) * np_["d3"][0] + np_["b3"][0]
    out = torch.from_numpy(np.clip(out, np.float32(0), np.float32(255)))
    return out[0] if squeeze else out


@pytest.fixture(scope="module")
def qp():
    return srcnn_int8.load_params()


@pytest.fixture(scope="module")
def jpack():
    return jint8.load_params()


def _plane(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 255, shape).astype(np.float32))


def test_conv1_k_order_holds_every_tap_once():
    taps = conv1_taps()
    assert sorted(t for t in taps if t >= 0) == list(range(81))
    assert taps.count(-1) == K1P - 81
    for k in range(0, K1P, 4):             # a register's 4 rows: one window row
        real = [t for t in taps[k:k + 4] if t >= 0]
        assert real == list(range(real[0], real[0] + len(real))) if real else True
        assert len({t // 9 for t in real}) <= 1


@pytest.mark.parametrize("mrow", [16 * wp + g for wp in range(4) for g in range(8)])
def test_funnel_shift_reads_the_group_at_the_ring_column(mrow):
    """The kernel's conv1 A registers: words W = (a WW + mrow) / 4 + goff,
    goff = (dy WW + 4 (m % 3)) / 4 of group m = 8s + q + 4i, joined as
    funnelshift(W, W + 1, 8 (mrow % 4)) for the lane's row and (W + 2, W +
    3) for the row 8 columns right: bytes mrow + dx .. + 3 of window row
    a + dy."""
    rng = np.random.default_rng(66)
    wh = 17 + 9                             # ring rows 0..16
    win = rng.integers(0, 128, wh * WW + 16).astype(np.uint8)
    win[wh * WW:] = 0                       # the kernel's zeroed tail
    words = win.view(np.uint32).astype(np.uint64)
    sh = 8 * (mrow & 3)
    taps = conv1_taps()

    def fshift(lo, hi):
        return int(((hi << np.uint64(32)) | lo) >> np.uint64(sh)) & 0xFFFFFFFF

    for a in range(17):
        base = (a * WW + mrow) // 4
        for s, q, i in itertools.product(range(K1P // 32), range(4), range(2)):
            m = 8 * s + q + 4 * i
            mm = m if m < NGRP else 0       # a padding group reads group 0
            goff = ((mm // 3) * WW + 4 * (mm % 3)) // 4
            k = 32 * s + 16 * i + 4 * q     # the register's first row
            for col, w0 in ((mrow, base + goff), (mrow + 8, base + goff + 2)):
                reg = fshift(words[w0], words[w0 + 1])
                for e in range(4):
                    dy, dx = mm // 3, 4 * (mm % 3) + e
                    assert (reg >> (8 * e)) & 0xFF == win[(a + dy) * WW + col + dx]
                    assert taps[k + e] == (9 * dy + dx if m < NGRP and dx < 9 else -1)


def test_magic_int_to_float_is_exact():
    acc = np.concatenate([np.arange(-70000, 70000),
                          np.random.default_rng(67).integers(-(1 << 22) + 1, 1 << 22, 200000)])
    np.testing.assert_array_equal(int_to_float(acc), acc.astype(np.float32))


def test_magic_code_equals_clip_round(qp):
    """code_of(x) == clip(round half to even(x), 0, 127), as torch.round,
    on ties, near-ties, the clip edges and the shipped scales' outputs."""
    rng = np.random.default_rng(68)
    x = np.concatenate([np.arange(-300, 300) * np.float32(0.5),
                        rng.uniform(-1e4, 1e4, 100000).astype(np.float32),
                        np.nextafter(np.arange(-2, 130, dtype=np.float32) + np.float32(0.5),
                                     np.float32(-1e9)),
                        np.nextafter(np.arange(-2, 130, dtype=np.float32) + np.float32(0.5),
                                     np.float32(1e9)),
                        np.float32([-0.0, 126.5, 127.5, 1e30, -1e30])])
    want = torch.clamp(torch.round(torch.from_numpy(x)), 0, 127).to(torch.int64).numpy()
    np.testing.assert_array_equal(code_of(x), want)
    acc = rng.integers(-(1 << 21), 1 << 21, (4096, 64))
    s, t = qp["s1"].numpy(), qp["t1"].numpy()
    np.testing.assert_array_equal(
        requant(acc, s, t),
        srcnn_int8.fold_requant(torch.from_numpy(acc), qp["s1"], qp["t1"]).to(torch.int64).numpy())


@pytest.mark.parametrize("nj", [8, 4])
def test_accumulator_bytes_land_on_perm_ch(nj):
    """requant_a's packing: lane q's codes of n-group j (channels 8j + 2q
    and + 1) go to register (j / 4, 2 ((j / 2) % 2)) [+ 1 for row g + 8],
    bytes 2 (j % 2) and + 1 (two byte_perm steps); that register holds A
    columns 32 (j / 4) + 16 ((j / 2) % 2) + 4q + byte, whose channel is
    perm_ch of it."""
    for q in range(4):
        for j in range(nj):
            for v in range(2):
                ks, r, byte = j // 4, 2 * ((j // 2) % 2), 2 * (j % 2) + v
                k = 32 * ks + 16 * (r // 2) + 4 * q + byte
                assert perm_ch(k) == 8 * j + 2 * q + v
    assert sorted(perm_ch(k) for k in range(8 * nj)) == list(range(8 * nj))


@pytest.mark.parametrize("shape,flags", [
    ((37, 53), None), ((40, 61), (0, 1, 0, 1)), ((29, 33), (0, 0, 0, 0)),
    ((3, 3), None), ((1, 70), (1, 0, 1, 0)), ((70, 1), None),
])
def test_emulator_equals_plain_version(qp, shape, flags):
    h, w = shape
    yh = _plane((h + 12, w + 12), 69)
    accs = {}
    got = forward_y_int8_wgmma(qp, yh, h, w, flags, accs)
    ref = fused_conv.forward_y_int8_reference(qp, yh, h, w, flags)
    assert got.shape == (h, w) and torch.equal(got, ref)
    # the int32 accumulators equal the plain convs' (exact) sums
    xq = srcnn_int8.quantize_input(yh[None])
    acc2 = srcnn_int8.conv12(qp, xq).reshape(1, -1, 32)
    np.testing.assert_array_equal(accs["acc2"], acc2.to(torch.int64).numpy())
    x = xq.to(torch.float32)
    cols = torch.stack([x[:, dy:dy + h + 4, dx:dx + w + 4]
                        for dy in range(9) for dx in range(9)], dim=-1)
    acc1 = (cols @ qp["w1q"].to(torch.float32)).reshape(1, -1, 64)
    np.testing.assert_array_equal(accs["acc1"], acc1.to(torch.int64).numpy())


def test_emulator_batch_equals_planes(qp):
    ys = _plane((3, 32, 41), 70)
    got = forward_y_int8_wgmma(qp, ys, 20, 29, (0, 1, 1, 0))
    for i in range(3):
        assert torch.equal(got[i], forward_y_int8_wgmma(qp, ys[i], 20, 29, (0, 1, 1, 0)))


@pytest.mark.parametrize("shape", [(48, 48), (61, 90)])
def test_emulator_equals_jax_int8_twin(qp, jpack, shape):
    """With a replicate halo and every flag set, K4's arithmetic equals the
    JAX package's XLA twin (``models/srcnn_int8.forward_y``) bit for bit."""
    y = np.random.default_rng(71).uniform(0, 255, shape).astype(np.float32)
    ref = np.asarray(jint8.forward_y(jpack, jnp.asarray(y)))
    halo = F.pad(torch.from_numpy(y)[None, None], (6, 6, 6, 6), mode="replicate")[0, 0]
    np.testing.assert_array_equal(forward_y_int8_wgmma(qp, halo, *shape).numpy(), ref)


# --- the persistent tile walk (srcnn_wgmma.cuh: tile_at, persistent_grid) ----

#: kernel -> its output tile (TH, TW)
TILES = {"K1": (16, 60), "K2": (24, 60), "K4": (26, 60)}


def walk(n: int, h: int, w: int, th: int, tw: int, sms: int) -> list[list[tuple]]:
    """The tiles each block of the persistent grid visits, in order: grid =
    min(tiles, sms) blocks; block b takes tiles b, b + grid, ...; tile ->
    (plane, r0, q0) as tile_at computes it."""
    tr, tc = -(-h // th), -(-w // tw)
    tiles = tr * tc * n
    grid = min(tiles, sms)
    per_plane = tr * tc
    return [[(t // per_plane, (t % per_plane) // tc * th, (t % per_plane) % tc * tw)
             for t in range(b, tiles, grid)] for b in range(grid)]


@pytest.mark.parametrize("kernel", list(TILES))
@pytest.mark.parametrize("n,h,w", [(1, 2048, 2048), (6, 257, 301), (1, 3, 3), (2, 1, 70),
                                   (3, 70, 1), (2, 500, 1000), (1, 130, 250)])
def test_persistent_walk_covers_every_tile_once(kernel, n, h, w):
    th, tw = TILES[kernel]
    blocks = walk(n, h, w, th, tw, sms=132)
    visited = [t for b in blocks for t in b]
    assert len(visited) == len(set(visited))
    covered = np.zeros((n, h, w), np.int64)
    for plane, r0, q0 in visited:
        assert 0 <= plane < n and 0 <= r0 < h and 0 <= q0 < w
        covered[plane, r0:r0 + th, q0:q0 + tw] += 1       # ragged tiles clip
    assert (covered == 1).all()
    # a static stride: the blocks' loads differ by at most one tile
    lens = [len(b) for b in blocks]
    assert max(lens) - min(lens) <= 1 and len(blocks) <= 132
