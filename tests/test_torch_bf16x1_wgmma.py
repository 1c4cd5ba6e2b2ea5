"""The arithmetic and index math of K3, K3n and K5 (``kernels/csrc/
fused_srcnn_bf16.cu``, bf16x1 on ``wgmma``), on the CPU.

K3 runs every GEMM of the ``bfloat16_fast`` tier on the tensor cores in
one bf16 pass: the window, h1 and c2 are rounded to bf16 once, the weights
too, and each GEMM sums k16 step by k16 step into an f32 accumulator.
conv1's K order is K2's pair order (``conv1_taps``, 45 pairs padded to K
96), the tap GEMM is padded to N 32, and conv3 is the ring clamp on the 25
tap planes and a fixed-order shift-add.  This file holds a test-only
emulator of that arithmetic and holds it to K3's gate (every pixel
within the flip bound of ``tests/bf16x1_gate.py``, max <= 2.0) against
``fused_conv.forward_y_reference(precision="bf16x1")`` and against the JAX
package's ``_kernel`` at ``BF16X1`` with the pair pack in Pallas interpret
mode, in its full and halo modes.

It also models the three walks that share K3's per-tile body: K3's
persistent grid (23 x 60 tiles), K3n's 24 x 28 tiles, and K5's row bands
with their rolling window and a cut tile at each band's end.  Each walk
must cover every output pixel once, and the emulator run tile by tile on
the windows the kernel reads, in f64 with every sum in one fixed order (so
that order cannot matter and only the ring, halo, window and clamp
addressing is tested), must equal the whole-plane result exactly.  The
border clamp is modelled as the kernel runs it for K3, K3n and K5
(``clamp_strips``: only the strips outside the clamp box that conv3
reads), which every mode of the bf16 kernel runs: its test covers K2's
and K3h's 24 x 60 tile (28 x 64 ring) too.  The CUDA kernels themselves
are held to the same gate and to each other bit for bit on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

import bf16x1_gate
from libsrcnn_tpu.kernels import fused_conv as jfused
from libsrcnn_tpu.models import srcnn as jsrcnn
from libsrcnn_tpu_torch.kernels import fused_conv
from libsrcnn_tpu_torch.models import srcnn
from test_torch_bf16x2 import K1P, NPAIR, bf16, conv1_taps

#: kernel -> its output tile (TH, TW); K5 walks K3's tiles in bands; K2
#: and K3h share the 24 x 60 tile
TILES = {"K3": (23, 60), "K3n": (24, 28), "K5": (23, 60), "K2": (24, 60), "K3h": (24, 60)}
SMS = 132


def kernel_weights(params: dict, dtype=torch.float32) -> dict:
    """The B operands as K3 stages them: bf16(w1) in the pair order [96, 64]
    (zero rows), bf16(w2) [64, 32], bf16(w3) as the tap GEMM [32, 32]
    (column n = tap 5 dy + dx, 25..31 zero); biases as they are."""
    taps = conv1_taps()
    w1 = params["w1"].reshape(64, 81).t()
    w1k = torch.stack([w1[t] if t >= 0 else torch.zeros(64) for t in taps])
    w3 = torch.zeros(32, 32)
    w3[:, :25] = params["w3"].reshape(32, 25)
    return {"w1": bf16(w1k).to(dtype), "w2": bf16(params["w2"].reshape(32, 64).t()).to(dtype),
            "w3": bf16(w3).to(dtype), "b1": params["b1"].to(dtype),
            "b2": params["b2"].to(dtype), "b3": params["b3"].to(dtype)}


def _dot_k16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w as K3 sums it: one pass, k16 step by k16 step, into f32."""
    acc = torch.zeros(x.shape[:-1] + (w.shape[1],), dtype=x.dtype)
    for k in range(0, x.shape[-1], 16):
        acc = acc + x[..., k:k + 16] @ w[k:k + 16]
    return acc


def _dot_ordered(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with every sum in ascending k, element by element: a row's
    result depends on that row alone, bit for bit, whatever else is in
    the batch."""
    acc = torch.zeros(x.shape[:-1] + (w.shape[1],), dtype=x.dtype)
    for k in range(x.shape[-1]):
        acc = acc + x[..., k:k + 1] * w[k]
    return acc


def tap_planes(cols: torch.Tensor, wk: dict, ordered: bool = False) -> torch.Tensor:
    """conv1, conv2 and the tap GEMM of ring positions whose windows, bf16
    and in the pair order, are ``cols`` [..., 96] -> the 25 taps [..., 25].
    h1 and c2 are rounded to bf16 once.  ``ordered``: the sums of
    :func:`_dot_ordered` (in ``cols``' dtype), else K3's."""
    dot = _dot_ordered if ordered else _dot_k16
    h1 = bf16(torch.relu(dot(cols, wk["w1"]) + wk["b1"])).to(cols.dtype)
    c2 = bf16(torch.relu(dot(h1, wk["w2"]) + wk["b2"])).to(cols.dtype)
    return dot(c2, wk["w3"])[..., :25]


def im2col(win: torch.Tensor) -> torch.Tensor:
    """[N, H, W] windows -> [N, (H-8)(W-8), 96]: each ring position's 9x9
    window in the pair order (a zero row reads tap 0: finite, weight
    zero)."""
    cols = F.unfold(win[:, None], 9).transpose(1, 2)
    return cols[..., [max(t, 0) for t in conv1_taps()]]


def shift_add(g: torch.Tensor, rows: int, cols: int, b3) -> torch.Tensor:
    """conv3 from the (clamped) tap planes [..., 25, rows+4, cols+4] in
    the kernel's fixed order, + b3, clamped to [0, 255]."""
    out = torch.zeros(g.shape[:-3] + (rows, cols), dtype=g.dtype)
    for dy in range(5):
        for dx in range(5):
            out = out + g[..., 5 * dy + dx, dy:dy + rows, dx:dx + cols]
    return torch.clamp(out + b3, 0.0, 255.0)


def forward_y_bf16x1(params: dict, y_padded: torch.Tensor, h: int, w: int,
                     edge_flags=None, *, ordered: bool = False) -> torch.Tensor:
    """K3's arithmetic on a halo plane [h+12, w+12] (or a batch) -> [h, w]:
    the window rounded once, conv1 in the pair order, h1 and c2 rounded
    once, the tap GEMM, the ring clamp on the tap planes, the shift-add.
    ``ordered``: in f64 with :func:`_dot_ordered`'s sums."""
    top, bottom, left, right = fused_conv._flags(edge_flags)
    dtype = torch.float64 if ordered else torch.float32
    squeeze = y_padded.dim() == 2
    y = y_padded[None] if squeeze else y_padded
    wk = kernel_weights(params, dtype)
    g = tap_planes(im2col(bf16(y).to(dtype)), wk, ordered)
    g = g.transpose(1, 2).reshape(y.shape[0], 25, h + 4, w + 4)
    g = g.index_select(2, fused_conv._ring_index(h, top, bottom, "cpu"))
    g = g.index_select(3, fused_conv._ring_index(w, left, right, "cpu"))
    out = shift_add(g, h, w, wk["b3"])
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


def _halo_plane(y):
    return F.pad(torch.from_numpy(y)[None, None], (6, 6, 6, 6), mode="replicate")[0, 0]


def _assert_bf16x1_close(got, ref, params, y_padded, h, w, flags=None):
    """K3's gate: every pixel within its flip bound on this halo plane."""
    v = bf16x1_gate.judge(torch.as_tensor(np.asarray(got)), torch.as_tensor(np.asarray(ref)),
                          bf16x1_gate.flip_bound(params, y_padded, h, w, flags))
    assert v.ok, str(v)


# --- the arithmetic --------------------------------------------------------


@pytest.mark.parametrize("shape,flags", [
    ((37, 53), None), ((96, 124), None), ((40, 61), (0, 1, 0, 1)),
    ((29, 33), (0, 0, 0, 0)), ((3, 3), None), ((1, 70), (1, 0, 1, 0)),
])
def test_emulator_matches_bf16x1_plain_version(params, shape, flags):
    h, w = shape
    yh = _plane((h + 12, w + 12), 81)
    got = forward_y_bf16x1(params, yh, h, w, flags)
    ref = fused_conv.forward_y_reference(params, yh, h, w, flags, precision="bf16x1")
    assert got.shape == (h, w)
    _assert_bf16x1_close(got, ref, params, yh, h, w, flags)


def test_emulator_batch_equals_planes(params):
    ys = _plane((3, 32, 41), 82)
    got = forward_y_bf16x1(params, ys, 20, 29, (0, 0, 0, 0))
    for i in range(3):
        assert torch.equal(got[i], forward_y_bf16x1(params, ys[i], 20, 29, (0, 0, 0, 0)))


def test_ordered_sums_stay_within_the_gate(params):
    """The f64 fixed-order variant the geometry model runs is K3's
    arithmetic too: within K3's gate of the f32 k16 emulator."""
    h, w = 40, 70
    yh = _plane((h + 12, w + 12), 83)
    _assert_bf16x1_close(forward_y_bf16x1(params, yh, h, w, ordered=True).float(),
                         forward_y_bf16x1(params, yh, h, w), params, yh, h, w)


@pytest.mark.parametrize("shape", [(37, 53), (96, 124)])
def test_emulator_matches_pallas_interpret(params, jparams, shape):
    """Against the JAX package's ``_kernel`` at ``BF16X1`` with the pair
    pack (the ``bfloat16_fast`` tier on the TPU) in Pallas interpret
    mode."""
    y = np.random.default_rng(84).uniform(0, 255, shape).astype(np.float32)
    ref = np.asarray(jfused.forward_y(jparams, jnp.asarray(y), interpret=True,
                                      precision=jfused.BF16X1, pack_im2col=True))
    yh = _halo_plane(y)
    _assert_bf16x1_close(forward_y_bf16x1(params, yh, *shape), ref, params, yh, *shape)


def test_emulator_matches_pallas_halo_mode(params, jparams):
    """Edge flags (0,1,0,1) against the Pallas kernel's halo mode at
    ``BF16X1`` with the pair pack: top and left are interior borders whose
    ring comes from the real halo."""
    h, w = 37, 53
    yh = np.random.default_rng(85).uniform(0, 255, (h + 12, w + 12)).astype(np.float32)
    p = {k: jnp.asarray(v) for k, v in jparams.items()}
    ref = jfused._fused(
        jnp.asarray(yh), p["w1"].reshape(81, 64), p["b1"],
        p["w2"].reshape(64, 32), p["b2"],
        p["w3"][:, :, :, 0].transpose(1, 0, 2).reshape(25, 32),
        p["b3"].reshape(1), jnp.asarray([0, 1, 0, 1], jnp.int32),
        th=jfused.BF16_TH, interpret=True, pad_mode="halo",
        precision=jfused.BF16X1, pack_im2col=True)
    yh = torch.from_numpy(yh)
    _assert_bf16x1_close(forward_y_bf16x1(params, yh, h, w, (0, 1, 0, 1)), ref, params, yh, h,
                         w, (0, 1, 0, 1))


# --- the narrow tile's im2col words ----------------------------------------


@pytest.mark.parametrize("m", range(64))
def test_narrow_im2col_words_hold_the_pair_at_the_ring_column(m):
    """K3n's conv1 A registers, read as it reads them.  Its ring is 32
    columns wide, so one m64 tile spans ring rows 2T and 2T + 1: row m of
    tile T is ring row 2T + m // 32, column m % 32.  The lane holding row m
    (warp m // 16, row group g = m % 8; rows g and g + 8 of a fragment)
    reads 32-bit words of the bf16 plane (from element 1 where its ring
    column is odd) at word base (a WW + col - parity) / 2 + toff, with
    a = 2T + warp // 2, col = 16 (warp % 2) + g, and four words on for row
    g + 8.  Each word holds the two taps of its GEMM rows at ring column
    m % 32 of ring row 2T + m // 32."""
    th, tw = TILES["K3n"]
    rh, ww = th + 4, tw + 12
    win = np.arange((rh + 8) * ww, dtype=np.int64)       # each element its index
    planes = [win, np.append(win[1:], -1)]               # from element 0 and 1
    taps = conv1_taps()
    warp, g, upper = m // 16, m % 8, (m % 16) >= 8
    col = 16 * (warp % 2) + g
    par = col & 1
    words = planes[par].reshape(-1, 2)
    for tile in range(rh // 2):
        a = 2 * tile + warp // 2
        assert a == 2 * tile + m // 32 and col + 8 * upper == m % 32
        base = (a * ww + col - par) // 2 + 4 * upper
        for s in range(K1P // 16):
            for q in range(4):
                for i in range(2):
                    p = 8 * s + q + 4 * i
                    pp = p if p < NPAIR else 0           # a padding pair reads pair 0
                    toff = ((pp // 5) * ww + 2 * (pp % 5)) // 2
                    k = 16 * s + 2 * q + 8 * i           # the register's first row
                    for e in range(2):
                        dy, dx = pp // 5, 2 * (pp % 5) + e
                        idx = (a + dy) * ww + m % 32 + dx
                        # past the plane only at dx 9 (a zero row), where the
                        # shifted plane ends in a 0 (here -1)
                        assert words[base + toff][e] == (idx if idx < win.size else -1)
                        assert idx < win.size or dx == 9
                        assert taps[k + e] == (9 * dy + dx if p < NPAIR and dx < 9 else -1)


# --- the border clamp on the tap planes ---------------------------------------


def clamp_box(r0, q0, h, w, flags):
    """The clamp box of a tile at output (r0, q0) in ring coordinates:
    rows a0 .. a1, columns b0 .. b1 keep their values."""
    top, bottom, left, right = flags
    return ((0 if top else -2) - r0 + 2, (h - 1 if bottom else h + 1) - r0 + 2,
            (0 if left else -2) - q0 + 2, (w - 1 if right else w + 1) - q0 + 2)


def clamp_strips(g: torch.Tensor, r0, q0, h_end, h, w, flags) -> list:
    """The kernel's clamp_strips on a tile's tap planes g [25, RH, RW], in
    place and as it enumerates them; returns the (a, b) it wrote."""
    rh, rw = g.shape[1:]
    a0, a1, b0, b1 = clamp_box(r0, q0, h, w, flags)
    nr, nc = min(rh, h_end - r0 + 4), min(rw, w - q0 + 4)
    top = max(0, min(a0, nr))
    bot = max(top, min(a1 + 1, nr))
    left = max(0, min(b0, nc))
    right = max(left, min(b1 + 1, nc))
    orows, ocols, mid = top + nr - bot, left + nc - right, bot - top
    s = np.arange(25 * orows * nc)
    c, i, b = s // max(orows * nc, 1), s % max(orows * nc, 1) // max(nc, 1), s % max(nc, 1)
    a = np.where(i < top, i, bot + i - top)
    dst = [(c, a, b)]
    src = [(c, np.clip(a, a0, a1), np.clip(b, b0, b1))]
    s = np.arange(25 * mid * ocols)
    c, a, j = s // max(mid * ocols, 1), top + s % max(mid * ocols, 1) // max(ocols, 1), \
        s % max(ocols, 1)
    b = np.where(j < left, j, right + j - left)
    dst.append((c, a, b))
    src.append((c, a, np.clip(b, b0, b1)))
    written = []
    for (dc, da, db), (sc, sa, sb) in zip(dst, src):
        # the sources lie in the box and are never written: one gather
        g[dc, da, db] = g[sc, sa, sb]
        written += list(zip(dc.tolist(), da.tolist(), db.tolist()))
    return written


@pytest.mark.parametrize("flags", [(1, 1, 1, 1), (0, 1, 0, 1), (1, 0, 1, 0), (0, 0, 0, 0)])
@pytest.mark.parametrize("kernel,r0,q0,h,h_end,w", [
    ("K3", 0, 0, 50, 50, 130), ("K3", 23, 60, 50, 50, 130), ("K3", 46, 120, 50, 50, 130),
    ("K3", 0, 0, 3, 3, 3), ("K3", 0, 0, 1, 1, 70), ("K5", 16, 0, 40, 32, 61),
    ("K5", 0, 0, 40, 16, 61), ("K3n", 24, 56, 30, 30, 70),
    ("K2", 0, 0, 50, 50, 130), ("K2", 48, 120, 50, 50, 130), ("K3h", 24, 60, 50, 50, 130),
    ("K3h", 0, 0, 1, 1, 70),
])
def test_clamp_strips_write_what_conv3_reads_outside_the_box(kernel, r0, q0, h, h_end,
                                                             w, flags):
    """``clamp_strips`` writes each ring position that conv3 reads (rows
    below min(RH, h_end - r0 + 4), columns below min(RW, w - q0 + 4)) and
    that lies outside the clamp box exactly once, and nothing else; each
    takes its clamped position's values, as srcnn_common.cuh's
    ``ring_clamp`` gives them."""
    th, tw = TILES[kernel]
    rh, rw = th + 4, tw + 4
    g = torch.arange(25 * rh * rw, dtype=torch.float64).reshape(25, rh, rw)
    written = clamp_strips(g, r0, q0, h_end, h, w, flags)
    a0, a1, b0, b1 = clamp_box(r0, q0, h, w, flags)
    nr, nc = min(rh, h_end - r0 + 4), min(rw, w - q0 + 4)
    want = {(c, a, b) for c in range(25) for a in range(nr) for b in range(nc)
            if not (a0 <= a <= a1 and b0 <= b <= b1)}
    assert len(written) == len(set(written)) and set(written) == want
    orig = torch.arange(25 * rh * rw, dtype=torch.float64).reshape(25, rh, rw)
    for c, a, b in list(want)[:400]:
        sa, sb = min(max(a, a0), a1), min(max(b, b0), b1)
        assert g[c, a, b] == orig[c, sa, sb]


# --- the three walks ----------------------------------------------------------


def fetch(y: torch.Tensor, r0: int, q0: int, th: int, tw: int, c0: int = 0) -> torch.Tensor:
    """Window columns c0 .. of the tile at output (r0, q0): padded rows r0
    .. r0+WH-1, columns q0 .. q0+WW-1 of the halo plane y, reads past it
    clamped in (fetch_window, fetch_cols)."""
    wh, ww = th + 12, tw + 12
    ph, pw = y.shape
    rows = torch.clamp(torch.arange(r0, r0 + wh), max=ph - 1)
    cols = torch.clamp(torch.arange(q0 + c0, q0 + ww), max=pw - 1)
    return y[rows][:, cols]


def run_tile(wk, window, r0, q0, th, tw, h, h_end, w, flags, out, cover):
    """One tile as the kernel runs it from its window [WH, WW] (bf16-
    rounded here): the tap planes of the ring rows it needs (the rows past
    them are NaN, as stale planes hold anything), the clamp, the
    shift-add of the output pixels below h_end and w into out (f64), and
    one count per pixel into cover."""
    rows = min(th, h_end - r0)
    need = rows + 4                                       # ring rows computed
    g = torch.full((25, th + 4, tw + 4), float("nan"), dtype=torch.float64)
    cols = im2col(bf16(window[None, :need + 8]).to(torch.float64))[0]
    g[:, :need] = tap_planes(cols, wk, ordered=True).t().reshape(25, need, tw + 4)
    clamp_strips(g, r0, q0, h_end, h, w, flags)
    part = shift_add(g[:, :rows + 4], rows, tw, wk["b3"])
    nc = min(tw, w - q0)
    out[r0:r0 + rows, q0:q0 + nc] = part[:, :nc]
    cover[r0:r0 + rows, q0:q0 + nc] += 1


def walk_persistent(n, h, w, th, tw, sms=SMS):
    """The tiles each block of the persistent grid visits, in order: grid =
    min(tiles, sms) blocks; block b takes tiles b, b + grid, ... as
    tile_at maps them to (plane, r0, q0)."""
    tr, tc = -(-h // th), -(-w // tw)
    tiles = tr * tc * n
    grid = min(tiles, sms)
    per_plane = tr * tc
    return [[(t // per_plane, (t % per_plane) // tc * th, (t % per_plane) % tc * tw)
             for t in range(b, tiles, grid)] for b in range(grid)]


def run_persistent(kernel, params, ys, h, w, flags, sms):
    th, tw = TILES[kernel]
    wk = kernel_weights(params, torch.float64)
    out = torch.full((ys.shape[0], h, w), float("nan"), dtype=torch.float64)
    cover = torch.zeros((ys.shape[0], h, w), dtype=torch.int64)
    for block in walk_persistent(ys.shape[0], h, w, th, tw, sms):
        for plane, r0, q0 in block:
            run_tile(wk, fetch(ys[plane], r0, q0, th, tw), r0, q0, th, tw, h, h, w,
                     flags, out[plane], cover[plane])
    return out, cover


def run_bands(params, ys, h, w, flags, tile_h):
    """K5: one block per band of tile_h rows and plane; its tiles cut at
    the band's end; the column tiles left to right with a rolling window
    (the KEEP columns the next tile shares moved along, the rest read)."""
    th, tw = TILES["K5"]
    keep = 12
    wk = kernel_weights(params, torch.float64)
    out = torch.full((ys.shape[0], h, w), float("nan"), dtype=torch.float64)
    cover = torch.zeros((ys.shape[0], h, w), dtype=torch.int64)
    for plane in range(ys.shape[0]):
        for band0 in range(0, h, tile_h):
            band1 = min(band0 + tile_h, h)
            win = fetch(ys[plane], band0, 0, th, tw)
            for r0 in range(band0, band1, th):
                for q0 in range(0, w, tw):
                    run_tile(wk, win, r0, q0, th, tw, h, band1, w, flags, out[plane],
                             cover[plane])
                    if q0 + tw < w:
                        win = torch.cat([win[:, tw:], fetch(ys[plane], r0, q0 + tw, th,
                                                            tw, keep)], 1)
                    elif r0 + th < band1:
                        win = fetch(ys[plane], r0 + th, 0, th, tw)
    return out, cover


@pytest.fixture(scope="module")
def planes():
    """Two seeded halo planes of a 50 x 130 output."""
    return torch.from_numpy(np.random.default_rng(86).uniform(
        0, 255, (2, 62, 142)).astype(np.float32))


@pytest.fixture(scope="module")
def whole(params, planes):
    """flags -> the whole-plane result of both planes (f64, fixed-order
    sums), computed once."""
    cache = {}

    def get(flags, h=50, w=130):
        key = (flags, h, w)
        if key not in cache:
            cache[key] = forward_y_bf16x1(params, planes[:, :h + 12, :w + 12], h, w,
                                          flags, ordered=True)
        return cache[key]
    return get


@pytest.mark.parametrize("kernel", ["K3", "K3n"])
@pytest.mark.parametrize("flags", [(1, 1, 1, 1), (0, 0, 0, 0), (0, 1, 1, 0)])
def test_persistent_walk_equals_the_whole_plane(params, planes, whole, kernel, flags):
    """K3's and K3n's persistent grids over two 50 x 130 planes, with
    ragged tiles at the bottom and right, on a grid of 7 blocks, so that
    each walks tiles of both planes: every pixel once, each equal to the
    whole-plane result."""
    out, cover = run_persistent(kernel, params, planes, 50, 130, flags, sms=7)
    assert (cover == 1).all()
    assert torch.equal(out, whole(flags))


@pytest.mark.parametrize("tile_h", [1, 5, 12, 13, 23, 64])
def test_band_walk_equals_the_whole_plane(params, planes, whole, tile_h):
    """K5's bands of 1 .. 64 rows (tiles cut at each band's end) with the
    rolling window, over two 50 x 130 planes: every pixel once, each equal
    to the whole-plane result."""
    flags = (1, 0, 0, 1)
    out, cover = run_bands(params, planes, 50, 130, flags, tile_h)
    assert (cover == 1).all()
    assert torch.equal(out, whole(flags))


def test_rolling_window_equals_a_fetched_window(planes):
    """K5's window after the KEEP columns moved along and the rest read
    equals the window fetched whole at that tile."""
    th, tw = TILES["K5"]
    y = planes[0]
    win = fetch(y, 23, 0, th, tw)
    for q0 in (60, 120):
        win = torch.cat([win[:, tw:], fetch(y, 23, q0, th, tw, 12)], 1)
        assert torch.equal(win, fetch(y, 23, q0, th, tw))


@pytest.mark.parametrize("kernel", list(TILES))
@pytest.mark.parametrize("n,h,w", [(1, 2048, 2048), (6, 257, 301), (1, 3, 3), (2, 1, 70),
                                   (3, 70, 1), (2, 500, 1000), (1, 1080, 1920)])
def test_walks_cover_every_pixel_once(kernel, n, h, w):
    """The persistent walks of K2, K3, K3h and K3n, and K5's bands (at 16
    rows), at the main path's sizes and ragged ones: every output pixel
    once, and the persistent blocks' loads differ by at most one tile."""
    th, tw = TILES[kernel]
    covered = np.zeros((n, h, w), np.int64)
    if kernel == "K5":
        for plane in range(n):
            for band0 in range(0, h, 16):
                band1 = min(band0 + 16, h)
                for r0 in range(band0, band1, th):
                    for q0 in range(0, w, tw):
                        covered[plane, r0:min(r0 + th, band1), q0:q0 + tw] += 1
    else:
        blocks = walk_persistent(n, h, w, th, tw)
        for b in blocks:
            for plane, r0, q0 in b:
                covered[plane, r0:r0 + th, q0:q0 + tw] += 1
        lens = [len(b) for b in blocks]
        assert max(lens) - min(lens) <= 1 and len(blocks) <= SMS
    assert (covered == 1).all()
