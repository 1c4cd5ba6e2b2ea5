"""K1's strip walk (``kernels/csrc/fused_srcnn.cu``), replayed on the CPU.

A K1 block takes segments: up to ``seg`` 16 x 60 tiles stacked down one
60-column strip of one plane, walked top to bottom.  A segment's first tile
computes its whole 20-row c2 ring; each later tile takes ring rows 0-3 (the
clamped tap planes G of the rows it shares with the tile above) from the
tile above and computes rows 4-19.  ``fused_conv.k1_walk`` is the plan the
C launch mirrors; :func:`walk` here replays the kernel's loop itself
(``segment_at`` and the block's next-tile logic) tile by tile.

The tests hold the replay to the plan (cover, carry, balance, counters),
and replay the walk over small planes with plain per-ring-row GEMMs, the
ring clamp and conv3's shift-add: carried G rows equal the rows the tile
would compute itself, and the planes equal ``forward_y_reference``.  The
kernel itself is held to its parent and its plain version on the card
(tests/test_torch_cuda.py).
"""

import re
import os

import pytest
import torch
import torch.nn.functional as F

from libsrcnn_tpu_torch.kernels import fused_conv
from libsrcnn_tpu_torch.models import srcnn
from libsrcnn_tpu_torch.utils import profiling
from torch_threads import torch_threads  # noqa: F401  (the thread rule)

TH, TW = fused_conv.K1_TILE
RH = fused_conv.K1_RING_ROWS
RW = TW + 4
CARRY = RH - TH
SMS = 132                                   # an H100 SXM's SMs
CSRC = os.path.join(os.path.dirname(fused_conv.__file__), "csrc", "fused_srcnn.cu")

# (n, h, w): clip A's plane, a 1024^2 still, a 13-row band, one tile,
# ragged planes, and planes whose walk differs alone and in a batch
SHAPES = [(8, 2160, 3840), (1, 1024, 1024), (1, 13, 1000), (1, 5, 7),
          (3, 1000, 250), (2, 1100, 61), (1, 1100, 240), (16, 1100, 240),
          (1, 2048, 2048), (4, 49, 700)]


def walk(n, h, w, sms):
    """The kernel's loop: per block, its tiles in order, each as (plane,
    tile row, strip, unit, a0 = first ring row computed, carries = the
    tile below takes rows from it)."""
    seg = fused_conv.k1_walk(n, h, w, sms).seg
    tr, tc = -(-h // TH), -(-w // TW)
    per_plane = -(-tr // seg) * tc
    units = per_plane * n
    grid = min(units, sms)
    blocks = []
    for b in range(grid):
        tiles = []
        for u in range(b, units, grid):
            plane, rem = divmod(u, per_plane)
            row, strip = (rem // tc) * seg, rem % tc
            length = min(seg, tr - row)
            for ti in range(length):
                tiles.append((plane, row + ti, strip, u, CARRY if ti else 0,
                              ti + 1 < length))
        blocks.append(tiles)
    return blocks


def test_plan_mirrors_the_kernel_constants():
    src = open(CSRC).read()
    assert re.search(rf"constexpr int TH = {TH}, TW = {TW};", src)
    assert re.search(r"constexpr int RH = TH \+ 4, RW = TW \+ 4;", src)
    assert RH == TH + 4


@pytest.mark.parametrize("n,h,w", SHAPES)
def test_walk_covers_every_tile_once(n, h, w):
    tr, tc = -(-h // TH), -(-w // TW)
    seen = [t[:3] for tiles in walk(n, h, w, SMS) for t in tiles]
    assert len(seen) == n * tr * tc == fused_conv.k1_walk(n, h, w, SMS).tiles
    assert set(seen) == {(p, r, c) for p in range(n) for r in range(tr)
                         for c in range(tc)}


@pytest.mark.parametrize("n,h,w", SHAPES)
def test_every_ring_row_computed_or_carried_from_the_tile_above(n, h, w):
    """A tile that starts at ring row 4 follows, in its block, the tile
    directly above it in the same plane, strip and segment, which carries;
    every segment's first tile computes all 20 rows."""
    for tiles in walk(n, h, w, SMS):
        prev = None
        for t in tiles:
            plane, row, strip, unit, a0, _ = t
            if a0:
                assert a0 == CARRY and prev is not None and prev[5]
                assert prev[:4] == (plane, row - 1, strip, unit)
            else:
                assert prev is None or prev[3] != unit
                assert prev is None or not prev[5]
            prev = t
        assert prev is None or not prev[5]


def _block_rows(blocks):
    return [sum(RH - t[4] for t in tiles) for tiles in blocks]


@pytest.mark.parametrize("n,h,w", SHAPES)
@pytest.mark.parametrize("sms", [SMS, 114, 7, 1])
def test_walk_balances_at_least_as_well_as_the_tile_walk(n, h, w, sms):
    """The most ring rows a block computes is no more than under the
    row-major tile walk (every tile 20 rows, min(tiles, SMs) blocks), and
    the plan's counts are the replay's."""
    plan = fused_conv.k1_walk(n, h, w, sms)
    blocks = walk(n, h, w, sms)
    rows = _block_rows(blocks)
    assert len(blocks) == plan.grid == min(plan.units, sms)
    assert max(rows) <= -(-plan.tiles // min(plan.tiles, sms)) * RH
    assert sum(rows) == plan.rows_computed
    assert sum(t[4] for tiles in blocks for t in tiles) == plan.rows_carried


def test_plan_of_the_clip_and_of_bands():
    """Clip A (8 x 2160 x 3840 on 132 SMs): segments of 15 tiles, 9 to a
    135-tile strip, 4,608 units in 35 rounds (120 blocks take 35, 12 take
    34); 4 of 20 ring rows carried on 14 tiles of 15.  One tile row
    carries nothing, as does a plane of one tile."""
    a = fused_conv.k1_walk(8, 2160, 3840, SMS)
    assert (a.seg, a.units, a.grid, a.tiles) == (15, 4608, 132, 69120)
    ratio = a.rows_carried / (a.rows_computed + a.rows_carried)
    assert ratio == pytest.approx(0.2 * 14 / 15) and 0.18 < ratio < 0.2
    assert a.rows_computed + a.rows_carried == RH * a.tiles
    assert max(_block_rows(walk(8, 2160, 3840, SMS))) == 35 * (RH + TH * 14)
    for n, h, w in [(1, 13, 1000), (1, 16, 3840), (8, 9, 1920), (1, 5, 7)]:
        b = fused_conv.k1_walk(n, h, w, SMS)
        assert b.rows_carried == 0 and b.seg == 1
        assert b.rows_computed == RH * b.tiles


def test_segment_length_adapts_to_the_batch():
    """The same plane walks other segments alone than in a batch of 16."""
    alone, batch = (fused_conv.k1_walk(n, 1100, 240, SMS).seg for n in (1, 16))
    assert alone != batch and alone > 1 and batch > 1


def test_k1_launch_counts_its_ring_rows(monkeypatch):
    """``fused_conv.launch`` adds the plan's rows to the two counters at a
    K1 launch and at no other kernel's (the launch itself stubbed: the
    kernel runs only on a card)."""
    monkeypatch.setattr(fused_conv, "run", lambda *a, **k: None)
    monkeypatch.setattr(fused_conv, "_sm_count", lambda device: SMS)
    y = torch.zeros(2, 1100 + 12, 240 + 12)
    out = torch.zeros(2, 1100, 240)
    plan = fused_conv.k1_walk(2, 1100, 240, SMS)
    before = profiling.counts_snapshot()
    fused_conv.launch("K1", torch.zeros(8129), y, out)
    fused_conv.launch("K3", torch.zeros(8129), y, out)
    assert profiling.counts["k1.ring_rows_computed"] - before[
        "k1.ring_rows_computed"] == plan.rows_computed
    assert profiling.counts["k1.ring_rows_carried"] - before[
        "k1.ring_rows_carried"] == plan.rows_carried > 0


# --- the walk over a plane, with the plain per-row arithmetic --------------

def _ring_row_g(params, yp, r0, q0, a):
    """G (25 tap planes) of ring row ``a`` of the tile at (r0, q0) of one
    halo plane ``yp``: [25, RW], from window rows r0 + a .. r0 + a + 8 and
    columns q0 .. q0 + RW + 7, reads past the plane clamped in as the
    kernel's fetch clamps them.  Every row is one GEMM chain of one shape,
    so a row computed twice gives the same bits."""
    ph, pw = yp.shape
    rows = torch.arange(r0 + a, r0 + a + 9).clamp(max=ph - 1)
    cols = torch.arange(q0, q0 + RW + 8).clamp(max=pw - 1)
    win = yp.index_select(0, rows).index_select(1, cols)
    x = F.unfold(win[None, None], 9)[0].t()                     # [RW, 81]
    h1 = torch.relu(x @ params["w1"].reshape(64, 81).t() + params["b1"])
    c2 = torch.relu(h1 @ params["w2"].reshape(32, 64).t() + params["b2"])
    return (c2 @ params["w3"].reshape(32, 25)).t()             # [25, RW]


def _ring_clamp(g, r0, q0, h, w, flags):
    """``ring_clamp`` of ``srcnn_common.cuh`` on a tile's ring [25, RH, RW]."""
    top, bottom, left, right = flags
    ra = (torch.arange(RH) + r0 - 2).clamp(0 if top else -2, h - 1 if bottom else h + 1)
    cb = (torch.arange(RW) + q0 - 2).clamp(0 if left else -2, w - 1 if right else w + 1)
    return g.index_select(1, ra - r0 + 2).index_select(2, cb - q0 + 2)


def _replay(params, y, h, w, flags, sms):
    """The plane(s) as the walk computes them, and each carried tile's
    ring checked against the ring it would compute alone."""
    n = y.shape[0]
    out = torch.full((n, h, w), float("nan"))
    carried = 0
    for tiles in walk(n, h, w, sms):
        g_prev = None
        for plane, row, strip, _, a0, carries in tiles:
            r0, q0 = row * TH, strip * TW
            ring = lambda first: torch.stack(
                [_ring_row_g(params, y[plane], r0, q0, a) for a in range(first, RH)], 1)
            g = _ring_clamp(ring(0), r0, q0, h, w, flags)
            if a0:
                rest = _ring_clamp(torch.cat([g_prev[:, RH - CARRY:], ring(CARRY)], 1),
                                   r0, q0, h, w, flags)
                assert torch.equal(rest, g)
                carried += 1
            acc = torch.zeros(TH, TW)
            for dy in range(5):
                for dx in range(5):
                    acc = acc + g[5 * dy + dx, dy:dy + TH, dx:dx + TW]
            tile = torch.clamp(acc + params["b3"], 0.0, 255.0)
            hh, ww = min(TH, h - r0), min(TW, w - q0)
            out[plane, r0:r0 + hh, q0:q0 + ww] = tile[:hh, :ww]
            g_prev = g if carries else None
    return out, carried


@pytest.mark.parametrize("n,h,w,sms", [(1, 49, 130, 1), (2, 70, 61, 2), (1, 40, 70, 2)])
@pytest.mark.parametrize("flags", [(1, 1, 1, 1), (1, 0, 0, 1), (0, 1, 1, 0), (0, 0, 0, 0)])
def test_replayed_walk_carries_the_rows_it_would_compute(n, h, w, sms, flags):
    """Over small planes on few SMs (long segments): every carried ring,
    clamped, equals the ring the tile computes alone, bit for bit, and the
    planes equal the plain version within K1's gate.  At 49 rows the
    bottom edge lies in the carried rows of the third tile."""
    params = srcnn.load_params("cpu")
    y = torch.rand(n, h + 12, w + 12, generator=torch.Generator().manual_seed(h + w)) * 255
    got, carried = _replay(params, y, h, w, flags, sms)
    plan = fused_conv.k1_walk(n, h, w, sms)
    assert carried * CARRY == plan.rows_carried > 0
    ref = fused_conv.forward_y_reference(params, y, h, w, flags)
    assert float((got - ref).abs().max()) <= 2e-3
