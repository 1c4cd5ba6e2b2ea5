"""Fully-fused SRCNN 9-1-5 forward: the hand-written CUDA kernels and their
plain PyTorch versions.

Port of ``libsrcnn_tpu/kernels/fused_conv.py`` (``_kernel``, reached through
``_fused`` / ``forward_y``) in its GEMM modes, the JAX package's
``MODE_PRECISIONS`` names:

========  ==========================  ===================================
kernel    mode                        source
========  ==========================  ===================================
K1        ``precision="exact"``       ``csrc/fused_srcnn.cu`` (3xTF32)
K2        ``"split"``                 ``csrc/fused_srcnn_bf16.cu``
K3h       ``"split"``, ``pack_im2col=True``   the same, hi/lo-packed conv1
K3        ``"bf16x1"``                the same
K3n       ``"bf16x1"``, ``geom="narrow"``     the same, narrower tile
K4        the int8 tier               ``csrc/fused_srcnn_int8.cu``
K5        ``"bf16x1"`` in row bands   ``csrc/fused_srcnn_bf16.cu``
========  ==========================  ===================================

K4 ports ``_kernel_int8`` (reached through ``_fused_int8`` /
``forward_y_int8``), with the quantized pack of :mod:`..models.srcnn_int8`:
:func:`forward_y_int8` and its plain version
:func:`forward_y_int8_reference`.  The JAX package's int8 tile height
(``INT8_TH = 80``) follows Mosaic's VMEM limits and is not carried over.

Every kernel is a ``wgmma`` kernel with a persistent grid.  K2, K3, K3h
and K3n are instances of one bf16 kernel: two passes per GEMM for K2; one
for K3 and K3n, whose narrower tile changes nothing a pixel computes; for
K3h one conv1 pass over the hi and lo rows of each tap, interleaved along
K, and two passes for conv2 and the tap GEMM.

K5 ports ``_kernel_band`` (reached through ``_fused_band`` /
``forward_y_band``): K3's per-tile body with one block per band of rows,
:func:`forward_y_band`, bit-identical to K3; its plain version is K3's.
K5 and the stage cuts of :mod:`.ablation` (K6, K7) are the
kernel-profiling path: they live in second builds of the same sources
(``_build.PROFILING``), so the main path's libraries do not grow.

The TPU kernel's tile geometry (TW=124 columns, 384-lane windows, the
im2col scratch, lane rolls, the i32 tap-pair words) follows Mosaic's layout
rules and is not carried over; the CUDA kernels keep what it computes and
what it keeps out of device memory (see the notes at the top of the
``.cu`` files).

Interface, for the pipeline and for banded / sharded callers alike:

* ``y_padded`` is the Y plane with a 6 px halo, ``[h+12, w+12]`` f32, or a
  batch of them ``[N, h+12, w+12]`` (one launch for the batch).  The
  pipeline has the resize emit it directly (``resize_plane_padded``).
* ``edge_flags`` ``(top, bottom, left, right)`` say which borders are true
  image edges.  There conv3 reads conv2's output clamped to the image
  (`libsrcnn.cpp:463-489`); at a 0 flag it reads the c2 computed over the
  real halo pixels.  ``None`` means all four are edges.

A CUDA tensor always goes to a kernel; a CPU tensor goes to the plain
version, :func:`forward_y_reference`.  Nothing falls back from one to the
other.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..models import srcnn, srcnn_int8
from ..utils import profiling
from . import _build

HALO = 6          # 4 (conv1) + 2 (conv3) each side

PRECISIONS = srcnn.PRECISIONS
GEOMS = ("wide", "narrow")

#: what ``pack_im2col=None`` means for the split mode: the plain two-pass
#: conv1 (K2), as ``PACK_IM2COL_SPLIT_DEFAULT`` is off in the JAX package;
#: set True to route the split mode to K3h
PACK_IM2COL_SPLIT_DEFAULT = False
#: what ``geom=None`` means for the bf16x1 mode: the wide tile (K3), as
#: ``NARROW_EW_DEFAULT`` is off in the JAX package; set True for K3n
NARROW_DEFAULT = False

#: the hand-written kernels' launches in this process, by kernel: the one
#: counter, ``utils.profiling.launches``
launches_by = profiling.launches

#: :func:`launch`'s kernels -> (library, entry point, leading int arguments;
#: K5 adds its band height)
_KERNELS = {"K1": ("fused_srcnn", "forward", ()),
            "K2": ("fused_srcnn_bf16", "forward", (0,)),
            "K3": ("fused_srcnn_bf16", "forward", (1,)),
            "K3h": ("fused_srcnn_bf16", "forward", (2,)),
            "K3n": ("fused_srcnn_bf16", "forward", (3,)),
            "K4": ("fused_srcnn_int8", "forward", ()),
            "K5": ("fused_srcnn_bf16_prof", "band_forward", ())}

#: K5's inner-loop names in the JAX package (``band_impl``): a static
#: unroll over the column tiles or a ``fori_loop`` over a rotated window.
#: On Hopper both name the one K5 instance, a loop over the column tiles
#: with a rolling window (``csrc/fused_srcnn_bf16.cu``).
BAND_IMPLS = ("unroll", "fori")
#: K1's output tile and c2 ring rows (``csrc/fused_srcnn.cu``: TH, TW, RH);
#: a tile below another in its segment takes the last RH - TH of them
K1_TILE = (16, 60)
K1_RING_ROWS = 20


class K1Walk(NamedTuple):
    """A K1 launch's strip walk (:func:`k1_walk`)."""
    seg: int              #: tiles per segment (the last of a strip may hold fewer)
    units: int            #: segments: n planes x strips x segments per strip
    grid: int             #: blocks, one per SM at most
    tiles: int
    rows_computed: int    #: ring rows the GEMMs compute over the launch
    rows_carried: int     #: ring rows taken from the tile above instead


@functools.lru_cache(maxsize=256)
def k1_walk(n: int, h: int, w: int, sms: int) -> K1Walk:
    """K1's walk of ``n`` planes of ``[h, w]`` on ``sms`` SMs, as the C
    launch plans it (``segment_tiles`` in ``csrc/fused_srcnn.cu``).  A
    segment is up to ``seg`` tiles stacked down one 60-column strip of a
    plane; its first tile computes all 20 ring rows, each later one 16 and
    takes 4 from the tile above.  ``seg`` is the one that bounds a block's
    ring rows least (its rounds times ``20 + 16 (seg - 1)``), the longest
    on a tie; ``seg = 1`` is the row-major tile walk, so no launch bounds
    worse than that one."""
    th, tw = K1_TILE
    carry = K1_RING_ROWS - th
    tr, tc = -(-h // th), -(-w // tw)
    best, best_rows, seg = 1, None, 1
    while True:
        segs = -(-tr // seg)
        units = n * tc * segs
        rows = -(-units // min(units, sms)) * (K1_RING_ROWS + th * (seg - 1))
        if best_rows is None or rows <= best_rows:
            best, best_rows = seg, rows
        if segs == 1:
            break
        seg = -(-tr // (segs - 1))        # the shortest seg with fewer segments
    units = n * tc * -(-tr // best)
    tiles = n * tc * tr
    return K1Walk(best, units, min(units, sms), tiles,
                  th * tiles + carry * units, carry * (tiles - units))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


#: the band height this port recommends for K5 (not a default: the JAX
#: package's 64 is): the fastest of 8, 12, 16, 24, 32 and 64 rows at
#: 2048^2 on an H100 (tools/trace_kernel.py --mode bf16x1band --th N,
#: PERF.md).  16 rows give a
#: 2048-row plane 128 blocks, one wave on the 132 SMs, each a K3 tile cut
#: to 16 rows; 12 rows give 171 blocks, two waves; 64 rows give 32
BAND_TILE_H = 16


def pack_params(params: dict) -> torch.Tensor:
    """OIHW params -> the kernels' flat f32 layout (``csrc/srcnn_common.cuh``):
    w1 [81,64] (tap k = 9*dy + dx), b1 [64], w2 [64,32], b2 [32],
    w3 [25,32] (tap k = 5*dy + dx), b3 [1]; 8,129 floats.  The bf16
    kernels round the weights themselves.  Counts one ``kernels.packs``."""
    profiling.counts["kernels.packs"] += 1
    parts = [
        params["w1"].reshape(64, 81).t(),
        params["b1"],
        params["w2"].reshape(32, 64).t(),
        params["b2"],
        params["w3"].reshape(32, 25).t(),
        params["b3"],
    ]
    return torch.cat([p.reshape(-1).to(torch.float32) for p in parts])


def pack_int8_params(qparams: dict) -> torch.Tensor:
    """int8 pack -> K4's byte layout (``csrc/fused_srcnn_int8.cu``): int8
    w1q [81,64] (tap k = 9*dy + dx), w2q [64,32], w3 [25,32] (tap k =
    5*dy + dx, :func:`..models.srcnn_int8.w3_taps`), 8,032 bytes; then f32
    s1 t1 [64], s2 t2 [32], d3, b3 and the input scale 127/255 (the f32
    value :func:`..models.srcnn_int8.quantize_input` multiplies by);
    8,812 bytes, uint8, on the pack's device.  Counts one
    ``kernels.packs``."""
    profiling.counts["kernels.packs"] += 1
    srcnn_int8.check_params(qparams)
    q = [qparams["w1q"], qparams["w2q"], srcnn_int8.w3_taps(qparams["w3q"])]
    dev = qparams["w1q"].device
    # torch.full fills on the device: no host-to-device copy per call
    scales = [qparams[k] for k in ("s1", "t1", "s2", "t2", "d3", "b3")] + [
        torch.full((1,), srcnn_int8.INPUT_SCALE, dtype=torch.float32, device=dev)]
    return torch.cat([p.reshape(-1).view(torch.uint8) for p in q] +
                     [torch.cat([p.reshape(-1) for p in scales]).view(torch.uint8)])


def kernel_for(precision: str = "exact", pack_im2col: bool | None = None,
               geom: str | None = None) -> str:
    """The kernel ("K1", "K2", "K3", "K3h" or "K3n") that a mode runs.

    ``pack_im2col`` packs bf16 taps, so it is refused for the exact mode
    (`fused_conv.py:719-721` of the JAX package).  For ``"bf16x1"`` the
    pair pack is a Mosaic store workaround: it is accepted and changes
    nothing.  The narrow tile exists for ``"bf16x1"`` only."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if geom is not None and geom not in GEOMS:
        raise ValueError(f"geom must be one of {GEOMS}, got {geom!r}")
    if precision == "exact":
        if pack_im2col:
            raise ValueError("pack_im2col packs bf16 taps; the exact tier "
                             "needs the f32 scratch")
        if geom == "narrow":
            raise ValueError("the narrow geometry is the bf16x1 kernel K3n")
        return "K1"
    if precision == "split":
        if geom == "narrow":
            raise ValueError("the narrow geometry is the bf16x1 kernel K3n")
        if pack_im2col is None:
            pack_im2col = PACK_IM2COL_SPLIT_DEFAULT
        return "K3h" if pack_im2col else "K2"
    if geom is None:
        geom = "narrow" if NARROW_DEFAULT else "wide"
    return "K3n" if geom == "narrow" else "K3"


def _flags(edge_flags) -> tuple[int, int, int, int]:
    if edge_flags is None:
        return (1, 1, 1, 1)
    flags = tuple(int(f) for f in edge_flags)
    if len(flags) != 4 or any(f not in (0, 1) for f in flags):
        raise ValueError(f"edge_flags must be 4 values in {{0, 1}}, got {edge_flags!r}")
    return flags


def _check_plane(y_padded: torch.Tensor, h: int, w: int) -> None:
    if h < 1 or w < 1:
        raise ValueError(f"output size must be positive, got {h}x{w}")
    if y_padded.dtype != torch.float32:
        raise TypeError(f"y_padded must be float32, got {y_padded.dtype}")
    if (y_padded.dim() not in (2, 3) or tuple(y_padded.shape[-2:]) !=
            (h + 2 * HALO, w + 2 * HALO)):
        raise ValueError(f"y_padded must be [h+12, w+12] or [N, h+12, w+12] "
                         f"with h+12, w+12 = {h + 2 * HALO}, {w + 2 * HALO}; "
                         f"got {list(y_padded.shape)}")
    if y_padded.dim() == 3 and not 1 <= y_padded.shape[0] <= 65535:
        raise ValueError(f"batch of {y_padded.shape[0]} planes: the kernels "
                         f"take 1 to 65535")


def _ring_index(n: int, lo_edge: int, hi_edge: int, device) -> torch.Tensor:
    """Indices into a c2 axis of n+4 entries (global -2 .. n+1) that clamp
    the ring to the image at a true edge and keep it elsewhere."""
    g = torch.arange(-2, n + 2, device=device)
    return g.clamp(0 if lo_edge else -2, n - 1 if hi_edge else n + 1) + 2


def forward_y_reference(params: dict, y_padded: torch.Tensor, h: int, w: int,
                        edge_flags=None, *, precision: str = "exact",
                        pack_im2col: bool | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`forward_y` (same signature; the
    geometry changes nothing the kernels compute, so it has none): the
    ``models/srcnn`` convs in ``precision`` on the halo plane, with the
    ring clamp as an index gather.  K3h's plain version is K2's.  With all
    flags set, a replicate halo and ``precision="exact"`` it equals
    ``srcnn.forward_y`` on the inner plane."""
    _check_plane(y_padded, h, w)
    kernel_for(precision, pack_im2col)           # the same argument checks
    top, bottom, left, right = _flags(edge_flags)
    dev = y_padded.device
    squeeze = y_padded.dim() == 2
    x = (y_padded[None] if squeeze else y_padded)[:, None]
    with srcnn.exact_f32(dev):
        c2 = srcnn.conv12(params, x, precision)             # [N,32,h+4,w+4]
        c2 = c2.index_select(2, _ring_index(h, top, bottom, dev))
        c2 = c2.index_select(3, _ring_index(w, left, right, dev))
        out = srcnn.conv3(params, c2, precision)
    return out[0] if squeeze else out


def _check_band(tile_h, band_impl: str = BAND_IMPLS[0]) -> None:
    if band_impl not in BAND_IMPLS:
        raise ValueError(f"band_impl must be one of {BAND_IMPLS}, got {band_impl!r}")
    if isinstance(tile_h, bool) or not isinstance(tile_h, int) or tile_h < 1:
        raise ValueError(f"tile_h must be an int >= 1, got {tile_h!r}")


def forward_y_band_reference(params: dict, y_padded: torch.Tensor, h: int,
                             w: int, edge_flags=None, *, tile_h: int = 64,
                             band_impl: str = "unroll") -> torch.Tensor:
    """Plain PyTorch version of :func:`forward_y_band` (K5): K3's,
    ``forward_y_reference(..., precision="bf16x1")``, since the band
    geometry changes nothing a pixel computes.  Checks ``tile_h`` and
    ``band_impl`` as the kernel's wrapper does."""
    _check_band(tile_h, band_impl)
    return forward_y_reference(params, y_padded, h, w, edge_flags,
                               precision="bf16x1")


def forward_y_int8_reference(qparams: dict, y_padded: torch.Tensor, h: int,
                             w: int, edge_flags=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`forward_y_int8` (K4): the
    ``models/srcnn_int8`` convs on the halo plane, with the ring clamp as
    an index gather on conv2's accumulators (the folded requant that
    follows is per position, so clamping acc2 or c2q is the same).  With
    all flags set and a replicate halo it equals ``srcnn_int8.forward_y``
    on the inner plane."""
    _check_plane(y_padded, h, w)
    srcnn_int8.check_params(qparams)
    top, bottom, left, right = _flags(edge_flags)
    dev = y_padded.device
    squeeze = y_padded.dim() == 2
    xq = srcnn_int8.quantize_input(y_padded[None] if squeeze else y_padded)
    acc2 = srcnn_int8.conv12(qparams, xq)                   # [N,h+4,w+4,32]
    acc2 = acc2.index_select(1, _ring_index(h, top, bottom, dev))
    acc2 = acc2.index_select(2, _ring_index(w, left, right, dev))
    c2q = srcnn_int8.fold_requant(acc2, qparams["s2"], qparams["t2"])
    out = srcnn_int8.conv3(qparams, c2q)
    return out[0] if squeeze else out


def build_all() -> None:
    """Build every kernel library, the profiling path's included (one
    nvcc each, all at once), and load each."""
    _build.build(*_build.LIBRARIES, *_build.main_libraries())
    for name in _build.LIBRARIES:
        _build.library(name)


def _prepare(fn: str, y_padded: torch.Tensor, h: int, w: int, edge_flags):
    """What :func:`forward_y`, :func:`forward_y_int8`, :func:`forward_y_band`
    and ``ablation.forward_y_cut`` (``fn``) share after their own checks:
    check the plane and the flags, and give (flags, out), ``out`` None for a
    CPU plane, which takes the plain version, and for a CUDA plane the new
    output the kernel launches into.  Any other device raises, and so does a
    CUDA plane that is not contiguous."""
    _check_plane(y_padded, h, w)
    flags = _flags(edge_flags)
    dev = y_padded.device
    if dev.type == "cpu":
        return flags, None
    if dev.type != "cuda":
        raise ValueError(f"{fn} takes CPU or CUDA tensors, got {dev}")
    if not y_padded.is_contiguous():
        raise ValueError("y_padded must be contiguous")
    return flags, torch.empty(y_padded.shape[:-2] + (h, w), dtype=torch.float32,
                              device=dev)


def forward_y(params: dict, y_padded: torch.Tensor, h: int, w: int,
              edge_flags=None, *, precision: str = "exact",
              pack_im2col: bool | None = None,
              geom: str | None = None) -> torch.Tensor:
    """Fused conv stack on halo planes ``[h+12, w+12]`` or ``[N, h+12,
    w+12]`` f32 -> ``[h, w]`` or ``[N, h, w]``.

    ``precision`` is ``"exact"`` (K1), ``"split"`` (K2; K3h with
    ``pack_im2col=True``) or ``"bf16x1"`` (K3; K3n with ``geom="narrow"``),
    see :func:`kernel_for`.  On a CUDA tensor this launches the kernel
    (built at first use) once for the whole batch on the current stream
    and counts it in :data:`launches_by`; on a CPU tensor it runs
    :func:`forward_y_reference`.  Any other device raises."""
    kernel = kernel_for(precision, pack_im2col, geom)
    flags, out = _prepare("fused_conv.forward_y", y_padded, h, w, edge_flags)
    if out is None:
        return forward_y_reference(params, y_padded, h, w, flags,
                                   precision=precision, pack_im2col=pack_im2col)
    launch(kernel, pack_params(params).to(out.device).contiguous(), y_padded,
           out, flags)
    return out


def forward_y_int8(qparams: dict, y_padded: torch.Tensor, h: int, w: int,
                   edge_flags=None) -> torch.Tensor:
    """The int8 tier's fused conv stack (K4) on halo planes ``[h+12,
    w+12]`` or ``[N, h+12, w+12]`` f32 -> ``[h, w]`` or ``[N, h, w]``, with
    the quantized pack of :mod:`..models.srcnn_int8` (port of
    ``forward_y_int8``, `fused_conv.py:649-671` of the JAX package).  On a
    CUDA tensor this launches K4 once for the whole batch and counts it;
    on a CPU tensor it runs :func:`forward_y_int8_reference`.  Any other
    device raises."""
    flags, out = _prepare("fused_conv.forward_y_int8", y_padded, h, w, edge_flags)
    if out is None:
        return forward_y_int8_reference(qparams, y_padded, h, w, flags)
    launch("K4", pack_int8_params(qparams).to(out.device), y_padded, out, flags)
    return out


def forward_y_band(params: dict, y_padded: torch.Tensor, h: int, w: int,
                   edge_flags=None, *, tile_h: int = 64,
                   band_impl: str = "unroll") -> torch.Tensor:
    """K3's conv stack in row bands (K5, port of ``forward_y_band``,
    `fused_conv.py:600-628` of the JAX package) on halo planes ``[h+12,
    w+12]`` or ``[N, h+12, w+12]`` f32 -> ``[h, w]`` or ``[N, h, w]``:
    one block per band of ``tile_h`` rows and plane, which walks all of
    its column tiles.  Its output equals K3's bit for bit.  ``band_impl``
    takes the JAX package's two names, :data:`BAND_IMPLS`; both run the
    one K5 instance.  On a CUDA tensor this launches K5 (from the
    profiling build, at first use) and counts it; on a CPU tensor it runs
    :func:`forward_y_band_reference`.  Any other device raises."""
    _check_band(tile_h, band_impl)
    flags, out = _prepare("fused_conv.forward_y_band", y_padded, h, w, edge_flags)
    if out is None:
        return forward_y_band_reference(params, y_padded, h, w, flags,
                                        tile_h=tile_h, band_impl=band_impl)
    launch("K5", pack_params(params).to(out.device).contiguous(), y_padded, out,
           flags, tile_h=tile_h)
    return out


def launch(kernel: str, packed: torch.Tensor, y_padded: torch.Tensor,
           out: torch.Tensor, flags=(1, 1, 1, 1), *, tile_h: int = 64) -> None:
    """Launch ``kernel`` (K1-K5) on CUDA tensors: ``packed`` from
    :func:`pack_params` (K4: :func:`pack_int8_params`), ``y_padded``
    [N, h+12, w+12] or [h+12, w+12] f32, ``out`` [N, h, w] or [h, w] f32,
    all contiguous on one device, on its current stream; ``tile_h`` is
    K5's band height and is read by K5 only.  Counts one launch in
    :data:`launches_by`, and for K1 the ring rows its walk computes and
    carries (:func:`k1_walk`) in ``utils.profiling.counts``.
    :func:`forward_y`, :func:`forward_y_int8` and :func:`forward_y_band`
    check their arguments and call this; a caller that keeps the packed
    weights of one parameter set may call it directly."""
    if kernel not in _KERNELS:
        raise ValueError(f"no kernel {kernel!r}; the kernels are {tuple(_KERNELS)} "
                         f"(K6 and K7 launch through kernels.ablation)")
    name, entry, extra = _KERNELS[kernel]
    if kernel == "K5":
        _check_band(tile_h)
        extra = (tile_h,)
    run(name, entry, kernel, packed, y_padded, out, flags, *extra)
    if kernel == "K1":
        walk = k1_walk(1 if out.dim() == 2 else out.shape[0], *out.shape[-2:],
                       _sm_count(out.device))
        profiling.counts["k1.ring_rows_computed"] += walk.rows_computed
        profiling.counts["k1.ring_rows_carried"] += walk.rows_carried


def run(name: str, entry: str, counted: str, packed: torch.Tensor,
        y_padded: torch.Tensor, out: torch.Tensor, flags, *extra: int) -> None:
    """Check the arguments of a launch and make it: entry point ``entry``
    of fused library ``name`` (``_build.LIBRARIES``) with ``extra`` int
    arguments after the flags, counted as ``counted``.  :func:`launch`
    and :func:`.ablation.launch_cut` call this."""
    h, w = out.shape[-2:]
    pdtype = torch.uint8 if name.startswith("fused_srcnn_int8") else torch.float32
    for arg, t, dtype in (("packed", packed, pdtype),
                          ("y_padded", y_padded, torch.float32),
                          ("out", out, torch.float32)):
        if (t.device != y_padded.device or t.dtype != dtype
                or not t.is_contiguous()):
            raise ValueError(f"{arg} must be a contiguous {dtype} tensor on "
                             f"{y_padded.device}")
    _build.cuda_device(y_padded, counted)       # before the library loads
    if y_padded.shape[:-2] != out.shape[:-2]:
        raise ValueError(f"y_padded {list(y_padded.shape)} and out "
                         f"{list(out.shape)} hold different batches")
    _check_plane(y_padded, h, w)
    flags = _flags(flags)
    limits = _build.constants(name)
    if packed.numel() != limits["n_params"]:
        raise ValueError(f"packed params hold {packed.numel()} elements, the "
                         f"kernel takes {limits['n_params']}")
    if h > limits["max_rows"]:
        raise ValueError(f"h={h} exceeds the kernel's grid limit of "
                         f"{limits['max_rows']} rows")
    n = 1 if y_padded.dim() == 2 else y_padded.shape[0]
    _build.launch(name, entry, counted, y_padded, out, packed, n, h, w, *flags,
                  *extra)
