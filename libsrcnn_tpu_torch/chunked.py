"""Out-of-core upscaling on one device: stream output-row bands (PyTorch
port of ``libsrcnn_tpu/chunked.py``).

The frame never exists on the card at once.  The host streams horizontal
output bands -- u8 source rows up, u8 result rows back -- and every
intermediate lives at band height, so peak device memory is O(band)
instead of O(image).  This is the library's answer for frames whose
planes do not fit on the device.

Exactness is the design constraint.  Each band is computed from the
GLOBAL contribution tables sliced to its rows (the reference's boundary
renormalization, `frawscale.cpp:52-108`, stays as it is), with the same
tap order and the same dropped all-zero tap columns as
:func:`.ops.resize._resize_axis`, so a band's resized rows equal the
one-shot plane's bit for bit.  The Y band carries the conv stack's 6 px
halo of REAL neighbour rows (replicated rows only at true image edges, by
the table-row replication that ``resize_plane_padded`` uses), and the
kernels' ``edge_flags`` say which of the band's borders are image edges:
``(r0 == 0, r1 == dst_h, 1, 1)`` (bands span the full width).  The conv
stack's per-pixel sums do not depend on where a pixel sits in a tile or a
plane, so the result equals :func:`.api.upscale` at the same tier, bit for
bit.

Three model kinds, three halo plans, each derived from the model:

* **srcnn** (9-1-5): a 6 px halo (4 conv1 + 2 conv3) and the reference's
  conv2-OUTPUT border replication (`libsrcnn.cpp:463-489`), gated by the
  flags.  On the kernel path (a CUDA device) each band's
  ``[bh+12, dst_w+12]`` halo plane goes through ``fused_conv.forward_y``:
  K1, K2 or K3 for the ``float32``, ``bfloat16`` and ``bfloat16_fast``
  tiers.  Off the kernel (the CPU, or ``use_kernel=False``) the exact tier
  runs the kernels' plain version with the same flags; the bf16 tiers are
  kernel-only here, and the int8 tier is one-shot only, as in the JAX
  package.
* **HR families** (vdsr, srcnn955: per-layer replicate-padded stacks): the
  halo is the stack's receptive radius (``<family>.halo_width(spec)``); at
  true image edges ``forward_hr_halo`` re-imposes each layer's replicate
  padding before every conv, and interior band borders keep their real
  neighbour rows.  No cut may sit within the halo of a true edge
  (:func:`_cut_ok`).
* **LR families** (fsrcnn, espcn: replicate-padded stacks with a learned
  upscale): bands are cut on whole LR rows and extended by
  ``<family>.lr_halo_width(spec, params)`` REAL neighbour LR rows (clamped
  at the true edges), run through the unmodified ``forward_lr``, and the
  halo's output rows are cropped.  Every kept output row's receptive field
  lies inside the slice's real rows or reaches a true image edge, where
  the slice border is the image border, so no flags are needed.
* **swinir** is refused (``pipeline.refuse_whole_frame``): its shifted windows
  chain every window to its neighbours through all the layers, so no
  finite halo gives a band the frame's values.

The families run at ``float32`` and ``bfloat16`` on either device, through
the same convs as the one-shot pass (:mod:`.ops.conv`), whose per-pixel
sums do not depend on the plane's shape.

``self_ensemble=True`` runs the flip self-ensemble band-wise: for each
output band, the four flip variants' corresponding bands (the flipped
image's bands are the mirrored plan) are computed, unflipped and averaged
as the one-shot ensemble does, so peak memory stays O(band).
"""

from __future__ import annotations

import numpy as np
import torch

from . import api, pipeline
from .config import DEFAULT_CONFIG, FilterType, SRCNNConfig, chroma_filter
from .kernels import fused_conv
from .ops import color, resize
from .ops.weights_table import contribution_table

#: srcnn conv stack halo: 4 (conv1 9x9) + 2 (conv3 5x5)
CONV_HALO = fused_conv.HALO


def _global_band_tables(filter_type: FilterType, dst: int, src: int):
    """Full-plane vertical gather tables in band form: clipped source
    indices [dst, K] int64 and f32 weights [dst, K], with the all-zero tap
    columns dropped exactly as :func:`.ops.resize._resize_axis` drops them
    (so per-row arithmetic, term order included, is the one-shot
    resize's).  ``dst == src`` degenerates to the K=1 identity table
    (multiply by 1.0), bitwise the copy the one-shot resize makes."""
    if dst == src:
        idx = np.arange(src, dtype=np.int64)[:, None]
        return idx, np.ones((src, 1), np.float32)
    left, w = contribution_table(filter_type, dst, src)
    k_all = w.shape[1]
    idx = np.clip(left[:, None] + np.arange(k_all)[None, :], 0, src - 1)
    keep = [k for k in range(k_all) if np.any(w[:, k])]
    return idx[:, keep].astype(np.int64), w[:, keep].astype(np.float32)


def _apply_band_axis0(plane: torch.Tensor, idx: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Vertical band gather with runtime tables ``idx`` [K, rows] int64 and
    ``w`` [K, rows] f32: emit ``rows`` rows of the globally resized plane
    [..., S, W].  The k-order accumulation of ``ops.resize._resize_axis``."""
    acc = None
    for k in range(w.shape[0]):
        term = plane.index_select(-2, idx[k]) * w[k][:, None]
        acc = term if acc is None else acc + term
    return acc


def _cut_ok(r: int, dst_h: int, halo: int, model: str) -> bool:
    """May a band boundary sit at output row ``r``?

    srcnn: not at row 1 or dst_h-1: the conv2-output ring is +-2 rows, so a
    band starting at row 1 (or ending at dst_h-1) has a ring row beyond the
    TRUE image edge while its edge flag is off, and a replicated-input ring
    is not the reference's replicated-conv2-output ring
    (`libsrcnn.cpp:463-489`).

    HR families: every cut at least ``halo`` rows from the true edges -- a
    band whose halo rows cross the image edge WITHOUT its edge flag would
    fill them with replicated input, which is not the model's per-layer
    replicate padding (`chunked.py:278-296` of the JAX package).

    Both rules are mirror-symmetric in r <-> dst_h - r, which the band-wise
    flip ensemble relies on."""
    if model == "srcnn":
        return r != 1 and r != dst_h - 1
    return halo <= r <= dst_h - halo


def _bands_from_edges(edges, halo: int, dst_h: int, gy_idx, gc_idx):
    """Per band [r0, r1): the Y rows with their halo (clipped to the
    image), the chroma rows, and the u8 source-row window [smin, smax)
    that covers both."""
    bands = []
    for r0, r1 in zip(edges[:-1], edges[1:]):
        rows_y = np.clip(np.arange(r0 - halo, r1 + halo), 0, dst_h - 1)
        rows_c = np.arange(r0, r1)
        iy = gy_idx[rows_y]
        ic = gc_idx[rows_c]
        smin = int(min(iy.min(), ic.min()))
        smax = int(max(iy.max(), ic.max())) + 1
        bands.append((r0, r1, rows_y, rows_c, smin, smax))
    return bands


def _cuts(dst_h: int, band_rows: int, halo: int, model: str) -> list[int]:
    """Cuts every ``band_rows`` rows, less those :func:`_cut_ok` refuses
    (the offending band merges into its neighbour)."""
    return [r for r in range(band_rows, dst_h, band_rows)
            if _cut_ok(r, dst_h, halo, model)]


def _bands_from_edges_lr(edges, halo: int, r: int, src_h: int, gc_idx):
    """LR-family bands (`chunked.py:202-220` of the JAX package): output
    band [r0, r1) (both multiples of the scale ``r``), its LR Y rows
    [ys0, ys1) (the band's own LR rows and up to ``halo`` REAL neighbour
    rows each side, clamped at the true edges), the chroma output rows,
    and the u8 source-row window [smin, smax) covering both."""
    bands = []
    for r0, r1 in zip(edges[:-1], edges[1:]):
        ys0 = max(0, r0 // r - halo)
        ys1 = min(src_h, r1 // r + halo)
        rows_c = np.arange(r0, r1)
        ic = gc_idx[rows_c]
        smin = int(min(ys0, ic.min()))
        smax = int(max(ys1, ic.max() + 1))
        bands.append((r0, r1, ys0, ys1, rows_c, smin, smax))
    return bands


def _resolve_chunked(cfg: SRCNNConfig, device: torch.device) -> bool:
    """Validate ``cfg`` for the chunked path; returns whether srcnn's bands
    go through the fused kernel (False for the families, which have none).
    Raises ``ValueError`` where the JAX package does
    (`chunked.py:323-381`)."""
    if cfg.step_scale:
        raise ValueError("step_scale is not supported by the chunked path "
                         "(one direct pass; chain calls per x2 pass)")
    if cfg.lane_pack:
        # the JAX package's bands run the learned families unpacked, so that
        # they stay bit-identical to the unpacked one-shot path, and refuse an
        # explicit lane_pack=True rather than change the reduction order
        raise ValueError("lane_pack=True is not supported by the chunked "
                         "path (bands run the LR stacks unpacked; leave "
                         "lane_pack unset/False)")
    pipeline.check_supported(cfg)
    pipeline.refuse_whole_frame(cfg, "upscale_chunked")
    if cfg.model != "srcnn":
        return False
    use_kernel = pipeline.resolve_kernel(cfg.use_kernel, device)
    if not (cfg.compute_dtype == "float32" or (
            cfg.compute_dtype in ("bfloat16", "bfloat16_fast") and use_kernel)):
        raise ValueError(
            f"the chunked path's srcnn conv tiers are float32 (plain or "
            f"kernel) and bfloat16/bfloat16_fast (kernel only); int8 is "
            f"one-shot only -- got compute_dtype={cfg.compute_dtype!r} with "
            f"use_kernel={cfg.use_kernel!r} on {device}")
    return use_kernel


def _band_resize(plane: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                 src_w: int, dst_w: int, filter_type: FilterType,
                 pad: tuple = ()) -> torch.Tensor:
    """A band of the globally resized plane: the vertical band gather
    (``idx`` / ``w``) and the horizontal pass (with ``pad`` =
    ``(pad_lo, out)`` replicate columns), in the reference's pass order."""
    if dst_w > src_w:
        return resize._resize_axis(_apply_band_axis0(plane, idx, w), dst_w,
                                   filter_type, 1, *pad)
    return _apply_band_axis0(resize._resize_axis(plane, dst_w, filter_type, 1, *pad),
                             idx, w)


def upscale_chunked(image, multiply: float, cfg: SRCNNConfig = DEFAULT_CONFIG,
                    *, band_rows: int = 512, params=None,
                    inflight_bands: int = 2,
                    device: str | torch.device = "cuda"):
    """Upscale one [H, W, D] u8 frame through ``device`` in horizontal
    output bands of ``band_rows`` rows (an LR family's rounded down to
    whole LR rows).

    Returns host numpy ``(out_u8 [H', W', D], conv_u8 [H', W'])``, equal bit
    for bit to :func:`.api.upscale` with ``return_conv_map=True`` at the
    same tier; peak device memory is O(inflight_bands x band_rows x W'),
    independent of H.

    ``inflight_bands`` bounds how many bands' results may wait on the
    device before the oldest is fetched (the fetch is the only blocking
    call of the loop); 1 is fully serial.  Outputs do not depend on it.

    srcnn at ``float32`` (kernel or plain) and at the bf16 tiers (kernel
    only), no int8; the families at ``float32`` and ``bfloat16``; no
    step-scale (chain calls per x2 pass), and an LR head takes its own
    scale exactly.  ``self_ensemble=True`` runs the band-wise flip ensemble
    (4x the compute, still O(band) memory, equal to the one-shot
    ensemble).  ``device``: ``"cuda"`` (default) raises without a card;
    CPU runs pass ``"cpu"``."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise TypeError(f"expected a uint8 image, got {image.dtype}")
    if image.ndim != 3 or image.shape[-1] not in (3, 4):
        raise ValueError(f"expected [H, W, 3|4] u8 image, got {image.shape}")
    h, w, _ = image.shape
    dst_w, dst_h = resize.scaled_size(w, h, multiply)
    if dst_w <= 0 or dst_h <= 0:
        raise ValueError(f"bad scale {multiply} for {w}x{h}")
    if band_rows < 1:
        raise ValueError("band_rows must be >= 1")
    if inflight_bands < 1:
        raise ValueError("inflight_bands must be >= 1")
    dev = api._device(device)
    use_kernel = _resolve_chunked(cfg, dev)
    params, spec = pipeline.prepare_model_params(
        cfg, api._params_on(params, cfg, dev, multiply), h, w, dst_h, dst_w,
        multiply)
    mod = pipeline.FAMILY_MODULES.get(cfg.model)
    prec = None if mod is None else pipeline.family_precision(cfg.compute_dtype)

    y_filter = FilterType(cfg.filter)
    c_filter = chroma_filter(y_filter)
    gc_idx, gc_w = _global_band_tables(c_filter, dst_h, h)

    def table(t, rows, shift=0):
        return torch.from_numpy(np.ascontiguousarray((t[rows] - shift).T)).to(dev)

    def finish(src, y_sr, rows_c, smin):
        """The band's chroma rows beside its Y result -> (out_u8, conv_u8)."""
        vc_idx, vc_w = table(gc_idx, rows_c, smin), table(gc_w, rows_c)
        rest = [_band_resize(p, vc_idx, vc_w, w, dst_w, c_filter) for p in src[1:]]
        out_u8 = color.ycbcr_to_rgb(torch.stack([y_sr, *rest], dim=0))
        return out_u8, torch.floor(y_sr).to(torch.uint8)

    def planes_of(img, smin, smax):
        src = torch.from_numpy(np.ascontiguousarray(img[smin:smax])).to(dev)
        return color.rgb_to_ycbcr(src)               # [D, smax-smin, w]

    if cfg.model in pipeline.LR_FAMILIES:
        r = spec.scale
        halo = mod.lr_halo_width(spec, params)
        # band boundaries sit on whole LR rows: each LR row emits exactly r
        # output rows through the learned upscale head
        br = max(r, band_rows // r * r)
        cuts = list(range(br, dst_h, br))

        def plan(edges):
            return _bands_from_edges_lr(edges, halo, r, h, gc_idx)

        def dispatch(img, band):
            r0, r1, ys0, ys1, rows_c, smin, smax = band
            planes = planes_of(img, smin, smax)
            sr = mod.forward_lr(params, planes[0][ys0 - smin:ys1 - smin], spec,
                                precision=prec)
            top = (r0 // r - ys0) * r
            return finish(planes, sr[top:top + r1 - r0], rows_c, smin)
    else:
        halo = CONV_HALO if mod is None else mod.halo_width(spec)
        gy_idx, gy_w = _global_band_tables(y_filter, dst_h, h)
        cuts = _cuts(dst_h, band_rows, halo, cfg.model)

        def plan(edges):
            return _bands_from_edges(edges, halo, dst_h, gy_idx, gc_idx)

        def dispatch(img, band):
            """One band's pass on the device (asynchronous on CUDA); returns
            its (out_u8, conv_u8) device tensors."""
            r0, r1, rows_y, rows_c, smin, smax = band
            bh = r1 - r0
            planes = planes_of(img, smin, smax)
            # Y: the band (+halo rows) with the conv stack's column halo
            yb = _band_resize(planes[0], table(gy_idx, rows_y, smin),
                              table(gy_w, rows_y), w, dst_w, y_filter,
                              (halo, dst_w + 2 * halo))
            flags = (int(r0 == 0), int(r1 == dst_h), 1, 1)
            if mod is not None:
                y_sr = mod.forward_hr_halo(params, yb, flags, spec, halo=halo,
                                           precision=prec)
            elif use_kernel:
                y_sr = fused_conv.forward_y(
                    params, yb, bh, dst_w, flags,
                    precision=pipeline.KERNEL_PRECISION[cfg.compute_dtype])
            else:
                y_sr = fused_conv.forward_y_reference(params, yb, bh, dst_w, flags)
            return finish(planes, y_sr, rows_c, smin)

    bands = plan([0] + cuts + [dst_h])
    if cfg.self_ensemble:
        # the flipped geometry: the MIRRORED cuts (every cut rule is
        # mirror-symmetric, and an LR family's stay on whole LR rows as
        # dst_h = r * h), windows from the same tables
        mirrored = plan([0] + [dst_h - c for c in reversed(cuts)] + [dst_h])
        return _chunked_ensemble(image, bands, mirrored, dispatch, inflight_bands)

    outs, convs = [], []
    inflight: list = []   # bounded window of bands' device results

    def drain_one():
        out_b, conv_b = inflight.pop(0)
        outs.append(out_b.cpu().numpy())
        convs.append(conv_b.cpu().numpy())

    for band in bands:
        inflight.append(dispatch(image, band))
        if len(inflight) > inflight_bands:
            drain_one()
    while inflight:
        drain_one()
    return np.concatenate(outs, axis=0), np.concatenate(convs, axis=0)


def _chunked_ensemble(image, bands, mirrored, dispatch, inflight_bands: int):
    """Band-wise flip self-ensemble (`chunked.py:519-572` of the JAX
    package): every output band is the f32 mean of the four flip
    variants' corresponding bands, rounded half to even (``np.rint``), as
    ``serve._ensemble_pass`` averages the four full-frame u8 outputs.

    A vertically flipped variant's band ranges are the MIRRORED plan, so
    its share of output band i is its own band n-1-i, flipped back.  Each
    output band is reduced on the host before the next one is fetched."""
    n = len(bands)
    flips = ((False, False), (False, True), (True, False), (True, True))
    views = {fv: image[::-1 if fv[0] else 1, ::-1 if fv[1] else 1]
             for fv in flips}

    def unflip(a, fv):
        fy, fx = fv
        if fy:
            a = a[::-1]
        if fx:
            a = a[:, ::-1]
        return a

    outs, convs = [], []
    inflight: list = []   # per band: [(flip, device out, device conv)] x 4

    def drain_one():
        acc_o = acc_c = None
        for fv, ob, cb in inflight.pop(0):
            o = unflip(ob.cpu().numpy(), fv).astype(np.float32)
            c = unflip(cb.cpu().numpy(), fv).astype(np.float32)
            acc_o = o if acc_o is None else acc_o + o
            acc_c = c if acc_c is None else acc_c + c
        outs.append(np.rint(acc_o / 4.0).astype(np.uint8))
        convs.append(np.rint(acc_c / 4.0).astype(np.uint8))

    for i in range(n):
        group = []
        for fv in flips:
            band = mirrored[n - 1 - i] if fv[0] else bands[i]
            group.append((fv, *dispatch(views[fv], band)))
        inflight.append(group)
        if len(inflight) > inflight_bands:
            drain_one()
    while inflight:
        drain_one()
    return np.concatenate(outs, axis=0), np.concatenate(convs, axis=0)
