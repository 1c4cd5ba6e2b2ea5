"""The full upscale (color -> resize -> model -> merge) of one frame cut over
a device mesh with explicit halo exchange (PyTorch port of
``libsrcnn_tpu/parallel/tiled.py``): the answer for frames too large for
one device.

* color split and merge are elementwise: no exchange;
* the separable resize exchanges :func:`_axis_halo` source rows / columns
  per pass and applies the GLOBAL contribution tables sliced per tile, with
  the all-zero tap columns dropped from the global table (never per tile),
  so that each output pixel sums the one-shot resize's terms in its order
  and the boundary renormalisation stays the reference's
  (`frawscale.cpp:52-108`);
* the model runs on the halo bodies: srcnn's kernel or plain body
  (:mod:`.halo`), an HR family's ``forward_hr_halo`` or an LR family's
  ``forward_lr_halo`` after one exchange of the family's halo.

The mesh's ``data`` axis replicates: each (row, col) tile is computed once,
on the device at data index 0 (the JAX package computes it on every
replica; the outputs are the same).  The result is assembled on the host
tile by tile, so no device ever holds the whole frame.  On a mesh that
spans processes each process computes the tiles it owns, trades halos
with the other ranks and returns its tiles as ``halo.Shard`` s.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from .. import api, pipeline
from ..chunked import _global_band_tables
from ..config import FilterType, SRCNNConfig, chroma_filter
from ..ops import color
from ..ops.filters import FILTERS
from ..ops.resize import scaled_size
from . import halo as halo_mod
from .mesh import Mesh


def _axis_halo(filter_type: FilterType, dst: int, src: int) -> int:
    """Source pixels one resize axis needs beyond a tile's own on each side."""
    _, fw = FILTERS[FilterType(filter_type)]
    scale = dst / src
    width = fw / scale if scale < 1.0 else fw
    return int(math.ceil(width)) + 1


@functools.lru_cache(maxsize=64)
def _tile_tables(filter_type: FilterType, dst: int, src: int, n: int,
                 device: torch.device):
    """Per tile of an axis cut in ``n``: (index [K, dst/n] int64 into the
    tile's extended axis, weight [K, dst/n] f32) on ``device``, the rows of
    the global table (all-zero tap columns dropped globally) for the tile's
    output pixels."""
    halo = _axis_halo(filter_type, dst, src)
    gidx, gw = _global_band_tables(filter_type, dst, src)
    src_l, dst_l = src // n, dst // n
    tables = []
    for i in range(n):
        rows = slice(i * dst_l, (i + 1) * dst_l)
        local = gidx[rows] - (i * src_l - halo)
        if local.min() < 0 or local.max() >= src_l + 2 * halo:
            raise AssertionError(f"resize taps of tile {i} reach past its halo of {halo}")
        tables.append(tuple(torch.from_numpy(np.ascontiguousarray(t.T)).to(device)
                            for t in (local, gw[rows])))
    return tables


def _resize_axis_grid(grid, filter_type: FilterType, dst: int, src: int,
                      axis: int, owners=None):
    """Resize ``axis`` (0: rows, dim -2; 1: columns, dim -1) of every tile
    [..., h, w] to its share of ``dst``: an exchange of :func:`_axis_halo`
    source pixels, then the global table's rows for the tile, in the
    one-shot resize's tap order (``ops.resize._resize_axis``)."""
    n = len(grid) if axis == 0 else len(grid[0])
    ext = halo_mod._exchange(grid, _axis_halo(filter_type, dst, src), axis, owners)
    dim = axis - 2

    def resize(ri, ci, e):
        idx, w = _tile_tables(FilterType(filter_type), dst, src, n,
                              e.device)[ri if axis == 0 else ci]
        acc = None
        for k in range(w.shape[0]):
            wk = w[k][:, None] if axis == 0 else w[k][None, :]
            term = e.index_select(dim, idx[k]) * wk
            acc = term if acc is None else acc + term
        return acc

    return halo_mod.tile_map(resize, ext)


def _resize_grid(grid, filter_type: FilterType, dst_h: int, dst_w: int,
                 h: int, w: int, owners=None):
    """Both axes in the reference's pass order (`frawscale.cpp:195-278`:
    vertical first when the width grows, else horizontal first); an axis
    whose size does not change is skipped, as the one-shot resize skips
    it (a scale-1 table would blur under a filter that does not
    interpolate)."""
    def v(g):
        return g if dst_h == h else _resize_axis_grid(g, filter_type, dst_h, h, 0, owners)

    def z(g):
        return g if dst_w == w else _resize_axis_grid(g, filter_type, dst_w, w, 1, owners)

    return z(v(grid)) if dst_w > w else v(z(grid))


def _plan(image, params, multiply: float, cfg: SRCNNConfig, mesh: Mesh):
    """Check the geometry and the model; returns (dst_h, dst_w, spec,
    model_halo, per-device params)."""
    h, w, _ = image.shape
    rows, cols = mesh.size("row"), mesh.size("col")
    dst_w, dst_h = scaled_size(w, h, multiply)
    if dst_w <= 0 or dst_h <= 0:
        raise ValueError(f"bad scale {multiply} for {w}x{h}")
    devs = {d for ri, row in enumerate(halo_mod.tile_devices(mesh))
            for ci, d in enumerate(row) if mesh.is_addressable(row=ri, col=ci)}
    prepared = {d: pipeline.prepare_model_params(
        cfg, api._params_on(params, cfg, d, multiply), h, w, dst_h, dst_w, multiply)
        for d in devs}
    on = {d: p for d, (p, _) in prepared.items()}
    params0, spec = next(iter(prepared.values()))
    model_halo = 0
    if cfg.model in pipeline.HR_FAMILIES:
        model_halo = pipeline.FAMILY_MODULES[cfg.model].halo_width(spec)
    elif cfg.model in pipeline.LR_FAMILIES:
        model_halo = pipeline.FAMILY_MODULES[cfg.model].lr_halo_width(spec, params0)
    for name, size, parts in (("H", h, rows), ("W", w, cols),
                              ("H'", dst_h, rows), ("W'", dst_w, cols)):
        if size % parts:
            raise ValueError(f"{name}={size} not divisible by mesh axis {parts}")
    if model_halo:
        # HR families: the halo counts output px; LR families: LR px
        th, tw = ((h // rows, w // cols) if cfg.model in pipeline.LR_FAMILIES
                  else (dst_h // rows, dst_w // cols))
        if th < model_halo or tw < model_halo:
            raise ValueError(f"per-shard tile {th}x{tw} smaller than the "
                             f"{cfg.model} halo {model_halo}")
    return dst_h, dst_w, spec, model_halo, on


def _run(image, params, multiply: float, cfg: SRCNNConfig, mesh: Mesh,
         kernel: bool):
    """One tiled pass of a host u8 frame: ``kernel`` picks srcnn's kernel
    body over its plain body (the families have one body).  Returns host
    numpy (out_u8 [H', W', D], conv_u8 [H', W']), or this process's tiles
    of both as ``halo.Shard`` lists on a mesh that spans processes."""
    owners = halo_mod.tile_owners(mesh)
    if owners is not None and all(r != mesh.rank for row in owners for r in row):
        return [], []          # no tile here, and no halo to trade
    image = api._as_u8_image(image)
    h, w, _ = image.shape
    dst_h, dst_w, spec, model_halo, on = _plan(image, params, multiply, cfg, mesh)
    y_filter = FilterType(cfg.filter)
    c_filter = chroma_filter(y_filter)
    tile_map = halo_mod.tile_map

    planes = tile_map(lambda ri, ci, t: color.rgb_to_ycbcr(t),       # [D, th, tw]
                      halo_mod.shard(image, mesh))
    chroma = _resize_grid(tile_map(lambda ri, ci, p: p[1:], planes), c_filter,
                          dst_h, dst_w, h, w, owners)
    model = cfg.model
    luma = tile_map(lambda ri, ci, p: p[0], planes)
    if model in pipeline.LR_FAMILIES:
        # the LR stack reads the raw Y tile and upscales it itself
        src = luma
    else:
        src = _resize_grid(luma, y_filter, dst_h, dst_w, h, w, owners)
    if model == "srcnn":
        p = next(iter(on.values()))
        if kernel:
            y_sr = halo_mod._tile_forward_kernel(
                p, src, pipeline.KERNEL_PRECISION[cfg.compute_dtype], owners)
        else:
            y_sr = halo_mod._tile_forward(p, src, cfg.compute_dtype, owners)
    else:
        mod = pipeline.FAMILY_MODULES[model]
        fwd = mod.forward_lr_halo if model in pipeline.LR_FAMILIES else mod.forward_hr_halo
        prec = pipeline.family_precision(cfg.compute_dtype)
        y_sr = tile_map(lambda ri, ci, e: fwd(on[e.device], e,
                                              halo_mod.edge_flags(src, ri, ci), spec,
                                              halo=model_halo, precision=prec),
                        halo_mod.exchange2d(src, model_halo, owners))

    merged = tile_map(lambda ri, ci, y: color.merge(y, list(chroma[ri][ci])), y_sr)
    out = tile_map(lambda ri, ci, m: m[0], merged)
    conv = tile_map(lambda ri, ci, m: m[1], merged)
    return halo_mod.gather(out, (0, 1), owners), halo_mod.gather(conv, owners=owners)


def upscale_tiled(image, params, multiply: float, cfg: SRCNNConfig, mesh: Mesh):
    """Full upscale of one [H, W, D] u8 frame cut over the mesh's ``row`` /
    ``col`` axes, with a halo exchange before every stage that reads its
    neighbours.  Returns host numpy ``(out_u8 [H', W', D], conv_u8 [H',
    W'])``, equal bit for bit to ``api.upscale(..., return_conv_map=True)``
    at the same tier on the mesh's device type.

    H, W and H', W' must divide by the axis sizes, and each tile must hold
    the halos.  ``params``: ``cfg.model``'s, as ``api.upscale`` takes them
    (None: the shipped ones).

    srcnn runs ``float32`` on the kernel body (``cfg.use_kernel`` None or
    True: K1 per tile on a CUDA mesh) or the plain body (False), and the
    bf16 tiers on the kernel body only (K2, K3 per tile).  On a CPU mesh the
    kernel body runs the kernels' plain versions, so its bf16 tiers compute
    the kernels' math (split-bf16x2, bf16x1), not the XLA twin that
    ``api.upscale(device="cpu")`` runs.  ``int8`` is refused, as in the JAX
    package.  The HR families (vdsr, srcnn955) exchange
    ``halo_width(spec)`` output pixels and the LR families (fsrcnn, espcn)
    ``lr_halo_width`` LR pixels, at ``float32`` and ``bfloat16``; an LR
    head takes its own scale exactly; swinir is refused, having no finite
    halo (``pipeline.refuse_whole_frame``).  ``self_ensemble=True`` runs four
    tiled passes (:func:`_tiled_ensemble`).  No step-scale (chain calls per
    x2 pass) and no ``lane_pack=True``.

    On a mesh that spans processes every rank passes the same frame and
    gets its own tiles: ``(out_shards, conv_shards)``, lists of
    ``halo.Shard`` (no ensemble there: its flipped passes would put a
    rank's tile on another rank)."""
    pipeline.refuse_whole_frame(cfg, "upscale_tiled")
    if cfg.self_ensemble:
        if mesh.multi_process:
            raise ValueError("self_ensemble is not implemented on a mesh that spans "
                             "processes (ROADMAP M14e); ensemble on a single-process "
                             "mesh or per frame via api.upscale")
        return _tiled_ensemble(image, params, multiply, cfg, mesh)
    if cfg.step_scale:
        raise ValueError(
            "step_scale is not supported by the tiled path (it runs one "
            "direct pass; skipping the chained-x2 u8 round trips would break "
            "bit-identity with api.upscale) -- chain upscale_tiled calls per "
            "x2 pass instead")
    if cfg.lane_pack:
        raise ValueError("lane_pack=True is not supported by the tiled path "
                         "(tiles run the LR stacks unpacked; leave lane_pack "
                         "unset/False)")
    pipeline.check_supported(cfg)
    kernel = False
    if cfg.model == "srcnn":
        kernel = halo_mod.resolve_body(cfg.use_kernel, mesh)
        if not (cfg.compute_dtype == "float32" or (
                cfg.compute_dtype in ("bfloat16", "bfloat16_fast") and kernel)):
            raise ValueError(
                "the tiled path's srcnn conv tiers are float32 (kernel or plain "
                "body) and bfloat16/bfloat16_fast (kernel body only) -- got "
                f"compute_dtype={cfg.compute_dtype!r} with "
                f"use_kernel={cfg.use_kernel!r}; use a single device or "
                "upscale_batch for other tiers")
    return _run(image, params, multiply, cfg, mesh, kernel)


def _tiled_ensemble(image, params, multiply: float, cfg: SRCNNConfig, mesh: Mesh):
    """Flip self-ensemble over the tiled path: four tiled passes on the flip
    variants, flipped back and averaged on the host as the API's ensemble
    averages them (f32 mean of the four u8 outputs, rounded half to even),
    so the result equals ``api.upscale(self_ensemble=True)`` wherever each
    tiled pass equals its single-device twin."""
    base = dataclasses.replace(cfg, self_ensemble=False)
    image = api._as_u8_image(image)
    acc_o = acc_c = None
    for fy, fx in ((False, False), (False, True), (True, False), (True, True)):
        sl = (slice(None, None, -1 if fy else 1), slice(None, None, -1 if fx else 1))
        out, conv = upscale_tiled(np.ascontiguousarray(image[sl]), params,
                                  multiply, base, mesh)
        o, c = out[sl].astype(np.float32), conv[sl].astype(np.float32)
        acc_o = o if acc_o is None else acc_o + o
        acc_c = c if acc_c is None else acc_c + c
    return (np.rint(acc_o / 4.0).astype(np.uint8),
            np.rint(acc_c / 4.0).astype(np.uint8))
