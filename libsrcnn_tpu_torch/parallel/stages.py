"""Pipeline-stage parallelism: the conv stack split across a ``stage`` mesh
axis, the frames of a clip streaming through it (PyTorch port of
``libsrcnn_tpu/parallel/stages.py``).

Each device owns a contiguous group of the stack's atomic stages, and a
clip of N frames flows through the chain in ``N + S - 1`` steps: at step
``t`` stage ``s`` works on frame ``t - s`` (when there is one), then its
buffer goes to stage ``s + 1``'s device -- the only traffic between
devices, one [C, H', W'] buffer per step.  The JAX package runs the
schedule as one ``lax.scan`` in a ``shard_map`` with ``ppermute``; here one
controller loops over the steps and stages, and a buffer moves by
``Tensor.to``.  Stages on different cards overlap, since CUDA launches are
asynchronous.  On a mesh that spans processes each rank runs the stages it
owns, a buffer crosses to the next stage's rank by ``isend`` / ``irecv``
(:func:`.distributed.p2p`), and the last stage's rank returns the frames.

Activations travel in a fixed packed layout so that every stage maps
buffer -> buffer: channels ``[0:k)`` hold the live Y-path activation,
channels ``[C-(d-1):C)`` carry the resized chroma planes untouched to the
final merge, zeros between.  After the last stage channels ``[0:d)`` hold
the RGB(A) output and channel ``d`` the conv map, as f32 (u8 values are
exact in f32).

The atoms run the single-device pass's own plain f32 ops (the same convs,
resize gather and color converters), so the output equals
``api.upscale(..., use_kernel=False)`` per frame bit for bit.  The fused
kernel is one op over the whole stack and cannot be split across stages,
so this path launches no kernel, and float32 is its only tier.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import api, pipeline
from ..config import FilterType, SRCNNConfig, chroma_filter
from ..models import srcnn
from ..ops import color, resize
from ..ops.conv import conv_same
from . import distributed
from .mesh import Mesh

#: supported pipeline depths of srcnn / srcnn955: contiguous groupings of
#: the four atomic stages [resize+color, conv1, conv2, conv3+merge]
_GROUPINGS = {
    2: ((0, 1), (2, 3)),   # conv1 dominates the work; pair it with the resize
    3: ((0, 1), (2,), (3,)),
    4: ((0,), (1,), (2,), (3,)),
}


def _state_helpers(C: int, n_chroma: int, dst_h: int, dst_w: int, device):
    """The packed layout of the carry-less atoms: ``pack(act, chroma)`` and
    ``chroma_of(state)``."""
    def pack(act, chroma):
        fill = C - act.shape[0] - n_chroma
        parts = [act.to(torch.float32)]
        if fill:
            parts.append(torch.zeros((fill, dst_h, dst_w), dtype=torch.float32,
                                     device=device))
        if n_chroma:
            parts.append(chroma)
        return torch.cat(parts, dim=0)

    def chroma_of(state):
        return state[C - n_chroma:] if n_chroma else state[:0]

    return pack, chroma_of


def _resized(frame, d, dst_h, dst_w, y_filter, c_filter):
    """(resized Y [H', W'], resized chroma [d-1, H', W'] or None) of a u8
    frame, as the single-device pass resizes them."""
    planes = color.rgb_to_ycbcr(frame)
    y_r = resize.resize_plane(planes[0], dst_h, dst_w, y_filter)
    rest = [resize.resize_plane(planes[c], dst_h, dst_w, c_filter) for c in range(1, d)]
    return y_r, (torch.stack(rest) if rest else None)


def _final(y_sr, chroma):
    """The merged u8 output planes and the conv map of a clamped Y plane,
    as f32 [d+1, H', W']."""
    out_u8, conv_u8 = color.merge(y_sr, [] if chroma is None else list(chroma))
    return torch.cat([out_u8.permute(2, 0, 1), conv_u8[None]]).to(torch.float32)


def _atoms(params, d, dst_h, dst_w, y_filter, c_filter, n_chroma, device):
    """The 9-1-5 stack's four atoms, each (packed [C, H', W'] f32 state,
    [H, W, D] u8 frame) -> packed state; C = 64 + d - 1."""
    C = 64 + n_chroma
    pack, chroma_of = _state_helpers(C, n_chroma, dst_h, dst_w, device)

    def a_resize(state, frame):
        y_r, chroma = _resized(frame, d, dst_h, dst_w, y_filter, c_filter)
        return pack(y_r[None], chroma)

    def a_conv1(state, frame):
        with srcnn.exact_f32(device):
            h1 = srcnn.conv1(params, srcnn.edge_pad(state[:1][None], 4))
        return pack(h1[0], chroma_of(state))

    def a_conv2(state, frame):
        with srcnn.exact_f32(device):
            h2 = srcnn.conv2(params, state[:64][None])
        return pack(h2[0], chroma_of(state))

    def a_conv3(state, frame):
        with srcnn.exact_f32(device):
            y_sr = srcnn.conv3(params, srcnn.edge_pad(state[:32][None], 2))[0]
        return pack(_final(y_sr, chroma_of(state) if n_chroma else None),
                    chroma_of(state))

    return [a_resize, a_conv1, a_conv2, a_conv3]


def _atoms_generic(params, spec, d, dst_h, dst_w, y_filter, c_filter, n_chroma,
                   device):
    """The generic srcnn family's (``"srcnn955"``) four atoms: the 9-1-5
    split with per-layer replicate-padded SAME convs at the spec's sizes
    (``srcnn_generic.forward_hr``).  C = n1 + d - 1."""
    C = spec.n1 + n_chroma
    if spec.n1 < d + 1:
        raise ValueError(f"n1={spec.n1} too narrow to carry the output")
    if spec.n2 > spec.n1:
        raise ValueError(f"n2={spec.n2} > n1={spec.n1}: the stage state "
                         f"carries n1 + chroma channels")
    pack, chroma_of = _state_helpers(C, n_chroma, dst_h, dst_w, device)

    def a_resize(state, frame):
        y_r, chroma = _resized(frame, d, dst_h, dst_w, y_filter, c_filter)
        return pack(y_r[None], chroma)

    def a_conv1(state, frame):
        h = torch.relu(conv_same(state[:1][None], params["w1"], "exact", params["b1"]))
        return pack(h[0], chroma_of(state))

    def a_conv2(state, frame):
        h = torch.relu(conv_same(state[:spec.n1][None], params["w2"], "exact",
                                 params["b2"]))
        return pack(h[0], chroma_of(state))

    def a_conv3(state, frame):
        h = conv_same(state[:spec.n2][None], params["w3"], "exact", params["b3"])[:, 0]
        y_sr = torch.clamp(h, 0.0, 255.0)[0]
        return pack(_final(y_sr, chroma_of(state) if n_chroma else None),
                    chroma_of(state))

    return [a_resize, a_conv1, a_conv2, a_conv3]


def _atoms_vdsr(params, spec, d, dst_h, dst_w, y_filter, c_filter, n_chroma,
                device):
    """vdsr's depth + 1 atoms: [resize, in, mid x (depth-2), out + residual +
    merge].  Layout: channels [0:ch) the live activation, channel ch the
    carried interpolated Y (the residual's identity path must reach the
    last stage), the tail the chroma planes; C = ch + 1 + d - 1."""
    ch = spec.ch
    C = ch + 1 + n_chroma
    if ch < d + 1:
        raise ValueError(f"vdsr ch={ch} too narrow to carry the output")

    def pack(act, carry, chroma):
        fill = C - act.shape[0] - 1 - n_chroma
        parts = [act.to(torch.float32)]
        if fill:
            parts.append(torch.zeros((fill, dst_h, dst_w), dtype=torch.float32,
                                     device=device))
        parts.append(carry[None])
        if n_chroma:
            parts.append(chroma)
        return torch.cat(parts, dim=0)

    def carry_of(state):
        return state[C - 1 - n_chroma]

    def chroma_of(state):
        return state[C - n_chroma:] if n_chroma else state[:0]

    def a_resize(state, frame):
        y_r, chroma = _resized(frame, d, dst_h, dst_w, y_filter, c_filter)
        return pack(y_r[None], y_r, chroma)

    def a_in(state, frame):
        h = torch.relu(conv_same(state[:1][None], params["in_w"], "exact",
                                 params["in_b"]))
        return pack(h[0], carry_of(state), chroma_of(state))

    def a_mid(l):
        def atom(state, frame):
            h = torch.relu(conv_same(state[:ch][None], params["mid_w"][l], "exact",
                                     params["mid_b"][l]))
            return pack(h[0], carry_of(state), chroma_of(state))

        return atom

    def a_out(state, frame):
        res = conv_same(state[:ch][None], params["out_w"], "exact", params["out_b"])[:, 0]
        y_sr = torch.clamp(carry_of(state)[None] + res, 0.0, 255.0)[0]
        return pack(_final(y_sr, chroma_of(state) if n_chroma else None),
                    carry_of(state), chroma_of(state))

    return [a_resize, a_in] + [a_mid(l) for l in range(spec.depth - 2)] + [a_out]


def _channels(model: str, spec, n_chroma: int) -> int:
    """C, the packed state's channel count (see the atoms)."""
    if model == "srcnn":
        return 64 + n_chroma
    if model == "srcnn955":
        return spec.n1 + n_chroma
    return spec.ch + 1 + n_chroma


def _balanced_groups(n_atoms: int, n_stages: int):
    """Contiguous split of atom indices into n_stages non-empty groups with
    the conv work balanced: atom 0 (the resize) is cheap, so it rides with
    the first group; the n_atoms - 1 convs split evenly."""
    convs = n_atoms - 1
    base, extra = divmod(convs, n_stages)
    groups, k = [], 1
    for s in range(n_stages):
        take = base + (1 if s < extra else 0)
        g = tuple(range(k, k + take))
        if s == 0:
            g = (0,) + g
        groups.append(g)
        k += take
    return tuple(groups)


def upscale_pipelined(frames, params, multiply: float, cfg: SRCNNConfig,
                      mesh: Mesh, axis: str = "stage"):
    """Upscale a clip with the stack pipelined across ``mesh.shape[axis]``
    devices (the devices at the other axes' index 0).

    Args:
      frames: [N, H, W, D] u8 frames of one geometry.
      params: ``cfg.model``'s parameters (None: the shipped ones).
      multiply: scale factor, as :func:`libsrcnn_tpu_torch.upscale` takes it.
      cfg: model ``"srcnn"`` or ``"srcnn955"`` (4 atoms, 2 to 4 stages) or
        ``"vdsr"`` (depth + 1 atoms, any 2 to depth + 1 stages, the
        residual's identity path carried in a reserved channel), at
        ``float32``.  The LR families' learned heads are single fused
        stages with nothing to pipeline: use ``sharding.upscale_batch``.
      mesh: mesh whose ``axis`` axis carries the stages.

    Returns:
      host numpy ([N, H', W', D] u8 frames, [N, H', W'] u8 conv maps), equal
      bit for bit to ``api.upscale(..., use_kernel=False)`` per frame.  On a
      mesh that spans processes every rank passes the same clip, runs the
      stages it owns, and the last stage's rank returns the frames; every
      other rank returns None.
    """
    from .. import serve

    if cfg.self_ensemble:
        raise ValueError("self_ensemble is not implemented for the "
                         "stage-pipelined path; ensemble per frame via "
                         "api.upscale")
    if cfg.step_scale:
        raise ValueError(
            "step_scale is not supported by the stage-pipelined path (it runs "
            "one direct pass; skipping the chained-x2 u8 round trips would "
            "break bit-identity with api.upscale) -- chain upscale_pipelined "
            "calls per x2 pass instead")
    n_stages = mesh.size(axis)
    if cfg.model in ("srcnn", "srcnn955"):
        if n_stages not in _GROUPINGS:
            raise ValueError(
                f"pipeline depth {n_stages} unsupported (axis {axis!r}); "
                f"use {sorted(_GROUPINGS)} stages for {cfg.model}")
    elif cfg.model == "vdsr":
        if n_stages < 2:
            raise ValueError(f"need >= 2 stages, got {n_stages}")
    else:
        raise ValueError(
            "pipeline-stage parallelism applies to the srcnn/srcnn955/vdsr "
            f"stacks; model {cfg.model!r} has a fused learned-upscale head "
            "(use sharding.upscale_batch)")
    if cfg.compute_dtype != "float32":
        raise ValueError(
            "the stage-pipelined path runs exact f32 only (its atoms carry f32 "
            "and would diverge from upscale() under "
            f"compute_dtype={cfg.compute_dtype!r}); use per-frame api.upscale "
            "or sharding.upscale_batch for the other tiers")
    clip = serve._as_u8_clip(frames)
    n, h, w, d = clip.shape
    dst_w, dst_h = resize.scaled_size(w, h, multiply)
    if dst_w <= 0 or dst_h <= 0:
        raise ValueError(f"bad scale {multiply} for {w}x{h}")
    devs = [mesh.device(**{axis: s}) for s in range(n_stages)]
    owner = [mesh.owner(**{axis: s}) for s in range(n_stages)]
    local = [o == mesh.rank for o in owner]
    if not any(local):
        return None
    prepared = [pipeline.prepare_model_params(
        cfg, api._params_on(params, cfg, dev, multiply), h, w, dst_h, dst_w,
        multiply) if mine else None for dev, mine in zip(devs, local)]
    spec = next(p for p in prepared if p is not None)[1]
    if cfg.model == "vdsr" and n_stages > spec.depth + 1:
        raise ValueError(f"{n_stages} stages exceed the {spec.depth + 1} vdsr atoms")

    y_filter = FilterType(cfg.filter)
    c_filter = chroma_filter(y_filter)
    if cfg.model == "vdsr":
        groups = _balanced_groups(spec.depth + 1, n_stages)
        build = functools.partial(_atoms_vdsr, spec=spec)
    else:
        groups = _GROUPINGS[n_stages]
        build = (_atoms if cfg.model == "srcnn"
                 else functools.partial(_atoms_generic, spec=spec))
    atoms = [build(p[0], d=d, dst_h=dst_h, dst_w=dst_w, y_filter=y_filter,
                   c_filter=c_filter, n_chroma=d - 1, device=dev) if p else None
             for p, dev in zip(prepared, devs)]
    C = _channels(cfg.model, spec, d - 1)

    def stage(s, state, frame):
        for a in groups[s]:
            state = atoms[s][a](state, frame)
        return state

    # only stage 0's resize atom reads the frames
    clip_t = torch.from_numpy(np.ascontiguousarray(clip)).to(devs[0]) if local[0] else None
    bufs = [None] * n_stages          # the state each stage reads this step
    results = []
    for t in range(n + n_stages - 1):
        outs = [None] * n_stages
        for s in range(n_stages):
            f = t - s
            if 0 <= f < n and local[s]:
                outs[s] = stage(s, bufs[s], clip_t[f] if s == 0 else None)
        if outs[-1] is not None:
            results.append(outs[-1][:d + 1])
        # hand each buffer down the chain (to another rank in step order, the
        # tag its stage); stage 0 reads fresh frames
        bufs = [None] * n_stages
        ops, into = [], []
        for s in range(n_stages - 1):
            if not 0 <= t - s < n or not (local[s] or local[s + 1]):
                continue
            if local[s] and local[s + 1]:
                bufs[s + 1] = outs[s].to(devs[s + 1])
            elif local[s]:
                ops.append(("send", outs[s], owner[s + 1], s))
            else:
                # the received state's shape, dtype and device (no storage)
                like = torch.empty((), device=devs[s + 1]).expand(C, dst_h, dst_w)
                ops.append(("recv", like, owner[s], s))
                into.append(s + 1)
        for s, buf in zip(into, distributed.p2p(ops)):
            bufs[s] = buf
    if not local[-1]:
        return None
    final = torch.stack([r.cpu() for r in results])          # [N, d+1, H', W']
    out_u8 = final[:, :d].permute(0, 2, 3, 1).to(torch.uint8).numpy()
    conv_u8 = final[:, d].to(torch.uint8).numpy()
    return out_u8, conv_u8
