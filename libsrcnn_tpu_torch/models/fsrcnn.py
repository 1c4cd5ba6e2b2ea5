"""FSRCNN (Dong et al., ECCV 2016), an LR-domain family (PyTorch port of
``libsrcnn_tpu/models/fsrcnn.py``).

It runs its feature stack at LOW resolution and upscales at the end with a
learned transposed convolution: feature extraction 5x5 (d) -> shrink 1x1
(s) -> m mapping 3x3 (s) -> expand 1x1 (d) -> deconv k x k, stride =
scale, d -> 1.  PReLU activations (per-channel alpha), edge-replicate SAME
padding on the convs, the [0, 255] domain.  One checkpoint per integer
factor (x2, x3, x4), the port's own
``models/weights/fsrcnn_x{scale}.npz``.

The deconv runs as the JAX package runs it: its dense sub-pixel form
(:func:`_subpixel_plan`), one stride-1 L x L conv emitting the scale^2
sub-pixel phases, zero-padded asymmetrically ``(P, L-1-P)`` on each axis,
then the pixel shuffle.  A head whose kernel is smaller than its stride
(none ships) runs the transposed conv itself
(:func:`..ops.conv.conv_transpose_same`).

No hand kernel runs this family: its convs are :mod:`..ops.conv`'s at the
tier's precision.  Tensors are NCHW / OIHW.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv import conv, conv_same, conv_transpose_same
from .espcn import pixel_shuffle
from .ring import HaloForward, edge_counts, replicate_ring, zero_ring
from .srcnn import normal, tensors_from_jax, tensors_to_jax, to_float, weights_path


@dataclasses.dataclass(frozen=True)
class FSRCNNSpec:
    scale: int = 2
    d: int = 56   # feature dim
    s: int = 12   # shrink dim
    m: int = 4    # mapping depth

    @property
    def name(self) -> str:
        return f"fsrcnn-x{self.scale}-d{self.d}s{self.s}m{self.m}"


def default_spec() -> FSRCNNSpec:
    return FSRCNNSpec()


def param_keys(m: int) -> tuple[str, ...]:
    layers = ("feat", "shrink", *(f"map{i}" for i in range(m)), "expand")
    return (*(f"{n}_{p}" for n in layers for p in "wba"), "deconv_w", "deconv_b")


def spec_of(params: dict, scale: int = 2) -> FSRCNNSpec:
    """The FSRCNNSpec of OIHW parameters: d, s and m from their shapes and
    keys; the scale is not in them (``scale``)."""
    m = sum(1 for k in params if k.startswith("map") and k.endswith("_w"))
    return FSRCNNSpec(scale=scale, d=params["feat_w"].shape[0],
                      s=params["shrink_w"].shape[0], m=m)


def params_from_jax(np_params: dict) -> dict[str, torch.Tensor]:
    """The JAX package's params pytree (HWIO, ``deconv_w [k,k,d,1]``) ->
    f32 CPU tensors, OIHW (``deconv_w [1,d,k,k]``)."""
    m = sum(1 for k in np_params if k.startswith("map") and k.endswith("_w"))
    return tensors_from_jax(np_params, param_keys(m))


def params_to_jax(params: dict) -> dict[str, np.ndarray]:
    """OIHW tensors -> the JAX package's params pytree as numpy (HWIO,
    ``deconv_w [k,k,d,1]`` as the JAX package stores it)."""
    m = sum(1 for k in params if k.startswith("map") and k.endswith("_w"))
    return tensors_to_jax(params, param_keys(m))


def init_params(generator: torch.Generator, spec: FSRCNNSpec = FSRCNNSpec(),
                device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """He init for the PReLU net (std sqrt(2 / fan_in)), zero biases, every
    PReLU alpha at 0.25, the 9x9 deconv scaled by 0.1; OIHW (JAX
    ``fsrcnn.init_params``: the form, not its key's draws)."""
    def he(cout, cin, k):
        return normal(generator, (cout, cin, k, k), float(np.sqrt(2.0 / (k * k * cin))))

    def layer(name, w, n):
        return {f"{name}_w": w, f"{name}_b": torch.zeros(n),
                f"{name}_a": torch.full((n,), 0.25)}

    d, s_ = spec.d, spec.s
    params = {**layer("feat", he(d, 1, 5), d), **layer("shrink", he(s_, d, 1), s_),
              **layer("expand", he(d, s_, 1), d),
              "deconv_w": he(1, d, 9) * 0.1, "deconv_b": torch.zeros(1)}
    for i in range(spec.m):
        params.update(layer(f"map{i}", he(s_, s_, 3), s_))
    return {k: v.to(device) for k, v in params.items()}


@functools.lru_cache(maxsize=4)
def _load_npz(path: str):
    with np.load(path) as z:
        spec = FSRCNNSpec(scale=int(z["meta_scale"]), d=int(z["meta_d"]),
                          s=int(z["meta_s"]), m=int(z["meta_m"]))
        return {k: z[k] for k in param_keys(spec.m)}, spec


def load_params(scale: int = 2, path: str | None = None,
                device: str | torch.device = "cpu"):
    """The shipped x``scale`` checkpoint (or the one at ``path``) ->
    (params on ``device``, spec from the file's ``meta_*`` entries)."""
    if path is None:
        path = weights_path(f"fsrcnn_x{scale}.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no shipped FSRCNN weights for x{scale} ({path})")
    np_params, spec = _load_npz(path)
    return ({k: v.to(device) for k, v in params_from_jax(np_params).items()},
            spec)


def _prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, x * alpha.reshape(1, -1, 1, 1))


@functools.lru_cache(maxsize=8)
def _subpixel_plan(k: int, r: int):
    """Static scatter plan turning a stride-``r`` transposed-conv kernel
    [k,k] into a stride-1 kernel [L,L] with r*r output channels, whose
    conv + depth-to-space computes the SAME ``lax.conv_transpose``
    (`fsrcnn.py:114-141` of the JAX package, copied: it is pure Python).

    conv_transpose SAME is an lhs-dilated conv with top / left pad
    ``pa = k-1-(k-r)//2``; output residue d (mod r) only sees kernel taps
    ``i = i0 + r*t`` with ``i0 = (pa-d) % r``, each reading input offset
    ``(d+i0-pa)//r + t``: a plain stride-1 conv per residue class.
    Returns (L, P, [(channel, sy, sx, wy, wx)]) tap placements."""
    pa = k - 1 - (k - r) // 2
    subs = []
    for d in range(r):
        i0 = (pa - d) % r
        subs.append((i0, (d + i0 - pa) // r, (k - i0 + r - 1) // r))
    P = max(-o for _, o, _ in subs)
    L = max(P + o + t for _, o, t in subs)
    taps = []
    for dy, (iy, oy, ty) in enumerate(subs):
        for dx, (ix, ox, tx) in enumerate(subs):
            for t_y in range(ty):
                for t_x in range(tx):
                    taps.append((dy * r + dx, P + oy + t_y, P + ox + t_x,
                                 iy + r * t_y, ix + r * t_x))
    return L, P, tuple(taps)


def _deconv_subpixel(h: torch.Tensor, w: torch.Tensor, r: int,
                     precision: str) -> torch.Tensor:
    """[N,C,H,W] x OIHW [1,C,k,k] -> [N,H*r,W*r], equal to the JAX
    package's ``lax.conv_transpose(h, w, (r, r), "SAME")``: for k >= r the
    dense stride-1 conv of :func:`_subpixel_plan` on the ZERO-padded plane
    (``(P, L-1-P)`` on each axis), then the pixel shuffle; for k < r the
    transposed conv itself."""
    k, cin = w.shape[-1], w.shape[1]
    if k < r:
        return conv_transpose_same(h, w, r, precision)[:, 0]
    L, P, taps = _subpixel_plan(k, r)
    c, sy, sx, wy, wx = (torch.tensor(a, device=w.device) for a in zip(*taps))
    w2 = w.new_zeros(r * r, cin, L, L)
    w2[c, :, sy, sx] = w[0][:, wy, wx].t()
    up = conv(F.pad(h, (P, L - 1 - P, P, L - 1 - P), mode="constant"), w2, precision)
    return pixel_shuffle(up, r)


def lr_halo_width(spec: FSRCNNSpec = FSRCNNSpec(), params: dict | None = None) -> int:
    """LR-domain receptive radius of the whole stack: how many REAL
    neighbour LR rows a band needs on each side so that its cropped output
    rows equal the full frame's.  feat 5x5 -> 2, the m mapping convs -> m,
    and the sub-pixel deconv's L x L conv -> max(P, L-1-P); the 1x1 layers
    add nothing.  The deconv's kernel size comes from ``params`` when
    given (9 otherwise)."""
    k = 9 if params is None else params["deconv_w"].shape[-1]
    L, P, _ = _subpixel_plan(k, spec.scale)
    return 2 + spec.m + max(P, L - 1 - P)


def forward_lr(params: dict, lr_y: torch.Tensor, spec: FSRCNNSpec | None = None,
               *, clamp: bool = True, precision: str = "exact") -> torch.Tensor:
    """LR Y plane(s) [H, W] or [N, H, W] -> HR [.., scale*H, scale*W].
    ``precision``: ``"exact"`` or ``"bf16"`` (:mod:`..ops.conv`)."""
    spec = spec or spec_of(params)
    squeeze = lr_y.dim() == 2
    h = to_float((lr_y[None] if squeeze else lr_y)[:, None], params["feat_w"])
    for name in ("feat", "shrink", *(f"map{i}" for i in range(spec.m)), "expand"):
        h = _prelu(conv_same(h, params[f"{name}_w"], precision, params[f"{name}_b"]),
                   params[f"{name}_a"])
    out = _deconv_subpixel(h, params["deconv_w"], spec.scale, precision) + params["deconv_b"]
    if clamp:
        out = torch.clamp(out, 0.0, 255.0)
    return out[0] if squeeze else out


def forward_lr_halo(params: dict, ext: torch.Tensor, flags,
                    spec: FSRCNNSpec | None = None, *, halo: int | None = None,
                    clamp: bool = True, precision: str = "exact") -> torch.Tensor:
    """Halo-aware forward for the tiled mesh path
    (`libsrcnn_tpu/models/fsrcnn.py:293-333`): ``ext`` [E_h, E_w] (or
    [N, E_h, E_w]) is a shard's LR plane extended by ``halo`` pixels of
    context on every side; ``flags`` (top, bottom, left, right) mark its
    borders that are true image edges, where the ring lies outside the
    image and each layer's replicate padding is re-imposed before a
    spatial conv reads it (the JAX package's ``_edge_replicate``).  The
    deconv's padding is zeros, so its input ring is zeroed there instead
    (``_edge_zero``).  Returns the shard's own output tile [..,
    (E_h-2*halo)*r, (E_w-2*halo)*r], bit-identical to :func:`forward_lr`
    of the whole plane at those pixels, clamped to [0, 255] unless
    ``clamp`` is False."""
    spec = spec or spec_of(params)
    if halo is None:
        halo = lr_halo_width(spec, params)
    return _forward_ring(params, ext, edge_counts(flags, halo), spec, halo, clamp,
                         precision)


def _forward_ring(params: dict, ext: torch.Tensor, edges, spec: FSRCNNSpec, halo: int,
                  clamp: bool, precision: str) -> torch.Tensor:
    """:func:`forward_lr_halo` with ``edges`` counting each side's
    out-of-image rows / columns (fewer than ``halo`` on a training share
    whose context reaches partly past the image edge)."""
    r = spec.scale
    squeeze = ext.dim() == 2
    h = to_float((ext[None] if squeeze else ext)[:, None], params["feat_w"])
    h = replicate_ring(h, edges)
    for name in ("feat", "shrink", *(f"map{i}" for i in range(spec.m))):
        h = _prelu(conv_same(h, params[f"{name}_w"], precision, params[f"{name}_b"]),
                   params[f"{name}_a"])
        h = replicate_ring(h, edges)
    h = _prelu(conv_same(h, params["expand_w"], precision, params["expand_b"]),
               params["expand_a"])
    h = zero_ring(h, edges)
    out = _deconv_subpixel(h, params["deconv_w"], r, precision) + params["deconv_b"]
    c = halo * r
    out = out[:, c:out.shape[1] - c, c:out.shape[2] - c]
    if clamp:
        out = torch.clamp(out, 0.0, 255.0)
    return out[0] if squeeze else out


def make_loss_forward(spec: FSRCNNSpec) -> HaloForward:
    """Adapter for :func:`..train.trainer.loss_fn`: FSRCNN reads the raw LR
    plane, so its training pairs are (lr_y, hr_y) with hr ``spec.scale``
    times lr (:func:`make_lr_patch_batch`).  The deconv's gradient flows
    through the sub-pixel plan's scatter onto the true ``deconv_w``.  It
    carries :func:`forward_lr_halo`'s ring form as its halo form, in LR
    pixels."""
    def forward(params, lr_y, clamp=False):
        return forward_lr(params, lr_y, spec, clamp=clamp)

    def forward_halo(params, ext, edges, clamp=False):
        return _forward_ring(params, ext, edges, spec, lr_halo_width(spec, params),
                             clamp, "exact")

    return HaloForward(forward, lambda params: lr_halo_width(spec, params), forward_halo)


def make_lr_patch_batch(images, batch_size: int, patch: int = 16,
                        spec: FSRCNNSpec = FSRCNNSpec(), seed: int = 0,
                        filter_type=None, device: str | torch.device = "cuda"):
    """(lr [B,p,p], hr [B,s*p,s*p]) f32 numpy pairs: random HR crops of the
    u8 RGB ``images``, their Y planes, and the Y planes downscaled by the
    classical resampler on ``device`` (``"cuda"``, the default, raises
    without a card).  The crops are drawn from ``default_rng(seed)`` in the
    JAX package's order, so on the CPU the pairs equal its pairs."""
    from ..api import _device
    from ..config import FilterType
    from ..ops import color, resize

    dev = _device(device)
    if filter_type is None:
        filter_type = FilterType.BICUBIC
    rng = np.random.default_rng(seed)
    sp = patch * spec.scale
    lr = np.empty((batch_size, patch, patch), np.float32)
    hr = np.empty((batch_size, sp, sp), np.float32)
    for b in range(batch_size):
        img = images[rng.integers(len(images))]
        h, w = img.shape[:2]
        if h < sp or w < sp:
            raise ValueError(f"image {h}x{w} smaller than HR patch {sp}")
        r = rng.integers(h - sp + 1)
        c = rng.integers(w - sp + 1)
        crop = torch.from_numpy(np.ascontiguousarray(img[r:r + sp, c:c + sp])).to(dev)
        hr_y = color.rgb_to_ycbcr(crop)[0]
        lr[b] = resize.resize_plane(hr_y, patch, patch, filter_type).cpu().numpy()
        hr[b] = hr_y.cpu().numpy()
    return lr, hr
