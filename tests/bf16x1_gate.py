"""The gate that holds K3's arithmetic to its plain version pixel by pixel.

K3 (the ``bfloat16_fast`` tier, ``kernels/csrc/fused_srcnn_bf16.cu``) and
its plain version, ``fused_conv.forward_y_reference(...,
precision="bf16x1")``, compute one function: the window, h1 and c2 each
rounded to bf16 once, the weights too, the sums in f32.  They sum in other
orders (the tensor cores k16 block by k16 block, cuDNN or oneDNN in
theirs), and an f32 sum taken in another order can land on the other side
of a bf16 rounding midpoint.  Such a flip moves the output by one bf16 ulp
of h1 or c2 times the weights downstream: up to ~1 on noise, where a pixel
with no rounding near a midpoint moves by ~1e-4.  A statistic over the
plane (a p99.9 of the error) cannot tell a flip from a fault; this gate
bounds each pixel.

:func:`flip_bound` computes, in float64 on the plane's device, the change
that any sound sum order can cause at each output pixel:

* every pre-activation ``pre`` of conv1 lies within ``e = WINDOW * U * S``
  of its exact value in any sound order, and of its value in any other
  sound order, ``S`` being its sum of term magnitudes plus ``|bias|``;
* so each order's bf16(relu(pre)) lies in ``[rb(relu(pre - e)),
  rb(relu(pre + e))]`` (``rb`` is ``srcnn.round_bf16``), whose width
  ``dh1`` bounds the gap between two orders' h1: 0 where no bf16 midpoint
  and no ReLU kink lies within ``e``, one bf16 ulp where one midpoint
  does.  Such an entry is *ambiguous*;
* conv2's pre-activation moves by what h1's roundings allow,
  ``sum_c dh1_c |w2|``, on top of its own slack: that is its ``e``, and
  ``dc2`` follows by the same rule;
* the output moves by at most ``sum dc2 |w3|`` over its 5x5 window, c2
  gathered through the ring clamp exactly as the plain version gathers it
  (``fused_conv._ring_index``), plus ``WINDOW * U * S3``, its own sum's
  slack.

The gate (:func:`judge`) is ``|got - plain| <= bound`` at every pixel,
plus ``|got - plain| <= MAX_ABS``.  :class:`Bounds` also carries the bound
of each stage cut of K3 (``kernels/ablation.py``), which writes per output
pixel the sum of the 64 h1 channels (``conv1``) or of the 32 c2 channels
(``conv2``) before rounding, or of the 25 taps (``taps``), at the pixel's
own ring position; ``load`` writes the rounded centre tap, which both sides
round alike, so its bound is 0.

:data:`WINDOW` is measured, not derived.  On the CPU, with the shipped
weights, the largest gap ``|pre_a - pre_b| / (U * S)`` between two of the
sound orders (the plain f32 conv, K3's k16 emulator, f64 sums and a
sequential f32 sum), each stage fed the same input, is 3.11 at h1 (a
plane of the kernel fuzz, ``tests/test_fuzz.py``), 3.84 at c2 (a 256^2
plane of ``chip_smoke.py``'s smooth recipe; 3.75 on the 130 x 250 smooth
plane of ``tests/test_torch_cuda.py``) and 2.36 at the output, over the
fuzz planes, two 256^2 noise planes and those smooth planes; on
chip_smoke's recipe at 512^2 and 1024^2, c2 reads 4.14 and 4.08
(``python tests/test_torch_bf16x1_gate.py`` prints them all).  h1 alone
would allow 5; c2's plain 64-term sum sits further from the k16 order on
smooth planes, where few h1 channels are zero, so ``WINDOW = 7``: 1.82x
the test planes' largest gap (``tests/test_torch_bf16x1_gate.py`` holds it
at 1.5x or more) and 1.69x the 512^2 plane's.

This module imports no jax: ``tests/test_torch_cuda.py``,
``tests/test_torch_fuzz.py`` and ``tests/test_torch_bf16x1_wgmma.py``
import it and ``chip_smoke.py`` loads it by path.
"""

from __future__ import annotations

import dataclasses

import torch

from libsrcnn_tpu_torch.kernels import ablation, fused_conv
from libsrcnn_tpu_torch.models import srcnn

#: f32's unit roundoff
U = 2.0 ** -24
#: a sum's slack in units of U times its sum of term magnitudes (module
#: docstring: the largest gap measured is 4.14, at c2)
WINDOW = 7.0
#: the largest |got - plain| at any pixel, whatever its bound
MAX_ABS = 2.0
#: the bound above which a pixel counts as one where flips can happen, in
#: the share that :class:`Verdict` reports (the old p99.9 gate's 0.05)
WIDE = 0.05
#: f64 values in one band's h1-sized tensors ([N, 64, rows, w + 4]); a
#: larger plane is computed in row bands, with the same result
BAND_VALUES = 1 << 25


@dataclasses.dataclass
class Bounds:
    """Per output pixel, [h, w] or [N, h, w] like the plane: the bound of
    the output (``out``), of each cut, and how many h1 and c2 entries
    under the pixel's 5x5 window (64 and 32 of each at 25 ring positions)
    are ambiguous."""
    out: torch.Tensor
    conv1: torch.Tensor
    conv2: torch.Tensor
    taps: torch.Tensor
    amb_h1: torch.Tensor
    amb_c2: torch.Tensor

    def stage(self, name: str) -> torch.Tensor:
        """The bound of K3's cut ``name`` (``full``: the output's)."""
        if name not in ablation.STAGES["K3"]:
            raise ValueError(f"no stage {name!r}; the stages are {ablation.STAGES['K3']}")
        if name == "load":
            return torch.zeros_like(self.out)
        return self.out if name == "full" else getattr(self, name)


def _rb(t: torch.Tensor) -> torch.Tensor:
    """bf16 of a float64 tensor's f32 value, back in float64."""
    return srcnn.round_bf16(t.float()).double()


def _width(pre: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The width of ``rb(relu(pre +- e))``: how far two orders' rounded
    activations can lie apart."""
    return _rb(torch.relu(pre + e)) - _rb(torch.relu(pre - e))


def _csum(t: torch.Tensor) -> torch.Tensor:
    """The sum over dim 1 in one fixed order (a reduction's order may
    depend on the shape, and a band's bounds must not)."""
    out = t[:, 0].clone()
    for ch in range(1, t.shape[1]):
        out.add_(t[:, ch])
    return out


def _weights(params: dict, dev) -> dict:
    def rb(k):
        return _rb(params[k].to(dev, torch.float64))

    w1, w2 = rb("w1").reshape(64, 81), rb("w2").reshape(32, 64)
    w3 = rb("w3").reshape(32, 25)
    b = {k: params[k].to(dev, torch.float64) for k in ("b1", "b2", "b3")}
    return {"w1": w1.t().reshape(81, 1, 64, 1, 1), "a1": w1.abs().t().reshape(81, 1, 64, 1, 1),
            "w2": w2.t().reshape(64, 1, 32, 1, 1), "a2": w2.abs().t().reshape(64, 1, 32, 1, 1),
            "a3": w3.abs().tolist(), "a3_taps": w3.abs().sum(1).tolist(),
            "b1": b["b1"].reshape(1, 64, 1, 1), "b2": b["b2"].reshape(1, 32, 1, 1),
            "b3": abs(float(b["b3"].reshape(-1)[0]))}


def _ring(wt: dict, x: torch.Tensor) -> dict:
    """conv1 and conv2 at the ring positions of the bf16 windows ``x`` [N,
    R + 8, C + 8] (f64): c2's rounded values and widths [N, 32, R, C], the
    ambiguous entries of h1 and c2 per position [N, R, C], and the conv1
    and conv2 cut bounds [N, R, C].  Every sum runs in one fixed order, so
    a position's values do not depend on R."""
    n, r, c = x.shape[0], x.shape[1] - 8, x.shape[2] - 8
    xa = x.abs()
    pre1 = wt["b1"].expand(n, 64, r, c).clone()
    s1 = wt["b1"].abs().expand(n, 64, r, c).clone()
    for k in range(81):
        dy, dx = divmod(k, 9)
        pre1.addcmul_(x[:, None, dy:dy + r, dx:dx + c], wt["w1"][k])
        s1.addcmul_(xa[:, None, dy:dy + r, dx:dx + c], wt["a1"][k])
    e1 = WINDOW * U * s1
    dh1 = _width(pre1, e1)
    h1 = _rb(torch.relu(pre1))
    cut1 = _csum(e1 * (pre1 > -e1)) + WINDOW * U * _csum(torch.relu(pre1 + e1))
    del pre1, s1, e1

    pre2 = wt["b2"].expand(n, 32, r, c).clone()
    e2 = wt["b2"].abs().expand(n, 32, r, c) * (WINDOW * U)
    for ch in range(64):
        pre2.addcmul_(h1[:, ch:ch + 1], wt["w2"][ch])
        e2 = e2 + (dh1[:, ch:ch + 1] + WINDOW * U * (h1[:, ch:ch + 1] + dh1[:, ch:ch + 1])
                   ) * wt["a2"][ch]
    dc2 = _width(pre2, e2)
    cut2 = _csum(e2 * (pre2 > -e2)) + WINDOW * U * _csum(torch.relu(pre2 + e2))
    return {"c2": _rb(torch.relu(pre2)), "dc2": dc2, "cut1": cut1, "cut2": cut2,
            "amb_h1": (dh1 > 0).sum(1), "amb_c2": (dc2 > 0).sum(1)}


def _box(t: torch.Tensor, rows: int, w: int, weights=None) -> torch.Tensor:
    """The 5x5 window sums [N, rows, w] of ``t`` [N, rows + 4, w + 4], each
    tap scaled by ``weights[tap]`` where given, in one fixed order."""
    out = torch.zeros(t.shape[:-2] + (rows, w), dtype=t.dtype, device=t.device)
    for k in range(25):
        dy, dx = divmod(k, 5)
        part = t[..., dy:dy + rows, dx:dx + w]
        out.add_(part if weights is None else part * weights[k])
    return out


def _band(wt: dict, xb: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
          r0: int, r1: int) -> dict:
    """The bounds of output rows r0 .. r1 - 1, from the c2 ring rows that
    ``rows`` (their ring-clamped source rows) name."""
    lo, hi = int(rows.min()), int(rows.max())
    st = _ring(wt, xb[:, lo:hi + 9])
    w = cols.numel() - 4
    nr = r1 - r0
    own = (slice(None), slice(r0 + 2 - lo, r1 + 2 - lo), slice(2, w + 2))

    def gather(t):
        return t.index_select(-2, rows - lo).index_select(-1, cols)

    c2, dc2 = st["c2"], st["dc2"]
    # each c2 entry's share of a sum over |w3|: its width plus the slack
    a3 = gather(dc2 + WINDOW * U * (c2 + dc2))
    out = torch.full((xb.shape[0], nr, w), WINDOW * U * wt["b3"], dtype=torch.float64,
                     device=xb.device)
    for ch in range(32):
        out.add_(_box(a3[:, ch], nr, w, wt["a3"][ch]))
    # the taps cut: the 25 taps' sums and then their sum, at own positions
    t3 = dc2 + 2 * WINDOW * U * (c2 + dc2)
    taps = torch.zeros_like(out)
    for ch in range(32):
        taps.add_(t3[own[0], ch, own[1], own[2]] * wt["a3_taps"][ch])
    return {"out": out, "conv1": st["cut1"][own], "conv2": st["cut2"][own], "taps": taps,
            "amb_h1": _box(gather(st["amb_h1"]), nr, w),
            "amb_c2": _box(gather(st["amb_c2"]), nr, w)}


def flip_bound(params: dict, y_padded: torch.Tensor, h: int, w: int, edge_flags=None,
               *, band_rows: int | None = None) -> Bounds:
    """The per-pixel bounds of K3 against its plain version on the halo
    plane ``y_padded`` [h + 12, w + 12] or [N, h + 12, w + 12] (the
    arguments of ``fused_conv.forward_y_reference``), in float64 on the
    plane's device.  ``band_rows`` output rows are computed at a time
    (default: as many as :data:`BAND_VALUES` allows); the result does not
    depend on it."""
    fused_conv._check_plane(y_padded, h, w)
    top, bottom, left, right = fused_conv._flags(edge_flags)
    squeeze = y_padded.dim() == 2
    y = y_padded[None] if squeeze else y_padded
    dev = y.device
    xb = _rb(y.double())
    wt = _weights(params, dev)
    ring_r = fused_conv._ring_index(h, top, bottom, dev)
    ring_c = fused_conv._ring_index(w, left, right, dev)
    if band_rows is None:
        band_rows = max(1, BAND_VALUES // (y.shape[0] * 64 * (w + 4)) - 4)
    parts = [_band(wt, xb, ring_r[r0:min(r0 + band_rows, h) + 4], ring_c, r0,
                   min(r0 + band_rows, h)) for r0 in range(0, h, band_rows)]
    fields = {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}
    if squeeze:
        fields = {k: v[0] for k, v in fields.items()}
    return Bounds(**fields)


@dataclasses.dataclass
class Verdict:
    """One comparison's result: ``n_over`` pixels over their bound, the
    largest gap / bound (``ratio``), the worst pixel (``where``, its
    ``gap``, ``bound`` and ambiguous h1 / c2 entries), the largest gap
    (``max_abs``) and the share of pixels whose bound is above
    :data:`WIDE`."""
    ok: bool
    n_over: int
    ratio: float
    where: tuple
    gap: float
    bound: float
    amb_h1: int
    amb_c2: int
    max_abs: float
    wide_share: float
    pixels: int

    def __str__(self) -> str:
        return (f"{'within' if self.ok else 'MISSED'}: {self.n_over} of {self.pixels} "
                f"pixels over their bound; worst gap / bound {self.ratio:.4g} at "
                f"{self.where} (gap {self.gap:.4g}, bound {self.bound:.4g}, ambiguous h1 "
                f"{self.amb_h1}, c2 {self.amb_c2}); max |diff| {self.max_abs:.4g} (limit "
                f"{MAX_ABS}); bound > {WIDE} on {100 * self.wide_share:.3g}% of pixels")


def judge(got: torch.Tensor, plain: torch.Tensor, bounds: Bounds, stage: str = "full",
          scale: float = 1.0) -> Verdict:
    """``got`` (K3's output or cut) against ``plain`` (its plain version)
    under ``bounds.stage(stage)``, at every pixel; the gaps, the bounds and
    :data:`MAX_ABS`'s test are on ``|got - plain| * scale``."""
    bound = bounds.stage(stage).to(got.device) * scale
    if got.shape != plain.shape or got.shape != bound.shape:
        raise ValueError(f"shapes differ: got {list(got.shape)}, plain "
                         f"{list(plain.shape)}, bound {list(bound.shape)}")
    gap = (got.double() - plain.double()).abs() * scale
    over = gap > bound
    ratio = torch.where(bound > 0, gap / bound.clamp_min(1e-300),
                        torch.where(gap > 0, torch.inf, 0.0))
    i = int(ratio.flatten().argmax())
    where = tuple(int(v) for v in torch.unravel_index(torch.tensor(i), gap.shape))
    max_abs = float(gap.max())
    return Verdict(ok=not bool(over.any()) and max_abs <= MAX_ABS, n_over=int(over.sum()),
                   ratio=float(ratio.flatten()[i]), where=where,
                   gap=float(gap.flatten()[i]), bound=float(bound.flatten()[i]),
                   amb_h1=int(bounds.amb_h1.flatten()[i]),
                   amb_c2=int(bounds.amb_c2.flatten()[i]), max_abs=max_abs,
                   wide_share=float((bound > WIDE).double().mean()), pixels=gap.numel())
