"""The gate that holds a float32 training gradient to a float64 one.

The reference is the same loss's gradient in float64 on the CPU, taken
along the float32 forward's own ReLU / PReLU branches: each activation
takes the sign pattern that the float32 run recorded (``x`` where the
mask is set and 0 elsewhere for a ReLU, ``where(mask, x, a * x)`` for a
PReLU) instead of choosing its own.
A pre-activation within f32's rounding of zero may take the other branch
in f32, which moves a leaf's gradient by up to 5e-3 of its largest entry
(a vdsr ReLU flip) although the float32 arithmetic is sound; pinning the
branches takes that out of the comparison.

Two checks follow.

* **The guard** keeps the pinning from hiding a wrong forward: where the
  float32 branches differ from the plain float64 forward's own, the f64
  pre-activation must lie within :data:`FLIP_RTOL` of its activation's
  largest magnitude.
* **The limit per leaf**: each leaf's gap, the largest absolute
  difference over the reference leaf's largest entry, is held to
  ``min(LIMIT_CAP, max(GRAD_RTOL, ROUNDING * kappa))``.  ``kappa`` is the
  leaf's largest sum of term magnitudes over its largest entry, in f64
  along the pinned branches: for a conv weight
  ``conv2d_weight(|x|, w.shape, |g|).max() / |gw|.max()``, for a bias
  ``sum|g| / |sum g|`` over a channel's pixels, for a PReLU slope
  ``sum |g x|`` over the pixels below zero; a leaf consumed through a view
  or a scatter (vdsr's stacked ``mid_w``, fsrcnn's sub-pixel ``deconv_w``)
  collects its operands' sums through that view.  An f32 sum of such terms
  is off by about the terms' relative error times ``kappa``.  A leaf whose
  kappa was not recorded keeps :data:`GRAD_RTOL`.

The constants.  ``ROUNDING = 256 * 2**-24``: a bias sum over 16 x 32^2
pixels has about 14 levels of accumulation (log2 of its 16,384 terms),
and each term carries the rounding of the layers around it, for which a
factor of about 18 is allowed; 14 x 18 ~ 256 units of f32's 2**-24.
``LIMIT_CAP = 1e-3``: a batch sample left out of a leaf moves it by about
1/16 of its largest entry and a gradient scaled by 1 + 2e-3 is off by
2e-3, so both stay caught whatever a leaf's kappa.

This module imports no jax: ``tests/test_torch_determinism.py`` imports
it and ``chip_smoke.py`` loads it by path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from libsrcnn_tpu_torch.models import fsrcnn, srcnn
from libsrcnn_tpu_torch.models.srcnn import exact_f32
from libsrcnn_tpu_torch.ops import conv as ops_conv
from libsrcnn_tpu_torch.train import loss_fn

#: the least limit of a leaf's gap, over the reference leaf's largest entry
GRAD_RTOL = 1e-4
#: the largest limit of any leaf's gap (see the module docstring)
LIMIT_CAP = 1e-3
#: f32's unit roundoff times the accumulation allowance (module docstring)
ROUNDING = 256 * 2.0 ** -24
#: a pinned branch's f64 pre-activation over its activation's largest magnitude
FLIP_RTOL = 1e-4


def limit(kappa: float | None) -> float:
    """A leaf's limit for its gap, from its cancellation ``kappa``."""
    if kappa is None:
        return GRAD_RTOL
    return min(LIMIT_CAP, max(GRAD_RTOL, ROUNDING * kappa))


class _Tape:
    """A context in which the loss forward's ReLUs and PReLUs record the
    branch each pre-activation takes (in forward order), or take the
    branches of ``pins``; with ``sites``, every conv, bias and PReLU slope
    also records its operands and keeps its output's gradient, from which
    :meth:`term_sums` gives each leaf's sum of term magnitudes."""

    def __init__(self, pins: list | None = None, sites: bool = False):
        self.pins, self.sites = pins, sites
        self.masks: list[torch.Tensor] = []     # the branches taken, on the CPU
        self.pre: list[torch.Tensor] = []       # the pre-activations, f64 on the CPU
        self.records: list[tuple] = []          # (operand, term sums from the gradient)
        self.leaves: dict = {}

    # -- the activations ------------------------------------------------------

    def _branch(self, x: torch.Tensor, own: torch.Tensor) -> torch.Tensor:
        mask = own if self.pins is None else self.pins[len(self.masks)].to(x.device)
        if mask.shape != x.shape:
            raise ValueError(f"pinned branch {len(self.masks)} has shape "
                             f"{tuple(mask.shape)}, the activation {tuple(x.shape)}")
        self.masks.append(mask.detach().cpu())
        self.pre.append(x.detach().cpu().double())
        return mask

    def relu(self, x: torch.Tensor) -> torch.Tensor:
        mask = self._branch(x, x > 0)
        return self._saved[torch, "relu"](x) if self.pins is None else x.masked_fill(~mask, 0.0)

    def prelu(self, x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        mask = self._branch(x, x >= 0)
        if self.pins is None:
            out = self._saved[fsrcnn, "_prelu"](x, a)
        else:
            out = torch.where(mask, x, x * a.reshape(1, -1, 1, 1))
        if self.sites:
            out.retain_grad()
            self.records.append((a, lambda: (out.grad.abs() * x.detach().abs() * ~mask)
                                 .sum((0, 2, 3))))
        return out

    # -- the conv sites ---------------------------------------------------------

    def _record(self, out, x=None, w=None, bias=None, bias_shape=None):
        """Keep ``out``'s gradient; register the weight ``w`` read against
        ``x`` and the ``bias`` broadcast from ``bias_shape`` into ``out``."""
        out.retain_grad()
        if w is not None:
            xa = x.detach().abs()
            self.records.append((w, lambda: torch.nn.grad.conv2d_weight(
                xa, w.shape, out.grad.abs())))
        if bias is not None:
            shape = (1, -1, 1, 1) if bias_shape is None else bias_shape
            self.records.append((bias, lambda: out.grad.abs().sum_to_size(
                bias.reshape(shape).shape).reshape(bias.shape)))
        return out

    def conv(self, x, w, precision="exact", bias=None):
        return self._record(self._saved[ops_conv, "conv"](x, w, precision, bias), x, w, bias)

    def deconv(self, h, w, r, precision):
        out = self._saved[fsrcnn, "_deconv_subpixel"](h, w, r, precision)
        b = self.leaves["deconv_b"]
        return self._record(out, bias=b, bias_shape=b.shape)

    # the 9-1-5's exact layers (``models/srcnn.py`` conv1, conv2, conv3), each
    # conv recorded; the training forward runs only the exact precision
    @staticmethod
    def _exact(precision):
        if precision != "exact":
            raise ValueError(f"the tape records the exact 9-1-5 only, not {precision!r}")

    def conv1(self, params, x, precision="exact"):
        self._exact(precision)
        z = F.conv2d(x, params["w1"], params["b1"])
        return torch.relu(self._record(z, x, params["w1"], params["b1"]))

    def conv2(self, params, h1, precision="exact"):
        self._exact(precision)
        z = srcnn._conv1x1(h1, params["w2"]) + srcnn._bias(params["b2"])
        return torch.relu(self._record(z, h1, params["w2"], params["b2"]))

    def conv3(self, params, c2, precision="exact", clamp=True):
        self._exact(precision)
        z = self._record(F.conv2d(c2, params["w3"], params["b3"]), c2, params["w3"],
                         params["b3"])
        return torch.clamp(z[:, 0], 0.0, 255.0) if clamp else z[:, 0]

    # -- patching -----------------------------------------------------------------

    def __enter__(self):
        patches = {(torch, "relu"): self.relu, (fsrcnn, "_prelu"): self.prelu}
        if self.sites:
            patches.update({(ops_conv, "conv"): self.conv, (fsrcnn, "conv"): self.conv,
                            (fsrcnn, "_deconv_subpixel"): self.deconv,
                            (srcnn, "conv1"): self.conv1, (srcnn, "conv2"): self.conv2,
                            (srcnn, "conv3"): self.conv3})
        self._saved = {key: getattr(*key) for key in patches}
        for (module, name), value in patches.items():
            setattr(module, name, value)
        return self

    def __exit__(self, *exc):
        for (module, name), value in self._saved.items():
            setattr(module, name, value)

    def run(self, params, forward, batch, dev, dtype) -> dict:
        """The loss's gradient on ``dev`` in ``dtype`` (f64 on the CPU per
        leaf), every activation recorded or pinned."""
        self.leaves = {k: v.detach().to(dev, dtype).clone().requires_grad_()
                       for k, v in params.items()}
        with self, exact_f32(dev):
            loss = loss_fn(self.leaves, *(torch.from_numpy(b).to(dev, dtype)
                                          for b in batch), forward)
            loss.backward(retain_graph=self.sites)
        if self.pins is not None and len(self.masks) != len(self.pins):
            raise ValueError(f"{len(self.pins)} pinned branches for {len(self.masks)} "
                             "activations")
        return {k: v.grad.detach().cpu().double() for k, v in self.leaves.items()}

    def term_sums(self) -> dict:
        """Each leaf's sum of term magnitudes per entry, carried from every
        recorded operand back through the view or scatter it was read
        from (a leaf read twice sums both)."""
        keys = list(self.leaves)
        sums = {}
        for operand, terms in self.records:
            got = torch.autograd.grad(operand, [self.leaves[k] for k in keys],
                                      terms().detach(), retain_graph=True,
                                      allow_unused=True)
            for k, g in zip(keys, got):
                if g is not None:
                    sums[k] = sums[k] + g if k in sums else g
        return {k: v.detach().cpu() for k, v in sums.items()}


def gradient(params, forward, batch, dev, dtype=torch.float32) -> tuple[dict, list]:
    """The loss's gradient on ``dev`` in ``dtype`` (each leaf as f64 on the
    CPU) and the branch every ReLU / PReLU took, in forward order."""
    tape = _Tape()
    grads = tape.run(params, forward, batch, torch.device(dev), dtype)
    return grads, tape.masks


@dataclasses.dataclass
class Reference:
    """The float64 reference of one loss along one set of branches."""
    grad: dict                  # the f64 gradient along the pinned branches
    plain: dict                 # the plain f64 gradient (its own branches)
    kappa: dict                 # leaf -> cancellation, None where not recorded
    limit: dict                 # leaf -> the limit of its gap
    flips: int                  # pinned branches that differ from f64's own
    worst_flip: float           # the largest |x64| / max |x64| among them
    where_worst: tuple | None   # (activation, batch, channel, row, column)


def reference(params, forward, batch, masks: list) -> Reference:
    """The float64 reference on the CPU along ``masks`` (the float32 run's
    branches): the plain f64 gradient and its branches, the pinned f64
    gradient, each leaf's kappa and limit, and the guard's flips."""
    cpu = torch.device("cpu")
    own = _Tape()
    plain = own.run(params, forward, batch, cpu, torch.float64)
    pinned = _Tape(pins=masks, sites=True)
    grad = pinned.run(params, forward, batch, cpu, torch.float64)
    sums = pinned.term_sums()
    kappa = {k: (float(sums[k].max() / g.abs().max()) if k in sums and g.abs().max() > 0
                 else None) for k, g in grad.items()}
    flips, worst, where = 0, 0.0, None
    for i, (m, m64, x64) in enumerate(zip(masks, own.masks, own.pre)):
        differ = m.to(m64.device) != m64
        flips += int(differ.sum())
        if differ.any():
            rel = x64.abs() * differ / x64.abs().max()
            at = int(rel.argmax())
            if float(rel.flatten()[at]) >= worst:
                worst = float(rel.flatten()[at])
                where = (i, *(int(j) for j in np.unravel_index(at, rel.shape)))
    return Reference(grad, plain, kappa, {k: limit(v) for k, v in kappa.items()},
                     flips, worst, where)


def gaps(got: dict, want: dict) -> dict:
    """Per leaf: max |got - want| over the largest |want|."""
    return {k: float((got[k] - g).abs().max() / g.abs().max()) for k, g in want.items()}


def misses(grads: dict, ref: Reference) -> list[str]:
    """Every way ``grads`` fails the gate against ``ref`` (empty: it passes)."""
    out = []
    if ref.worst_flip > FLIP_RTOL:
        out.append(f"guard: {ref.flips} pinned branches differ from f64's own, the worst "
                   f"{ref.worst_flip:.3g} of its activation's largest magnitude at "
                   f"(activation, batch, channel, row, column) {ref.where_worst}")
    for k, v in gaps(grads, ref.grad).items():
        if not v <= ref.limit[k]:
            out.append(f"{k}: gap {v:.3g} over limit {ref.limit[k]:.3g} "
                       f"(kappa {ref.kappa[k]})")
    return out


def describe(grads: dict, ref: Reference) -> str:
    """Each leaf's gap, kappa and limit, and the pinned flips."""
    kap = {k: "-" if v is None else f"{v:.3g}" for k, v in ref.kappa.items()}
    return (", ".join(f"{k} {g:.3g} (kappa {kap[k]}, limit {ref.limit[k]:.3g})"
                      for k, g in gaps(grads, ref.grad).items())
            + f"; {ref.flips} pinned flips" + ("" if not ref.flips else
                 f", the worst {ref.worst_flip:.3g} of its activation's largest magnitude "
                 f"at (activation, batch, channel, row, column) {ref.where_worst}"))
