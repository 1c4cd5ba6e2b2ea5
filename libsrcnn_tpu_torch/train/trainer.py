"""The training step, a minimal trainer loop and npz checkpoints (PyTorch
port of ``libsrcnn_tpu/train/trainer.py``).

A step is MSE on the Y channel in the [0, 255] domain through a model's
plain forward with its final clamp off, autograd, and one Adam update
(``torch.optim.Adam`` with optax's defaults).  The forward, the backward
and the update run with TF32 off in cuDNN and cuBLAS (``exact_f32``), so
the card computes in true f32 as the JAX package's CPU reference does,
and under cuDNN's deterministic algorithms with its autotuner off, so two
runs from one seed end on equal weights, as the JAX trainer's do.
The hand kernels have no backward and are never reached here.

The parameters live in an ``nn.ParameterDict`` of OIHW leaves on the
trainer's device.  Checkpoints keep the JAX package's layout (HWIO npz
plus ``step``, and any ``meta_*`` entries), so a checkpoint written by
either package loads in the other.

On a mesh (``parallel.make_mesh`` in one process, or
``parallel.distributed.global_mesh`` across processes) the step computes
the JAX package's sharded step (`libsrcnn_tpu/train/trainer.py:60-76`),
with the collectives GSPMD inserts there written out:

* **dp** -- the batch is cut over ``data``;
* **sp** -- the patch height is cut over ``row``.  Each position cuts its
  rows plus the model's receptive halo straight from the global batch,
  which every rank holds, the width padded by the halo
  (:func:`_rows_with_halo`): 6 px for the 9-1-5 (conv1's 4 and conv3's
  2), ``forward.halo_width`` for a family (vdsr's depth, the 9-5-5's 8,
  an LR family's LR radius).  The input is data, so nothing crosses
  positions for it, neither forward nor backward.  The forward on the
  extended rows re-imposes each layer's padding on the rows and columns
  past the image edge, however many there are (:mod:`..models.ring`), so
  any share height trains.  The price is compute: a share of h rows
  computes h + 2 halo, so a row cut pays only where shares are much
  taller than the halo (vdsr's 16 on the CLI's 32-row patches over row
  2 triples each share's rows);
* **tp** -- for the 9-1-5 only, as the JAX step applies
  :func:`param_shardings` only when ``forward`` is None: conv1's output
  filters and conv2's input filters are cut over ``col``; each ``col``
  shard runs conv1 on its filters and conv2 on its input filters, and the
  partial sums of conv2 are added in ``col`` order before its bias and
  ReLU: each shard adds the others' partials detached, so the backward of
  the sum is the identity into its own partial (Megatron's row-parallel
  layer).  Every ``col`` shard then runs the same conv3 on the same sums.
  A family's parameters stay whole on every position, and ``col`` repeats
  the same forward on each, as the JAX step's replicated parameters do.

Each mesh position holds its replica of the parameters (its ``col`` slice
of the split ones).  The loss is the global mean.  A parameter's gradient
is the sum, in (data, row) order, of the gradients the positions holding
its slice computed (the replicated ones' from ``col`` 0, since every
``col`` computes the same), and every replica of it takes that one sum, so
their Adam steps are identical and the replicas stay equal bit for bit.
In one process the partial sums and gradients move by ``.to``; across
processes by ``send`` / ``recv`` and ``all_gather_object``.
:func:`save_checkpoint_sharded` writes ``torch.distributed.checkpoint``
directories, each rank its shards (the counterpart of the JAX package's
orbax checkpoints, in torch's format).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models import espcn, fsrcnn, srcnn, srcnn_generic, vdsr
from ..models.ring import HaloForward, replicate_ring
from ..models.srcnn import exact_f32

#: the OIHW dim of each 9-1-5 parameter that tensor parallelism cuts
#: (`libsrcnn_tpu/train/trainer.py:43-57` in HWIO); None: replicated.  Only
#: the 9-1-5's step cuts (:func:`_cuts`): srcnn955 has the same keys
TP_DIMS = {"w1": 0, "b1": 0, "w2": 1, "b2": None, "w3": None, "b3": None}
#: the mesh axes of the sharded step: dp, sp, tp
MESH_AXES = ("data", "row", "col")
#: the 9-1-5's receptive halo: conv1's 4 px and conv3's 2
HALO_915 = 6

#: a family's first parameter key -> its module (``params_from_jax`` /
#: ``params_to_jax``); srcnn's 9-1-5 shares the generic family's keys
FAMILY_BY_KEY = {"w1": srcnn_generic, "in_w": vdsr, "feat_w": fsrcnn, "c1_w": espcn}


def _family(keys):
    for key, module in FAMILY_BY_KEY.items():
        if key in keys:
            return module
    raise ValueError(f"no model family has the parameters {sorted(keys)}")


def loss_fn(params, lr_y: torch.Tensor, hr_y: torch.Tensor,
            forward=None) -> torch.Tensor:
    """MSE on the Y channel in the [0, 255] domain, unclamped forward.

    ``forward(params, y, clamp=False)`` defaults to the 9-1-5 model's plain
    forward; a family's ``make_loss_forward(spec)`` trains the zoo."""
    if forward is None:
        forward = srcnn.forward_y
    pred = forward(params, lr_y, clamp=False)
    return torch.mean((pred - hr_y) ** 2)


def param_shardings(mesh, tp_axis: str = "col") -> dict:
    """For each 9-1-5 key, the OIHW dim split over ``tp_axis`` (None: the
    key is replicated): conv1's output filters and conv2's input filters."""
    mesh.size(tp_axis)          # the mesh has the axis
    return dict(TP_DIMS)


def _sizes(mesh) -> tuple[int, int, int]:
    return tuple(mesh.size(a) for a in MESH_AXES)


def _positions(mesh) -> list[tuple[int, int, int]]:
    """(data, row, col) of every mesh position, in C order (other axes at 0)."""
    D, R, C = _sizes(mesh)
    return [(d, r, c) for d in range(D) for r in range(R) for c in range(C)]


def _coords(p) -> dict:
    return dict(zip(MESH_AXES, p))


def _local_positions(mesh) -> list[tuple[int, int, int]]:
    return [p for p in _positions(mesh) if mesh.is_addressable(**_coords(p))]


def _cuts(mesh, forward) -> dict:
    """For each parameter tensor parallelism cuts on this mesh, its OIHW
    dim: :data:`TP_DIMS` for the 9-1-5's step (``forward`` None) with
    ``col`` > 1, else none (a family's parameters stay whole, as the JAX
    step applies ``param_shardings`` only when ``forward`` is None)."""
    if forward is not None or _sizes(mesh)[2] == 1:
        return {}
    return {k: d for k, d in TP_DIMS.items() if d is not None}


def _tp_slice(value: torch.Tensor, dim: int | None, c: int, n: int) -> torch.Tensor:
    if dim is None:
        return value
    size = value.shape[dim] // n
    return value.narrow(dim, c * size, size)


def shard_params(params: dict, mesh, forward=None) -> list[nn.ParameterDict]:
    """The replicas of ``params`` (OIHW) for this process's mesh positions,
    in C order: each an ``nn.ParameterDict`` on its position's device, with
    its ``col`` slice of the parameters :func:`param_shardings` splits when
    the step is the 9-1-5's (``forward`` None; a family's ``forward``
    keeps every parameter whole).  ``meta_*`` entries are left out."""
    C = _sizes(mesh)[2]
    cuts = _cuts(mesh, forward)
    for name, dim in cuts.items():
        if name in params and params[name].shape[dim] % C:
            raise ValueError(f"{name} {tuple(params[name].shape)}: dim {dim} does not "
                             f"divide by col {C}")
    return [nn.ParameterDict({
        k: nn.Parameter(_tp_slice(torch.as_tensor(v), cuts.get(k), p[2], C)
                        .to(mesh.device(**_coords(p)), torch.float32).clone())
        for k, v in params.items() if not k.startswith("meta_")})
        for p in _local_positions(mesh)]


def _col_partials(part: dict, mesh) -> dict:
    """For each (data, row) group, every ``col`` shard's conv2 partial sum,
    for each of this process's positions: ``{pos: [partial of col 0, ...]}``,
    its own with its graph, the others detached (the tp sum's backward is
    the identity into its own partial).  Partials on other ranks are
    received, in one global order: group, sending col, receiving rank."""
    from ..parallel import distributed

    D, R, C = _sizes(mesh)
    rank = mesh.rank
    ops, keys = [], []
    tag = 0
    for d in range(D):
        for r in range(R):
            owners = [mesh.owner(data=d, row=r, col=c) for c in range(C)]
            mine = [c for c in range(C) if owners[c] == rank]
            for c in range(C):
                for dst in sorted(set(owners) - {owners[c]}):
                    if owners[c] == rank:
                        ops.append(("send", part[(d, r, c)].detach(), dst, tag))
                    elif dst == rank:
                        ops.append(("recv", part[(d, r, mine[0])], owners[c], tag))
                        keys.append((d, r, c))
                    tag += 1
    received = dict(zip(keys, distributed.p2p(ops)))
    out = {}
    for (d, r, c), own in part.items():
        out[(d, r, c)] = [own if k == c else
                          (part[(d, r, k)].detach() if (d, r, k) in part
                           else received[(d, r, k)]).to(own.device)
                          for k in range(C)]
    return out


def _forward_915_mesh(replicas: dict, ext: dict, mesh) -> dict:
    """The 9-1-5 forward (clamp off) of each of this process's positions
    on its rows with :data:`HALO_915` of context (``{pos: ([b, h + 12, W +
    12], edges)}``, :func:`_rows_with_halo`), with the tp sum: ``{pos: [b,
    h, W] prediction}``.  conv1 reads the context replicated past the edge
    (``forward_y``'s ``edge_pad``); conv2's output has 2 px left, whose
    out-of-image rows and columns take its edge before conv3 reads them."""
    part = {p: srcnn._conv1x1(srcnn.conv1(replicas[p], x[:, None]), replicas[p]["w2"])
            for p, (x, _) in ext.items()}
    h2 = {}
    for p, partials in _col_partials(part, mesh).items():
        s = partials[0]
        for t in partials[1:]:
            s = s + t
        h2[p] = replicate_ring(torch.relu(s + srcnn._bias(replicas[p]["b2"])),
                               [max(0, e - 4) for e in ext[p][1]])
    return {p: srcnn.conv3(replicas[p], h, clamp=False) for p, h in h2.items()}


def _rows_with_halo(t: torch.Tensor, rows: slice, halo: int):
    """``rows`` of the [b, H, W] planes ``t`` with ``halo`` rows of context
    on each side and the width padded by ``halo``, all replicated past the
    image edge: -> ([b, h + 2 halo, W + 2 halo], the (top, bottom, left,
    right) counts of out-of-image rows / columns)."""
    H = t.shape[1]
    lo, hi = rows.start - halo, rows.stop + halo
    ext = t.index_select(1, torch.arange(lo, hi, device=t.device).clamp(0, H - 1))
    return (F.pad(ext, (halo, halo), mode="replicate"),
            (max(0, -lo), max(0, hi - H), halo, halo))


def _mesh_step(replicas: list, optimizer: torch.optim.Optimizer, batch,
               forward, mesh) -> torch.Tensor:
    """:func:`train_step` on a mesh (see the module's docstring)."""
    D, R, C = _sizes(mesh)
    if forward is not None and R > 1 and not isinstance(forward, HaloForward):
        raise ValueError("row > 1 cuts the patch height: a family's forward needs its "
                         "halo form (its make_loss_forward's HaloForward)")
    lr_y, hr_y = (torch.as_tensor(b, dtype=torch.float32) for b in batch)
    B, H, W = lr_y.shape
    if B % D or H % R:
        raise ValueError(f"batch {B}x{H}x{W} not divisible by data {D} x row {R}")
    bp = B // D
    local = _local_positions(mesh)
    if len(local) != len(replicas):
        raise ValueError(f"{len(replicas)} replicas for {len(local)} local mesh positions")
    reps = dict(zip(local, replicas))
    devs = {p: mesh.device(**_coords(p)) for p in local}
    cuts = _cuts(mesh, forward)

    def rows(t, p) -> tuple[slice, slice]:
        """Position p's (batch, row) slices of t (an LR family's hr is
        larger than its lr)."""
        d, r, _ = p
        hp = t.shape[1] // R
        return slice(d * bp, (d + 1) * bp), slice(r * hp, (r + 1) * hp)

    def share(t, p):
        b, h = rows(t, p)
        return t[b, h].to(devs[p])

    def with_halo(p, halo):
        """Position p's rows of lr_y with ``halo`` of context, on its device,
        and their edge counts."""
        b, h = rows(lr_y, p)
        ext, edges = _rows_with_halo(lr_y[b], h, halo)
        return ext.to(devs[p]), edges

    with exact_f32(torch.device(mesh.device_type)):
        optimizer.zero_grad(set_to_none=True)
        if forward is None:
            pred = _forward_915_mesh(reps, {p: with_halo(p, HALO_915) for p in local}, mesh)
        elif R == 1:
            pred = {p: forward(reps[p], share(lr_y, p), clamp=False) for p in local}
        else:
            pred = {p: forward.forward_halo(reps[p], *with_halo(p, forward.halo_width(reps[p])),
                                            clamp=False) for p in local}
        # each position's share of the global mean
        losses = {p: torch.sum((pred[p] - share(hr_y, p)) ** 2) / hr_y.numel()
                  for p in local}
        if local:
            first = devs[local[0]]
            sum(v.to(first) for v in losses.values()).backward()
        # every position's gradients and loss, gathered across processes
        names = list(replicas[0].keys()) if replicas else []
        got = {p: ({k: reps[p][k].grad.detach() for k in names}, losses[p].detach())
               for p in local}
        if mesh.multi_process:
            mine = {p: ({k: g.cpu() for k, g in gs.items()}, l.cpu())
                    for p, (gs, l) in got.items()}
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, mine)
            got = {p: v for part in every for p, v in part.items()} | got
        # one sum per (parameter, col slice, device), in (data, row) order,
        # handed to every replica of that slice
        sums = {}
        for p in local:
            for k in names:
                group = p[2] if k in cuts else 0
                key = (k, group, devs[p])
                if key not in sums:
                    grads = [got[(d, r, group)][0][k].to(devs[p])
                             for d in range(D) for r in range(R)]
                    sums[key] = grads[0]
                    for g in grads[1:]:
                        sums[key] = sums[key] + g
                reps[p][k].grad = sums[key]
        optimizer.step()
    loss = None
    for d in range(D):
        for r in range(R):
            v = got[(d, r, 0)][1].cpu()
            loss = v if loss is None else loss + v
    return loss


def train_step(params, optimizer: torch.optim.Optimizer, batch,
               forward=None, mesh=None) -> torch.Tensor:
    """One Adam step on ``params`` in place; ``batch`` is (lr_y, hr_y)
    [B, H, W] f32 tensors on the parameters' device.  Returns the loss
    before the update (detached).

    With ``mesh``: ``params`` is the list of this process's replicas
    (:func:`shard_params`), ``optimizer`` one optimizer over all of them,
    ``batch`` the GLOBAL batch (tensors or numpy on any device; every rank
    passes the same), cut over ``data`` (B) and ``row`` (H); the step
    runs dp, sp and tp as the module's docstring says, and returns the
    global loss on the host.  Every rank of a mesh that spans processes
    calls it together.  ``forward`` (a family's ``make_loss_forward``)
    trains on any such mesh: ``row`` cuts its rows with their halo,
    ``col`` repeats it on whole parameters (:func:`shard_params` with the
    same ``forward``)."""
    if mesh is not None:
        return _mesh_step(params, optimizer, batch, forward, mesh)
    lr_y, hr_y = batch
    with exact_f32(lr_y.device):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, lr_y, hr_y, forward)
        loss.backward()
        optimizer.step()
    return loss.detach()


def save_checkpoint(path: str, params, step: int = 0) -> None:
    """npz checkpoint in the JAX package's layout: the family's weights in
    HWIO, ``step``, and any ``meta_*`` entries of ``params`` as they are."""
    meta = {k: np.asarray(v) for k, v in params.items() if k.startswith("meta_")}
    np.savez(path, step=np.int64(step), **_family(params).params_to_jax(params), **meta)


def load_checkpoint(path: str, device: str | torch.device = "cuda"):
    """Inverse of :func:`save_checkpoint` for any family's checkpoint,
    either package's: -> (params, step), the weights f32 OIHW tensors on
    ``device`` (``"cuda"``, the default, raises without a card), the
    ``meta_*`` entries numpy arrays as stored."""
    from ..api import _device

    dev = _device(device)
    with np.load(path) as z:
        entries = {k: z[k] for k in z.files}
    params = {k: v.to(dev) for k, v in _family(entries).params_from_jax(entries).items()}
    params.update({k: v for k, v in entries.items() if k.startswith("meta_")})
    return params, int(entries["step"])


def save_checkpoint_sharded(directory: str, params: dict, step: int = 0) -> None:
    """A ``torch.distributed.checkpoint`` of ``params`` in ``directory/<step>``
    (the counterpart of the JAX package's orbax checkpoint, in torch's
    format; the npz of :func:`save_checkpoint` is the one both packages
    read).  ``params``: whole tensors, or a trainer's
    :meth:`Trainer.param_shards` (``"w1.<col>"`` keys for the slices tensor
    parallelism cuts).  In a process group every rank calls it together and
    writes its own shards; a key that several ranks hold is written once."""
    state = {k: v.detach() for k, v in params.items() if not k.startswith("meta_")}
    import torch.distributed.checkpoint as dcp

    dcp.save(state, checkpoint_id=os.path.join(directory, str(step)),
             no_dist=not dist.is_initialized())


def load_checkpoint_sharded(directory: str, step: int | None = None,
                            device: str | torch.device = "cuda"):
    """Inverse of :func:`save_checkpoint_sharded`: -> (params, step), whole
    f32 OIHW tensors on ``device`` (the ``col`` shards concatenated),
    ``step`` the latest in ``directory`` by default.  Each process reads
    alone."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader

    from ..api import _device

    dev = _device(device)
    if step is None:
        steps = [int(n) for n in os.listdir(directory) if n.isdigit()]
        if not steps:
            raise FileNotFoundError(f"no checkpoint step in {directory}")
        step = max(steps)
    path = os.path.join(directory, str(step))
    meta = FileSystemReader(path).read_metadata().state_dict_metadata
    state = {k: torch.empty(m.size, dtype=m.properties.dtype) for k, m in meta.items()}
    dcp.load(state, checkpoint_id=path, no_dist=True)
    whole, shards = {}, {}
    for k, v in state.items():
        name, _, c = k.partition(".")
        if c:
            shards.setdefault(name, {})[int(c)] = v
        else:
            whole[k] = v
    for name, parts in shards.items():
        whole[name] = torch.cat([parts[c] for c in sorted(parts)], TP_DIMS[name])
    return {k: v.to(dev) for k, v in whole.items()}, int(step)


class Trainer:
    """Minimal training driver: Adam, the step, a step count.

    Args:
      params: initial parameters, OIHW (a family's ``init_params``,
        ``load_params`` or ``params_from_jax``); ``meta_*`` entries are
        left out.  Default: :func:`..models.srcnn.init_params` from
        ``seed``.
      learning_rate: Adam's step size (b1 0.9, b2 0.999, eps 1e-8).
      mesh: a ``(data, row, col)`` mesh (single-process or global) to
        train on: each of this process's positions holds a replica
        (:func:`shard_params`) and :meth:`fit` runs the sharded step
        (:func:`train_step`); with a mesh that spans processes every rank
        feeds the same global batches.
      seed: seeds the default init's ``torch.Generator``.
      forward: the model's loss forward (see :func:`loss_fn`); on a mesh
        with ``row`` > 1 a family's ``make_loss_forward``, which carries
        the halo form the row cut runs.
      device: where the parameters live and the steps run; ``"cuda"``
        (default) raises without a card.  With a mesh, the mesh's device
        type (else ``ValueError``); the replicas live on its devices.
    """

    def __init__(self, params: dict | None = None, learning_rate: float = 1e-4,
                 mesh=None, seed: int = 0, forward=None,
                 device: str | torch.device = "cuda"):
        from ..api import _device

        if mesh is not None and mesh.device_type != torch.device(device).type:
            raise ValueError(f"device {str(device)!r} is not the mesh's device "
                             f"type {mesh.device_type!r}")
        self.device = _device(device)
        if params is None:
            params = srcnn.init_params(torch.Generator().manual_seed(seed))
        self.mesh = mesh
        if mesh is None:
            self._params = nn.ParameterDict({
                k: nn.Parameter(torch.as_tensor(v).to(self.device, torch.float32).clone())
                for k, v in params.items() if not k.startswith("meta_")})
            tensors = self._params.parameters()
        else:
            self.replicas = shard_params(params, mesh, forward)
            self._cuts = _cuts(mesh, forward)
            tensors = [t for rep in self.replicas for t in rep.parameters()]
        self.optimizer = torch.optim.Adam(tensors, lr=learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.forward = forward
        self.step = 0

    @property
    def params(self):
        """The parameters: the ``nn.ParameterDict``, or on a mesh the whole
        OIHW tensors (detached), assembled from the replicas' ``col`` slices
        (across processes every rank calls it together)."""
        if self.mesh is None:
            return self._params
        C = _sizes(self.mesh)[2]
        shards = self.param_shards()
        if self.mesh.multi_process:
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, {k: v.cpu() for k, v in shards.items()})
            shards = {k: v for part in every for k, v in part.items()} | shards
        dev = self.mesh.device(**_coords(_local_positions(self.mesh)[0]))
        return {k: torch.cat([shards[f"{k}.{c}"].to(dev) for c in range(C)], self._cuts[k])
                if k in self._cuts else shards[k].to(dev) for k in self.replicas[0]}

    def param_shards(self) -> dict:
        """This process's distinct parameter slices, for
        :func:`save_checkpoint_sharded`: ``"<name>.<col>"`` for a slice that
        tensor parallelism cuts, ``"<name>"`` for a whole one."""
        return self._shards(lambda v: v.detach())

    def _shards(self, get) -> dict:
        """``get`` of each of this process's distinct parameter slices, under
        :meth:`param_shards`' keys (``train.optim`` reads their gradients)."""
        if self.mesh is None:
            return {k: get(v) for k, v in self._params.items()}
        out = {}
        for (_, _, c), rep in zip(_local_positions(self.mesh), self.replicas):
            for k, v in rep.items():
                key = f"{k}.{c}" if k in self._cuts else k
                if key not in out:
                    out[key] = get(v)
        return out

    def fit(self, batches, log_every: int = 0) -> list[float]:
        """Run over an iterable of (lr_y, hr_y) numpy batches; returns the
        loss of each step."""
        losses = []
        for lr_y, hr_y in batches:
            if self.mesh is None:
                batch = (torch.as_tensor(lr_y, dtype=torch.float32).to(self.device),
                         torch.as_tensor(hr_y, dtype=torch.float32).to(self.device))
                loss = train_step(self.params, self.optimizer, batch, self.forward)
            else:
                loss = train_step(self.replicas, self.optimizer, (lr_y, hr_y),
                                  self.forward, self.mesh)
            self.step += 1
            losses.append(float(loss))
            if log_every and self.step % log_every == 0:
                print(f"step {self.step}: loss {losses[-1]:.4f}")
        return losses
