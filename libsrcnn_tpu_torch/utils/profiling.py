"""Profiling and timing -- port of ``libsrcnn_tpu/utils/profiling.py``.

* :func:`trace` -- a ``torch.profiler`` run around a block, written as a
  Chrome trace file (view it in Perfetto or ``chrome://tracing``);
* :func:`span` -- a named range of the program (:data:`SPANS`) in any
  profiler run, and next to free without one;
* :data:`counts` -- the program's counters of copies and rebuilds, and
  :data:`launches` -- its hand-written kernels' launches, always on;
  :func:`counts_snapshot` reads both, :func:`launches_since` the launches
  between two readings;
* :class:`StageTimer` -- per-stage times: CUDA events on a CUDA device,
  the host clock on the CPU;
* :func:`median_ms` -- the median time of single calls, by StageTimer;
* :func:`card` -- the card's name and power limit, to print beside times.

The spans, in the order of a still request; a pass's spans nest in
``sr.pipeline.pass``, and a still's in ``sr.api.upscale``:

* ``sr.api.upscale``: one still request, the whole of ``api.upscale``;
* ``sr.api.params``: ``api._params_on``, the caller's parameters made
  ready on the device;
* ``sr.api.upload``, ``sr.api.download``: ``api``'s host <-> device
  copies (the still; the output and the conv map);
* ``sr.pipeline.pass``: ``pipeline.run_pass``, one pass of a frame or a
  clip;
* ``sr.color.split``: u8 RGB(A) -> planar f32 YCbCr;
* ``sr.resize``: one plane's resize (each chroma plane, the Y plane with
  its halo);
* ``sr.conv_stack``: the model on the Y plane, its weight pack included;
* ``sr.swinir.attn``, ``sr.swinir.mlp``, ``sr.swinir.conv`` (inside
  ``sr.conv_stack``, for ``models.swinir``): a Swin layer's attention
  (LN1, roll, partition, qkv, scores, bias, mask, softmax, AV, proj,
  reverse, roll back, residual add), its MLP (LN2, fc1, GELU, fc2,
  residual add), and the rest of the model (scaling, pad and crop, every
  3x3 conv with its residual, the whole-image LayerNorms, the bias gather,
  the head);
* ``sr.color.merge``: planar -> u8 RGB(A), and the conv map's u8 cast;
* ``sr.serve.upload``, ``sr.serve.download``: ``serve``'s host <-> device
  copies.

They are ``record_function`` ranges, on the profiler's clock with the
device's activity, so a kernel can be put down to the span that launched
it.  The counters (:data:`counts`):

* ``copy.h2d_bytes``, ``copy.d2h_bytes``: bytes of each host <-> card
  copy made under an upload or download span;
* ``kernels.packs``: weight packs for a fused kernel
  (``fused_conv.pack_params``, ``pack_int8_params``);
* ``resize.tables_built``: resize index / weight tables built (cache
  misses of ``ops.resize``);
* ``kernels.libs_loaded``: kernel libraries loaded (``kernels._build.library``
  misses);
* ``k1.ring_rows_computed``, ``k1.ring_rows_carried``: c2 ring rows of
  16 x 60 tiles that K1's GEMMs computed, and that a tile took from the
  tile above it instead (``kernels.fused_conv.k1_walk``, added at each K1
  launch);
* ``swinir.windows``: windows a SwinIR layer attended, summed over layers;
* ``swinir.masks_built``: SwinIR's relative-position index and shift mask
  built for a padded size and device (cache misses).
"""

from __future__ import annotations

import collections
import contextlib
import os
import subprocess
import time

import numpy as np
import torch

#: every span of the program, in the order of a still request
SPANS = ("sr.api.upscale", "sr.api.params", "sr.api.upload", "sr.pipeline.pass",
         "sr.color.split", "sr.resize", "sr.conv_stack", "sr.swinir.attn",
         "sr.swinir.mlp", "sr.swinir.conv", "sr.color.merge", "sr.api.download",
         "sr.serve.upload", "sr.serve.download")
#: what :func:`span` returns while no profiler runs
NO_SPAN = contextlib.nullcontext()
#: the program's counters (see the module's notes); a plain add at each
#: site, with no lock
counts = collections.Counter()
#: launches of the hand-written kernels in this process, by kernel (K6 and
#: K7 are the stage cuts of ``kernels.ablation``), each counted by
#: ``kernels._build.launch``
launches = collections.Counter(dict.fromkeys(
    ("K1", "K2", "K3", "K3h", "K3n", "K4", "K5", "K6", "K7", "resample", "color"), 0))


def span(name: str):
    """``with span("sr.resize"): ...``: a ``record_function`` range named
    ``name`` while a profiler runs, else :data:`NO_SPAN` (a check of one
    flag; an idle ``record_function`` costs twenty times more)."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return NO_SPAN


def counts_snapshot() -> collections.Counter:
    """A copy of :data:`counts`, with :data:`launches` as
    ``kernels.launch.<kernel>``."""
    snap = collections.Counter(counts)
    snap.update({f"kernels.launch.{k}": n for k, n in launches.items()})
    return snap


def launches_since(snapshot: collections.Counter) -> collections.Counter:
    """The launches made since ``snapshot``, an earlier
    :func:`counts_snapshot`, by kernel; a kernel that made none is left
    out."""
    return +collections.Counter({k: n - snapshot[f"kernels.launch.{k}"]
                                 for k, n in launches.items()})


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block: ``with trace("tb") as prof: run()``.  Records
    CPU ops, and CUDA kernels when a card is present; on exit writes
    ``<logdir>/trace.json``.  ``prof.key_averages()`` sums the events by
    name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StageTimer:
    """Per-stage times over iterations, in ms.

    On a CUDA device each stage is timed by CUDA events recorded on the
    current stream around the block (the device's time for the work the
    block queued); on the CPU by the host clock around the block.

    >>> t = StageTimer(torch.device("cuda"))
    >>> with t.stage("resize"):
    ...     out = resize(...)
    >>> print(t.report())
    """

    def __init__(self, device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"StageTimer times CPU or CUDA work, got {self.device}")
        self._events: dict[str, list] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.device.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record(torch.cuda.current_stream(self.device))
            try:
                yield
            finally:
                t1.record(torch.cuda.current_stream(self.device))
                self._events.setdefault(name, []).append((t0, t1))
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._events.setdefault(name, []).append(
                    1e3 * (time.perf_counter() - t0))

    @property
    def times(self) -> dict[str, list[float]]:
        """Stage -> its times in ms (waits for the device first)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            return {k: [a.elapsed_time(b) for a, b in v]
                    for k, v in self._events.items()}
        return {k: list(v) for k, v in self._events.items()}

    def report(self) -> str:
        clock = "CUDA events" if self.device.type == "cuda" else "host clock"
        return "\n".join(f"{name:20s} {float(np.median(ts)):8.3f} ms "
                         f"(median of {len(ts)}, {clock})"
                         for name, ts in self.times.items())


def card(device: torch.device | str = "cuda") -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them, for printing
    beside a time; the name alone where nvidia-smi cannot be run."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        res = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, check=True)
        return res.stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"


def median_ms(fn, device: torch.device | str = "cuda", runs: int = 10,
              warmup: int = 2) -> float:
    """Median ms of ``runs`` single calls of ``fn``, after ``warmup``
    calls, timed by :class:`StageTimer` on ``device``: CUDA events on its
    current stream, or the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    timer = StageTimer(device)
    for _ in range(runs):
        with timer.stage("call"):
            fn()
    return float(np.median(timer.times["call"]))
