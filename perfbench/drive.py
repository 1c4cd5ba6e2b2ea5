"""The one general traffic generator: it reads a mix's data file
(``traffic/<mix>.json``) and sends its requests through the program's
entry in a closed loop.

Keys of a mix:

* ``entry``: the program's entry, ``entries/<entry>.py``;
* ``inputs``: ``"device"`` or ``"host"``, where the inputs are made to
  live in set-up; a request on the card is done when a CUDA event
  recorded after its call has passed, one on the host when the call
  returns;
* ``frames``: frames per request (a clip ``[frames, H, W, 3]``; 1 and
  ``"host"`` mean one still ``[H, W, 3]``);
* ``shapes``: the input sizes ``[H, W]``; ``scale``: the factor;
* ``pool``: distinct inputs made per shape, reused in turn;
* ``order``: ``"cycle"`` (shape by shape, input by input) or
  ``"shuffled_blocks"`` (every block of ``len(shapes)`` requests holds
  each shape once, in an order drawn from the seed, so every seed sends
  the same mix);
* ``in_flight``: requests enqueued before the oldest is waited for (one
  client);
* ``warm_requests``: requests sent in set-up, which must cover every
  shape;
* ``sample``: completed requests whose outputs are kept for the check,
  drawn from the seed over the whole window;
* ``trace_requests``: requests in the traced sub-window.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import random
import time

import numpy as np
import torch

from . import inputs


@dataclasses.dataclass
class Done:
    index: int
    key: tuple
    t_issue: float
    t_called: float
    t_done: float
    out_px: int


@dataclasses.dataclass
class Window:
    done: list
    t_start: float
    t_end: float

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start


class Plan:
    """A mix's inputs, made from the seed on ``device``, and its order."""

    def __init__(self, traffic: dict, seed: int, device: torch.device):
        self.traffic, self.seed = traffic, int(seed)
        self.shapes = [tuple(s) for s in traffic["shapes"]]
        self.scale = float(traffic["scale"])
        n = traffic["frames"]
        host = traffic["inputs"] == "host"
        if host and n != 1:
            raise ValueError("host inputs are stills: frames must be 1")
        self.pool = {}
        for si, (h, w) in enumerate(self.shapes):
            for pi in range(traffic["pool"]):
                x = inputs.frames(n, h, w, seed, 1000 * si + pi, device)
                self.pool[si, pi] = x[0].cpu().numpy() if host else x
        self._perms = {}

    def key(self, i: int) -> tuple:
        n_shapes, pool = len(self.shapes), self.traffic["pool"]
        block, pos = divmod(i, n_shapes)
        if self.traffic["order"] == "cycle":
            return pos, block % pool
        if self.traffic["order"] == "shuffled_blocks":
            if block not in self._perms:
                self._perms[block] = np.random.default_rng(
                    [self.seed, block]).permutation(n_shapes)
            return int(self._perms[block][pos]), block % pool
        raise ValueError(f"unknown order {self.traffic['order']!r}")

    def out_shape(self, key: tuple) -> tuple:
        h, w = self.shapes[key[0]]
        return (int(np.float32(h) * np.float32(self.scale)),
                int(np.float32(w) * np.float32(self.scale)))

    def out_px(self, key: tuple) -> int:
        oh, ow = self.out_shape(key)
        return self.traffic["frames"] * oh * ow


class Reservoir:
    """``k`` completed requests and their outputs, drawn uniformly from all
    that are offered by a generator seeded from the run's seed (reservoir
    sampling); a request that drops out releases its outputs."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, random.Random(int(seed) * 7919 + 1), 0, []

    def offer(self, done: Done, outputs: tuple) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((done, outputs))
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = (done, outputs)


def run(call, plan: Plan, device: torch.device, *, seconds: float | None = None,
        count: int | None = None, start: int = 0,
        reservoir: Reservoir | None = None, annotate: bool = False) -> Window:
    """Send requests ``start, start + 1, ...`` through ``call`` with
    ``in_flight`` of them enqueued, until ``seconds`` have passed since
    the first was sent or ``count`` were sent, then wait for the rest.
    Every request sent is waited for and returned.  ``annotate`` marks
    each call and each wait as a ``record_function`` range, for a traced
    sub-window."""
    span = (torch.profiler.record_function if annotate
            else lambda name: contextlib.nullcontext())
    in_flight = plan.traffic["in_flight"]
    on_card = device.type == "cuda" and plan.traffic["inputs"] == "device"
    pending, done = collections.deque(), []
    t_start = time.perf_counter()
    i = start
    while True:
        sending = (time.perf_counter() - t_start < seconds if seconds is not None
                   else i - start < count)
        if sending:
            key = plan.key(i)
            t_issue = time.perf_counter()
            with span("perfbench.call"):
                outputs = call(plan.pool[key])
            t_called = time.perf_counter()
            event = None
            if on_card:
                event = torch.cuda.Event()
                event.record()
            pending.append((i, key, t_issue, t_called, event, outputs))
            i += 1
            if len(pending) < in_flight:
                continue
        elif not pending:
            break
        j, key, t_issue, t_called, event, outputs = pending.popleft()
        if event is not None:
            with span("perfbench.wait"):
                event.synchronize()
        d = Done(j, key, t_issue, t_called, time.perf_counter(), plan.out_px(key))
        if reservoir is not None:
            reservoir.offer(d, outputs)
        del outputs
        done.append(d)
    return Window(done, t_start, done[-1].t_done if done else t_start)
