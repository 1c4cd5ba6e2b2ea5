"""What one cell is, read from ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Each sits in a file of its own, found by name:

* ``configs/<config>.json``: the model, its widths, its work per output
  pixel, tier, weights and the kernel-name patterns of its conv stack
  (the path is the config's ``file`` in ``BENCHMARK.json``);
* ``traffic/<traffic>.json``: the entry the window drives and the
  requests it sends (read by :mod:`.drive`);
* ``cells/<cell>.json``: the limits of the numbers that decide
  ``correct`` in that cell (read by :mod:`.check`);
* ``entries/<entry>.py``: a traffic's entry into the program, a function
  ``make(traffic, program_config, params, device)`` that returns
  ``call(x) -> (out, conv map or None)``;
* ``weights/<kind>.py``: a configuration's weights, a function
  ``load(weights, seed, device)`` of the config's ``weights`` entry;
* ``reference/<model>.py``: the plain reference of a model (read by
  :mod:`.reference.plain`);
* ``metrics/<metric>.py``: a per-layer metric's reader, a function
  ``read(summary)`` that returns a number or None.  A name with a
  suffix after a dot (``mfu.stills``) falls back to the reader of the
  part before it (``metrics/mfu.py``) when it has no file of its own.

A new cell, configuration, entry or metric adds files and entries;
nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``; KeyError if
    there is none."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; there are {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(os.path.join(root, configs[w["config"]]["file"])),
        traffic=_json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
        limits=_json(os.path.join(HERE, "cells", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def module(folder: str, name: str):
    """``<folder>/<name>.py`` under the benchmark, loaded by its path."""
    path = os.path.join(HERE, folder, name + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no {folder}/{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"perfbench_{folder}_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``, or of the reader
    of the name's part before its first dot."""
    base = metric.split(".")[0]
    own = os.path.isfile(os.path.join(HERE, "metrics", metric + ".py"))
    return module("metrics", metric if own else base).read
