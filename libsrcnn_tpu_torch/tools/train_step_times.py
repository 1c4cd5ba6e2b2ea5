"""Time the port's training steps on the card: ms per step by CUDA events,
the median of 10 steps after 3 warm-up steps.

* the 9-1-5's step (Adam, TF32 off) at batch 16 x 32^2 (the CLI's) and
  128 x 33^2 (the SRCNN paper's), on device-resident batches of the
  goldens' butterfly, as ``train_step`` takes them;
* each training recipe's step at its published width and its own
  optimizer chain, batch 64 of a pool built from the butterfly: the
  recipe's own loop (``tools.train_*.run``), each step timed between
  the CUDA events that an optimizer step hook records after each update
  (the loop's batch draw, upload, step and loss read);
* the 9-1-5's step on the 2x2x2 mesh over ``["cuda:0"] * 8``.

Run from the root of a checkout:
    python -m libsrcnn_tpu_torch.tools.train_step_times
    python -m libsrcnn_tpu_torch.tools.train_step_times --against OTHER_CHECKOUT

``--against`` times another checkout of the repository in turns with
this one, each run in a process of its own that imports its checkout's
package: the other, this one, this one, the other.  Each process runs
this file by path with ``PYTHONPATH`` set to its checkout, so the other
checkout need not hold the script.  It prints each run and each side's
median over its runs.  Needs a CUDA card; prints the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

WARMUP, RUNS = 3, 10
#: rounds of the comparison, each the other checkout, this one, this one,
#: the other: host-bound steps move by tens of percent between processes
ROUNDS = 2
#: recipe -> (tool module, extra flags): the published widths (vdsr at its
#: recipe's depth 12 / 32 channels, the LR heads at x2), batch 64
RECIPES = {"fsrcnn": ("train_fsrcnn", []), "espcn": ("train_espcn", []),
           "vdsr": ("train_vdsr", ["--depth", "12", "--ch", "32"]),
           "srcnn955": ("train_srcnn955", [])}
RECIPE_ARGS = ["--pool", "256", "--batch", "64", "--corpus", "base"]


def _checkout() -> str:
    """The root of the checkout whose package this process imported."""
    import libsrcnn_tpu_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(libsrcnn_tpu_torch.__file__)))


def _median_ms(fn) -> float:
    """The median CUDA-event ms of :data:`RUNS` calls of ``fn`` after
    :data:`WARMUP` calls."""
    import numpy as np
    import torch

    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(RUNS):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


def _recipe_ms(name: str, img) -> float:
    """The recipe's median step: its own ``run`` for WARMUP + RUNS + 1
    steps on a pool of ``img``, a CUDA event recorded after each step's
    Adam update (torch's optimizer step hook, which the recipes' chains
    reach through ``torch.optim.Adam``), each step timed from one event to
    the next: the loop's batch draw, upload, step and loss read."""
    import importlib

    import numpy as np
    import torch
    from torch.optim.optimizer import register_optimizer_step_post_hook

    tool = importlib.import_module(f"libsrcnn_tpu_torch.tools.{RECIPES[name][0]}")
    parser = (tool.parser() if hasattr(tool, "parser") else
              importlib.import_module("libsrcnn_tpu_torch.tools.train_fsrcnn")
              .lr_parser("", name))
    n = WARMUP + RUNS + 1
    events = []

    def record(*_):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    hook = register_optimizer_step_post_hook(record)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            run = tool.run(parser.parse_args(RECIPE_ARGS + RECIPES[name][1] + [
                "--steps", str(n), "--eval-every", str(n), "--device", "cuda",
                "--out", os.path.join(tmp, f"{name}.npz")]), images=[img])
    finally:
        hook.remove()
    if len(events) != n or len(run.losses) != n:
        raise RuntimeError(f"{name}: {len(events)} optimizer steps, {len(run.losses)} losses")
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in
                            zip(events[WARMUP:-1], events[WARMUP + 1:])]))


def measure() -> dict:
    """Every step's median ms on this process's card and checkout, on the
    goldens of the checkout that holds this file."""
    import contextlib
    import io

    import numpy as np
    import torch

    from libsrcnn_tpu_torch.models import srcnn
    from libsrcnn_tpu_torch.parallel import make_mesh
    from libsrcnn_tpu_torch.train import Trainer, make_patch_batch, train_step

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the step times are the card's")
    here = os.path.dirname(os.path.abspath(__file__))
    with np.load(os.path.join(here, "..", "..", "tests", "goldens", "goldens.npz")) as z:
        img = np.ascontiguousarray(z["in_butterfly_full"])
    ms = {}
    init = srcnn.init_params(torch.Generator().manual_seed(0))
    for n, p in ((16, 32), (128, 33)):
        batch = tuple(torch.from_numpy(b).to("cuda") for b in
                      make_patch_batch([img], n, p, 2.0, seed=0, device="cpu"))
        t = Trainer(params=init, device="cuda")
        ms[f"9-1-5 {n}x{p}^2"] = _median_ms(lambda: train_step(t.params, t.optimizer, batch))
    for name in RECIPES:
        with contextlib.redirect_stdout(io.StringIO()):
            ms[f"recipe {name} 64"] = _recipe_ms(name, img)
    batch = tuple(torch.from_numpy(b).to("cuda") for b in
                  make_patch_batch([img], 16, 32, 2.0, seed=0, device="cpu"))
    mesh = make_mesh({"data": 2, "row": 2, "col": 2}, ["cuda:0"] * 8)
    t = Trainer(params=srcnn.load_params(), mesh=mesh, device="cuda")
    ms["9-1-5 16x32^2 2x2x2"] = _median_ms(
        lambda: train_step(t.replicas, t.optimizer, batch, None, mesh))
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True)
    return {"checkout": _checkout(), "card": power.stdout.strip().splitlines()[0],
            "ms": ms}


def compare(this: str, other: str) -> list[dict]:
    """Time ``other`` and ``this`` (checkout roots) in turns, each in its own
    process: :data:`ROUNDS` times other, this, this, other."""
    runs = []
    for root in (other, this, this, other) * ROUNDS:
        env = dict(os.environ, PYTHONPATH=root)
        out = subprocess.run([sys.executable, os.path.abspath(__file__)], env=env,
                             capture_output=True, text=True)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("STEP-TIMES ")]
        if out.returncode or len(lines) != 1:
            raise RuntimeError(f"timing {root}: rc {out.returncode}\n{out.stdout[-2000:]}"
                               f"\n{out.stderr[-4000:]}")
        got = json.loads(lines[0][len("STEP-TIMES "):])
        if os.path.realpath(got["checkout"]) != os.path.realpath(root):
            raise RuntimeError(f"timing {root} imported the package of {got['checkout']}")
        runs.append(dict(got, side="this" if root == this else "other"))
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another checkout, timed in turns with this one")
    args = ap.parse_args(argv)
    import numpy as np

    this = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if not args.against:
        print("STEP-TIMES " + json.dumps(measure()), flush=True)
        return 0
    runs = compare(this, os.path.abspath(args.against))
    for i, r in enumerate(runs):
        print(f"run {i}: {r['checkout']} on {r['card']}: " +
              ", ".join(f"{k} {v:.3f}" for k, v in r["ms"].items()))
    print(f"ms per step, median of {RUNS} after {WARMUP} warm-up steps; per side the "
          f"median and range of its {2 * ROUNDS} runs; {args.against} (other) against "
          f"{this} (this), on {runs[0]['card']}:")
    for k in runs[0]["ms"]:
        side = {name: [r["ms"][k] for r in runs if r["side"] == name]
                for name in ("other", "this")}
        med = {name: float(np.median(v)) for name, v in side.items()}
        print(f"  {k}: " + ", ".join(f"{name} {med[name]:.3f} [{min(v):.3f}-{max(v):.3f}]"
                                     for name, v in side.items())
              + f" ({med['this'] / med['other']:.3f}x)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
