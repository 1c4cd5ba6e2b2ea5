"""The readings that a cell's limits are set from, at the cell's own size.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 3]

For each of ``--seeds`` it runs the program as a run of the cell does (set-up,
a window of ``--seconds``, the same reservoir of requests) and compares
the kept requests with the reference: the lower readings.  For each of
``--control-seeds`` it puts the control in the program's place and compares
as many requests as a run keeps: the upper readings.  The control is the configuration's
``control``: the reference computed one precision below the one the
configuration states (``{"kind": "reference", "precision": ...}``), or
the program with its own lower-precision path switched on (``{"kind":
"program", "tier": ...}``).  It prints one JSON line per seed and, last,
each number's largest lower and smallest upper reading.  It needs a
card, like a run of the cell, and is not part of one.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import bench, check, drive, spec  # noqa: E402


def control_call(cell: spec.Cell, params: dict, device: torch.device):
    """The control in the entry's place: what it returns for an input,
    in the entry's form (with a conv map only where the entry has one)."""
    ctl = cell.config["control"]
    if ctl["kind"] == "program":
        weights = bench.params_for(cell.config, 0, device, ctl["weights"])
        return bench.program_call(cell, weights, device, ctl["tier"])
    if ctl["kind"] != "reference":
        raise ValueError(f"unknown control {ctl['kind']!r}")
    batched = cell.traffic["inputs"] == "device"
    scale = float(cell.traffic["scale"])
    with_conv = spec.module("entries", cell.traffic["entry"]).CONV_MAP

    def call(x):
        out, conv = check.reference(cell.config, params, x, scale, batched, device,
                                    precision=ctl["precision"])
        if not batched:
            out, conv = out[0].cpu().numpy(), conv[0].cpu().numpy()
        return out, (conv if with_conv else None)

    return call


def readings(cell: spec.Cell, seed: int, seconds: float, device: torch.device,
             control: bool) -> dict:
    """The numbers of one seed, for the program or for the control."""
    params = bench.params_for(cell.config, seed, device)
    call = control_call(cell, params, device) if control else None
    params, plan, call = bench.prepare(cell, seed, device, call)
    res = drive.Reservoir(cell.traffic["sample"], seed)
    if control:
        # as many requests as a run compares, however long they take
        win = drive.run(call, plan, device, count=cell.traffic["sample"], reservoir=res)
    else:
        win = drive.run(call, plan, device, seconds=seconds, reservoir=res)
    numbers, sat = bench.check_sample(cell, plan, res.items, params, device)
    return dict(numbers, requests=len(win.done), saturation=sat)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        bench.log("needs a CUDA device")
        return 2
    cell = spec.load(args.workload)
    device = torch.device("cuda", 0)
    rows = {"program": [], "control": []}
    for side, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in (int(s) for s in seeds.split(",")):
            r = readings(cell, seed, args.seconds, device, side == "control")
            rows[side].append(r)
            print(json.dumps({"side": side, "seed": seed, **r}), flush=True)
    nums = [k for k in check.NUMBERS if k in rows["program"][0]]
    lower = {k: max(r[k] for r in rows["program"]) for k in nums}
    upper = {k: min(r[k] for r in rows["control"]) for k in nums}
    print(json.dumps({"workload": cell.name, "card": bench.card_sample(),
                      "lower": lower, "upper": upper,
                      "upper_over_lower": {k: (upper[k] / lower[k] if lower[k] else
                                               float(np.inf if upper[k] else np.nan))
                                           for k in nums}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
