"""Where the int8 kernel K4's time goes: its stage cuts (K7), timed in turn.

Port of ``benchmarks/int8_ablation.py``, for the card:

    python -m libsrcnn_tpu_torch.tools.int8_ablation [size]

The same table as :mod:`.kernel_ablation` for K4 with the shipped int8
pack: load (the window quantized to int8 codes), conv1, conv2, taps, full,
then the production launch.  It needs a CUDA device and raises without
one.
"""

from __future__ import annotations

import argparse

from ..utils import profiling
from .kernel_ablation import ablate, report


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("size", type=int, nargs="?", default=2048)
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args(argv)
    rows = ablate("K4", args.size, runs=args.runs)
    print(report("K4", args.size, rows, profiling.card(), args.runs))
    return rows


if __name__ == "__main__":
    main()
