"""The check that decides ``correct``, driven on the CPU at a tiny size:
the program agrees with the plain reference within each cell's limits,
the control (the reference one precision down, or the program's int8
tier) fails them, and a run whose timed path is broken underneath comes
out not correct."""

import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench import bench, check, control, spec  # noqa: E402
from perfbench.reference import plain  # noqa: E402

CPU = torch.device("cpu")
CELLS = [w["name"] for w in spec.benchmark(ROOT)["workloads"]]
SEEDS = (3, 2 ** 31 + 17)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny(name: str) -> spec.Cell:
    """The cell with its traffic cut to a size the CPU runs in seconds."""
    cell = spec.load(name, ROOT)
    t = cell.traffic
    if t["inputs"] == "device":
        t.update(shapes=[[30, 44]], frames=3, pool=2, warm_requests=2, sample=2)
    else:
        t.update(shapes=[[20, 20], [16, 24], [24, 16], [20, 28]], warm_requests=8,
                 sample=3)
    return cell


def cell_of(name: str) -> spec.Cell:
    return spec.load(name, ROOT)


def run(cell: spec.Cell, seed: int, call=None) -> dict:
    return bench.run_cell(cell, seed, 0.3, False, CPU, time.perf_counter(), call)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_program_agrees_with_reference(name, seed):
    r = run(tiny(name), seed)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {m["name"] for m in cell_of(name).end_to_end}
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails(name, seed):
    """The reference computed one precision down (TF32 operands, emulated
    on the CPU), or the program's int8 tier, in the program's place."""
    cell = tiny(name)
    params = bench.params_for(cell.config, seed, CPU)
    r = run(cell, seed, control.control_call(cell, params, CPU))
    assert not r["correct"], r["checks"]


def test_bf16_conv_stack_fails_the_f32_cells():
    """A bf16-rounded conv stack in place of the f32 one fails the f32
    cells' comparison."""
    for name in ("srcnn915-f32.gpuclip-1080p", "vdsr20x64-f32.stills"):
        cell = tiny(name)
        params = bench.params_for(cell.config, 5, CPU)
        batched = cell.traffic["inputs"] == "device"

        def bf16(x, cell=cell, params=params, batched=batched):
            out, conv = check.reference(cell.config, params, x, cell.traffic["scale"],
                                        batched, CPU, precision="bf16")
            return (out, conv) if batched else (out[0].numpy(), None)

        assert not run(cell, 5, bf16)["correct"], name


def _program(cell, seed):
    return bench.program_call(cell, bench.params_for(cell.config, seed, CPU), CPU)


@pytest.mark.parametrize("name", [c for c in CELLS if "gpuclip" in c])
def test_half_the_clip_left_out_fails(name):
    """The second half of each clip's frames is not computed: the first
    half's outputs stand in for it."""
    cell = tiny(name)
    call = _program(cell, 7)

    def half(x):
        out, conv = call(x[: (x.shape[0] + 1) // 2])
        n = x.shape[0]
        idx = torch.arange(n) % out.shape[0]
        return out[idx], conv[idx]

    assert not run(cell, 7, half)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_fails(name):
    """Every answer is altered where it is produced: one frame's planes
    come out one level brighter."""
    cell = tiny(name)
    call = _program(cell, 9)

    def altered(x):
        out, conv = call(x)
        if isinstance(out, np.ndarray):
            return np.minimum(out, 254) + 1, conv
        out, conv = out.clone(), conv.clone()
        out[0] = out[0].clamp(max=254) + 1
        conv[0] = conv[0].clamp(max=254) + 1
        return out, conv

    assert not run(cell, 9, altered)["correct"]


def test_reference_resize_matches_table_sums():
    """A constant plane stays constant through both filters (the tables'
    weights sum to one) and the tables index inside the source."""
    plane = torch.full((1, 7, 9), 100.0)
    for kind in ("bicubic", "bilinear"):
        out = plain.resize(plane, 14, 18, kind)
        assert torch.allclose(out, plane.new_full(out.shape, 100.0), atol=1e-4)
    left, w = plain.contribution_table("bicubic", 14, 7)
    assert np.allclose(w.sum(1), 1.0) and left.min() >= 0


def test_tf32_emulation_rounds_to_ten_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0 - 2 ** -9])
    r = plain.round_tf32(x)
    assert r.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0 - 2 ** -9]
