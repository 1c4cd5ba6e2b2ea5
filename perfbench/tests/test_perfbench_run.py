"""``run.py`` as the command: without a card it prints no result and
fails; on a card (``-m cuda``) a short run of every cell is correct and
prints the result line the contract asks for."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RUN = [sys.executable, os.path.join("perfbench", "run.py")]
sys.path.insert(0, ROOT)

from perfbench import spec  # noqa: E402

CELLS = [w["name"] for w in spec.benchmark(ROOT)["workloads"]]


def _run(cwd, *args, env=None, timeout=600):
    return subprocess.run(RUN + list(args), cwd=cwd, capture_output=True, text=True,
                          timeout=timeout, env=env)


def test_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run(ROOT, "--workload", CELLS[0], "--seed", "2147483999", "--seconds", "1",
             "--trace", "0", env=env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails and prints nothing."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    r = _run(tmp_path, "--workload", CELLS[0], "--seed", "5", "--seconds", "1",
             "--trace", "0")
    assert r.returncode != 0
    assert r.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = _run(ROOT, "--workload", cell, "--seed", "2147483999", "--seconds", "2",
             "--trace", trace)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    want = spec.load(cell, ROOT)
    names = {m["name"] for m in (want.per_layer if trace == "1" else want.end_to_end)}
    assert set(line["metrics"]) == names
    if trace == "1":
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"]
        shares = [m for m in names if m.split(".")[0] in ("conv_roofline", "mfu")]
        assert shares
        for m in shares:
            assert 0 < line["metrics"][m]["value"] <= 100, m
