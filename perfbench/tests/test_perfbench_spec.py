"""The benchmark's files: every configuration, cell, traffic mix and metric
is found by its name and parses; the work arithmetic; and no module of the
benchmark imports JAX or the JAX package (the reference: nothing of the
program either)."""

import ast
import json
import os
import re
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench import check, drive, spec, work  # noqa: E402

BENCH = spec.benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    c = spec.load(cell, ROOT)
    entry = spec.module("entries", c.traffic["entry"])
    assert callable(entry.make) and entry.CONV_MAP in (True, False)
    assert callable(spec.module("weights", c.config["weights"]["kind"]).load)
    assert os.path.isfile(os.path.join(ROOT, "perfbench", "reference",
                                       c.config["model"] + ".py"))
    assert c.limits["limits"], "a cell compares at least one number"
    assert set(c.limits["limits"]) <= set(check.NUMBERS)
    if not entry.CONV_MAP:
        assert set(c.limits["limits"]) == {"rgb_off"}, "no conv map to compare"
    assert c.traffic["warm_requests"] >= 2 * len(c.traffic["shapes"])
    small = dict(c.traffic, shapes=[[8, 8]] * len(c.traffic["shapes"]), pool=1)
    plan = drive.Plan(small, 2 ** 31 + 9, torch.device("cpu"))
    shapes = {plan.key(i)[0] for i in range(c.traffic["warm_requests"])}
    assert shapes == set(range(len(c.traffic["shapes"]))), "warm-up covers every shape"
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in e2e:
        assert m.split(".")[0] in ("out_mp_s", "req_ms_p95", "setup_s"), m
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, m["name"]


SUMMARY = {"host_call_s": [], "main_flops": 0, "main_s": 0.0, "peak_flops": 495e12,
           "out_px": 0, "window_s": 0.0, "busy_s": 0.0,
           "conv_device_s": 0.0, "ops_device_s": 0.0, "conv_least_s": 0.0}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    read = spec.reader(metric)
    assert read(dict(SUMMARY)) is None, "a reader that finds nothing returns nothing"


def test_metric_readers_read_their_share():
    s = dict(SUMMARY, host_call_s=[0.002, 0.004], main_flops=495e12 * 0.5, main_s=10.0,
             out_px=4_000_000, window_s=2.0, busy_s=1.5, conv_device_s=0.5,
             ops_device_s=1.0, conv_least_s=0.1)
    assert spec.reader("host_ms_per_req")(s) == pytest.approx(3.0)
    assert spec.reader("mfu")(s) == pytest.approx(5.0)
    assert spec.reader("mfu.stills")(s) == pytest.approx(5.0)
    assert spec.reader("conv_roofline")(s) == pytest.approx(20.0)
    assert spec.reader("ops_ms_per_mp")(s) == pytest.approx(250.0)
    assert spec.reader("idle_share")(s) == pytest.approx(25.0)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert entry["file"].startswith("perfbench/")
    for key in ("macs_per_out_px", "n_params", "halo"):
        assert isinstance(cfg[key], int) and cfg[key] >= 0, key
    assert cfg["n_params"] > cfg["macs_per_out_px"] > 0
    assert cfg["peak"] in work.peaks()["flops"]
    assert cfg["conv_kernels"]
    assert cfg["reduced"] == entry["reduced"]


def _config(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    with open(os.path.join(ROOT, entry["file"])) as f:
        return json.load(f)


def test_flop_arithmetic():
    """Each configuration's work, from its published widths: SRCNN
    2 * (81 * 64 + 64 * 32 + 25 * 32) = 16,064 FLOP per output pixel and
    VDSR 2 * (576 + 18 * 36,864 + 576) = 1,329,408; K1's least time at
    2048^2 is 4.194 MP * 16,064 / 495e12 = 0.136 ms."""
    for name in ("srcnn-915", "srcnn-915-bf16fast"):
        c = _config(name)
        macs = (c["f1"] ** 2 * c["channels"] * c["n1"] + c["f2"] ** 2 * c["n1"] * c["n2"]
                + c["f3"] ** 2 * c["n2"] * c["channels"])
        assert 2 * macs == 2 * c["macs_per_out_px"] == 16064
        assert c["n_params"] == macs + c["n1"] + c["n2"] + c["channels"] == 8129
        assert c["halo"] == c["f1"] // 2 + c["f3"] // 2
    v = _config("vdsr-20x64")
    k2, ch = v["kernel"] ** 2, v["ch"]
    macs = k2 * ch + (v["depth"] - 2) * k2 * ch * ch + k2 * ch
    assert 2 * macs == 2 * v["macs_per_out_px"] == 1329408
    assert v["n_params"] == macs + (v["depth"] - 1) * ch + 1
    srcnn = _config("srcnn-915")
    px = 2048 * 2048
    least = work.least_seconds(srcnn, work.flops(srcnn, px),
                               work.conv_bytes(srcnn, 1, 2048, 2048))
    assert least == pytest.approx(4.194304e6 * 16064 / 495e12)
    assert round(least * 1e3, 3) == 0.136


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub=""):
    base = os.path.join(ROOT, "perfbench", sub)
    return [os.path.join(d, f) for d, _, fs in os.walk(base) for f in fs if f.endswith(".py")]


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        found = _imports(path) & {"jax", "jaxlib", "flax", "libsrcnn_tpu"}
        assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_program():
    """The reference imports only the standard library, numpy and torch,
    and relative imports only inside ``reference/``."""
    for path in _sources("reference"):
        names = _imports(path)
        assert "libsrcnn_tpu_torch" not in names, path
        assert names <= {"__future__", "contextlib", "importlib", "math", "numpy",
                         "torch"}, (path, names)
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level == 1 and node.module in (None, "plain"), path


def test_forbidden_modules_compare_whole_names(monkeypatch):
    from perfbench import bench

    monkeypatch.setitem(sys.modules, "libsrcnn_tpu_torch_fake", object())
    assert "libsrcnn_tpu_torch_fake" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "libsrcnn_tpu.fake", object())
    assert "libsrcnn_tpu.fake" in bench.forbidden_modules()
