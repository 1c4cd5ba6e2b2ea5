"""The readers of the program's spans and counters (``spans.py`` and its
metrics), on a synthetic Chrome trace and summary: a kernel is put down
to the innermost ``sr.*`` span through its launch's correlation, or
through the device's ``gpu_user_annotation`` ranges where its launch is
not in the trace; each new reader's value; and every accepted reader and
``DeviceTrace`` read what they read without the new keys and ranges."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench import spans, spec, tracing  # noqa: E402

HOST, DEV = (7, 7), (0, 3)


def _x(cat, name, ts, dur, where=HOST, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": where[0], "tid": where[1],
            "ts": ts, "dur": dur, "args": args}


def _events(with_spans=True):
    """A pass [0, 1000) us with a resize and a conv stack inside it;
    kernels and a copy launched inside and outside them, one from another
    thread, and two whose launch the trace lacks (a library with its own
    CUDA runtime)."""
    ev = [
        _x("cpu_op", "aten::mul", 110, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 150, 5, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 350, 5, correlation=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 600, 5, correlation=3),
        _x("cuda_driver", "cuLaunchKernel", 650, 5, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 150, 5, where=(7, 8), correlation=5),
        _x("kernel", "gather_kernel", 1200, 100, DEV, correlation=1),
        _x("kernel", "fused_srcnn_kernel", 1300, 400, DEV, correlation=2),
        _x("gpu_memcpy", "Memcpy DtoH", 1700, 50, DEV, correlation=3),
        _x("kernel", "mul_kernel", 1750, 10, DEV, correlation=4),
        _x("kernel", "other_thread", 1760, 10, DEV, correlation=5),
        _x("kernel", "wgmma_kernel", 1800, 60, DEV, correlation=99),
        _x("kernel", "late_kernel", 2000, 40, DEV, correlation=98),
    ]
    if with_spans:
        ev += [
            _x("user_annotation", "sr.pipeline.pass", 0, 1000),
            _x("user_annotation", "sr.resize", 100, 100),
            _x("user_annotation", "sr.conv_stack", 300, 200),
            _x("user_annotation", "perfbench.call", -10, 1020),
            _x("gpu_user_annotation", "sr.pipeline.pass", 1200, 700, DEV),
            _x("gpu_user_annotation", "sr.conv_stack", 1300, 580, DEV),
        ]
    return ev


def test_kernels_put_down_to_their_innermost_span():
    got = {name: span for _, name, _, _, span in spans.attribute(_events())}
    assert got == {
        "gather_kernel": "sr.resize",            # by correlation
        "fused_srcnn_kernel": "sr.conv_stack",
        "Memcpy DtoH": "sr.pipeline.pass",       # a copy, in the pass alone
        "mul_kernel": "sr.pipeline.pass",        # a driver-level launch
        "other_thread": None,                    # launched outside any range
        "wgmma_kernel": "sr.conv_stack",         # no launch: device side
        "late_kernel": None,                     # in no range at all
    }
    assert [a[2] for a in spans.attribute(_events())] == sorted(
        a[2] for a in spans.attribute(_events()))


def test_span_fields():
    f = spans.span_fields(_events())
    assert f["span_device_s"] == pytest.approx(
        {"sr.resize": 100e-6, "sr.conv_stack": 460e-6,
         "sr.pipeline.pass": 60e-6})
    assert f["span_kernels"] == {"sr.resize": 1, "sr.conv_stack": 2,
                                 "sr.pipeline.pass": 1}
    assert f["kernel_s"] == pytest.approx(620e-6)
    assert f["unattributed_kernel_s"] == pytest.approx(50e-6)


def test_a_program_without_spans_gives_nothing():
    f = spans.span_fields(_events(with_spans=False))
    assert f["span_device_s"] == {} and f["span_kernels"] == {}
    assert f["unattributed_kernel_s"] == pytest.approx(f["kernel_s"])


def test_device_trace_reads_the_same_with_the_spans(tmp_path):
    """The accepted ``DeviceTrace`` gives the same device seconds, busy
    time, window and top operations with the program's ranges in the
    trace; only the idle gaps' names change, to the spans."""
    reads = []
    for with_spans in (False, True):
        path = tmp_path / f"{with_spans}.json"
        path.write_text(json.dumps({"traceEvents": _events(with_spans)}))
        t = tracing.DeviceTrace.from_chrome(str(path))
        reads.append((t.seconds("kernel"), t.seconds("copy"), t.busy_s(),
                      t.window_s(), t.top_ops(), [d for _, d in t.idle_gaps()]))
    assert reads[0] == reads[1]


def test_idle_gaps_by_span(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    t = tracing.DeviceTrace.from_chrome(str(path))
    # two gaps, 1770-1800 and 1860-2000 us, fall after every host range
    assert t.idle_gaps() == spans.span_gaps(t) == [["no traced host op",
                                                    pytest.approx(170e-6)]]
    t.host.append(("sr.api.upscale", 1900.0, 200.0))
    t.host.append(("aten::mul", 1920.0, 20.0))
    assert spans.span_gaps(t)[0][0] == "sr.api.upscale"
    assert t.idle_gaps()[0][0] == "aten::mul"


SUMMARY = {"host_call_s": [0.002, 0.004], "main_flops": 495e12 * 0.5, "main_s": 10.0,
           "peak_flops": 495e12, "out_px": 4_000_000, "window_s": 2.0, "busy_s": 1.5,
           "conv_device_s": 0.5, "ops_device_s": 1.0, "conv_least_s": 0.1}
NEW_KEYS = {"span_device_s": {"sr.resize": 0.6, "sr.color.split": 0.1,
                              "sr.color.merge": 0.2, "sr.conv_stack": 0.6,
                              "sr.api.download": 0.05},
            "span_kernels": {"sr.resize": 400, "sr.conv_stack": 40,
                             "sr.color.split": 100, "sr.color.merge": 260},
            "kernel_s": 1.5, "unattributed_kernel_s": 0.0,
            "counts": {"copy.h2d_bytes": 750_000, "copy.d2h_bytes": 4_000_000,
                       "kernels.packs": 40, "kernels.launch.K1": 40},
            "main_requests": 40, "main_out_px": 1_000_000, "trace_requests": 8}


@pytest.mark.parametrize("metric,value", [
    ("resize_ms_per_mp", 150.0), ("color_ms_per_mp", 75.0),
    ("kernels_per_req", 100.0), ("kernels_per_req.stills", 100.0),
    ("copy_mb_per_mp.stills", 4.75), ("rebuilds_per_req", 1.0)])
def test_new_readers(metric, value):
    s = dict(SUMMARY, **NEW_KEYS)
    assert spec.reader(metric)(s) == pytest.approx(value)
    assert spec.reader(metric)(dict(SUMMARY)) is None, "the parent's summary"
    assert spec.reader(metric)(dict(s, span_device_s={}, span_kernels={},
                                    counts=None)) is None, "a program without them"


def test_rebuilds_read_zero_when_the_caches_hold():
    s = dict(SUMMARY, **dict(NEW_KEYS, counts={"kernels.launch.K1": 40}))
    assert spec.reader("rebuilds_per_req")(s) == 0.0


@pytest.mark.parametrize("metric", [m["name"] for m in spec.benchmark(ROOT)["per_layer"]])
def test_accepted_readers_read_the_same(metric):
    read = spec.reader(metric)
    assert read(dict(SUMMARY, **NEW_KEYS)) == read(dict(SUMMARY))


def test_every_new_reader_is_found_by_name():
    for names in spans.METRICS.values():
        for name in names:
            assert callable(spec.reader(name)), name


def test_counts_snapshot_reads_the_program(monkeypatch):
    from libsrcnn_tpu_torch.utils import profiling

    snap = spans.counts_snapshot()
    assert "kernels.launch.K1" in snap
    monkeypatch.delattr(profiling, "counts_snapshot")
    assert spans.counts_snapshot() is None
