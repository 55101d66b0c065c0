"""The slice read by the program's spans and counters (``benchmark/
spans.py``, ``benchmark/layers.py``, the ``host_syncs_*`` readers), on
hand-made Chrome traces and on a tiny cell on the CPU."""

import copy
import json
import os
import subprocess
import sys

import pytest

from benchmark import layers, spans, trace
from test_bench_arith import ev, reader


def launch(ts, corr, tid=1, name="cudaLaunchKernel"):
    return dict(ev("cuda_runtime", name, ts, 2), tid=tid, args={"correlation": corr})


def kernel(name, ts, dur, corr):
    return dict(ev("kernel", name, ts, dur), args={"correlation": corr})


def step_timeline():
    """One train step in a 1000 us mark: the forward launched on thread 1,
    the backward's kernel launched on autograd's thread 2 while thread 1
    sits in ``train.backward``, a kernel launched before any span."""
    return [
        ev("user_annotation", trace.MARK, 1000, 1000),
        ev("user_annotation", "train.step", 1100, 800),
        ev("user_annotation", "net.backbone", 1110, 240),
        ev("user_annotation", "train.backward", 1400, 400),
        ev("user_annotation", "Optimizer.step#Adamax.step", 1820, 50),  # not the program's
        ev("cpu_op", "aten::conv2d", 1160, 100),
        launch(1010, 1), kernel("fill", 1020, 30, 1),                   # outside every span
        launch(1170, 2), kernel("conv", 1200, 150, 2),                  # net.backbone
        launch(1500, 3, tid=2), kernel("dgrad", 1600, 200, 3),          # train.backward, from thread 2
        dict(launch(1830, 4), cat="cuda_driver", name="cuLaunchKernel"), kernel("adamax", 1840, 40, 4),
        kernel("unmatched", 1950, 100, 99),                             # no launch seen: clipped to 50
    ]


def test_a_kernel_goes_to_the_span_that_launched_it():
    got = spans.by_span(step_timeline())
    assert got["roots"] == {"train.step": 1}
    assert got["device_s"] == pytest.approx({spans.OUTSIDE: (30 + 50) * 1e-6, "net.backbone": 150e-6,
                                             "train.backward": 200e-6, "train.step": 40e-6})


def test_a_gap_goes_to_the_innermost_span():
    got = spans.by_span(step_timeline())
    # busy [1020,1050) [1200,1350) [1600,1800) [1840,1880) [1950,2000)
    assert got["idle_s"] == pytest.approx({spans.OUTSIDE: (20 + 70) * 1e-6, "net.backbone": 150e-6,
                                           "train.backward": 250e-6, "train.step": 40e-6})
    s = trace.summarize(step_timeline())
    assert sum(got["idle_s"].values()) == pytest.approx(s["window_s"] - s["busy_s"])


def test_spans_leave_summarize_as_it_was():
    events = [
        ev("user_annotation", trace.MARK, 1000, 1000), ev("kernel", "conv", 900, 300), ev("kernel", "bn", 1100, 200),
        ev("gpu_memcpy", "Memcpy HtoD", 1500, 100), ev("kernel", "conv", 1900, 300),
        ev("cpu_op", "aten::copy_", 1300, 250), ev("cpu_op", "aten::to", 1250, 1000),
        ev("cuda_runtime", "cudaLaunchKernel", 1010, 5), ev("cuda_runtime", "cudaMemcpyAsync", 1400, 5),
        ev("cuda_runtime", "cudaStreamSynchronize", 1450, 5), ev("cuda_runtime", "cudaLaunchKernel", 2500, 5),
    ]  # test_bench_arith.py's timeline
    want, kept = trace.summarize(events), copy.deepcopy(events)
    got = spans.by_span(events)
    assert events == kept and trace.summarize(events) == want
    assert got == {"roots": {}, "device_s": pytest.approx({spans.OUTSIDE: 600e-6}),
                   "idle_s": pytest.approx({spans.OUTSIDE: 500e-6})}


def test_no_device_event_no_device_reading():
    events = [ev("user_annotation", trace.MARK, 0, 100), ev("user_annotation", "detect.call", 10, 80)]
    parts = spans.by_span(events)
    assert parts["device_s"] == {} and parts["roots"] == {"detect.call": 1}
    split = layers.split(parts, trace.summarize(events), {"host_syncs": 11})
    assert split == {"roots": {"detect.call": 1}, "counters": {"host_syncs": 11.0}}
    assert layers.split(spans.by_span(events[:1]), trace.summarize(events[:1]), None) == {"roots": {}}


@pytest.mark.parametrize("name", ["host_syncs_per_call.detect_bulk", "host_syncs_per_call.stream",
                                  "host_syncs_per_step.train"])
def test_host_syncs_over_the_slice_calls(name, monkeypatch):
    rec = {"trace": {"calls": 20}}
    monkeypatch.setattr(spans, "program_counters", lambda: {"host_syncs": 220})
    assert reader(name)(rec) == 11.0
    assert reader(name)({}) is None
    monkeypatch.setattr(spans, "program_counters", lambda: None)  # a program without counters
    assert reader(name)(rec) is None


@pytest.mark.parametrize("cell,root,syncs", [("resnet18_detect_stream", "detect.call", 15),
                                             ("dla34_train", "train.step", 2)])
def test_a_tiny_cell_split_by_span(tiny, cell, root, syncs):
    """5 s: the slice starts with a call begun after a fifth of the window."""
    code = ("import sys; sys.path.insert(0, '.')\nfrom benchmark.layers import main\n"
            f"sys.exit(main(['--workload', {cell!r}, '--seed', '2147483659', '--seconds', '5'], device='cpu'))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tiny, capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, OMP_NUM_THREADS="4"))
    assert p.returncode == 0, p.stderr[-2000:]
    line, split = (json.loads(l) for l in p.stdout.splitlines()[-2:])
    assert line["correct"] and split["layers"] == {"roots": {root: 2}, "counters": {"host_syncs": float(syncs)}}
    assert [v["value"] for k, v in line["metrics"].items() if k.startswith("host_syncs")] == [syncs]
