"""The port's benches (``rtm3d_tpu_torch/tools/``) on the CPU, at a tiny
size, against the JAX tools they port.

- ``bench``, ``bench_latency`` (also ``--int8``, and ResNet-18 in fp32)
  and ``bench_train`` (step-only, and ``--e2e`` through the reader, the
  loader, the device warp and cache on a 4-frame tree), each through its
  CLI with ``--device cpu``, its bench function held at a tiny frame
  (the CLIs take the JAX tools' shapes): the printed JSON lines carry the JAX tools'
  keys and metric names (at the default shapes the names are the JAX
  tools' literals), and the port's extra keys, no others.
- The kernels' wrappers, counted where the tools call them (on the CPU
  each runs its plain version): 2 LM solves a detect call, 1 splat a train
  step, 52 ``quantize`` and 52 ``conv_s8`` an int8 DLA-34 call. The tools
  read the same counts (``<wrapper>.launches``) that the card's kernels
  keep.
- ``bench``'s profiler sessions: one without a device lane on the card
  is taken again, then refused.
- ``trace_times`` on a trace from ``utils/profiling.py::device_trace``
  of three marked detect calls (ResNet-18, 3 LM iterations): the lane's busy time (the union of its
  nested ops) against the profiler's summed self time of the ops, the ops'
  summed time and the convolutions' against its totals, and the marks'
  time against its own (``key_averages``), each within 1%; the marks'
  per-call durations number three.
"""

import functools
import json
import os
import re
from pathlib import Path

import pytest
import torch
from torch.profiler import record_function

from rtm3d_tpu_torch.data import targets
from rtm3d_tpu_torch.data.synthetic import generate_kitti
from rtm3d_tpu_torch.ops import int8_conv, lm_solver, splat
from rtm3d_tpu_torch.tools import bench, bench_latency, bench_train, trace_times

REPO = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
TINY_HW = (32, 64)
JAX_LATENCY_KEYS = {"batch", "iters", "device", "backbone", "dtype"}
JAX_DEVICE_KEYS = {"p50_ms", "p90_ms", "p99_ms", "mean_ms", "per_image_ms"}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def counted(monkeypatch):
    """Each kernel wrapper behind a counter of its calls, kept where the
    card's kernels keep their launches (``<wrapper>.launches``)."""

    def counter(fn):
        def wrapped(*args, **kwargs):
            wrapped.launches += 1
            return fn(*args, **kwargs)

        wrapped.launches = 0
        return wrapped

    sp = counter(splat.splat_heatmap)
    monkeypatch.setattr(lm_solver, "lm_solve", counter(lm_solver.lm_solve))
    monkeypatch.setattr(splat, "splat_heatmap", sp)
    monkeypatch.setattr(targets, "splat_heatmap", sp)
    monkeypatch.setattr(int8_conv, "quantize", counter(int8_conv.quantize))
    monkeypatch.setattr(int8_conv, "conv_s8", counter(int8_conv.conv_s8))


def json_lines(text: str) -> list:
    return [json.loads(l) for l in text.splitlines() if l.startswith("{")]


def jax_literal(path: str, pattern: str) -> set:
    return set(re.findall(pattern, (REPO / path).read_text()))


def test_metric_names_at_the_default_shapes_are_the_jax_tools():
    assert jax_literal("bench.py", r'"(detect_\w+_1280x384)"') == {
        "detect_images_per_sec_dla34_b128_1280x384", "detect_ms_per_image_dla34_b1_1280x384"}
    h, w = bench_latency.H, bench_latency.W
    assert (bench.BATCH, h, w) == (128, 384, 1280)
    assert jax_literal("tools/bench_train.py", r'f"(train_\w+_dla34_b)\{args\.batch\}(_1280x384_)\{args\.dtype\}"') == {
        ("train_step_images_per_sec_dla34_b", "_1280x384_"), ("train_e2e_images_per_sec_dla34_b", "_1280x384_")}
    args = bench_train.parse_args([])
    assert (args.batch, args.dtype, args.iters, bench_train.N) == (16, "float32", 10, 32)


def test_bench_throughput_and_b1(counted, capsys, monkeypatch):
    monkeypatch.setattr(bench, "throughput", functools.partial(bench.throughput, batch=2, iters=2, hw=TINY_HW))
    monkeypatch.setattr(bench, "latency_b1", functools.partial(bench.latency_b1, iters=3, hw=TINY_HW))
    out = bench.main(CPU)
    line = json_lines(capsys.readouterr().out)[-1]
    assert line == json.loads(json.dumps(out))
    assert line["metric"] == "detect_images_per_sec_dla34_b2_64x32" and line["unit"] == "images/sec"
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "card", "timed_by", "ms_per_call",
                         "wall_ms_per_call", "profiler_device_ms_per_call", "lm_launches_per_call",
                         "outputs_finite"}
    assert line["lm_launches_per_call"] == 2 and line["card"] == "cpu" and line["timed_by"] == "host_clock"
    assert line["outputs_finite"] is True
    assert line["profiler_device_ms_per_call"] == "not measured"  # a CPU trace has no device lane
    # vs_baseline is rounded from the unrounded rate: 1e-3 covers both roundings
    assert line["value"] > 0 and line["vs_baseline"] == pytest.approx(line["value"] / bench.PAPER_FPS, abs=1e-3)

    out = bench.main(CPU + ["--b1"])
    line = json_lines(capsys.readouterr().out)[-1]
    assert line["metric"] == "detect_ms_per_image_dla34_b1_64x32" and line["unit"] == "ms/image"
    assert {"metric", "value", "unit", "vs_baseline"} <= set(line) and line["lm_launches_per_call"] == 2
    assert line["vs_baseline"] == pytest.approx(bench.PAPER_MS / line["value"], abs=1e-3)


def test_bench_retakes_a_profiler_session_without_device_lanes(monkeypatch):
    """On the card a profiler session that records no device lane is taken
    again, up to PROFILER_SESSIONS times, then the bench fails; on the CPU
    a trace has no device lane and the device time is "not measured"."""
    sessions = []

    def summarize(path):
        sessions.append(path)
        return ({"gpu/stream 7": 5.0} if len(sessions) == 2 else {}), [], 0.0, []

    monkeypatch.setattr(bench, "summarize", summarize)
    calls = []
    assert bench.profiled_lanes(lambda: calls.append(1), torch.device("cuda")) == {"gpu/stream 7": 5.0}
    assert len(sessions) == len(calls) == 2
    monkeypatch.setattr(bench, "summarize", lambda path: ({}, [], 0.0, []))
    calls.clear()
    with pytest.raises(RuntimeError, match="no device activity"):
        bench.profiled_lanes(lambda: calls.append(1), torch.device("cuda"))
    assert len(calls) == bench.PROFILER_SESSIONS
    assert bench.profiled_lanes(lambda: None, torch.device("cpu")) == {}


@pytest.mark.parametrize("mode", ["bf16", "int8", "resnet18_fp32"])
def test_bench_latency(counted, capsys, tmp_path, monkeypatch, mode):
    monkeypatch.setattr(bench_latency, "run", functools.partial(bench_latency.run, hw=TINY_HW))
    batches = "1,2" if mode == "bf16" else "2"
    argv = CPU + ["--batches", batches, "--iters", "2", "--out", str(tmp_path / "lat.json")]
    argv += {"bf16": [], "int8": ["--int8"], "resnet18_fp32": ["--backbone", "RESNET-18", "--dtype", "float32"]}[mode]
    bench_latency.main(argv)
    lines = json_lines(capsys.readouterr().out)
    assert [l["batch"] for l in lines] == [int(b) for b in batches.split(",")]
    for l in lines:
        assert set(l) == JAX_LATENCY_KEYS | {"wall", "launches_per_call", "card"}
        assert l["device"] == "not measured"  # no device clock on the CPU
        assert set(l["wall"]) == JAX_DEVICE_KEYS - {"per_image_ms"} and l["iters"] == 2
        assert l["launches_per_call"]["lm"] == 2
        convs = 52 if mode == "int8" else 0
        assert l["launches_per_call"]["conv_s8"] == l["launches_per_call"]["quantize"] == convs
    assert (lines[0]["backbone"], lines[0]["dtype"]) == {
        "bf16": ("DLA-34", "bfloat16"), "int8": ("DLA-34", "bfloat16"), "resnet18_fp32": ("RESNET-18", "float32")}[mode]
    report = json.loads((tmp_path / "lat.json").read_text())
    assert set(report) == {"int8", "backbone", "dtype", "results"} and report["int8"] == (mode == "int8")


def test_latency_percentiles_on_a_device_clock():
    """The ``device`` block as the JAX tool computes it, from per-call ms."""
    p = bench_latency.percentiles([1.0, 2.0, 3.0, 4.0])
    assert p == {"p50_ms": 2.5, "p90_ms": pytest.approx(3.7), "p99_ms": pytest.approx(3.97), "mean_ms": 2.5}


def test_bench_train_step_only_and_e2e(counted, capsys, tmp_path, monkeypatch):
    tree = generate_kitti(str(tmp_path / "kitti"), num_train=4, num_test=0, img_hw=(64, 96), max_objs=4)
    monkeypatch.setattr(bench_train, "run", functools.partial(bench_train.run, hw=(64, 96)))
    out = bench_train.main(CPU + ["--batch", "2", "--iters", "1", "--e2e", "--data-path", tree])
    step, e2e = json_lines(capsys.readouterr().out)
    assert step["metric"] == "train_step_images_per_sec_dla34_b2_96x64_float32"
    assert e2e["metric"] == "train_e2e_images_per_sec_dla34_b2_96x64_float32"
    assert set(step) == {"metric", "value", "unit", "ms_per_step", "wall_ms_per_step", "tf32", "remat",
                         "splat_launches_per_step", "peak_mem_gb", "loss"}
    assert set(e2e) == {"metric", "value", "unit", "ms_per_step", "workers", "steps", "device_cache_gb", "tf32",
                        "splat_launches_per_step", "loss"}
    assert step["splat_launches_per_step"] == e2e["splat_launches_per_step"] == 1
    assert e2e["steps"] == 2 and e2e["device_cache_gb"] > 0  # one epoch of 4 frames at b2, the canvases cached
    assert out == {"step_only": step, "e2e": e2e}
    with pytest.raises(SystemExit, match="not ported"):
        bench_train.main(["--device", "cpu", "--s2d-block", "4"])


def test_trace_times_sums_to_the_profilers_totals(tmp_path):
    from rtm3d_tpu_torch.utils.profiling import device_trace

    from rtm3d_tpu_torch.nn.model import create_model
    from rtm3d_tpu_torch.train.step import make_detect_step

    cfg = bench_latency.bench_config("RESNET-18", "float32", (32, 64))
    cfg.DETECTOR.SOLVER_ITERS = 3
    detect = make_detect_step(create_model(cfg), cfg, device="cpu")
    frames, K = bench_latency.distinct_frames(1, 3, (32, 64), "cpu"), bench_latency.kitti_K(1, "cpu")
    detect(frames[0], K)
    with device_trace(str(tmp_path)) as prof:
        for f in frames:
            with record_function("detect_call"):
                detect(f, K)
    rows = {e.key: e for e in prof.key_averages()}
    lanes, top_ops, span, calls = trace_times.summarize(str(tmp_path), top=10**6, host=True)
    assert top_ops and span > 0 and len(lanes) == 1
    # the ops: every row but the marks, this test's and the port's layer spans
    ops = [e for k, e in rows.items() if k != "detect_call" and not k.startswith(("detect.", "net."))]
    # the lane's busy time, the union of its nested ops, is the profiler's
    # summed self time of the ops
    assert sum(lanes.values()) == pytest.approx(sum(e.self_cpu_time_total for e in ops), rel=1e-2)
    # the ops' summed times (an op's events summed; an op that calls its
    # own overload counts twice in the trace, once in the profiler's table)
    assert sum(t for _, t in top_ops) == pytest.approx(sum(e.cpu_time_total for e in ops), rel=1e-2)
    assert dict(top_ops)["aten::convolution"] == pytest.approx(rows["aten::convolution"].cpu_time_total, rel=1e-2)
    totals = {"detect_call": rows["detect_call"].cpu_time_total}
    assert dict(calls)["detect_call"] == pytest.approx(totals["detect_call"], rel=1e-2)
    per_call = trace_times.call_durations(str(tmp_path))["detect_call"]
    assert len(per_call) == 3 and sum(per_call) == pytest.approx(totals["detect_call"], rel=1e-2)
    assert trace_times.summarize(str(tmp_path))[0] == {}  # no device lane in a CPU trace
    cli = trace_times.main([str(tmp_path), "--top", "5"])  # the device's lanes: none here
    assert cli[0] == {} and cli[3] == calls and os.path.isfile(trace_times.find_trace_file(str(tmp_path)))
