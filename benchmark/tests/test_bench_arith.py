"""The benchmark's arithmetic on hand-made numbers: the FLOP counts, the
union of device intervals, the idle share, launches, the percentile, the
rates and the shares of the peak."""

import importlib.util

import pytest

from benchmark import trace
from benchmark.flops import flops_per_image
from conftest import ROOT


def reader(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def conf(trunk):
    return {"reference_trunk": trunk, "config": {"MODEL": {"OUT_CHANNELS": 256, "HEADER_NUM_CONV": 2},
                                                 "DATASET": {"OBJs": ["Car", "Pedestrian", "Cyclist"]}}}


@pytest.mark.parametrize("trunk,fwd,both", [("dla34", 436.28, 1306.03), ("resnet18", 411.62, 1232.54)])
def test_flops_at_1280x384(trunk, fwd, both):
    assert round(flops_per_image(conf(trunk), (384, 1280), backward=False) / 1e9, 2) == fwd
    assert round(flops_per_image(conf(trunk), (384, 1280), backward=True) / 1e9, 2) == both


def ev(cat, name, ts, dur, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}


def test_slice_summary_on_a_hand_made_timeline():
    events = [
        ev("user_annotation", trace.MARK, 1000, 1000),
        ev("kernel", "conv", 900, 300),          # clipped to [1000, 1200): 200
        ev("kernel", "bn", 1100, 200),           # overlaps conv: union [1000, 1300)
        ev("gpu_memcpy", "Memcpy HtoD", 1500, 100),
        ev("kernel", "conv", 1900, 300),         # clipped to [1900, 2000): 100
        ev("cpu_op", "aten::copy_", 1300, 250),  # the host during the gap [1300, 1500)
        ev("cpu_op", "aten::to", 1250, 1000),    # longer: not the innermost
        ev("cuda_runtime", "cudaLaunchKernel", 1010, 5), ev("cuda_runtime", "cudaMemcpyAsync", 1400, 5),
        ev("cuda_runtime", "cudaStreamSynchronize", 1450, 5), ev("cuda_runtime", "cudaLaunchKernel", 2500, 5),
    ]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx((300 + 100 + 100) * 1e-6)
    assert s["launches"] == 2
    assert s["device_ops"][0] == ["conv", pytest.approx(300e-6)]
    gaps = dict((k, v) for k, v in s["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(200e-6) and gaps["aten::to"] == pytest.approx(300e-6)
    rec = {"trace": dict(s, calls=2, images=64, flops_per_image=1e9, peak_flops=1e12)}
    assert reader("device_idle_pct.detect_bulk")(rec) == pytest.approx(50.0)
    assert reader("network_roofline.detect_bulk")(rec) == pytest.approx(100 * 64e9 / 1e12 / 500e-6)
    assert reader("detect_mfu")(rec) == pytest.approx(100 * 64e9 / 1e12 / 1000e-6)
    assert reader("launches_per_call.stream")(rec) == 1.0


def test_union_of_intervals():
    assert trace.union([(5, 7), (1, 3), (2, 4), (7, 8)]) == [(1, 4), (5, 8)]


def test_rates_and_percentile():
    lat = [i / 1000 for i in range(1, 101)]  # 1..100 ms
    rec = {"kind": "detect", "latencies_s": lat, "images": 640, "window_s": 2.0, "setup_s": 3.5,
           "peak_allocated": 3 * 2 ** 30}
    assert reader("detect_p95_ms")(rec) == pytest.approx(95.05)
    assert reader("detect_img_per_s")(rec) == 320.0
    assert reader("train_img_per_s")(rec) is None
    assert reader("setup_s")(rec) == 3.5
    rec["kind"] = "train"
    assert reader("train_peak_gib")(rec) == 3.0 and reader("detect_img_per_s")(rec) is None
    assert reader("device_idle_pct.train")(rec) is None  # no trace: nothing to read
