"""The control comes out not correct: the reference in the program's
place, its convolutions on float8 inputs and weights and its 3D solve in
bfloat16 (``benchmark/control.py``), judged as a run judges the program,
breaks at least one of each cell's limits. At a size a CPU test run holds;
the readings at the cells' own sizes on the chip are in PERF.md."""

import json

import pytest
import torch

from benchmark import gen, judge
from benchmark.drivers import detect as D
from benchmark.drivers import train as T
from conftest import ROOT, TINY_CANVAS, TINY_HW

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in BENCH["workloads"]}
torch.set_num_threads(4)


def parts(cell: str):
    w = CELLS[cell]
    conf = json.loads((ROOT / {c["name"]: c for c in BENCH["configs"]}[w["config"]]["file"]).read_text())
    conf["config"]["INPUT_SIZE"] = [TINY_HW[0] * 2, TINY_HW[1] * 2]
    conf["config"]["DATASET"]["MAX_OBJS"] = 8
    traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    traffic.update(canvas_hw=[TINY_CANVAS[0] * 2, TINY_CANVAS[1] * 2], pool_batches=2, check_calls=2,
                   batch=min(2, traffic["batch"]), ref_block=2, dataset_frames=8)
    limits = json.loads((ROOT / "benchmark" / "workloads" / f"{cell}.json").read_text())["limits"]
    return conf, traffic, limits


@pytest.mark.parametrize("cell", [c for c in CELLS if c != "dla34_train"])
def test_detect_control_breaks_a_limit(cell):
    conf, traffic, limits = parts(cell)
    dev = torch.device("cpu")
    sd = D.weights(conf, traffic, 41, dev)
    inputs = D.Inputs(conf, traffic, 41, dev)
    nums = D.check(D.control_answers(conf, traffic, sd, inputs, 2, dev), conf, traffic, sd, inputs, dev)
    assert any(nums[k] > v for k, v in limits.items()), nums


def test_train_control_breaks_a_limit():
    conf, traffic, limits = parts("dla34_train")
    dev = torch.device("cpu")
    sd = gen.make_weights(conf, 43, dev, "float32")
    cache, batches = T.dataset(conf, traffic, 43, dev)
    control = T.reference_readings(conf, sd, batches[:3], cache, dev, control=True)
    ref = T.reference_readings(conf, sd, batches[:3], cache, dev)
    nums = judge.train_numbers(control, ref, sd)
    nums.update(late_control(conf, traffic, 43))  # a run checks both the first steps and those after the window
    assert any(nums[k] > v for k, v in limits.items()), nums


def late_control(conf, traffic, seed):
    """The control going on from the program's state after a few steps, as
    a run's check after its window does."""
    from types import SimpleNamespace

    from benchmark import control

    return control.train_reading({"conf": conf, "traffic": traffic}, seed, "control", torch.device("cpu"),
                                 SimpleNamespace(late_after=2))


def test_train_control_after_the_window_breaks_a_limit():
    conf, traffic, limits = parts("dla34_train")
    nums = late_control(conf, traffic, 44)
    assert any(nums[k] > v for k, v in limits.items() if k.startswith("late_")), nums
