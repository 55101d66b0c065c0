"""BENCHMARK.json against the benchmark's contract, and the harness finding
every configuration, traffic mix, cell and metric by name."""

import json
import re
import subprocess
import sys

import pytest

from conftest import ROOT, make_copy, run_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert all(LINE.match(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = [m["name"] for m in METRICS] + [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]] + [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert len({c["name"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in METRICS)
    assert all(LINE.match(x) for x in [w["why"] for w in BENCH["workloads"]] + [c["source"] for c in BENCH["configs"]]
               + [m["layer"] for m in BENCH["per_layer"]])


def test_entries_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for w in BENCH["workloads"]:
        mine = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(mine) >= 2, w["name"]
        layers = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layers, w["name"]
        for m in layers:
            assert w["name"] in e2e[m["moves"]].get("workloads", [w["name"]])
    for m in BENCH["per_layer"]:
        if "workloads" in m:
            assert all(c in {w["name"] for w in BENCH["workloads"]} for c in m["workloads"])


def test_chip_time_fits():
    cells = len(BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, cells // 4)
    runs = 2 + 14 * 24  # the limit is what fits with the full 24 cells
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_harness_finds_every_part_by_name(w):
    confs = {c["name"]: c for c in BENCH["configs"]}
    assert (ROOT / confs[w["config"]]["file"]).is_file()
    assert confs[w["config"]]["file"].startswith("benchmark/")
    traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    assert (ROOT / "benchmark" / "drivers" / f"{traffic['kind']}.py").is_file()
    assert json.loads((ROOT / "benchmark" / "workloads" / f"{w['name']}.json").read_text())["limits"]
    for m in METRICS:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_each_config_file_is_its_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert (ROOT / "benchmark" / "reference" / "trunks" / f"{conf['reference_trunk']}.py").is_file()


def test_a_cell_added_in_a_copy_runs_without_an_edit(tmp_path):
    copy = make_copy(tmp_path / "c")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    traffic = json.loads((copy / "benchmark" / "traffic" / "input_b1.json").read_text())
    (copy / "benchmark" / "traffic" / "added_b2.json").write_text(json.dumps(dict(traffic, batch=2)))
    (copy / "benchmark" / "workloads" / "dla34_added.json").write_text(
        (copy / "benchmark" / "workloads" / "dla34_detect_bulk.json").read_text())
    bench["workloads"].append({"name": "dla34_added", "config": "rtm3d_dla34_kitti", "traffic": "added_b2", "chips": 1,
                               "why": "a cell added by files alone"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "resnet18_detect_stream" in m.get("workloads", []):
            m["workloads"].append("dla34_added")
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run_cell(copy, "dla34_added")
    assert r["rc"] == 0, r["stderr"][-2000:]
    assert r["line"]["correct"] and set(r["line"]["metrics"]) == {"detect_p95_ms", "setup_s"}
    assert list(r["line"])[-1] == "checks"


def _no_result(cmd, cwd):
    p = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=300)
    return p.returncode != 0 and not any(l.startswith("{") for l in p.stdout.splitlines()), p


def test_exits_without_a_result_when_there_is_no_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ok, p = _no_result([sys.executable, "-m", "benchmark.run", "--workload", "dla34_detect_bulk", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], make_copy(tmp_path / "c", tiny=False))
    assert ok, p.stdout + p.stderr


def test_exits_without_a_result_in_a_bare_checkout(tmp_path):
    copy = make_copy(tmp_path / "c", tiny=False)
    (copy / "rtm3d_tpu_torch").unlink()  # only BENCHMARK.json and the files under paths
    ok, p = _no_result([sys.executable, "-m", "benchmark.run", "--workload", "dla34_detect_bulk", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], copy)
    assert ok, p.stdout + p.stderr


def test_forbidden_modules_are_named_by_whole_top_level_name(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "rtm3d_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert "rtm3d_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "rtm3d_tpu.nn", sys)
    assert run.loaded_forbidden() == ["jax", "rtm3d_tpu"]
