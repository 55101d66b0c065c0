"""On the card: every cell runs as the driver runs it, and comes out
correct; its traced run reads every per-layer metric it lists."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(cuda_device, w, trace):
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", w, "--seed", "2147483651",
                        "--seconds", "3", "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.splitlines()[-1])
    assert line["correct"], line["checks"]
    want = [m["name"] for m in BENCH["per_layer" if trace else "end_to_end"] if w in m.get("workloads", [w])]
    assert sorted(line["metrics"]) == sorted(want)
