"""The benchmark's own tests: run with ``python -m pytest benchmark/tests``
from the repository's root. They import nothing of JAX; those that need a
CUDA device are marked ``cuda`` and skip inside a fixture."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

TINY_HW = [128, 64]  # (W, H): the smallest frame DLA-34 trains on at batch 2
TINY_CANVAS = [60, 124]


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def shrink(copy: Path) -> None:
    """Cut a copy's cells to a size a CPU test run holds: frames of
    ``TINY_HW``, batch 2, float32, a few frames a pool."""
    for f in (copy / "benchmark" / "configs").glob("*.json"):
        conf = json.loads(f.read_text())
        conf["config"]["INPUT_SIZE"] = TINY_HW
        conf["config"]["DATASET"]["MAX_OBJS"] = 8
        conf["config"]["TPU"]["COMPUTE_DTYPE"] = "float32"
        f.write_text(json.dumps(conf))
    for f in (copy / "benchmark" / "traffic").glob("*.json"):
        tr = json.loads(f.read_text())
        tr.update(canvas_hw=TINY_CANVAS, pool_batches=2, warmup_calls=1, check_calls=2, ref_block=2,
                  batch=min(2, tr["batch"]), trace_calls=2)
        if tr["kind"] == "train":
            tr["dataset_frames"] = 12
        f.write_text(json.dumps(tr))


def make_copy(dst: Path, tiny: bool = True) -> Path:
    """A checkout of the benchmark (``BENCHMARK.json``, ``benchmark/``) with
    the program linked in."""
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dst / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    (dst / "rtm3d_tpu_torch").symlink_to(ROOT / "rtm3d_tpu_torch")
    if tiny:
        shrink(dst)
    return dst


def run_cell(copy: Path, workload: str, seed: int = 2147483659, seconds: float = 1.0, trace: int = 0,
             fault: str = "") -> dict:
    """One run of ``workload`` in ``copy`` on the CPU, in its own process,
    the timed path broken by ``fault`` (``benchmark/tests/faults.py``) when
    given. Returns the exit code, the result line (or None) and stderr."""
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from benchmark.run import main\n"
        f"wrap = None\n"
        f"if {fault!r}:\n"
        "    import importlib.util\n"
        f"    spec = importlib.util.spec_from_file_location('faults', {str(Path(__file__).parent / 'faults.py')!r})\n"
        "    faults = importlib.util.module_from_spec(spec); spec.loader.exec_module(faults)\n"
        f"    wrap = getattr(faults, {fault!r})\n"
        f"sys.exit(main(['--workload', {workload!r}, '--seed', '{seed}', '--seconds', '{seconds}', "
        f"'--trace', '{trace}'], device='cpu', wrap_call=wrap))\n")
    env = dict(os.environ, OMP_NUM_THREADS="4")
    p = subprocess.run([sys.executable, "-c", code], cwd=copy, capture_output=True, text=True, timeout=600, env=env)
    lines = [l for l in p.stdout.splitlines() if l.startswith("{")]
    return {"rc": p.returncode, "line": json.loads(lines[-1]) if lines else None, "stderr": p.stderr}


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    return make_copy(tmp_path_factory.mktemp("tiny"))
