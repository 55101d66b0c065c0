"""The port stands alone: no module of ``rtm3d_tpu_torch`` nor
``chip_smoke.py`` imports JAX, flax, optax or the JAX package, and a process
that imports the port and runs it (a detect call and a train step) never
loads JAX."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rtm3d_tpu")


def _port_sources():
    files = sorted((REPO / "rtm3d_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10 and files[-1].exists()
    return files


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    # "rtm3d_tpu_torch" is a root of its own, distinct from "rtm3d_tpu"
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_port_runs_without_loading_jax(tmp_path):
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import numpy as np\n"
        "from rtm3d_tpu_torch.api import Detector\n"
        "from rtm3d_tpu_torch.config import default_config\n"
        "from rtm3d_tpu_torch.nn.model import create_model\n"
        "cfg = default_config(); cfg.DETECTOR.TOPK_CANDIDATES = 4; cfg.DETECTOR.SOLVER_ITERS = 3\n"
        "det = Detector(cfg, create_model(cfg), device='cpu')\n"
        "K = np.tile(np.array([[30., 0, 16], [0, 30, 16], [0, 0, 1]], np.float32), (1, 1, 1))\n"
        "out = det(np.zeros((1, 32, 32, 3), np.uint8), K)\n"
        "assert out['scores'].shape == (1, 4)\n"
        "from rtm3d_tpu_torch.train.state import TrainState\n"
        "from rtm3d_tpu_torch.train.step import make_train_step\n"
        "cfg.INPUT_SIZE = (64, 64); cfg.DATASET.MAX_OBJS = 2\n"
        "labels = dict(cls=np.zeros((1, 2), np.int32), bbox=np.array([[[8., 8., 40., 32.], [0., 0., 16., 16.]]], np.float32),\n"
        "              dim=np.ones((1, 2, 3), np.float32), alpha=np.zeros((1, 2), np.float32), ry=np.zeros((1, 2), np.float32),\n"
        "              loc=np.array([[[0., 1., 10.], [1., 1., 12.]]], np.float32), K=np.tile(np.array([30., 0, 16, 0, 30, 16, 0, 0, 1], np.float32), (1, 2, 1)),\n"
        "              mask=np.array([[True, False]]), noise_mask=np.zeros((1, 2), bool))\n"
        "state = TrainState.create(create_model(cfg), cfg, device='cpu')\n"
        "state, m = make_train_step(cfg, device='cpu')(state, {'image': np.full((1, 64, 64, 3), 7, np.uint8), 'labels': labels})\n"
        "assert state.step == 1 and bool(m['loss'].isfinite())\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in %r)\n"
        "assert not bad, bad\n"
        "print('ok')\n" % (FORBIDDEN,)
    )
    path = os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, PYTHONPATH=path)
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-2000:]
