"""The port's layer spans and host-sync counter (``utils/profiling.py``),
on the CPU, with a ResNet-18 at 64x64, batch 2: two ``Detector`` calls of
uint8 frames and two train steps of raw canvases with ``warp``, ``photo``
and ``border``.

- Under ``torch.profiler`` every span of the call or the step appears in
  the Chrome trace, each a child of its root (``detect.call``,
  ``train.step``) on the same thread, and there is one root a call or
  step.
- ``host_syncs`` moves by 15 a call of uint8 frames: the 11 output keys'
  ``.cpu()``, and the copies of host lists to the device that wait for it
  (the normalisation's mean and std, the solve's priors); and by 2 a step
  with ``photo``: the corner signs' copy and the seeds' ``.tolist()``.
- With no profiler no span enters ``record_function`` (the port's
  binding, replaced here by one that raises; torch's optimizer enters its
  own whatever the profiler) and no counter moves.
"""

import json

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from rtm3d_tpu_torch.api import Detector
from rtm3d_tpu_torch.config import default_config
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.ops.device_warp import warp_params_for
from rtm3d_tpu_torch.train.state import TrainState
from rtm3d_tpu_torch.train.step import make_train_step
from rtm3d_tpu_torch.utils import profiling
from tests.test_torch_ddp import HW, labels_batch

B, CANVAS_HW = 2, (40, 70)
SPANS = {
    "detect": ("detect.call", {"detect.input", "net.backbone", "net.kfpn", "net.header", "detect.decode",
                               "detect.solve", "detect.output"}),
    "train": ("train.step", {"train.input", "train.targets", "net.backbone", "net.kfpn", "net.header",
                             "train.loss", "train.backward", "train.update"}),
}


@pytest.fixture(scope="module")
def runs():
    """{"detect": call(), "train": step()}: each runs the entry point once."""
    cfg = default_config()
    cfg.MODEL.BACKBONE = "RESNET-18"
    cfg.MODEL.KFNs = ["layer1", "layer2", "layer3", "layer4"]
    cfg.INPUT_SIZE = (HW, HW)
    cfg.DATASET.MAX_OBJS = 6
    cfg.TRAINING.EMA = True
    model = create_model(cfg)
    rng = np.random.RandomState(0)
    detector = Detector(cfg, model, device="cpu")
    frames = rng.randint(0, 256, (B, HW, HW, 3)).astype(np.uint8)
    K = np.tile(np.array([[60.0, 0, HW / 2], [0, 60.0, HW / 2], [0, 0, 1]], np.float32), (B, 1, 1))
    state = TrainState.create(model, cfg, device="cpu")
    step = make_train_step(cfg, device="cpu")
    params, _ = warp_params_for(CANVAS_HW, (HW, HW), HW)
    batch = {"image": rng.randint(0, 256, (B, *CANVAS_HW, 3)).astype(np.uint8),
             "warp": np.tile(np.concatenate([params, CANVAS_HW[::-1]]).astype(np.float32), (B, 1)),
             "photo": np.asarray([[1.1, 0.05, 2.0, 11], [1.0, 0.0, 0.0, 12]], np.float32),
             "border": rng.uniform(0, 255, (B, 3)).astype(np.float32),
             "labels": labels_batch(rng, B)}
    return {"detect": lambda: detector(frames, K), "train": lambda: step(state, batch)}


def traced(run, n, path):
    """The user annotations of ``n`` runs under the profiler, and the
    counters' moves."""
    before = dict(profiling.counters)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            run()
    prof.export_chrome_trace(str(path))
    moved = {k: v - before.get(k, 0) for k, v in profiling.counters.items() if v != before.get(k, 0)}
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"], moved


@pytest.mark.parametrize("entry", ["detect", "train"])
def test_every_span_nests_under_one_root_a_call(entry, runs, tmp_path):
    root, layers = SPANS[entry]
    spans, _ = traced(runs[entry], 2, tmp_path / "trace.json")
    ours = [e for e in spans if e["name"] == root or e["name"] in layers]
    roots = [e for e in ours if e["name"] == root]
    assert len(roots) == 2
    for e in ours:
        if e["name"] == root:
            continue
        around = [r for r in ours if r is not e and r["tid"] == e["tid"] and r["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= r["ts"] + r["dur"]]
        parent = min(around, key=lambda r: r["dur"])
        assert parent["name"] == root, (e["name"], parent["name"])
    for r in roots:
        inside = {e["name"] for e in ours if r["ts"] <= e["ts"] <= r["ts"] + r["dur"] and e is not r}
        assert inside == layers


@pytest.mark.parametrize("entry,syncs", [("detect", 15), ("train", 2)])
def test_host_syncs_a_call(entry, syncs, runs, tmp_path):
    _, moved = traced(runs[entry], 2, tmp_path / "trace.json")
    assert moved == {"host_syncs": 2 * syncs}


@pytest.mark.parametrize("entry", ["detect", "train"])
def test_no_profiler_enters_no_span_and_counts_nothing(entry, runs, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    before = dict(profiling.counters)
    runs[entry]()
    assert dict(profiling.counters) == before
