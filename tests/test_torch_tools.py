"""The port's stats CLI and model tools against the JAX package's, on the CPU.

- ``cli.stats`` over the KITTI tree of tests/test_torch_data.py (6 train
  frames of 64x192 at INPUT_SIZE 192): the JSON equal to the JAX CLI's
  within 1e-6 (measured 0 on the areas and counts, 3e-8 on the vertex
  offsets: the port projects in float32 torch, the JAX CLI in float32
  numpy), ``num_objects`` with the JAX CLI's quirk (1 on a tree with no
  object); ``--vis-targets`` overlays within one grey level of the JAX
  CLI's (measured: equal), one splat launch per overlay.
- ``model_info``: parameter counts equal to the JAX ``model_info``'s; the
  FLOPs of RTM3D ResNet-18 at 96x320 with XLA's count within 0.85-0.95 of
  this one (measured 0.893: XLA counts no padding tap, see
  ``utils/model_info.py``).
- ``device_trace`` writes a Chrome trace and yields the profiler.
"""

import json
import os
import shutil

import cv2
import jax
import numpy as np
import pytest
import torch

from rtm3d_tpu.cli import stats as stats_jax
from rtm3d_tpu.config import default_config as default_config_jax
from rtm3d_tpu.nn.model import init_model
from rtm3d_tpu.utils.model_info import model_info as model_info_jax
from rtm3d_tpu_torch.cli import stats
from rtm3d_tpu_torch.config import default_config
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.ops import splat
from rtm3d_tpu_torch.utils import profiling
from rtm3d_tpu_torch.utils.model_info import model_info
from tests.test_torch_data import REPO, kitti_tree  # noqa: F401

ARGS = ["--model-config", str(REPO / "configs" / "rtm3d_dla34_kitti.yaml"), "--set", "INPUT_SIZE", "(192, 192)",
        "DATASET.MAX_OBJS", "8"]


def test_stats_json_and_overlays_match_jax(kitti_tree, tmp_path, monkeypatch, capsys):  # noqa: F811
    want = stats_jax.main(ARGS[:2] + ["--data-path", kitti_tree, "--vis-targets", str(tmp_path / "jax"),
                                      "--vis-count", "3"] + ARGS[2:])
    calls = []
    kernel = splat.splat_heatmap

    def counted(*a, **k):
        calls.append(a[0].shape)
        return kernel(*a, **k)

    monkeypatch.setattr("rtm3d_tpu_torch.data.targets.splat_heatmap", counted)
    capsys.readouterr()
    got = stats.main(ARGS[:2] + ["--data-path", kitti_tree, "--device", "cpu", "--vis-targets", str(tmp_path / "port"),
                                 "--vis-count", "3"] + ARGS[2:])
    assert json.loads(capsys.readouterr().out.split("target overlays")[0]) == {
        k: v for k, v in got.items() if k != "overlays"}
    assert set(got) - {"overlays"} == set(want)
    assert got["num_images"] == want["num_images"] == 6 and got["num_objects"] == want["num_objects"] > 6
    for k in ("BBOX_AREA_MAX", "BBOX_AREA_MIN"):
        assert abs(got[k] - want[k]) <= 1e-6, k
    np.testing.assert_allclose(got["VERTEX_OFFSET_INFER"], want["VERTEX_OFFSET_INFER"], atol=1e-6, rtol=0)
    assert len(calls) == 3 and all(c[0] == 1 for c in calls)  # one launch per overlay
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 3 and [os.path.basename(p) for p in got["overlays"]] == names
    for n in names:
        a = cv2.imread(str(tmp_path / "jax" / n)).astype(int)
        b = cv2.imread(str(tmp_path / "port" / n)).astype(int)
        assert a.shape == b.shape == (64, 192, 3) and np.abs(a - b).max() <= 1, n


def test_num_objects_quirk_on_a_tree_without_objects(kitti_tree, tmp_path):  # noqa: F811
    """An empty split: no areas, so both CLIs report the placeholder's
    length, 1, and its zeros."""
    tree = str(tmp_path / "kitti")
    shutil.copytree(kitti_tree, tree, ignore=shutil.ignore_patterns("cache"))  # no annotation cache
    for f in os.listdir(os.path.join(tree, "training", "label_2")):
        open(os.path.join(tree, "training", "label_2", f), "w").close()
    want = stats_jax.main(ARGS[:2] + ["--data-path", tree] + ARGS[2:])
    got = stats.main(ARGS[:2] + ["--data-path", tree, "--device", "cpu"] + ARGS[2:])
    assert got == want and got["num_objects"] == 1 and got["BBOX_AREA_MAX"] == 0.0


@pytest.mark.parametrize("backbone", ["RESNET-18", "DLA-34"])
def test_model_info_matches_jax(backbone):
    cfg_jax, cfg = default_config_jax(), default_config()
    for c in (cfg_jax, cfg):
        c.INPUT_SIZE, c.MODEL.BACKBONE = (320, 96), backbone
        if backbone.startswith("RESNET"):
            c.MODEL.KFNs = ["layer1", "layer2", "layer3", "layer4"]
    cfg_jax.TPU.S2D_STEM = False
    model, variables = init_model(cfg_jax, jax.random.PRNGKey(0))
    want = model_info_jax(model, variables, (96, 320))
    got = model_info(create_model(cfg), (96, 320))
    assert got["params"] == want["params"] and got["input"] == want["input"] == "1x96x320x3"
    assert 0.85 <= want["flops"] / got["flops"] <= 0.95, want["flops"] / got["flops"]
    # two batches: twice the operations
    assert model_info(create_model(cfg), (96, 320), batch=2)["flops"] == 2 * got["flops"]


def test_timer_and_device_trace(tmp_path):
    with profiling.device_trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = os.listdir(tmp_path)
    assert len(traces) == 1 and json.load(open(tmp_path / traces[0]))["traceEvents"]
    assert any("mm" in e.key for e in prof.key_averages())
