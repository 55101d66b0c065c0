"""``python -m rtm3d_tpu_torch.cli.detect`` and ``.evaluate`` against the JAX
package's CLIs, on the CPU: the same KITTI tree (tests/test_torch_data.py's,
3 test frames of 64x192, rect 256x96 at INPUT_SIZE 256, so the frames are
resampled), the same flax msgpack (an EMA that differs from the parameters,
which both CLIs serve), batch 2 (a padded tail), fp32, top-K 10 with the
score and residual thresholds lifted so that every image writes lines.
Twice: under ``configs/rtm3d_dla34_kitti.yaml`` (host resampling) and under
``configs/rtm3d_dla34_kitti_tpu.yaml`` (the device warp; the port with two
loader workers), the port with ``--save-vis``.

The random weights would regress vertex sets that no cuboid fits, on which
the LM stops unconverged at depths of kilometres and each stack's float
noise moves the pose by percents. So the vertex head of both weight sets
is set to a constant: the projection of a car 25 m ahead on the optical
axis, relative to its centre (``cuboid_vertex_head``). Each peak then
regresses a near-cuboid (exact on the optical axis), and the LM converges
to a plausible box (residuals of pixels: RESIDUAL_THRESH is lifted).

The result files must hold the same lines, matched by (class, 2D box):
class, box, alpha, ry and score equal to the format's last digit, dim and
loc within the tolerances of tests/test_torch_detect.py:63-69 (0.01 and
0.05). The AP tables of both evaluators over the same files must be equal.
"""

import os

import jax
import numpy as np
import pytest

from rtm3d_tpu.cli import detect as detect_jax
from rtm3d_tpu.cli import evaluate as evaluate_jax
from rtm3d_tpu.train import checkpoint as ckpt_jax
from rtm3d_tpu_torch.cli import detect, evaluate
from rtm3d_tpu_torch.config import load_config
from rtm3d_tpu_torch.data.kitti import create_dataset
from rtm3d_tpu_torch.utils.measure import compare_result_dirs, cuboid_vertex_bias
from tests.test_torch_checkpoint_import import cfgs, jax_state_with_ema
from tests.test_torch_data import REPO, kitti_tree  # noqa: F401

SET = ["INPUT_SIZE", "(256, 256)", "DATASET.MAX_OBJS", "8", "DETECTOR.TOPK_CANDIDATES", "10",
       "DETECTOR.SCORE_THRESH", "0.0", "DETECTOR.RESIDUAL_THRESH", "1e9", "TPU.COMPUTE_DTYPE", "float32",
       "TPU.S2D_STEM", "False", "num_workers", "0"]
MODES = {"host": "rtm3d_dla34_kitti.yaml", "device_warp": "rtm3d_dla34_kitti_tpu.yaml"}


def cuboid_vertex_head(params, K):
    """``params`` with the vertex head (``offset_fr_main``) a constant."""
    params = jax.tree_util.tree_map(np.array, params)
    head = params["detect_header"]["offset_fr_main"]["head"]["conv"]
    head["kernel"] = np.zeros_like(head["kernel"])
    head["bias"] = cuboid_vertex_bias(K)
    return params


@pytest.fixture(scope="module")
def msgpack(kitti_tree, tmp_path_factory):  # noqa: F811
    cfg = load_config(str(REPO / "configs" / MODES["host"]), SET)
    K = create_dataset(kitti_tree, cfg, is_training=False, split="test")[0]["calib"].reshape(3, 3)
    _, state = jax_state_with_ema(cfgs()[0])
    state = state.replace(params=cuboid_vertex_head(state.params, K), ema_params=cuboid_vertex_head(state.ema_params, K))
    return ckpt_jax.CheckPointer(str(tmp_path_factory.mktemp("weights"))).save("model_best", state)


@pytest.fixture(scope="module", params=list(MODES))
def runs(request, kitti_tree, msgpack, tmp_path_factory):  # noqa: F811
    mode = request.param
    out = tmp_path_factory.mktemp(mode)
    config = str(REPO / "configs" / MODES[mode])
    common = ["--model-config", config, "--data-path", kitti_tree, "--split", "test", "--checkpoint", msgpack,
              "--batch-size", "2"]
    detect_jax.main(common + ["--out-dir", str(out / "jax"), "--set", *SET])
    port = ["--out-dir", str(out / "port"), "--save-vis", str(out / "vis"), "--device", "cpu", "--set", *SET]
    summary = detect.main(common + port + (["num_workers", "2"] if mode == "device_warp" else []))
    return mode, config, kitti_tree, out, summary


def test_result_files_match_jax(runs):
    mode, _, tree, out, summary = runs
    names = sorted(open(os.path.join(tree, "ImageSets", "test.txt")).read().split())
    assert summary["images"] == len(names) == 3 and summary["img_size"] == [256, 96]
    assert len(summary["batch_s"]) == len(summary["wait_s"]) == 2  # 2 + a padded 1
    assert sorted(os.listdir(out / "port")) == sorted(os.listdir(out / "jax")) == [f"{n}.txt" for n in names]
    cmp = compare_result_dirs(str(out / "jax"), str(out / "port"), names)
    assert cmp["lines"] == cmp["lines_got"] == 30  # every top-K slot, thresholds lifted
    worst = cmp["max_abs"]
    assert cmp["box_agree_share"] == 1.0 and worst["score"] <= 1e-4 + 1e-9 and worst["angle"] <= 0.01 + 1e-9, cmp
    assert worst["dim"] <= 0.01 + 1e-9 and worst["loc"] <= 0.05, cmp
    lo, hi = cmp["depth_range"]
    assert 20 < lo and hi < 30  # converged boxes, near the car the vertices draw


def test_evaluate_matches_jax(runs, capsys):
    _, config, tree, out, _ = runs
    for results in ("port", "jax"):
        argv = ["--model-config", config, "--data-path", tree, "--split", "test", "--out-dir", str(out / results),
                "--skip-detect", "--recall-points", "11"]
        got, want = evaluate.main(argv + ["--device", "cpu"]), evaluate_jax.main(argv)
        assert got == want and len(got) == 36
        assert all(np.isfinite(v) for v in got.values())
    assert '"Car_3d_moderate"' in capsys.readouterr().out


def test_save_vis_writes_the_three_drawings(runs):
    """The input frame (in device-warp mode rebuilt on the host by the same
    affine), the three-row panel and the bird's-eye view, per image."""
    _, _, tree, out, _ = runs
    names = sorted(open(os.path.join(tree, "ImageSets", "test.txt")).read().split())
    from rtm3d_tpu_torch.data.image_io import imread

    for name in names:
        img, panel, bev = (imread(str(out / "vis" / f"{name}{s}.png")) for s in ("", "_panel", "_bev"))
        assert img.shape == (96, 256, 3) and panel.shape == (144, 128, 3) and bev.shape == (400, 400, 3)
        assert img.std() > 0 and bev.std() > 0


