"""Card tests of the detect-from-files slice: ``cli.detect`` on the GPU
against the same CLI on the CPU, and the AP evaluator's host C++ overlap
library built and loaded on the card's machine.

Like tests/test_torch_cuda.py this file imports neither JAX nor the JAX
package; on a machine with a CUDA device, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_detect.py -q

Without a device every ``cuda``-marked test skips with its reason.
"""

import os

import numpy as np
import pytest
import torch

from rtm3d_tpu_torch.cli import detect, evaluate
from rtm3d_tpu_torch.config import load_config
from rtm3d_tpu_torch.data.kitti import create_dataset
from rtm3d_tpu_torch.data.synthetic import generate_kitti
from rtm3d_tpu_torch.eval import ap
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.ops import lm_solver
from rtm3d_tpu_torch.utils.measure import compare_result_dirs, cuboid_vertex_bias

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SET = ["INPUT_SIZE", "(256, 256)", "DATASET.MAX_OBJS", "8", "DETECTOR.TOPK_CANDIDATES", "10",
       "DETECTOR.SCORE_THRESH", "0.0", "DETECTOR.RESIDUAL_THRESH", "1e9", "TPU.COMPUTE_DTYPE", "float32",
       "num_workers", "2"]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the GPU paths have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_detect_cli_gpu_matches_cpu(cuda, tmp_path):
    """Device-warp mode, 5 test frames at batch 2 (a padded tail): 2 LM
    launches per batch on the GPU, a result file per frame, and the lines of
    the CPU run, with weights whose vertex head draws a car (the LM
    converges) and TF32 off."""
    tree = generate_kitti(str(tmp_path / "kitti"), 2, 5, (64, 192), max_objs=4, seed=3)
    config = os.path.join(REPO, "configs", "rtm3d_dla34_kitti_tpu.yaml")
    cfg = load_config(config, SET)
    K = create_dataset(tree, cfg, is_training=False, split="test")[0]["calib"].reshape(3, 3)
    model = create_model(cfg, torch.Generator().manual_seed(1))
    with torch.no_grad():
        head = model.detect_header.offset_fr_main_header.offset_fr_main_head
        head.weight.zero_()
        head.bias.copy_(torch.from_numpy(cuboid_vertex_bias(K)))
    weights = str(tmp_path / "weights.pt")
    torch.save(model.state_dict(), weights)
    argv = ["--model-config", config, "--data-path", tree, "--checkpoint", weights, "--batch-size", "2"]
    was = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lm_solver.lm_solve.launches = 0
        gpu = detect.main(argv + ["--out-dir", str(tmp_path / "gpu"), "--set", *SET])
        launches = lm_solver.lm_solve.launches
        detect.main(argv + ["--out-dir", str(tmp_path / "cpu"), "--device", "cpu", "--set", *SET])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = was
    assert gpu["images"] == 5 and gpu["img_size"] == [256, 96] and len(gpu["batch_s"]) == 3
    assert launches == 2 * 3
    names = sorted(open(os.path.join(tree, "ImageSets", "test.txt")).read().split())
    assert sorted(os.listdir(tmp_path / "gpu")) == [f"{n}.txt" for n in names]
    cmp = compare_result_dirs(str(tmp_path / "cpu"), str(tmp_path / "gpu"), names)
    assert cmp["lines"] == cmp["lines_got"] == 50 and cmp["box_agree_share"] >= 0.99, cmp
    assert cmp["max_abs"]["dim"] <= 0.01 + 1e-9 and cmp["max_abs"]["loc"] <= 0.05, cmp
    table = evaluate.main(["--model-config", config, "--data-path", tree, "--out-dir", str(tmp_path / "gpu"),
                           "--skip-detect"])
    assert len(table) == 36 and all(np.isfinite(v) for v in table.values())


@pytest.mark.cuda
def test_overlap_library_builds_on_the_card_machine(cuda):
    rng = np.random.RandomState(0)
    a = np.c_[rng.uniform(-8, 8, (30, 2)), rng.uniform(0.5, 5, (30, 2)), rng.uniform(-3, 3, 30)].astype(np.float32)
    b = (a[:12] + rng.normal(0, 0.5, (12, 5))).astype(np.float32)
    got = ap.bev_intersection_matrix(a, b)
    assert os.path.dirname(ap._geometry()._name).endswith("_build")
    np.testing.assert_allclose(got, ap.bev_intersection_matrix(a, b, impl="plain"), rtol=0, atol=1e-5)
    assert (got > 0).any()
