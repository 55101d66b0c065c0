"""Card tests of the production same-weights campaign and the side-by-side
mode (``rtm3d_tpu_torch/tools/ap_parity.py``) and of the four tools that
read a campaign's work dir, through the kernels.

Like tests/test_torch_cuda.py this file imports neither JAX nor the JAX
package; on a machine with a CUDA device, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_prod.py -q

Without a device every ``cuda``-marked test skips with its reason.

- A small campaign (input 128, 8 train frames, 20 steps at b4, ResNet-18):
  one splat launch a step, 2 LM launches a port and int8 batch, one
  ``quantize`` and one ``conv_s8`` launch an int8 conv an int8 batch.
- The four tools on a work dir whose peaks pass the score gate (seed-0
  ResNet-18, the vertex head drawing a car, the heatmap bias 0), the
  card's port leg against the reference pipeline on the host: every
  candidate matched, scores within 1e-3 and vertices within 0.05 px
  (``chip_smoke.py``'s ap_parity_tools gates); solver_tune's deployed row
  equal to diag's LM costs within 1e-5; the ladder's fp32 rung writing the
  port leg's lines; each int8 variant's launches.
- A small side-by-side run (input 128, 8 train and 4 test frames, 6 steps
  at b4, ResNet-18): one splat launch a step in the port's step and one
  in the reference leg's target build; the port leg trained under TF32,
  the reference leg with TF32 off, as the flags read inside each leg; 2
  LM launches a port, int8 and samew batch; one ``quantize`` and one
  ``conv_s8`` launch an int8 conv an int8 batch.
"""

import os

import numpy as np
import pytest
import torch

from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.tools import (
    ap_parity, diag_same_weights, int8_variants, precision_ladder, real_parity, solver_tune,
)
from rtm3d_tpu_torch.utils.measure import cuboid_vertex_bias

SIZE, BATCH = 128, 4
TOOL = dict(input_size=SIZE, batch=BATCH, eval_split="train", say=lambda *a: None)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the GPU paths have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_campaign_launches_its_kernels(cuda, tmp_path):
    out = ap_parity.run_production_parity(str(tmp_path), input_size=SIZE, num_train=8, num_test=2, steps=20,
                                          batch=BATCH, save_every=10, train_augment=False, eval_split="train",
                                          progress=lambda *a: None)
    train, legs = out["train"], out["legs"]
    assert train["steps_run"] == train["splat_launches"] == 20 and train["tf32"]["cudnn"]
    assert out["loss_first_last"][1] < out["loss_first_last"][0]
    for leg in ("port", "int8"):
        assert legs[leg]["batches"] == 2 and legs[leg]["lm_launches"] == 4, leg
    n = legs["int8"]["int8_convs"] * legs["int8"]["batches"]
    assert n > 0 and legs["int8"]["conv_s8_launches"] == legs["int8"]["quantize_launches"] == n
    assert out["config"]["card"]["name"] == torch.cuda.get_device_name(cuda)


@pytest.mark.cuda
def test_tools_on_a_detecting_work_dir(cuda, tmp_path):
    work = str(tmp_path)
    data = ap_parity.fixture(work, SIZE, 8, 1, seed=20)
    K = np.array(open(os.path.join(data, "training", "calib", "000000.txt")).read().split()[1:],
                 np.float32).reshape(3, 4)[:, :3]
    sd = create_model(ap_parity.make_config(data, SIZE, BATCH, 1e-3), torch.Generator().manual_seed(0)).state_dict()
    sd["detect_header.offset_fr_main_header.offset_fr_main_head.weight"].zero_()
    sd["detect_header.offset_fr_main_header.offset_fr_main_head.bias"].copy_(torch.from_numpy(cuboid_vertex_bias(K)))
    sd["detect_header.main_kf_header.main_kf_head.bias"].fill_(0.0)
    torch.save(sd, os.path.join(work, "port_final.pt"))
    cfg, model, ds = diag_same_weights.load_work_dir(work, SIZE, BATCH, "train")
    with ap_parity.tf32_mode(False):
        real_parity.detect_port(cfg, model, ds, BATCH, os.path.join(work, "results_port"), cuda)
    real_parity.detect_reference(cfg, model, ds, os.path.join(work, "results_torch"))

    diag = diag_same_weights.run(work, out=os.path.join(work, "diag.json"), **TOOL)
    s = diag["summary"]
    assert s["n_matched"] > 0 and s["unmatched"] == {"jax_only": 0, "torch_only": 0}
    assert s["max_dscore"] <= 1e-3 and s["max_dvert_px"] <= 0.05
    assert diag["config"]["lm_launches"] == 2 * 2  # 8 frames at b4

    tune = solver_tune.run(os.path.join(work, "diag.json"), say=lambda *a: None)
    assert tune["matched"] == s["n_matched"]
    variants = tune["variants"]
    assert variants["kernel it40 prior20 (deployed)"]["deployed_vs_diag_max_abs"] <= 1e-5
    assert variants["kernel it40 prior20 (deployed)"]["lm_launches"] == 2
    assert variants["plain it40 prior0"]["lm_launches"] == 0 and variants["kernel it40 prior0"]["lm_launches"] == 1

    ladder = precision_ladder.run(work, **TOOL)
    for name in os.listdir(os.path.join(work, "results_port")):
        assert open(os.path.join(work, "results_port_fp32", name)).read() == open(
            os.path.join(work, "results_port", name)).read(), name
    assert all(ladder[r]["lm_launches"] == 4 for r in precision_ladder.RUNGS)

    rows = {k: v for k, v in int8_variants.run(work, **TOOL).items() if isinstance(v, dict) and "launches" in v}
    assert len(rows) == 4
    for name, r in rows.items():
        n = r["int8_convs"] * r["batches"]
        assert n > 0 and r["launches"] == {"conv_s8": n, "quantize": n, "lm": 2 * r["batches"]}, name


@pytest.mark.cuda
def test_side_by_side_launches_its_kernels(cuda, tmp_path):
    out = ap_parity.run_ap_parity(str(tmp_path), input_size=SIZE, num_train=8, num_test=4, steps=6, batch=BATCH,
                                  save_every=3, progress=lambda *a: None)
    train, legs = out["train"], out["legs"]
    assert train["steps_run"] == 6 and train["port"]["splat_launches"] == train["torch"]["splat_launches"] == 6
    assert train["port"]["tf32"] == {"cudnn": True, "matmul": True}
    assert train["torch"]["tf32"] == {"cudnn": False, "matmul": False}
    assert out["loss_drift_curve"][0] < 5e-3 and out["config"]["card"]["name"] == torch.cuda.get_device_name(cuda)
    for leg in ("port", "int8", "samew"):
        assert legs[leg]["batches"] == 1 and legs[leg]["lm_launches"] == 2, leg
    n = legs["int8"]["int8_convs"] * legs["int8"]["batches"]
    assert n > 0 and legs["int8"]["conv_s8_launches"] == legs["int8"]["quantize_launches"] == n
    assert set(out["ap"]["Car_bbox_moderate"]) == {"port", "torch", "delta", "int8", "delta_int8", "samew",
                                                   "delta_samew"}
