"""The four tools that read a production work dir
(``rtm3d_tpu_torch/tools/{diag_same_weights,solver_tune,precision_ladder,
int8_variants}.py``) against the JAX tools, on the CPU.

The work dir: the campaign's fixture (4 train frames of 96x128, input 128,
so 128x96) and the JAX ``init_model`` weights of ResNet-18 (seed 0) as the
JAX tools read them (``jax_final.pkl``) and as the port's read them
(``port_final.pt``, through ``state_dict_from_jax``). The vertex head
draws a car 25 m ahead on the optical axis (``utils/measure.py::
cuboid_vertex_bias``), so the LM converges, and the heatmap head's bias is
0, so that the top-K peaks pass the 0.25 score gate.

- ``diag_same_weights``: the JAX tool (its ``main``) and the port's on the
  same weights and frames: the same matched candidates, row by row, with
  the same classes, accept decisions and flips; scores within 1e-4, and
  each pipeline's vertices within 1e-4 px of its reference decode.
- ``solver_tune``: on the diag file's rows (the vertices and K the LM
  solved) the deployed variant (40 iterations, prior 20) gives the diag's
  LM costs within 1e-5, and its accept decisions.
- ``precision_ladder``: its ``fp32`` rung writes the lines of
  ``results_port`` byte for byte; the report's rungs and keys.
- ``int8_variants``: each skip policy zeroes the same scales as the JAX
  tool's ``policy_scales`` on the same keys, and the quantized network's
  int8 convs are the rest; the calibration sweep's rows are the JAX
  tool's; every row of a policy sweep carries its kernels' launches, one
  of each int8 kernel per int8 conv per batch (counted on the CPU where
  the card counts launches).
- Each tool's entry point runs on the card unless told ``--device cpu``:
  with no GPU it raises.
"""

import json
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from rtm3d_tpu.nn.model import init_model
from rtm3d_tpu_torch.nn import quant
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.ops import int8_conv, lm_solver
from rtm3d_tpu_torch.tools import (
    ap_parity, diag_same_weights, int8_variants, precision_ladder, real_parity, solver_tune,
)
from rtm3d_tpu_torch.train.checkpoint import state_dict_from_jax
from rtm3d_tpu_torch.utils.measure import cuboid_vertex_bias
from tools import ap_parity as ap_jax
from tools import diag_same_weights as diag_jax
from tools import int8_variants as int8_variants_jax

SIZE, BATCH = 128, 4
TOOL = dict(input_size=SIZE, batch=BATCH, eval_split="train", device="cpu")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The work dir, with the port's float and reference legs served."""
    root = str(tmp_path_factory.mktemp("prod"))
    data = ap_parity.fixture(root, SIZE, 4, 1, seed=20)
    cfg_jax = ap_jax.make_config(data, SIZE, BATCH, 1e-3)
    _, variables = init_model(cfg_jax, jax.random.PRNGKey(0), input_size=(SIZE, 96))
    variables = jax.tree_util.tree_map(np.array, jax.device_get(variables))
    K = open(os.path.join(data, "training", "calib", "000000.txt")).read().split()[1:]
    K = np.array(K, np.float32).reshape(3, 4)[:, :3]
    header = variables["params"]["detect_header"]
    header["offset_fr_main"]["head"]["conv"]["kernel"][...] = 0.0
    header["offset_fr_main"]["head"]["conv"]["bias"][...] = cuboid_vertex_bias(K)
    header["main_kf"]["head"]["conv"]["bias"][...] = 0.0
    with open(os.path.join(root, "jax_final.pkl"), "wb") as f:
        pickle.dump(variables, f)
    model = create_model(ap_parity.make_config(data, SIZE, BATCH, 1e-3))
    torch.save(state_dict_from_jax(variables, model), os.path.join(root, "port_final.pt"))
    cfg, model, ds = diag_same_weights.load_work_dir(root, SIZE, BATCH, "train")
    real_parity.detect_port(cfg, model, ds, BATCH, os.path.join(root, "results_port"), torch.device("cpu"))
    real_parity.detect_reference(cfg, model, ds, os.path.join(root, "results_torch"))
    return root


def test_diag_matches_the_jax_diag(work, monkeypatch):
    out_jax = os.path.join(work, "diag_jax.json")
    monkeypatch.setattr(sys, "argv", ["diag_same_weights", "--work-dir", work, "--input-size", str(SIZE),
                                      "--batch", str(BATCH), "--out", out_jax])
    diag_jax.main()
    want = json.load(open(out_jax))
    got = diag_same_weights.run(work, out=os.path.join(work, "diag.json"), say=lambda *a: None, **TOOL)
    s, w = got["summary"], want["summary"]
    assert set(s) == set(w)
    assert s["n_matched"] == w["n_matched"] >= 40 and s["unmatched"] == w["unmatched"]
    for k in ("gate_flips", "flips_lm_rejected_scipy_accepted", "flips_scipy_rejected_lm_accepted",
              "accepted_jax", "accepted_torch"):
        assert s[k] == w[k], k
    assert s["accepted_jax"] > 0 and got["config"]["frames"] == 4
    for r, q in zip(got["rows"], want["rows"]):
        assert (r["img"], r["cls"], r["acc_j"], r["acc_t"]) == (q["img"], q["cls"], q["acc_j"], q["acc_t"])
        assert abs(r["score_j"] - q["score_j"]) < 1e-4 and abs(r["score_t"] - q["score_t"]) < 1e-4
        assert r["dvert"] < 1e-4 and q["dvert"] < 1e-4
    assert set(json.load(open(os.path.join(work, "diag.json")))) == {"summary", "rows", "config"}


def test_solver_tune_deployed_row_is_the_diag_lm(work):
    diag = os.path.join(work, "diag_tune.json")
    rows = diag_same_weights.run(work, out=diag, say=lambda *a: None, **TOOL)["rows"]
    got = solver_tune.run(diag, out=os.path.join(work, "tune.json"), say=lambda *a: None, device="cpu")
    assert got["matched"] == len(rows) > 0
    assert list(got["variants"]) == [v[0] for v in solver_tune.VARIANTS] and len(got["variants"]) == 7
    deployed = got["variants"]["kernel it40 prior20 (deployed)"]
    assert deployed["deployed_vs_diag_max_abs"] <= 1e-5
    assert deployed["accepted"] == sum(r["acc_j"] for r in rows)


def test_precision_ladder_fp32_rung_is_results_port(work):
    got = precision_ladder.run(work, say=lambda *a: None, **TOOL)
    assert set(got) == {"eval_split", "torch_accepted", "card", "fp32", "tf32", "bf16"}
    names = sorted(os.listdir(os.path.join(work, "results_port")))
    for n in names:
        assert open(os.path.join(work, "results_port_fp32", n)).read() == open(
            os.path.join(work, "results_port", n)).read(), n
    assert got["fp32"]["accepted"] == real_parity.count_accepted(os.path.join(work, "results_port")) > 0
    assert got["bf16"]["compute_dtype"] == "bfloat16" and got["tf32"]["tf32"]
    assert json.load(open(os.path.join(work, "precision_ladder.json")))["fp32"]["accepted"] == got["fp32"]["accepted"]


def test_int8_policies_skip_the_same_convs_as_jax(work):
    cfg, model, _ = diag_same_weights.load_work_dir(work, SIZE, BATCH, "train")
    scales = {k: 1.0 for k in quant.conv_paths(model).values()}
    for policy in int8_variants.POLICIES:
        got = int8_variants.policy_scales(scales, policy)
        want = int8_variants_jax.policy_scales(scales, policy)
        assert got == want, policy
        assert int8_variants.int8_convs(quant.quantize_model(model, got)) == sum(v > 0 for v in got.values())
    zeroed = {p: sum(v == 0 for v in int8_variants.policy_scales(scales, p).values())
              for p in int8_variants.POLICIES}
    assert zeroed["full"] == 0 < zeroed["float-head"] < zeroed["float-vertex"] < zeroed["float-header"]
    assert int8_variants.variants(True) == [  # the JAX tool's --calib-sweep grid
        (m, pc, p) for m in ("absmax", "p99.9", "p99.99", "mse") for pc in (False, True)
        for p in ("full", "float-head")] + [("p99.9", False, "float-vertex"), ("mse", False, "float-vertex")]


def test_int8_variants_rows_count_their_launches(work, monkeypatch):
    def counter(fn):
        def wrapped(*args, **kwargs):
            wrapped.launches += 1
            return fn(*args, **kwargs)

        wrapped.launches = 0
        return wrapped

    monkeypatch.setattr(int8_conv, "quantize", counter(int8_conv.quantize))
    monkeypatch.setattr(int8_conv, "conv_s8", counter(int8_conv.conv_s8))
    monkeypatch.setattr(lm_solver, "lm_solve", counter(lm_solver.lm_solve))
    got = int8_variants.run(work, say=lambda *a: None, **TOOL)
    rows = {k: v for k, v in got.items() if isinstance(v, dict) and "launches" in v}
    assert list(rows) == [f"absmax_{p}" for p in int8_variants.POLICIES]
    for name, r in rows.items():
        n = r["int8_convs"] * r["batches"]
        assert r["batches"] == 1 and r["int8_convs"] > 0, name
        assert r["launches"] == {"conv_s8": n, "quantize": n, "lm": 2 * r["batches"]}, name
    assert rows["absmax_full"]["int8_convs"] > rows["absmax_float-header"]["int8_convs"]


@pytest.mark.parametrize("tool, argv", [
    (ap_parity, ["--production"]), (diag_same_weights, ["--work-dir", "w"]), (solver_tune, ["--diag", "d.json"]),
    (precision_ladder, ["--work-dir", "w"]), (int8_variants, ["--work-dir", "w"])],
    ids=["ap_parity", "diag_same_weights", "solver_tune", "precision_ladder", "int8_variants"])
def test_entry_points_ask_for_the_card(tool, argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        tool.main(argv)
    assert os.listdir(tmp_path) == []
