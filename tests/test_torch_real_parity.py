"""The real-data protocol of the port (``rtm3d_tpu_torch/tools/
real_parity.py``) and its reference pipeline (``tools/
reference_pipeline.py``), on the CPU.

- The reference pipeline against the JAX package's test helpers it copies,
  on the same logits and K: ``reference_decode`` against
  ``tests/test_decode_parity.py::_torch_reference_decode`` (every field
  equal) and ``reference_solve`` against ``tests/test_detect_parity.py::
  _scipy_reference_solve`` with that module's priors, ``REF_LOC`` and K
  (equal: the same scipy run on the same numbers).
- The port leg's result files equal ``cli.detect``'s, byte for byte, on the
  same weights, tree and config (ResNet-18, input 128).
- The report contract of tests/test_tools.py:57-72, on a generated tree
  (6 train and 4 test frames of 96x128, max 3 objects), ResNet-18 at
  input 128, weights from seed 7 saved as a ``.pt`` with the vertex head
  drawing a car 100 m ahead (utils/measure.py::cuboid_vertex_bias, so that
  the LM accepts lanes) and the heatmap head's bias 0 (scores about 0.5:
  13 accepted lines on the port leg, 12 on the reference's), score 0.45, top-K 5, bootstrap 10, the dry run's bars
  (min overlap 0.3, min height 0); a partial import refused.
- The dry run's agreement gates (chip_smoke.py's real_parity phase) on
  this tree: each leg's lines against the other's (box to 0.01 px and
  score to 1e-4 on the shared detections, 9 in 10 shared), and each leg's
  3D boxes reprojected with the frame's K onto its 2D boxes within 2 px.
- The frame of the 2D boxes, measured: on KITTI's geometry (20 frames of
  375x1242 at input 1280 under IS_RECT, 1280x416) the ground truth
  written as detections in the original frame (the port's ``real_parity``
  and both detect CLIs) scores 100 in every cell; the same boxes in the
  network's input frame (the JAX tool's ``_detect_jax``/``_detect_torch``
  write the raw decode) score Car/Pedestrian/Cyclist bbox 0.36/0.68/1.79
  at the devkit bars (72.86/12.73/40.18 at the dry run's), bev and 3D
  untouched. On those frames the labels' 3D boxes reproject onto their 2D
  boxes within 1 px (the format's two decimals), and with a yaw turned by
  0.05 rad they part by more than 2 px.
- ``slow``: the JAX tool (``tools/real_parity.run_real_parity``) on the
  same tree and ``.pt``: its reference column equals the port's where the
  boxes need no clipping to the frame (the port writes boxes in the
  original frame, clipped, as cli.detect does; the JAX tool writes them
  unclipped), and the port's AP against the JAX pipeline's within
  tests/test_ap_parity.py:53-60's bound of 15 points.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from rtm3d_tpu_torch.cli.detect import original_frame_boxes
from rtm3d_tpu_torch.data.synthetic import generate_kitti
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.tools import real_parity
from rtm3d_tpu_torch.tools.reference_pipeline import reference_decode, reference_solve
from rtm3d_tpu_torch.utils.measure import compare_result_dirs, cuboid_vertex_bias, reprojection_px

RP = dict(split="test", backbone="RESNET-18", input_size=128, batch=4, score_thresh=0.45, topk=5,
          min_overlap=0.3, min_height=0.0, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A generated tree and a seed-7 ResNet-18 ``.pt`` whose vertex head
    draws a car."""
    root = tmp_path_factory.mktemp("real_parity")
    data = generate_kitti(str(root / "kitti"), num_train=6, num_test=4, img_hw=(96, 128), max_objs=3)
    cfg = real_parity.make_config(data, 128, "RESNET-18", 0.45, 5)
    K = real_parity.create_dataset(data, cfg, is_training=False, split="test")[0]["calib"].reshape(3, 3)
    sd = create_model(cfg, torch.Generator().manual_seed(7)).state_dict()
    sd["detect_header.offset_fr_main_header.offset_fr_main_head.weight"].zero_()
    sd["detect_header.offset_fr_main_header.offset_fr_main_head.bias"].copy_(
        torch.from_numpy(cuboid_vertex_bias(K, depth=100.0)))
    sd["detect_header.main_kf_header.main_kf_head.bias"].fill_(0.0)  # scores about 0.5: peaks pass 0.45
    ckpt = str(root / "model_best.pt")
    torch.save({"model": sd}, ckpt)
    out = real_parity.run_real_parity(data, ckpt, work_dir=str(root / "work"), bootstrap=10,
                                      progress=lambda *a: None, **RP)
    return {"root": root, "data": data, "ckpt": ckpt, "report": out}


def test_reference_decode_equals_the_jax_tests_loop():
    from tests.test_decode_parity import _torch_reference_decode

    rng = np.random.RandomState(3)
    B, C, H, W = 3, 3, 24, 32
    main = np.full((B, C, H, W), -4.0, np.float32)
    for b in range(B):
        for _ in range(rng.randint(1, 6)):
            main[b, rng.randint(C), rng.randint(2, H - 2), rng.randint(2, W - 2)] = rng.uniform(0.5, 4.0)
    logits = (main, rng.randn(B, 16, H, W).astype(np.float32), rng.randn(B, 2, H, W).astype(np.float32),
              rng.randn(B, 2, H, W).astype(np.float32))
    got, want = reference_decode(logits, 0.4, 10), _torch_reference_decode(logits, 0.4, 10)
    assert sum(len(g["cls"]) for g in got) > 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_reference_solve_equals_the_jax_tests_scipy_solve():
    from tests.test_detect_parity import DIM_REF, K_CAM, REF_LOC, _scipy_reference_solve
    rng = np.random.RandomState(0)
    # cars 15-30 m ahead on the optical axis, projected, plus pixel noise
    verts = [cuboid_vertex_bias(K_CAM, down=1.0, depth=d).reshape(8, 2) + K_CAM[:2, 2] + rng.randn(8, 2) * 0.3
             for d in (15.0, 20.0, 25.0, 30.0, 18.0, 22.0)]
    for k in range(6):
        got = reference_solve(k % 3, verts[k], K_CAM, DIM_REF, REF_LOC)
        want = _scipy_reference_solve(k % 3, verts[k], K_CAM)
        assert got["cost"] == want["cost"] and got["ry"] == want["ry"]
        np.testing.assert_array_equal(got["dim"], want["dim"])
        np.testing.assert_array_equal(got["loc"], want["loc"])


def test_port_leg_files_equal_the_detect_cli(tree, tmp_path):
    from rtm3d_tpu_torch.cli import detect as cli_detect

    cfg_path = tmp_path / "cfg.yaml"
    with open(cfg_path, "w") as f:
        yaml.dump({"INPUT_SIZE": "(128, 128)", "IS_RECT": True,
                   "MODEL": {"BACKBONE": "RESNET-18", "KFNs": ["layer1", "layer2", "layer3", "layer4"]},
                   "DATASET": {"MAX_OBJS": 32},
                   "DETECTOR": {"SCORE_THRESH": 0.45, "TOPK_CANDIDATES": 5},
                   "TPU": {"NORMALIZE_ON_DEVICE": False}}, f)
    out_dir = tmp_path / "cli"
    cli_detect.main(["--model-config", str(cfg_path), "--data-path", tree["data"], "--split", "test",
                     "--checkpoint", tree["ckpt"], "--batch-size", "4", "--out-dir", str(out_dir),
                     "--device", "cpu"])
    port_dir = tree["root"] / "work" / "results_port"
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(out_dir)) and len(names) == 4
    lines = 0
    for n in names:
        got, want = (port_dir / n).read_text(), (out_dir / n).read_text()
        assert got == want, n
        lines += len(got.splitlines())
    assert lines == tree["report"]["accepted_counts"]["port"] > 0


def test_report_contract(tree):
    out = tree["report"]
    assert out["config"]["n_images"] == 4 and out["config"]["input"] == [128, 96]
    assert set(out["accepted_counts"]) == {"port", "torch"}
    assert out["accepted_counts"]["port"] > 0 and out["accepted_counts"]["torch"] > 0
    for rp in ("ap_r40", "ap_r11"):
        cells = out[rp]
        assert len(cells) == 27  # 3 classes x 3 metrics x 3 difficulties
        for v in cells.values():
            assert set(v) == {"port", "torch", "delta"}
            assert v["delta"] == pytest.approx(v["port"] - v["torch"], abs=0.011)
    assert out["bootstrap"]["n_images"] == 4 and out["bootstrap"]["n_resamples"] == 10
    assert len([k for k in out["bootstrap"] if k.endswith("_moderate")]) == 9
    assert set(out["bootstrap"]["Car_3d_moderate"]) == {"delta_ci95"}
    assert out["legs"]["port"]["batches"] == 1
    for leg in ("results_port", "results_torch"):
        assert len(os.listdir(tree["root"] / "work" / leg)) == 4


def test_legs_agree_and_their_3d_boxes_reproject(tree):
    names = sorted(open(tree["data"] + "/ImageSets/test.txt").read().split())
    work = tree["root"] / "work"
    for want, got in (("torch", "port"), ("port", "torch")):
        cmp = compare_result_dirs(str(work / f"results_{want}"), str(work / f"results_{got}"), names)
        assert cmp["box_agree_share"] >= 0.9 and cmp["agreed_score"] <= 1e-4 + 1e-9, (want, cmp)
    for leg in ("port", "torch"):
        r = reprojection_px(str(work / f"results_{leg}"), names, tree["data"])
        assert r["lines"] == tree["report"]["accepted_counts"][leg] and r["max_px"] <= 2.0, (leg, r)


def test_input_frame_boxes_cost_a_perfect_detector_its_bbox_ap(tmp_path):
    hw = (375, 1242)
    data = generate_kitti(str(tmp_path / "kitti"), num_train=0, num_test=20, img_hw=hw, max_objs=8)
    cfg = real_parity.make_config(data, 1280, "DLA-34", 0.4, 100)
    ds = real_parity.create_dataset(data, cfg, is_training=False, split="test")
    assert tuple(ds.img_size) == (1280, 416)
    r = ds.resize_max_side / max(hw)
    pad = ((ds.img_size[0] - int(hw[1] * r)) // 2, (ds.img_size[1] - int(hw[0] * r)) // 2)
    legs = {leg: tmp_path / leg for leg in ("port", "torch")}  # the original frame, the input frame
    for d in legs.values():
        d.mkdir()
    for n in open(f"{data}/ImageSets/test.txt").read().split():
        rows = [l.split() for l in open(f"{data}/training/label_2/{n}.txt").read().splitlines()]
        original, scaled = [], []
        for p in rows:
            box = np.asarray(p[4:8], np.float64)
            inp = box * r + np.tile(pad, 2)
            back = original_frame_boxes(inp[None], (hw[1], hw[0]), ds.resize_max_side, ds.img_size)[0]
            np.testing.assert_allclose(back, box, atol=1e-6)  # the input frame is the one the CLIs map back
            original.append(" ".join(p + ["1.0"]))
            scaled.append(" ".join(p[:4] + [f"{v:.2f}" for v in inp] + p[8:] + ["1.0"]))
        (legs["port"] / f"{n}.txt").write_text("\n".join(original) + "\n")
        (legs["torch"] / f"{n}.txt").write_text("\n".join(scaled) + "\n")
    # reprojection_px on KITTI's geometry: the labels' 3D boxes project onto
    # their 2D boxes up to the format's two decimals (0.73 px for a car 9 m
    # ahead); a yaw turned by 0.05 rad moves them by 8.8 px
    names = open(f"{data}/ImageSets/test.txt").read().split()
    gt = reprojection_px(str(legs["port"]), names, data)
    assert gt["lines"] > 20 and gt["max_px"] <= 1.0, gt
    turned = tmp_path / "turned"
    turned.mkdir()
    for n in names:
        rows = [l.split() for l in (legs["port"] / f"{n}.txt").read_text().splitlines()]
        (turned / f"{n}.txt").write_text("".join(" ".join(p[:14] + [f"{float(p[14]) + 0.05:.2f}", p[15]]) + "\n"
                                                 for p in rows))
    assert reprojection_px(str(turned), names, data)["max_px"] > 2.0
    res = {k: str(v) for k, v in legs.items()}
    bars = {"devkit": {}, "dry_run": {"min_overlap": 0.3, "min_height": 0.0}}
    want = {"devkit": {"Car": 0.36, "Pedestrian": 0.68, "Cyclist": 1.79},
            "dry_run": {"Car": 72.86, "Pedestrian": 12.73, "Cyclist": 40.18}}
    for name, kw in bars.items():
        cells = real_parity.score_legs(data, res, split="test", **kw)
        for key, c in cells.items():
            cls, metric, _ = key.split("_")
            assert c["port"] == 100.0, (name, key, c)
            assert c["torch"] == (want[name][cls] if metric == "bbox" else 100.0), (name, key, c)


def test_partial_import_is_refused(tree, tmp_path):
    sd = torch.load(tree["ckpt"], weights_only=True)["model"]
    partial = {k: v for k, v in sd.items() if not k.startswith("detect_header.main_kf")}
    ckpt = str(tmp_path / "partial.pt")
    torch.save(partial, ckpt)
    with pytest.raises(SystemExit, match="partial import"):
        real_parity.run_real_parity(tree["data"], ckpt, work_dir=str(tmp_path / "w"), progress=lambda *a: None, **RP)


@pytest.mark.slow
def test_port_against_the_jax_tool(tree, tmp_path):
    from tools.real_parity import run_real_parity

    jax_out = run_real_parity(tree["data"], tree["ckpt"], split="test", backbone="RESNET-18", input_size=128,
                              batch=4, work_dir=str(tmp_path / "jax"), score_thresh=0.45, topk=5,
                              min_overlap=0.3, min_height=0.0, progress=lambda *a: None)
    port = tree["report"]
    assert jax_out["accepted_counts"]["torch"] == port["accepted_counts"]["torch"]
    clipped = _clipped_boxes(tmp_path / "jax" / "results_torch", tree)
    for rp in ("ap_r40", "ap_r11"):
        for key, cell in port[rp].items():
            if not clipped or "_bbox_" not in key:
                assert cell["torch"] == jax_out[rp][key]["torch"], (rp, key)
            assert abs(cell["port"] - jax_out[rp][key]["jax"]) <= 15.0, (rp, key)


def _clipped_boxes(jax_dir, tree) -> bool:
    """Whether a box of the JAX tool's reference leg leaves the frame."""
    w0, h0 = 128, 96
    for n in os.listdir(jax_dir):
        for line in (jax_dir / n).read_text().splitlines():
            x1, y1, x2, y2 = (float(v) for v in line.split()[4:8])
            if min(x1, y1) < 0 or x2 > w0 - 1 or y2 > h0 - 1:
                return True
    return False
