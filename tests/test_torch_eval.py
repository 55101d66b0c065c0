"""The port's KITTI writer and AP evaluator against the JAX package's.

Labels and results are written from seeded numpy: Car, Pedestrian and
Cyclist boxes across the difficulty buckets (heights, truncation and
occlusion), Van and Person_sitting neighbours, DontCare regions, and
detections that perturb the ground truth in 2D and 3D plus false positives.
The AP tables must equal the JAX evaluator's to 1e-12 for every class x
metric x difficulty, R40 and R11, AOS included: the port's host C++ overlap
against the JAX package's native library, the port's plain (pure-Python)
overlap against the JAX package's Python fallback.
"""

import os

import numpy as np
import pytest

from rtm3d_tpu.eval import ap as ap_jax
from rtm3d_tpu.eval import kitti_writer as writer_jax
from rtm3d_tpu_torch.data.synthetic import generate_kitti
from rtm3d_tpu_torch.eval import ap
from rtm3d_tpu_torch.eval import kitti_writer as writer
from rtm3d_tpu_torch.eval import timing
from rtm3d_tpu_torch.utils import kernel_build

CLASSES = ("Car", "Pedestrian", "Cyclist")
NAMES = [f"{i:06d}" for i in range(12)]
DIMS = {"Car": (1.53, 1.63, 3.88), "Van": (2.21, 1.90, 5.08), "Pedestrian": (1.76, 0.66, 0.84),
        "Person_sitting": (1.27, 0.59, 0.80), "Cyclist": (1.74, 0.60, 1.76)}


def _line(name, trunc, occ, alpha, box, dim, loc, ry, score=None):
    s = (f"{name} {trunc:.2f} {occ} {alpha:.2f} {box[0]:.2f} {box[1]:.2f} {box[2]:.2f} {box[3]:.2f} "
         f"{dim[0]:.2f} {dim[1]:.2f} {dim[2]:.2f} {loc[0]:.2f} {loc[1]:.2f} {loc[2]:.2f} {ry:.2f}")
    return s if score is None else s + f" {score:.4f}"


def _objects(rng):
    """One image's ground truth: (type, trunc, occ, alpha, box, dim, loc, ry)."""
    objs = []
    for _ in range(rng.randint(3, 9)):
        name = ["Car", "Car", "Pedestrian", "Cyclist", "Van", "Person_sitting"][rng.randint(6)]
        dim = np.array(DIMS[name]) * rng.uniform(0.9, 1.1, 3)
        loc = np.array([rng.uniform(-12, 12), rng.uniform(1.0, 2.0), rng.uniform(6, 45)])
        ry = rng.uniform(-np.pi, np.pi)
        x1, y1 = rng.uniform(0, 1100), rng.uniform(100, 300)
        h = 700.0 / loc[2] * dim[0]  # heights across the 25 / 40 px buckets
        box = [x1, y1, x1 + h * dim[2] / dim[0] * rng.uniform(0.4, 1.0), y1 + h]
        objs.append((name, float(rng.choice([0.0, 0.1, 0.3, 0.6])), int(rng.randint(0, 4)),
                     writer.alpha_from_ry(ry, loc[0], loc[2]), box, dim, loc, ry))
    if rng.rand() < 0.7:
        x1, y1 = rng.uniform(0, 1000), rng.uniform(120, 250)
        objs.append(("DontCare", -1.0, -1, -10.0, [x1, y1, x1 + rng.uniform(30, 120), y1 + rng.uniform(20, 60)],
                     np.array([-1.0] * 3), np.array([-1000.0] * 3), -10.0))
    return objs


def write_tree(root, seed=0):
    """``root/label_2`` and ``root/results`` for ``NAMES`` (the last image
    has no result file); returns ``(gt_dir, det_dir)``."""
    rng = np.random.RandomState(seed)
    gt_dir, det_dir = os.path.join(root, "label_2"), os.path.join(root, "results")
    os.makedirs(gt_dir), os.makedirs(det_dir)
    for n, name in enumerate(NAMES):
        objs = _objects(rng)
        with open(os.path.join(gt_dir, f"{name}.txt"), "w") as f:
            f.write("\n".join(_line(*o) for o in objs) + "\n")
        if n == len(NAMES) - 1:
            continue
        dets = []
        for (t, _, _, _, box, dim, loc, ry) in objs:
            if t == "DontCare" or rng.rand() < 0.15:
                continue
            t = {"Van": "Car", "Person_sitting": "Pedestrian"}.get(t, t) if rng.rand() < 0.5 else t
            b = np.array(box) + rng.normal(0, 2, 4)
            d = dim * rng.uniform(0.95, 1.05, 3)
            lo = loc + rng.normal(0, 0.12, 3)
            r = ry + rng.normal(0, 0.15)
            dets.append((t, 0.0, 0, writer.alpha_from_ry(r, lo[0], lo[2]), b, d, lo, r, rng.uniform(0.05, 1.0)))
        for _ in range(rng.randint(0, 4)):  # false positives, some tied scores
            x1, y1 = rng.uniform(0, 1100), rng.uniform(100, 300)
            dets.append((CLASSES[rng.randint(3)], 0.0, 0, 0.3, [x1, y1, x1 + 60, y1 + 45], np.array([1.5, 1.6, 3.9]),
                         np.array([rng.uniform(-10, 10), 1.5, rng.uniform(8, 40)]), 0.1, float(rng.choice([0.5, 0.25]))))
        with open(os.path.join(det_dir, f"{name}.txt"), "w") as f:
            f.write("\n".join(_line(*d) for d in dets) + ("\n" if dets else ""))
    return gt_dir, det_dir


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(str(tmp_path_factory.mktemp("ap")))


def table(evaluate, gt_dir, det_dir, recall_points, **kw):
    out = {}
    for cls in CLASSES:
        for metric in ("bbox", "bev", "3d"):
            for diff in ("easy", "moderate", "hard"):
                args = dict(class_name=cls, metric=metric, difficulty=diff, recall_points=recall_points, **kw)
                if metric == "bbox":
                    out[f"{cls}_bbox_{diff}"], out[f"{cls}_aos_{diff}"] = evaluate(
                        gt_dir, det_dir, NAMES, with_aos=True, **args)
                else:
                    out[f"{cls}_{metric}_{diff}"] = evaluate(gt_dir, det_dir, NAMES, **args)
    return out


@pytest.mark.parametrize("recall_points", [40, 11])
@pytest.mark.parametrize("impl", ["cpp", "plain"])
def test_ap_table_matches_jax(tree, monkeypatch, recall_points, impl):
    if impl == "plain":  # the JAX package's own Python fallback
        monkeypatch.setattr(ap_jax, "_geom_lib", lambda: None)
    want = table(ap_jax.evaluate_directories, *tree, recall_points)
    got = table(ap.evaluate_directories, *tree, recall_points, impl=impl)
    assert got.keys() == want.keys() and len(got) == 36
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
    # the table is not degenerate: detections score, and not all perfectly
    assert 0 < np.mean(list(got.values())) < 1
    assert sum(0 < v < 1 for v in got.values()) >= 12


def test_ground_truth_scores_100(tree, tmp_path):
    """Each label file written back as results with score 1.0 scores 100 on
    every key with a valid ground-truth box (and so does its AOS)."""
    gt_dir, _ = tree
    det_dir = str(tmp_path / "gt_as_results")
    os.makedirs(det_dir)
    for name in NAMES:
        lines = [l for l in open(os.path.join(gt_dir, f"{name}.txt")).read().splitlines() if l]
        lines = [l + " 1.0000" for l in lines if l.split()[0] in CLASSES]
        open(os.path.join(det_dir, f"{name}.txt"), "w").write("\n".join(lines) + "\n")
    got = table(ap.evaluate_directories, gt_dir, det_dir, 40)
    scored = 0
    for cls in CLASSES:
        for diff in ("easy", "moderate", "hard"):
            if ap.evaluate_directories(gt_dir, det_dir, NAMES, class_name=cls, metric="bbox", difficulty=diff) == 0.0:
                continue  # no valid ground truth in this bucket
            scored += 1
            for m in ("bbox", "aos", "bev", "3d"):
                assert got[f"{cls}_{m}_{diff}"] == pytest.approx(1.0, abs=1e-12), (cls, m, diff)
    assert scored >= 6


def test_val_scale_tree_scores_as_the_jax_evaluator(tmp_path):
    """eval/timing.py's tree at 12 frames: a labels-only synthetic tree and
    result files of 30 lines a frame (perturbed labels, then random boxes),
    whose table the port scores as the JAX evaluator does, to 1e-12."""
    root = str(tmp_path / "ev")
    generate_kitti(root, 0, len(NAMES), timing.KITTI_HW, max_objs=8, seed=20, images=False)
    assert not os.path.exists(os.path.join(root, "training", "image_2"))
    gt_dir, det_dir = os.path.join(root, "training", "label_2"), os.path.join(root, "results")
    assert timing.write_results_tree(gt_dir, det_dir, NAMES, list(CLASSES), 30, 20) == 30 * len(NAMES)
    want = table(ap_jax.evaluate_directories, gt_dir, det_dir, 40)
    got = table(ap.evaluate_directories, gt_dir, det_dir, 40)
    assert got.keys() == want.keys() and len(got) == 36
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
    assert sum(v > 0 for v in got.values()) >= 6  # the perturbed labels score


def test_val_scale_timing_gives_one_table_by_both_routes(tmp_path):
    root = tmp_path / "t"
    rec = timing.main(["--frames", "6", "--dets", "20", "--root", str(root), "--out", str(tmp_path / "t.json")])
    assert rec["tables_equal"] and len(rec["table_cpp"]) == 36 and rec["result_lines"] == 120
    assert rec["overlaps"] > 0 and rec["cpp_s"] > 0 and rec["plain_s"] > 0
    assert not root.exists() and os.path.exists(tmp_path / "t.json")


def test_overlap_library_matches_plain_and_jax():
    rng = np.random.RandomState(3)
    n = 40
    a = np.c_[rng.uniform(-8, 8, (n, 2)), rng.uniform(0.5, 5, (n, 2)), rng.uniform(-np.pi, np.pi, n)]
    b = a[: n // 2] + np.c_[rng.normal(0, 0.7, (n // 2, 2)), rng.normal(0, 0.3, (n // 2, 2)),
                            rng.normal(0, 0.4, n // 2)]
    b[0] = a[0]  # identical boxes
    b[1, 4] = a[1, 4] + np.pi / 2  # a quarter turn
    a, b = a.astype(np.float32), b.astype(np.float32)
    got = ap.bev_intersection_matrix(a, b)
    plain = ap.bev_intersection_matrix(a, b, impl="plain")
    assert got.dtype == np.float32 and got.shape == (n, n // 2)
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got, ap_jax.bev_intersection_matrix(a, b))
    assert (got > 0).mean() > 0.05 and got[0, 0] == pytest.approx(a[0, 2] * a[0, 3], rel=1e-6)
    assert ap.bev_intersection_matrix(a[:0], b).shape == (0, n // 2)
    with pytest.raises(ValueError, match="impl"):
        ap.bev_intersection_matrix(a, b, impl="native")


def test_overlap_library_is_built_from_the_port_and_a_failed_build_raises(tmp_path, monkeypatch):
    """The library comes from csrc/geometry.cc into _build/, never from
    native/; it is no CUDA source; and with no working compiler the
    evaluator raises instead of dropping to Python."""
    lib = kernel_build.host_library_path("geometry")
    assert lib.parent == kernel_build.BUILD_DIR and lib.name.startswith("geometry-")
    assert "geometry" not in kernel_build.kernel_names()
    ap.bev_intersection_matrix(np.ones((1, 5), np.float32), np.ones((1, 5), np.float32))
    assert lib.exists() and ap._geometry()._name == str(lib)

    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(kernel_build, "find_cxx", lambda: "false")  # a compiler that always fails
    monkeypatch.setattr(ap, "_GEOM_LIB", None)
    with pytest.raises(RuntimeError, match="build failed"):
        ap.bev_intersection_matrix(np.ones((1, 5), np.float32), np.ones((1, 5), np.float32))
    # the plain version needs no library
    assert ap.bev_intersection_matrix(np.ones((1, 5), np.float32), np.ones((1, 5), np.float32), impl="plain")[0, 0] == 1.0


def _detections(rng, B=2, K=6, with_3d=True):
    det = {
        "cls": rng.randint(0, 3, (B, K)).astype(np.int32),
        "scores": rng.uniform(0, 1, (B, K)).astype(np.float32),
        "accepted": rng.rand(B, K) < 0.6,
        "bbox2d": np.sort(rng.uniform(0, 1200, (B, K, 4)).astype(np.float32), axis=-1)[..., [0, 1, 2, 3]],
    }
    if with_3d:
        det.update(ry=rng.uniform(-4, 4, (B, K)).astype(np.float32),
                   dim=rng.uniform(0.5, 5, (B, K, 3)).astype(np.float32),
                   loc=np.c_[rng.uniform(-20, 20, (B * K, 1)), rng.uniform(-2, 3, (B * K, 1)),
                             rng.uniform(-5, 60, (B * K, 1))].reshape(B, K, 3).astype(np.float32))
    return det


@pytest.mark.parametrize("with_3d", [True, False], ids=["3d", "2d_only"])
def test_writer_matches_jax(tmp_path, with_3d):
    rng = np.random.RandomState(7)
    det = _detections(rng, with_3d=with_3d)
    names = ["Car", "Pedestrian", "Cyclist"]
    for i in range(2):
        got, want = writer.detections_to_lines(det, names, i), writer_jax.detections_to_lines(det, names, i)
        assert got == want and len(got) == int(det["accepted"][i].sum())
        writer.write_results(str(tmp_path / "port"), f"im{i}", got)
        writer_jax.write_results(str(tmp_path / "jax"), f"im{i}", want)
        assert open(tmp_path / "port" / f"im{i}.txt").read() == open(tmp_path / "jax" / f"im{i}.txt").read()
    for ry, x, z in rng.uniform(-10, 10, (50, 3)):
        assert writer.alpha_from_ry(ry, x, z) == writer_jax.alpha_from_ry(ry, x, z)
    writer.write_results(str(tmp_path / "port"), "empty", [])
    assert open(tmp_path / "port" / "empty.txt").read() == ""
