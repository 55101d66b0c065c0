"""``cli.detect --int8`` and ``cli.evaluate --int8 --int8-guard`` of the port
against the JAX package's CLIs, on the CPU, on tests/test_torch_detect_cli.py's
tree and flax msgpack (its ``SET``: 256x96 frames, batch 2 with a padded
tail, fp32, top-K 10, the thresholds lifted), under the host config.

The JAX CLI calibrates (absmax, the 2 batches of the 3 test frames) and
writes its scales; the port calibrates on its own, and serves the JAX
scales file too. Calibration values within 1e-3 relative
(tests/test_torch_quant.py). Served from the same scales, the lines agree
as far as int8 lets them: the JAX serving program is jitted, and there XLA
divides by the scale as a multiplication by its reciprocal, which rounds a
few inputs in 1e5 to the other integer (the port divides in IEEE
arithmetic, as the JAX package's eager ``_quantized_conv`` does), and an
input near a rounding edge in one stack's fp32 can round the other way. The
random network's heatmap is near flat (scores 0.53-0.55), so score
differences of 1e-3 reorder its top 10. Measured here: 25 of 30 lines with
the same class and box, scores within 0.0048 where they match; held at 80%
and 0.01. The gate's counts: float and int8 detections equal to the JAX
CLI's, matched within one.
"""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest

from rtm3d_tpu.cli import detect as detect_jax
from rtm3d_tpu.train import checkpoint as ckpt_jax
from rtm3d_tpu_torch.cli import detect, evaluate
from rtm3d_tpu_torch.config import load_config
from rtm3d_tpu_torch.data.kitti import create_dataset
from rtm3d_tpu_torch.utils.measure import compare_result_dirs
from tests.test_torch_checkpoint_import import cfgs, jax_state_with_ema
from tests.test_torch_data import REPO, kitti_tree  # noqa: F401
from tests.test_torch_detect_cli import MODES, SET, cuboid_vertex_head

CONFIG = str(REPO / "configs" / MODES["host"])


@pytest.fixture(scope="module")
def msgpack(kitti_tree, tmp_path_factory):  # noqa: F811
    """tests/test_torch_detect_cli.py's weights (its vertex head drawing a
    car), removed after the module: a DLA-34 msgpack with EMA is 457 MB."""
    cfg = load_config(CONFIG, SET)
    K = create_dataset(kitti_tree, cfg, is_training=False, split="test")[0]["calib"].reshape(3, 3)
    _, state = jax_state_with_ema(cfgs()[0])
    state = state.replace(params=cuboid_vertex_head(state.params, K), ema_params=cuboid_vertex_head(state.ema_params, K))
    path = ckpt_jax.CheckPointer(str(tmp_path_factory.mktemp("weights"))).save("model_best", state)
    yield path
    os.remove(path)
GATE = re.compile(r"float 2D detections (\d+), int8 (\d+), matched (\d+) \(recall ([0-9.]+)\)")


def printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


@pytest.fixture(scope="module")
def int8_runs(kitti_tree, msgpack, tmp_path_factory):  # noqa: F811
    out = tmp_path_factory.mktemp("int8")
    common = ["--model-config", CONFIG, "--data-path", kitti_tree, "--split", "test", "--checkpoint", msgpack,
              "--batch-size", "2", "--int8", "--calib-method", "absmax"]
    port = ["--device", "cpu", "--set", *SET]
    _, jax_out = printed(detect_jax.main, common + ["--out-dir", str(out / "jax"), "--calib-scales",
                                                    str(out / "jax_scales.json"), "--set", *SET])
    summary, port_out = printed(detect.main, common + ["--out-dir", str(out / "port"), "--calib-scales",
                                                       str(out / "port_scales.json"), *port])
    _, reload_out = printed(detect.main, common + ["--out-dir", str(out / "port_reload"), "--calib-scales",
                                                   str(out / "port_scales.json"), *port])
    _, jax_scales_out = printed(detect.main, common + ["--out-dir", str(out / "port_jax_scales"), "--calib-scales",
                                                       str(out / "jax_scales.json"), *port])
    names = sorted(open(os.path.join(kitti_tree, "ImageSets", "test.txt")).read().split())
    return {"out": out, "names": names, "jax": jax_out, "port": port_out, "reload": reload_out,
            "jax_scales": jax_scales_out, "summary": summary, "tree": kitti_tree, "common": common, "port_args": port}


def lines(d, name):
    return open(os.path.join(d, f"{name}.txt")).read().splitlines()


def test_int8_detect_serves_2d_and_gates_like_jax(int8_runs):
    r = int8_runs
    out, names = r["out"], r["names"]
    assert r["summary"]["images"] == 3
    assert "int8: serving 2D-only" in r["port"] and "int8: calibrated 58 conv activation scales (absmax)" in r["port"]
    for d in ("jax", "port"):
        assert sorted(os.listdir(out / d)) == [f"{n}.txt" for n in names]
    for n in names:  # 2D lines: the 3D fields carry the KITTI placeholders
        assert len(lines(out / "port", n)) == 10
        assert all(" -1.00 -1.00 -1.00 -1000.00 -1000.00 -1000.00 -10.00 " in l for l in lines(out / "port", n))
    want = [int(v) for v in GATE.search(r["jax"]).groups()[:3]]
    got = [int(v) for v in GATE.search(r["port"]).groups()[:3]]
    assert got[:2] == want[:2] == [30, 30] and abs(got[2] - want[2]) <= 1, (got, want)
    # the scales: the JAX package's keys and values
    js = json.load(open(out / "jax_scales.json"))
    ps = json.load(open(out / "port_scales.json"))
    assert sorted(js) == sorted(ps) and len(ps) == 58
    for k in js:
        np.testing.assert_allclose(ps[k], js[k], rtol=1e-3, err_msg=k)
    # served from the JAX scales, the port writes the JAX CLI's lines
    cmp = compare_result_dirs(str(out / "jax"), str(out / "port_jax_scales"), names)
    assert cmp["lines"] == cmp["lines_got"] == 30 and cmp["box_agree_share"] >= 0.8, cmp
    assert cmp["max_abs"]["score"] <= 0.01, cmp


def test_calib_scales_round_trip(int8_runs):
    """A second run loads the file the first wrote: the same result files,
    and the notice that the gate has no batches to sweep."""
    r = int8_runs
    assert "int8: loaded 58 activation scales" in r["reload"] and "int8 gate skipped" in r["reload"]
    assert "int8 gate (float-reference" not in r["reload"]
    for n in r["names"]:
        assert lines(r["out"] / "port", n) == lines(r["out"] / "port_reload", n)


def test_int8_3d_anyway_solves_in_3d(int8_runs):
    r = int8_runs
    out = r["out"] / "port_3d"
    detect.main(r["common"] + ["--out-dir", str(out), "--int8-3d-anyway", "--int8-no-gate", "--calib-scales",
                               str(r["out"] / "port_scales.json"), *r["port_args"]])
    for n in r["names"]:
        ls = lines(out, n)
        assert len(ls) == 10 and not any("-1000.00" in l for l in ls)
        depth = [float(l.split()[13]) for l in ls]
        assert all(np.isfinite(depth))


def test_evaluate_int8_guard(int8_runs, capsys):
    r = int8_runs
    argv = ["--model-config", CONFIG, "--data-path", r["tree"], "--split", "test", "--checkpoint",
            r["common"][r["common"].index("--checkpoint") + 1], "--batch-size", "2", "--int8", "--device", "cpu",
            "--out-dir", str(r["out"] / "eval"), "--set", *SET]
    got = evaluate.main(argv + ["--int8-guard", "100"])
    assert sorted(got) == ["delta", "float", "int8"]
    assert all(len(t) == 36 and all(np.isfinite(v) for v in t.values()) for t in got.values())
    assert got["delta"] == {k: round(got["int8"][k] - got["float"][k], 2) for k in got["int8"]}
    assert os.path.isdir(str(r["out"] / "eval_fp")) and "int8 - float AP deltas" in capsys.readouterr().out
    # a guard that no table can meet: the WARNING, exit code 3, the tables kept
    with pytest.raises(evaluate.Int8GuardTripped) as tripped:
        evaluate.main(argv + ["--int8-guard", "-1"])
    assert tripped.value.code == 3 and tripped.value.results["delta"] == got["delta"]
    assert "WARNING: int8 drops moderate AP" in capsys.readouterr().out


def test_int8_refuses_an_export(tmp_path):
    with pytest.raises(ValueError, match="export holds no int8 program"):
        detect.main(["--model-config", CONFIG, "--device", "cpu", "--int8", "--from-export", str(tmp_path / "m.pt2")])
