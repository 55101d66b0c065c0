"""``rtm3d_tpu_torch.cli.export`` and serving from its artifact, on the CPU.

ResNet-18 at 64x64, the small model of the JAX package's export tests
(tests/test_export.py:17), with the weights of one flax msgpack that both
packages read.

- The artifact (a ``torch.export`` program, forward or ``--with-decode``,
  at fp32 and bf16) served through ``make_detect_step_from_export`` gives
  the eager detect step's detections bit for bit: the same ATen operations
  on the same weights, cast as the eager step casts them.
- The forward artifact's logits against the JAX CLI's StableHLO artifact of
  the same msgpack, on the same frames: atol 1e-5, rtol 1e-5 (measured
  8.9e-7 on logits up to 0.59), the tolerance tests/test_torch_resnet.py
  holds the eager model to.
- ``cli.detect --from-export`` writes files byte-identical to the
  from-model run (the contract of tests/test_export.py:37-60), and the
  artifact's batch overrides ``--batch-size``.
- ``--platforms cpu,cuda`` gives a graph that names no device, and the
  export refuses one that does (a tensor made on the export's device, the
  trap ``decode/peaks.py`` had); ``load_exported`` refuses a device the
  artifact was not made for.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtm3d_tpu.cli import export as export_jax
from rtm3d_tpu.train import checkpoint as ckpt_jax
from rtm3d_tpu.train.optim import build_optimizer
from rtm3d_tpu.train.state import TrainState as TrainStateJax
from rtm3d_tpu_torch.cli import detect as cli_detect
from rtm3d_tpu_torch.cli import export
from rtm3d_tpu_torch.config import load_config
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.train.checkpoint import load_detect_weights
from rtm3d_tpu_torch.train.step import make_detect_step, make_detect_step_from_export
from tests.test_torch_data import REPO, kitti_tree  # noqa: F401
from tests.test_torch_resnet import resnet_cfgs
from tests.test_torch_model import jax_variables

CONFIG = str(REPO / "configs" / "rtm3d_resnet18_kitti.yaml")
SET = ["INPUT_SIZE", "(64, 64)", "DETECTOR.TOPK_CANDIDATES", "10", "DETECTOR.SCORE_THRESH", "0.0",
       "DETECTOR.RESIDUAL_THRESH", "1e9"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def msgpack(tmp_path_factory):
    cfg_jax, _ = resnet_cfgs()
    _, variables = jax_variables(cfg_jax, seed=6)
    tx, _ = build_optimizer(cfg_jax, variables["params"])
    d = tmp_path_factory.mktemp("weights")
    return ckpt_jax.CheckPointer(str(d)).save("model_best", TrainStateJax.create(variables, tx, with_ema=False))


def frames(seed=0, b=2):
    rng = np.random.RandomState(seed)
    K = np.tile(np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]], np.float32), (b, 1, 1))
    return rng.randint(0, 256, (b, 64, 64, 3)).astype(np.uint8), K


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_decode", [False, True])
def test_artifact_equals_the_eager_detect_step(msgpack, tmp_path, dtype, with_decode):
    cfg = load_config(CONFIG, SET + ["TPU.COMPUTE_DTYPE", dtype])
    path = str(tmp_path / "model.pt2")
    rec = export.main(["--model-config", CONFIG, "--output", path, "--checkpoint", msgpack, "--batch-size", "2",
                       "--device", "cpu", "--set", *SET, "TPU.COMPUTE_DTYPE", dtype]
                      + (["--with-decode"] if with_decode else []))
    assert rec["batch"] == 2 and rec["input_hw"] == [64, 64] and rec["with_decode"] == with_decode
    assert rec["platforms"] == ["cpu"] and rec["bytes"] == os.path.getsize(path)
    model = create_model(cfg)
    load_detect_weights(msgpack, model)
    eager = make_detect_step(model, cfg, with_3d=True, device="cpu")
    exported = export.load_exported(path, "cpu")
    served = make_detect_step_from_export(exported, cfg, device="cpu")
    x, K = frames()
    want, got = eager(x, K), served(x, K)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert want["accepted"].any()


def test_forward_artifact_matches_the_jax_artifact(msgpack, tmp_path):
    jax_path, path = str(tmp_path / "model.stablehlo"), str(tmp_path / "model.pt2")
    export_jax.main(["--model-config", CONFIG, "--output", jax_path, "--checkpoint", msgpack, "--batch-size", "2",
                     "--set", *SET, "TPU.S2D_STEM", "False"])
    export.main(["--model-config", CONFIG, "--output", path, "--checkpoint", msgpack, "--batch-size", "2",
                 "--device", "cpu", "--set", *SET])
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    want = export_jax.load_exported(jax_path).call(jnp.asarray(x))
    with torch.no_grad():
        got = export.load_exported(path, "cpu")(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2), atol=1e-5, rtol=1e-5)


def test_detect_from_export_writes_the_same_files(kitti_tree, msgpack, tmp_path, capsys):  # noqa: F811
    """Three test frames: from the model at batch 2 (a padded tail), from
    the artifact (batch 2, asked for 5)."""
    common = ["--model-config", CONFIG, "--data-path", kitti_tree, "--split", "test", "--device", "cpu"]
    lifted = [*SET[2:], "INPUT_SIZE", "(192, 192)"]
    model_dir, export_dir = tmp_path / "model", tmp_path / "export"
    summary = cli_detect.main(common + ["--checkpoint", msgpack, "--batch-size", "2", "--out-dir", str(model_dir),
                                        "--set", *lifted])
    w, h = summary["img_size"]
    art = str(tmp_path / "detect.pt2")
    export.main(["--model-config", CONFIG, "--output", art, "--checkpoint", msgpack, "--batch-size", "2",
                 "--with-decode", "--device", "cpu", "--set", *lifted, "INPUT_SIZE", f"({w}, {h})"])
    capsys.readouterr()
    served = cli_detect.main(common + ["--from-export", art, "--batch-size", "5", "--out-dir", str(export_dir),
                                       "--set", *lifted])
    assert "from-export: artifact batch is 2, overriding --batch-size" in capsys.readouterr().out
    assert len(served["batch_s"]) == 2 and served["images"] == 3
    names = sorted(os.listdir(model_dir))
    assert len(names) == 3 and sorted(os.listdir(export_dir)) == names
    for n in names:
        assert (model_dir / n).read_bytes() == (export_dir / n).read_bytes(), n
    with pytest.raises(ValueError, match="takes 64x64 frames"):
        small = str(tmp_path / "small.pt2")
        export.main(["--model-config", CONFIG, "--output", small, "--checkpoint", msgpack, "--device", "cpu",
                     "--set", *SET])
        cli_detect.main(common + ["--from-export", small, "--out-dir", str(tmp_path / "x"), "--set", *lifted])


def test_platforms_need_a_device_free_graph(msgpack, tmp_path, monkeypatch):
    cfg = load_config(CONFIG, SET)
    model = create_model(cfg)
    ep, meta = export.export_detect(model, cfg, 1, True, "cpu", ["cpu", "cuda"])
    assert meta["platforms"] == ["cpu", "cuda"] and export.graph_devices(ep) == []
    path = str(tmp_path / "one.pt2")
    export.save_exported(ep, meta, path)
    assert export.load_exported(path, "cpu").platforms == ["cpu", "cuda"]
    with pytest.raises(ValueError, match="not for meta"):
        export.load_exported(path, "meta")

    decode = export.decode_detections

    def decode_on_a_device(logits, **kw):  # the trap: a tensor made on the input's device
        det = decode(logits, **kw)
        det["scores"] = det["scores"] + torch.zeros((), device=logits[0].device)
        return det

    monkeypatch.setattr(export, "decode_detections", decode_on_a_device)
    ep, meta = export.export_detect(model, cfg, 1, True, "cpu")
    assert meta["platforms"] == ["cpu"] and export.graph_devices(ep)
    with pytest.raises(ValueError, match="names a device"):
        export.export_detect(model, cfg, 1, True, "cpu", ["cpu", "cuda"])
