"""Weights into the port: flax msgpack files of the JAX package read without
flax, the suffix-matched import of a partial ``.pt``, and the EMA that a port
``CheckPointer`` file serves.

- A full msgpack written by the JAX ``CheckPointer.save`` with an EMA shadow
  that differs from the parameters gives exactly ``state_dict_from_jax`` of
  the EMA variables (the JAX detect CLI prefers the EMA); without an EMA,
  of the parameters.
- A ``strip_checkpoint`` deploy file (bfloat16 by default) round-trips bit
  for bit; flax's chunked leaves, numpy scalars and complex numbers decode
  as flax decodes them.
- ``import_reference_weights`` on a backbone-only ``.pt`` (keys without the
  ``backbone.`` prefix) loads what the JAX ``import_torch_weights`` loads,
  key for key, with the same count missed.
- A port ``CheckPointer`` file serves its EMA through
  ``Detector.from_config`` (a model read with its raw parameters would
  serve other weights).
- The port's ``strip_checkpoint`` of a port file holds the EMA and the BN
  statistics cast to bfloat16 (or float32 as they are), no optimizer
  state, and ``load_detect_weights`` serves it; of the same weights as the
  JAX strip (the fixture's EMA through ``state_dict_from_jax``) it equals
  that strip bit for bit.
"""

import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from rtm3d_tpu.config import default_config as default_config_jax
from rtm3d_tpu.train import checkpoint as ckpt_jax
from rtm3d_tpu.train.optim import build_optimizer
from rtm3d_tpu.train.state import TrainState as TrainStateJax
from rtm3d_tpu_torch.api import Detector
from rtm3d_tpu_torch.cli import train as cli_train
from rtm3d_tpu_torch.config import default_config
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.train import checkpoint as ckpt
from rtm3d_tpu_torch.train.state import TrainState
from tests.test_torch_model import jax_variables

SIZE = ["INPUT_SIZE", "(64, 64)"]


def cfgs():
    return default_config_jax().merge_from_list(list(SIZE)), default_config().merge_from_list(list(SIZE))


def jax_state_with_ema(cfg_jax, seed=1):
    """A JAX train state whose EMA shadow differs from its parameters."""
    _, variables = jax_variables(cfg_jax, seed=seed)
    tx, _ = build_optimizer(cfg_jax, variables["params"])
    state = TrainStateJax.create(variables, tx, with_ema=True)
    rng = np.random.RandomState(seed)
    ema = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) * (1 + 0.05 * rng.standard_normal(p.shape))).astype(np.float32), state.params)
    return variables, state.replace(ema_params=ema)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    cfg_jax, cfg = cfgs()
    variables, state = jax_state_with_ema(cfg_jax)
    d = tmp_path_factory.mktemp("msgpack")
    full = ckpt_jax.CheckPointer(str(d)).save("model_best", state, epoch=3, min_loss=1.5)
    no_ema = ckpt_jax.CheckPointer(str(d)).save("model_no_ema", state.replace(ema_params=None))
    stripped = ckpt_jax.strip_checkpoint(full, str(d / "deploy.msgpack"))
    return cfg, variables, state, full, no_ema, stripped


def assert_state_dicts_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_full_msgpack_serves_the_ema(saved):
    cfg, variables, state, full, no_ema, _ = saved
    model = create_model(cfg)
    got, used_ema = ckpt.load_flax_checkpoint(full, model)
    want = ckpt.state_dict_from_jax({"params": jax.device_get(state.ema_params),
                                     "batch_stats": variables["batch_stats"]}, model)
    assert used_ema
    assert_state_dicts_equal(got, want)
    raw = ckpt.state_dict_from_jax(variables, model)
    assert not torch.equal(got["backbone.base_layer.0.weight"], raw["backbone.base_layer.0.weight"])

    got, used_ema = ckpt.load_flax_checkpoint(no_ema, model)
    assert not used_ema
    assert_state_dicts_equal(got, raw)
    payload = ckpt.read_flax_msgpack(full)
    assert payload["epoch"] == 3 and payload["min_loss"] == 1.5 and int(payload["state"]["step"]) == 0


def test_stripped_bf16_file_round_trips_bit_for_bit(saved):
    cfg, variables, state, _, _, stripped = saved
    tree = ckpt.read_flax_msgpack(stripped)
    want = serialization.msgpack_restore(open(stripped, "rb").read())
    flat_got, flat_want = ckpt._flatten(tree), ckpt._flatten(want)
    assert flat_got.keys() == flat_want.keys() and len(flat_got) > 100
    n_bf16 = 0
    for k, w in flat_want.items():
        g = flat_got[k]
        if w.dtype.name == "bfloat16":
            n_bf16 += 1
            assert g.dtype == torch.bfloat16 and g.shape == w.shape
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), np.asarray(w).view(np.int16), err_msg=str(k))
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(k))
    assert n_bf16 == len(jax.tree_util.tree_leaves(state.params)) + 2 * len(
        jax.tree_util.tree_leaves(variables["batch_stats"])) // 2
    model = create_model(cfg)
    sd, used_ema = ckpt.load_flax_checkpoint(stripped, model)
    model.load_state_dict(sd, strict=True)
    # the deploy file holds the EMA as its params, each float32 value the
    # bfloat16 one exactly
    wants = ckpt.state_dict_from_jax(
        jax.tree_util.tree_map(lambda a: np.asarray(a).astype(np.float32), want), model)
    assert not used_ema
    assert_state_dicts_equal(sd, wants)


def test_chunked_leaves_scalars_and_complex_decode_as_in_flax(tmp_path, monkeypatch):
    import jax.numpy as jnp

    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)  # bytes: every array below is chunked
    rng = np.random.RandomState(0)
    tree = {"a": {"w": rng.standard_normal((7, 9)).astype(np.float32),
                  "b": np.asarray(jnp.asarray(rng.standard_normal((5, 13)), jnp.bfloat16))},
            "i": np.arange(40, dtype=np.int32), "s": np.float32(2.5), "n": np.int64(-3), "c": complex(1.5, -2.0),
            "e": {}, "f": 0.25, "t": "text"}
    path = tmp_path / "chunked.msgpack"
    path.write_bytes(serialization.msgpack_serialize(tree))
    got, want = ckpt.read_flax_msgpack(str(path)), serialization.msgpack_restore(path.read_bytes())
    np.testing.assert_array_equal(got["a"]["w"], want["a"]["w"])
    np.testing.assert_array_equal(got["a"]["b"].view(torch.int16).numpy(), want["a"]["b"].view(np.int16))
    np.testing.assert_array_equal(got["i"], want["i"])
    assert got["a"]["w"].shape == (7, 9) and got["a"]["b"].shape == (5, 13)
    assert got["s"] == want["s"] == np.float32(2.5) and got["s"].dtype == np.float32
    assert got["n"] == -3 and got["c"] == complex(1.5, -2.0) and got["e"] == {} and got["f"] == 0.25
    assert got["t"] == "text"


def test_orbax_directory_and_missing_file(tmp_path, capsys):
    model = create_model(cfgs()[1])
    with pytest.raises(NotImplementedError, match="queue A: Data-parallel"):
        ckpt.load_detect_weights(str(tmp_path), model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    line = ckpt.load_detect_weights(str(tmp_path / "absent.msgpack"), model)
    assert "not found" in line and "not found" in capsys.readouterr().out
    assert_state_dicts_equal(model.state_dict(), before)


def test_backbone_only_pt_loads_by_suffix_as_in_jax(saved, tmp_path):
    cfg, variables = saved[:2]
    source = create_model(cfg, torch.Generator().manual_seed(5))
    path = str(tmp_path / "backbone.pt")
    torch.save(source.backbone.state_dict(), path)  # keys without "backbone."

    model = create_model(cfg, torch.Generator().manual_seed(6))
    report = ckpt.import_reference_weights(model, ckpt.load_torch_weights(path)[0])
    imported, report_jax = ckpt_jax.import_torch_weights(variables, ckpt_jax.load_torch_state_dict(path))

    assert sorted(report["loaded"]) == sorted(report_jax["loaded"])
    assert len(report["missed"]) == len(report_jax["missed"]) > 0
    assert sorted(report["missed"]) == sorted(report_jax["missed"])
    backbone = [k for k in source.backbone.state_dict() if not k.endswith("num_batches_tracked")]
    assert len(report["loaded"]) == len(backbone)
    got, want = model.state_dict(), ckpt.state_dict_from_jax(imported, model)
    for key, _ in report["loaded"]:
        assert torch.equal(got[key], want[key]), key
        assert torch.equal(got[key], source.backbone.state_dict()[key[len("backbone."):]]), key
    fresh = create_model(cfg, torch.Generator().manual_seed(6)).state_dict()
    for key in report["missed"]:
        assert torch.equal(got[key], fresh[key]), key  # left as it was


def test_pretrained_mode_imports_by_suffix(tmp_path, capsys):
    cfg = cfgs()[1]
    source = create_model(cfg, torch.Generator().manual_seed(5))
    path = str(tmp_path / "backbone.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in source.backbone.state_dict().items()}}, path)
    cfg.TRAINING.CHECKPOINT_MODE, cfg.TRAINING.CHECKPOINT_FILE = "pretrained", path
    mode, state = cli_train._model_state(cfg, 20, "cpu", 10)
    assert mode == "pretrained" and "missed" in capsys.readouterr().out
    got = state.model.state_dict()
    for k, v in source.backbone.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[f"backbone.{k}"], v), k


def test_port_checkpoint_serves_its_ema(tmp_path):
    """The EMA repair: a port CheckPointer file through Detector.from_config
    serves the EMA shadow laid over the parameters, as the JAX detect does."""
    cfg = cfgs()[1]
    cfg.DETECTOR.TOPK_CANDIDATES, cfg.DETECTOR.SOLVER_ITERS = 8, 4
    state = TrainState.create(create_model(cfg, torch.Generator().manual_seed(3)), cfg, device="cpu", with_ema=True)
    with torch.no_grad():
        for v in state.ema.values():
            v.mul_(1.1).add_(0.01)
    path = ckpt.CheckPointer(str(tmp_path)).save("model_best", state)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text("INPUT_SIZE: (64, 64)\nDETECTOR:\n  TOPK_CANDIDATES: 8\n  SOLVER_ITERS: 4\n")

    rng = np.random.RandomState(0)
    images = (rng.rand(2, 64, 64, 3) * 255).astype(np.uint8)
    K = np.tile(np.array([[60.0, 0, 32], [0, 60, 32], [0, 0, 1]], np.float32), (2, 1, 1))
    served = Detector.from_config(str(cfg_path), checkpoint=path, device="cpu")(images, K)
    ema = Detector(cfg, {k: v.clone() for k, v in state.eval_variables().items()}, device="cpu")(images, K)
    raw = Detector(cfg, state.model.state_dict(), device="cpu")(images, K)
    for k in ema:
        np.testing.assert_array_equal(served[k], ema[k], err_msg=k)
    assert not np.array_equal(served["scores"], raw["scores"])

    sd, used_ema = ckpt.load_torch_weights(path)
    assert used_ema and torch.equal(sd["backbone.base_layer.0.weight"], state.ema["backbone.base_layer.0.weight"])
    # a reference file (its weights under "model", DataParallel names) is
    # served as it stands, with no EMA
    ref_path = str(tmp_path / "reference.pt")
    torch.save({"model": {f"module.{k}": v for k, v in state.model.state_dict().items()}, "epoch": 3}, ref_path)
    ref_sd, ref_ema = ckpt.load_torch_weights(ref_path)
    assert not ref_ema and ref_sd.keys() == state.model.state_dict().keys()
    assert torch.equal(ref_sd["backbone.base_layer.0.weight"], state.model.state_dict()["backbone.base_layer.0.weight"])
    assert os.path.basename(open(tmp_path / "last_checkpoint").read()) == "model_best.pt"


def port_state_of(cfg, variables, state):
    """A port train state holding the JAX ``state``'s parameters and BN
    statistics, with its EMA shadow."""
    model = create_model(cfg)
    model.load_state_dict(ckpt.state_dict_from_jax(variables, model))
    port = TrainState.create(model, cfg, device="cpu", with_ema=True)
    ema = ckpt.state_dict_from_jax({"params": jax.device_get(state.ema_params),
                                    "batch_stats": variables["batch_stats"]}, model)
    with torch.no_grad():
        for k, v in port.ema.items():
            v.copy_(ema[k])
    return port, ema


@pytest.mark.parametrize("dtype", ["bfloat16", ""])
def test_strip_checkpoint_keeps_the_ema_and_bn_statistics(saved, tmp_path, dtype):
    cfg, variables, state = saved[:3]
    port, ema = port_state_of(cfg, variables, state)
    src = ckpt.CheckPointer(str(tmp_path)).save("model_best", port)
    dst = ckpt.strip_checkpoint(src, str(tmp_path / "deploy.pt"), dtype=dtype)
    got = torch.load(dst, weights_only=True)
    want_dtype = torch.bfloat16 if dtype else torch.float32
    assert got.keys() == port.model.state_dict().keys()
    for k, v in port.model.state_dict().items():
        want = ema[k] if k in port.ema else v
        if v.dtype == torch.float32:
            assert got[k].dtype == want_dtype and torch.equal(got[k], want.to(want_dtype)), k
        else:
            assert torch.equal(got[k], v), k
    assert os.path.getsize(dst) < os.path.getsize(src) / (3 if dtype else 1.5)  # no optimizer state
    model = create_model(cfg, torch.Generator().manual_seed(9))
    line = ckpt.load_detect_weights(dst, model)
    assert line.startswith(f"imported {len(got) - sum(k.endswith('num_batches_tracked') for k in got)} tensors; 0")
    for k, v in model.state_dict().items():
        assert torch.equal(v, got[k].to(v.dtype)), k


def test_strip_checkpoint_equals_the_jax_strip(saved, tmp_path):
    cfg, variables, state, _, _, stripped = saved
    port, _ = port_state_of(cfg, variables, state)
    src = ckpt.CheckPointer(str(tmp_path)).save("model_best", port)
    got = torch.load(ckpt.strip_checkpoint(src, str(tmp_path / "deploy.pt")), weights_only=True)
    # the JAX deploy file's bfloat16 leaves, as float32 values (exact)
    want, used_ema = ckpt.load_flax_checkpoint(stripped, create_model(cfg))
    assert not used_ema and got.keys() == want.keys()
    for k in want:
        if not k.endswith("num_batches_tracked"):
            assert got[k].dtype == torch.bfloat16 and torch.equal(got[k].float(), want[k]), k
    with pytest.raises(ValueError, match="not a torch floating dtype"):
        ckpt.strip_checkpoint(src, str(tmp_path / "x.pt"), dtype="int8")
