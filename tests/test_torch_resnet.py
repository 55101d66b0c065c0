"""The port's ResNet backbones against the JAX package's, on the CPU, and
the ResNet-18 config through the port's trainer and detector.

Weights come from the JAX ``init`` with BN statistics drawn at random
(tests/test_torch_model.py's ``jax_variables``), carried across by
``state_dict_from_jax`` with ``strict=True``; inputs are drawn with numpy.

Tolerances, each measured here first:
- ``PoseResNet`` features at 64x64 b2, depths 18 and 50: in eval mode
  atol 1e-5, rtol 1e-5 (measured max |d| 1.8e-6); in train mode, where
  BatchNorm normalises layer4 by the 8 values a channel has at 2x2,
  within 2e-3 of each map's largest |value| (measured 1.4e-5 at depth 18,
  9.6e-4 at depth 50, in layer4: the float32 noise of a variance of 8
  values); the BN running statistics after one train forward atol 2e-4
  (measured 3.6e-7 at depth 18, 8.6e-5 at depth 50);
- RTM3D ResNet-18 logits at 64x64: atol 1e-5, rtol 1e-5 (measured 6.6e-7
  on logits up to 0.33; the precedent of test_model_parity.py:242 is atol
  5e-2, rtol 1e-2);
- one train step at 64x64 b2, the JAX side in float64 as in
  tests/test_torch_train.py: the port's float32 gradient per tensor within
  1e-3 of JAX's in L2 (measured at most 2.9e-5), the header's 8
  stop-gradient biases exactly 0 on both sides; then the step's loss and
  aux rel 1e-5 (measured 1.6e-7, 7.2e-7), BN running statistics atol 1e-5
  (measured 3.0e-7).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtm3d_tpu.config import default_config as default_config_jax
from rtm3d_tpu.nn.resnet import PoseResNet as PoseResNetJax
from rtm3d_tpu.train import checkpoint as ckpt_jax
from rtm3d_tpu.train import optim as optim_jax
from rtm3d_tpu.train.state import TrainState as TrainStateJax
from rtm3d_tpu.train.step import _loss_from_batch as loss_from_batch_jax
from rtm3d_tpu.train.step import make_train_step as make_train_step_jax
from rtm3d_tpu_torch.api import Detector
from rtm3d_tpu_torch.cli import detect as cli_detect
from rtm3d_tpu_torch.cli import evaluate as cli_evaluate
from rtm3d_tpu_torch.cli import train as cli_train
from rtm3d_tpu_torch.config import default_config, load_config
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.nn.resnet import PoseResNet, built_layers
from rtm3d_tpu_torch.train import checkpoint as ckpt
from rtm3d_tpu_torch.train import optim
from rtm3d_tpu_torch.train.state import TrainState
from rtm3d_tpu_torch.train.step import _loss_from_batch, _to_device, make_train_step
from tests.test_checkpoint import _torch_resnet18
from tests.test_torch_data import REPO, kitti_tree  # noqa: F401
from tests.test_torch_model import jax_variables
from tests.test_torch_train import by_port_name, make_batch

KFNS = ["layer1", "layer2", "layer3", "layer4"]
CONFIG = str(REPO / "configs" / "rtm3d_resnet18_kitti.yaml")
# the shipped ResNet-18 config at a CPU size: only the size, the batch, the
# loader and the log dir move
SMALL = ["INPUT_SIZE", "(192, 192)", "BATCH_SIZE", "2", "DATASET.MAX_OBJS", "8", "num_workers", "0",
         "TRAINING.LOGDIR", "''"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def randomised_stats(variables, seed):
    rng = np.random.RandomState(seed)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                (rng.normal(0, 0.02, v.shape) if k == "mean" else rng.uniform(0.9, 1.1, v.shape)).astype(np.float32)
                for k, v in tree.items()}

    return walk(variables)


def jax_backbone(depth, kfns, hw=64):
    model = PoseResNetJax(depth=depth, kfns=tuple(kfns))
    variables = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3))))
    return model, {"params": variables["params"], "batch_stats": randomised_stats(variables["batch_stats"], depth)}


@pytest.mark.parametrize("depth", [18, 50])
@pytest.mark.parametrize("train", [False, True])
def test_features_and_bn_statistics_match_jax(depth, train):
    model, variables = jax_backbone(depth, KFNS)
    port = PoseResNet(depth, KFNS)
    port.load_state_dict(ckpt.state_dict_from_jax(variables, port), strict=True)
    port.train(train)
    x = np.random.RandomState(depth).randn(2, 64, 64, 3).astype(np.float32)
    if train:
        want, upd = jax.jit(lambda v, x: model.apply(v, x, train=True, mutable=["batch_stats"]))(variables, x)
    else:
        want = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape == (2, 64 * (4 if depth == 50 else 1) * 2**i, 16 // 2**i, 16 // 2**i)
        if train:
            assert np.abs(g.numpy() - w).max() <= 2e-3 * np.abs(w).max(), f"layer{i + 1}"
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5, err_msg=f"layer{i + 1}")
    if train:
        sd = ckpt.state_dict_from_jax({"params": variables["params"], "batch_stats": jax.device_get(upd)["batch_stats"]},
                                      port)
        stats = [(k, b) for k, b in port.named_buffers() if k.endswith(("running_mean", "running_var"))]
        assert len(stats) == 2 * (20 if depth == 18 else 53)
        for k, buf in stats:
            np.testing.assert_allclose(buf.numpy(), sd[k].numpy(), atol=2e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("kfns", [["layer2", "layer3"], ["layer1"], ["layer1", "layer3"], ["layer4"],
                                  ["layer2", "layer4"]])
def test_early_exit_builds_the_layers_jax_builds(kfns):
    """``if layer_name not in kfns and idx >= len(kfns): break``
    (rtm3d_tpu/nn/resnet.py:115-116) decides which layers exist, so the
    parameter sets are equal key for key, and the features too (["layer4"]
    builds layer1 alone and returns nothing, as in JAX)."""
    model, variables = jax_backbone(18, kfns)
    port = PoseResNet(18, kfns)
    names = {ckpt._to_dotted(p) for col in ("params", "batch_stats") for p in ckpt._flatten(variables[col])}
    assert {k for k in port.state_dict() if not k.endswith("num_batches_tracked")} == names
    assert sorted({k.split(".")[0] for k in names if k.startswith("layer")}) == built_layers(kfns)
    port.load_state_dict(ckpt.state_dict_from_jax(variables, port), strict=True)
    x = np.random.RandomState(1).randn(1, 64, 64, 3).astype(np.float32)
    want = model.apply(variables, x, train=False)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == sum(k in kfns for k in built_layers(kfns))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2), atol=1e-5, rtol=1e-5)


def resnet_cfgs(hw=64):
    out = []
    for cfg in (default_config_jax(), default_config()):
        cfg.INPUT_SIZE = (hw, hw)
        cfg.MODEL.BACKBONE = "RESNET-18"
        cfg.MODEL.KFNs = list(KFNS)
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def resnet18():
    cfg_jax, cfg = resnet_cfgs()
    model, variables = jax_variables(cfg_jax, seed=4)
    port = create_model(cfg)
    port.load_state_dict(ckpt.state_dict_from_jax(variables, port), strict=True)
    return cfg_jax, cfg, model, variables, port.eval()


def test_rtm3d_resnet18_logits_match_jax(resnet18):
    _, _, model, variables, port = resnet18
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32) * 0.5
    want = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    for name, g, w in zip(("main_kf", "offset_fr_main", "main_offset", "vertex_offset"), got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5, err_msg=name)


def test_init_and_param_groups_match_jax(resnet18):
    """The port's own init draws from the JAX distributions (per conv
    kernel of >= 1000 values, the largest magnitude within 20% of JAX's),
    and every parameter falls in the JAX group of its flax leaf."""
    _, cfg, _, variables, _ = resnet18
    port = create_model(cfg, torch.Generator().manual_seed(1))
    sd = port.state_dict()
    jax_params = {ckpt._to_dotted(p): v for p, v in ckpt._flatten(variables["params"]).items()}
    checked = 0
    for k, v in jax_params.items():
        if v.size >= 1000 and k.endswith("weight") and v.ndim == 4:
            assert 0.8 < sd[k].abs().max().item() / np.abs(v).max() < 1.25, k
            checked += 1
    assert checked > 40 and any(k.startswith("backbone.layer4.0.downsample.0") for k in jax_params)
    want = {ckpt._to_dotted(p): g for p, g in
            ckpt._flatten(jax.device_get(optim_jax.param_groups(variables["params"]))).items()}
    assert optim.param_groups(port, ()) == want


def test_train_step_matches_jax(resnet18):
    cfg_jax, cfg, model, variables, _ = resnet18
    for c in (cfg_jax, cfg):
        c.BATCH_SIZE, c.DATASET.MAX_OBJS = 2, 6
        c.SOLVER.BASE_LR, c.SOLVER.WARMUP_ITERS, c.TPU.DONATE = 1e-3, 2, False
    batch = make_batch(5)
    f64 = lambda tree: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64) if a.dtype == np.float32 else jnp.asarray(a), tree)
    with jax.enable_x64():
        v64 = f64(variables)
        loss_fn = loss_from_batch_jax(model, cfg_jax, v64["params"], v64["batch_stats"], f64(batch), train=True)
        grads = jax.device_get(jax.jit(jax.grad(loss_fn, has_aux=True))(v64["params"])[0])
        tx, _ = optim_jax.build_optimizer(cfg_jax, v64["params"])
        s1, want = make_train_step_jax(model, cfg_jax, tx)(TrainStateJax.create(v64, tx, with_ema=True), f64(batch))
        s1, want = jax.device_get(s1), jax.device_get(want)

    port = create_model(cfg)
    port.load_state_dict(ckpt.state_dict_from_jax(variables, port), strict=True)
    loss, _ = _loss_from_batch(port.train(), cfg, _to_device(batch, torch.device("cpu")))
    loss.backward()
    g_jax = by_port_name(grads, port, variables["batch_stats"])
    stopped = {k for k, p in port.named_parameters() if p.grad is None}
    # the header's ConvLevel biases (stop_bias_grad), exactly 0 in JAX
    assert len(stopped) == 8 and {k for k, g in g_jax.items() if not g.any()} == stopped
    for k, p in port.named_parameters():
        if k not in stopped:
            assert np.linalg.norm(p.grad.numpy() - g_jax[k]) <= 1e-3 * np.linalg.norm(g_jax[k]), k

    # the step from the same weights and statistics (the forward above
    # folded the batch into port's)
    port = create_model(cfg)
    port.load_state_dict(ckpt.state_dict_from_jax(variables, port), strict=True)
    state = TrainState.create(port, cfg, device="cpu", with_ema=True)
    state, got = make_train_step(cfg, device="cpu")(state, batch)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["loss_items"].numpy(), want["loss_items"], rtol=1e-5)
    sd = ckpt.state_dict_from_jax({"params": s1.params, "batch_stats": s1.batch_stats}, state.model)
    stats = [(k, b) for k, b in state.model.named_buffers() if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 40
    for k, buf in stats:
        np.testing.assert_allclose(buf.numpy(), sd[k].numpy(), atol=1e-5, rtol=0, err_msg=k)


def test_torchvision_backbone_imports_key_for_key_as_jax(resnet18):
    """A torchvision-layout ResNet-18 trunk (keys without ``backbone.``, its
    BN statistics drawn at random), built as tests/test_checkpoint.py:128-205
    builds it, imported by suffix: the same (model key, source key) pairs as
    the JAX ``import_torch_weights``, and the same misses (the KFPN and the
    header)."""
    _, cfg, _, variables, _ = resnet18
    torch.manual_seed(3)
    net = _torch_resnet18()
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0, 0.02)
                mod.running_var.uniform_(0.8, 1.2)
    sd = dict(net.state_dict())
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 512), torch.zeros(1000)  # torchvision's head
    _, want = ckpt_jax.import_torch_weights(variables, {k: v.numpy() for k, v in sd.items()})
    port = create_model(cfg)
    got = ckpt.import_reference_weights(port, sd)
    assert sorted(got["loaded"]) == sorted(want["loaded"])
    assert sorted(got["missed"]) == sorted(want["missed"])
    assert len(got["loaded"]) == 100 and all(k.startswith("backbone.") for k, _ in got["loaded"])
    psd = port.state_dict()
    for k, src in got["loaded"]:
        assert torch.equal(psd[k], sd[src]), k


def test_resnet18_msgpack_of_the_jax_cli_loads(resnet18, tmp_path):
    cfg_jax, cfg, _, variables, _ = resnet18
    tx, _ = optim_jax.build_optimizer(cfg_jax, variables["params"])
    path = ckpt_jax.CheckPointer(str(tmp_path)).save("model_best", TrainStateJax.create(variables, tx, with_ema=False))
    port = create_model(cfg)
    sd, ema = ckpt.load_flax_checkpoint(path, port)
    assert not ema
    want = ckpt.state_dict_from_jax(variables, port)
    assert sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in sd)


def train(tree, weights, extra=()):
    return cli_train.main(["--model-config", CONFIG, "--data-path", tree, "--device", "cpu", "--set", *SMALL,
                           "TRAINING.WEIGHTS", weights, *extra])


def test_shipped_config_trains_from_init(kitti_tree, tmp_path, capsys):  # noqa: F811
    """Fault (f): the config ships ``pretrained`` with an empty
    ``CHECKPOINT_FILE``; the port raised there, the JAX CLI trains from
    init (rtm3d_tpu/cli/train.py:163-171). A named ``.pth`` that does not
    exist warns and trains from init too; once it exists (a torchvision
    ResNet-18 trunk) its 100 tensors are imported."""
    cfg = load_config(CONFIG)
    assert cfg.TRAINING.CHECKPOINT_MODE == "pretrained" and cfg.TRAINING.CHECKPOINT_FILE == ""
    out = train(kitti_tree, str(tmp_path / "w"), ["SOLVER.MAX_EPOCH", "2"])
    assert out["img_size"] == [192, 64] and [h["steps"] for h in out["history"]] == [3, 3]
    losses = [v for h in out["history"] for v in h["train_loss"] + h["eval_loss"]]
    assert np.isfinite(losses).all()
    assert out["history"][1]["eval_loss"][-1] < out["history"][0]["eval_loss"][-1]
    assert "training from init" in capsys.readouterr().out
    missing = str(tmp_path / "imagenet.pth")
    train(kitti_tree, str(tmp_path / "w2"), ["SOLVER.MAX_EPOCH", "1", "TRAINING.CHECKPOINT_FILE", missing])
    assert f"WARNING: pretrained weights {missing} not found; training from init" in capsys.readouterr().out
    # a torchvision-layout backbone file that exists is imported by suffix
    torch.save(_torch_resnet18().state_dict(), missing)
    out = train(kitti_tree, str(tmp_path / "w3"), ["SOLVER.MAX_EPOCH", "1", "TRAINING.CHECKPOINT_FILE", missing])
    assert f"imported 100 tensors from {missing}" in capsys.readouterr().out
    assert np.isfinite(out["history"][0]["eval_loss"]).all()


def test_detect_finds_the_trained_checkpoint_by_the_config_path(kitti_tree, tmp_path):  # noqa: F811
    """Fault (e): the configs name ``weights/<BACKBONE>/model_best.msgpack``
    and the port's trainer writes ``model_best.pt`` there. With no
    ``--checkpoint``, ``Detector.from_config`` and ``cli.detect`` serve the
    ``.pt`` with its EMA, as a detector loaded from it explicitly does, and
    not random weights; ``cli.evaluate`` detects through it too."""
    weights = str(tmp_path / "weights")
    train(kitti_tree, weights, ["SOLVER.MAX_EPOCH", "1", "TRAINING.EMA", "True"])
    pt = os.path.join(weights, "RESNET-18", "model_best.pt")
    served = ["DETECTOR.CHECKPOINT", os.path.join(weights, "RESNET-18", "model_best.msgpack")]
    lifted = ["INPUT_SIZE", "(192, 192)", "DETECTOR.TOPK_CANDIDATES", "10", "DETECTOR.SCORE_THRESH", "0.0",
              "DETECTOR.RESIDUAL_THRESH", "1e9"]
    x = np.random.RandomState(0).randint(0, 256, (2, 64, 192, 3)).astype(np.uint8)
    K = np.tile(np.array([[60.0, 0, 96], [0, 60.0, 32], [0, 0, 1]], np.float32), (2, 1, 1))
    by_config = Detector.from_config(CONFIG, overrides=lifted + served, input_size=(192, 64), device="cpu")(x, K)
    sd, ema = ckpt.load_torch_weights(pt)
    assert ema
    cfg = load_config(CONFIG, lifted)
    cfg.INPUT_SIZE = (192, 64)
    explicit = Detector(cfg, sd, device="cpu")(x, K)
    random = Detector.from_config(CONFIG, overrides=lifted + ["DETECTOR.CHECKPOINT", str(tmp_path / "none.msgpack")],
                                  input_size=(192, 64), device="cpu")(x, K)
    for k in explicit:
        np.testing.assert_array_equal(by_config[k], explicit[k], err_msg=k)
    assert not np.array_equal(by_config["scores"], random["scores"])

    def run(out, extra=(), overrides=()):
        cli_detect.main(["--model-config", CONFIG, "--data-path", kitti_tree, "--split", "test", "--device", "cpu",
                         "--batch-size", "2", "--out-dir", str(out), *extra, "--set", *lifted, *overrides])
        return {n: (out / n).read_text() for n in sorted(os.listdir(out))}

    by_path = run(tmp_path / "by_path", overrides=served)
    assert by_path == run(tmp_path / "explicit", ["--checkpoint", pt]) and len(by_path) == 3
    assert by_path != run(tmp_path / "random", overrides=["DETECTOR.CHECKPOINT", str(tmp_path / "none.msgpack")])
    # cli.evaluate detects through the same path and scores the files
    evaluated = tmp_path / "evaluated"
    table = cli_evaluate.main(["--model-config", CONFIG, "--data-path", kitti_tree, "--split", "test", "--device",
                               "cpu", "--batch-size", "2", "--out-dir", str(evaluated), "--set", *lifted, *served])
    assert len(table) == 36 and all(np.isfinite(v) for v in table.values())
    assert {n: (evaluated / n).read_text() for n in sorted(os.listdir(evaluated))} == by_path
