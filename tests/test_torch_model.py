"""The port's DLA-34 RTM3D against the JAX package's, weights carried across.

JAX variables come from ``init_model`` with BN statistics randomised as in
tests/test_model_parity.py:216-221, go through the port's
``state_dict_from_jax`` and load with ``strict=True``. Eval-mode logits at
64x64 fp32 must agree; the precedent of test_model_parity.py:242 is
atol 5e-2, rtol 1e-2. Measured here: max |d| 3.6e-7 on logits of max
magnitude ~0.18, so the bound pinned is atol 1e-5, rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtm3d_tpu.config import default_config
from rtm3d_tpu.nn.model import init_model
from rtm3d_tpu_torch.nn.layers import UpSample, bilinear_kernel_1d
from rtm3d_tpu_torch.nn.model import RTM3D, create_model
from rtm3d_tpu_torch.train.checkpoint import _flatten, _to_dotted, state_dict_from_jax


def jax_variables(cfg, seed=0):
    """``init_model`` variables as numpy, BN stats drawn from ``seed``."""
    model, variables = init_model(cfg, jax.random.PRNGKey(0))
    variables = jax.device_get(variables)
    rng = np.random.RandomState(seed)

    def randomise(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = randomise(v)
            elif k == "mean":
                out[k] = rng.normal(0, 0.02, v.shape).astype(np.float32)
            else:
                out[k] = rng.uniform(0.9, 1.1, v.shape).astype(np.float32)
        return out

    return model, {"params": variables["params"], "batch_stats": randomise(variables["batch_stats"])}


@pytest.fixture(scope="module")
def carried():
    cfg = default_config()
    cfg.INPUT_SIZE = (64, 64)
    jax_model, variables = jax_variables(cfg)
    port = create_model(cfg)
    port.load_state_dict(state_dict_from_jax(variables, port), strict=True)
    return cfg, jax_model, variables, port.eval()


def test_logits_match_jax(carried):
    cfg, jax_model, variables, port = carried
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32) * 0.5
    ref = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(ref) == 4
    for name, g, r in zip(("main_kf", "offset_fr_main", "main_offset", "vertex_offset"), got, ref):
        r = np.asarray(r).transpose(0, 3, 1, 2)
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5, rtol=1e-5, err_msg=name)


def test_every_key_carried_by_exact_name(carried):
    _, _, variables, port = carried
    keys = {k for k in port.state_dict() if not k.endswith("num_batches_tracked")}
    names = {
        _to_dotted(p) for col in ("params", "batch_stats") for p in _flatten(variables[col])
    }
    assert keys == names
    for k in ("backbone.base_layer.0.weight", "backbone.level2.project.0.weight",
              "kfpn_fusion.fusion_up4.1.conv_tran.weight",
              "detect_header.main_kf_header.main_kf_head.weight",
              "detect_header.offset_fr_main_header.4.running_var"):
        assert k in keys, k


def test_state_dict_from_jax_is_strict(carried):
    _, _, variables, port = carried
    extra = {"params": dict(variables["params"], stray={"kernel": np.zeros((1,))}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError):
        state_dict_from_jax(extra, port)
    params = dict(variables["params"])
    del params["detect_header"]
    with pytest.raises(KeyError):
        state_dict_from_jax({"params": params, "batch_stats": variables["batch_stats"]}, port)


def test_init_matches_jax_init_bounds(carried):
    """The port's own init draws from the JAX package's distributions:
    per tensor, the largest magnitude sits within 20% of JAX's (uniform
    draws of >= 1000 values reach their bound to well under that)."""
    _, _, variables, _ = carried
    cfg = default_config()
    port = create_model(cfg, torch.Generator().manual_seed(1))
    sd = port.state_dict()
    jax_params = {_to_dotted(p): v for p, v in _flatten(variables["params"]).items()}
    checked = 0
    for k, v in jax_params.items():
        if v.size < 1000 or not k.endswith("weight") or v.ndim != 4:
            continue
        ratio = sd[k].abs().max().item() / np.abs(v).max()
        assert 0.8 < ratio < 1.25, (k, ratio)
        checked += 1
    assert checked > 50


def test_upsample_bilinear_fill_and_seeded_init():
    up = UpSample(4)
    up.reset_parameters(torch.Generator().manual_seed(0))
    b1 = bilinear_kernel_1d(4)
    w = up.conv_tran.weight.detach().numpy()  # (in, out, kh, kw)
    for c in range(4):
        np.testing.assert_array_equal(w[c, 0], np.outer(b1, b1))
    assert not np.allclose(w[:, 1], np.outer(b1, b1))
    a = create_model(default_config(), torch.Generator().manual_seed(3))
    b = create_model(default_config(), torch.Generator().manual_seed(3))
    assert all(torch.equal(a.state_dict()[k], b.state_dict()[k]) for k in a.state_dict())


def test_resnet_backbone_not_ported_yet():
    """The ResNet backbones are ported now (tests/test_torch_resnet.py):
    ``RESNET-<depth>`` builds a PoseResNet and an unknown name raises."""
    from rtm3d_tpu_torch.nn.resnet import PoseResNet

    model = RTM3D(backbone_name="RESNET-18", kfns=("layer1", "layer2", "layer3", "layer4"))
    assert isinstance(model.backbone, PoseResNet) and model.backbone.depth == 18
    with pytest.raises(ValueError, match="unsupported backbone"):
        RTM3D(backbone_name="VGG-16")
