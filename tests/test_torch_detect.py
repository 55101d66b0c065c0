"""The whole slice: the port's ``make_detect_step`` and ``Detector`` against
the JAX package's, DLA-34 at 64x64 fp32, uint8 input, with the 3D solve,
top-K 10, the same weights carried across.

Random weights regress random vertices, on which the prior-regularised LM
pose can part on fp noise while its reprojection cost does not. So the
decode outputs, the cost and ``accepted`` are compared tightly (measured:
decode floats within 4e-6, cost within 6e-6), and the pose (ry, dim, loc)
only on slots that both accept.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtm3d_tpu.api import Detector as DetectorJax
from rtm3d_tpu.config import default_config
from rtm3d_tpu.train.step import make_detect_step as make_detect_step_jax
from rtm3d_tpu_torch.api import Detector
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.train.checkpoint import state_dict_from_jax
from rtm3d_tpu_torch.train.step import make_detect_step
from tests.test_torch_model import jax_variables

B = 2


@pytest.fixture(scope="module")
def carried():
    cfg = default_config()
    cfg.INPUT_SIZE = (64, 64)
    cfg.DETECTOR.TOPK_CANDIDATES = 10
    jax_model, variables = jax_variables(cfg, seed=1)
    state_dict = state_dict_from_jax(variables, create_model(cfg))
    rng = np.random.RandomState(4)
    images = (rng.rand(B, 64, 64, 3) * 255).astype(np.uint8)
    K = np.tile(np.array([[60.0, 0, 32], [0, 60, 32], [0, 0, 1]], np.float32), (B, 1, 1))
    ref = jax.device_get(
        make_detect_step_jax(jax_model, cfg, with_3d=True)(
            variables, jnp.asarray(images), jnp.asarray(K)
        )
    )
    return cfg, variables, state_dict, images, K, ref


def test_detect_step_matches_jax(carried):
    cfg, _, state_dict, images, K, ref = carried
    model = create_model(cfg)
    model.load_state_dict(state_dict, strict=True)
    got = make_detect_step(model, cfg, with_3d=True, device="cpu")(
        torch.from_numpy(images), torch.from_numpy(K)
    )
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == np.asarray(ref[k]).shape, k
    for k in ("cls", "valid", "accepted"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert ref["valid"].any()
    for k in ("scores", "m_proj", "v_proj", "bbox2d"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["cost"], ref["cost"], atol=1e-4, rtol=1e-4)
    both = (got["cost"] < 0.1) & (ref["cost"] < 0.1)
    dry = np.angle(np.exp(1j * (got["ry"] - ref["ry"])))
    assert np.all(np.abs(dry[both]) < 1e-3)
    np.testing.assert_allclose(got["dim"][both], ref["dim"][both], atol=0.01)
    np.testing.assert_allclose(got["loc"][both], ref["loc"][both], atol=0.05)


def test_detector_to_objects_matches_jax(carried):
    cfg, variables, state_dict, images, K, ref = carried
    det = Detector(cfg, state_dict, device="cpu")
    out = det(images, K)
    assert isinstance(out["scores"], np.ndarray) and out["scores"].shape == (B, 10)
    np.testing.assert_array_equal(out["accepted"], ref["accepted"])
    # the unpacking itself, on the same arrays with every valid slot accepted
    forced = {k: np.asarray(v) for k, v in ref.items()}
    forced["accepted"] = forced["valid"]
    objs = det.to_objects(forced)
    assert objs == DetectorJax(cfg, variables).to_objects(forced)
    assert sum(len(o) for o in objs) == forced["valid"].sum() > 0
    o = objs[0][0]
    assert o["loc"][1] == pytest.approx(float(forced["loc"][0, 0, 1]) + o["dim"][0] / 2)


def test_entry_points_raise_without_gpu(monkeypatch, carried):
    cfg, _, state_dict, _, _, _ = carried
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Detector(cfg, state_dict)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_detect_step(create_model(cfg), cfg)
