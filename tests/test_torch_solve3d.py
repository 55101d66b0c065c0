"""The port's ``solve_bbox3d`` against the JAX package's (plain path,
``use_pallas=False``), prior weight 20 (the default, config.py:203), 40
iterations, on well-posed projected boxes of the three KITTI classes.

Per-box pixel noise straddles the acceptance threshold, so the accept masks
(cost < 0.1) hold both outcomes and must be equal. On accepted slots the
pose must agree: measured max |d ry| 1.6e-5 rad, |d dim| 0.0017 m,
|d loc| 0.0098 m, |d cost| 8.5e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtm3d_tpu.decode.solve3d import COR, solve_bbox3d as solve_bbox3d_jax
from rtm3d_tpu_torch.decode.solve3d import solve_bbox3d

DIM_REF = np.array(
    [[1.52607842, 1.62858147, 3.88396124],
     [1.76067766, 0.6602296, 0.84220464],
     [1.73712792, 0.59677122, 1.76338868]],
    np.float32,
)
REF_LOC = np.array([0.0, -0.5, 20.0], np.float32)
K_KITTI = np.array([[721.5, 0, 609.6], [0, 721.5, 172.9], [0, 0, 1.0]], np.float32)


def projected_boxes(rng, B, N, noise):
    """(B, N) boxes of random class, size, yaw and place in front of a KITTI
    camera, projected to their 8 corners (B, N, 8, 2) + pixel noise."""
    cls = rng.randint(0, 3, (B, N))
    d = DIM_REF[cls] * rng.uniform(0.9, 1.1, (B, N, 3))  # h, w, l
    ry = rng.uniform(-np.pi, np.pi, (B, N))
    loc = np.stack(
        [rng.uniform(-8, 8, (B, N)), rng.uniform(0.5, 2, (B, N)), rng.uniform(8, 40, (B, N))], -1
    )
    s, c = np.sin(ry)[..., None], np.cos(ry)[..., None]
    xc = COR[0] * d[..., 2:3] * c + COR[2] * d[..., 1:2] * s + loc[..., 0:1]
    yc = COR[1] * d[..., 0:1] + loc[..., 1:2]
    zc = -COR[0] * d[..., 2:3] * s + COR[2] * d[..., 1:2] * c + loc[..., 2:3]
    uv = np.stack([K_KITTI[0, 0] * xc / zc + K_KITTI[0, 2], K_KITTI[1, 1] * yc / zc + K_KITTI[1, 2]], -1)
    uv += rng.randn(*uv.shape) * noise
    return uv.astype(np.float32), cls.astype(np.int32)


@pytest.mark.parametrize("noise", ["low", "mixed"])
def test_solve_bbox3d_matches_jax(noise):
    rng = np.random.RandomState(7)
    B, N = 4, 16
    sigma = 0.05 if noise == "low" else rng.uniform(0.01, 0.15, (B, N, 1, 1))
    uv, cls = projected_boxes(rng, B, N, sigma)
    Kb = np.ascontiguousarray(np.broadcast_to(K_KITTI, (B, N, 3, 3)))

    ref = solve_bbox3d_jax(
        jnp.asarray(uv), jnp.asarray(cls), jnp.asarray(Kb), jnp.asarray(DIM_REF),
        jnp.asarray(REF_LOC), iters=40, use_pallas=False, prior_weight=20.0,
    )
    got = solve_bbox3d(
        torch.from_numpy(uv), torch.from_numpy(cls), torch.from_numpy(Kb),
        DIM_REF, REF_LOC, iters=40, prior_weight=20.0,
    )
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in got.items()}
    for k in ("ry", "dim", "loc", "cost"):
        assert got[k].shape == ref[k].shape, k

    acc = ref["cost"] < 0.1
    np.testing.assert_array_equal(got["cost"] < 0.1, acc)
    if noise == "low":
        assert acc.all()
    else:
        assert 0 < acc.sum() < acc.size  # both outcomes present
    dry = np.angle(np.exp(1j * (got["ry"] - ref["ry"])))  # mod 2 pi
    assert np.abs(dry[acc]).max() < 1e-3
    np.testing.assert_allclose(got["dim"][acc], ref["dim"][acc], atol=0.01)
    np.testing.assert_allclose(got["loc"][acc], ref["loc"][acc], atol=0.05)
    np.testing.assert_allclose(got["cost"][acc], ref["cost"][acc], atol=1e-4)
