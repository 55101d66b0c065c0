"""The port's LM solver (rtm3d_tpu_torch/ops/lm_solver.py) against the JAX
package's two versions of it: the plain ``_lm_batch`` and the Pallas kernel
``lm_solve_pallas`` run in interpret mode, on the same numpy inputs.

With the dimension prior (weight 20, the default) the problem is well posed
and every lane agrees closely. At weight 0 the objective has an exact scale
gauge (dims and location slide along the view rays at equal cost), so the
solution x is not comparable and a near-degenerate lane can settle apart on
rounding noise alone (the JAX package's own two versions part on such lanes
too). There the test compares what is gauge-free — the cost and the
reprojected corners — on the lanes where both converged, and bounds the
lanes where only one did.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtm3d_tpu.decode.solve3d import _lm_batch
from rtm3d_tpu.geometry.projection import proj2d_bbox3d
from rtm3d_tpu.ops.lm_solver import lm_solve_pallas
from rtm3d_tpu_torch.decode.solve3d import _residuals_batch
from rtm3d_tpu_torch.ops.lm_solver import lm_flops, lm_solve, lm_solve_reference

K_KITTI = np.array([[721.5, 0, 609.6], [0, 721.5, 172.9], [0, 0, 1.0]], np.float32)
ITERS = 40
CONVERGED = 2.0  # a 0.3 px-noise box converges to cost ~0.2-1.3 (16 terms)


def synthetic_boxes(rng, M, noise=0.3):
    """Projected car boxes at random poses + pixel noise, as in
    tests/test_pallas_ops.py. Returns (uv (M,8,2), x0 (M,8), K (M,3,3))."""
    K = np.tile(K_KITTI, (M, 1, 1))
    dims = np.tile(np.array([1.53, 1.63, 3.88], np.float32), (M, 1))
    locs = np.stack(
        [rng.randn(M) * 3, rng.randn(M) * 0.3 + 1, rng.rand(M) * 25 + 8], -1
    ).astype(np.float32)
    rys = rng.uniform(-np.pi, np.pi, M).astype(np.float32)
    uv_full, _, _ = proj2d_bbox3d(dims, locs, rys, K, bottom_center=False)
    uv = np.transpose(uv_full, (0, 2, 1))[:, :8].astype(np.float32)
    uv += rng.randn(*uv.shape).astype(np.float32) * noise
    x0 = np.tile(np.array([0, 1, 3.884, 1.526, 1.629, 0, -0.5, 20.0], np.float32), (M, 1))
    return uv, x0, K


def to_soa(uv, x0, K):
    """The kernels' layout: uv (16, M), x0 (8, M), kp (4, M)."""
    uv_k = np.concatenate([uv[..., 0].T, uv[..., 1].T], 0)
    kp = np.stack([K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2]], 0)
    return np.ascontiguousarray(uv_k), np.ascontiguousarray(x0.T), np.ascontiguousarray(kp)


def reprojection(x, uv, K):
    """Per-corner residuals (M, 16) of solutions x (M, 8): gauge-free."""
    r, _ = _residuals_batch(torch.as_tensor(x), torch.as_tensor(K), torch.as_tensor(uv))
    return r.numpy()


def check_against(x_port, c_port, x_ref, c_ref, uv, K, prior_weight):
    if prior_weight > 0:
        # well posed: measured max |dcost| 1.3e-4 (rel 1.8e-4), max |dx| 0.024
        np.testing.assert_allclose(c_port, c_ref, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(x_port, x_ref, atol=0.05)
        return
    both = (c_port < CONVERGED) & (c_ref < CONVERGED)
    split = (c_port < CONVERGED) != (c_ref < CONVERGED)
    # measured: at most 1 split lane in 200; both-converged lanes agree to
    # |dcost| 4e-5 and 0.002 px per corner
    assert split.sum() <= max(1, int(0.02 * len(c_ref))), split.sum()
    assert both.mean() >= 0.7
    np.testing.assert_allclose(c_port[both], c_ref[both], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(
        reprojection(x_port[both], uv[both], K[both]),
        reprojection(x_ref[both], uv[both], K[both]),
        atol=0.01,
    )


@pytest.mark.parametrize("prior_weight", [0.0, 20.0])
@pytest.mark.parametrize("M", [16, 200])  # 200: ragged, not a multiple of 128
def test_lm_reference_matches_jax(M, prior_weight):
    rng = np.random.RandomState(20 + M)
    uv, x0, K = synthetic_boxes(rng, M)
    uv_k, x0_k, kp = to_soa(uv, x0, K)

    x_port, c_port = lm_solve(
        torch.from_numpy(uv_k), torch.from_numpy(x0_k), torch.from_numpy(kp),
        iters=ITERS, prior_weight=prior_weight,
    )
    assert x_port.shape == (8, M) and c_port.shape == (1, M)
    x_port, c_port = x_port.numpy().T, c_port.numpy()[0]

    xj, cj = _lm_batch(
        jnp.asarray(uv), jnp.asarray(x0), jnp.asarray(K), ITERS, prior_weight=prior_weight
    )
    check_against(x_port, c_port, np.asarray(xj), np.asarray(cj), uv, K, prior_weight)

    xp, cp = lm_solve_pallas(
        jnp.asarray(uv_k), jnp.asarray(x0_k), jnp.asarray(kp),
        iters=ITERS, interpret=True, prior_weight=prior_weight,
    )
    check_against(x_port, c_port, np.asarray(xp).T, np.asarray(cp)[0], uv, K, prior_weight)


def test_lm_solve_takes_plain_version_on_cpu_only():
    rng = np.random.RandomState(1)
    uv_k, x0_k, kp = (torch.from_numpy(a) for a in to_soa(*synthetic_boxes(rng, 8)))
    before = lm_solve.launches
    x, c = lm_solve(uv_k, x0_k, kp, iters=5)
    xr, cr = lm_solve_reference(uv_k, x0_k, kp, iters=5)
    assert torch.equal(x, xr) and torch.equal(c, cr)
    assert lm_solve.launches == before  # no kernel launched on the CPU
    with pytest.raises(ValueError):
        lm_solve(uv_k[:15], x0_k, kp)
    with pytest.raises(ValueError):
        lm_solve(uv_k, x0_k, kp[:, :4])


def test_lm_flops_counts_every_lane_and_iteration():
    per = lm_flops(1, 40, 0.0)
    assert lm_flops(1000, 40, 0.0) == 1000 * per
    assert lm_flops(1, 40, 20.0) > per  # the prior adds work
    assert 700 * 40 < per < 1600 * 40  # ~1k operations per lane-iteration
