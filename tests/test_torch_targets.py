"""The port's target building against the JAX package's, on the CPU.

- The splat's plain version (``ops/splat.py::splat_heatmap_reference``,
  what ``splat_heatmap`` runs on the CPU) against JAX ``_render_heatmap``
  and the Pallas kernel ``splat_heatmap_pallas`` in interpret mode, on the
  inputs of tests/test_pallas_ops.py:11-20 and its all-masked and
  noise-peak cases, plus an edge batch. The port is NCHW, JAX NHWC: the
  test transposes. Tolerance atol 1e-6 (measured: max |d| 6.0e-8, an ulp
  of exp); the pixels equal to 1.0, which the focal loss counts as
  positives, must be the same set.
- ``build_targets`` against JAX ``build_targets`` (both Gaussian types) and
  the numpy oracle ``build_targets_np`` (dynamic radius, float64), on the
  labels of tests/test_targets.py; seed 2 puts 15% of the vertices at
  negative pixels and 61% off the map. Int and bool keys exact; float keys
  within atol 1e-5 (measured: 7.6e-6 for v_coor_off, the fp32 ulp of
  vertices of magnitude 64-128 px, against both; 4.2e-7 for m_hm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtm3d_tpu.data.targets import _render_heatmap, build_targets_np
from rtm3d_tpu.data.targets import build_targets as build_targets_jax
from rtm3d_tpu.ops.splat import splat_heatmap_pallas
from rtm3d_tpu_torch.data.targets import build_targets
from rtm3d_tpu_torch.ops.splat import (
    splat_bytes,
    splat_flops,
    splat_heatmap,
    splat_heatmap_reference,
)
from tests.test_pallas_ops import _inputs
from tests.test_targets import _random_labels

FLOAT_KEYS = ("m_hm", "m_off", "v_off", "v_coor_off")
EXACT_KEYS = ("m_proj", "v_proj", "v_mask", "mask_3d", "mask", "noise_mask")


def splat_case(name):
    rng = np.random.RandomState(20)
    if name.startswith("random"):
        return _inputs(np.random.RandomState(int(name[6:])))
    if name == "all_masked":  # test_pallas_ops.py:38-52
        m_proj, cls, sigma, radius, mask, noise, hw, C = _inputs(rng)
        mask[:] = False
        return m_proj, cls, sigma, radius, mask, noise & mask, hw, C
    if name == "noise_peak":  # test_pallas_ops.py:55-71
        return (np.array([[[5, 6]]], np.int32), np.array([[1]], np.int32),
                np.array([[2.0]], np.float32), np.array([[6.0]], np.float32),
                np.array([[True]]), np.array([[True]]), (16, 24), 3)
    # edge: centers off the map, R = 0, a noise slot whose window misses
    # the map, two classes overlapping, a masked slot under a live one
    m_proj = np.array([[[-3, 2], [10, 5], [10, 5], [30, 40], [0, 0], [7, 7]]], np.int32)
    cls = np.array([[0, 1, 2, 0, 5, 1]], np.int32)  # 5: clipped to C-1
    sigma = np.array([[1.5, 2.0, 0.7, 3.0, 1.0, 2.0]], np.float32)
    radius = np.array([[4.0, 0.0, 3.0, 5.0, 2.0, 9.0]], np.float32)
    mask = np.array([[True, True, True, True, True, False]])
    noise = np.array([[False, False, True, True, False, True]])
    return m_proj, cls, sigma, radius, mask, noise, (12, 16), 3


CASES = ["random20", "random21", "random22", "all_masked", "noise_peak", "edge"]


@pytest.mark.parametrize("case", CASES)
def test_plain_splat_matches_jax(case):
    m_proj, cls, sigma, radius, mask, noise, hw, C = splat_case(case)
    args = [m_proj, cls, sigma, radius, mask, noise]
    got = splat_heatmap(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), hw, C)
    assert got.shape == (cls.shape[0], C) + tuple(hw) and got.dtype == torch.float32
    got = got.numpy().transpose(0, 2, 3, 1)  # NCHW -> NHWC
    jargs = [jnp.asarray(a) for a in args]
    for ref in (_render_heatmap(*jargs, hw, C), splat_heatmap_pallas(*jargs, hw, C, interpret=True)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got == 1.0, ref == 1.0)
    if case == "all_masked":
        assert got.sum() == 0
    if case == "noise_peak":
        assert got[0, 6, 5, 1] == np.float32(0.9999) and got.max() == np.float32(0.9999)
    if case == "edge":
        # the centers of slot 1 (R = 0) and slot 4 (class 5 clipped to 2)
        assert (got == 1.0).sum() == 2 and got[0, 5, 10, 1] == 1.0 and got[0, 0, 0, 2] == 1.0
        assert got[0, 5, 10, 2] == np.float32(0.9999)  # slot 2's noise center


def test_splat_wrapper_on_cpu_takes_the_plain_version():
    m_proj, cls, sigma, radius, mask, noise, hw, C = (
        torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
        for a in _inputs(np.random.RandomState(3))
    )
    before = splat_heatmap.launches
    got = splat_heatmap(m_proj, cls, sigma, radius, mask, noise, hw, C)
    assert torch.equal(got, splat_heatmap_reference(m_proj, cls, sigma, radius, mask, noise, hw, C))
    assert splat_heatmap.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError):
        splat_heatmap(m_proj[..., :1], cls, sigma, radius, mask, noise, hw, C)
    with pytest.raises(ValueError):
        splat_heatmap(m_proj, cls, sigma[:, :3], radius, mask, noise, hw, C)


def test_splat_work_counts():
    H, W, C = 32, 40, 3
    m_proj = torch.tensor([[[5, 5], [0, 0], [100, 100], [20, 10]]], dtype=torch.int32)
    radius = torch.tensor([[2.0, 3.0, 4.0, 2.5]])
    mask = torch.tensor([[True, True, True, False]])
    # windows on the map: 5x5, 4x4 (clipped at the corner), 0 (off the map)
    assert splat_flops(m_proj, radius, mask, (H, W)) == (25 + 16) * 7 + 3 * 2
    assert splat_bytes(1, 4, (H, W), C) == 4 * 22 + C * H * W * 4
    assert splat_bytes(32, 64, (96, 320), 3) == 32 * 64 * 22 + 11_796_480  # the slice's 11.8 MB


def _labels_case(seed):
    labels = _random_labels(np.random.RandomState(seed), img_hw=(128, 160))
    if seed == 2:
        # vertices straddle the map's edges: boxes near the camera, off to the side
        labels["loc"][..., 0] *= 4
        labels["loc"][..., 2] = np.abs(labels["loc"][..., 2]) * 0.3 + 2
    return labels


def _compare(got, ref, keys, atol, where=None):
    for k in keys:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        if k == "m_hm":
            g = g.transpose(0, 2, 3, 1)
        elif where is not None:
            g, r = g[where], r[where]
        assert g.shape == r.shape, k
        if k in EXACT_KEYS:
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            np.testing.assert_allclose(g, r, atol=atol, rtol=0, err_msg=k)
    hm_g = np.asarray(got["m_hm"]).transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(hm_g == 1.0, np.asarray(ref["m_hm"]) == 1.0)


@pytest.mark.parametrize("gaussian", ["dynamic_radius", "dynamic_sigma"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_targets_matches_jax(seed, gaussian):
    labels = _labels_case(seed)
    feat_hw = (32, 40)
    got = build_targets({k: torch.from_numpy(v) for k, v in labels.items()}, feat_hw, 3,
                        gaussian_gen_type=gaussian)
    ref = jax.device_get(build_targets_jax({k: jnp.asarray(v) for k, v in labels.items()}, feat_hw, 3,
                                           gaussian_gen_type=gaussian, use_pallas=False))
    assert set(got) == set(ref)
    for k in EXACT_KEYS:
        assert got[k].dtype in (torch.int32, torch.bool), k
    _compare(got, ref, FLOAT_KEYS + EXACT_KEYS, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_targets_matches_numpy_oracle(seed):
    labels = _labels_case(seed)
    feat_hw = (32, 40)
    got = build_targets({k: torch.from_numpy(v) for k, v in labels.items()}, feat_hw, 3)
    oracle = build_targets_np(labels, feat_hw, 3)
    # the oracle leaves unmasked slots at zero (padding): compare the objects
    _compare(got, oracle, FLOAT_KEYS + EXACT_KEYS, atol=1e-5, where=labels["mask"])
