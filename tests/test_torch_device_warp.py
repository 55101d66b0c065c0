"""The port's device warp and input stage against the JAX package's, on
the CPU.

``device_warp``: the same uint8 canvas and params through
``rtm3d_tpu/ops/device_warp.py::device_warp`` and the port's, max |d| <=
1e-4 on normalised values (a row of the interpolation matrices has two
non-zeros, so both sides sum the same two products; measured ~1e-6).
``prepare_images`` with the photometric std at 0 is deterministic and held
to the JAX function the same way, with and without the device dataset
cache. With std > 0 the port's noise (one torch.Generator draw per batch) is held
by its statistics: mean ~0 and std within 5% of the asked value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtm3d_tpu.config import default_config as default_config_jax
from rtm3d_tpu.ops import device_warp as warp_jax
from rtm3d_tpu.train.step import prepare_images as prepare_images_jax
from rtm3d_tpu_torch.config import default_config
from rtm3d_tpu_torch.ops import device_warp as warp
from rtm3d_tpu_torch.train.step import prepare_images

MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
CANVAS_HW = (40, 70)  # the largest source; frame 1 is smaller (a padded canvas)
SRC_HW = [(40, 70), (31, 52), (40, 70)]
OUT_WH = (96, 64)


def canvases(seed=0):
    rng = np.random.RandomState(seed)
    out = np.zeros((len(SRC_HW), *CANVAS_HW, 3), np.uint8)
    for i, (h, w) in enumerate(SRC_HW):
        out[i, :h, :w] = rng.randint(0, 256, (h, w, 3))
    return out


def warp_params(scale, mirror):
    rows = []
    for i, (h, w) in enumerate(SRC_HW):
        p, _ = warp.warp_params_for((h, w), OUT_WH, OUT_WH[0], scale, mirror and i != 2)
        p_jax, _ = warp_jax.warp_params_for((h, w), OUT_WH, OUT_WH[0], scale, mirror and i != 2)
        np.testing.assert_array_equal(p, p_jax)
        rows.append(np.concatenate([p, [w, h]]).astype(np.float32))
    return np.stack(rows)


@pytest.mark.parametrize("scale", [1.0, 1.15])
@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("border", [True, False], ids=["border", "mean_border"])
def test_device_warp_matches_jax(scale, mirror, border):
    imgs, params = canvases(), warp_params(scale, mirror)
    bd = np.random.RandomState(1).uniform(0, 255, (len(SRC_HW), 3)).astype(np.float32) if border else None
    want = np.asarray(warp_jax.device_warp(jnp.asarray(imgs), jnp.asarray(params), OUT_WH[::-1], MEAN, STD,
                                           border=None if bd is None else jnp.asarray(bd)))
    got = warp.device_warp(torch.from_numpy(imgs), torch.from_numpy(params), OUT_WH[::-1], MEAN, STD,
                           border=None if bd is None else torch.from_numpy(bd))
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(SRC_HW), OUT_WH[1], OUT_WH[0], 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    # the smaller frame's zero canvas padding never blends in: it warps as
    # the frame alone on a canvas of its own size
    h, w = SRC_HW[1]
    alone = warp.device_warp(torch.from_numpy(imgs[1:2, :h, :w].copy()), torch.from_numpy(params[1:2]),
                             OUT_WH[::-1], MEAN, STD, border=None if bd is None else torch.from_numpy(bd[1:2]))
    if border:
        torch.testing.assert_close(got[1:2], alone, rtol=0, atol=1e-5)


def test_four_params_mean_the_whole_canvas():
    imgs = canvases()
    p6 = warp_params(1.0, False)
    p6[:, 4:] = [CANVAS_HW[1], CANVAS_HW[0]]
    a = warp.device_warp(torch.from_numpy(imgs), torch.from_numpy(p6), OUT_WH[::-1], MEAN, STD)
    b = warp.device_warp(torch.from_numpy(imgs), torch.from_numpy(p6[:, :4]), OUT_WH[::-1], MEAN, STD)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def batch_for(cache: bool, photo):
    imgs = canvases(2)
    batch = {"warp": warp_params(1.15, True),
             "border": np.random.RandomState(3).uniform(0, 255, (len(SRC_HW), 3)).astype(np.float32),
             "photo": np.asarray(photo, np.float32)}
    if cache:
        order = np.array([2, 0, 1], np.int32)
        batch["image_idx"] = order
        return batch, imgs[np.argsort(order)]
    batch["image"] = imgs
    return batch, None


@pytest.mark.parametrize("cache", [False, True], ids=["canvas", "cache"])
def test_prepare_images_matches_jax_without_noise(cache):
    photo = [[1.1, 0.05, 0.0, 11], [0.85, -0.1, 0.0, 12], [1.0, 0.0, 0.0, 0]]
    batch, image_cache = batch_for(cache, photo)
    cfg_jax, cfg = default_config_jax(), default_config()
    cfg_jax.INPUT_SIZE = cfg.INPUT_SIZE = OUT_WH
    want = np.asarray(prepare_images_jax({k: jnp.asarray(v) for k, v in batch.items()}, cfg_jax,
                                         None if image_cache is None else jnp.asarray(image_cache)))
    got = prepare_images({k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
                         None if image_cache is None else torch.from_numpy(image_cache))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    # the uint8 path without warp: the plain normalisation
    plain = prepare_images({"image": torch.from_numpy(canvases())}, cfg)
    want_plain = np.asarray(prepare_images_jax({"image": jnp.asarray(canvases())}, cfg_jax))
    np.testing.assert_allclose(plain.numpy(), want_plain, atol=1e-6, rtol=0)


def test_prepare_images_needs_the_cache():
    batch, _ = batch_for(True, [[1.0, 0.0, 0.0, 0]] * 3)
    with pytest.raises(ValueError, match="image_cache"):
        prepare_images({k: torch.from_numpy(v) for k, v in batch.items()}, default_config())


def test_photometric_noise_statistics():
    """An identity warp of a flat grey canvas: the output, un-normalised,
    is 128 + the noise. Two lanes share a host seed and must still differ;
    a lane with std 0 gets none."""
    H, W = 64, 96
    cfg = default_config()
    cfg.INPUT_SIZE = (W, H)
    std = 5.0
    batch = {
        "image": torch.full((3, H, W, 3), 128, dtype=torch.uint8),
        "warp": torch.tensor([[1.0, 1.0, 0.0, 0.0, W, H]] * 3),
        "border": torch.zeros(3, 3),
        "photo": torch.tensor([[1.0, 0.0, std, 77], [1.0, 0.0, std, 77], [1.0, 0.0, 0.0, 77]]),
    }
    out = prepare_images(batch, cfg)
    x = (out * torch.tensor(STD) + torch.tensor(MEAN)) * 255.0 - 128.0
    for lane in (0, 1):
        noise = x[lane].double()
        assert abs(noise.mean().item()) < 0.05 * std
        assert abs(noise.std().item() / std - 1.0) < 0.05
    assert not torch.allclose(x[0], x[1])
    assert x[2].abs().max().item() < 1e-3
    again = prepare_images(batch, cfg)
    torch.testing.assert_close(again, out, rtol=0, atol=0)  # seeded: the same noise again
