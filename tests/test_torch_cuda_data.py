"""Card tests of the data slice: the device warp and the input stage on the
GPU against the CPU, and the pinned side-stream copy of
``prefetch_to_device``.

Like tests/test_torch_cuda.py this file imports neither JAX nor the JAX
package; on a machine with a CUDA device, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_data.py -q

Without a device every ``cuda``-marked test skips with its reason.
"""

import numpy as np
import pytest
import torch

from rtm3d_tpu_torch.config import default_config
from rtm3d_tpu_torch.data.loader import prefetch_to_device
from rtm3d_tpu_torch.ops.device_warp import device_warp, warp_params_for
from rtm3d_tpu_torch.train.step import prepare_images

MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the GPU paths have no CPU mode")
    return torch.device("cuda")


def kitti_batch(rng, B=4, canvas=(375, 1242)):
    """uint8 canvases (frame 1 smaller than the canvas) and warp params to 1280x416."""
    imgs = np.zeros((B, *canvas, 3), np.uint8)
    rows = []
    for i in range(B):
        h, w = (370, 1224) if i == 1 else canvas
        imgs[i, :h, :w] = rng.randint(0, 256, (h, w, 3))
        p, _ = warp_params_for((h, w), (1280, 416), 1280, 1.0 + 0.1 * i, i % 2 == 0)
        rows.append(np.concatenate([p, [w, h]]))
    return imgs, np.stack(rows).astype(np.float32), rng.uniform(0, 255, (B, 3)).astype(np.float32)


@pytest.mark.cuda
def test_device_warp_gpu_matches_cpu(cuda):
    """TF32 is forced off inside the warp even where the caller allows it."""
    imgs, params, border = kitti_batch(np.random.RandomState(0))
    want = device_warp(torch.from_numpy(imgs), torch.from_numpy(params), (416, 1280), MEAN, STD,
                       torch.from_numpy(border))
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = device_warp(torch.from_numpy(imgs).to(cuda), torch.from_numpy(params).to(cuda), (416, 1280), MEAN,
                          STD, torch.from_numpy(border).to(cuda))
        assert torch.backends.cuda.matmul.allow_tf32  # restored
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    assert (got.cpu() - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_prepare_images_cache_and_noise_on_the_gpu(cuda):
    imgs, params, border = kitti_batch(np.random.RandomState(1))
    cfg = default_config()
    cfg.INPUT_SIZE = (1280, 416)
    photo = np.array([[1.1, 0.05, 0.0, 5], [0.9, -0.1, 0.0, 6], [1.0, 0.0, 0.0, 7], [1.0, 0.0, 0.0, 8]], np.float32)
    batch = {"image_idx": np.array([3, 2, 1, 0], np.int32), "warp": params, "border": border, "photo": photo}
    cache = imgs[::-1].copy()
    want = prepare_images({k: torch.from_numpy(v) for k, v in batch.items()}, cfg, torch.from_numpy(cache))
    got = prepare_images({k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}, cfg,
                         torch.from_numpy(cache).to(cuda))
    assert (got.cpu() - want).abs().max().item() <= 1e-4

    noisy = dict(batch, photo=np.array([[1.0, 0.0, 6.0, 9]] * 4, np.float32))
    flat = np.full_like(cache, 128)
    out = prepare_images({k: torch.from_numpy(v).to(cuda) for k, v in noisy.items()}, cfg,
                         torch.from_numpy(flat).to(cuda))
    assert not torch.allclose(out[0], out[1])  # lanes of one seed differ
    again = prepare_images({k: torch.from_numpy(v).to(cuda) for k, v in noisy.items()}, cfg,
                           torch.from_numpy(flat).to(cuda))
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_prefetch_copies_every_batch_through_pinned_memory(cuda):
    rng = np.random.RandomState(2)
    batches = [{"image": rng.randint(0, 256, (8, 64, 96, 3)).astype(np.uint8),
                "labels": {"bbox": rng.rand(8, 5, 4).astype(np.float32), "mask": rng.rand(8, 5) > 0.5},
                "path": [f"{b}-{i}" for i in range(8)], "num_valid": 8} for b in range(5)]
    got = []
    for b in prefetch_to_device(iter(batches), cuda, size=2):
        # work on the consuming stream while the next copy runs on the side
        got.append({"image": b["image"].clone(), "bbox": b["labels"]["bbox"].clone(),
                    "mask": b["labels"]["mask"].clone(), "path": b["path"], "num_valid": b["num_valid"]})
        assert b["image"].is_cuda and b["labels"]["bbox"].device.type == "cuda"
    assert len(got) == len(batches)
    for g, w in zip(got, batches):
        assert torch.equal(g["image"].cpu(), torch.from_numpy(w["image"]))
        assert torch.equal(g["bbox"].cpu(), torch.from_numpy(w["labels"]["bbox"]))
        assert torch.equal(g["mask"].cpu(), torch.from_numpy(w["labels"]["mask"]))
        assert g["path"] == w["path"] and g["num_valid"] == 8
