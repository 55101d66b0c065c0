"""The port's ``decode_detections`` against the JAX package's on seeded
random logits (NHWC into JAX, the same arrays as NCHW into the port).

Logits are N(0, 1) floats, so peak scores have no ties and the two top-K
orders coincide; every output is compared on every slot (valid ones
included). Measured: bit-identical on the CPU, so the tolerance is exact for
the integer outputs and 1e-6 for the float ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtm3d_tpu.decode.peaks import decode_detections as decode_jax
from rtm3d_tpu_torch.decode.peaks import decode_detections, nms_peaks


@pytest.mark.parametrize("shape,topk", [((2, 3, 16, 20), 30), ((1, 3, 24, 40), 100)])
def test_decode_matches_jax(shape, topk):
    B, C, H, W = shape
    rng = np.random.RandomState(H + W)
    logits = [
        rng.randn(B, H, W, C).astype(np.float32),
        rng.randn(B, H, W, 16).astype(np.float32),
        rng.randn(B, H, W, 2).astype(np.float32),
        rng.randn(B, H, W, 2).astype(np.float32),
    ]
    ref = decode_jax([jnp.asarray(l) for l in logits], score_thresh=0.9, topk=topk)
    got = decode_detections(
        [torch.from_numpy(l).permute(0, 3, 1, 2) for l in logits], score_thresh=0.9, topk=topk
    )
    assert set(got) == set(ref)
    valid = np.asarray(ref["valid"])
    assert 0 < valid.sum() < valid.size
    for key in ("cls", "valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
    assert got["cls"].dtype == torch.int32 and got["valid"].dtype == torch.bool
    for key in ("scores", "m_proj", "v_proj", "bbox2d"):
        g, r = got[key].numpy(), np.asarray(ref[key])
        assert g.shape == r.shape, key
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(g[valid], r[valid], rtol=1e-6, atol=1e-6, err_msg=key)


def test_nms_keeps_only_local_maxima():
    hm = torch.zeros(1, 1, 5, 5)
    hm[0, 0, 1, 1] = 0.9
    hm[0, 0, 1, 2] = 0.5  # neighbour of a higher peak: suppressed
    hm[0, 0, 4, 4] = 0.3  # isolated corner peak: kept
    out = nms_peaks(hm)
    assert out[0, 0, 1, 1] == 0.9 and out[0, 0, 4, 4] == 0.3
    assert out[0, 0, 1, 2] == 0
