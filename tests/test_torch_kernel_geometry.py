"""The CUDA kernels' launch geometry, on the CPU.

``lm_launch_geometry`` and ``splat_launch_geometry`` are the pure Python
functions whose numbers the wrappers hand to the kernels' C launchers
(csrc/lm_solver.cu, csrc/splat.cu), so what a grid covers is checked here,
where no card is needed: every detection in exactly one thread, the LM grid
spread over the card's SMs (an H100 SXM's 132, and other counts), every
heatmap pixel in exactly one tile, and the live-slot count that
chip_smoke.py reports. The splat's tile shape is the kernel's own
(``splat_tile_shape`` reads it from the built library), so the tests here
take it as a parameter: the kernel's 8x64 and others.
"""

import numpy as np
import pytest
import torch

from rtm3d_tpu_torch.ops import lm_solver, splat

PATH_M = (25_600, 38_400)  # the detect path's two LM calls: b128 x top-K 100, 2 and 3 inits
SMS = (132, 114, 78)  # H100 SXM and PCIe, and a card of fewer SMs


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("M", [1, 2, 3, 31, 33, 127, 129, 25_600, 38_400])
def test_lm_detections_map_to_one_thread(M, sms):
    blocks, threads = lm_solver.lm_launch_geometry(M, sms)
    assert threads % 32 == 0 and 32 <= threads <= 256  # whole warps, the kernel's limit
    assert blocks * threads >= M
    assert (blocks - 1) * threads < M  # no block without a detection
    # the kernel's mapping: thread t serves detection t, threads past M none
    t = np.arange(blocks * threads)
    counts = np.bincount(t[t < M], minlength=M)
    assert (counts == 1).all()


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("M", PATH_M)
def test_lm_grid_spreads_evenly_over_the_sms(M, sms):
    blocks, threads = lm_solver.lm_launch_geometry(M, sms)
    assert lm_solver.busiest_sm_share(blocks, sms) <= 1.15
    # no block size spreads the grid better on this card
    best = min(lm_solver.busiest_sm_share(-(-M // t), sms) for t in lm_solver.LM_BLOCK_THREADS)
    assert lm_solver.busiest_sm_share(blocks, sms) == best


def test_lm_geometry_defaults_to_an_h100():
    assert lm_solver.lm_launch_geometry(25_600) == lm_solver.lm_launch_geometry(25_600, 132) == (115, 224)


@pytest.mark.parametrize("blocks,sms,share", [(132, 132, 1.0), (133, 132, 2 / (133 / 132)), (264, 132, 1.0),
                                              (115, 132, 132 / 115), (115, 114, 2 / (115 / 114))])
def test_busiest_sm_share(blocks, sms, share):
    assert lm_solver.busiest_sm_share(blocks, sms) == pytest.approx(share)


def test_lm_flops_only_get_stricter():
    """lm_flops counts the current source. A bound may only get stricter:
    the count stays at or below the 2,182 operations per lane and iteration
    of the one-thread Gauss-Jordan design it replaced."""
    per_iter = lm_solver.lm_flops(1, 2, 0.0) - lm_solver.lm_flops(1, 1, 0.0)
    assert per_iter == lm_solver._FLOPS_ITER <= 2_182
    assert lm_solver.lm_flops(10, 40, 20.0) > lm_solver.lm_flops(10, 40, 0.0)


TILES = [(8, 64), (16, 64), (8, 32)]  # csrc/splat.cu's, and others


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("H,W", [(17, 33), (32, 40), (96, 320)])
def test_splat_tiles_cover_every_pixel_once(H, W, tile):
    th, tw = tile
    gx, gy, gz = splat.splat_launch_geometry(3, H, W, tile)
    assert gz == 3
    count = np.zeros((gy * th, gx * tw), int)
    for by in range(gy):
        for bx in range(gx):
            count[by * th:(by + 1) * th, bx * tw:(bx + 1) * tw] += 1
            assert by * th < H and bx * tw < W  # every tile holds a pixel of the map
    assert (count[:H, :W] == 1).all()


def _slot_inputs(rng, B, N, H, W):
    m_proj = np.stack([rng.randint(-6, W + 6, (B, N)), rng.randint(-6, H + 6, (B, N))], -1)
    sigma = rng.rand(B, N) * 3 + 0.5
    radius = np.ceil(sigma * 2)
    radius[:, ::5] = -1.0  # no window: only a noise center reaches
    mask = rng.rand(B, N) > 0.2
    noise = mask & (rng.rand(B, N) > 0.6)
    cls = rng.randint(0, 3, (B, N))
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        m_proj.astype(np.int32), cls.astype(np.int32), sigma.astype(np.float32),
        radius.astype(np.float32), mask, noise)]


@pytest.mark.parametrize("tile", TILES[:2])
@pytest.mark.parametrize("H,W", [(17, 33), (32, 40), (24, 140)])
def test_splat_live_slots_hold_every_slot_that_reaches_a_tile(H, W, tile):
    """A slot the kernel drops for a tile must put nothing there: every slot
    whose own heatmap (the plain version, one slot at a time) is non-zero
    inside a tile is counted live for that tile, and no masked-out slot is."""
    B, N = 2, 12
    m_proj, cls, sigma, radius, mask, noise = _slot_inputs(np.random.RandomState(H + W), B, N, H, W)
    live = splat.splat_live_slots(m_proj, radius, mask, (H, W), tile)
    th, tw = tile
    gx, gy, _ = splat.splat_launch_geometry(B, H, W, tile)
    assert live.shape == (B, gy, gx)
    reached = torch.zeros((B, gy, gx), dtype=torch.long)
    for n in range(N):
        one = torch.zeros((B, N), dtype=torch.bool)
        one[:, n] = True
        hm = splat.splat_heatmap_reference(m_proj, cls, sigma, radius, mask & one, noise & one, (H, W), 3)
        pad = torch.zeros((B, gy * th, gx * tw))
        pad[:, :H, :W] = hm.amax(1)
        reached += (pad.reshape(B, gy, th, gx, tw) > 0).any(4).any(2).long()
    assert (live >= reached).all()
    assert (live <= mask.sum(1)[:, None, None]).all()
    unmasked = splat.splat_live_slots(m_proj, radius, torch.zeros_like(mask), (H, W), tile)
    assert int(unmasked.sum()) == 0
