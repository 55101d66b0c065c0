"""The KFPN's softmax-attention fusion on the CPU (``ops/kfpn_fuse.py``,
``nn/kfpn.py``):

- ``kfpn_fuse_reference``, the kernel's arithmetic in plain PyTorch (one
  max and one sum of exponentials per channel, then the weighted sum),
  equals the KFPN's composed loop in float64 for 2, 3 and 4 levels, on
  maps whose H x W is no multiple of the kernel's pixel split;
- ``KeypointFPNFusion.forward`` keeps the composed path with grad
  enabled, with a spatial grid attached, under autocast and on the CPU;
  where the fused path is opened to CPU maps (``kernel_may_run``
  stood in for) it takes it, through ``kfpn_fuse``'s plain version, and
  raises on maps the kernel does not take rather than composing them;
- ``nn/layers.py::kernel_may_run`` opens the fused path to a (fake) CUDA map
  with autograd and autocast off, and to nothing else;
- the wrapper raises on maps the kernel does not take: an NCHW map, a
  channel count not a multiple of 8, mixed dtypes, float16, an image of
  2**31 values.

The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import contextlib

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from rtm3d_tpu_torch.nn import kfpn
from rtm3d_tpu_torch.nn.spec import ShapeSpec
from rtm3d_tpu_torch.ops.kfpn_fuse import (
    kfpn_fuse, kfpn_fuse_apply_blocks, kfpn_fuse_bytes, kfpn_fuse_reference, kfpn_fuse_stats_slices,
)
from rtm3d_tpu_torch.parallel.spatial import Grid

B, OUT = 2, 8
DEEPEST_HW = (3, 5)  # the deepest level's map; stride 4 is 2**(levels-1) times larger


def fusion(levels: int, dtype=torch.float32):
    """A KFPN of ``levels`` levels (strides 4, 8, ...) and its feature maps,
    both channels_last, seeded."""
    torch.manual_seed(levels)
    names = [f"l{i}" for i in range(levels)]
    chans = [16, 24, 32, 40][:levels]
    spec = {n: ShapeSpec(channels=c, stride=4 * 2 ** i) for i, (n, c) in enumerate(zip(names, chans))}
    module = kfpn.KeypointFPNFusion(names, spec, out_channels=OUT).to(dtype=dtype, memory_format=torch.channels_last)
    with torch.no_grad():  # larger maps, so that the softmax weights are far from uniform
        for p in module.parameters():
            p.mul_(1.5)
    h, w = DEEPEST_HW
    feats = [(3 * torch.randn(B, c, h * 2 ** (levels - 1 - i), w * 2 ** (levels - 1 - i), dtype=dtype))
             .contiguous(memory_format=torch.channels_last) for i, c in enumerate(chans)]
    return module, feats


def captured(module, feats):
    """The module's output, with the x0 and upsampled maps its fusion
    weighed (in the loop's order), caught by forward hooks."""
    lv = module.levels
    seen = {}
    hooks = [getattr(module, f"kfpn_head{lv[0]}").register_forward_hook(lambda m, i, o: seen.__setitem__("x0", o))]
    for i in range(len(lv) - 1, 0, -1):
        hooks.append(getattr(module, f"fusion_up{lv[i]}").register_forward_hook(
            lambda m, inp, o, i=i: seen.__setitem__(i, o)))
    try:
        z = module(feats)
    finally:
        for h in hooks:
            h.remove()
    return z, seen["x0"], [seen[i] for i in range(len(lv) - 1, 0, -1)]


@pytest.mark.parametrize("levels", [2, 3, 4])
def test_reference_equals_the_composed_loop_in_float64(levels):
    module, feats = fusion(levels, torch.float64)
    with torch.no_grad():
        z, x0, ups = captured(module, feats)
    assert len(ups) == levels - 1
    h, w = DEEPEST_HW
    assert ups[0].shape[-2:] == (h * 2 ** (levels - 1), w * 2 ** (levels - 1))
    ref = kfpn_fuse_reference(x0, ups)
    assert ref.dtype == torch.float64
    torch.testing.assert_close(ref, z, rtol=1e-12, atol=1e-12)
    for u in ups:  # the weights are far from uniform
        att = torch.softmax(u.reshape(B, OUT, -1), -1)
        assert att.max() > 2 * att.mean()


def test_reference_rounds_once_in_bf16_closer_than_the_composition():
    """In bf16 the plain version rounds once, where the composition rounds
    each weight, product and partial sum: its error against float64 is
    within half a bf16 ulp, and no larger than the composition's."""
    module, feats = fusion(3)
    with torch.no_grad():
        _, x0, ups = captured(module, feats)
    x0, ups = x0.bfloat16(), [u.bfloat16() for u in ups]
    got = kfpn_fuse_reference(x0, ups)
    exact = kfpn_fuse_reference(x0.double(), [u.double() for u in ups])
    composed = x0
    for u in ups:
        composed = composed + u * torch.softmax(u.reshape(B, OUT, -1), -1).reshape(u.shape)
    assert got.dtype == torch.bfloat16
    err = (got.double() - exact).abs()
    assert (err <= exact.abs() * 2 ** -8 + 1e-6).all()
    assert err.max() <= (composed.double() - exact).abs().max()
    assert torch.equal(kfpn_fuse(x0, ups), got)  # CPU maps take the plain version


@pytest.mark.parametrize("case", ["grad", "spatial", "autocast", "cpu", "open"])
def test_forward_path(case, monkeypatch):
    """``case`` "open": the fused path opened to CPU maps, with grad
    disabled, so it runs (through kfpn_fuse's plain version); "spatial":
    opened too, but a grid is attached; every other case composes."""
    module, feats = fusion(3)
    with torch.no_grad():
        composed = module(feats)
    calls = []

    def spy(x0, ups):
        calls.append(len(ups))
        return kfpn_fuse(x0, ups)

    monkeypatch.setattr(kfpn, "kfpn_fuse", spy)
    if case in ("spatial", "open"):
        monkeypatch.setattr(kfpn, "kernel_may_run", lambda x0: True)
    if case == "spatial":
        class OneBand(Grid):
            def all_reduce(self, t, op=None):
                return t

        module.spatial = OneBand([(0, feats[0].shape[2] * 4)], 0)
    ctx = {"grad": torch.enable_grad(), "autocast": torch.autocast("cpu", dtype=torch.bfloat16)}.get(
        case, contextlib.nullcontext())
    with ctx, torch.set_grad_enabled(case == "grad"):
        z = module(feats)
    assert calls == ([2] if case == "open" else [])
    assert z.requires_grad == (case == "grad")
    if case != "autocast":
        torch.testing.assert_close(z.float(), composed, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fault,match", [("nchw", "channels_last"), ("channels", "multiple of 8")])
def test_forward_raises_where_the_kernel_refuses_the_maps(fault, match, monkeypatch):
    """With the fused path open, maps the kernel does not take raise from
    the forward: no composed fallback."""
    module, feats = fusion(3)
    if fault == "nchw":
        module, feats = module.to(memory_format=torch.contiguous_format), [f.contiguous() for f in feats]
    else:
        names = [f"l{i}" for i in range(3)]
        spec = {n: ShapeSpec(channels=c, stride=4 * 2 ** i) for i, (n, c) in enumerate(zip(names, [16, 24, 32]))}
        module = kfpn.KeypointFPNFusion(names, spec, out_channels=12).to(memory_format=torch.channels_last)
    monkeypatch.setattr(kfpn, "kernel_may_run", lambda x0: True)
    with torch.no_grad(), pytest.raises(ValueError, match=match):
        module(feats)


@pytest.mark.parametrize("case,opens", [("inference", True), ("grad", False), ("autocast", False), ("cpu", False)])
def test_fusion_kernel_may_run(case, opens):
    """On a fake CUDA map (no device needed): open with autograd and
    autocast off, shut with either on; shut for a CPU map."""
    if case == "cpu":
        x0 = torch.empty(1, 8, 2, 2)
    else:
        with FakeTensorMode():
            x0 = torch.empty(1, 8, 2, 2, device="cuda")
    was = torch.is_autocast_enabled("cuda")
    torch.set_autocast_enabled("cuda", case == "autocast")
    try:
        with torch.set_grad_enabled(case == "grad"):
            assert kfpn.kernel_may_run(x0) == opens
    finally:
        torch.set_autocast_enabled("cuda", was)


def maps(C=16, dtype=torch.float32, shape=(2, 6, 10)):
    b, h, w = shape
    return [torch.randn(b, C, h, w, dtype=dtype).contiguous(memory_format=torch.channels_last) for _ in range(4)]


@pytest.mark.parametrize("fault,match", [
    ("nchw", "channels_last"),
    ("channels", "multiple of 8"),
    ("dtypes", "one dtype"),
    ("no_ups", "1 to 4"),
    ("shapes", "one \\(B, C, H, W\\) shape"),
    ("float16", "one dtype"),
    ("image_values", "fewer than 2\\*\\*31"),
])
def test_wrapper_raises_on_maps_the_kernel_does_not_take(fault, match):
    x0, *ups = maps(C=12 if fault == "channels" else 16)
    if fault == "nchw":
        ups[1] = ups[1].contiguous()
    elif fault == "dtypes":
        ups[2] = ups[2].bfloat16()
    elif fault == "no_ups":
        ups = []
    elif fault == "shapes":
        ups[0] = ups[0][:, :, :5].contiguous(memory_format=torch.channels_last)
    elif fault == "float16":
        x0, ups = x0.half(), [u.half() for u in ups]
    elif fault == "image_values":  # 2**31 values an image, on the meta device: no memory
        x0, *ups = [torch.empty(1, 1024, 2 ** 11, 2 ** 10, device="meta").contiguous(memory_format=torch.channels_last)
                    for _ in range(4)]
    with pytest.raises(ValueError, match=match):
        kfpn_fuse(x0, ups)


def test_bytes_of_the_detect_paths_fusion():
    # b32 x 256 x 104 x 320 in bf16, three upsampled maps: 8 maps' bytes
    assert kfpn_fuse_bytes(32, 256, (104, 320), 3, 2) == 8 * 32 * 256 * 104 * 320 * 2


@pytest.mark.parametrize("batch,stats_blocks,apply_blocks", [(32, 768, 544), (1, 192, 528)])
def test_launch_geometry_covers_the_card(batch, stats_blocks, apply_blocks):
    """At the detect path's 256 x 104 x 320 maps (3 upsampled) on 132 SMs:
    the statistics grid (8 blocks a map, image and channel slice) has a
    block for every SM at b1 as at b32, the slices of 32 channels or more;
    the apply grid about four an SM, none without a pixel."""
    slices = kfpn_fuse_stats_slices(batch, 256, 3, 132)
    assert 256 % (8 * slices) == 0 and 256 // slices >= 32
    assert 8 * batch * 3 * slices == stats_blocks >= 132
    blocks_x = kfpn_fuse_apply_blocks(batch, 256, 104 * 320, 132)
    assert blocks_x * batch == apply_blocks
    assert (blocks_x - 1) * (256 // 32) < 104 * 320
