"""The deformable convolution (DCNv2) and the ResNet-101-DCN backbone on the
CPU (``ops/dcn.py``, ``nn/dcn.py``, ``nn/resnet.py``):

- ``dcn_reference``, the kernel's arithmetic in plain PyTorch, equals a
  float64 direct sum of the definition (mmcv's bilinear sampler, corners
  outside the map read 0, positions outside (-1, H) x (-1, W) read 0) at
  offsets of +-4 px, with samples beyond every border and samples at
  exactly integer positions; zero offsets under a mask of 1 are a plain
  3x3 conv; a single offset channel moves its own tap along its own axis;
- ``RESNET-101-DCN`` builds 26 deformable layers, in ``layer3`` and
  ``layer4`` only, in caffe style (stride on ``conv1``), and the plain
  ResNets keep PyTorch's style; ``deepest_stride`` still reads 32;
- one CPU train step of a ResNet-101-DCN model, with and without REMAT,
  gives finite, nonzero gradients to an offset conv;
- where the kernel's path is opened to CPU tensors, every DCN layer goes
  through the wrapper (and counts ``dcn_kernel``); the wrapper raises on
  tensors the kernel does not take; ``torch.export`` composes;
- int8 calibration and serving, and the spatial mesh axis, refuse a DCN
  network.

The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rtm3d_tpu_torch.config import default_config
from rtm3d_tpu_torch.nn import dcn, quant
from rtm3d_tpu_torch.nn.dcn import ModulatedDeformConv
from rtm3d_tpu_torch.nn.model import RTM3D, create_model, deepest_stride
from rtm3d_tpu_torch.nn.resnet import parse_resnet_name
from rtm3d_tpu_torch.ops.dcn import dcn_reference, modulated_deform_conv
from rtm3d_tpu_torch.parallel.spatial import attached
from rtm3d_tpu_torch.utils import profiling

KFNS = ("layer1", "layer2", "layer3", "layer4")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def bilinear(img: np.ndarray, py: float, px: float) -> np.ndarray:
    """mmcv's ``dmcn_im2col_bilinear`` of a (C, H, W) map at (py, px)."""
    H, W = img.shape[1:]
    out = np.zeros(img.shape[0])
    if not (py > -1 and px > -1 and py < H and px < W):
        return out
    y0, x0 = int(np.floor(py)), int(np.floor(px))
    ly, lx = py - y0, px - x0
    for dy, dx, w in ((0, 0, (1 - ly) * (1 - lx)), (0, 1, (1 - ly) * lx), (1, 0, ly * (1 - lx)), (1, 1, ly * lx)):
        if 0 <= y0 + dy < H and 0 <= x0 + dx < W:
            out += w * img[:, y0 + dy, x0 + dx]
    return out


def direct_sum(x: np.ndarray, om: np.ndarray, w: np.ndarray) -> np.ndarray:
    B, _, H, W = x.shape
    y = np.zeros((B, w.shape[0], H, W))
    for b in range(B):
        for h in range(H):
            for c in range(W):
                for k in range(9):
                    i, j = divmod(k, 3)
                    m = 1.0 / (1.0 + np.exp(-om[b, 18 + k, h, c]))
                    s = bilinear(x[b], h - 1 + i + om[b, 2 * k, h, c], c - 1 + j + om[b, 2 * k + 1, h, c])
                    y[b, :, h, c] += w[:, :, i, j] @ (m * s)
    return y


def test_plain_version_equals_the_definition_at_4px():
    """Offsets uniform in +-4 px on a 5 x 6 map (most taps of the border
    pixels sample beyond it, some beyond -1 and H), a third of them whole
    numbers (samples at exactly integer positions, and at exactly -1 and
    H, which read 0); mask logits standard normal. Float64 throughout: the
    two sums differ only in order."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 5, 6, generator=g, dtype=torch.float64)
    om = torch.randn(2, 27, 5, 6, generator=g, dtype=torch.float64)
    om[:, :18] = torch.rand(2, 18, 5, 6, generator=g, dtype=torch.float64) * 8 - 4
    whole = torch.rand(2, 18, 5, 6, generator=g) < 1 / 3
    om[:, :18][whole] = om[:, :18][whole].round()
    w = torch.randn(4, 3, 3, 3, generator=g, dtype=torch.float64)
    want = direct_sum(x.numpy(), om.numpy(), w.numpy())
    got = dcn_reference(x, om, w).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    py = torch.arange(5, dtype=torch.float64).view(1, 1, 5, 1) + om[:, 0:18:2]
    assert (py <= -1).any() and (py >= 5).any() and whole.any()  # the cases named above occur


def test_zero_offsets_and_a_mask_of_one_are_a_plain_conv():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 8, 7, 9, generator=g, dtype=torch.float64)
    w = torch.randn(5, 8, 3, 3, generator=g, dtype=torch.float64)
    om = torch.zeros(2, 27, 7, 9, dtype=torch.float64)
    om[:, 18:] = float("inf")
    torch.testing.assert_close(dcn_reference(x, om, w), F.conv2d(x, w, padding=1), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("tap", [0, 4, 7])
@pytest.mark.parametrize("axis", [0, 1])
def test_one_offset_channel_moves_its_tap_along_its_axis(tap, axis):
    """Channel 2k + axis set to 1 (a whole pixel, so no blending): tap k
    reads the input one pixel further down (axis 0, dy) or right (axis 1,
    dx), zero past the edge; the other eight taps are the plain conv's."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 4, 6, 7, generator=g, dtype=torch.float64)
    w = torch.randn(3, 4, 3, 3, generator=g, dtype=torch.float64)
    om = torch.zeros(1, 27, 6, 7, dtype=torch.float64)
    om[:, 18:] = float("inf")
    om[:, 2 * tap + axis] = 1.0
    xp = F.pad(x, (2, 2, 2, 2))  # a read at -1 or at H (W) is 0
    want = 0
    for k in range(9):
        i, j = divmod(k, 3)
        dy, dx = (1 - axis, axis) if k == tap else (0, 0)
        window = xp[:, :, 1 + i + dy:1 + i + dy + 6, 1 + j + dx:1 + j + dx + 7]
        want = want + torch.einsum("oc,bchw->bohw", w[:, :, i, j], window)
    torch.testing.assert_close(dcn_reference(x, om, w), want, rtol=1e-12, atol=1e-12)
    assert not torch.allclose(want, F.conv2d(x, w, padding=1))


def test_resnet101_dcn_layout():
    """26 deformable convs, every 3x3 conv of layer3 and layer4; caffe
    style (stride on conv1, conv2 at stride 1) everywhere; the plain
    ResNet-101 keeps PyTorch's style (stride on conv2)."""
    assert parse_resnet_name("ResNet-101-DCN") == (101, True) and parse_resnet_name("RESNET-18") == (18, False)
    net = RTM3D("ResNet-101-DCN", kfns=KFNS).backbone
    where = [name for name, m in net.named_modules() if isinstance(m, ModulatedDeformConv)]
    assert len(where) == 26 and {n.split(".")[0] for n in where} == {"layer3", "layer4"}
    assert all(n.endswith(".conv2") for n in where)
    assert len(net.layer3) == 23 and len(net.layer4) == 3
    for layer in ("layer2", "layer3", "layer4"):
        first = getattr(net, layer)[0]
        assert first.conv1.stride == (2, 2) and first.downsample[0].stride == (2, 2)
    assert all(m.conv2.conv_offset.stride == (1, 1) for m in net.layer3)
    assert net.layer2[0].conv2.stride == (1, 1)
    plain = RTM3D("RESNET-101", kfns=KFNS).backbone
    assert plain.layer2[0].conv1.stride == (1, 1) and plain.layer2[0].conv2.stride == (2, 2)
    assert not any(isinstance(m, ModulatedDeformConv) for m in plain.modules())
    with pytest.raises(ValueError, match="Bottleneck"):
        RTM3D("RESNET-18-DCN", kfns=KFNS)
    cfg = default_config()
    cfg.MODEL.BACKBONE, cfg.MODEL.KFNs = "RESNET-101-DCN", list(KFNS)
    assert deepest_stride(cfg) == 32


def dcn_cfg(remat: bool = False):
    cfg = default_config()
    cfg.MODEL.BACKBONE = "RESNET-101-DCN"
    cfg.MODEL.KFNs = list(KFNS)
    cfg.INPUT_SIZE = (96, 64)
    cfg.DATASET.MAX_OBJS = 8
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.REMAT = remat
    return cfg


def train_batch(rng, B=2, N=8):
    """uint8 96x64 frames and N label slots an image."""
    x1, y1 = rng.rand(B, N) * 70, rng.rand(B, N) * 44
    labels = {
        "cls": rng.randint(0, 3, (B, N)).astype(np.int32),
        "bbox": np.stack([x1, y1, x1 + 22, y1 + 16], -1).astype(np.float32),
        "dim": (rng.rand(B, N, 3) + 0.8).astype(np.float32), "alpha": np.zeros((B, N), np.float32),
        "ry": rng.uniform(-3, 3, (B, N)).astype(np.float32),
        "loc": np.stack([rng.randn(B, N), rng.randn(B, N) * 0.2 + 1, rng.rand(B, N) * 20 + 8], -1).astype(np.float32),
        "K": np.tile(np.array([60.0, 0, 48, 0, 60.0, 32, 0, 0, 1], np.float32), (B, N, 1)),
        "mask": rng.rand(B, N) > 0.2, "noise_mask": rng.rand(B, N) > 0.9,
    }
    return {"image": (rng.rand(B, 64, 96, 3) * 255).astype(np.uint8), "labels": labels}


@pytest.mark.parametrize("remat", [False, True])
def test_a_train_step_reaches_the_offset_convs(remat):
    """One CPU train step (REMAT on and off: the checkpointed stages
    recompute the composed DCN): a finite loss, and finite, nonzero
    gradients in an offset conv of layer3 and of layer4."""
    from rtm3d_tpu_torch.train.state import TrainState
    from rtm3d_tpu_torch.train.step import make_train_step

    cfg = dcn_cfg(remat)
    state = TrainState.create(create_model(cfg, torch.Generator().manual_seed(0)), cfg, device="cpu")
    state, m = make_train_step(cfg, device="cpu")(state, train_batch(np.random.RandomState(6)))
    assert torch.isfinite(m["loss_items"]).all()
    for conv in (state.model.backbone.layer3[5].conv2, state.model.backbone.layer4[2].conv2):
        grad = conv.conv_offset.weight.grad
        assert grad is not None and torch.isfinite(grad).all() and grad.abs().max() > 0


def test_the_kernels_path_runs_every_layer_through_the_wrapper(monkeypatch):
    """With the kernel's path opened to CPU tensors (the condition stood in
    for), an inference forward takes the wrapper in all 26 layers (its
    checks, then the plain version on the CPU) and counts ``dcn_kernel``
    while a profiler records; the composed forward gives the same logits."""
    model = create_model(dcn_cfg(), torch.Generator().manual_seed(3)).eval().to(memory_format=torch.channels_last)
    x = torch.randn(1, 3, 64, 96, generator=torch.Generator().manual_seed(4)).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        composed = model(x)
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return modulated_deform_conv(*args)

    monkeypatch.setattr(dcn, "modulated_deform_conv", spy)
    monkeypatch.setattr(dcn, "kernel_may_run", lambda x: not torch.is_grad_enabled())
    before = profiling.counters["dcn_kernel"]
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = model(x)
    assert len(calls) == 26 and profiling.counters["dcn_kernel"] == before + 26
    for a, b in zip(got, composed):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fault,match", [
    ("nchw", "channels_last"), ("c_in", "multiple of 32"), ("c_out", "multiple of 128"),
    ("dtypes", "one dtype"), ("float16", "one dtype"), ("offsets", "offsets of shape"),
])
def test_wrapper_raises_on_tensors_the_kernel_does_not_take(fault, match):
    c_in = 48 if fault == "c_in" else 32
    c_out = 64 if fault == "c_out" else 128
    x = torch.randn(1, c_in, 4, 5).contiguous(memory_format=torch.channels_last)
    om = torch.randn(1, 18 if fault == "offsets" else 27, 4, 5).contiguous(memory_format=torch.channels_last)
    w = torch.randn(c_out, c_in, 3, 3).contiguous(memory_format=torch.channels_last)
    if fault == "nchw":
        x = x.contiguous()
    elif fault == "dtypes":
        om = om.bfloat16()
    elif fault == "float16":
        x, om, w = x.half(), om.half(), w.half()
    with pytest.raises(ValueError, match=match):
        modulated_deform_conv(x, om, w)


def test_export_composes(monkeypatch):
    """Under ``torch.export`` the layer composes even where the kernel's
    path is open (the trace is compiling): the program holds the plain
    version's gathers, never calls the wrapper, and equals eager."""
    layer = ModulatedDeformConv(32, 128).eval()
    monkeypatch.setattr(dcn, "kernel_may_run", lambda x: not torch.compiler.is_compiling())
    monkeypatch.setattr(dcn, "modulated_deform_conv", lambda *a: pytest.fail("the wrapper ran under export"))
    x = torch.randn(1, 32, 5, 6)
    ep = torch.export.export(layer, (x,))
    assert any(n.target == torch.ops.aten.gather.default for n in ep.graph.nodes)
    with torch.no_grad():
        torch.testing.assert_close(ep.module()(x), dcn_reference(x, layer.conv_offset(x), layer.conv.weight))


def test_int8_and_the_spatial_axis_refuse_a_dcn_network():
    """int8 calibration and serving refuse the network; a layer on a band
    of the spatial mesh axis (a grid attached as the train and eval-loss
    steps attach it) raises."""
    model = RTM3D("RESNET-101-DCN", kfns=KFNS)
    with pytest.raises(ValueError, match="int8 serving"):
        quant.quantize_model(model, {})
    with pytest.raises(ValueError, match="int8 calibration"):
        quant.calibrate_act_scales(model, [])
    layer = ModulatedDeformConv(32, 128)
    with attached(layer, object()), pytest.raises(ValueError, match="band"):
        layer(torch.randn(1, 32, 4, 4))
    layer(torch.randn(1, 32, 4, 4))  # detached again: the layer runs
