"""The int8 kernels on the card: ``quantize`` and ``conv_s8`` of
``csrc/int8_conv.cu`` against their plain versions (bit-equal: the rounding
is IEEE in both and the integer sums are exact), and an int8 network on the
GPU against the same network on the CPU, conv by conv.

This file imports neither JAX nor the JAX package. On a machine with a CUDA
device, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_int8.py -q

Without a device every test skips with its reason.
"""

import copy

import numpy as np
import pytest
import torch

from rtm3d_tpu_torch.config import default_config
from rtm3d_tpu_torch.nn import quant
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.ops import int8_conv
from rtm3d_tpu_torch.train.step import make_detect_step


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (cin, cout, k, stride, dilation, h, w): the stem (cin 3), a cout-3 head,
# strided and dilated 3x3s, a 1x1 on a ragged pixel count, cin 16 (K = 144,
# not a multiple of 32), cout not a multiple of the tile
SHAPES = [
    (3, 16, 7, 1, 1, 37, 61),
    (256, 3, 1, 1, 1, 13, 40),
    (16, 32, 3, 2, 1, 33, 70),
    (64, 64, 3, 1, 2, 20, 24),
    (128, 256, 1, 1, 1, 7, 9),
    (16, 16, 3, 1, 1, 11, 13),
    (32, 96, 3, 1, 1, 9, 17),
]


def conv_case(seed, cin, cout, k, stride, dil, h, w, n=2, dtype=torch.float32, channels_last=True):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, cin, h, w), generator=g).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    scale = (torch.rand((cin,), generator=g) * 0.05 + 0.005).float()
    wq = torch.randint(-127, 128, (cout, cin, k, k), generator=g, dtype=torch.int8)
    out_scale = (torch.rand((cout,), generator=g) * 1e-3).float()
    bias = torch.randn((cout,), generator=g).float()
    return x, scale, wq, out_scale, bias


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_bit_equal_to_plain(cuda, shape, dtype):
    cin, cout, k, stride, dil, h, w = shape
    x, scale, wq, out_scale, bias = conv_case(sum(shape), *shape, dtype=dtype)
    cp = int8_conv.padded_channels(cin)
    pad = dil * (k - 1) // 2
    packed = int8_conv.pack_weight(wq)
    want_q = int8_conv.quantize_reference(x, scale, cp)
    want = int8_conv.conv_s8_reference(want_q, packed, (k, k), stride, pad, dil, out_scale, bias, dtype)
    q0, c0 = int8_conv.quantize.launches, int8_conv.conv_s8.launches
    got_q = int8_conv.quantize(x.to(cuda), scale.to(cuda), cp)
    got = int8_conv.conv_s8(got_q, packed.to(cuda), (k, k), stride, pad, dil, out_scale.to(cuda),
                            bias.to(cuda), dtype)
    torch.cuda.synchronize()
    assert (int8_conv.quantize.launches, int8_conv.conv_s8.launches) == (q0 + 1, c0 + 1)
    assert torch.equal(got_q.cpu(), want_q)
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.equal(got.cpu(), want), (got.cpu().float() - want.float()).abs().max()
    # no bias, and an NCHW-contiguous input read through its strides
    got = int8_conv.conv_s8(int8_conv.quantize(x.contiguous().to(cuda), scale.to(cuda), cp), packed.to(cuda),
                            (k, k), stride, pad, dil, out_scale.to(cuda), None, dtype)
    want = int8_conv.conv_s8_reference(want_q, packed, (k, k), stride, pad, dil, out_scale, None, dtype)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_quantize_rounds_half_to_even_and_clips(cuda):
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 300.0, -300.0, 126.5, -126.5, 0.0, 1e30, -1e30],
                     dtype=torch.float32).view(1, 12, 1, 1)
    scale = torch.ones(12)
    got = int8_conv.quantize(x.to(cuda), scale.to(cuda), 12).cpu().view(-1).tolist()
    assert got == [0, 2, 2, 0, -2, 127, -127, 126, -126, 0, 127, -127]
    assert int8_conv.quantize_reference(x, scale, 12).view(-1).tolist() == got


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_take(cuda):
    x, scale, wq, out_scale, bias = conv_case(0, 16, 16, 3, 1, 1, 8, 8)
    packed = int8_conv.pack_weight(wq).to(cuda)
    xq = int8_conv.quantize(x.to(cuda), scale.to(cuda), 16)
    with pytest.raises(ValueError):
        int8_conv.quantize(x.to(cuda).half(), scale.to(cuda), 16)
    with pytest.raises(ValueError):
        int8_conv.conv_s8(xq, packed[:, :100], (3, 3), 1, 1, 1, out_scale.to(cuda), None, torch.float32)
    with pytest.raises(ValueError):
        int8_conv.conv_s8(xq, packed, (3, 3), 1, 1, 1, out_scale.to(cuda), None, torch.float16)
    with pytest.raises(ValueError):
        int8_conv.conv_s8(xq, packed.cpu(), (3, 3), 1, 1, 1, out_scale.to(cuda), None, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_network_on_the_card_matches_the_cpu_conv_by_conv(cuda, dtype):
    """DLA-34 at 128x128, calibrated on the CPU, served int8 on the card:
    each int8 conv's own input on the card, through the CPU's plain
    versions, gives the card's output bit for bit. (Free-running, the two
    networks part: an input an ulp away on the other side of a rounding edge
    changes an int8 value, and the change travels; chip_smoke.py's
    int8_logits phase measures that.) The detect step launches each kernel
    once per int8 conv and returns finite scores."""
    cfg = default_config()
    cfg.INPUT_SIZE = (128, 128)
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.DETECTOR.TOPK_CANDIDATES = 20
    model = create_model(cfg, torch.Generator().manual_seed(0)).eval()
    frames = (np.random.RandomState(0).rand(2, 128, 128, 3) * 255).astype(np.uint8)
    x = torch.from_numpy(frames).float() / 255.0 - 0.5
    scales = quant.calibrate_act_scales(model, [x], method="absmax")
    qmodel = quant.quantize_model(model, quant.skip_scales(scales, ("/head",)))
    tdt = getattr(torch, dtype)
    gpu = copy.deepcopy(qmodel).to(cuda, tdt).to(memory_format=torch.channels_last)
    cpu = copy.deepcopy(qmodel).to(tdt)
    seen = []
    hooks = [m.register_forward_hook(lambda mod, a, o, n=n: seen.append((n, a[0].cpu(), o.cpu())))
             for n, m in gpu.named_modules() if isinstance(m, quant.QuantConv)]
    with torch.no_grad():
        gpu(x.to(cuda, tdt).permute(0, 3, 1, 2))
        for hk in hooks:
            hk.remove()
        cpu_mods = dict(cpu.named_modules())
        assert len(seen) == sum(isinstance(m, quant.QuantConv) for m in qmodel.modules()) - 2  # 2 dead projections
        for name, xin, out in seen:
            assert torch.equal(cpu_mods[name](xin), out), name
    c0 = int8_conv.conv_s8.launches
    det = make_detect_step(qmodel, cfg, with_3d=False, device=cuda)(frames, np.tile(np.eye(3, dtype=np.float32),
                                                                                     (2, 1, 1)))
    torch.cuda.synchronize()
    assert int8_conv.conv_s8.launches - c0 == len(seen)
    assert torch.isfinite(det["scores"]).all() and det["scores"].shape == (2, 20)
