"""The int8 conv kernel's variants, on the CPU: every conv shape of the two
served backbones maps to a variant of ``csrc/int8_conv.cu``'s ``conv_s8``
whose constraints hold (``ops/int8_conv.py::conv_variant``, the choice the
wrapper makes before a launch), and ``pack_weight`` followed by the plain
``conv_s8_reference`` equals ``F.conv2d`` on the int8 values.

This file imports neither JAX nor the JAX package, and needs no card: the
kernels themselves are held to these plain versions on the card by
``tests/test_torch_cuda_int8.py`` and ``chip_smoke.py``'s ``int8_kernel``.
"""

import os

import pytest
import torch
import torch.nn.functional as F

from rtm3d_tpu_torch.config import load_config
from rtm3d_tpu_torch.nn import quant
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.ops import int8_conv

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
MODELS = {"dla34": "rtm3d_dla34_kitti_tpu.yaml", "resnet18": "rtm3d_resnet18_kitti.yaml"}
SERVED_HW = (416, 1280)  # the detect path's 1280x416 input
TMA_BOX_MAX = 256  # a TMA box's extent in any dimension
SWIZZLE_SPAN = 128  # bytes of the 128-byte swizzle: the box's inner extent, one wgmma row


@pytest.fixture(scope="module")
def shapes():
    """{model: its distinct conv shapes at 1280x416 (cin, cout, k, stride,
    pad, dil, h, w) -> served int8 in a forward}, from a forward on the meta
    device."""
    out = {}
    for name, config in MODELS.items():
        cfg = load_config(os.path.join(CONFIGS, config))
        cfg.INPUT_SIZE = SERVED_HW[::-1]
        with torch.device("meta"):
            model = create_model(cfg).eval()
        convs = quant.conv_shapes(model, *SERVED_HW, tuple(cfg.TPU.INT8_SKIP))
        sigs = {}
        for c in convs:
            sig = tuple(c[k] for k in ("cin", "cout", "k", "stride", "pad", "dil", "h", "w"))
            sigs[sig] = sigs.get(sig, False) or c["served"]
        out[name] = sigs
    return out


def test_conv_shapes_finds_every_conv(shapes):
    """DLA-34: 58 convs in 32 shapes, 52 served int8 in 29 (the dead
    projections and INT8_SKIP's heads not); ResNet-18 in 23 shapes."""
    assert len(shapes["dla34"]) == 32 and sum(shapes["dla34"].values()) == 29
    assert len(shapes["resnet18"]) == 23
    assert (3, 16, 7, 1, 3, 1, 416, 1280) in shapes["dla34"] and (3, 64, 7, 2, 3, 1, 416, 1280) in shapes["resnet18"]


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("batch", [2, 32])
def test_every_conv_maps_to_a_variant_whose_constraints_hold(shapes, model, batch):
    for (cin, cout, k, stride, pad, dil, h, w), served in shapes[model].items():
        cp = int8_conv.padded_channels(cin)
        kp = int8_conv.padded_taps(k * k * cp)
        ho, wo = int8_conv.out_hw(h, w, (k, k), stride, pad, dil)
        v = int8_conv.conv_variant(batch, h, w, cp, cout, (k, k), stride, pad, dil, kp)
        shape = (cin, cout, k, stride, pad, dil, h, w, v["name"])
        # the N tile: the narrowest wgmma width that holds Cout, or 256 and more tiles
        bn = v["bn"]
        assert bn in int8_conv.N_TILES and bn == min(b for b in int8_conv.N_TILES if b >= min(cout, 256)), shape
        assert v["tiles"][1] == -(-cout // bn) <= 65535, shape
        # K: whole 32-byte wgmma steps, 128-byte ring chunks, a last chunk of 1-4 steps
        assert kp % int8_conv.TILE_K == 0 and kp >= k * k * cp and kp % 16 == 0, shape
        assert v["k_tiles"] == -(-kp // int8_conv.CHUNK), shape
        assert 1 <= (kp - int8_conv.CHUNK * (v["k_tiles"] - 1)) // int8_conv.TILE_K <= 4, shape
        assert v["stages"] >= 3, shape
        for itemsize in (2, 4):
            smem = int8_conv.conv_variant(batch, h, w, cp, cout, (k, k), stride, pad, dil, kp, itemsize)["smem"]
            assert smem <= int8_conv.SMEM_LIMIT, shape
        if bn <= 64:  # bf16, as served: two blocks on an SM at N 32 and 64, three at N 16 (228 KB, 1 KB a block reserved)
            assert (3 if bn == 16 else 2) * (v["smem"] + 1024) <= 233_472, shape
        if v["load"] != "tma":  # the gather's table holds every piece of K
            assert -(-k * k * cp // (16 if v["load"] == "gather16" else 4)) <= int8_conv.MAX_PIECES, shape
        assert batch * h * w * cp < int8_conv.MAX_BYTES and batch * ho * wo < int8_conv.MAX_BYTES, shape
        if v["load"] == "tma":
            # one tap's 128 channels a box: stride 1 (the box walks output
            # pixels one input pixel apart), whole 128-byte chunks of a tap,
            # no K padding, and a 128-pixel tile of bh rows by bw columns
            assert stride == 1 and cp % int8_conv.CHUNK == 0 and kp == k * k * cp, shape
            assert v["bh"] * v["bw"] == int8_conv.TILE_M and max(v["bh"], v["bw"]) <= TMA_BOX_MAX, shape
            assert int8_conv.CHUNK == SWIZZLE_SPAN and cp % 16 == 0, shape  # box inner extent, 16-byte strides
            assert v["tiles"][0] == batch * -(-ho // v["bh"]) * -(-wo // v["bw"]), shape
            # the tile is shaped to the rows: no wider than needed, and no more pixels than any other width
            covered = -(-ho // v["bh"]) * v["bh"] * -(-wo // v["bw"]) * v["bw"]
            assert all(covered <= -(-ho // (128 // bw)) * (128 // bw) * -(-wo // bw) * bw
                       for bw in (8, 16, 32, 64, 128)), shape
        else:
            # a 16-byte piece (gather16) or a 4-byte one (gather4) lies in one
            # tap and is aligned, since every pixel starts Cp bytes after the last
            assert cp % (16 if v["load"] == "gather16" else 4) == 0, shape
            assert v["load"] == ("gather16" if cp % 16 == 0 else "gather4"), shape
            assert v["tiles"][0] == -(-(batch * ho * wo) // int8_conv.TILE_M), shape
        if served:
            # every served conv's output rows take the coalesced 16-byte stores (bf16)
            assert cout * 2 % 16 == 0, shape


def test_wide_convs_take_tma_and_thin_ones_their_own_tile(shapes):
    """The design's split, as the served DLA-34 shapes take it: the header's
    3x3s and the backbone's stride-1 convs at 128 channels and more by TMA
    with tiles shaped to their rows, the stem by 4-byte gathers, the
    full-resolution 16- and 32-channel convs at N tiles 16 and 32."""
    names = {}
    for (cin, cout, k, stride, pad, dil, h, w), served in shapes["dla34"].items():
        cp = int8_conv.padded_channels(cin)
        names[(cin, cout, k, stride, dil, h)] = int8_conv.conv_variant(
            32, h, w, cp, cout, (k, k), stride, pad, dil, int8_conv.padded_taps(k * k * cp))["name"]
    assert names[(256, 256, 3, 1, 6, 104)] == names[(256, 256, 3, 1, 1, 104)] == "tma_n256_2x64"
    assert names[(128, 128, 3, 1, 1, 52)] == "tma_n128_4x32"
    assert names[(512, 512, 3, 1, 1, 13)] == "tma_n256_16x8"
    assert names[(3, 16, 7, 1, 1, 416)] == "gather4_n16"
    assert names[(16, 16, 3, 1, 1, 416)] == "gather16_n16"
    assert names[(16, 32, 3, 2, 1, 416)] == "gather16_n32"


def test_no_variant_takes_past_32_bit_offsets_or_a_bad_packing():
    with pytest.raises(ValueError, match="no kernel variant"):
        int8_conv.conv_variant(1, 16384, 32768, 4, 16, (1, 1), 1, 0, 1, 32)  # 2^31 input bytes
    with pytest.raises(ValueError, match="no kernel variant"):
        int8_conv.conv_variant(1, 8, 8, 6, 16, (1, 1), 1, 0, 1, 32)  # Cp not a multiple of 4
    with pytest.raises(ValueError, match="no kernel variant"):
        int8_conv.conv_variant(1, 8, 8, 16, 16, (3, 3), 1, 1, 1, 128)  # Kp < 9 * 16
    assert int8_conv.conv_variant(1, 16383, 32768, 4, 16, (1, 1), 1, 0, 1, 32)["load"] == "gather4"


@pytest.mark.parametrize("model", sorted(MODELS))
def test_pack_weight_then_the_plain_conv_equals_conv2d_on_the_int8_values(shapes, model):
    """For every conv shape of the model, at 12x20 (the kernel, stride,
    padding and dilation as served), batch 2, with a bias and per output
    channel scales: F.conv2d in float64 on the int8 input and weights (the
    channels unpadded), scaled as the epilogue scales, equals the plain
    version's output from ``quantize_reference``'s padded NHWC input and
    the packed weights, bit for bit, in float32 and bf16."""
    g = torch.Generator().manual_seed(len(model))
    for cin, cout, k, stride, pad, dil, _, _ in shapes[model]:
        h, w = 12 + 2 * dil, 20 + 2 * dil
        xq = torch.randint(-127, 128, (2, cin, h, w), generator=g, dtype=torch.int8)
        wq = torch.randint(-127, 128, (cout, cin, k, k), generator=g, dtype=torch.int8)
        out_scale = torch.rand((cout,), generator=g) * 1e-3
        bias = torch.randn((cout,), generator=g)
        cp = int8_conv.padded_channels(cin)
        packed = int8_conv.pack_weight(wq)
        assert packed.shape == (cout, int8_conv.padded_taps(k * k * cp)) and packed.dtype == torch.int8
        # the NHWC int8 input as quantize writes it: unit scale, channels padded with zeros
        x_nhwc = int8_conv.quantize_reference(xq.float(), torch.ones(cin), cp)
        assert torch.equal(x_nhwc[..., :cin].permute(0, 3, 1, 2), xq)
        acc = F.conv2d(xq.double(), wq.double(), stride=stride, padding=pad, dilation=dil)
        for dtype in (torch.float32, torch.bfloat16):
            want = (acc.float().permute(0, 2, 3, 1) * out_scale + bias).to(dtype)
            got = int8_conv.conv_s8_reference(x_nhwc, packed, (k, k), stride, pad, dil, out_scale, bias, dtype)
            assert torch.equal(got, want), (cin, cout, k, stride, pad, dil, dtype)
