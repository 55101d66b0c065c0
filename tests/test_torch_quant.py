"""The port's int8 post-training quantization (``nn/quant.py``,
``ops/int8_conv.py``) against the JAX package's (``rtm3d_tpu/nn/quant.py``),
on the CPU, with weights carried across by ``state_dict_from_jax`` and
inputs drawn with numpy.

Tolerances, each measured here first:
- the plain int8 convolution: int32 results bit-equal to JAX's
  ``conv_general_dilated`` on int8 with ``preferred_element_type=int32``;
- one quantized conv on the same input (per tensor, per channel, a dead
  channel, with and without bias): bit-equal to JAX's ``_quantized_conv``
  run eagerly. (Under ``jit`` XLA turns the division by the constant scale
  into a multiplication by its reciprocal, which rounds ~2e-5 of the
  activations to the other integer; the port divides as the eager program
  does, in IEEE arithmetic.)
- calibration values: rtol 1e-3 (measured at most 1.1e-4: the port's fp32
  activations differ from JAX's in the last bits, and a percentile or a max
  picks up that difference);
- a percentile over a tensor of more than 2^24 elements: bit-equal to
  ``jnp.quantile`` (linear rule, float32);
- quantized logits of DLA-34 and ResNet-18 at 64x64, absmax scales: at
  fp32 within 1e-5 of the largest |logit| (measured 1.8e-6: every conv's
  int8 input is the same on these inputs; with other scales a value a few
  ulps away from a rounding edge in one stack can round to the other
  integer, and the difference travels: 4.8% of the largest was seen with
  the mse scales of DLA-34); at bf16, where the two frameworks round
  BatchNorm and the adds at other places, max |d| within 0.15 and mean |d|
  within 0.03 of the largest (measured 0.068 and 0.013).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtm3d_tpu.config import default_config as default_config_jax
from rtm3d_tpu.nn import quant as quant_jax
from rtm3d_tpu.nn.layers import Conv as ConvJax
from rtm3d_tpu_torch.config import default_config
from rtm3d_tpu_torch.nn import quant
from rtm3d_tpu_torch.nn.layers import Conv
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.ops import int8_conv
from rtm3d_tpu_torch.train.checkpoint import state_dict_from_jax
from rtm3d_tpu_torch.train.step import make_detect_step
from tests.test_torch_model import jax_variables

KFNS = ["layer1", "layer2", "layer3", "layer4"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def model_pair(backbone, hw=64):
    cfg_jax, cfg = default_config_jax(), default_config()
    for c in (cfg_jax, cfg):
        c.INPUT_SIZE = (hw, hw)
        if backbone != "DLA-34":
            c.MODEL.BACKBONE = backbone
            c.MODEL.KFNs = list(KFNS)
    model, variables = jax_variables(cfg_jax)
    port = create_model(cfg)
    port.load_state_dict(state_dict_from_jax(variables, port), strict=True)
    return model, variables, port.eval(), cfg


@pytest.fixture(scope="module", params=["DLA-34", "RESNET-18"])
def pair(request):
    return request.param, *model_pair(request.param)


def frames(seed=0, n=2, hw=64):
    return np.random.RandomState(seed).randn(n, hw, hw, 3).astype(np.float32) * 0.5


# (cin, cout, k, stride, dilation): k 1/3/7, stride 1/2, a dilated 3x3, the
# 3-channel stem, a 3-channel output (the hm head), K not a multiple of 32
CONVS = [(3, 16, 7, 2, 1), (3, 8, 7, 1, 1), (16, 3, 1, 1, 1), (16, 24, 3, 2, 1), (32, 16, 3, 1, 2),
         (64, 32, 1, 2, 1), (20, 12, 3, 1, 1)]


@pytest.mark.parametrize("shape", CONVS, ids=[f"cin{c[0]}_cout{c[1]}_k{c[2]}_s{c[3]}_d{c[4]}" for c in CONVS])
def test_plain_int8_conv_bit_equal_to_jax(shape):
    cin, cout, k, stride, dil = shape
    rng = np.random.RandomState(sum(shape))
    xq = rng.randint(-127, 128, (2, 13, 17, cin)).astype(np.int8)
    wq = rng.randint(-127, 128, (k, k, cin, cout)).astype(np.int8)  # HWIO
    pad = (k - 1) * dil // 2
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq), (stride, stride), [(pad, pad), (pad, pad)], rhs_dilation=(dil, dil),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
    cp = int8_conv.padded_channels(cin)
    xq_t = torch.nn.functional.pad(torch.from_numpy(xq), (0, cp - cin))
    packed = int8_conv.pack_weight(torch.from_numpy(wq).permute(3, 2, 0, 1))
    # |acc| < 2^24 here, so float32(acc) * 1 is the integer itself
    got = int8_conv.conv_s8(xq_t, packed, (k, k), stride, pad, dil, torch.ones(cout), None, torch.float32)
    assert got.shape == want.shape and np.abs(want).max() < 2**24
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want.astype(np.int64))
    assert int8_conv.quantize.launches == int8_conv.conv_s8.launches == 0  # the CPU takes the plain versions


CLIPS = {
    "per_tensor": 1.7,
    "per_tensor_clips_hard": 0.2,
    "per_channel": [0.5, 1.5, 2.0, 0.25, 1.0, 3.0],
    "per_channel_dead": [0.5, 0.0, 2.0, 0.25, 0.0, 3.0],
}


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("clip", list(CLIPS))
def test_quantized_conv_bit_equal_to_jax(clip, bias):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 9, 11, 6).astype(np.float32)
    m = ConvJax(5, 3, stride=2, use_bias=bias)
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    if bias:
        v = jax.tree_util.tree_map(np.asarray, v)
        v["params"]["conv"]["bias"] = rng.randn(5).astype(np.float32)
    want = np.asarray(quant_jax.quantized_apply(m, {"": CLIPS[clip]})(v, jnp.asarray(x)))
    conv = Conv(6, 5, 3, stride=2, bias=bias)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.array(v["params"]["conv"]["kernel"]).transpose(3, 2, 0, 1)))
        if bias:
            conv.bias.copy_(torch.from_numpy(np.array(v["params"]["conv"]["bias"])))
    q = quant.QuantConv(conv, CLIPS[clip])
    with torch.no_grad():
        got = q(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    # an int8 result, not the float conv's
    with torch.no_grad():
        ref = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - ref).max() > 0


def test_bf16_quantized_conv_bit_equal_to_jax():
    """Weights, bias and input in bf16, as the bf16 serving step holds them:
    s_w from the bf16-rounded kernel, the output cast to bf16."""
    rng = np.random.RandomState(5)
    x = rng.randn(1, 8, 8, 16).astype(np.float32)
    m = ConvJax(32, 3, use_bias=True)
    v = m.init(jax.random.PRNGKey(1), jnp.asarray(x))
    vb = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), v)
    want = quant_jax.quantized_apply(m, {"": 2.5})(vb, jnp.asarray(x).astype(jnp.bfloat16))
    conv = Conv(16, 32, 3, bias=True)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.array(v["params"]["conv"]["kernel"]).transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.from_numpy(np.array(v["params"]["conv"]["bias"])))
    q = quant.QuantConv(conv, 2.5).to(torch.bfloat16)
    with torch.no_grad():
        got = q(torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_skip_scales_prefix_and_suffix_rules():
    scales = {"backbone/conv1": 1.5, "detect_header/main_kf/head": 0.25, "detect_header/offset_fr_main/head": 0.5,
              "detect_header/main_kf/convs/layer0/conv": 2.0, "kfpn_fusion/kfpn_head2": [0.5, 0.0]}
    for skip in [("/head",), ("detect_header/main_kf/",), ("/head", "backbone/"), (), ("kfpn_head2",)]:
        assert quant.skip_scales(scales, skip) == quant_jax.skip_scales(scales, skip), skip
    out = quant.skip_scales(scales, ("/head",))
    assert out["detect_header/main_kf/head"] == 0.0 and out["detect_header/main_kf/convs/layer0/conv"] == 2.0


# per-channel selections: the vertex-offset branch (a prefix rule), the heads
# (a suffix rule); under mse the per-channel convs take per-channel absmax
CALIBRATIONS = [("absmax", ("/head",)), ("p99.9", ("detect_header/vertex_offset/",)),
                ("p99.99", ()), ("mse", ("detect_header/vertex_offset/", "/head"))]


def test_calibration_matches_jax_and_the_key_sets_are_equal(pair):
    name, model, variables, port, _ = pair
    x = frames(1)
    keys = set(quant.conv_paths(port).values())
    for method, per_channel in CALIBRATIONS:
        want = quant_jax.calibrate_act_scales(model, variables, [jnp.asarray(x[:1]), jnp.asarray(x[1:])],
                                              method=method, per_channel=per_channel)
        got = quant.calibrate_act_scales(port, [torch.from_numpy(x[:1]), torch.from_numpy(x[1:])], method=method,
                                         per_channel=per_channel)
        assert set(got) == set(want) == keys, (method, set(got) ^ set(want))
        assert len(keys) == (58 if name == "DLA-34" else 39)
        pc = 0
        for k in want:
            assert np.ndim(got[k]) == np.ndim(want[k]), (method, k)
            pc += np.ndim(got[k])
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-7, err_msg=f"{method} {k}")
        assert pc == sum(quant._match_fns(per_channel)(k) for k in keys)


def test_percentile_past_2_24_elements_matches_jnp_quantile():
    """``torch.quantile`` refuses this size; the port's rule is jnp's."""
    rng = np.random.RandomState(6)
    x = np.abs(rng.standard_cauchy(2**24 + 4097)).astype(np.float32)
    for q in (0.999, 0.9999):
        want = np.asarray(jnp.quantile(jnp.asarray(x), q))
        got = quant.quantile_f32(torch.from_numpy(x), q).numpy()
        assert got == want, (q, got, want)
    xc = x[: (2**24 + 4096)].reshape(-1, 4)  # per channel, along axis 0
    want = np.asarray(jnp.quantile(jnp.asarray(xc), 0.999, axis=0))
    np.testing.assert_array_equal(quant.quantile_f32(torch.from_numpy(xc), 0.999, dim=0).numpy(), want)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_scales_json_loads_in_the_other_package(tmp_path, writer):
    scales = {"backbone/base_conv": 2.25, "detect_header/main_kf/head": 0.125,
              "detect_header/vertex_offset/convs/layer0/conv": [0.5, 1.5, 2.0]}
    path = str(tmp_path / "scales.json")
    (quant_jax if writer == "jax" else quant).save_act_scales(path, scales)
    assert quant.load_act_scales(path) == quant_jax.load_act_scales(path) == scales


def test_jax_paths_invert_the_checkpoint_names():
    for backbone in ("DLA-34", "RESNET-18", "RESNET-50"):
        cfg = default_config()
        cfg.INPUT_SIZE = (64, 64)
        if backbone != "DLA-34":
            cfg.MODEL.BACKBONE, cfg.MODEL.KFNs = backbone, list(KFNS)
        paths = quant.conv_paths(create_model(cfg))
        assert len(set(paths.values())) == len(paths)
    assert quant.jax_path("detect_header.main_kf_header.3") == "detect_header/main_kf/convs/layer1/conv"
    assert quant.jax_path("backbone.layer2.0.downsample.0") == "backbone/layer2/block0/downsample_conv"
    with pytest.raises(ValueError):
        quant.jax_path("backbone.nothing_like_it.7")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_logits_match_jax(pair, dtype):
    name, model, variables, port, cfg = pair
    x = frames(2)
    scales = quant_jax.skip_scales(
        quant_jax.calibrate_act_scales(model, variables, [jnp.asarray(x)], method="absmax"), ("/head",))
    jdt = jnp.dtype(dtype)
    v = variables if dtype == "float32" else jax.tree_util.tree_map(
        lambda p: p.astype(jdt) if p.dtype == jnp.float32 else p, variables)
    want = quant_jax.quantized_apply(model, scales)(v, jnp.asarray(x).astype(jdt))
    tdt = getattr(torch, dtype)
    qmodel = quant.quantize_model(port, scales).to(tdt)
    with torch.no_grad():
        got = qmodel(torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt))
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32)).transpose(0, 3, 1, 2)
        d = np.abs(g.float().numpy() - w)
        top = np.abs(w).max()
        if dtype == "float32":
            assert d.max() <= 1e-5 * top, d.max() / top
        else:
            assert d.max() <= 0.15 * top and d.mean() <= 0.03 * top, (d.max() / top, d.mean() / top)


def test_int8_skip_keeps_the_matched_convs_float():
    _, _, port, _ = model_pair("DLA-34")
    paths = quant.conv_paths(port)
    scales = {p: 1.0 for p in paths.values()}
    heads = {n for n, p in paths.items() if p.endswith("/head")}
    q = quant.quantize_model(port, quant.skip_scales(scales, tuple(default_config().TPU.INT8_SKIP)))
    mods = dict(q.named_modules())
    assert len(heads) == 4
    assert all(type(mods[n]) is Conv for n in heads)
    assert all(isinstance(mods[n], quant.QuantConv) for n in paths if n not in heads)
    # a missing key, a 0 and an all-zero channel list stay float; the model given is not touched
    del scales[paths["backbone.base_layer.0"]]
    scales[paths["backbone.level0.0"]] = 0.0
    scales[paths["backbone.level1.0"]] = [0.0] * 16
    mods = dict(quant.quantize_model(port, scales).named_modules())
    assert all(type(mods[n]) is Conv for n in ("backbone.base_layer.0", "backbone.level0.0", "backbone.level1.0"))
    assert not any(isinstance(m, quant.QuantConv) for m in port.modules())
    with pytest.raises(ValueError):
        quant.quantize_model(port, {paths["backbone.level1.0"]: [1.0] * 3})


def test_int8_detect_step_packs_from_the_cast_weights():
    """A bf16 step quantizes its bf16 copy of the network: the weight scales
    come from the bf16-rounded kernels, as the JAX step casts its variables
    before the apply. On the CPU the step runs the plain versions."""
    _, _, port, cfg = model_pair("RESNET-18")
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.DETECTOR.TOPK_CANDIDATES = 5
    scales = quant.calibrate_act_scales(port, [torch.from_numpy(frames(3))], method="absmax")
    qmodel = quant.quantize_model(port, quant.skip_scales(scales, ("/head",)))
    imgs = (np.random.RandomState(0).rand(2, 64, 64, 3) * 255).astype(np.uint8)
    det = make_detect_step(qmodel, cfg, with_3d=False, device="cpu")(imgs, np.tile(np.eye(3, dtype=np.float32),
                                                                                    (2, 1, 1)))
    assert det["scores"].shape == (2, 5) and torch.isfinite(det["scores"]).all() and "dim" not in det
    conv = qmodel.backbone.conv1
    assert isinstance(conv, quant.QuantConv)
    fp32_scale = conv.pack()[2]
    conv = copy.deepcopy(qmodel).to(torch.bfloat16).backbone.conv1
    _, _, out_scale, _ = conv.pack()
    s_w = (conv.weight.detach().float().abs().amax(dim=(1, 2, 3)) / 127.0).clamp_min(1e-12)
    np.testing.assert_array_equal(out_scale.numpy(), (s_w * np.float32(max(conv.clip / 127.0, 1e-12))).numpy())
    assert not torch.equal(out_scale, fp32_scale)
