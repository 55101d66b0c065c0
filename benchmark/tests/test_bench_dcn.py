"""The ResNet-101-DCN configuration in the benchmark: the port against the
plain reference, the deformable convs' counted work, the two readers of
its per-layer metrics, and a planted fault (offsets dropped) on a CPU run
of the cell in a shrunk copy."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import dcn_work, gen, spans
from benchmark.flops import flops_per_image
from benchmark.program import port_config, port_model
from benchmark.reference.dcn import ModulatedDeformConv
from benchmark.reference.network import build_network
from benchmark.run import reader
from conftest import ROOT, TINY_HW

CELL = "r101dcn_detect_bulk"
CONF = json.loads((ROOT / "benchmark" / "configs" / "rtm3d_r101dcn_kitti.json").read_text())


def tiny_conf() -> dict:
    c = json.loads(json.dumps(CONF))
    c["config"]["INPUT_SIZE"] = TINY_HW
    c["config"]["TPU"]["COMPUTE_DTYPE"] = "float32"
    return c


def test_port_and_reference_agree_at_tiny_size():
    """One seeded state dict loads strict into both; their logits agree to
    float32 rounding (``test_networks_agree``'s tolerance)."""
    torch.set_num_threads(4)
    c = tiny_conf()
    sd = gen.make_weights(c, 3, "cpu", "float32")
    prog = port_model(port_config(c), sd, torch.device("cpu")).eval()
    ref = build_network(c)
    ref.load_state_dict(sd, strict=True)
    ref.eval()
    x = torch.randn(2, 3, TINY_HW[1], TINY_HW[0], generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for a, b in zip(prog(x), ref(x)):
            assert torch.allclose(a, b, rtol=1e-4, atol=1e-5), float((a - b).abs().max())


def test_dcn_work_against_a_hand_count():
    """At 1280x416: 23 layer3 convs of 256 channels on 26 x 80 and 3 layer4
    convs of 512 on 13 x 40, 2 x 9 x C_in x C_out x H x W operations each;
    bytes: input, 27 offset channels and output in bf16, and the weight."""
    layers = dcn_work.dcn_layers(CONF, (416, 1280))
    assert [(l["c_in"], l["c_out"], l["hw"]) for l in layers] == [(256, 256, (26, 80))] * 23 + [(512, 512, (13, 40))] * 3
    want = 23 * 2 * 9 * 256 * 256 * 26 * 80 + 3 * 2 * 9 * 512 * 512 * 13 * 40
    assert dcn_work.dcn_flops_per_image(CONF, (416, 1280)) == want == 63_795_363_840
    assert layers[0]["bytes"] == 2 * (26 * 80 * (256 + 27 + 256) + 9 * 256 * 256)


def test_flops_per_image_counts_the_dcn_taps():
    """``FlopCounterMode`` counts a reference DCN layer as its offset conv
    plus the stride-3 conv over the tap image: 2 x 9 x C_in x (27 + C_out)
    x H x W, the sampling nothing; the network's count holds all 26."""
    with torch.device("meta"):
        layer = ModulatedDeformConv(64, 128)
        x = torch.empty(1, 64, 10, 12)
    with FlopCounterMode(display=False) as counter:
        layer(x)
    assert counter.get_total_flops() == 2 * 9 * 64 * (27 + 128) * 10 * 12
    total = flops_per_image(CONF, (416, 1280), backward=False)
    assert total > dcn_work.dcn_flops_per_image(CONF, (416, 1280)) and round(total / 1e9, 2) == 598.53


def test_dcn_roofline_reader(monkeypatch):
    """The DCN's operations in the slice at the peak over the kernel's
    device seconds, read by the kernel's symbol among the device ops; None
    where it is not among them or no cell is named."""
    ops = dcn_work.dcn_flops_per_image(CONF, (416, 1280)) * 640
    rec = {"trace": {"images": 640, "peak_flops": 989e12, "device_ops": [
        ["void (anonymous namespace)::dcn_forward_kernel<__nv_bfloat16>(__nv_bfloat16 const*)", 0.25],
        ["cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_32x32_128x2_nhwc_align8", 1.0]]}}
    assert dcn_work.roofline_pct(rec, CONF) == pytest.approx(100 * ops / 989e12 / 0.25)
    assert dcn_work.roofline_pct({"trace": dict(rec["trace"], device_ops=rec["trace"]["device_ops"][1:])}, CONF) is None
    assert dcn_work.cell_conf(["--workload", CELL, "--seed", "1"])["name"] == CONF["name"]
    assert dcn_work.cell_conf(["-c"]) is None
    monkeypatch.setattr(sys, "argv", ["benchmark/run.py", "--workload", CELL, "--seconds", "30"])
    assert reader("dcn_roofline.detect_bulk")(rec) == pytest.approx(100 * ops / 989e12 / 0.25)
    assert reader("dcn_roofline.detect_bulk")({}) is None


def test_dcn_kernel_layers_reader(monkeypatch):
    rec = {"trace": {"calls": 20}}
    read = reader("dcn_kernel_layers_per_call.detect_bulk")
    monkeypatch.setattr(spans, "program_counters", lambda: {"dcn_kernel": 520, "host_syncs": 300})
    assert read(rec) == 26.0
    monkeypatch.setattr(spans, "program_counters", lambda: {"host_syncs": 300})
    assert read(rec) == 0.0  # the timed path composed
    monkeypatch.setitem(sys.modules, "rtm3d_tpu_torch.nn.dcn", None)  # a program without deformable convs
    assert read(rec) is None


def run_with_fault(copy: Path, fault: str, seed: int = 2147483659) -> dict:
    """As conftest's ``run_cell``, the fault taken from ``dcn_faults.py``."""
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import importlib.util\n"
        "from benchmark.run import main\n"
        f"spec = importlib.util.spec_from_file_location('dcn_faults', {str(Path(__file__).parent / 'dcn_faults.py')!r})\n"
        "faults = importlib.util.module_from_spec(spec); spec.loader.exec_module(faults)\n"
        f"sys.exit(main(['--workload', {CELL!r}, '--seed', '{seed}', '--seconds', '1', '--trace', '0'], device='cpu', "
        f"wrap_call=getattr(faults, {fault!r}) if {fault!r} else None))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=copy, capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, OMP_NUM_THREADS="4"))
    lines = [l for l in p.stdout.splitlines() if l.startswith("{")]
    return {"rc": p.returncode, "line": json.loads(lines[-1]) if lines else None, "stderr": p.stderr}


def test_offsets_dropped_under_the_timed_path(tiny):
    """A sound tiny run is correct; with every DCN's offsets dropped the
    answers move (the compared gaps grow). Whether ``correct`` goes false
    is printed: at the init's offsets (a tenth of a pixel) the fault moves
    the answers less than the float8 control does (PERF.md)."""
    sound, fault = run_with_fault(tiny, ""), run_with_fault(tiny, "detect_dcn_no_offsets")
    assert sound["rc"] == 0 and fault["rc"] == 0, (sound["stderr"] + fault["stderr"])[-3000:]
    assert sound["line"]["correct"], sound["line"]["checks"]
    moved = {k: (sound["line"]["checks"][k]["value"], v["value"]) for k, v in fault["line"]["checks"].items()}
    assert any(f > 10 * s + 1e-4 for s, f in moved.values()), moved
    print(f"offsets dropped: correct {fault['line']['correct']}, sound against fault {moved}")
