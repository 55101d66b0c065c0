"""Readings for the limits of ``correct``: the program's and the control's
numbers on many seeds, in one process, at a cell's own size.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 [--control-seeds 4,5,6] [--out FILE]

For each seed of ``--seeds`` the program's numbers (a detection cell: its
answers on as many calls as a run checks, ``check_calls``, or ``--calls``;
a training cell: its first steps), and for each of ``--control-seeds`` the
control's: the reference in the program's place, computed in the precision
below the configuration's (float8 convolutions; a bfloat16 3D solve). With
``--late-after N`` a training cell reads instead three steps after N more,
as a run checks after its window: the program's, or the control's from the
program's state. Witnesses and faults, the reference in the program's
place: ``--witness-seeds`` (training under bfloat16 autocast),
``--witness-detect-seeds`` (the network in bfloat16), ``--half-seeds``
(training on half of each batch) and ``--nonms-seeds`` (the decode without
its 3x3 suppression). One JSON line a reading. The benchmark's own runs
never run these; the limits in ``benchmark/workloads/<cell>.json`` are set
from them (PERF.md).
"""

import argparse
import gc
import json
import sys

import torch

from benchmark import run as bench_run


def detect_reading(parts: dict, seed: int, side: str, device, args) -> dict:
    from benchmark.drivers import detect as D

    conf, traffic = parts["conf"], parts["traffic"]
    calls = args.calls or int(traffic["check_calls"])
    sd = D.weights(conf, traffic, seed, device)
    inputs = D.Inputs(conf, traffic, seed, device)
    if side == "program":
        answers = D.program_answers(conf, traffic, sd, inputs, calls, device)
    else:
        answers = D.control_answers(conf, traffic, sd, inputs, calls, device, side)
    return D.check(answers, conf, traffic, sd, inputs, device)


def late_reading(parts: dict, seed: int, side: str, device, after: int) -> dict:
    """Training after a window: the program driven ``after`` steps past its
    first ones, then three more from that state by the program ("program")
    or by the control ("control"), against the reference from the same
    state."""
    from benchmark import gen, judge
    from benchmark.drivers import train as T
    from benchmark.program import TrainState, make_train_step, port_config, port_model

    conf, traffic = parts["conf"], parts["traffic"]
    n = int(traffic["check_steps"])
    sd = gen.make_weights(conf, seed, device, "float32")
    cache, batches = T.dataset(conf, traffic, seed, device)
    cfg = port_config(conf)
    state = TrainState.create(port_model(cfg, sd, device), cfg, device=device)
    step = make_train_step(cfg, device=device)
    for i in range(n + after):
        state, _ = step(state, batches[i % len(batches)], cache)
    late_b = T.window_batches(batches, n + after, n)
    if side == "program":
        state, start, got = T.late_readings(state, step, late_b, cache, n)
    else:
        start = T.snapshot(state)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    if side != "program":
        got = T.reference_readings(conf, sd, late_b, cache, device, control=True, start=start)
    ref = T.reference_readings(conf, sd, late_b, cache, device, start=start)
    return judge.train_numbers(got, ref, start["params"], prefix="late_", ema_init=start["ema"])


def train_reading(parts: dict, seed: int, side: str, device, args) -> dict:
    from benchmark import gen, judge
    from benchmark.drivers import train as T
    from benchmark.program import TrainState, make_train_step, port_config, port_model

    conf, traffic = parts["conf"], parts["traffic"]
    n = int(traffic["check_steps"])
    if args.late_after and side in ("program", "control"):
        return late_reading(parts, seed, side, device, args.late_after)
    sd = gen.make_weights(conf, seed, device, "float32")
    cache, batches = T.dataset(conf, traffic, seed, device)
    if side == "program":
        cfg = port_config(conf)
        state = TrainState.create(port_model(cfg, sd, device), cfg, device=device)
        state, got = T.program_readings(state, make_train_step(cfg, device=device), batches, cache, n)
        del state
    elif side == "half":  # the fault: half of each batch left out, the mean over the rest
        half = [{k: ({kk: vv[:len(b["image_idx"]) // 2] for kk, vv in v.items()} if isinstance(v, dict)
                     else v[:len(b["image_idx"]) // 2]) for k, v in b.items()} for b in batches[:n]]
        got = T.reference_readings(conf, sd, half, cache, device)
    else:  # the control, or the witness: the reference under bfloat16 autocast
        got = T.reference_readings(conf, sd, batches[:n], cache, device, control=side == "control",
                                   autocast=torch.bfloat16 if side == "witness" else None)
    gc.collect()
    torch.cuda.empty_cache()
    ref = T.reference_readings(conf, sd, batches[:n], cache, device)
    return judge.train_numbers(got, ref, sd)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--witness-seeds", default="", help="training: the reference under bfloat16 autocast")
    p.add_argument("--half-seeds", default="", help="training: the fault, half of each batch left out")
    p.add_argument("--witness-detect-seeds", default="", help="detection: the reference in bfloat16")
    p.add_argument("--nonms-seeds", default="", help="detection: the fault, the 3x3 suppression left out")
    p.add_argument("--calls", type=int, default=0, help="detection: calls a reading (default: the cell's check_calls)")
    p.add_argument("--late-after", type=int, default=0,
                   help="training: read three steps after this many past the first, as a run's check after its window")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    parts = bench_run.cell_parts(args.workload)
    device = torch.device("cuda", 0)
    reading = {"detect": detect_reading, "train": train_reading}[parts["traffic"]["kind"]]
    out = open(args.out, "a") if args.out else sys.stdout
    for side, seeds in (("program", args.seeds), ("control", args.control_seeds), ("witness", args.witness_seeds),
                        ("half", args.half_seeds), ("witness", args.witness_detect_seeds),
                        ("nonms", args.nonms_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            nums = reading(parts, seed, side, device, args)
            print(json.dumps({"workload": args.workload, "side": side, "seed": seed, **nums}), file=out, flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
