"""One run of one cell of the benchmark of ``rtm3d_tpu_torch``.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is found by name in
``BENCHMARK.json``; its configuration file, its traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``kind`` names the driver,
``benchmark/drivers/<kind>.py``), its limits (``benchmark/workloads/<cell>
.json``) and one reader a metric (``benchmark/metrics/<metric>.py``) are
data found by name, so a new cell, configuration or metric adds files.

The run makes its weights and inputs from ``--seed``, warms up the cell's
own shapes (set-up, ``setup_s``), measures for ``--seconds`` (nothing is
built inside the window), checks a sample of the window's outputs against
the plain reference (``benchmark/judge.py``) once the window has closed
and the program's memory is freed, and prints one JSON line last:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones, read from a profiled
slice of the window), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each compared number with its limit (also the last lines
on standard error). It exits non-zero with no result line when there is no
CUDA device, fewer devices than the cell asks for, or when JAX or the JAX
package is loaded once the window has closed.

Build and kernel caches stay in fixed directories of the checkout
(``.bench_cache/``; the port's kernel libraries in
``rtm3d_tpu_torch/_build/``), so only a checkout's first run builds.
"""

import os
import sys
import time
from pathlib import Path

T0 = time.perf_counter()  # set-up is timed from here, before any heavy import
ROOT = Path(__file__).resolve().parents[1]
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "cuda"}
for _var, _sub in CACHES.items():
    os.environ[_var] = str(ROOT / ".bench_cache" / _sub)

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "rtm3d_tpu")


def loaded_forbidden() -> list:
    """Modules of JAX or of the JAX package in this process, by whole
    top-level name (``rtm3d_tpu_torch`` is not ``rtm3d_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics._{name}",
                                                  ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_parts(name: str) -> dict:
    """The cell's entry, configuration file, traffic mix, limits and
    metrics, found by name from ``BENCHMARK.json``."""
    bench = read_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    conf_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    applies = lambda m: name in m.get("workloads", [name])
    return {"cell": cell, "conf": read_json(ROOT / conf_entry["file"]),
            "traffic": read_json(ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json"),
            "limits": read_json(ROOT / "benchmark" / "workloads" / f"{name}.json")["limits"],
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


class Context:
    """What a driver gets: the cell's parts, the run's arguments, the
    device, and the hooks around the window."""

    def __init__(self, parts: dict, args, device, wrap_call=None):
        self.conf, self.traffic = parts["conf"], parts["traffic"]
        self.seed, self.seconds, self.trace = args.seed, float(args.seconds), bool(args.trace)
        self.device = device
        self.wrap_call = wrap_call or (lambda f: f)
        self.memory_peak = 0
        self.marks = []  # (set-up part, seconds since the start) for the notes

    def mark(self, name: str):
        self.marks.append((name, round(self.elapsed(), 3)))

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def settle():
        """End of set-up: what set-up made is moved out of the garbage
        collector's scans (``gc.freeze``), so that the window's
        collections walk only the window's own objects."""
        import gc

        gc.collect()
        gc.freeze()

    @staticmethod
    def elapsed() -> float:
        return time.perf_counter() - T0

    def close_window(self, rec: dict):
        """Read the memory peak and the loaded modules as the window closes."""
        import torch

        if self.device.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_reserved(self.device)
        self.forbidden = loaded_forbidden()


def parse_args(argv=None):
    p = argparse.ArgumentParser("benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, wrap_call=None) -> int:
    """Runs the cell and prints its line; returns the exit code. ``device``
    and ``wrap_call`` are for the harness's own tests (a CPU device, a
    broken timed path); a run from the command line has neither."""
    args = parse_args(argv)
    parts = cell_parts(args.workload)
    import torch

    if device is None:
        chips = int(parts["cell"]["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"benchmark: the cell needs {chips} CUDA device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    else:
        device = torch.device(device)
    ctx = Context(parts, args, device, wrap_call)
    driver = importlib.import_module(f"benchmark.drivers.{parts['traffic']['kind']}")
    res = driver.run(ctx)
    rec = res["rec"]
    if "trace" in rec:
        from benchmark.flops import PEAK_FLOPS, flops_per_image

        W, H = ctx.conf["config"]["INPUT_SIZE"]
        rec["trace"].update(flops_per_image=flops_per_image(ctx.conf, (H, W), backward=rec["kind"] == "train"),
                            peak_flops=PEAK_FLOPS[ctx.conf["config"]["TPU"]["COMPUTE_DTYPE"]])
    print(f"note set-up: {ctx.marks}", file=sys.stderr)
    if "note" in rec:
        print(f"note window: {rec['note']}", file=sys.stderr)
    for k, v in res["numbers"].items():  # the numbers this cell does not compare
        if k not in parts["limits"]:
            print(f"note {k}: {v!r}", file=sys.stderr)
    checks = {}
    for name, limit in parts["limits"].items():
        value = res["numbers"].get(name, float("nan"))
        checks[name] = {"value": value, "limit": limit}
    correct = res["failed"] == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                         for c in checks.values())
    metrics = {}
    for m in parts["per_layer"] if args.trace else parts["end_to_end"]:
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
           "count": int(parts["cell"]["chips"]), "memory_peak_bytes": int(ctx.memory_peak)}
    line = {"correct": bool(correct), "attempted": int(res["attempted"]), "failed": int(res["failed"]),
            "metrics": metrics, "device": dev}
    if args.trace and "trace" in rec:
        dev.update(busy_s=rec["trace"]["busy_s"], window_s=rec["trace"]["window_s"])
        line["breakdown"] = {"device_ops": rec["trace"]["device_ops"], "idle_gaps": rec["trace"]["idle_gaps"]}
    line["checks"] = checks
    forbidden = sorted(set(getattr(ctx, "forbidden", [])) | set(loaded_forbidden()))
    if forbidden:
        print(f"benchmark: modules of JAX or the JAX package are loaded: {forbidden}", file=sys.stderr)
        return 4
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
