"""The port's CLIs data-parallel on the CPU: ``cli.train --multihost`` and
``cli.detect`` over two gloo ranks, launched as torchrun launches them
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``:
a port the OS picked free), each rank a process with two intra-op
threads, its output in a file, every wait bounded.

Training, on the port's synthetic KITTI tree (8 train frames, 3 test
frames of 64x192; DLA-34 at INPUT_SIZE 192, rect 192x64, fp32, global
batch 4, so 2 steps an epoch at either world size), one chain of runs
that resumes across world sizes both ways and across both checkpoint
formats, each run from the save the one before it left:

    A  2 ranks, 2 epochs, .pt files (the master saves)
    B  1 rank,  resume to epoch 3, from A's .pt, TRAINING.USE_ORBAX: a directory
    C  2 ranks, resume to epoch 4, from B's directory, USE_ORBAX (every rank saves)
    D  1 rank,  resume to epoch 5, from C's directory, .pt
    E  2 ranks, resume to epoch 6, from D's .pt

Each run's rank processes log every ``CheckPointer.save`` call they make
and every checkpoint they write (wrappers around ``CheckPointer.save``,
``torch.save`` and ``torch.distributed.checkpoint.save``, in the launch
command), so the test sees which ranks save and which write. Gates: A's
losses finite and falling, its lines printed by the master alone, every
rank calling ``save`` and the master alone writing; every resume's
banner, and the step of the save each run leaves (4, 6, 8, 10, 12: no
step lost or run twice). The ranks of a run share one tree, and the
first to read it writes its annotation caches while the other may be
reading them.

Serving: ``cli.detect`` on the test split (3 frames: at two ranks one
rank's shard ends in a pad) at one rank and at two, ``--batch-size 4``
(3 frames a call at one rank, 2 a rank at two), the weights of
``create_model`` with the vertex head drawing a car (as
tests/test_torch_detect_cli.py: the LM converges); float and ``--int8``
(the master calibrates and sends the scales). The result files of two
ranks equal one rank's line for line; the scales the two-rank master
wrote equal the one-rank run's.
"""

import glob
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from rtm3d_tpu_torch.cli import detect
from rtm3d_tpu_torch.config import load_config
from rtm3d_tpu_torch.data.kitti import create_dataset
from rtm3d_tpu_torch.data.synthetic import generate_kitti
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.train.checkpoint import is_checkpoint_dir, read_checkpoint_dir
from rtm3d_tpu_torch.utils.measure import compare_result_dirs, cuboid_vertex_bias
from tests.test_torch_data import REPO
from tests.test_torch_ddp import wait_all

CONFIG = str(REPO / "configs" / "rtm3d_dla34_kitti.yaml")
SMALL = ["INPUT_SIZE", "(192, 192)", "BATCH_SIZE", "4", "DATASET.MAX_OBJS", "8", "num_workers", "0",
         "TRAINING.LOGDIR", "''", "SOLVER.WARMUP_ITERS", "0"]
DETECT_SET = ["INPUT_SIZE", "(192, 192)", "DATASET.MAX_OBJS", "8", "DETECTOR.TOPK_CANDIDATES", "10",
              "DETECTOR.SCORE_THRESH", "0.0", "DETECTOR.RESIDUAL_THRESH", "1e9", "num_workers", "0"]
TIMEOUT_S = 300
# the launch command: the module run as ``python -m`` would, with every
# CheckPointer.save call (SAVE) and every file or directory written by
# torch.save or torch.distributed.checkpoint.save (WRITE) logged with the
# rank that made it
LAUNCH = """
import os, runpy, sys
import torch
import torch.distributed.checkpoint as dcp
from rtm3d_tpu_torch.parallel import dist
from rtm3d_tpu_torch.train import checkpoint

def logged(kind, fn, name_of):
    def wrapper(*args, **kwargs):
        print(f"{kind} rank={dist.rank()} {name_of(*args, **kwargs)}", flush=True)
        return fn(*args, **kwargs)
    return wrapper

checkpoint.CheckPointer.save = logged("SAVE", checkpoint.CheckPointer.save, lambda self, name, *a, **k: name)
torch.save = logged("WRITE", torch.save, lambda obj, f, *a, **k: os.path.basename(str(f)))
dcp.save = logged("WRITE", dcp.save, lambda *a, checkpoint_id, **k: os.path.basename(str(checkpoint_id)))
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(module: str, args: list, world: int, logdir, tag: str) -> list:
    """``python -m module args`` as ``world`` ranks (or one plain process
    when ``world`` is None); returns each process's output."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="2", PYTHONUNBUFFERED="1")
    if world:
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE=str(world))
    procs, paths = [], []
    for r in range(world or 1):
        paths.append(os.path.join(logdir, f"{tag}.rank{r}.log"))
        rank_env = dict(env, RANK=str(r), LOCAL_RANK=str(r)) if world else env
        with open(paths[-1], "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", LAUNCH, module, *args], cwd=REPO, env=rank_env,
                                          stdout=log, stderr=subprocess.STDOUT))
    wait_all(procs, TIMEOUT_S)
    logs = [open(path).read() for path in paths]
    assert all(p.returncode == 0 for p in procs), "\n".join(
        f"{tag} rank {r}: exit {p.returncode}\n{text[-3000:]}" for r, (p, text) in enumerate(zip(procs, logs)))
    return logs


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return generate_kitti(str(tmp_path_factory.mktemp("kitti") / "kitti"), num_train=8, num_test=3,
                          img_hw=(64, 192), max_objs=5)


def saved_step(path: str) -> int:
    if is_checkpoint_dir(path):
        return read_checkpoint_dir(path)["step"]
    return torch.load(path, map_location="cpu", weights_only=True)["step"]


def prune(save_dir: str) -> str:
    """Every save but the pointer's removed (the chain's disk stays at one
    save between runs); returns the pointer's path."""
    last = open(os.path.join(save_dir, "last_checkpoint")).read().strip()
    for f in os.listdir(save_dir):
        path = os.path.join(save_dir, f)
        if f != "last_checkpoint" and os.path.abspath(path) != os.path.abspath(last):
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
    return last


CHAIN = [  # (tag, world, mode, epochs, USE_ORBAX)
    ("A", 2, "start", 2, False),
    ("B", None, "resume", 3, True),
    ("C", 2, "resume", 4, True),
    ("D", None, "resume", 5, False),
    ("E", 2, "resume", 6, False),
]


@pytest.fixture(scope="module")
def chain(tree, tmp_path_factory):
    work = tmp_path_factory.mktemp("ddp_cli")
    weights = str(work / "weights")
    save_dir = os.path.join(weights, "DLA-34")
    runs = {}
    try:
        for tag, world, mode, epochs, orbax in CHAIN:
            args = ["--model-config", CONFIG, "--data-path", tree, "--device", "cpu"]
            args += ["--multihost"] if world else []
            args += ["--set", *SMALL, "TRAINING.WEIGHTS", weights, "TRAINING.CHECKPOINT_MODE", mode,
                     "SOLVER.MAX_EPOCH", str(epochs), "TRAINING.USE_ORBAX", str(orbax)]
            logs = launch("rtm3d_tpu_torch.cli.train", args, world, work, tag)
            files = sorted(os.listdir(save_dir))
            last = prune(save_dir)
            runs[tag] = {"logs": logs, "files": files, "last": last, "is_dir": is_checkpoint_dir(last),
                         "step": saved_step(last)}
        yield runs
    finally:
        shutil.rmtree(weights, ignore_errors=True)


def epoch_totals(log: str, kind: str) -> list:
    """The ``total`` of each epoch's last train line, or of its test line."""
    pat = r"epoch (\d+) it \d+/\d+ .*?total=([-0-9.naif]+)" if kind == "train" else \
        r"epoch (\d+) test: .*?total=([-0-9.naif]+)"
    out = {}
    for e, v in re.findall(pat, log):
        out[int(e)] = float(v)
    return [out[k] for k in sorted(out)]


def test_two_rank_training_trains_and_only_the_master_writes(chain):
    master, other = chain["A"]["logs"]
    assert "2 ranks, 2 rows each" in master
    train, test = epoch_totals(master, "train"), epoch_totals(master, "test")
    assert len(train) == len(test) == 2 and all(math.isfinite(v) for v in train + test)
    assert train[1] < train[0] and test[1] < test[0], (train, test)
    assert not re.search(r"epoch \d", other) and "model:" not in other  # the master alone prints
    names = {"model_0000000", "model_0000001", "model_best"}
    for rank, log in enumerate((master, other)):  # every rank calls save; the master alone writes
        assert set(re.findall(r"SAVE rank=%d (\S+)" % rank, log)) == names
    writes = re.findall(r"WRITE rank=(\d) (model_\S+)", master + other)
    assert {r for r, _ in writes} == {"0"} and {n for _, n in writes} == {f"{n}.pt" for n in names}
    assert [f for f in chain["A"]["files"] if not f.startswith("model_best")] == [
        "last_checkpoint", "model_0000000.pt", "model_0000001.pt"]


@pytest.mark.parametrize("tag", ["B", "C", "D", "E"])
def test_resume_across_world_sizes_and_formats(chain, tag):
    i = [c[0] for c in CHAIN].index(tag)
    _, world, _, epochs, orbax = CHAIN[i]
    before = chain[CHAIN[i - 1][0]]
    assert before["is_dir"] == CHAIN[i - 1][4]  # the format it resumes from
    run = chain[tag]
    assert f"resumed from epoch {epochs - 1}," in run["logs"][0]
    assert run["step"] == 2 * epochs  # 2 steps an epoch at either world size, none lost or run twice
    assert run["is_dir"] == orbax and run["last"].endswith(".pt") != orbax
    text = "".join(run["logs"])
    every = {"0", "1"} if world == 2 else {"0"}
    assert {r for r, _ in re.findall(r"SAVE rank=(\d) (\S+)", text)} == every
    writes = re.findall(r"WRITE rank=(\d) (model_\S+)", text)
    assert {r for r, _ in writes} == (every if orbax else {"0"}), writes  # directory saves are collective


def test_annotation_cache_is_whole_or_absent(tmp_path, monkeypatch):
    """The ranks of a run share one tree, and one rank can read an
    annotation cache while another writes it: a reader of a file written
    in place met a truncated one (``EOFError``). A cache is renamed into
    place whole, and a write cut short leaves no file behind."""
    from rtm3d_tpu_torch.data import kitti

    path = str(tmp_path / "shape_train.npy")

    def cut_short(f, arr, allow_pickle):
        f.write(b"\x93NUMPY")
        raise OSError("no space left on device")

    monkeypatch.setattr(kitti.np, "save", cut_short)
    with pytest.raises(OSError):
        kitti._save_atomic(path, np.zeros((2, 2), np.int64))
    assert os.listdir(tmp_path) == []
    monkeypatch.undo()
    kitti._save_atomic(path, np.arange(4).reshape(2, 2))
    assert os.listdir(tmp_path) == ["shape_train.npy"] and np.load(path).tolist() == [[0, 1], [2, 3]]


@pytest.fixture(scope="module")
def served(tree, tmp_path_factory):
    work = tmp_path_factory.mktemp("ddp_detect")
    cfg = load_config(CONFIG, DETECT_SET)
    K = create_dataset(tree, cfg, is_training=False, split="test")[0]["calib"].reshape(3, 3)
    sd = create_model(cfg).state_dict()
    sd["detect_header.offset_fr_main_header.offset_fr_main_head.weight"].zero_()
    sd["detect_header.offset_fr_main_header.offset_fr_main_head.bias"].copy_(torch.from_numpy(cuboid_vertex_bias(K)))
    weights = str(work / "car.pt")
    torch.save(sd, weights)
    try:
        yield _serve(tree, work, weights)
    finally:
        os.remove(weights)  # 120 MB the suite need not keep


def _serve(tree, work, weights) -> dict:
    """cli.detect float and int8, at one rank (in this process) and at two."""
    out = {}
    for kind in ("float", "int8"):
        for world in (1, 2):
            res = str(work / f"{kind}{world}")
            extra = ["--int8", "--int8-3d-anyway", "--calib-scales", res + ".json"] if kind == "int8" else []
            args = ["--model-config", CONFIG, "--data-path", tree, "--device", "cpu", "--checkpoint", weights,
                    "--out-dir", res, "--batch-size", "4", *extra, "--set", *DETECT_SET]
            if world == 1:
                summary = detect.main(args)
                logs = None
            else:
                logs = launch("rtm3d_tpu_torch.cli.detect", args, 2, work, f"{kind}{world}")
                summary = None
            out[(kind, world)] = {"dir": res, "summary": summary, "logs": logs}
    return out


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_two_rank_detect_writes_one_rank_files(served, tree, kind):
    one, two = served[(kind, 1)], served[(kind, 2)]
    names = sorted(os.path.splitext(os.path.basename(p))[0] for p in glob.glob(os.path.join(one["dir"], "*.txt")))
    assert len(names) == 3 and one["summary"]["images"] == 3
    assert sorted(os.listdir(two["dir"])) == sorted(os.listdir(one["dir"]))
    cmp = compare_result_dirs(one["dir"], two["dir"], names)
    assert cmp["lines"] == cmp["lines_got"] > 0 and cmp["box_agree_share"] == 1.0, cmp
    assert all(v == 0.0 for v in cmp["max_abs"].values()), cmp
    master, other = two["logs"]
    assert re.search(r"detect: 3 images, .* 2 ranks", master) and "detect:" not in other
    if kind == "int8":
        scales = [json.load(open(d["dir"] + ".json")) for d in (one, two)]
        assert scales[0] == scales[1] and len(scales[0]) > 0
        assert "int8: calibrated" in master and "int8: calibrated" not in other
