"""``TPU.MESH_AXES``/``TPU.MESH_SHAPE`` in the port's CLIs, on the CPU.

The JAX CLIs build their device mesh from both keys
(``rtm3d_tpu/cli/train.py:126``, ``cli/detect.py:206``), and a ``spatial``
axis shards each frame's rows (``rtm3d_tpu/parallel/mesh.py:88-94``). The
port lays its torchrun ranks out as the same data x spatial grid
(``parallel/dist.py::check_mesh_config``): both CLIs run a
``("data", "spatial")`` and a ``("spatial",)`` mesh under torchrun (two
gloo ranks, a 1 x 2 grid), and the detect CLI's result files equal one
rank's line for line (serving replicates the frames across ``spatial``).
Every mesh the port cannot run is refused with a message before a frame
is read, never run as something else: an unknown axis name, a shape
whose product is not the world size, and bands thinner than the
network's deepest stride. Every shipped config passes.
"""

import glob
import os
import shutil

import pytest

from rtm3d_tpu.config import load_config as load_config_jax
from rtm3d_tpu.parallel.mesh import batch_sharding, create_mesh
from rtm3d_tpu_torch.cli import detect, train
from rtm3d_tpu_torch.config import load_config
from rtm3d_tpu_torch.data.kitti import create_dataset
from rtm3d_tpu_torch.data.synthetic import generate_kitti
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.parallel import dist
from rtm3d_tpu_torch.utils.measure import compare_result_dirs, cuboid_vertex_bias
from tests.test_torch_ddp_cli import free_port
from tests.test_torch_ddp import wait_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "rtm3d_resnet18_kitti.yaml")
SMALL = ["INPUT_SIZE", "(128, 128)", "DETECTOR.TOPK_CANDIDATES", "5", "num_workers", "0"]
# every peak a line: the car-drawing vertex head below converges the LM
SERVE = ["DETECTOR.SCORE_THRESH", "0.0", "DETECTOR.RESIDUAL_THRESH", "1e9"]
MESHES = {
    "data_spatial": ["TPU.MESH_AXES", "('data', 'spatial')", "TPU.MESH_SHAPE", "(-1, 2)"],
    "spatial": ["TPU.MESH_AXES", "('spatial',)"],
}
REFUSED = {
    "unknown_axis": (["TPU.MESH_AXES", "('data', 'model')", "TPU.MESH_SHAPE", "(-1, 1)"], "not these axis names"),
    "shape_4": (["TPU.MESH_SHAPE", "(4,)"], "product must be the world size 1"),
    "spatial_4": (["TPU.MESH_AXES", "('data', 'spatial')", "TPU.MESH_SHAPE", "(1, 4)"],
                  "product must be the world size 1"),
}
# rect 128x96 on the tree's 96x128 frames: three units of 32 rows; at
# INPUT_SIZE 32 the rect frame (32x32, each side rounded up to a multiple
# of 32) has one, thinner than two bands
THIN = ["INPUT_SIZE", "(32, 32)"]
TIMEOUT_S = 300
# each rank: every CLI call of the launch in turn, each joining the
# process group on a port of its own and leaving it
LAUNCH = """
import json, os, sys
from rtm3d_tpu_torch.cli import detect, train
calls = json.loads(sys.argv[1])
for i, (cli, argv, refused) in enumerate(calls):
    os.environ["MASTER_PORT"] = str(json.loads(sys.argv[2])[i])
    try:
        (train if cli == "train" else detect).main(argv)
        assert not refused, f"call {i} ran"
    except ValueError as e:
        if not refused:
            raise
        print(f"REFUSED {i}: {e}", flush=True)
    print(f"DONE {i}", flush=True)
"""


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return generate_kitti(str(tmp_path_factory.mktemp("mesh") / "kitti"), num_train=2, num_test=2,
                          img_hw=(96, 128), max_objs=2)


def cli_argv(cli, tree, work, tag, extra):
    argv = ["--model-config", CONFIG, "--data-path", tree, "--device", "cpu"]
    if cli == "train":
        argv += ["--multihost"]
    else:
        argv += ["--out-dir", os.path.join(work, f"res_{tag}"), "--batch-size", "2", "--checkpoint",
                 os.path.join(work, "car.pt")]
    return argv + ["--set", "TRAINING.WEIGHTS", os.path.join(work, f"w_{tag}"), "TRAINING.LOGDIR", "''",
                   "SOLVER.MAX_EPOCH", "1", "BATCH_SIZE", "2", *SMALL, *SERVE, *extra]


def car_weights(tree, path):
    """create_model's weights with the vertex head drawing a car
    (tests/test_torch_ddp_cli.py), so that every line's LM converges."""
    import torch

    cfg = load_config(CONFIG, SMALL)
    K = create_dataset(tree, cfg, is_training=False, split="test")[0]["calib"].reshape(3, 3)
    sd = create_model(cfg).state_dict()
    sd["detect_header.offset_fr_main_header.offset_fr_main_head.weight"].zero_()
    sd["detect_header.offset_fr_main_header.offset_fr_main_head.bias"].copy_(torch.from_numpy(cuboid_vertex_bias(K)))
    torch.save(sd, path)


@pytest.fixture(scope="module")
def launched(tree, tmp_path_factory):
    """Two torchrun-style ranks: both CLIs under each accepted mesh, then
    each CLI under bands thinner than the stride; and one rank's detect
    run without a mesh, in this process."""
    import json
    import subprocess
    import sys

    work = str(tmp_path_factory.mktemp("mesh_ranks"))
    car_weights(tree, os.path.join(work, "car.pt"))
    calls = [(cli, cli_argv(cli, tree, work, f"{mesh}_{cli}", MESHES[mesh]), False)
             for mesh in MESHES for cli in ("train", "detect")]
    calls += [(cli, cli_argv(cli, tree, work, f"thin_{cli}", MESHES["data_spatial"] + THIN), True)
              for cli in ("train", "detect")]
    ports = [free_port() for _ in calls]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="2", PYTHONUNBUFFERED="1", MASTER_ADDR="127.0.0.1", WORLD_SIZE="2")
    procs, paths = [], []
    for r in range(2):
        paths.append(os.path.join(work, f"rank{r}.log"))
        with open(paths[-1], "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", LAUNCH, json.dumps(calls), json.dumps(ports)],
                                          cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=log,
                                          stderr=subprocess.STDOUT))
    wait_all(procs, TIMEOUT_S)
    logs = [open(p).read() for p in paths]
    assert all(p.returncode == 0 for p in procs), "\n".join(f"rank {r}: {t[-3000:]}" for r, t in enumerate(logs))
    one = detect.main(["--model-config", CONFIG, "--data-path", tree, "--device", "cpu", "--out-dir",
                       os.path.join(work, "res_one"), "--batch-size", "2", "--checkpoint",
                       os.path.join(work, "car.pt"), "--set", *SMALL, *SERVE])
    os.remove(os.path.join(work, "car.pt"))  # 100 MB the suite need not keep
    return {"work": work, "logs": logs, "one": one, "calls": calls}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cli", ["train", "detect"])
def test_cli_runs_a_spatial_mesh_under_torchrun(launched, cli, mesh):
    master, other = launched["logs"]
    work = launched["work"]
    i = [k for k, (c, argv, _) in enumerate(launched["calls"]) if c == cli and f"{mesh}_{cli}" in " ".join(argv)][0]
    block = master.split(f"DONE {i - 1}")[-1].split(f"DONE {i}")[0] if i else master.split("DONE 0")[0]
    if cli == "train":
        assert "2 ranks, 2 rows each, a 1 x 2 data x spatial grid" in block, block[-2000:]
        assert "epoch 0 test:" in block and "epoch 0" not in other
        saved = glob.glob(os.path.join(work, f"w_{mesh}_train", "*", "*.pt"))
        assert saved, os.listdir(work)
        shutil.rmtree(os.path.join(work, f"w_{mesh}_train"))  # checkpoints the suite need not keep
    else:
        assert "detect: 2 images" in block and "a 1 x 2 data x spatial grid" in block, block[-2000:]
        got, want = os.path.join(work, f"res_{mesh}_detect"), os.path.join(work, "res_one")
        names = sorted(os.path.splitext(f)[0] for f in os.listdir(want))
        assert len(names) == 2 and sorted(os.listdir(got)) == sorted(os.listdir(want))
        cmp = compare_result_dirs(want, got, names)
        assert cmp["lines"] == cmp["lines_got"] > 0 and cmp["box_agree_share"] == 1.0, cmp
        assert all(v == 0.0 for v in cmp["max_abs"].values()), cmp


@pytest.mark.parametrize("cli", ["train", "detect"])
def test_cli_refuses_bands_thinner_than_the_stride(launched, cli):
    i = [k for k, (c, _, refused) in enumerate(launched["calls"]) if c == cli and refused][0]
    for log in launched["logs"]:
        line = [l for l in log.splitlines() if l.startswith(f"REFUSED {i}:")]
        assert line and "thinner than the stride" in line[0], log[-2000:]
    assert not os.path.exists(os.path.join(launched["work"], f"res_thin_{cli}"))


@pytest.mark.parametrize("mesh", list(REFUSED), ids=list(REFUSED))
@pytest.mark.parametrize("cli", ["train", "detect"])
def test_cli_refuses_a_mesh_the_port_cannot_run(cli, mesh, tree, tmp_path):
    argv = ["--model-config", CONFIG, "--data-path", tree, "--device", "cpu"]
    if cli == "detect":
        argv += ["--out-dir", str(tmp_path / "res")]
    setting, message = REFUSED[mesh]
    argv += ["--set", "TRAINING.WEIGHTS", str(tmp_path / "w"), "TRAINING.LOGDIR", "''", *SMALL, *setting]
    with pytest.raises(ValueError, match=message):
        (train if cli == "train" else detect).main(argv)
    assert not (tmp_path / "res").exists() and not (tmp_path / "w").exists()


@pytest.mark.parametrize("shape,height,grid", [((-1, 2), 96, (2, 2)), ((2, 2), 64, (2, 2)), ((-1, 4), 128, (1, 4))])
def test_check_mesh_config_lays_out_the_grid(monkeypatch, shape, height, grid):
    monkeypatch.setattr(dist, "world_size", lambda: 4)
    cfg = load_config(CONFIG, ["TPU.MESH_AXES", "('data', 'spatial')", "TPU.MESH_SHAPE", str(shape),
                               "INPUT_SIZE", f"(128, {height})"])
    assert dist.check_mesh_config(cfg) == grid
    cfg = load_config(CONFIG, ["TPU.MESH_AXES", "('data', 'spatial')", "TPU.MESH_SHAPE", "(1, 4)",
                               "INPUT_SIZE", "(128, 96)"])
    with pytest.raises(ValueError, match="thinner than the stride"):
        dist.check_mesh_config(cfg)  # 3 units of 32 rows for 4 bands


def test_the_jax_package_builds_the_same_grid():
    """The JAX package's mesh for the same keys: the frames' rows sharded on
    ``spatial``, device ``i * S + j`` at ``(i, j)`` (8 virtual CPU devices,
    tests/conftest.py), the port's rank layout."""
    cfg = load_config_jax(CONFIG, MESHES["data_spatial"])
    mesh = create_mesh(cfg)
    assert mesh.axis_names == ("data", "spatial") and mesh.devices.shape == (4, 2)
    ids = [[d.id for d in row] for row in mesh.devices]
    first = ids[0][0]
    assert ids == [[first + i * 2 + j for j in range(2)] for i in range(4)]
    assert tuple(batch_sharding(mesh)["image"].spec)[:2] == ("data", "spatial")


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))),
                         ids=lambda p: os.path.basename(p))
def test_shipped_configs_pass(path):
    cfg = load_config(path)
    assert dist.check_mesh_config(cfg) == (1, 1)
    assert tuple(cfg.TPU.MESH_AXES) == ("data",)


def test_a_data_mesh_of_the_world_size_serves(tree, tmp_path):
    out = detect.main(["--model-config", CONFIG, "--data-path", tree, "--device", "cpu", "--out-dir",
                       str(tmp_path / "res"), "--batch-size", "2", "--set", *SMALL,
                       "TPU.MESH_AXES", "('data',)", "TPU.MESH_SHAPE", f"({dist.world_size()},)"])
    assert out["images"] == 2 and len(os.listdir(tmp_path / "res")) == 2
