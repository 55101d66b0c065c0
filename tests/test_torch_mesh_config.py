"""``TPU.MESH_AXES``/``TPU.MESH_SHAPE`` in the port's CLIs, on the CPU.

The JAX CLIs build their device mesh from both keys
(``rtm3d_tpu/cli/train.py:126``, ``cli/detect.py:206``), and a ``spatial``
axis shards each frame's rows (``rtm3d_tpu/parallel/mesh.py:88-94``). The
port runs data parallelism only, one process per device under torchrun, so
both CLIs refuse any other mesh with a message
(``parallel/dist.py::check_mesh_config``) before they read a frame, where
they used to run data-parallel without a word. Every shipped config
passes, and a mesh of ``(world size,)`` on the ``data`` axis serves.
"""

import glob
import os

import pytest

from rtm3d_tpu.config import load_config as load_config_jax
from rtm3d_tpu.parallel.mesh import batch_sharding, create_mesh
from rtm3d_tpu_torch.cli import detect, train
from rtm3d_tpu_torch.config import load_config
from rtm3d_tpu_torch.data.synthetic import generate_kitti
from rtm3d_tpu_torch.parallel import dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "rtm3d_resnet18_kitti.yaml")
SMALL = ["INPUT_SIZE", "(128, 128)", "DETECTOR.TOPK_CANDIDATES", "5", "num_workers", "0"]
REFUSED = [
    ["TPU.MESH_AXES", "('data', 'spatial')", "TPU.MESH_SHAPE", "(-1, 2)"],
    ["TPU.MESH_AXES", "('spatial',)"],
    ["TPU.MESH_SHAPE", "(4,)"],
]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return generate_kitti(str(tmp_path_factory.mktemp("mesh") / "kitti"), num_train=2, num_test=2,
                          img_hw=(96, 128), max_objs=2)


@pytest.mark.parametrize("mesh", REFUSED, ids=["data_spatial", "spatial", "shape_4"])
@pytest.mark.parametrize("cli", ["train", "detect"])
def test_cli_refuses_a_mesh_the_port_cannot_run(cli, mesh, tree, tmp_path):
    argv = ["--model-config", CONFIG, "--data-path", tree, "--device", "cpu"]
    if cli == "detect":
        argv += ["--out-dir", str(tmp_path / "res")]
    argv += ["--set", "TRAINING.WEIGHTS", str(tmp_path / "w"), "TRAINING.LOGDIR", "''", *SMALL, *mesh]
    with pytest.raises(ValueError, match=r"data parallelism only.*torchrun.*'spatial' axis.*not ported"):
        (train if cli == "train" else detect).main(argv)
    assert not (tmp_path / "res").exists() and not (tmp_path / "w").exists()


def test_the_jax_package_runs_the_refused_spatial_mesh():
    """What the port refuses is a mesh the JAX package builds: the frames'
    rows sharded on ``spatial`` (8 virtual CPU devices, tests/conftest.py)."""
    cfg = load_config_jax(CONFIG, ["TPU.MESH_AXES", "('data', 'spatial')", "TPU.MESH_SHAPE", "(-1, 2)"])
    mesh = create_mesh(cfg)
    assert mesh.axis_names == ("data", "spatial") and mesh.devices.shape[1] == 2
    assert tuple(batch_sharding(mesh)["image"].spec)[:2] == ("data", "spatial")


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))),
                         ids=lambda p: os.path.basename(p))
def test_shipped_configs_pass(path):
    cfg = load_config(path)
    dist.check_mesh_config(cfg)
    assert tuple(cfg.TPU.MESH_AXES) == ("data",)


def test_a_data_mesh_of_the_world_size_serves(tree, tmp_path):
    out = detect.main(["--model-config", CONFIG, "--data-path", tree, "--device", "cpu", "--out-dir",
                       str(tmp_path / "res"), "--batch-size", "2", "--set", *SMALL,
                       "TPU.MESH_AXES", "('data',)", "TPU.MESH_SHAPE", f"({dist.world_size()},)"])
    assert out["images"] == 2 and len(os.listdir(tmp_path / "res")) == 2
