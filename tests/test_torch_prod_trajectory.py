"""Does the port train as the JAX package trains, from one init? The
production campaign's gap (ROADMAP.md §C, fault (l): the port's
``port_prod_report.json`` starts at loss 9,898.5 and ends at 0.239 where
the JAX record ``prod_r5_report.json`` starts at 4,860.74 and ends at
0.029) settled on the CPU, both packages in one process: the first loss
is the draw's, and from one init the two packages train alike. (The rest
of the gap was the recipe: the JAX record ran with 10x LR drops at 5,000
and 8,000, which its report does not record; with them the port's
campaign ends at 0.0365 from its own draw and 0.0265 from the JAX draw,
``port_prod_r2_report.json`` and ``port_prod_jax_init_r2_report.json``.)

- (a) The first loss at the campaign's recipe (fixture seed 20, 64 train
  frames, 512x384, b8, the test-transform uint8 stream, ResNet-18), the
  train-mode loss of the stream's first batch under three weight sets:
  the JAX package with its ``PRNGKey(20)`` draw (``_init_jax_stack(cfg,
  ds, init_seed=20)``); the port with the same weights
  (``state_dict_from_jax``); the port with its own seed-20 draw, as
  ``train_port`` draws it. Measured: 4,862.501 (JAX), 4,862.501 (port,
  the same weights; 1e-7 apart, every term within 2e-6), 9,898.80 (the
  port's draw). The first two must agree to 1e-4 relative, each term too;
  the JAX init lands within 1e-3 of the JAX record's 4,860.74 (its TPU
  passes are bf16) and the port's draw within 1e-3 of the port record's
  9,898.5 (its card ran TF32). So the first-loss gap is the draw.
- (a, slow) Eight draws of each package (seeds 0-7) at the same batch:
  JAX 3,931-8,168 (mean 5,770), port 3,059-8,683 (mean 5,800). The means
  agree within 10% and each package's draws span more than 2x, the gap
  between the two seed-20 draws: the inits have one distribution.
- (b) The trajectory from one init at a small size: the production
  stream (test transform, constant LR 1e-3, no EMA), ResNet-18 at input
  128 (128x96 frames), 8 train frames, b4, the JAX tool's
  ``_init_jax_stack(init_seed=20)`` and its step over ``_step_stream``
  against ``train_port``'s loop from the same weights: 60 steps, and 200
  in a ``slow`` case (the port's step takes 1-1.5 s on 2 CPU threads, so
  200 steps of both packages take about 300 s alone, more than twice that
  beside the other files of a whole run). Measured at 200 steps: drift[0]
  1.3e-6, the largest over the first 10 steps 0.018, over all 0.13, the
  last 50 losses' means 0.992 (JAX) and 0.996 (port); at 60 steps the
  largest over all 0.032, the last-50 means 3.637 and 3.634. Bounds: drift[0]
  <= 1e-4, the first 10 < 5e-2, every step < 0.5, both losses fall, the
  last-50 means within 25% of each other (tests/test_ap_parity.py:41-47
  holds the side-by-side harness to 5e-3, 5e-2, 0.5 and 25%).

Run as a script, ``python tests/test_torch_prod_trajectory.py OUT.pt``
writes the JAX seed-20 draw at the campaign's recipe as a state dict of
the port (103 MB), which ``python -m rtm3d_tpu_torch.tools.ap_parity
--production --init OUT.pt`` trains from.
"""

import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from rtm3d_tpu.data import transforms as transforms_jax  # noqa: E402
from rtm3d_tpu.data.kitti import create_dataset as create_dataset_jax  # noqa: E402
from rtm3d_tpu.data.loader import DataLoader as DataLoaderJax  # noqa: E402
from rtm3d_tpu.train.step import _loss_from_batch as loss_from_batch_jax  # noqa: E402
from rtm3d_tpu_torch.data import transforms  # noqa: E402
from rtm3d_tpu_torch.data.kitti import create_dataset  # noqa: E402
from rtm3d_tpu_torch.nn.model import create_model  # noqa: E402
from rtm3d_tpu_torch.tools import ap_parity  # noqa: E402
from rtm3d_tpu_torch.train.checkpoint import state_dict_from_jax  # noqa: E402
from rtm3d_tpu_torch.train.step import _loss_from_batch  # noqa: E402
from tools import ap_parity as ap_jax  # noqa: E402

CAMPAIGN = dict(input_size=512, num_train=64, num_test=32, batch=8, seed=20)
RECORD_JAX_FIRST = 4860.74365234375  # docs/experiments/prod_r5_report.json
RECORD_PORT_FIRST = 9898.5  # docs/experiments/port_prod_report.json
SAME_WEIGHTS_REL = 1e-4
RECORD_REL = 1e-3
TRAJECTORY = dict(input_size=128, num_train=8, num_test=2, batch=4, seed=20)
TRAJECTORY_BOUNDS = {"drift0": 1e-4, "first10": 5e-2, "every": 0.5, "last50_rel": 0.25}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def campaign_stream(work: str, input_size: int, num_train: int, num_test: int, batch: int, seed: int):
    """Both packages' configs and datasets at the production recipe (the
    cached, uint8, test-transform stream), and the JAX loader."""
    data = ap_jax._fixture(work, input_size, num_train, num_test, seed)
    cfg_jax = ap_jax.make_config(data, input_size, batch, 1e-3)
    cfg = ap_parity.make_config(data, input_size, batch, 1e-3)
    for c in (cfg_jax, cfg):
        c.DATASET.CACHE_IMAGES, c.TPU.NORMALIZE_ON_DEVICE = True, True
    ds_jax = create_dataset_jax(data, cfg_jax, is_training=True, split="train",
                                augment=transforms_jax.test_transform(input_size))
    ds = create_dataset(data, cfg, is_training=True, split="train", augment=transforms.test_transform(input_size))
    cfg.INPUT_SIZE = tuple(ds.img_size)
    loader_jax = DataLoaderJax(ds_jax, batch, shuffle=True, seed=seed, num_shards=1, shard_index=0)
    return cfg_jax, ds_jax, cfg, ds, loader_jax


def jax_batch(b):
    return {"image": jnp.asarray(b["image"]), "labels": {k: jnp.asarray(v) for k, v in b["labels"].items()}}


def port_loss(net, cfg, b):
    """The port's train-mode loss terms [MKF, VFM, M_OFF, V_OFF, total] on ``b``."""
    net.train()
    with torch.no_grad():
        _, aux = _loss_from_batch(net, cfg, {"image": torch.from_numpy(np.asarray(b["image"])),
                                             "labels": {k: torch.from_numpy(np.asarray(v))
                                                        for k, v in b["labels"].items()}})
    return aux.numpy().astype(np.float64)


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    cfg_jax, ds_jax, cfg, ds, loader = campaign_stream(str(tmp_path_factory.mktemp("campaign")), **CAMPAIGN)
    _, b = next(ap_jax._step_stream(loader, 1, 0))
    model, variables, _, _, _ = ap_jax._init_jax_stack(cfg_jax, ds_jax, init_seed=CAMPAIGN["seed"])
    assert list(cfg.INPUT_SIZE) == list(cfg_jax.INPUT_SIZE) == [512, 384]
    terms = jax.jit(lambda v, batch: loss_from_batch_jax(model, cfg_jax, v["params"], v["batch_stats"], batch,
                                                         train=True)(v["params"])[1][0])
    return {"cfg_jax": cfg_jax, "cfg": cfg, "batch": b, "model": model, "variables": variables, "terms": terms}


def test_first_loss_at_the_campaign_recipe(campaign):
    cfg, b = campaign["cfg"], campaign["batch"]
    want = np.asarray(campaign["terms"](campaign["variables"], jax_batch(b)), np.float64)
    net = create_model(cfg)
    net.load_state_dict(state_dict_from_jax(jax.device_get(campaign["variables"]), net), strict=True)
    same = port_loss(net, cfg, b)
    draw = port_loss(create_model(cfg, torch.Generator().manual_seed(CAMPAIGN["seed"])), cfg, b)
    print(f"first loss: JAX init {want[4]:.3f} on JAX, {same[4]:.3f} on the port; the port's draw {draw[4]:.3f}")
    np.testing.assert_allclose(same, want, rtol=SAME_WEIGHTS_REL)
    assert abs(want[4] - RECORD_JAX_FIRST) <= RECORD_REL * RECORD_JAX_FIRST, want[4]
    assert abs(draw[4] - RECORD_PORT_FIRST) <= RECORD_REL * RECORD_PORT_FIRST, draw[4]
    assert draw[4] > 2 * want[4]  # the records' gap, 9,898.5 against 4,860.74, is there at step 0


@pytest.mark.slow
def test_the_two_packages_draw_from_one_distribution(campaign):
    cfg, b, model = campaign["cfg"], campaign["batch"], campaign["model"]
    init = jax.jit(model.init)
    w, h = cfg.INPUT_SIZE
    jax_first, port_first = [], []
    for seed in range(8):
        v = init(jax.random.PRNGKey(seed), jnp.zeros((1, h, w, 3)))
        jax_first.append(float(campaign["terms"](v, jax_batch(b))[4]))
        port_first.append(port_loss(create_model(cfg, torch.Generator().manual_seed(seed)), cfg, b)[4])
    print(f"first loss over seeds 0-7: JAX {np.round(jax_first, 1).tolist()}, port {np.round(port_first, 1).tolist()}")
    assert abs(np.mean(port_first) / np.mean(jax_first) - 1) < 0.1
    assert max(jax_first) > 2 * min(jax_first) and max(port_first) > 2 * min(port_first)


@pytest.mark.parametrize("steps", [60, pytest.param(200, marks=pytest.mark.slow)])
def test_trajectory_from_one_init(tmp_path, steps):
    cfg_jax, ds_jax, cfg, ds, loader = campaign_stream(str(tmp_path), **TRAJECTORY)
    _, variables, _, state, train_step = ap_jax._init_jax_stack(cfg_jax, ds_jax, init_seed=TRAJECTORY["seed"])
    init = state_dict_from_jax(jax.device_get(variables), create_model(cfg))
    loss_jax = []
    for _, b in ap_jax._step_stream(loader, steps, 0):  # the JAX tool's production loop (:583-640)
        state, metrics = train_step(state, jax_batch(b))
        loss_jax.append(float(metrics["loss"]))
    _, loss_port, rec = ap_parity.train_port(cfg, ds, str(tmp_path), steps, TRAJECTORY["batch"], TRAJECTORY["seed"],
                                             resume=False, save_every=steps, device=torch.device("cpu"),
                                             progress=lambda *a: None, init=init)
    assert rec["steps_run"] == steps and len(loss_jax) == len(loss_port) == steps
    drift = [abs(p - j) / max(abs(j), 1e-9) for p, j in zip(loss_port, loss_jax)]
    last_jax, last_port = np.mean(loss_jax[-50:]), np.mean(loss_port[-50:])
    print(f"trajectory: first {loss_jax[0]:.3f}/{loss_port[0]:.3f}, drift[0] {drift[0]:.2e}, first 10 "
          f"{max(drift[:10]):.4f}, all {max(drift):.4f}, last-50 means {last_jax:.4f}/{last_port:.4f}")
    b = TRAJECTORY_BOUNDS
    assert drift[0] <= b["drift0"], drift[0]
    assert max(drift[:10]) < b["first10"], drift[:10]
    assert max(drift) < b["every"], max(drift)
    assert loss_jax[-1] < loss_jax[0] and loss_port[-1] < loss_port[0]
    assert abs(last_port - last_jax) / max(last_port, last_jax) < b["last50_rel"], (last_jax, last_port)


def write_jax_init(out: str) -> None:
    """The JAX seed-20 draw at the campaign's recipe, as the port's state dict, to ``out``."""
    with tempfile.TemporaryDirectory() as work:
        cfg_jax, ds_jax, cfg, _, _ = campaign_stream(work, **CAMPAIGN)
        _, variables, _, _, _ = ap_jax._init_jax_stack(cfg_jax, ds_jax, init_seed=CAMPAIGN["seed"])
        torch.save(state_dict_from_jax(jax.device_get(variables), create_model(cfg)), out)


if __name__ == "__main__":
    write_jax_init(sys.argv[1])
