"""The ``spatial`` mesh axis of the port (``parallel/spatial.py``): training
and the eval-loss step row-sharded over a data x spatial grid of gloo
ranks on the CPU, against one rank on the same global batch and against
the JAX package's single-device step on it.

Two launches of rank processes (this file run as a script, ``_rank_main``:
no JAX in the children, two intra-op threads each, a ``file://``
rendezvous in the test's directory, every wait bounded), started together
while this process computes the one-rank and JAX references:

- two ranks, grid (1, 2): DLA-34 at 64x64 (bands 32 + 32), global batch 4,
  three steps, then the same three steps with ``TPU.REMAT``, the eval-loss
  step and three witnesses; ResNet-18 at 96 rows x 64 (uneven bands,
  64 + 32: its stride-2 stem and -inf-padded max-pool on both), one step;
  every per-op case below;
- four ranks, grid (2, 2): the DLA-34 64x64 run and the eval-loss step,
  each data group two of the four frames.

The network runs in float64 (as tests/test_torch_ddp.py: the float32
gradient of this network carries about 1% of noise per tensor), from the
JAX initial weights (``state_dict_from_jax``), BASE_LR 1e-3 with
tests/test_torch_ddp.py's two warm-up steps (lr 1e-6, 5e-4, 1e-3). Without
the warm-up, plain data parallelism (two ranks, spatial size 1) already
parts from one rank on these batches by 3.3e-6 at one coordinate of
``main_offset_header.0.weight`` after the first update: coupled weight
decay cancels its gradient to 1.4e-9, under Adamax's eps of 1e-8, so the
update there follows rounding; the (2, 2) grid parts by the same amount.

Gates, each tests/test_torch_ddp.py's against one rank: the loss and aux
of each step rel 1e-6, the BN running statistics atol 1e-7, the step-1
gradient rel 1e-8 in L2 over all of it and 1e-6 per tensor, the
parameters and the EMA after the last step within 1e-6 (the runs keep
each one's move from the initial weights, in float32: 6e-8 of it at
most, 6e-11 after three steps at lr 1e-3), the ranks' parameters
hashing equal after each step, ``num_targets`` equal. Against the JAX step
(float64) after one step, tests/test_torch_train.py's one-step gates: the
loss rel 1e-5, the BN statistics atol 1e-5, the parameters and the EMA
more than 1e-7 apart on at most 1e-3 of the coordinates and none more
than 2 lr.
``TPU.REMAT`` on equals off under the grid bit for bit (losses and
parameter hashes). The eval-loss step with a padded row equals one rank's
loss of the valid rows.

Measured on the CPU: against one rank, the loss within 1.1e-7, the BN
statistics 2.3e-9, the step-1 gradient 6.8e-11 in L2 (1.8e-8 the worst
tensor, at (2, 2)), the parameters 3.8e-9; against the JAX step, the loss
within 1.4e-6, the BN statistics 1.5e-7, the parameters more than 1e-7
apart on 2.5e-6 of the coordinates, none more than 1.99e-6 (2 lr: 2e-6).

Witnesses, one step each on the two ranks, must part from one rank past
the gates: the halo replaced by zero rows at every band edge, a
band-local KFPN softmax, and the loss's gathers not masked to the band
that owns the pixel (measured: the step-1 gradient 1.44, 0.21 and 0.028
apart in L2).

Per op: ``Conv`` (kernel 1, 3, 7; stride 1, 2; dilation 6 at kernel 3),
``UpSample`` and the ResNet ``MaxPool`` on two bands of a 32-row map,
even (16 + 16) and uneven (24 + 8), against the op on the whole map in
float64: the output, the input gradient and the weight gradients summed
over the ranks within 1e-12 of the largest value. A halo taller than a
neighbour's band raises on both ranks.

A ``slow`` case runs the JAX package's own ``("data", "spatial")`` mesh
(1 x 2 over two of the virtual CPU devices, as tests/test_sharding.py:
60-74 builds it) against the port's grid on the same batch.
"""

import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rtm3d_tpu_torch.config import default_config
from rtm3d_tpu_torch.data.targets import build_targets
from rtm3d_tpu_torch.nn.layers import Conv, MaxPool, UpSample
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.parallel import spatial
from rtm3d_tpu_torch.train.state import TrainState
from rtm3d_tpu_torch.train.step import make_eval_loss_step, make_train_step
from tests.test_torch_ddp import wait_all

REPO = Path(__file__).resolve().parents[1]
B, N = 4, 6
STEPS = {"dla": 3, "resnet_uneven": 1}
CASES = {"dla": ("DLA-34", (64, 64)), "resnet_uneven": ("RESNET-18", (64, 96))}
BANDS = {"dla": [(0, 32), (32, 64)], "resnet_uneven": [(0, 64), (64, 96)]}
TIMEOUT_S = 300
LOSS_REL, BUFFER_ATOL, GRAD_L2, GRAD_L2_TENSOR, PARAM_ATOL = 1e-6, 1e-7, 1e-8, 1e-6, 1e-6
WITNESSES = ("zero_halo", "local_softmax", "unmasked_gathers")
# the per-op cases: (name, constructor, its arguments)
OPS = [(f"conv_k{k}_s{s}_d{d}", Conv, (3, 4, k, s, d, True, 0 if k == 1 else None))
       for k, s, d in ((1, 1, 1), (1, 2, 1), (3, 1, 1), (3, 2, 1), (7, 1, 1), (7, 2, 1), (3, 1, 6))]
OPS += [("upsample", UpSample, (3,)), ("maxpool", MaxPool, (3, 2, 1))]
SPLITS = {"even": [(0, 16), (16, 32)], "uneven": [(0, 24), (24, 32)]}


def port_cfg(case):
    backbone, hw = CASES[case]
    cfg = default_config()
    cfg.INPUT_SIZE = hw
    cfg.BATCH_SIZE = B
    cfg.DATASET.MAX_OBJS = N
    cfg.SOLVER.BASE_LR = 1e-3
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.TPU.DONATE = False
    cfg.TPU.S2D_STEM = False
    if backbone != "DLA-34":
        cfg.MODEL.BACKBONE = backbone
        cfg.MODEL.KFNs = ["layer1", "layer2", "layer3", "layer4"]
    return cfg


def train_batch(seed, hw):
    """A global batch of 4 frames of ``hw`` (w, h): 6 boxes a frame spread
    over every band, the last frames' later slots padded out, one slot
    flagged as noise. The 3D boxes project near the principal point, so
    many vertices lie in another band than their box's centre."""
    w, h = hw
    rng = np.random.RandomState(seed)
    x1, y1 = rng.rand(B, N) * (w - 20), rng.rand(B, N) * (h - 20)
    labels = {
        "cls": rng.randint(0, 3, (B, N)).astype(np.int32),
        "bbox": np.stack([x1, y1, x1 + 15, y1 + 12], -1).astype(np.float32),
        "dim": (rng.rand(B, N, 3) + 0.5).astype(np.float32),
        "alpha": np.zeros((B, N), np.float32),
        "ry": rng.uniform(-1, 1, (B, N)).astype(np.float32),
        "loc": np.stack([rng.randn(B, N), rng.randn(B, N) * 0.2 + 1, rng.rand(B, N) * 20 + 8], -1).astype(np.float32),
        "K": np.tile(np.array([60.0, 0, w / 2, 0, 60.0, h / 2, 0, 0, 1], np.float32), (B, N, 1)),
        "mask": np.ones((B, N), bool),
        "noise_mask": np.zeros((B, N), bool),
    }
    labels["mask"][0, N - 1] = False
    labels["mask"][2:, 3:] = False
    labels["noise_mask"][3, 1] = True
    return {"image": rng.rand(B, h, w, 3), "labels": labels}


def rows(tree, index, parts):
    """Data group ``index``'s contiguous rows of a batch, of ``parts``."""
    if isinstance(tree, dict):
        return {k: rows(v, index, parts) for k, v in tree.items()}
    n = len(tree) // parts
    return tree[index * n:(index + 1) * n]


def digest(model) -> str:
    h = hashlib.sha256()
    for _, p in model.named_parameters():
        h.update(p.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def new_state(state_dict, cfg):
    model = create_model(cfg)
    model.load_state_dict(state_dict, strict=True)
    state = TrainState.create(model, cfg, device="cpu", with_ema=True)
    state.model.double()
    state.ema = {k: v.double() for k, v in state.ema.items()}
    return state


def train_run(state_dict, cfg, batches, heavy: bool) -> dict:
    """The train steps on ``batches``: each step's loss items, target count,
    parameter hash and BN statistics; with ``heavy``, the step-1 gradient
    (float64), and how far the parameters and the EMA moved from
    ``state_dict`` by step 1 and by the last step (float32)."""
    state = new_state(state_dict, cfg)
    step = make_train_step(cfg, device="cpu")
    out = {"loss_items": [], "num_targets": [], "digests": [], "buffers": []}
    for i, b in enumerate(batches):
        state, m = step(state, b)
        out["loss_items"].append(m["loss_items"].clone())
        out["num_targets"].append(int(m["num_targets"]))
        out["digests"].append(digest(state.model))
        out["buffers"].append({k: v.detach().clone() for k, v in state.model.named_buffers()
                               if k.endswith(("running_mean", "running_var"))})
        if heavy and i == 0:
            out["grads"] = {k: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                            for k, p in state.model.named_parameters()}
        for tag in ("1",) * (i == 0) + ("",) * (i == len(batches) - 1) if heavy else ():
            out["params" + tag] = {k: (p.detach() - state_dict[k].double()).float()
                                   for k, p in state.model.named_parameters()}
            out["ema" + tag] = {k: (v - state_dict[k].double()).float() for k, v in state.ema.items()}
    return out


def eval_batch(hw):
    b = train_batch(8, hw)
    b["sample_valid"] = np.array([True, True, True, False])
    return b


def eval_run(state_dict, cfg, batch):
    return make_eval_loss_step(cfg, device="cpu")(new_state(state_dict, cfg), batch)["loss_items"]


def op_case(name, split, inputs, grid=None):
    """The op of ``name`` on ``inputs``' map: on the whole of it, or, with
    ``grid``, on this rank's band. The output, the input gradient (from the
    output gradient's matching rows) and the weight gradients."""
    ctor, args = {n: (c, a) for n, c, a in OPS}[name]
    mod = ctor(*args).double()
    mod.load_state_dict(inputs["state"][name])
    x, gy = inputs["x"], inputs["gy"][name]
    if grid is not None:
        a, b = grid.band
        x = x[:, :, a:b]
        scale = gy.shape[2] / inputs["x"].shape[2]
        gy = gy[:, :, int(a * scale):int(b * scale)]
    x = x.clone().requires_grad_()
    with spatial.attached(mod, grid):
        y = mod(x)
    (y * gy).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw": [p.grad for p in mod.parameters()]}


def _rank_main(workdir: str, rank: int, world: int) -> None:
    """One rank of a launch: every case of its grid on its band."""
    from rtm3d_tpu_torch.losses import rtm3d_loss as loss_mod
    from rtm3d_tpu_torch.nn import kfpn
    from rtm3d_tpu_torch.parallel import dist

    torch.set_num_threads(2)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    dist.init_distributed("cpu", init_method=f"file://{workdir}/store{world}", rank=rank, world_size=world,
                          timeout=60)
    try:
        data = world // 2
        dist.init_mesh(data, 2)
        d, heavy = dist.data_index(), rank == 0
        out = {"grid": (dist.data_size(), dist.spatial_size(), d, dist.spatial_index())}
        for case in CASES if world == 2 else ("dla",):
            spec = inputs["cases"][case]
            mine = [rows(b, d, data) for b in spec["batches"]]
            res = {"train": train_run(spec["state_dict"], spec["cfg"], mine, heavy)}
            if case == "dla":
                res["eval"] = eval_run(spec["state_dict"], spec["cfg"], rows(spec["eval_batch"], d, data))
            if case == "dla" and world == 2:
                remat = train_run(spec["state_dict"], spec["cfg_remat"], mine, False)
                res["remat"] = {k: remat[k] for k in ("loss_items", "digests")}
                one_rank = {"zero_halo": (spatial.Grid, "exchange", lambda self, up, down: (None, None)),
                            "local_softmax": (kfpn, "softmax_hw", lambda flat, grid: torch.softmax(flat, -1)),
                            "unmasked_gathers": (loss_mod, "_gather_pixels", None)}
                gather = loss_mod._gather_pixels

                def unmasked(fmap, xy, rows=None):
                    got, owned = gather(fmap, xy, rows)
                    return got, None if owned is None else torch.ones_like(owned)

                for name in WITNESSES:
                    where, attr, fn = one_rank[name]
                    saved = getattr(where, attr)
                    setattr(where, attr, unmasked if fn is None else fn)
                    try:
                        w = train_run(spec["state_dict"], spec["cfg"], mine[:1], heavy)
                    finally:
                        setattr(where, attr, saved)
                    res[name] = {"loss_items": w["loss_items"],
                                 "grads": {k: g.float() for k, g in w["grads"].items()}} if heavy else {}
            torch.save(res, os.path.join(workdir, f"{case}{world}_rank{rank}.pt"))
        if world == 2:
            grid = {k: spatial.Grid(v, dist.spatial_index(), dist.spatial_group()) for k, v in SPLITS.items()}
            out["ops"] = {(name, split): op_case(name, split, inputs["ops"], grid[split])
                          for name, _, _ in OPS for split in SPLITS}
            thin = spatial.Grid([(0, 4), (4, 8)], dist.spatial_index(), dist.spatial_group())
            try:
                spatial.halo_exchange(torch.zeros(1, 1, 4, 3), 5, 0, 0.0, thin)
            except ValueError as e:
                out["too_tall"] = str(e)
        torch.save(out, os.path.join(workdir, f"misc{world}_rank{rank}.pt"))
    finally:
        dist.shutdown()


def start(workdir: Path, world: int) -> list:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="2")
    procs = []
    for r in range(world):
        with open(workdir / f"w{world}_rank{r}.log", "w") as log:
            procs.append(subprocess.Popen([sys.executable, __file__, str(workdir), str(r), str(world)], cwd=REPO,
                                          env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def finish(workdir: Path, procs: list, world: int) -> None:
    wait_all(procs, TIMEOUT_S)
    for r, p in enumerate(procs):
        assert p.returncode == 0, (workdir / f"w{world}_rank{r}.log").read_text()[-4000:]


def pop(workdir: Path, name: str):
    """A rank's file, read and deleted (they are hundreds of MB)."""
    path = workdir / name
    out = torch.load(path, weights_only=False)
    path.unlink()
    return out


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def l2(a, b):
    return float((a - b).norm() / b.norm())


def flat(tree):
    return torch.cat([v.double().reshape(-1) for v in tree.values()])


def params_apart(got: dict, want: dict, atol: float):
    diff = torch.cat([(got[k].double() - torch.as_tensor(want[k]).double()).abs().reshape(-1) for k in want])
    return float((diff > atol).double().mean()), float(diff.max())


def against_one_rank(grid_ranks: list, one: dict) -> dict:
    """The gates' numbers for a grid run (every rank's train record, rank 0
    the heavy one) against the one-rank run of the same batches."""
    r0 = grid_ranks[0]
    per = {k: l2(r0["grads"][k], g) for k, g in one["grads"].items() if g.norm() > 0}
    return {
        "hash_equal": all(r["digests"] == r0["digests"] for r in grid_ranks),
        "hashes_move": len(set(r0["digests"])) == len(r0["digests"]),
        "loss_rel": max(float(((r["loss_items"][i] - w).abs() / w.abs()).max())
                        for r in grid_ranks for i, w in enumerate(one["loss_items"])),
        "num_targets": [r["num_targets"] for r in grid_ranks],
        "buffer_diff": max(float((r0["buffers"][i][k] - v).abs().max())
                           for i, bufs in enumerate(one["buffers"]) for k, v in bufs.items()),
        "grad_l2": l2(flat(r0["grads"]), flat(one["grads"])), "grad_l2_tensor": max(per.values()),
        "params": params_apart(r0["params"], one["params"], PARAM_ATOL),
        "ema": params_apart(r0["ema"], one["ema"], PARAM_ATOL),
    }


def jax_reference(case, variables, jax_model, batches):
    """The JAX package's single-device train step, float64, on the global
    batch: metrics, and the parameters, EMA and BN statistics after it."""
    import jax
    import jax.numpy as jnp

    from rtm3d_tpu.config import default_config as default_config_jax
    from rtm3d_tpu.train import optim as optim_jax
    from rtm3d_tpu.train.state import TrainState as TrainStateJax
    from rtm3d_tpu.train.step import make_train_step as make_train_step_jax

    cfg = port_cfg(case)
    cfg_jax = default_config_jax()
    cfg_jax.INPUT_SIZE, cfg_jax.BATCH_SIZE, cfg_jax.DATASET.MAX_OBJS = cfg.INPUT_SIZE, B, N
    cfg_jax.SOLVER.BASE_LR, cfg_jax.SOLVER.WARMUP_ITERS = 1e-3, 2
    cfg_jax.TPU.DONATE, cfg_jax.TPU.S2D_STEM = False, False
    cfg_jax.MODEL.BACKBONE, cfg_jax.MODEL.KFNs = cfg.MODEL.BACKBONE, list(cfg.MODEL.KFNs)
    to64 = lambda tree: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64) if a.dtype in (np.float32, np.float64) else jnp.asarray(a), tree)
    with jax.enable_x64():
        v64 = to64(variables)
        tx, schedule = optim_jax.build_optimizer(cfg_jax, v64["params"])
        state, m = make_train_step_jax(jax_model, cfg_jax, tx)(TrainStateJax.create(v64, tx, with_ema=True),
                                                              to64(batches[0]))
        state, m = jax.device_get((state, m))
    return {"metrics": m, "state": state, "lr": float(schedule(0))}


def against_jax(r0: dict, ref: dict, model, init: dict) -> dict:
    """A grid run's first step (rank 0's record) against the JAX step's;
    ``init``: the weights both started from."""
    from rtm3d_tpu_torch.train.checkpoint import state_dict_from_jax

    s = ref["state"]
    sd = state_dict_from_jax({"params": s.params, "batch_stats": s.batch_stats}, model)
    ema = state_dict_from_jax({"params": s.ema_params, "batch_stats": s.batch_stats}, model)
    moved = lambda tree: {k: tree[k].double() - init[k].double() for k in r0["params1"]}
    return {
        "loss_rel": abs(r0["loss_items"][0][4].item() - float(ref["metrics"]["loss"])) / float(ref["metrics"]["loss"]),
        "num_targets": (r0["num_targets"][0], int(ref["metrics"]["num_targets"])),
        "buffer_diff": max(float((v - sd[k]).abs().max()) for k, v in r0["buffers"][0].items()),
        "params": params_apart(r0["params1"], moved(sd), 1e-7),
        "ema": params_apart(r0["ema1"], moved(ema), 1e-7),
        "bound": 2 * ref["lr"],
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both launches, the one-rank runs and the JAX steps, reduced to the
    numbers the tests gate (the states are GBs)."""
    from rtm3d_tpu_torch.train.checkpoint import state_dict_from_jax
    from tests.test_torch_model import jax_variables

    torch.set_num_threads(2)
    inputs, jax_side = {"cases": {}}, {}
    for case in CASES:
        cfg = port_cfg(case)
        jax_side[case] = jax_variables(cfg, seed=2)
        jax_model, variables = jax_side[case]
        spec = {"cfg": cfg, "state_dict": state_dict_from_jax(variables, create_model(cfg)),
                "batches": [train_batch(s, cfg.INPUT_SIZE) for s in range(5, 5 + STEPS[case])]}
        if case == "dla":
            spec["cfg_remat"] = port_cfg(case)
            spec["cfg_remat"].TPU.REMAT = True
            spec["eval_batch"] = eval_batch(cfg.INPUT_SIZE)
        inputs["cases"][case] = spec
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 3, 32, 5))
    ops = {"x": x, "state": {}, "gy": {}}
    for name, ctor, args in OPS:
        mod = ctor(*args).double()
        if hasattr(mod, "reset_parameters"):
            mod.reset_parameters(torch.Generator().manual_seed(len(ops["state"])))
        ops["state"][name] = mod.state_dict()
        with torch.no_grad():
            ops["gy"][name] = torch.from_numpy(rng.randn(*mod(x).shape))
    inputs["ops"] = ops

    workdir = tmp_path_factory.mktemp("spatial")
    torch.save(inputs, workdir / "inputs.pt")
    launches = {w: start(workdir, w) for w in (2, 4)}
    try:
        one = {case: train_run(spec["state_dict"], spec["cfg"], spec["batches"], True)
               for case, spec in inputs["cases"].items()}
        dla = inputs["cases"]["dla"]
        eb = dla["eval_batch"]
        one_eval = eval_run(dla["state_dict"], dla["cfg"], {"image": eb["image"][:3],
                                                            "labels": {k: v[:3] for k, v in eb["labels"].items()}})
        refs = {case: jax_reference(case, jax_side[case][1], jax_side[case][0], spec["batches"])
                for case, spec in inputs["cases"].items()}
    finally:
        for w, procs in launches.items():
            finish(workdir, procs, w)
    (workdir / "inputs.pt").unlink()

    out = {"one_eval": one_eval, "ops_inputs": ops}
    for case, spec in inputs["cases"].items():
        model = create_model(spec["cfg"])
        for w in (2, 4) if case == "dla" else (2,):
            ranks = [pop(workdir, f"{case}{w}_rank{r}.pt") for r in range(w)]
            train = [r["train"] for r in ranks]
            out[(case, w)] = {"one_rank": against_one_rank(train, one[case]),
                              "jax": against_jax(train[0], refs[case], model, spec["state_dict"]),
                              "one_num_targets": one[case]["num_targets"]}
            if case == "dla":
                out[(case, w)]["eval"] = [r["eval"] for r in ranks]
            if case == "dla" and w == 2:
                out["remat"] = [(r["remat"], r["train"]["loss_items"], r["train"]["digests"]) for r in ranks]
                for name in WITNESSES:
                    wit = ranks[0][name]
                    out[name] = {"grad_l2": l2(flat(wit["grads"]), flat(one[case]["grads"])),
                                 "loss_rel": float((wit["loss_items"][0][4] - one[case]["loss_items"][0][4]).abs()
                                                   / one[case]["loss_items"][0][4])}
            del ranks, train
    out["misc"] = {w: [pop(workdir, f"misc{w}_rank{r}.pt") for r in range(w)] for w in (2, 4)}
    return out


GRIDS = [("dla", 2), ("dla", 4), ("resnet_uneven", 2)]
GRID_IDS = ["dla_1x2", "dla_2x2", "resnet18_uneven_1x2"]


def test_band_rows():
    assert spatial.band_rows(416, 2, 32) == [(0, 224), (224, 416)]
    assert spatial.band_rows(384, 4, 32) == [(0, 96), (96, 192), (192, 288), (288, 384)]
    assert spatial.band_rows(96, 2, 32) == [(0, 64), (64, 96)]
    with pytest.raises(ValueError, match="thinner than the stride"):
        spatial.band_rows(64, 4, 32)
    with pytest.raises(ValueError, match="not a multiple of the network's deepest stride 32"):
        spatial.band_rows(100, 2, 32)


def test_without_a_grid_nothing_is_banded():
    """Spatial size 1: no grid, and ``attached`` leaves the model alone."""
    model = create_model(port_cfg("dla"))
    assert spatial.frame_grid(64, 32) is None
    with spatial.attached(model, None):
        assert all(getattr(m, "spatial", None) is None for m in model.modules())


def test_the_ranks_sit_on_the_row_major_grid(world):
    for w, ranks in world["misc"].items():
        data = w // 2
        assert [r["grid"] for r in ranks] == [(data, 2, r // 2, r % 2) for r in range(w)]


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_grid_train_steps_equal_one_rank(world, grid):
    got = world[grid]["one_rank"]
    assert got["hash_equal"] and got["hashes_move"], got
    assert got["loss_rel"] <= LOSS_REL, got
    assert got["buffer_diff"] <= BUFFER_ATOL, got
    assert got["grad_l2"] <= GRAD_L2 and got["grad_l2_tensor"] <= GRAD_L2_TENSOR, got
    assert got["params"][0] == 0 and got["ema"][0] == 0, got


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_grid_train_step_matches_jax_on_the_global_batch(world, grid):
    got = world[grid]["jax"]
    assert got["loss_rel"] <= 1e-5, got
    assert got["buffer_diff"] <= 1e-5, got
    for share, worst in (got["params"], got["ema"]):
        assert share <= 1e-3 and worst <= got["bound"], got


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_num_targets_counts_each_object_once(world, grid):
    """Summed over the data axis only: the ranks of a data group hold the
    same labels. Equal to one rank's and to the JAX step's."""
    rec = world[grid]
    assert all(n == rec["one_num_targets"] for n in rec["one_rank"]["num_targets"])
    assert rec["jax"]["num_targets"][0] == rec["jax"]["num_targets"][1]


def test_remat_on_equals_off_under_the_grid(world):
    for remat, losses, digests in world["remat"]:
        assert remat["digests"] == digests
        assert all(torch.equal(a, b) for a, b in zip(remat["loss_items"], losses))


@pytest.mark.parametrize("w", [2, 4], ids=["1x2", "2x2"])
def test_grid_eval_loss_leaves_padded_rows_out(world, w):
    for got in world[("dla", w)]["eval"]:
        torch.testing.assert_close(got, world["one_eval"], rtol=LOSS_REL, atol=0)


def test_the_batches_cross_bands():
    """The gathers' ownership is exercised: centres in both bands, and
    vertices in another band than their centre's."""
    for case in CASES:
        cfg = port_cfg(case)
        labels = train_batch(5, cfg.INPUT_SIZE)["labels"]
        t = build_targets({k: torch.from_numpy(v) for k, v in labels.items()},
                          (cfg.INPUT_SIZE[1] // 4, cfg.INPUT_SIZE[0] // 4), 3)
        edge = BANDS[case][0][1] // 4
        live = t["mask"] & ~t["noise_mask"]
        centre_top = t["m_proj"][..., 1] < edge
        vert_top = t["v_proj"][..., 1] < edge
        assert (live & centre_top).any() and (live & ~centre_top).any()
        crossing = live[..., None] & t["mask_3d"][..., None] & t["v_mask"] & (vert_top != centre_top[..., None])
        assert crossing.sum() >= 4, crossing.sum()


@pytest.mark.parametrize("witness", WITNESSES)
def test_witnesses_part_from_one_rank(world, witness):
    """Each fault the spatial path guards against, made on purpose, moves
    the step-1 gradient past the gradient gate by far."""
    assert world[witness]["grad_l2"] > 1e6 * GRAD_L2, world[witness]


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("name", [n for n, _, _ in OPS])
def test_banded_op_equals_the_whole_op(world, name, split):
    got = [r["ops"][(name, split)] for r in world["misc"][2]]
    want = op_case(name, split, world["ops_inputs"])
    y = torch.cat([g["y"] for g in got], 2)
    dx = torch.cat([g["dx"] for g in got], 2)
    assert y.shape == want["y"].shape and dx.shape == want["dx"].shape
    assert rel(y, want["y"]) <= 1e-12 and rel(dx, want["dx"]) <= 1e-12
    for i, w in enumerate(want["dw"]):
        assert rel(got[0]["dw"][i] + got[1]["dw"][i], w) <= 1e-12


def test_a_halo_taller_than_a_band_raises_on_every_rank(world):
    for r in world["misc"][2]:
        assert "taller than a neighbour's band" in r["too_tall"]


@pytest.mark.slow
def test_jax_spatial_mesh_equals_the_port_grid():
    """The JAX package's ``("data", "spatial")`` mesh, 1 x 2 over two
    virtual CPU devices (tests/conftest.py), against the port's grid of
    two gloo ranks, one step of DLA-34 at 64x64 in float64 on the same
    batch and weights: the loss, the BN statistics and the parameters, at
    tests/test_torch_train.py's one-step tolerances."""
    import jax
    import jax.numpy as jnp

    from rtm3d_tpu.config import default_config as default_config_jax
    from rtm3d_tpu.parallel.mesh import create_mesh, replicate_state, shard_batch
    from rtm3d_tpu.train import optim as optim_jax
    from rtm3d_tpu.train.state import TrainState as TrainStateJax
    from rtm3d_tpu.train.step import make_train_step as make_train_step_jax
    from rtm3d_tpu_torch.train.checkpoint import state_dict_from_jax
    from tests.test_torch_model import jax_variables

    cfg = port_cfg("dla")
    cfg_jax = default_config_jax()
    cfg_jax.INPUT_SIZE, cfg_jax.BATCH_SIZE, cfg_jax.DATASET.MAX_OBJS = cfg.INPUT_SIZE, B, N
    cfg_jax.SOLVER.BASE_LR, cfg_jax.SOLVER.WARMUP_ITERS = 1e-3, 2
    cfg_jax.TPU.DONATE, cfg_jax.TPU.S2D_STEM = False, False
    cfg_jax.TPU.MESH_AXES, cfg_jax.TPU.MESH_SHAPE = ("data", "spatial"), (1, 2)
    jax_model, variables = jax_variables(cfg, seed=2)
    batch = train_batch(5, cfg.INPUT_SIZE)
    to64 = lambda tree: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64) if a.dtype in (np.float32, np.float64) else jnp.asarray(a), tree)
    with jax.enable_x64():
        mesh = create_mesh(cfg_jax, devices=jax.devices()[:2])
        v64 = to64(variables)
        tx, schedule = optim_jax.build_optimizer(cfg_jax, v64["params"])
        state = replicate_state(mesh, TrainStateJax.create(v64, tx, with_ema=True))
        state, m = make_train_step_jax(jax_model, cfg_jax, tx)(state, shard_batch(mesh, to64(batch)))
        state, m = jax.device_get((state, m))

    torch.set_num_threads(2)
    workdir = Path(os.environ.get("TMPDIR", "/tmp")) / f"spatial_jax_mesh_{os.getpid()}"
    workdir.mkdir(parents=True, exist_ok=True)
    model = create_model(cfg)
    spec = {"cfg": cfg, "state_dict": state_dict_from_jax(variables, model), "batches": [batch]}
    torch.save({"cases": {"mesh": spec}}, workdir / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, __file__, str(workdir), str(r), "mesh"], cwd=REPO, env=env)
             for r in range(2)]
    wait_all(procs, TIMEOUT_S)
    assert all(p.returncode == 0 for p in procs)
    r0 = pop(workdir, "mesh_rank0.pt")
    got = against_jax(r0, {"metrics": m, "state": state, "lr": float(schedule(0))}, model, spec["state_dict"])
    for f in workdir.iterdir():
        f.unlink()
    workdir.rmdir()
    assert got["loss_rel"] <= 1e-5 and got["buffer_diff"] <= 1e-5, got
    assert got["num_targets"][0] == got["num_targets"][1], got
    for share, worst in (got["params"], got["ema"]):
        assert share <= 1e-3 and worst <= got["bound"], got


def _mesh_rank_main(workdir: str, rank: int) -> None:
    """A rank of the slow case: one step of its band at grid (1, 2)."""
    from rtm3d_tpu_torch.parallel import dist

    torch.set_num_threads(2)
    spec = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)["cases"]["mesh"]
    dist.init_distributed("cpu", init_method=f"file://{workdir}/store", rank=rank, world_size=2, timeout=60)
    try:
        dist.init_mesh(1, 2)
        run = train_run(spec["state_dict"], spec["cfg"], spec["batches"], rank == 0)
        torch.save(run, os.path.join(workdir, f"mesh_rank{rank}.pt"))
    finally:
        dist.shutdown()


if __name__ == "__main__":
    if sys.argv[3] == "mesh":
        _mesh_rank_main(sys.argv[1], int(sys.argv[2]))
    else:
        _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
