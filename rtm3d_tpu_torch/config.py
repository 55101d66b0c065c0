"""Configuration tree for rtm3d_tpu_torch.

The port's own copy of ``rtm3d_tpu/config.py`` (the port imports nothing of
the JAX package): the same ``Config`` class, the same default tree and the
same ``load_config``, so ``configs/*.yaml`` load unchanged, ``TPU:`` section
included. The port reads ``TPU.COMPUTE_DTYPE`` as its compute dtype; it adds
no keys of its own.

A small, dependency-free replacement for fvcore's ``CfgNode`` (the reference
configures itself via ``CONFIGS.clone() + merge_from_file(yaml)``, reference:
models/configs/detault.py:1-88, train.py:36-40). Keys mirror the reference's
default tree one-for-one so the reference's YAML files load unchanged.
``yaml`` is imported only when a file is read.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Mapping


class Config(dict):
    """Nested attribute-accessible dict with clone/merge semantics."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def clone(self) -> "Config":
        return copy.deepcopy(self)

    def merge(self, other: Mapping[str, Any]) -> "Config":
        """Recursively merge ``other`` into self (in place). Returns self."""
        for k, v in other.items():
            if isinstance(v, Mapping) and isinstance(self.get(k), dict):
                Config.merge(self[k], v)  # type: ignore[arg-type]
            else:
                self[k] = _wrap(v)
        return self

    def merge_from_file(self, path: str) -> "Config":
        import yaml

        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        return self.merge(_coerce_tuples(loaded))

    def merge_from_list(self, opts: list) -> "Config":
        """Merge dotted key/value pairs, e.g. ["SOLVER.BASE_LR", "0.001"]."""
        assert len(opts) % 2 == 0, "override list must be key value pairs"
        for key, value in zip(opts[::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, Config())
            if isinstance(value, str):
                try:
                    value = ast.literal_eval(value)
                except (ValueError, SyntaxError):
                    pass
            node[parts[-1]] = value
        return self


def _wrap(v: Any) -> Any:
    if isinstance(v, Mapping) and not isinstance(v, Config):
        c = Config()
        for k, vv in v.items():
            c[k] = _wrap(vv)
        return c
    return v


def _coerce_tuples(obj: Any) -> Any:
    """The reference's YAMLs write tuples as strings, e.g. ``(1280, 1280)``
    (models/configs/rtm3d_dla34_kitti.yaml:1). Coerce them to real tuples."""
    if isinstance(obj, Mapping):
        return {k: _coerce_tuples(v) for k, v in obj.items()}
    if isinstance(obj, str) and obj.startswith("(") and obj.endswith(")"):
        try:
            return ast.literal_eval(obj)
        except (ValueError, SyntaxError):
            return obj
    return obj


def default_config() -> Config:
    """Defaults mirroring the reference tree (models/configs/detault.py:3-88),
    with a `TPU` section that is new in this framework."""
    c = Config()
    c.INPUT_SIZE = (640, 640)
    c.IS_RECT = True
    c.IS_MOSAIC = False
    c.BATCH_SIZE = 32
    c.DEVICE = "tpu"
    c.num_workers = 0

    c.TRAINING = Config(
        LOGDIR="./logdirs/",
        WEIGHTS="./weights/",
        CHECKPOINT_MODE="RESUME",  # ['pretrained', 'resume', 'start']
        CHECKPOINT_FILE="",
        W_MKF=1.0,
        W_VKF=1.0,
        W_VFM=1.0,
        W_M_OFF=0.5,
        W_V_OFF=0.5,
        EMA=False,          # ModelEMA parity (module.py:71-119; dead in reference)
        EMA_DECAY=0.9999,
        # orbax directory-per-step checkpoints: multi-host/sharded-state
        # aware (every process writes its shards collectively); the default
        # msgpack format keeps the reference's one-file-per-save layout
        # (check_point.py:130-134) and requires replicated state
        USE_ORBAX=False,
    )

    c.DATASET = Config(
        PATH="./datasets/data/kitti",
        OBJs=["Car", "Pedestrian", "Cyclist"],
        RELATE_OBJs=[["Van", "Truck"], ["Person_sitting"], ["Person_sitting"]],
        MEAN=[0.485, 0.456, 0.406],
        STD=[0.229, 0.224, 0.225],
        BBOX_AREA_MAX=0.2598311523503046,
        BBOX_AREA_MIN=0.0002022788461538487,
        GAUSSIAN_SIGMA_MAX=19,
        GAUSSIAN_SIGMA_MIN=3,
        VERTEX_OFFSET_INFER=[0.75, 0.57],
        GAUSSIAN_GEN_TYPE="dynamic_radius",  # or 'dynamic_sigma'
        # fused single-resample native C++ preprocessing (True|False).
        # Measured SLOWER than the sequential cv2 path on this host (74 vs
        # 43 ms/img at KITTI scale: cv2's fixed-point SIMD beats the scalar
        # fused loop) — kept as an option for cv2-free deployments; the
        # TPU-native answer is the device-side matmul warp (TPU.DEVICE_WARP).
        FAST_PREPROC=False,
        # fixed-shape cap: max objects per image after related-class expansion
        MAX_OBJS=64,
        # decode every image once into RAM at dataset construction (KITTI
        # train fits in ~5 GB); removes PNG decode from the per-step host
        # path and, with forked loader workers, is shared copy-on-write
        CACHE_IMAGES=False,
        aug_hsv_h=0.014,
        aug_hsv_s=0.68,
        aug_hsv_v=0.36,
        aug_degrees=0.0,
        aug_translate=0.0,
        aug_scale=0.5,
        aug_shear=0.0,
    )

    c.SOLVER = Config(
        OPTIM_TYPE="adamax",  # the reference hard-codes Adamax (OptimizerBuilder.py:34-36)
        LR_SCHEDULER_NAME="WarmupMultiStepLR",
        MAX_EPOCH=1000,
        BASE_LR=0.01,
        MOMENTUM=0.937,
        WEIGHT_DECAY=0.0005,
        WEIGHT_DECAY_NORM=0.0,
        GAMMA=0.1,
        STEPS=(20000, 50000),
        WARMUP_FACTOR=1.0 / 1000,
        WARMUP_ITERS=1000,
        WARMUP_METHOD="linear",
        EXCLUDE_SCOPE=(),
        INCLUDE_SCOPE=(),
        LOAD_SOLVER=True,
        BIAS_LR_FACTOR=1.0,
        WEIGHT_DECAY_BIAS=0.0005,
        ACCUMULATE_STEPS=1,  # gradient accumulation (reference solver.py:65, dead)
        # Adamax's fixed decoupled weight decay in the reference
        # (OptimizerBuilder.py:34-36: Adamax(lr, weight_decay=1e-4) -> L2)
        ADAMAX_WEIGHT_DECAY=1e-4,
    )

    c.MODEL = Config(
        BACKBONE="DLA-34",
        DOWN_SAMPLE=4.0,
        OUT_CHANNELS=256,
        KFNs=["level2", "level3", "level4", "level5"],
        FOCAL_LOSS_ALPHA=2.0,
        FOCAL_LOSS_BEDA=4.0,
        SMOOTH_L1_LOSS_BETA=0.1,
        HEADER_NUM_CONV=2,
    )

    c.DETECTOR = Config(
        CHECKPOINT="",
        SCORE_THRESH=0.5,
        TOPK_CANDIDATES=30,
        NMS_THRESH_TEST=0.5,
        dim_ref=[
            [1.52607842, 1.62858147, 3.88396124],  # h, w, l  (Car)
            [1.76067766, 0.6602296, 0.84220464],   # Pedestrian
            [1.73712792, 0.59677122, 1.76338868],  # Cyclist
        ],
        REF_LOC=[0.0, -0.5, 20.0],  # detect.py:74 initial location guess
        SOLVER_ITERS=40,            # LM iterations for 3D recovery
        RESIDUAL_THRESH=0.1,        # accept solutions with residual < 0.1
        # dimension-prior term weight in the 3D objective. The reference's
        # aimFun omits it, leaving an exact scale gauge (depth drifts to the
        # init); the RTM3D paper's energy includes the prior. 0 = exact
        # reference behaviour.
        DIM_PRIOR_WEIGHT=20.0,
    )

    # --- TPU-native section (no reference counterpart) ---
    c.TPU = Config(
        MESH_AXES=("data",),      # device mesh axis names
        MESH_SHAPE=(-1,),         # -1: all available devices on that axis
        COMPUTE_DTYPE="float32",  # 'bfloat16' for MXU-friendly training
        PARAM_DTYPE="float32",
        NORMALIZE_ON_DEVICE=True,  # loader ships uint8; step normalises on TPU
        REMAT=False,              # jax.checkpoint the backbone to save HBM
        # exact space-to-depth reparameterisation of DLA's stem/level0/level1
        # (low-channel full-res convs underfill the MXU; see layers.py)
        S2D_STEM=True,
        # s2d block size: 0 = auto (largest of 4/2 dividing the input);
        # 2/4 force a block for A/B measurement (kernel-FLOP inflation is
        # b^2 for the stride-1 stem convs, lane fill is b^2*channels)
        S2D_BLOCK=0,
        DONATE=True,              # donate train-state buffers across steps
        # device-resident dataset (requires DEVICE_WARP): raw uint8 frames
        # live in HBM after a one-time transfer; each step gathers its batch
        # on device and the host ships only labels + affine scalars
        # (~100 KB/step instead of ~22 MB/step). KITTI train is ~5.2 GB —
        # fits v5e HBM alongside bf16 training state.
        DEVICE_DATA_CACHE=False,
        # int8 serving: conv path-suffixes kept in float. The header output
        # convs ("head") are <0.5% of FLOPs but carry the heatmap logits and
        # the vertex regression whose quantization error the 3D solver's
        # residual<0.1 gate amplifies (r5 sweep on a trained checkpoint,
        # docs/experiments/int8_calib_sweep_r5.json: full-int8 accepts
        # 10/107 under absmax, 29/107 under MSE clips; float-head lifts
        # those to 25 and 41 — int8 3D stays below the serving bar, which
        # is why serving defaults to 2D-only where this policy governs
        # quality/FLOPs, not 3D acceptance). Empty tuple = quantize
        # everything (round-2 behaviour).
        INT8_SKIP=("/head",),
    )
    return c


def load_config(yaml_path: str | None = None, overrides: list | None = None) -> Config:
    cfg = default_config()
    if yaml_path:
        cfg.merge_from_file(yaml_path)
    if overrides:
        cfg.merge_from_list(list(overrides))
    return cfg
