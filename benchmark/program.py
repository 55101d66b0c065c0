"""The system under test, as the benchmark builds it: ``rtm3d_tpu_torch``.

The port's configuration is made from the configuration file's
``config`` block over the port's defaults; its network is built on the meta
device and takes the benchmark's seeded state dict, so no weight is drawn
twice or on the host. Nothing here imports JAX or the JAX package.
"""

import torch

from rtm3d_tpu_torch.api import Detector
from rtm3d_tpu_torch.config import default_config
from rtm3d_tpu_torch.nn.model import RTM3D
from rtm3d_tpu_torch.train.state import TrainState
from rtm3d_tpu_torch.train.step import make_train_step

__all__ = ["Detector", "TrainState", "make_train_step", "port_config", "port_model"]


def port_config(conf: dict):
    cfg = default_config().merge(conf["config"])
    cfg.INPUT_SIZE = tuple(cfg.INPUT_SIZE)
    cfg.SOLVER.STEPS = tuple(cfg.SOLVER.STEPS)
    return cfg


def port_model(cfg, state_dict: dict, device) -> torch.nn.Module:
    with torch.device("meta"):
        net = RTM3D(backbone_name=cfg.MODEL.BACKBONE, kfns=tuple(cfg.MODEL.KFNs),
                    num_classes=len(cfg.DATASET.OBJs), out_channels=cfg.MODEL.OUT_CHANNELS,
                    header_num_conv=cfg.MODEL.HEADER_NUM_CONV)
    net = net.to_empty(device=device)
    net.load_state_dict(state_dict, strict=True)
    return net
