"""rtm3d_tpu_torch — the PyTorch/CUDA port of rtm3d_tpu for NVIDIA Hopper.

The JAX package ``rtm3d_tpu`` stays the reference; this package sits beside
it, keeps its module names (``nn/dla.py``, ``decode/solve3d.py``, ...) and
imports nothing of it. Plain tensor work is PyTorch; the one TPU kernel on
the detect path, the Levenberg-Marquardt 3D solver, is a hand-written CUDA
kernel for ``sm_90a`` (``csrc/lm_solver.cu``), built at first use.

Entry points (``api.Detector``, ``train.step.make_detect_step``) run on
``cuda`` unless the caller passes ``device="cpu"``; with no GPU and no
explicit device they raise instead of falling back to the CPU.
"""

__version__ = "0.1.0"

from rtm3d_tpu_torch.config import Config, default_config, load_config  # noqa: F401
