"""rtm3d_tpu_torch — the PyTorch/CUDA port of rtm3d_tpu for NVIDIA Hopper.

The JAX package ``rtm3d_tpu`` stays the reference; this package sits beside
it, keeps its module names (``nn/dla.py``, ``decode/solve3d.py``, ...) and
imports nothing of it. Plain tensor work is PyTorch; each TPU kernel of the
JAX package is a hand-written CUDA kernel for ``sm_90a``, built at first
use: the Levenberg-Marquardt 3D solver on the detect path
(``csrc/lm_solver.cu``) and the heatmap target splat on the training path
(``csrc/splat.cu``). The int8 serving path (``nn/quant.py``) adds two
hand-written kernels that replace no TPU kernel, the activation quantize
and the int8 convolution (``csrc/int8_conv.cu``).

Entry points (``api.Detector``, ``train.step.make_detect_step``,
``make_train_step``, ``make_eval_loss_step``, ``train.state.TrainState``)
run on ``cuda`` unless the caller passes ``device="cpu"``; with no GPU and
no explicit device they raise instead of falling back to the CPU.
"""

__version__ = "0.1.0"

from rtm3d_tpu_torch.config import Config, default_config, load_config  # noqa: F401
