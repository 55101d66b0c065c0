"""The plain reference: float32 PyTorch, TF32 off, no kernel of the program.

Written from the reference repository's modules (hitfeelee/rtm3d) and the
port's plain versions, frozen here so that no later change to the program
moves it. It imports nothing of ``rtm3d_tpu_torch``, ``rtm3d_tpu`` or JAX,
and takes nothing the program made: the benchmark hands both sides the same
seeded weights, frames and labels.
"""
