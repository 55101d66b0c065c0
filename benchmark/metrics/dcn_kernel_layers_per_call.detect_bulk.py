"""The program's ``dcn_kernel`` counter over the traced slice's calls: the
deformable conv layers a call that ran the hand-written kernel (26 for
ResNet-101-DCN; 0 means the timed path composed them). None for a program
without deformable convs."""

from benchmark.spans import per_call


def read(rec):
    try:
        import rtm3d_tpu_torch.nn.dcn  # noqa: F401  (the program that counts it)
    except ImportError:
        return None
    return per_call(rec, "dcn_kernel")
