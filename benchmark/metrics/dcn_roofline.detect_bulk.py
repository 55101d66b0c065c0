"""The deformable convs' counted operations in the traced slice
(``benchmark/dcn_work.py``, from the reference network) at the bf16
tensor-core peak (989 TFLOP/s) over the device seconds the trace gives the
DCN kernel (``csrc/dcn.cu``'s ``dcn_forward_kernel``), in percent. None
where the kernel is not among the slice's ten largest device operations, or
no cell is named on the command line."""

from benchmark import dcn_work


def read(rec):
    return dcn_work.roofline_pct(rec, dcn_work.cell_conf())
