"""Seconds from the start of the process to the first timed call: imports,
the CUDA context, weights and inputs, building the program's kernels where
they are not built yet, and the warm-up calls."""


def read(rec):
    return rec["setup_s"]
