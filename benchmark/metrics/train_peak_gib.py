"""``torch.cuda.max_memory_allocated()`` over the whole run, set-up
included, read before the output check allocates anything, in GiB."""


def read(rec):
    return rec["peak_allocated"] / 2 ** 30 if rec["kind"] == "train" else None
