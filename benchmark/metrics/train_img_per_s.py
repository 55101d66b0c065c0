"""Images stepped over the window's seconds; the window ends in a
synchronise of the device."""


def read(rec):
    return rec["images"] / rec["window_s"] if rec["kind"] == "train" else None
