"""Images whose outputs reached the host inside the window, over the
window's seconds (host clock, from before the first call to the return of
the last)."""


def read(rec):
    return rec["images"] / rec["window_s"] if rec["kind"] == "detect" else None
