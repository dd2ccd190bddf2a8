"""Captions completed (on the host) over the whole window (host clock)."""


def read(run):
    return run.items / run.window_s if run.unit_items == "captions" else None
