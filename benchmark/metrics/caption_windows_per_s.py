"""Captions resolved inside the window, over the window's seconds."""


def read(run):
    r = run.records
    return r.completed / r.window_s if r.window_s else None
