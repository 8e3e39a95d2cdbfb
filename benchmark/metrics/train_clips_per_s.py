"""Clips (a 6-frame window with its caption) of the train steps launched
in the window, over the seconds until the card finished them."""


def read(run):
    r = run.records
    return r.clips / r.window_s if r.window_s else None
