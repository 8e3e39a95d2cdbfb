"""Host ms of the train step's backward: the mean of the slice's
``rtvc.train.backward`` ranges (the program's spans; the calling thread
from ``loss.backward()`` until the autograd engine has issued the
backward)."""

from benchlib.spans import mean_ms


def read(run):
    return mean_ms(run, "rtvc.train.backward")
