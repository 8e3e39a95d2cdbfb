"""Host ms a decoded token takes to issue at batch 1: the mean over the
slice's ``rtvc.decode.token`` ranges of each one's duration less its
``rtvc.decode.stop_wait`` (the program's spans)."""

from benchlib.spans import mean_self_ms


def read(run):
    return mean_self_ms(run, "rtvc.decode.token", "rtvc.decode.stop_wait")
