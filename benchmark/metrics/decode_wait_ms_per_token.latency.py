"""Host ms a decoded token waits on the read-back of its stop test: the
mean of the slice's ``rtvc.decode.stop_wait`` ranges (the program's
spans; one a token)."""

from benchlib.spans import mean_ms


def read(run):
    return mean_ms(run, "rtvc.decode.stop_wait")
