"""Host ms a train step spends on its dtype copies: the mean over the
slice's ``rtvc.train.step`` ranges of their ``rtvc.train.grad_cast``
(the float32 gradients) and ``rtvc.train.copy_back`` (the masters into
the bf16 compute copy) children (the program's spans)."""

from benchlib.spans import mean_children_ms

PARTS = ("rtvc.train.grad_cast", "rtvc.train.copy_back")


def read(run):
    return mean_children_ms(run, "rtvc.train.step", PARTS)
