"""Host ms a batch spends on the server's scheduler thread in series with
the caption step: the mean over the slice's ``rtvc.serve.batch`` ranges of
their ``rtvc.serve.assemble``, ``rtvc.serve.place`` and
``rtvc.serve.resolve`` children (the program's spans)."""

from benchlib.spans import mean_children_ms

PARTS = ("rtvc.serve.assemble", "rtvc.serve.place", "rtvc.serve.resolve")


def read(run):
    return mean_children_ms(run, "rtvc.serve.batch", PARTS)
