"""Real rows a batch of the server: the ``rtvc.serve.row`` ranges inside
the slice's ``rtvc.serve.batch`` ranges ÷ those batches (the program's
spans; a row is a request copied into the bucket, not padding)."""

from benchlib.spans import per_parent


def read(run):
    return per_parent(run, "rtvc.serve.row", "rtvc.serve.batch")
