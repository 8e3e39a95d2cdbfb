"""Process start until the measured window opens: imports, the kernels'
build or load, the models and their weights, warm-up (and for the train
step its first three steps)."""


def read(run):
    return run.setup_s
