"""ms a decoded token: the program's caption step at the cell's batch
(CUDA events) less its encode, over the decode iterations it ran."""

from benchlib.readers import per_token_ms


def read(run):
    return per_token_ms(run)
