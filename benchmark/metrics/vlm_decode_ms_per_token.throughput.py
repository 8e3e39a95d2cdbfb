"""A decode step of the vision-language captioner: device ms of the
kernels launched inside each ``rtvc.decode.token`` range (one token of
every row, through the latent caches), the mean over the ranges of the
profiled slice."""

from benchlib.vlm_readers import ms_per_range


def read(run):
    return ms_per_range(run, "rtvc.decode.token")
