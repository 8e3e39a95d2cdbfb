"""The language model's pass over the prompt and the visual tokens:
device ms of the kernels launched inside each ``rtvc.vlm.prefill`` range
(a batch), the mean over the ranges of the profiled slice."""

from benchlib.vlm_readers import ms_per_range


def read(run):
    return ms_per_range(run, "rtvc.vlm.prefill")
