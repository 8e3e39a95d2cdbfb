"""MoonViT and the projector: device ms of the kernels launched inside
each ``rtvc.vlm.vision`` range (a batch's frames), the mean over the
ranges of the profiled slice."""

from benchlib.vlm_readers import ms_per_range


def read(run):
    return ms_per_range(run, "rtvc.vlm.vision")
