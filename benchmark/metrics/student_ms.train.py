"""CUDA-event ms a step of the train step's student part, between the
program's ``mark`` points, averaged over the steps of the measured
window of a traced run."""

from benchlib.readers import span_mean


def read(run):
    return span_mean(run, "student_ms")
