"""CUDA-event ms of clip_preprocess + the student's forward_image_enc at
the cell's batch (the copy of the smoke script's part_times), after the
measured traffic of a traced run."""

from benchlib.readers import span_mean


def read(run):
    return span_mean(run, "encode_ms")
