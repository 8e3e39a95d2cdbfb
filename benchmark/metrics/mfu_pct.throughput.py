"""Model FLOPs of the work completed in the measured window (the
benchmark's count from the configuration's widths) over the window's
seconds times the card's bf16 peak, 989 TFLOP/s."""

from benchlib.readers import mfu_pct


def read(run):
    return mfu_pct(run)
