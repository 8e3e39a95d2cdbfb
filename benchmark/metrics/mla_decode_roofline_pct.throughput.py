"""One layer's absorbed latent attention at one position: Σ bound ÷ Σ
device time over the ``rtvc.vlm.mla_decode`` ranges of the profiled
slice (each an eager body or a replayed graph). A range's bound is the
larger of its bytes over 3.35 TB/s (the latent cache ``[B, T, 576]``
bf16, the four projections' weights, the rows in and out) and its
operations over 989 TFLOP/s; B is the served batch's bucket, T the
cache's slots (prompt + new tokens: every slot is read, those past the
position masked)."""

from benchlib.readers import roofline_pct
from benchlib.vlm_readers import mla_decode_pairs


def read(run):
    return roofline_pct(mla_decode_pairs(run))
