"""The routed experts in the prefill: Σ bound ÷ Σ device time over the
``rtvc.vlm.experts`` ranges inside ``rtvc.vlm.prefill`` in the profiled
slice. A range's bound is the larger of its grouped products' bytes over
3.35 TB/s and their operations over 989 TFLOP/s, from the operands'
shapes (every expert's weights read once: at thousands of tokens an
expert each is hit); its device time is every kernel it launched (the
gather, the activation and the weighted sum beside the products)."""

from benchlib.readers import roofline_pct
from benchlib.vlm_readers import moe_prefill_pairs


def read(run):
    return roofline_pct(moe_prefill_pairs(run))
