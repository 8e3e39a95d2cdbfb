"""K4, the flash attention of the teacher's joint decoder (one launch a
layer at [B, heads, prefix + caption, D], prefix-causal): Σ bound ÷ Σ
device time over its launches in the profiled slice. Its launches are the
kernels named below that were launched inside the teacher's textual head
(a ``bench::teacher.textual`` range that ``drivers/train_step.py`` puts
around it); the bound of each is the larger of its bytes over 3.35 TB/s
and its operations over 989 TFLOP/s, from the configuration's shapes."""

from benchlib.readers import roofline_pct
from benchlib.work import flash_work

RANGE = "bench::teacher.textual"
# csrc/flash_attention_sm90.cu (bf16, and its input-dtype softmax) and
# csrc/flash_attention.cu (float32)
SYMBOLS = ("attention_sm90_kernel", "attention_native_sm90_kernel",
           "attention_kernel")


def read(run):
    t = run.trace_data
    if t is None:
        return None
    cfg = run.config
    te = cfg["teacher"]
    grid = te["clip"]["image_size"] // te["clip"]["patch_size"]
    prefix = te["num_image_with_embedding"] * (grid * grid + 1)
    length = prefix + cfg["train"]["caption_len"]
    heads = te["attention_heads"]
    nbytes, flops = flash_work(cfg["train"]["batch_size"], heads, length,
                               te["hidden_size"] // heads, prefix)
    pairs = [(nbytes, flops, float(k["dur"]) * 1e-6)
             for k in t.in_slice()
             if k.get("cat") == "kernel"
             and any(s in k.get("name", "") for s in SYMBOLS)
             and t.launched_within(k, RANGE) is not None]
    return roofline_pct(pairs)
