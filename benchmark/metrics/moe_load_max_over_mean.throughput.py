"""Expert balance: the program's counter of routed tokens per (MoE layer,
expert), summed on the device over the measured window and read once
after it; the largest expert load over the mean load, in the worst
layer (1 is even)."""


def read(run):
    v = run.records.spans.get("moe_load_max_over_mean")
    return v[0] if v else None
