"""The flash-attention kernel's share of its roofline in the traced slice:
each forward launch's least time (``cost.flash_cost`` at the traced
calls' mean rows × heads × tokens × head dim, bidirectional: bytes at
the HBM rate or FLOPs at the dtype's peak) over the kernel's device
time, in %.  Reads only where the configuration has attention heads (the
DiT family)."""
from bench import cost


def read(run):
    cfg = getattr(run, "config", {})
    rows = getattr(run, "slice_rows", None)
    if run.kind != "serve" or run.trace is None or not rows or \
            "n_heads" not in cfg:
        return None
    launches = run.trace.count("flash_")
    seconds = run.trace.device_s("flash_")
    if launches == 0 or seconds <= 0:
        return None
    dh = cfg["head_dim"] or cfg["d_model"] // cfg["n_heads"]
    tokens = (cfg["image_size"] // cfg["patch_size"]) ** 2
    b = sum(rows) / len(rows)
    nbytes, flops = cost.flash_cost((b, cfg["n_heads"], tokens, dh),
                                    cfg["n_kv_heads"], 2)
    per = cost.bound_s(nbytes, flops, cost.PEAK_FLOPS[cfg["dtype"]])
    return 100.0 * launches * per / seconds
