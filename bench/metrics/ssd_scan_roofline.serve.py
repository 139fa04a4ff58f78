"""The SSD-scan kernel's share of its roofline in the traced slice: each
forward launch's least time (``cost.ssd_cost`` at the traced calls'
mean rows × tokens × SSM heads × head dim, state size n, one chunk of
the tokens: bytes at the HBM rate or FLOPs at the dtype's peak) over the
kernel's device time, in %.  Reads only where the configuration has an SSM state
(the DiT family)."""
from bench import cost


def read(run):
    cfg = getattr(run, "config", {})
    rows = getattr(run, "slice_rows", None)
    if run.kind != "serve" or run.trace is None or not rows or \
            "ssm_state" not in cfg:
        return None
    launches = run.trace.count("ssd_")
    seconds = run.trace.device_s("ssd_")
    if launches == 0 or seconds <= 0:
        return None
    tokens = (cfg["image_size"] // cfg["patch_size"]) ** 2
    heads = cfg["ssm_expand"] * cfg["d_model"] // cfg["ssm_head_dim"]
    b = sum(rows) / len(rows)
    nbytes, flops = cost.ssd_cost(
        (b, tokens, heads, cfg["ssm_head_dim"]), cfg["ssm_state"],
        min(cfg["ssm_chunk"], tokens), 2)
    per = cost.bound_s(nbytes, flops, cost.PEAK_FLOPS[cfg["dtype"]])
    return 100.0 * launches * per / seconds
