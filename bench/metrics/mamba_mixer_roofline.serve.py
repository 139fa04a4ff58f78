"""The Mamba2 mixer's fused glue kernels' share of their roofline in the
traced slice: each launch's least time at the traced calls' mean rows ×
tokens (bytes, each input read once and each output written once, at the
HBM rate, or its float32 operations at the float32 peak, whichever is
longer) over the kernels' device time, in %.  Three kernels, told apart
by name, all carrying the prefix ``mamba_`` that no other kernel has:
``mamba_conv_silu`` (x and B/C through the causal conv, the bias and
SiLU), ``mamba_rmsnorm_kernel`` (the input norm over d_model) and
``mamba_rmsnorm_gated`` (the D skip, the gate and the output norm over
d_inner).  Reads only where such launches were traced: not in the U-Net
cells, nor where a DiT ran its mixers eagerly."""
from bench import cost

PREFIX = "mamba_"


def _least_s(cfg, rows):
    """{kernel name: least seconds of one launch over ``rows`` tokens}."""
    d = cfg["d_model"]
    di = cfg["ssm_expand"] * d
    heads = di // cfg["ssm_head_dim"]
    k = cfg["ssm_conv_kernel"]
    ch = di + 2 * cfg["ssm_state"]
    item = 2 if cfg["dtype"] in ("bfloat16", "float16") else 4
    work = {"mamba_conv_silu": ((2 * rows * ch + (k + 1) * ch) * item,
                                rows * ch * (2 * k + 4)),
            "mamba_rmsnorm_kernel": ((2 * rows * d + d) * item,
                                     rows * (4 * d + 3)),
            "mamba_rmsnorm_gated": ((4 * rows * di + di) * item + 4 * heads,
                                    rows * (10 * di + 3))}
    return {name: cost.bound_s(nbytes, flops, cost.FP32_FLOPS_PER_S)
            for name, (nbytes, flops) in work.items()}


def read(run):
    cfg = getattr(run, "config", {})
    rows = getattr(run, "slice_rows", None)
    if run.kind != "serve" or run.trace is None or not rows or \
            "ssm_state" not in cfg:
        return None
    seconds = run.trace.device_s(PREFIX)
    if run.trace.count(PREFIX) == 0 or seconds <= 0:
        return None
    tokens = (cfg["image_size"] // cfg["patch_size"]) ** 2
    b = sum(rows) / len(rows)
    least = sum(run.trace.count(name) * per
                for name, per in _least_s(cfg, b * tokens).items())
    return 100.0 * least / seconds
