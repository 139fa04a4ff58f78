"""The serving step's share of the card's peak: the model calls that
finished in the measured interval (each timed by the benchmark's event
after it) times the model's FLOPs a call (counted in set-up with
``FlopCounterMode`` at the request's batch) plus the DDPM-step kernel's
float operations for the call's images, over the interval's seconds and
the published peak of the configuration's dtype, in %."""
from bench import cost


def read(run):
    if run.kind != "serve" or run.interval_s <= 0 or run.calls <= 0:
        return None
    flops = run.calls * (run.flops_per_call +
                         run.images * run.pixels * cost.DRAW_FLOAT_OPS)
    return cost.share_pct(flops, run.interval_s, cost.PEAK_FLOPS[run.dtype])
