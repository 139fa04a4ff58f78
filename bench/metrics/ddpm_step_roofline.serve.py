"""The rowwise DDPM-step kernel's share of its roofline in the traced
slice: the least time of the rows it stepped (``cost.rowwise_launch_
bound_s``: bytes at the HBM rate, or the draw's integer and float
operations in the integer slots) over the kernel's device time, in %.

The rows are the traced model calls' own: each call denoises one slab
(a scanned group or request) and the step's launch follows the step's
calls, so every traced call but the last, whose launch falls after the
slice, adds its slab: exactly where a step holds one slab, to within a
step's slabs at the slice's edges where it holds more.  A slab that a
launch passes without stepping (masked) is not counted, so the share
reads low rather than high."""
from bench import cost

NAME = "ddpm_step_rowwise"


def read(run):
    rows = getattr(run, "slice_rows", None)
    if run.kind != "serve" or run.trace is None or not rows:
        return None
    seconds = run.trace.device_s(NAME)
    if run.trace.count(NAME) == 0 or seconds <= 0:
        return None
    least = sum(cost.rowwise_launch_bound_s(1, r * run.pixels, r)
                for r in rows[:-1])
    return 100.0 * least / seconds
