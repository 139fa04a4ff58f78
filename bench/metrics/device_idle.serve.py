"""Share of the traced slice's device span (the first activity's start
to the last one's end, on the device's clock) in which nothing ran on
the device (profiler), in %."""


def read(run):
    if run.kind != "serve" or run.trace is None or run.trace.span_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.span_s)
