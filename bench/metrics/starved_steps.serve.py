"""Share of the window's engine steps that the host opened after the
device had finished the previous step (the program's ``starved_steps``
over ``probed_steps`` counters, moved over the measured window), in %:
near 100 the device waits for the host, near 0 the host waits for the
device.  Most of the window lies outside the profiled slice, so the
profiler's host cost touches few of the steps."""


def read(run):
    if run.kind != "serve":
        return None
    probed = run.counters.get("probed_steps", 0)
    if probed <= 0:
        return None
    return 100.0 * run.counters.get("starved_steps", 0) / probed
