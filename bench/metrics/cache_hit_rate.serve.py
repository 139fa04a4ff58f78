"""Share of the measured interval's prefix-cache probes that hit, from the
serve runtime's ``cache_hits`` and ``cache_misses`` counters, in %."""


def read(run):
    if run.kind != "serve":
        return None
    hits = run.counters.get("cache_hits", 0)
    misses = run.counters.get("cache_misses", 0)
    return None if hits + misses == 0 else 100.0 * hits / (hits + misses)
