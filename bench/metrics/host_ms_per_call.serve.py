"""Host milliseconds the engine's stages take to dispatch one model call:
the runtime's ``server_scan`` and ``client_scan`` spans of the waves in
the measured interval, over those waves' model calls.  A launch that
waits for room in the device's queue waits inside a span, so where the
device is the slower side this reads the device's pace."""


def read(run):
    if run.kind != "serve" or not run.spans or run.calls <= 0:
        return None
    host = sum(t1 - t0 for name, t0, t1 in run.spans
               if name in ("server_scan", "client_scan") and t1 >= t0)
    return 1e3 * host / run.calls
