"""Device idle milliseconds a traced call whose gap began while the host
was outside every model call: the engine step's glue (stacking, the DDPM
launch), the runtime's plan, probe and retire, and the benchmark's poll
and submit.  With ``model_call_idle_ms.serve`` it splits
``device_idle.serve``'s idle time; read from the profiled slice."""
from bench import idle_split


def read(run):
    split = idle_split.split_ms(run)
    return None if split is None else split[1]
