"""Device idle milliseconds a traced call whose gap began while the host
was inside a model call (the program's ``repro.model_call`` range): the
device ran out of work while the host was still issuing the denoiser's
ops, where fewer ops or CUDA graphs would close it.  Read from the
profiled slice, so it carries the profiler's own host cost."""
from bench import idle_split


def read(run):
    split = idle_split.split_ms(run)
    return None if split is None else split[0]
