"""The traced slice's device idle, split by what the host was doing when
each gap began: inside one of the program's ``repro.model_call`` ranges
(the engine's span around a denoiser call, which the program's tracer
holds open in the profiler), or outside all of them (the step's glue,
the runtime's plan, probe and retire, the benchmark's poll and submit).

The gaps are rebuilt from ``trace.kernels`` as ``TraceSummary`` merges
them, so the two parts sum to ``span_s − busy_s``.  A trace with no
device activity, or with no ``repro.model_call`` range (a program
without the engine's spans), splits nothing: ``split_ms`` returns None.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

MODEL_CALL = "repro.model_call"


def device_gaps(kernels) -> List[Tuple[int, int]]:
    """(start, end) of each interval with nothing on the device, between
    the first activity's start and the last one's end (ns)."""
    gaps, end = [], None
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def _union(ranges) -> Tuple[List[int], List[int]]:
    starts, ends = [], []
    for s, e in sorted(ranges):
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return starts, ends


def split_ms(run) -> Optional[Tuple[float, float]]:
    """(idle ms inside model calls, idle ms outside them), each over the
    slice's traced calls; None where there is nothing to split."""
    if run.kind != "serve" or run.trace is None or not run.slice_rows \
            or run.trace.span_s <= 0:
        return None
    starts, ends = _union((s, e) for name, s, e in run.trace._cpu
                          if name == MODEL_CALL)
    if not starts:
        return None
    inside = outside = 0
    for g0, g1 in device_gaps(run.trace.kernels):
        i = bisect.bisect_right(starts, g0) - 1
        if i >= 0 and g0 < ends[i]:
            inside += g1 - g0
        else:
            outside += g1 - g0
    calls = len(run.slice_rows)
    return inside / 1e6 / calls, outside / 1e6 / calls
