"""Rates over whole units of work.

A serving run keeps marks: (seconds since the window opened, requests
finished by then), each taken where a wave of known requests has just
finished.  ``whole_cycles`` picks the first mark and the last one whose
distance in requests is a whole number of the mix's cycles (each client's
share of the traffic once), so the work counted is the mix's own and no
lump is cut at the window's edge.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple


def whole_cycles(marks: Sequence[Tuple[float, int]], cycle: int,
                 window_s: float, first: int = 0
                 ) -> Optional[Tuple[int, int]]:
    """(index a, index b) of two marks: a = ``first``, b the last mark
    inside the window such that the requests between them are a whole,
    positive number of cycles; None where no such mark exists."""
    if first >= len(marks):
        return None
    _, n_a = marks[first]
    best = None
    for b in range(first + 1, len(marks)):
        t_b, n_b = marks[b]
        if t_b > window_s:
            break
        if n_b > n_a and (n_b - n_a) % cycle == 0:
            best = b
    return None if best is None else (first, best)


def rate(marks: Sequence[Tuple[float, int]], a: int, b: int) -> float:
    """Requests a second between marks a and b."""
    (t_a, n_a), (t_b, n_b) = marks[a], marks[b]
    return (n_b - n_a) / (t_b - t_a)

