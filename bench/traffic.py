"""The one generator of the benchmark's traffic: a mix file of parameters
(``bench/traffic/<mix>.json``) read into a seeded stream of requests.

A serving mix names its clients' cuts as fractions of the configuration's
T, the images a request holds, and how labels are drawn:

* ``client_class``: each client asks for one attribute class, drawn from
  the seed without repeats, the same for every image it requests (the
  paper's non-IID clients: their server prefixes repeat);
* ``bits``: each image's attributes are independent draws with
  probability ``p_attr`` (CelebA's binary attributes: no two requests
  share a prefix);
* ``zipf``: one class a request, ranked by p(rank) ∝ 1/(rank+1)^a.

Each client draws from a stream of its own, so the n-th request of a
client is the same whatever the timing of the run.  Warm-up requests come
from a stream of their own too.  ``zipf_probs`` and the per-request draw
of ``zipf`` follow the program's ``launch/collab_serve.synth_queue``, of
which this is the benchmark's own copy.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np

WARMUP_STREAM = 1 << 20


class Request(NamedTuple):
    client: int
    t_cut: int
    y: np.ndarray          # (images, n_classes) float32


def zipf_probs(n_classes: int, a: float) -> np.ndarray:
    """p(rank) ∝ 1/(rank+1)^a; a = 0 is uniform."""
    p = 1.0 / np.arange(1, n_classes + 1, dtype=np.float64) ** a
    return p / p.sum()


def cuts(mix: Dict, T: int) -> List[int]:
    """Each client's cut t_ζ: its fraction of T, floored, at least 1."""
    return [max(1, int(math.floor(f * T))) for f in mix["cut_fractions"]]


class Stream:
    """The requests of a serving mix for one seed."""

    def __init__(self, mix: Dict, n_classes: int, T: int, seed: int):
        self.mix, self.n_classes = mix, n_classes
        self.cuts = cuts(mix, T)
        self.seed = int(seed)
        self.classes = np.random.default_rng(
            [self.seed, 0]).permutation(n_classes)
        self._rng: Dict[int, np.random.Generator] = {}

    def _stream(self, sid: int) -> np.random.Generator:
        if sid not in self._rng:
            self._rng[sid] = np.random.default_rng([self.seed, 1, sid])
        return self._rng[sid]

    def _labels(self, client: int, rng: np.random.Generator) -> np.ndarray:
        mode, n, k = self.mix["labels"], self.mix["images"], self.n_classes
        eye = np.eye(k, dtype=np.float32)
        if mode == "client_class":
            label = int(self.classes[client % k])
        elif mode == "zipf":
            label = int(rng.choice(k, p=zipf_probs(k, self.mix["zipf_a"])))
        elif mode == "bits":
            return (rng.random((n, k)) < self.mix["p_attr"]).astype(
                np.float32)
        else:
            raise ValueError(f"unknown label mode {mode!r}")
        return np.broadcast_to(eye[label], (n, k)).copy()

    def next(self, client: int) -> Request:
        y = self._labels(client, self._stream(client))
        return Request(client, self.cuts[client], y)

    def warmup(self) -> List[Request]:
        """``warmup`` in the mix: ``one_per_client`` or ``one``."""
        rng = self._stream(WARMUP_STREAM)
        who = range(len(self.cuts)) if self.mix["warmup"] == \
            "one_per_client" else [0]
        return [Request(c, self.cuts[c], self._labels(c, rng)) for c in who]
