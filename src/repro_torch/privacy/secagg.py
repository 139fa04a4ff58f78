"""Pairwise-masking secure-aggregation SIMULATION (Bonawitz et al. 2017,
the SecAgg construction) over the registry's permanent uids.

The port of the JAX package's ``privacy/secagg.py``.  SecAgg's defining
property is that the server learns ONLY the sum: each pair of cohort
members derives a shared mask, one adds it and the other subtracts it,
and the masks must cancel EXACTLY in the server's summation.  Float
addition is not associative, so the transport runs in an integer ring:
uploads are fixed-point quantized (round(x · 2^SCALE_BITS) as int64,
carried as uint64 so overflow wraps mod 2^64) and masks are uniform
uint64.  A masked upload is uniform on the ring; the mod-2^64 sum is
mask-free.  The ring arithmetic runs on the host in numpy uint64 (a
model's leaves come to the host once an upload); the mask words come
from ``prng.leafwise_bits``, the bits ``jax.random.bits`` draws, drawn
on the model's device in one pass over every leaf.

Consequences:

* the pipeline is the same with masking on or off — quantize → exact
  integer sum → dequantize — so ``secagg`` on/off is bitwise identical
  at the aggregate;
* mask agreement is keyed by (base key, TAG_SECAGG, round, uid pair)
  with per-leaf fold-ins: addressed, never chained;
* dropout recovery: a party that departs before uploading leaves its
  pair masks in the survivors' sum; the server rebuilds exactly those
  from the shared seeds and removes them, mod 2^64.

Quantization error is at most 2^-(SCALE_BITS+1) per element per member;
the quantizer saturates at ±2^62 / 2^SCALE_BITS (~4.4e12).  A tree's
leaves are taken in ``core/trees.leaves`` order (a dict by sorted key,
as ``jax.tree.leaves``; a module by ``named_parameters()``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core import prng, trees

# Stream tag for pairwise mask agreement (disjoint from participation's
# TAG_* block and dp.TAG_DP).
TAG_SECAGG = 0x5EA6

SCALE_BITS = 20                      # fixed-point scale 2^20
_SCALE = float(1 << SCALE_BITS)


def _host64(leaf) -> np.ndarray:
    """A leaf as a host float64 array (exact for float32 and bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().float().cpu().numpy()
    return np.asarray(leaf, np.float64)


def quantize(tree) -> List[np.ndarray]:
    """Leaf list of fixed-point uint64 encodings (two's complement via
    int64 -> uint64 view) — the SecAgg wire format."""
    out = []
    for l in trees.leaves(tree):
        v = _host64(l) * _SCALE
        # saturate at +/-2^62: exactly representable in float64, safely
        # inside int64, and ~4.4e12 in value units at the default scale
        v = np.clip(np.rint(v), -(2.0 ** 62), 2.0 ** 62)
        out.append(v.astype(np.int64).view(np.uint64))
    return out


def dequantize(leaves: Sequence[np.ndarray], template):
    """Back to a tree shaped like ``template``: each sum rescaled in
    float64 (exact for every in-range sum), rounded to float32, then to
    the template leaf's dtype and device."""
    vals = [torch.from_numpy(np.asarray(
        (q.view(np.int64).astype(np.float64) / _SCALE).astype(np.float32))
    ).to(device=t.device, dtype=t.dtype)
            for q, t in zip(leaves, trees.leaves(template))]
    return trees.unflatten(template, vals)


def _pair_key(base_key: torch.Tensor, round_idx: int, u: int, v: int):
    """The shared mask seed of pair {u, v} at ``round_idx`` — addressed
    by the SORTED uid pair, so both parties derive the same key."""
    lo, hi = (u, v) if u < v else (v, u)
    k = prng.fold_in(prng.fold_in(base_key, TAG_SECAGG), round_idx)
    return prng.fold_in(prng.fold_in(k, lo), hi)


def _mask_leaves(key: torch.Tensor, template) -> List[np.ndarray]:
    """A uniform uint64 mask per leaf: two uint32 words of
    ``random_bits(fold_in(key, i), (2,) + shape)`` glued on the host."""
    ls = trees.leaves(template)
    if not ls:
        return []
    dev = ls[0].device if isinstance(ls[0], torch.Tensor) else "cpu"
    bits = prng.leafwise_bits(key.to(dev),
                              [(2,) + tuple(l.shape) for l in ls])
    out = []
    for b in bits:
        w = b.cpu().numpy().astype(np.uint64)
        out.append((w[0] << np.uint64(32)) | w[1])
    return out


def mask_for(base_key, round_idx: int, uid: int, cohort: Sequence[int],
             template) -> List[np.ndarray]:
    """Member ``uid``'s total mask against ``cohort``: the mod-2^64 sum
    of +pair_mask for every partner with a larger uid and -pair_mask for
    every smaller one (the canonical SecAgg sign convention)."""
    leaves = [np.zeros(tuple(l.shape), np.uint64)
              for l in trees.leaves(template)]
    with np.errstate(over="ignore"):   # mod-2^64 wraparound is the point
        for v in cohort:
            v = int(v)
            if v == int(uid):
                continue
            pm = _mask_leaves(_pair_key(base_key, round_idx, int(uid), v),
                              template)
            for i, m in enumerate(pm):
                if int(uid) < v:
                    leaves[i] = leaves[i] + m      # uint64 wraps mod 2^64
                else:
                    leaves[i] = leaves[i] - m
    return leaves


def masked_upload(tree, base_key, round_idx: int, uid: int,
                  cohort: Sequence[int]) -> List[np.ndarray]:
    """What member ``uid`` SENDS: its quantized update plus its total
    cohort mask, mod 2^64."""
    q = quantize(tree)
    m = mask_for(base_key, round_idx, uid, cohort, tree)
    with np.errstate(over="ignore"):
        return [a + b for a, b in zip(q, m)]


def secagg_sum(uploads: Dict[int, object], cohort: Sequence[int], base_key,
               round_idx: int, masked: bool = True):
    """The server-side aggregate of ``uploads`` (uid -> float tree).

    ``cohort`` is the full mask-agreement party list; uids in ``cohort``
    missing from ``uploads`` are DROPPED parties and trigger recovery:
    their pair masks with every surviving uploader are rebuilt and removed
    from the sum.  ``masked=False`` runs the same quantize -> integer sum
    -> dequantize pipeline without masks: bitwise the same output."""
    if not uploads:
        raise ValueError("secagg_sum needs at least one upload")
    survivors = sorted(int(u) for u in uploads)
    cohort = sorted(int(u) for u in cohort)
    missing = [u for u in survivors if u not in cohort]
    if missing:
        raise ValueError(f"uploaders {missing} not in the mask-agreement "
                         f"cohort {cohort}")
    template = uploads[survivors[0]]
    acc = None
    with np.errstate(over="ignore"):   # exact arithmetic mod 2^64
        for u in survivors:
            leaves = (masked_upload(uploads[u], base_key, round_idx, u,
                                    cohort)
                      if masked else quantize(uploads[u]))
            acc = leaves if acc is None else [a + b
                                              for a, b in zip(acc, leaves)]
        if masked:
            dropped = [u for u in cohort if u not in uploads]
            for d in dropped:
                for s in survivors:
                    pm = _mask_leaves(_pair_key(base_key, round_idx, s, d),
                                      template)
                    for i, m in enumerate(pm):
                        if s < d:
                            acc[i] = acc[i] - m
                        else:
                            acc[i] = acc[i] + m
    return dequantize(acc, template)
