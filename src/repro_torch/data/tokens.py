"""Synthetic token streams for the LM training and serving drivers.

The port of the JAX package's ``data/tokens.py``: Zipf-distributed
unigrams with an injected copy span give next-token structure a model can
learn (the loss falls), without any external corpus.  Labels are the
one-step shift.  The draws are ``core/prng.py``'s threefry, so the
uniforms and the span's position equal JAX's bit for bit; the Zipf table
is computed in torch and may differ from XLA's by an ulp, which moves a
few draws into the neighbouring bin (``prng.choice``;
tests/test_torch_tokens.py bounds how many).  The table is computed once
per (vocab, alpha) on the host, whatever the thread count, and
``prng.choice`` sums it there, so the card and every process draw the
same tokens bit for bit.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import prng


@functools.lru_cache(maxsize=8)
def zipf_probs(vocab: int, alpha: float = 1.1) -> torch.Tensor:
    """(vocab,) float32 probabilities ∝ rank^−alpha, ranks 1..vocab,
    computed on the host once per (vocab, alpha) with one intra-op
    thread: torch's CPU sum splits a row over the threads and its
    float32 bits follow the split, so the table would otherwise change
    with the thread count.  The cached tensor is shared, not to be
    written."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ranks = torch.arange(1, vocab + 1, dtype=torch.float32)
        probs = ranks ** (-alpha)
        return probs / probs.sum()
    finally:
        torch.set_num_threads(threads)


def zipf_tokens(key: torch.Tensor, shape, vocab: int,
                alpha: float = 1.1) -> torch.Tensor:
    """Token ids of ``shape`` drawn from the Zipf table, int32, on the
    key's device."""
    return prng.choice(key, vocab, shape, p=zipf_probs(vocab, alpha))


def lm_batch(key: torch.Tensor, batch: int, seq: int, vocab: int,
             copy_span: int = 16) -> dict:
    """{tokens (B, S), labels (B, S)}, int32 values in int64 tensors (the
    port's embeddings take int64 indices), with labels[t] = tokens[t+1].
    Where seq > 2·copy_span, positions [p + span, p + 2·span) repeat
    [p, p + span) in every row, p = randint(0, seq − 2·span) drawn from
    the third key of ``split(key, 3)`` as the reference draws it."""
    kz, _, kp = prng.split(key, 3)
    toks = zipf_tokens(kz, (batch, seq + 1), vocab)
    if copy_span > 0 and seq > 2 * copy_span:
        p = int(prng.randint(kp, (), 0, seq - 2 * copy_span))
        toks = toks.clone()
        toks[:, p + copy_span:p + 2 * copy_span] = toks[:, p:p + copy_span]
    toks = toks.long()
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
