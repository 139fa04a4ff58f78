"""The port's token data (``prng.choice``, data/tokens.py) against
``jax.random.choice`` and the JAX package's ``data/tokens.py``.

* ``choice`` without ``p`` is ``randint``: equal to JAX's bitwise.
* With ``p`` (the Zipf table of ``zipf_tokens``): the uniforms are JAX's
  bitwise, and so is the algorithm (cdf = cumsum(p), r = cdf[-1]·(1 − u),
  the left ``searchsorted``): given XLA's own table the port's draw equals
  ``jax.random.choice`` exactly.  The table itself is computed in torch
  and differs from XLA's by ulps (a 1-ulp pow, sums grouped otherwise;
  TABLE_ATOL bounds the largest cumsum gap, ~4.2e-7 at vocab 32,000).
  So a token may differ from JAX's, and every token that does must have
  its r within TABLE_ATOL of a boundary between the two bins; the test
  reports how many differ (a difference, not a fault: ROADMAP.md).
* ``lm_batch``: the one-step shift and the copy span of
  tests/test_data.py, the span at JAX's position.
* The Zipf table is computed on the host once per (vocab, alpha) with
  one thread (``zipf_probs``, cached): bitwise this one-thread process's
  table, and the same in a fresh process at any thread count (a float32
  CPU sum's bits follow its split over threads); ``choice`` sums it on
  the host; the same key draws the same tokens in a fresh process, and
  (the ``cuda`` test, skipped without a card) on the card.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import tokens as jtokens
from repro_torch.core import prng
from repro_torch.data import tokens

torch.set_num_threads(1)

VOCAB = 32_000
TABLE_ATOL = 1e-6            # |cdf_torch − cdf_xla|, and r's nearness


def _jax_cdf(vocab):
    ranks = jnp.arange(1, vocab + 1, dtype=jnp.float32)
    probs = ranks ** (-1.1)
    return np.asarray(jnp.cumsum(probs / probs.sum()))


@pytest.mark.parametrize("n,shape", [(50, (1000,)), (32_000, (8, 129)),
                                     (7, (3, 5, 4)), (1, (6,))])
@pytest.mark.parametrize("seed", [0, 5])
def test_choice_without_p_is_randint_bitwise(n, shape, seed):
    want = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, shape))
    got = prng.choice(prng.PRNGKey(seed), n, shape)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_choice_with_xlas_table_is_jax_choice():
    """The algorithm alone: fed XLA's probabilities, the port's draw
    equals ``jax.random.choice``."""
    ranks = jnp.arange(1, VOCAB + 1, dtype=jnp.float32)
    probs = ranks ** (-1.1)
    probs = probs / probs.sum()
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.choice(key, VOCAB, (16, 129), p=probs))
    # the port's cumsum of XLA's p, compared with XLA's cumsum
    cdf = torch.cumsum(torch.from_numpy(np.array(probs)), 0).numpy()
    u = prng.uniform(prng.PRNGKey(11), (16, 129)).numpy()
    np.testing.assert_array_equal(
        u, np.asarray(jax.random.uniform(key, (16, 129))))
    r = np.float32(cdf[-1]) * (np.float32(1) - u)
    got = prng.choice(prng.PRNGKey(11), VOCAB, (16, 129),
                      p=torch.from_numpy(np.array(probs))).numpy()
    xla_cdf = np.asarray(jnp.cumsum(probs))
    same = np.searchsorted(xla_cdf, np.float32(xla_cdf[-1]) * (1 - u),
                           side="left")
    np.testing.assert_array_equal(same, want)
    # the port's own cumsum moves at most the draws at a bin's edge
    moved = got != want
    edge = np.abs(r - cdf[np.minimum(got, want)]) <= TABLE_ATOL
    assert np.all(edge[moved])


@pytest.mark.parametrize("seed,shape", [(3, (8, 129)), (9, (64, 257))])
def test_zipf_tokens_differ_from_jax_only_at_bin_edges(seed, shape):
    cdf_t = torch.cumsum(tokens.zipf_probs(VOCAB), 0).numpy()
    cdf_j = _jax_cdf(VOCAB)
    gap = float(np.abs(cdf_t - cdf_j).max())
    assert gap <= TABLE_ATOL
    want = np.asarray(jtokens.zipf_tokens(jax.random.PRNGKey(seed), shape,
                                          VOCAB))
    got = tokens.zipf_tokens(prng.PRNGKey(seed), shape, VOCAB)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    got = got.numpy()
    u = prng.uniform(prng.PRNGKey(seed), shape).numpy()
    np.testing.assert_array_equal(
        u, np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape)))
    r = np.float32(cdf_t[-1]) * (np.float32(1) - u)
    moved = got != want
    lo = np.minimum(got, want)
    near = np.minimum(np.abs(r - cdf_t[lo]), np.abs(r - cdf_j[lo]))
    print(f"zipf {shape}: {int(moved.sum())} of {moved.size} tokens differ "
          f"from JAX's (cumsum gap {gap:.3g}); r's distance to their bin "
          f"edge at most {float(near[moved].max()) if moved.any() else 0:.3g}")
    assert np.all(near[moved] <= TABLE_ATOL)
    assert np.all(np.abs(got - want)[moved] == 1)   # the neighbouring bin
    assert moved.sum() <= max(1, moved.size // 100)


@pytest.mark.parametrize("batch,seq", [(1, 8), (2, 33), (4, 64), (3, 17)])
def test_lm_batch_shift_property(batch, seq):
    b = tokens.lm_batch(prng.PRNGKey(1), batch, seq, vocab=97, copy_span=0)
    assert tuple(b["tokens"].shape) == (batch, seq)
    assert tuple(b["labels"].shape) == (batch, seq)
    np.testing.assert_array_equal(b["tokens"][:, 1:].numpy(),
                                  b["labels"][:, :-1].numpy())


def test_copy_span_creates_repetition_at_jaxs_position():
    key = jax.random.PRNGKey(0)
    b = tokens.lm_batch(prng.PRNGKey(0), 2, 128, vocab=1000, copy_span=16)
    ref = jtokens.lm_batch(key, 2, 128, vocab=1000, copy_span=16)
    toks = b["tokens"][0].numpy()
    p = int(jax.random.randint(jax.random.split(key, 3)[2], (), 0, 96))
    np.testing.assert_array_equal(toks[p:p + 16], toks[p + 16:p + 32])
    assert any(np.array_equal(toks[q:q + 16], toks[q + 16:q + 32])
               for q in range(0, 96))
    # the tokens are JAX's but for draws at a bin's edge
    assert (b["tokens"].numpy() != np.asarray(ref["tokens"])).mean() < 0.01
    np.testing.assert_array_equal(b["tokens"][:, 1:].numpy(),
                                  b["labels"][:, :-1].numpy())


def test_zipf_table_is_cached_on_the_host():
    for vocab in (VOCAB, 51_865, 97):
        probs = tokens.zipf_probs(vocab)
        assert probs.device.type == "cpu" and probs.dtype == torch.float32
        ranks = torch.arange(1, vocab + 1, dtype=torch.float32)
        want = ranks ** (-1.1)                 # this process: one thread
        assert torch.equal(probs, want / want.sum())
        assert tokens.zipf_probs(vocab) is probs      # computed once
    # choice sums the table on the host: cumsum, r, left searchsorted
    key = prng.PRNGKey(13)
    cdf = torch.cumsum(tokens.zipf_probs(VOCAB), 0)
    r = cdf[-1] * (1 - prng.uniform(key, (4, 33)))
    assert torch.equal(prng.choice(key, VOCAB, (4, 33),
                                   p=tokens.zipf_probs(VOCAB)),
                       torch.searchsorted(cdf, r).to(torch.int32))
    with pytest.raises(ValueError, match="expected"):
        prng.choice(key, 10, (2,), p=tokens.zipf_probs(VOCAB))


_DRAW = """
import sys, torch
sys.path.insert(0, {src!r})
torch.set_num_threads({threads})
from repro_torch.core import prng
from repro_torch.data import tokens
t = tokens.lm_batch(prng.PRNGKey(21), 4, 300, 51_865)["tokens"]
print(",".join(str(int(x)) for x in t.reshape(-1)))
assert torch.get_num_threads() == {threads}
"""


@pytest.mark.parametrize("threads", [1, 4])
def test_zipf_tokens_equal_in_a_fresh_process(threads):
    src = str(Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run([sys.executable, "-c",
                          _DRAW.format(src=src, threads=threads)],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.strip()
    here = tokens.lm_batch(prng.PRNGKey(21), 4, 300, 51_865)["tokens"]
    assert out == ",".join(str(int(x)) for x in here.reshape(-1))


@pytest.mark.cuda
def test_cuda_zipf_tokens_equal_the_cpu_tokens():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    for seed, vocab, shape in ((0, 32_000, (4, 1025)),
                               (7, 51_865, (8, 1501))):
        cpu = tokens.zipf_tokens(prng.PRNGKey(seed), shape, vocab)
        card = tokens.zipf_tokens(prng.PRNGKey(seed, device="cuda"), shape,
                                  vocab)
        assert card.device.type == "cuda"
        assert torch.equal(card.cpu(), cpu)
