"""Threefry-2x32 keys and draws, bit for bit with ``jax.random``.

The serve path addresses its randomness by key rather than drawing from a
sequential generator: ``fold_in(key, seed)`` per group and per request,
``fold_in(key, i)`` per batch row, chained ``split`` in the per-request
samplers.  Warm==cold, fifo==depth and padding invariance rest on that
addressing, so the port keeps JAX's counter-based generator instead of a
``torch.Generator``.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words;
every word op is done in int64 and masked to 32 bits, which runs the same
on the CPU and on CUDA.  The layout follows jax 0.9.0 with
``jax_threefry_partitionable=True`` (the default there):

* ``split(key, n)[i]`` and ``fold_in(key, i)`` both hash the counter pair
  ``(0, i)`` under the key;
* ``random_bits`` hashes ``(hi32(j), lo32(j))`` for the flat index j of
  every element and XORs the two output words;
* ``uniform`` puts the top 23 bits into the mantissa of a float in [1, 2);
* ``normal`` is ``sqrt(2)·erfinv(uniform(nextafter(-1, 0), 1))``.  Bits,
  keys and uniforms equal JAX's exactly; ``torch.erfinv`` may differ from
  XLA's by a few ulps.

Each draw is ~170 elementwise launches on a card; the samplers' per-step
draws run instead inside the DDPM-step kernel (``csrc/threefry.cuh``, the
same bits).  ``fill_normal_`` draws a large parameter window by window
of its flat index, bit for bit the one-shot draw, so an expert tensor of
10^9 elements needs no 10^9-element int64 temporaries.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_SQRT2 = np.float32(np.sqrt(2.0))
_NORMAL_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))

Data = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds) on broadcastable int64 tensors
    holding uint32 words.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + k1) & MASK
    x2 = (x2 + k2) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the pair
    (0, seed mod 2^32)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside the int32 range")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def key_data(key: torch.Tensor) -> np.ndarray:
    """The key words as a host uint32 array (JAX's ``key_data`` layout)."""
    return key.detach().cpu().numpy().astype(np.uint32)


def _as_words(data: Data, device) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data.to(device=device, dtype=torch.int64) & MASK
    return torch.tensor(int(data) & MASK, dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: Data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter pair (0, data) under key.
    ``key`` is (..., 2); ``data`` an int or an integer tensor that
    broadcasts against ``key[..., 0]``."""
    d = _as_words(data, key.device)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of one (2,) key into (num, 2) keys."""
    if key.shape != (2,):
        raise ValueError(f"split takes one (2,) key, got {tuple(key.shape)}")
    return fold_in(key, torch.arange(num, device=key.device))


def _bits_at(key: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The bits of the elements whose flat indices are ``idx`` (any
    shape): partitionable threefry hashes each index on its own."""
    expand = key.shape[:-1] + (1,) * idx.ndim
    b1, b2 = threefry2x32(key[..., 0].reshape(expand),
                          key[..., 1].reshape(expand), idx >> 32, idx & MASK)
    return b1 ^ b2


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2^32)).  A batched key
    (..., 2) gives (..., *shape), each key drawing its own ``shape``."""
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device)
    return _bits_at(key, idx.reshape(shape))


def leafwise_bits(key: torch.Tensor, shapes: Sequence[Sequence[int]]
                  ) -> list:
    """``[random_bits(fold_in(key, i), shapes[i]) for i ...]`` in one
    pass: every element of every leaf is hashed under its leaf's key in
    a single flat draw, so a model of a few hundred parameter tensors
    costs one draw's launches instead of one per tensor.  Bit for bit
    the per-leaf draws."""
    shapes = [tuple(int(s) for s in shp) for shp in shapes]
    if not shapes:
        return []
    sizes = [math.prod(shp) for shp in shapes]
    dev = key.device
    keys = fold_in(key, torch.arange(len(shapes), device=dev))
    leaf = torch.repeat_interleave(
        torch.arange(len(shapes), device=dev),
        torch.tensor(sizes, device=dev))
    starts = torch.tensor([0] + sizes[:-1], device=dev).cumsum(0)
    idx = torch.arange(sum(sizes), dtype=torch.int64, device=dev) - \
        starts[leaf]
    k = keys[leaf]
    b1, b2 = threefry2x32(k[:, 0], k[:, 1], idx >> 32, idx & MASK)
    return [part.reshape(shp) for part, shp in
            zip(torch.split(b1 ^ b2, sizes), shapes)]


def _uniform_from_bits(bits: torch.Tensor, minval: float,
                       maxval: float) -> torch.Tensor:
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = np.float32(minval)
    scale = np.float32(maxval) - lo
    lo_t = torch.tensor(lo, dtype=torch.float32, device=bits.device)
    out = floats * torch.tensor(scale, dtype=torch.float32,
                                device=bits.device) + lo_t
    return torch.maximum(lo_t, out)


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on [minval, maxval)."""
    return _uniform_from_bits(random_bits(key, shape), minval, maxval)


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """The standard normals ``normal`` makes of 32 random bits each."""
    u = _uniform_from_bits(bits, float(_NORMAL_LO), 1.0)
    return torch.erfinv(u) * torch.tensor(_SQRT2, device=bits.device)


def normal(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32 (erfinv of a symmetric uniform)."""
    return normal_from_bits(random_bits(key, shape))


_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1


def _split2(key: torch.Tensor):
    """``_split(key)`` of jax.random's samplers for a key or a batch of
    keys (..., 2): the two keys fold_in(key, 0) and fold_in(key, 1)."""
    ks = fold_in(key.unsqueeze(-2), torch.arange(2, device=key.device))
    return ks[..., 0, :], ks[..., 1, :]


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b mod 2^32 for uint32 words in int64, without int64 overflow:
    b is taken in two 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _rem32(a: torch.Tensor, span: torch.Tensor) -> torch.Tensor:
    """XLA's unsigned remainder: a % span, and a where span is 0."""
    return torch.where(span == 0, a, a % torch.where(span == 0, 1, span))


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` with the default
    int32 dtype, bit for bit: two words of 32 bits per value from the
    two halves of ``split(key)``, combined as (hi % span · mult + lo %
    span) % span with mult = (2^16 mod span)² mod span, every product
    and sum wrapping mod 2^32.  ``minval``/``maxval`` are clipped to the
    int32 range; a ``maxval`` above it widens the span by one (jax's
    out-of-range branch); ``maxval <= minval`` gives ``minval``.  A
    batched key (..., 2) gives (..., *shape), one draw per key as ``vmap``
    over keys gives.  Returns int32."""
    minval, maxval = int(minval), int(maxval)
    out_of_range = maxval > _INT32_MAX
    lo_v = min(max(minval, _INT32_MIN), _INT32_MAX)
    hi_v = min(max(maxval, _INT32_MIN), _INT32_MAX)
    dev = key.device
    k1, k2 = _split2(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = (hi_v - lo_v) & MASK if hi_v > lo_v else 1
    if out_of_range and hi_v > lo_v:
        span = (span + 1) & MASK
    span = torch.tensor(span, dtype=torch.int64, device=dev)
    mult = _rem32(torch.tensor(1 << 16, dtype=torch.int64, device=dev), span)
    mult = _rem32(_mul32(mult, mult), span)
    offset = (_mul32(_rem32(higher, span), mult) + _rem32(lower, span)) & MASK
    offset = _rem32(offset, span)
    out = (lo_v + offset + 2 ** 31) & MASK        # int32 add, wrapping
    return (out - 2 ** 31).to(torch.int32)


def choice(key: torch.Tensor, n: int, shape: Sequence[int] = (),
           p=None) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, p=p)`` with replacement over
    arange(n).  Without ``p``, ``randint(key, shape, 0, n)`` bit for bit.
    With ``p`` (n float32 weights), JAX's algorithm: cdf = cumsum(p), r =
    cdf[-1]·(1 − uniform(key, shape)), the first index whose cdf value
    is not below r (``searchsorted``, left side).  The cumsum is taken on
    the host (a CUDA cumsum may group its sums otherwise from call to
    call) and moved to the key's device, so the card draws what the CPU
    draws bit for bit.  The uniforms equal JAX's bit for bit; a
    torch-computed ``p`` or cumsum may differ from XLA's by an ulp, which
    moves an r lying that close to a bin's edge into the neighbouring
    bin.  Returns int32."""
    if p is None:
        return randint(key, shape, 0, n)
    p = torch.as_tensor(p, dtype=torch.float32).cpu()
    if p.shape != (n,):
        raise ValueError(f"choice: p has shape {tuple(p.shape)}, expected "
                         f"({n},)")
    cdf = torch.cumsum(p, dim=0).to(key.device)
    r = cdf[-1] * (1 - uniform(key, shape))
    return torch.searchsorted(cdf, r).to(torch.int32)


def bernoulli(key: torch.Tensor, p, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for float32 ``p`` (a float
    or a tensor broadcasting against ``shape``): uniform(key, shape) < p,
    bool."""
    p = torch.as_tensor(p, dtype=torch.float32, device=key.device)
    return uniform(key, shape) < p


def permutation(key: torch.Tensor, x) -> torch.Tensor:
    """``jax.random.permutation(key, x)``: an int ``x`` shuffles
    arange(x) (int32), a tensor is shuffled along its first axis.  JAX's
    ``_shuffle``: ceil(3·ln(n) / ln(2^32 − 1)) rounds, each a stable sort
    by 32 fresh random bits per element, from ``key, subkey =
    split(key)``."""
    if isinstance(x, int):
        x = torch.arange(x, dtype=torch.int32, device=key.device)
    n = x.shape[0]
    rounds = int(np.ceil(3 * np.log(max(1, n)) /
                         np.log(np.iinfo(np.uint32).max)))
    idx = torch.arange(n, device=key.device)
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        idx = idx[order]
    return x[idx.to(x.device)]


def categorical(key: torch.Tensor, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)``: the Gumbel-max
    trick, argmax(logits + g) with g = −log(−log(u)), u ``uniform`` on
    [tiny, 1) of the logits' shape (float32 logits).  The uniforms equal
    JAX's bit for bit; the logarithms may differ by an ulp.  Returns
    int64 indices (JAX's int32 values)."""
    tiny = float(torch.finfo(logits.dtype).tiny)
    u = uniform(key.to(logits.device), tuple(logits.shape), minval=tiny,
                maxval=1.0).to(logits.dtype)
    return torch.argmax(-torch.log(-torch.log(u)) + logits, dim=axis)


FILL_CHUNK = 1 << 26     # elements per window: ~3 GB of int64 temporaries


def fill_normal_(param: torch.Tensor, key: torch.Tensor, scale: float = 1.0,
                 divisor: float = 1.0, chunk: int = FILL_CHUNK) -> None:
    """Draw ``normal(key, param.shape) * scale / divisor`` into ``param``
    in place, cast to its dtype, ``chunk`` elements at a time.  The draw
    hashes each element's flat index, so the window [j0, j1) is that
    slice of the one-shot draw, bit for bit, and the temporaries stay
    O(chunk) however large ``param`` is.  Scale and divisor are applied
    in float32 on the device as JAX's ``(normal(k, s) * c).astype(dt)``
    and ``(normal(k, s) / c).astype(dt)`` apply them (a 0-dim device
    tensor, so a division stays a division).  ``param`` must be
    contiguous."""
    if not param.is_contiguous():
        raise ValueError("fill_normal_: parameter is not contiguous")
    if key.shape != (2,):
        raise ValueError(f"fill_normal_ takes one (2,) key, got "
                         f"{tuple(key.shape)}")
    key = key.to(param.device)
    flat = param.detach().view(-1)
    mul = torch.tensor(np.float32(scale), device=param.device)
    div = torch.tensor(np.float32(divisor), device=param.device)
    for j0 in range(0, flat.numel(), chunk):
        j1 = min(j0 + chunk, flat.numel())
        idx = torch.arange(j0, j1, dtype=torch.int64, device=param.device)
        z = normal_from_bits(_bits_at(key, idx))
        if scale != 1.0:
            z = z * mul
        if divisor != 1.0:
            z = z / div
        flat[j0:j1].copy_(z)
