"""GQA self-attention with RoPE (full or fractional) for full sequences.

The port of the JAX package's ``models/attention.py`` for the DiT path:
``rope_freqs``, ``apply_rope``, ``attend``, ``causal_mask``, ``attn_init``
and ``self_attention``.  The full-sequence product in ``self_attention``
goes through ``kernels.flash_attention.ops`` (the CUDA kernel on the card,
its plain version on the CPU); ``attend`` is the model's generic core,
used by ``decode_attention`` (one query against a cache, computed outside
any kernel in the reference too) and by callers with an arbitrary mask.
The KV cache (``init_cache``, ``cache_len_for``) is a fixed-size buffer,
a ring indexed by ``pos % C`` when a sliding window bounds it.
The encoder-decoder's cross attention (``cross_attention`` against the
K/V of ``encoder_kv``) has Sq != Sk, which no flash kernel takes; as in
the reference it runs through ``attend``, plain torch on both devices.

On ``DTensor`` activations (the partitioned families, models/
transformer.py) a projection's output dim is cut over "model"; where
the mesh does not divide its heads (GQA with fewer K/V heads than ranks,
chatglm3-6b's 2 heads of 128 over 16), ``_split_heads`` gathers that dim
whole before the view, so no rank holds part of a head, and the flash
wrapper gives each rank the K/V heads its query heads read.  Cross
attention runs ``attend`` on each rank's heads the same way
(``on_local_heads``): ``DTensor``'s strategy search over its 5-D
einsums costs seconds a call.

A placed decode cache (sharding/specs.py ``shard_decode_state``, laid
out by ``kv_cache_spec``) is attended where it lies, through
``local_map`` (``_attend_on_shards``): with its K/V heads cut over
"model" each rank takes its query heads against them; with its slots
cut (GQA with fewer K/V heads than "model" ranks) each rank takes every
query head against its slots, the token's K/V written on the rank that
owns slot pos % C, and the partial softmaxes are combined over "model"
(``attend_partial``: the max all-reduced, then Σexp·V and Σexp), so no
rank gathers the cache; the merged heads are sliced back to the
out-projection's row cut (``_rows_of``).  Cross attention against
encoder K/V cut by frames combines alike.

RoPE rotates interleaved pairs (``x[..., ::2]``, ``x[..., 1::2]``) as JAX
does, not the half-split ``rotate_half`` of common PyTorch code.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core import prng
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import dense, fill_dense, replicate_like
from repro_torch.sharding import specs

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, fraction: float = 1.0,
               device=None):
    """Inverse frequencies for the rotary fraction of the head dim, and
    that fraction's (even) width."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    idx = torch.arange(0, rot, 2, device=device).float()
    return 1.0 / (theta ** (idx / rot)), rot


def apply_rope(x, positions, theta: float, fraction: float = 1.0):
    """x: (B, H, S, dh); positions: (B, S) or (S,)."""
    dh = x.shape[-1]
    inv_freq, rot = rope_freqs(dh, theta, fraction, x.device)
    if rot == 0:
        return x
    pos = positions.float()
    if pos.ndim == 1:
        pos = pos[None, :]
    ang = pos[:, None, :, None] * inv_freq           # (B, 1, S, rot/2)
    cos = replicate_like(x, torch.cos(ang))
    sin = replicate_like(x, torch.sin(ang))
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., ::2], x_rot[..., 1::2]
    y1 = x1 * cos - x2 * sin                         # float32, as in JAX
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape)
    return torch.cat([y.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# Core attention
# ---------------------------------------------------------------------------


def attend(q, k, v, mask=None, scale: Optional[float] = None):
    """q: (B, H, Sq, dh), k/v: (B, Hkv, Skv, dh) with H % Hkv == 0.
    mask broadcasts to (B, H, Sq, Skv), True = attend."""
    B, H, Sq, dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(B, Hkv, group, Sq, dh)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k).float() * scale
    if mask is not None:
        m = torch.broadcast_to(mask, (B, H, Sq, Skv)).reshape(
            B, Hkv, group, Sq, Skv)
        logits = torch.where(m, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w, v)
    return out.reshape(B, H, Sq, dh)


def causal_mask(seq: int, window: int = 0, device=None):
    i = torch.arange(seq, device=device)[:, None]
    j = torch.arange(seq, device=device)[None, :]
    m = j <= i
    if window > 0:
        m = m & ((i - j) < window)
    return m                                         # (S, S)


# ---------------------------------------------------------------------------
# Self-attention layer (projections + RoPE)
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """The projections of one attention layer (JAX keys wq, wk, wv, wo)."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, dtype, device=None):
        super().__init__()
        self.wq = dense(d_model, n_heads * head_dim, dtype, device)
        self.wk = dense(d_model, n_kv_heads * head_dim, dtype, device)
        self.wv = dense(d_model, n_kv_heads * head_dim, dtype, device)
        self.wo = dense(n_heads * head_dim, d_model, dtype, device)


def fill_attn(m: Attention, key: torch.Tensor) -> None:
    kq, kk, kv, ko = prng.split(key, 4)
    for lin, k in ((m.wq, kq), (m.wk, kk), (m.wv, kv), (m.wo, ko)):
        fill_dense(lin, k)


def attn_init(key: torch.Tensor, d_model: int, n_heads: int,
              n_kv_heads: int, head_dim: int, dtype) -> Attention:
    m = Attention(d_model, n_heads, n_kv_heads, head_dim, dtype, key.device)
    fill_attn(m, key)
    return m


def _whole_heads(x, n_heads: int):
    """A placed projection (B, S, H·dh) whose last dim is cut over mesh
    dims that do not divide its H heads, with that dim gathered whole;
    otherwise ``x`` itself."""
    cut = Shard(x.ndim - 1)
    mesh = x.device_mesh
    ways = math.prod(mesh.size(d) for d, p in enumerate(x.placements)
                     if p == cut)
    if n_heads % ways == 0:
        return x
    return x.redistribute(mesh, [Replicate() if p == cut else p
                                 for p in x.placements])


def _split_heads(x, n_heads: int, head_dim: int):
    B, S, _ = x.shape
    if isinstance(x, DTensor):
        x = _whole_heads(x, n_heads)
    return x.reshape(B, S, n_heads, head_dim).transpose(1, 2)


def _merge_heads(x):
    B, H, S, dh = x.shape
    out = x.transpose(1, 2).reshape(B, S, H * dh)
    if isinstance(out, DTensor):
        # the gradient back as the heads were laid out: a cut the heads
        # do not divide cannot be viewed back into them
        out = specs.pin(out, out.placements)
    return out


def qkv(params: Attention, x, n_heads, n_kv_heads, head_dim, positions,
        theta, fraction, use_rope=True):
    q = _split_heads(params.wq(x), n_heads, head_dim)
    k = _split_heads(params.wk(x), n_kv_heads, head_dim)
    v = _split_heads(params.wv(x), n_kv_heads, head_dim)
    if use_rope:
        q = apply_rope(q, positions, theta, fraction)
        k = apply_rope(k, positions, theta, fraction)
    return q, k, v


def self_attention(params: Attention, x, *, n_heads, n_kv_heads, head_dim,
                   positions, theta=10_000.0, fraction=1.0, causal=True,
                   window=0, use_rope=True, return_kv=False):
    """Full-sequence attention, x: (B, S, D).  As in JAX, the window
    applies only to causal attention: a bidirectional call attends to the
    whole sequence whatever ``window`` says (the kernel would apply it)."""
    q, k, v = qkv(params, x, n_heads, n_kv_heads, head_dim, positions, theta,
                  fraction, use_rope)
    a = flash_ops.flash_attention(q, k, v, causal=causal,
                                  window=window if causal else 0)
    out = params.wo(_merge_heads(a))
    if return_kv:
        return out, (k, v)
    return out


def cross_attention(params: Attention, x, enc_k, enc_v, *, n_heads,
                    n_kv_heads, head_dim):
    """Decoder → encoder attention.  x: (B, Sq, D); enc_k / enc_v: (B,
    Hkv, Se, dh), prepared once by ``encoder_kv``."""
    q = _split_heads(params.wq(x), n_heads, head_dim)
    if isinstance(enc_k, DTensor) and _seq_dim(enc_k) is not None:
        valid = torch.ones(enc_k.shape[2], dtype=torch.bool, device=q.device)
        a = _attend_on_shards(q, enc_k, enc_v, valid)
        return params.wo(_rows_of(_merge_heads(a), params.wo.weight))
    if isinstance(q, DTensor):
        a = flash_ops.on_local_heads(lambda q, k, v: attend(q, k, v),
                                     q, enc_k, enc_v)
    else:
        a = attend(q, enc_k, enc_v)
    return params.wo(_merge_heads(a))


def encoder_kv(params: Attention, enc_out, n_kv_heads, head_dim):
    """The cross attention's K and V of the encoder's output (B, Se, D),
    each (B, Hkv, Se, dh)."""
    k = _split_heads(params.wk(enc_out), n_kv_heads, head_dim)
    v = _split_heads(params.wv(enc_out), n_kv_heads, head_dim)
    return k, v


# ---------------------------------------------------------------------------
# KV cache (fixed-size buffer; ring semantics when window > 0)
# ---------------------------------------------------------------------------


def init_cache(batch: int, n_kv_heads: int, cache_len: int, head_dim: int,
               dtype, device=None):
    shape = (batch, n_kv_heads, cache_len, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_len_for(seq_len: int, window: int) -> int:
    return min(seq_len, window) if window > 0 else seq_len


def decode_attention(params: Attention, x, cache, pos: int, *, n_heads,
                     n_kv_heads, head_dim, theta=10_000.0, fraction=1.0,
                     window=0, use_rope=True):
    """One-token decode.  x: (B, 1, D); ``pos`` the current position (a
    host int).  Returns (out (B, 1, D), new cache); the given cache is
    not changed.

    The buffer has length C = cache_len_for(seq, window); with a window
    it is a ring indexed by pos % C.  RoPE uses absolute positions, so
    the relative geometry holds whatever the ring's rotation.

    A placed cache (sharding/specs.py ``shard_decode_state``) runs on
    each rank's part through ``local_map`` (``_attend_on_shards``)."""
    B = x.shape[0]
    C = cache["k"].shape[2]
    dev = x.device
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=dev)
    q, k_new, v_new = qkv(params, x, n_heads, n_kv_heads, head_dim,
                          positions, theta, fraction, use_rope)
    slot = pos % C
    # valid slots: those already written (<= pos), within the window
    idx = torch.arange(C, device=dev)
    written = (torch.ones(C, dtype=torch.bool, device=dev) if pos + 1 >= C
               else idx <= slot)
    if window > 0:
        # the absolute position held in each ring slot
        abs_pos = torch.where(idx <= slot, pos - slot + idx,
                              pos - slot + idx - C)
        valid = written & (pos - abs_pos < window) & (abs_pos >= 0)
    else:
        valid = written
    if isinstance(cache["k"], DTensor):
        a, k, v = _attend_on_shards(q, cache["k"], cache["v"], valid,
                                    (k_new, v_new), slot)
        a = _rows_of(_merge_heads(a), params.wo.weight)
    else:
        a, k, v = _write_attend(q, cache["k"], cache["v"], valid,
                                (k_new, v_new), slot)
        a = _merge_heads(a)
    return params.wo(a), {"k": k, "v": v}


def _write_attend(q, k, v, valid, new=(), slot: int = 0, lo: int = 0,
                  group=None):
    """``attend(q, k, v, valid)`` after writing ``new`` = (k_new, v_new)
    (B, Hkv, 1, dh) into copies of k and v at slot ``slot`` − ``lo``
    when it lies in them (``lo``: the first slot they hold); with
    ``group``, the other slots on its other ranks (``attend_partial``).
    Returns out, and with ``new`` the written k and v."""
    if new:
        k, v = k.clone(), v.clone()
        if lo <= slot < lo + k.shape[2]:
            k[:, :, slot - lo:slot - lo + 1] = new[0]
            v[:, :, slot - lo:slot - lo + 1] = new[1]
    out = attend(q, k, v, valid[None, None, None]) if group is None else \
        attend_partial(q, k, v, valid, group)
    return (out, k, v) if new else out


# ---------------------------------------------------------------------------
# Placed caches: heads cut (local), or the sequence cut (lse combine)
# ---------------------------------------------------------------------------


def _seq_dim(k) -> Optional[int]:
    """The mesh dim that cuts a placed cache (B, Hkv, C, dh) along its
    slots, or None (its heads are cut, or nothing)."""
    dims = [d for d, p in enumerate(k.placements) if p == Shard(2)]
    if len(dims) > 1:
        raise ValueError(f"cache slots cut over two mesh dims: "
                         f"{k.placements}")
    return dims[0] if dims else None


def attend_partial(q, k, v, mask, group):
    """``attend`` over K/V (B, Hkv, Sk, dh) whose keys are this rank's
    part of the sequence, the rest on the other ranks of ``group``: the
    logits' max all-reduced, then the local Σexp and Σexp·V (float32)
    summed in one all-reduce, and their quotient in v's type.  ``mask``
    (Sk,) marks the local keys to attend; every query must see at least
    one key on some rank."""
    import torch.distributed as dist
    B, H, Sq, dh = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, Sq, dh)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k).float() * \
        (1.0 / math.sqrt(dh))
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    top = logits.amax(dim=-1, keepdim=True)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    p = torch.exp(logits - top)
    acc = torch.cat([torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()),
                     p.sum(dim=-1, keepdim=True)], dim=-1)
    dist.all_reduce(acc, group=group)
    out = (acc[..., :dh] / acc[..., dh:]).to(v.dtype)
    return out.reshape(B, H, Sq, dh)


def _attend_on_shards(q, k, v, valid, new=(), slot: int = 0):
    """``attend(q, k, v, valid)`` on placed operands, each rank on its
    part through ``local_map``, after writing ``new`` = (k_new, v_new)
    (B, Hkv, 1, dh) into slot ``slot`` when given.  The batch is cut as
    the K/V cut it.  With their heads cut over "model", each rank takes
    its query heads against its K/V heads (q's heads cut alike).  With
    their keys cut (a cache's slots), each rank takes the whole heads of
    q (and of ``new``, written on the rank that owns the slot) against
    its keys, combined by ``attend_partial`` over that mesh dim: no rank
    gathers the keys.  Returns out (B, H, Sq, dh), and with ``new`` the
    written k and v, all placed."""
    from torch.distributed.tensor.experimental import local_map
    mesh = k.device_mesh
    d = _seq_dim(k)
    cut = 1 if d is None else 2
    (c_pl, _), (q_pl, _) = specs.local_map_placements(
        specs.mesh_kinds(k, 0, cut), (0, cut), (0, 1 if d is None else None))
    lo, n = 0, k.shape[2]
    if d is not None:
        n //= mesh.size(d)
        lo = mesh.get_local_rank(d) * n
    mask = valid[lo:lo + n]
    group = None if d is None else mesh.get_group(d)
    local = lambda q, k, v, *kv_new: _write_attend(q, k, v, mask, kv_new,
                                                   slot, lo, group)
    return local_map(local, out_placements=(q_pl, c_pl, c_pl) if new
                     else q_pl,
                     in_placements=(q_pl, c_pl, c_pl) + (q_pl,) * len(new),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, *new)


def _rows_of(a, w):
    """A placed activation (B, S, H·dh) cut along its last dim as the
    input dim (1) of ``w`` (an out-projection's weight) is: this rank's
    slice of the row cut, taken without communication where ``a`` is
    whole there."""
    if not isinstance(w, DTensor):
        return a
    last = Shard(a.ndim - 1)
    want = [last if pw == Shard(1) else pa if pa != last else Replicate()
            for pa, pw in zip(a.placements, w.placements)]
    return a if want == list(a.placements) else \
        a.redistribute(a.device_mesh, want)
