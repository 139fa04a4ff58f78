"""Shared building blocks: the dense-weight initialiser (threefry-keyed,
equal to the JAX package's for the same key), the token embedding, the
sinusoidal timestep embedding, RMSNorm, whisper's LayerNorm and the two
MLPs.

Each function also takes ``DTensor`` parameters and activations (the
partitioned families, sharding/specs.py ``shard_params``): the same
operations, with ``DTensor``'s sharding propagation inserting the
collectives, so RMSNorm over a dim cut over "model" all-reduces its row
statistic, and ``embed`` looks up a vocab-sharded table on each rank's
rows and sums them.

Parameters live in ``nn.Module``s whose attribute names are the JAX
package's parameter keys (``scale``, ``w_gate``, ``w_up`` …), so
bridge.py maps a JAX tree onto a module name by name.  A JAX ``(in, out)``
dense weight is an ``nn.Linear`` without bias, which stores ``(out, in)``.
The functions keep the JAX names and take the module where JAX takes its
parameter dict (``rmsnorm(params, x, eps)``, ``mlp_apply(params, x,
mlp_type)``); each ``*_init(key, …)`` builds the module on the key's
device and draws its weights in JAX's key order.  Forward only.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.nn.utils import skip_init

from repro_torch.core import prng
from repro_torch.sharding import specs


def dense_init(key: torch.Tensor, d_in: int, d_out: int,
               dtype=torch.float32, scale: Optional[float] = None
               ) -> torch.Tensor:
    """(d_in, d_out) weight ~ N(0, scale²), scale = 1/sqrt(d_in) by
    default — JAX's (in, out) layout."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (prng.normal(key, (d_in, d_out)) * scale).to(dtype)


def dense(d_in: int, d_out: int, dtype, device=None) -> nn.Linear:
    """An uninitialised bias-free ``nn.Linear`` (filled by an init or by
    bridge.py)."""
    return skip_init(nn.Linear, d_in, d_out, bias=False,
                     device="cpu" if device is None else device, dtype=dtype)


def fill(param: torch.Tensor, value: torch.Tensor) -> None:
    """Copy ``value`` into a parameter in place (shapes must match)."""
    if param.shape != value.shape:
        raise ValueError(f"fill: parameter {tuple(param.shape)} vs value "
                         f"{tuple(value.shape)}")
    with torch.no_grad():
        param.copy_(value)


def fill_dense(lin: nn.Linear, key: torch.Tensor,
               scale: Optional[float] = None) -> None:
    """``dense_init`` into an ``nn.Linear`` (transposed to (out, in))."""
    fill(lin.weight, dense_init(key, lin.in_features, lin.out_features,
                                lin.weight.dtype, scale).t())


def embed_init(key: torch.Tensor, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    """(vocab, d) token embedding ~ N(0, 0.02²), JAX's ``embed_init``."""
    return (prng.normal(key, (vocab, d)) * 0.02).to(dtype)


def embedding(vocab: int, d: int, dtype, device=None) -> nn.Embedding:
    """An uninitialised ``nn.Embedding``: its (vocab, d) weight is JAX's
    ``embed`` array as it is, and ``embedding(tokens)`` is
    ``embed[tokens]``."""
    return skip_init(nn.Embedding, vocab, d,
                     device="cpu" if device is None else device, dtype=dtype)


def embed(table: nn.Embedding, tokens):
    """``table(tokens)``.  A vocab-sharded table (a ``DTensor`` weight cut
    over "model" by its rows, JAX's ``("model", None)``) looks up on each
    rank the tokens of its rows, zero elsewhere, through ``local_map``:
    the rows come out as partial sums over the vocab's ranks, which the
    caller's ``constrain`` all-reduces.  (``DTensor``'s own embedding
    gives a masked partial that its backward cannot take back from a
    partial-sum gradient.)"""
    w = table.weight
    if not isinstance(w, DTensor):
        return table(tokens)
    from torch.distributed.tensor.experimental import local_map
    mesh = w.device_mesh
    rows = [d for d, p in enumerate(w.placements) if p == Shard(0)]
    if len(rows) > 1 or any(tokens.placements[d] != Replicate()
                            for d in rows):
        raise ValueError(f"embed: table {w.placements} with tokens "
                         f"{tokens.placements}")
    kinds = ["cut" if d in rows else kind
             for d, kind in enumerate(specs.mesh_kinds(tokens, 0))]
    (w_pl, w_grad), (t_pl, _), (_, out) = specs.local_map_placements(
        kinds, (None, 0), (0, None), (0, None))
    lo = mesh.get_local_rank(rows[0]) * (w.shape[0] // mesh.size(rows[0])) \
        if rows else None

    def local(w, tokens):
        if lo is None:
            return F.embedding(tokens, w)
        idx = tokens - lo
        hit = (idx >= 0) & (idx < w.shape[0])
        found = F.embedding(torch.where(hit, idx, 0), w)
        return torch.where(hit[..., None], found, 0.0)

    return local_map(local, out_placements=out,
                     in_placements=(w_pl, t_pl),
                     in_grad_placements=(w_grad, t_pl), device_mesh=mesh,
                     redistribute_inputs=True)(w, tokens)


def fill_embedding(emb: nn.Embedding, key: torch.Tensor) -> None:
    """``embed_init`` into an embedding."""
    fill(emb.weight, embed_init(key, emb.num_embeddings, emb.embedding_dim,
                                emb.weight.dtype))


def sinusoidal_embedding(positions: torch.Tensor, dim: int,
                         max_period: float = 10_000.0) -> torch.Tensor:
    """(...,) positions -> (..., dim) sinusoidal embedding (float32)."""
    half = dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(max_period) * idx / half)
    args = positions.float()[..., None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def replicate_like(ref, t: torch.Tensor):
    """``t``, a constant computed beside the model (positions, their
    rotary angles or sinusoidal embedding), as ``ref`` holds its values: a
    ``DTensor`` replicated over ``ref``'s mesh when ``ref`` is a placed
    activation, ``t`` itself otherwise."""
    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))

    def forward(self, x, eps: float = 1e-5):
        return rmsnorm(self, x, eps)


def rmsnorm_init(d: int, dtype, device=None) -> RMSNorm:
    return RMSNorm(d, dtype, device)


def rmsnorm(params: RMSNorm, x: torch.Tensor, eps: float = 1e-5):
    """JAX's two forms.  float32: x · rsqrt(mean(x²) + eps) · scale.  Any
    other type (``_rmsnorm_lowmem``): the row statistic in float32, then
    two products each rounded in x's type."""
    scale = params.scale
    if x.dtype == torch.float32:
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
        return x * torch.rsqrt(var + eps) * scale
    x32 = x.float()
    var = (x32 * x32).sum(dim=-1, keepdim=True) / x.shape[-1]
    inv = torch.rsqrt(var + eps)
    return x * inv.to(x.dtype) * scale.to(x.dtype)


# ---------------------------------------------------------------------------
# LayerNorm (whisper)
# ---------------------------------------------------------------------------


class LayerNorm(nn.Module):
    """JAX keys ``scale`` and ``bias``."""

    def __init__(self, d: int, dtype, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))

    def forward(self, x, eps: float = 1e-5):
        return layernorm(self, x, eps)


def layernorm_init(d: int, dtype, device=None) -> LayerNorm:
    return LayerNorm(d, dtype, device)


def layernorm(params: LayerNorm, x: torch.Tensor, eps: float = 1e-5):
    """JAX's LayerNorm: the row's mean and population variance (jnp.var,
    so ``correction=0``) in float32, scale and bias applied in float32,
    then one rounding to x's type."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * params.scale.float() + params.bias.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


class SwiGLU(nn.Module):
    def __init__(self, d: int, f: int, dtype, device=None):
        super().__init__()
        self.w_gate = dense(d, f, dtype, device)
        self.w_up = dense(d, f, dtype, device)
        self.w_down = dense(f, d, dtype, device)

    def forward(self, x):
        return swiglu(self, x)


class GeluMLP(nn.Module):
    def __init__(self, d: int, f: int, dtype, device=None):
        super().__init__()
        self.w1 = dense(d, f, dtype, device)
        self.w2 = dense(f, d, dtype, device)

    def forward(self, x):
        return gelu_mlp(self, x)


def swiglu(params: SwiGLU, x):
    return params.w_down(F.silu(params.w_gate(x)) * params.w_up(x))


def gelu_mlp(params: GeluMLP, x):
    # jax.nn.gelu defaults to the tanh approximation
    return params.w2(F.gelu(params.w1(x), approximate="tanh"))


def gelu_mlp_init(key: torch.Tensor, d: int, f: int, dtype) -> GeluMLP:
    m = GeluMLP(d, f, dtype, key.device)
    fill_mlp(m, key)
    return m


def make_mlp(d: int, f: int, dtype, mlp_type: str, device=None) -> nn.Module:
    """The uninitialised MLP of ``mlp_type`` (swiglu | gelu)."""
    cls = SwiGLU if mlp_type == "swiglu" else GeluMLP
    return cls(d, f, dtype, device)


def mlp_init(key: torch.Tensor, d: int, f: int, dtype,
             mlp_type: str) -> nn.Module:
    m = make_mlp(d, f, dtype, mlp_type, key.device)
    fill_mlp(m, key)
    return m


def fill_mlp(m: nn.Module, key: torch.Tensor) -> None:
    """Draw an MLP's weights as JAX's ``mlp_init`` does for ``key``."""
    if isinstance(m, SwiGLU):
        k1, k2, k3 = prng.split(key, 3)
        fill_dense(m.w_gate, k1)
        fill_dense(m.w_up, k2)
        fill_dense(m.w_down, k3)
    else:
        k1, k2 = prng.split(key)
        fill_dense(m.w1, k1)
        fill_dense(m.w2, k2)


def mlp_apply(params: nn.Module, x, mlp_type: str):
    return swiglu(params, x) if mlp_type == "swiglu" else gelu_mlp(params, x)
