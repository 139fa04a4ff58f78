"""Mixture-of-Experts layer.

The port of the JAX package's ``models/moe.py``: ``moe_init`` (here the
``MoE`` module and ``fill_moe``), ``_router``, ``_aux_loss``,
``_expert_ffn``, the three modes and ``moe_apply``, which picks one from
the ``runtime`` as JAX's does:

* ``moe_dense`` (no mesh): every expert on every token, combined with the
  router's top-k weights, with no capacity and no drops.  Its expert
  products take the tokens broadcast to every expert, an ``expand`` that
  costs no copy.
* ``moe_ep`` (a mesh, ``moe_mode="ep"``; training and prefill): tokens
  packed into ``capacity`` slots per expert (``_dispatch_local``), sent to
  the experts' ranks over the mesh's ``model`` group (``all_to_all``), run
  through the local experts, sent back and combined with the router's
  weights (``_combine_local``).  Tokens past an expert's capacity are
  dropped, as in JAX.
* ``moe_ep2d`` (``moe_mode="ep2d"``; decode): the weights stay put, each
  rank holding its experts' slice of the FFN width over ``data``; the
  tokens are gathered over the batch group, dispatched as in ``moe_ep``,
  the partial products summed over ``data`` (``all_reduce``) and each
  rank keeps its own rows.

A rank of the mesh holds the full parameters and uses its slice of them
(its experts, and in ``moe_ep2d`` its part of F), as JAX's ``shard_map``
gives each device its shard; gradients reach the full tensors through
the slices.  Placed parameters (sharding/specs.py ``shard_params``,
``DTensor``s) and a placed x run the same functions on local parts:
each expert tensor redistributed to this rank's experts (the training
layout's FSDP all-gather over "data", whose backward reduce-scatters
the gradient; in the inference layout nothing moves) and taken with
``to_local`` (``_local_experts``), y placed back as x, the aux loss as
a placed vector of the batch shards' losses and its mean.

JAX's collectives become ``torch.distributed.nn.functional``
ones on the mesh's process groups (launch/mesh.py), which autograd
differentiates: ``all_to_all`` → ``all_to_all_single`` over ``model``,
``all_gather`` over the batch axes → ``all_gather`` over ``data`` (over
("pod", "data") flattened, pod-major, on a multi-pod mesh), ``psum`` →
``all_reduce``, ``axis_index`` → the rank in the batch axes.  They
run at one rank too.  The aux loss is the mean over the batch shards, the
same value on every rank.

Every expert product (three per layer) is the grouped matmul, through
``kernels.grouped_matmul.ops`` (the hand-written CUDA kernels on the
card, the forward and, under grad, the backward).  On CUDA ``_combine_local``
sums a token's k rows in one fixed order (JAX scatter-adds them; an
``index_add_`` would add them in atomic order), and ``_dispatch_local``
writes the kept rows to their unique slots, so both are deterministic.
"""
from __future__ import annotations

import math
import warnings
from typing import Tuple

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.kernels.grouped_matmul import ops as gmm_ops
from repro_torch.models.layers import dense_init, fill, replicate_like


class MoE(nn.Module):
    """The JAX keys: ``router`` (d, E) kept in float32 whatever the
    model's type, ``w_gate`` / ``w_up`` (E, d, F) and ``w_down`` (E, F, d)
    in the model's type — JAX's layouts, not ``nn.Linear``'s."""

    def __init__(self, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

        def empty(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        self.router = empty(d, e, dt=torch.float32)
        self.w_gate = empty(e, d, f)
        self.w_up = empty(e, d, f)
        self.w_down = empty(e, f, d)


def fill_moe(m: MoE, key: torch.Tensor) -> None:
    """``moe_init``'s draws in its key order: the router through
    ``dense_init`` in float32, each expert tensor a float32 normal times
    1/sqrt(d) (gate, up) or over sqrt(F) (down), cast to the model's type
    window by window (``prng.fill_normal_``)."""
    d, e = m.router.shape
    f = m.w_gate.shape[-1]
    kr, kg, ku, kd = prng.split(key, 4)
    fill(m.router, dense_init(kr, d, e, torch.float32))
    prng.fill_normal_(m.w_gate, kg, scale=1.0 / math.sqrt(d))
    prng.fill_normal_(m.w_up, ku, scale=1.0 / math.sqrt(d))
    prng.fill_normal_(m.w_down, kd, divisor=math.sqrt(f))


def moe_init(key: torch.Tensor, cfg: ArchConfig, dtype) -> MoE:
    m = MoE(cfg, dtype, key.device)
    fill_moe(m, key)
    return m


def _router(params: MoE, x: torch.Tensor, top_k: int):
    """x: (N, D) -> (probs (N, E) f32, topk_w (N, k) f32, topk_idx (N, k)
    int64).  The k largest probabilities in descending order, renormalised
    to sum to one (``lax.top_k``; on exact ties JAX takes the lower index
    first, which ``torch.topk`` does not promise)."""
    return _route(params.router, x, top_k)


def _route(router: torch.Tensor, x: torch.Tensor, top_k: int):
    """``_router`` with the router's weight (d, E) given."""
    logits = x.float() @ router
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_idx = torch.topk(probs, top_k, dim=-1, largest=True,
                                  sorted=True)
    topk_w = topk_w / torch.clamp(topk_w.sum(-1, keepdim=True), min=1e-9)
    return probs, topk_w, topk_idx


def _aux_loss(probs: torch.Tensor, topk_idx: torch.Tensor,
              n_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e f_e * P_e.  The counts
    are a compare-and-sum over the E experts (``bincount``'s values,
    whose output size a meta tensor cannot know).  Placed (``DTensor``)
    probabilities and choices, cut by rows, give the loss of all the
    rows."""
    experts = replicate_like(topk_idx, torch.arange(
        n_experts, device=topk_idx.device))
    counts = (topk_idx.reshape(-1, 1) == experts).sum(dim=0).float()
    f = counts / torch.clamp(counts.sum(), min=1.0)
    p = probs.mean(dim=0)
    return n_experts * torch.sum(f * p)


def _expert_ffn(w_gate, w_up, w_down, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (E, C, D) grouped per expert -> (E, C, D): SwiGLU per
    expert, each product one grouped-matmul launch on the card."""
    g = F.silu(gmm_ops.grouped_matmul(tokens, w_gate))
    u = gmm_ops.grouped_matmul(tokens, w_up)
    return gmm_ops.grouped_matmul(g * u, w_down)


def moe_dense(params: MoE, x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D).  Every expert on every token, combined with the
    router's top-k weights.  Returns (y (B, S, D), aux loss).

    Placed (``DTensor`` parameters and x, a mesh without ``moe_ep``):
    each rank its batch shard against every expert, gathered whole
    (``_local_experts``), y placed as x; the aux loss over the whole
    batch, its probabilities and choices placed by rows."""
    from torch.distributed.tensor import DTensor
    placed = isinstance(params.w_gate, DTensor)
    if placed:
        w = [_local_experts(getattr(params, n), x)
             for n in ("w_gate", "w_up", "w_down")]
        x, router, back, rows = _placed(params, x)
    else:
        router, w = params.router, (params.w_gate, params.w_up,
                                    params.w_down)
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    probs, topk_w, topk_idx = _route(router, xt, cfg.top_k)
    combine = torch.zeros_like(probs).scatter_(1, topk_idx, topk_w)
    y_e = _expert_ffn(*w, xt.unsqueeze(0).expand(cfg.n_experts, -1, -1))
    y = torch.einsum("end,ne->nd", y_e, combine.to(y_e.dtype))
    y = y.reshape(B, S, D)
    if not placed:
        return y, _aux_loss(probs, topk_idx, cfg.n_experts)
    return back(y), _aux_loss(rows(probs), rows(topk_idx), cfg.n_experts)


# ---------------------------------------------------------------------------
# expert-parallel modes over a DeviceMesh
# ---------------------------------------------------------------------------


def _collective(fn, *args, **kwargs):
    """An autograd-aware collective of ``torch.distributed.nn.functional``
    (newer torch marks the module deprecated; its functions still carry
    a backward, which the plain collectives do not)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kwargs)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """JAX's tiled ``all_to_all`` on axis 0: equal slabs of ``t``'s rows,
    slab j to rank j of ``group``; the result's slabs in source order."""
    t = t.contiguous()
    return _collective(dist_fn.all_to_all_single, torch.empty_like(t), t,
                       group=group)


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """JAX's tiled ``all_gather`` on axis 0: every rank's rows in rank
    order."""
    return torch.cat(_collective(dist_fn.all_gather, t.contiguous(),
                                 group=group), dim=0)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``psum`` over ``group``."""
    return _collective(dist_fn.all_reduce, t.contiguous(),
                       op=dist.ReduceOp.SUM, group=group)


def _axis(mesh, axes) -> str:
    """The one mesh dimension named by ``axes`` (a name or a 1-tuple)."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(names) != 1 or names[0] not in mesh.mesh_dim_names:
        raise ValueError(f"moe: model axis {axes} must name one "
                         f"dimension of the mesh {mesh.mesh_dim_names}")
    return names[0]


def _axis_size(mesh, axes) -> int:
    name = _axis(mesh, axes)
    return mesh.size(mesh.mesh_dim_names.index(name))


def _batch_mesh(mesh, batch_axes):
    """The 1-D mesh of the batch axes: one dimension of ``mesh``, or
    several flattened in order, major first (JAX's tiled collectives over
    a tuple of axes), as ``DeviceMesh._flatten`` lays them (cached by
    torch)."""
    names = (batch_axes,) if isinstance(batch_axes, str) else \
        tuple(batch_axes)
    if not names or any(n not in mesh.mesh_dim_names for n in names):
        raise ValueError(f"moe: batch axes {batch_axes} must name "
                         f"dimensions of the mesh {mesh.mesh_dim_names}")
    return mesh[names[0]] if len(names) == 1 else mesh[names]._flatten()


def _batch_mean(aux: torch.Tensor, mesh, batch_axes) -> torch.Tensor:
    """The mean over the batch shards of each shard's aux loss (JAX's
    ``jnp.mean`` over the batch-sharded ``aux[None]``)."""
    batch = _batch_mesh(mesh, batch_axes)
    return _all_reduce(aux, batch.get_group()) / batch.size()


def _capacity(cfg: ArchConfig, N: int) -> int:
    """Slots per expert: JAX's expression, evaluated in the same order."""
    return max(int(cfg.top_k * N / cfg.n_experts * cfg.capacity_factor), 4)


def _dispatch_local(xt: torch.Tensor, topk_w: torch.Tensor,
                    topk_idx: torch.Tensor, n_experts: int, capacity: int):
    """Pack tokens into per-expert slots (E, C) on this shard.  Returns
    (buffer (E*C, D), meta needed to undo the packing: ``order``,
    ``keep``, ``slot``, ``token_id``, ``weight``, as JAX's).

    The assignments are sorted by expert (stable), each takes the next
    slot of its expert, and those past ``capacity`` are dropped.  JAX adds
    every assignment into the buffer at its slot; the kept slots are
    unique and the dropped ones add zeros into slot 0, so writing the kept
    rows (the dropped ones into a spare row, cut off after) gives the same
    buffer without a sum."""
    N, D = xt.shape
    k = topk_idx.shape[1]
    M = N * k
    dev = xt.device
    flat_e = topk_idx.reshape(M)
    flat_w = topk_w.reshape(M)
    token_id = torch.arange(N, device=dev).repeat_interleave(k)

    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(M, device=dev) - first
    keep = pos_in_e < capacity
    slot = torch.where(keep, sorted_e * capacity + pos_in_e,
                       torch.zeros_like(pos_in_e))

    rows = n_experts * capacity
    vals = xt[token_id[order]] * keep[:, None].to(xt.dtype)
    dest = torch.where(keep, slot, torch.full_like(slot, rows))
    buf = xt.new_zeros((rows + 1, D)).index_put((dest,), vals)[:rows]
    meta = dict(order=order, keep=keep, slot=slot, token_id=token_id,
                weight=flat_w)
    return buf, meta


def _combine_local(buf_out: torch.Tensor, meta: dict, N: int
                   ) -> torch.Tensor:
    """Inverse of ``_dispatch_local``: (E*C, D) -> (N, D) weighted by the
    router.  Each assignment's row goes back to its place in token order
    (token n's k assignments at n*k .. n*k + k − 1) and a token's k rows
    are summed in that order."""
    order, keep, slot = meta["order"], meta["keep"], meta["slot"]
    weight = meta["weight"]
    M = order.numel()
    gathered = buf_out[slot] * keep[:, None].to(buf_out.dtype)
    w_sorted = weight[order].to(buf_out.dtype)
    contrib = gathered * w_sorted[:, None]
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(M, device=order.device))
    return contrib[inv].reshape(N, M // N, -1).sum(dim=1)


def _expert_slice(mesh, model_axis: str, n_experts: int):
    """(this rank's expert slice, ep, experts per rank)."""
    ep = _axis_size(mesh, model_axis)
    if n_experts % ep:
        raise ValueError(f"moe: {n_experts} experts over {ep} model ranks")
    e_loc = n_experts // ep
    m = mesh.get_local_rank(model_axis)
    return slice(m * e_loc, (m + 1) * e_loc), ep, e_loc


def _experts_round_trip(buf, w_gate, w_up, w_down, group, ep: int,
                        e_loc: int, capacity: int, reduce_group=None):
    """The dispatched buffer (E*C, D) to the experts' ranks, through the
    local experts (summed over ``reduce_group`` when given) and back."""
    D = buf.shape[-1]
    buf = _all_to_all(buf, group)       # rows grouped by source shard
    toks = buf.reshape(ep, e_loc, capacity, D).transpose(0, 1)
    out = _expert_ffn(w_gate, w_up, w_down,
                      toks.reshape(e_loc, ep * capacity, D))
    if reduce_group is not None:
        out = _all_reduce(out, reduce_group)
    out = out.reshape(e_loc, ep, capacity, D).transpose(0, 1)
    return _all_to_all(out.reshape(ep * e_loc * capacity, D), group)


# ---------------------------------------------------------------------------
# placed operands: the experts laid out by sharding/specs.py ``shard_params``
# ---------------------------------------------------------------------------


class _ShareGrad(torch.autograd.Function):
    """The identity, whose backward divides the gradient by ``n``: an
    expert's local weights serve the ``n`` model ranks' identical copies
    of a batch shard's tokens, so their gradients arrive ``n`` times."""

    @staticmethod
    def forward(ctx, w, n: int):
        ctx.n = n
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _batch_dims(x):
    """The mesh dims that cut a placed x's batch (dim 0)."""
    from torch.distributed.tensor import Shard
    return {d for d, p in enumerate(x.placements) if p == Shard(0)}


def _local_experts(w, x, model_axis=None, cut=None):
    """This rank's part of a placed expert tensor (E, ·, ·) for the placed
    tokens ``x``: the experts of its ``model_axis`` rank (every expert
    without one), and over ``cut`` = (mesh axis, tensor dim) its slice of
    that dim, whole over every other mesh dim.  Redistributed to that
    layout first: in the training layout (``_RULES_3D_MOE``) the
    all-gather over "data" of the FSDP cut, whose backward
    reduce-scatters the gradient; in the inference layout
    (``_RULES_3D_MOE_INFER``, the ``cut`` of ``moe_ep2d``) nothing moves.
    Its gradient is a partial sum over the mesh dims that cut x's batch,
    scaled by 1/ep for the ep copies of the tokens its experts see."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    batch = _batch_dims(x)
    want, grad = [], []
    for d, name in enumerate(mesh.mesh_dim_names):
        if name == model_axis:
            want.append(Shard(0))
        elif cut is not None and name == cut[0]:
            want.append(Shard(cut[1]))
        else:
            want.append(Replicate())
        grad.append(Partial() if d in batch and want[-1] == Replicate()
                    else want[-1])
    if list(w.placements) != want:
        w = w.redistribute(mesh, want)
    local = w.to_local(grad_placements=grad)
    ep = 1 if model_axis is None else _axis_size(mesh, model_axis)
    return _ShareGrad.apply(local, ep) if ep > 1 else local


def _placed(params: MoE, x):
    """(x's local part, the router's local tensor, a function that places
    a local output as x, one that places this shard's rows of a result
    as the rows of all the shards) of a placed MoE call.  The router's
    gradient is a partial sum over the mesh dims that cut the batch (each
    rank routes its shard) and whole over the others (their ranks route
    the same tokens)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    batch = _batch_dims(x)
    router = params.router.to_local(grad_placements=[
        Partial() if d in batch else Replicate() for d in range(mesh.ndim)])
    back = lambda y: DTensor.from_local(y, mesh, x.placements,
                                        run_check=False, shape=x.shape,
                                        stride=x.stride())
    rows = lambda t: DTensor.from_local(t, mesh, [
        Shard(0) if d in batch else Replicate() for d in range(mesh.ndim)],
        run_check=False)
    return x.to_local(), router, back, rows


def _mean_of_shards(rows, aux):
    """JAX's ``jnp.mean`` of the batch shards' aux losses, this shard's
    ``aux`` placed by ``rows``: their sum over the shards, then / their
    count (where the mean would be a partial average, which the loss's
    partial sums do not meet)."""
    vec = rows(aux.reshape(1))
    return vec.sum() / vec.shape[0]


def moe_ep(params: MoE, x: torch.Tensor, cfg: ArchConfig, mesh,
           batch_axes=("data",), model_axis: str = "model"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over ``mesh``.  x: this rank's batch shard (B,
    S, D); this rank runs its experts of the ``model`` axis.  One
    all-to-all pair per layer (dispatch and return).  Returns (y (B, S, D)
    in x's type, the aux loss averaged over the batch shards).

    Placed (``DTensor`` parameters laid out by ``shard_params``, x cut
    over the batch axes): the same on x's local part, with each expert
    tensor gathered over "data" to this rank's experts
    (``_local_experts``); y comes back placed as x, the aux loss as the
    mean of the placed per-shard losses."""
    from torch.distributed.tensor import DTensor
    if isinstance(params.w_gate, DTensor):
        x_loc, router, back, rows = _placed(params, x)
        w = [_local_experts(getattr(params, n), x, model_axis)
             for n in ("w_gate", "w_up", "w_down")]
        y, aux = _moe_ep_local(x_loc, router, w, cfg, mesh, model_axis)
        return back(y), _mean_of_shards(rows, aux)
    es, _, _ = _expert_slice(mesh, model_axis, cfg.n_experts)
    y, aux = _moe_ep_local(x, params.router,
                           [params.w_gate[es], params.w_up[es],
                            params.w_down[es]], cfg, mesh, model_axis)
    return y, _batch_mean(aux, mesh, batch_axes)


def _moe_ep_local(x, router, w, cfg: ArchConfig, mesh, model_axis: str):
    """``moe_ep`` on plain tensors: x this rank's batch shard, ``w`` its
    experts' (w_gate, w_up, w_down).  Returns (y, this shard's aux)."""
    _, ep, e_loc = _expert_slice(mesh, model_axis, cfg.n_experts)
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    N = xt.shape[0]
    probs, topk_w, topk_idx = _route(router, xt, cfg.top_k)
    aux = _aux_loss(probs, topk_idx, cfg.n_experts)
    capacity = _capacity(cfg, N)
    buf, meta = _dispatch_local(xt, topk_w, topk_idx, cfg.n_experts,
                                capacity)
    out = _experts_round_trip(buf, *w, mesh.get_group(model_axis),
                              ep, e_loc, capacity)
    y = _combine_local(out, meta, N)
    return y.reshape(B, S, D).to(x.dtype), aux


def moe_ep2d(params: MoE, x: torch.Tensor, cfg: ArchConfig, mesh,
             batch_axes=("data",), model_axis: str = "model",
             data_axis: str = "data") -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference MoE with the weights stationary: experts over
    ``model_axis``, each expert's FFN width over ``data_axis``.  The
    tokens move instead: gathered over the batch group, dispatched over
    ``model``, a partial-F expert product summed over ``data``, sent back,
    and this rank's rows kept.  x: this rank's batch shard (B, S, D).

    Placed (the inference layout of ``shard_params(inference=True)``):
    each expert tensor's local part is this rank's slice, with nothing
    moved (``_local_experts``); y comes back placed as x."""
    from torch.distributed.tensor import DTensor
    es, ep, e_loc = _expert_slice(mesh, model_axis, cfg.n_experts)
    fp = _axis_size(mesh, data_axis)
    if cfg.d_ff % fp:
        raise ValueError(f"moe: d_ff {cfg.d_ff} over {fp} data ranks")
    if isinstance(params.w_gate, DTensor):
        x_loc, router, back, rows = _placed(params, x)
        w = [_local_experts(getattr(params, n), x, model_axis,
                            (data_axis, dim))
             for n, dim in (("w_gate", 2), ("w_up", 2), ("w_down", 1))]
        y, aux = _moe_ep2d_local(x_loc, router, w, cfg, mesh, batch_axes,
                                 model_axis, data_axis)
        return back(y), _mean_of_shards(rows, aux)
    f_loc = cfg.d_ff // fp
    r = mesh.get_local_rank(data_axis)
    fs = slice(r * f_loc, (r + 1) * f_loc)
    y, aux = _moe_ep2d_local(
        x, params.router, [params.w_gate[es, :, fs], params.w_up[es, :, fs],
                           params.w_down[es, fs, :]],
        cfg, mesh, batch_axes, model_axis, data_axis)
    return y, _batch_mean(aux, mesh, batch_axes)


def _moe_ep2d_local(x, router, w, cfg: ArchConfig, mesh, batch_axes,
                    model_axis: str, data_axis: str):
    """``moe_ep2d`` on plain tensors: ``w`` this rank's (w_gate, w_up,
    w_down) slices.  Returns (y, the aux of the gathered tokens)."""
    _, ep, e_loc = _expert_slice(mesh, model_axis, cfg.n_experts)
    batch = _batch_mesh(mesh, batch_axes)
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    n_loc = xt.shape[0]
    xt_all = _all_gather(xt, batch.get_group())
    N = xt_all.shape[0]
    probs, topk_w, topk_idx = _route(router, xt_all, cfg.top_k)
    aux = _aux_loss(probs, topk_idx, cfg.n_experts)
    capacity = _capacity(cfg, N)
    buf, meta = _dispatch_local(xt_all, topk_w, topk_idx, cfg.n_experts,
                                capacity)
    out = _experts_round_trip(
        buf, *w, mesh.get_group(model_axis), ep, e_loc, capacity,
        reduce_group=mesh.get_group(data_axis))
    y_all = _combine_local(out, meta, N)
    shard = batch.get_local_rank()
    y = y_all[shard * n_loc:(shard + 1) * n_loc]
    return y.reshape(B, S, D).to(x.dtype), aux


def moe_apply(params: MoE, x: torch.Tensor, cfg: ArchConfig, runtime=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``moe_apply``: ``moe_ep`` or ``moe_ep2d`` on the runtime's
    mesh by its ``moe_mode``, else ``moe_dense``."""
    if runtime is not None and runtime.mesh is not None:
        if runtime.moe_mode == "ep":
            return moe_ep(params, x, cfg, runtime.mesh, runtime.batch_axes,
                          runtime.model_axis)
        if runtime.moe_mode == "ep2d":
            return moe_ep2d(params, x, cfg, runtime.mesh, runtime.batch_axes,
                            runtime.model_axis)
    return moe_dense(params, x, cfg)
