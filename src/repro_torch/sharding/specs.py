"""Partition rules: parameter, optimizer, input and state specs.

The port of the JAX package's ``sharding/specs.py``.  A spec is a tuple
with one entry per tensor dim, each entry as in JAX's ``PartitionSpec``:
``None`` (replicated), a mesh axis name, or a tuple of names (the dim
cut over several axes, major first).

Mesh axes (launch/mesh.py): ``("data", "model")`` single pod (16 × 16)
or ``("pod", "data", "model")`` multi-pod (2 × 16 × 16).  The batch
shards over ("pod", "data"); tensor-parallel weights over "model"; FSDP
(ZeRO-style) weight and optimizer sharding over "data".  A mesh is a
``DeviceMesh`` or anything whose ``.shape`` is a dict of axis sizes (the
reference tests' ``FakeMesh``), so per-device bytes can be reckoned with
no process group at all (``axis_sizes``).

The rules are JAX's, by name and rank over JAX's parameter tree:

  embed (V,D)          -> ("model", None)        vocab-parallel
  unembed (D,V)        -> (None, "model")
  wq/wk/wv (D,H·dh)    -> ("data", "model")      Megatron in-proj + FSDP
  wo (H·dh, D)         -> ("model", "data")      Megatron out-proj + FSDP
  w_gate/w_up (D,F)    -> ("data", "model")
  w_down (F,D)         -> ("model", "data")
  MoE experts (E,D,F)  -> ("model", "data", None) expert-parallel + FSDP
  MoE w_down (E,F,D)   -> ("model", None, "data")
  router (D,E)         -> replicated (fp32)
  mamba z/x/dt_proj    -> ("data", "model")      heads/channels over model
  mamba bc_proj (D,2N) -> ("data", None)         B,C shared across heads
  mamba out_proj (di,D)-> ("model", "data")      partial-sum + all-reduce
  norms / scalars      -> replicated

A port parameter's spec comes from JAX's rule through the bridge's own
per-parameter layout (``bridge.param_layouts``, the table the copy
uses): JAX's stacked layer axis (``layers``, ``mamba``, ``enc_layers``,
``dec_layers``) is unstacked into per-layer modules, so its leading
``None`` is dropped, and the dims are permuted as the bridge permutes
them (``nn.Linear`` stores JAX's (in, out) as (out, in); conv kernels
HWIO as OIHW).  Decode-state leaves are per layer in the port, so their
specs are JAX's without the leading stack entries.  Optimizer moments
inherit the parameter specs.

Applying them (``shard_params``, ``shard_batch``, ``shard_decode_state``,
``place``): a tensor laid out by a spec is a ``DTensor`` whose
placements are the sanitized spec's (``placements``), the counterpart of
a ``jax.Array`` with a ``NamedSharding``; models/transformer.py
``constrain`` pins activations the same way, and ``pin`` lays a tensor's
gradient out as the tensor.  ``shard_params(inference=True)`` and
``shard_decode_state`` are the decode layout: weights tensor-parallel
only, MoE experts by ``_RULES_3D_MOE_INFER`` (models/moe.py
``moe_ep2d``), caches by ``kv_cache_spec`` (heads over "model" where it
divides them, else the sequence), SSM states by ``ssm_state_specs``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import bridge

Spec = Tuple[Any, ...]

# leaf-name -> spec for 2D weights (non-stacked form, JAX's layout)
_RULES_2D = {
    "wq": ("data", "model"), "wk": ("data", "model"),
    "wv": ("data", "model"), "wo": ("model", "data"),
    "w_gate": ("data", "model"), "w_up": ("data", "model"),
    "w_down": ("model", "data"),
    "w1": ("data", "model"), "w2": ("model", "data"),
    "z_proj": ("data", "model"), "x_proj": ("data", "model"),
    "dt_proj": ("data", "model"), "bc_proj": ("data", None),
    "out_proj": ("model", "data"),
    "time": (None, None),
}

_RULES_3D_MOE = {
    "w_gate": ("model", "data", None), "w_up": ("model", "data", None),
    "w_down": ("model", None, "data"),
}

# inference layout (moe_ep2d): expert FFN dim over "data" so decode never
# all-gathers expert weights — see models/moe.moe_ep2d.
_RULES_3D_MOE_INFER = {
    "w_gate": ("model", None, "data"), "w_up": ("model", None, "data"),
    "w_down": ("model", "data", None),
}


def _entry(axes: Tuple[str, ...]):
    """A spec entry naming ``axes``: None, a name, or a tuple of two or
    more (as ``PartitionSpec`` normalises a 1-tuple to its name)."""
    return None if not axes else axes[0] if len(axes) == 1 else tuple(axes)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mesh whose ``.shape``
    is such a dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _drop_data(spec: Spec) -> Spec:
    """Inference layout: weights tensor-parallel only — drop the FSDP
    "data" factor (at decode the per-layer weight all-gather dwarfs the
    few tokens of useful traffic)."""
    out = []
    for e in spec:
        if e == "data":
            out.append(None)
        elif isinstance(e, tuple):
            out.append(_entry(tuple(a for a in e if a != "data")))
        else:
            out.append(e)
    return tuple(out)


def param_spec_for(names: Tuple[str, ...], ndim: int,
                   inference: bool = False) -> Spec:
    """JAX's spec of the leaf at path ``names`` (its dict keys, "[i]" for
    a list entry) of JAX's rank ``ndim`` (the stacked axis counted)."""
    name = names[-1] if names else ""
    stacked = bridge.is_stacked(names)
    base_nd = ndim - 1 if stacked else ndim

    if name in ("embed", "tok_embed"):
        return ("model", None)
    if name == "unembed":
        return (None, "model")
    if name == "router":
        return (None, None, None) if stacked else (None, None)

    spec = None
    if base_nd == 3 and name in _RULES_3D_MOE:
        spec = (_RULES_3D_MOE_INFER if inference else _RULES_3D_MOE)[name]
    elif base_nd == 2 and name in _RULES_2D:
        spec = _RULES_2D[name]
        if inference:
            spec = _drop_data(spec)
    if spec is None:
        spec = (None,) * base_nd
    if stacked:
        spec = (None,) + spec
    if len(spec) != ndim:
        raise ValueError(f"{names}: spec {spec} for rank {ndim}")
    return spec


def port_spec(jax_spec: Spec, stacked: bool, layout: str) -> Spec:
    """A JAX parameter spec in the port's layout: the stacked layer
    entry dropped, the dims permuted as ``bridge.PERM[layout]``."""
    spec = tuple(jax_spec[1:] if stacked else jax_spec)
    perm = bridge.PERM[layout]
    return spec if perm is None else tuple(spec[i] for i in perm)


def param_specs(model, inference: bool = False) -> Dict[str, Spec]:
    """{parameter name: spec} of a module (``named_parameters()``
    order)."""
    layouts = bridge.param_layouts(model)
    out = {}
    for name, p in model.named_parameters():
        path, layout = layouts[name]
        stacked = bridge.is_stacked(path)
        jax_spec = param_spec_for(path, p.ndim + stacked, inference)
        out[name] = port_spec(jax_spec, stacked, layout)
    return out


def opt_state_specs(model) -> Dict[str, Any]:
    ps = param_specs(model)
    return {"m": ps, "v": ps, "step": ()}


# ---------------------------------------------------------------------------
# Stacked-client axis (the vectorized CollaFuse engine, core/collab.py)
# ---------------------------------------------------------------------------

CLIENT_AXIS = "clients"


def client_stacked_specs(stacked_params, inference: bool = False,
                         client_axis: str = CLIENT_AXIS):
    """Specs for a client-stacked parameter tree (a leading (n_clients,)
    axis on every leaf): shard ONLY the stack axis — k identical-shape
    models train as pure model parallelism over clients."""
    del inference
    return bridge.tree_map(
        lambda leaf: (client_axis,) + (None,) * (leaf.ndim - 1),
        stacked_params)


def client_opt_specs(stacked_params, client_axis: str = CLIENT_AXIS):
    """AdamW moments follow the stacked parameter specs; the per-client
    ``step`` is a (n_clients,) vector sharded over the client axis."""
    ps = client_stacked_specs(stacked_params, client_axis=client_axis)
    return {"m": ps, "v": ps, "step": (client_axis,)}


def client_batch_spec(ndim: int, client_axis: str = CLIENT_AXIS) -> Spec:
    """Round inputs xs / ys / mask are (n_batches, n_clients, B, ...):
    shard the client axis (dim 1), replicate the batch loop's dim."""
    return (None, client_axis) + (None,) * (ndim - 2)


def cohort_uid_spec(client_axis: str = CLIENT_AXIS) -> Spec:
    """The (tier,) registry-uid vector of an identity-keyed cohort round:
    one id per cohort slot, so it shards with the slot axis."""
    return (client_axis,)


def sample_stack_spec(ndim: int, lead_axis: str = CLIENT_AXIS,
                      batch_axis: str = "data") -> Spec:
    """Sampling-engine stacks are (G|R, B, ...): the group/request lead
    axis over "clients", the request batch over "data"."""
    return (lead_axis, batch_axis) + (None,) * (ndim - 2)


def sample_plan_specs(tables):
    """Specs of a ``sample_plan.PlanTables``, as the same NamedTuple."""
    return type(tables)(
        group_y=sample_stack_spec(tables.group_y.ndim),
        group_t=(CLIENT_AXIS, None),
        group_t_prev=(CLIENT_AXIS, None),
        group_active=(CLIENT_AXIS, None),
        group_seed=(CLIENT_AXIS,),
        request_group=(CLIENT_AXIS,),
        request_client=(CLIENT_AXIS,),
        request_seed=(CLIENT_AXIS,),
        client_t=(CLIENT_AXIS, None),
        client_t_prev=(CLIENT_AXIS, None),
        client_active=(CLIENT_AXIS, None))


def inject_specs(inject):
    """Specs of a ``sample_plan.InjectTables`` (cache-hit handoffs
    entering the engine): laid out like the scanned stacks."""
    return type(inject)(x=sample_stack_spec(inject.x.ndim),
                        y=sample_stack_spec(inject.y.ndim))


def handoff_spec(ndim: int, batch_axis: str = "data") -> Spec:
    """One cached server handoff (B, ...): batch over "data"."""
    return (batch_axis,) + (None,) * (ndim - 1)


# ---------------------------------------------------------------------------
# Placement on a mesh: the five ``shard_*`` functions of the reference.
# A placed operand is a ``DTensor`` (the counterpart of a ``jax.Array``
# with a ``NamedSharding``): its spec, sanitized against its shape, gives
# one placement per mesh dim, and its local part is this rank's slice.
# Every rank holds the whole host value (the same seed, the same plan),
# so placing moves no data; the engines read the layout off the operands.
# ---------------------------------------------------------------------------


def placements(spec: Spec, mesh):
    """The ``DTensor`` placements of a sanitized spec: ``Shard(i)`` on the
    mesh dim that tensor dim i names, ``Replicate()`` elsewhere.  A dim
    cut over several axes (the multi-pod batch, ``("pod", "data")``) is
    ``Shard(i)`` on each of their mesh dims; ``DTensor`` cuts the earlier
    mesh dim first, so the spec must name them in the mesh's order, major
    first, as JAX reads the tuple."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        dims = [names.index(a) for a in
                (entry if isinstance(entry, tuple) else (entry,))]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: {entry} is not in the mesh's "
                             f"order {names}")
        for d in dims:
            out[d] = Shard(i)
    return out


def distribute(t: torch.Tensor, mesh, pl, copy: bool = False):
    """``t`` (whole on every rank) as a ``DTensor`` of placements ``pl``
    on ``mesh``: its local part this rank's slice, taken without
    communication (a view, or a copy of its own with ``copy``)."""
    from torch.distributed.tensor import DTensor
    local = t
    for d, p in enumerate(pl):
        if p.is_shard():
            local = local.chunk(mesh.size(d), dim=p.dim)[
                mesh.get_local_rank(d)]
    if copy and local.numel() != t.numel():
        local = local.clone()
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def place(mesh, value, spec: Spec, copy: bool = False):
    """``value`` (a tensor or a numpy array, whole on every rank) laid out
    on ``mesh`` by ``spec`` sanitized against its shape: a ``DTensor`` on
    the mesh's device type (a meta tensor stays on meta) whose local part
    is this rank's slice, taken without communication (``distribute``).
    A dim the mesh does not divide stays replicated, as in JAX."""
    t = torch.from_numpy(np.ascontiguousarray(value)) \
        if isinstance(value, np.ndarray) else value
    if t.device.type not in (mesh.device_type, "meta"):
        t = t.to(mesh.device_type)
    pl = placements(sanitize_spec(spec, tuple(t.shape), mesh), mesh)
    return distribute(t, mesh, pl, copy)


class _Pin(torch.autograd.Function):
    """Redistribute a ``DTensor`` to ``placements``, and its gradient to
    the same placements: ``with_sharding_constraint`` is its own
    transpose in JAX.  (``redistribute``'s own backward hands a partial
    sum back as it is, and ``DTensor`` then meets a partial gradient at
    the next product by gathering the whole weight.)"""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


def pin(x, placements):
    """A ``DTensor`` and, in the backward, its gradient laid out by
    ``placements``."""
    return _Pin.apply(x, tuple(placements))


def mesh_kinds(t, batch=None, cut=None):
    """What each mesh dim does to a placed operand ``t``: ``"batch"``
    where it cuts ``t``'s dim ``batch``, ``"cut"`` where it cuts dim
    ``cut`` (the heads, channels or rows a kernel treats one by one),
    None elsewhere."""
    from torch.distributed.tensor import Shard
    return ["batch" if batch is not None and p == Shard(batch) else
            "cut" if cut is not None and p == Shard(cut) else None
            for p in t.placements]


def local_map_placements(kinds, *dims):
    """``local_map``'s placements over a mesh whose dims do ``kinds``
    (``mesh_kinds``), for operands and outputs each given as its (batch
    dim, cut dim), None where it has no such dim.  Returns, for each, its
    (placements, gradient placements): ``Shard`` of its own dim where a
    mesh dim cuts a dim it has; whole elsewhere, where over a mesh dim
    that cuts the others its gradient, or an output's value, is a partial
    sum over that dim's ranks."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    out = []
    for batch, cut in dims:
        pl, grad = [], []
        for kind in kinds:
            dim = {"batch": batch, "cut": cut, None: None}[kind]
            pl.append(Replicate() if dim is None else Shard(dim))
            grad.append(Partial() if kind is not None and dim is None
                        else pl[-1])
        out.append((pl, grad))
    return out


def shard_params(model, mesh, inference: bool = False):
    """Lay a module's parameters out on ``mesh`` in place, the
    counterpart of JAX's ``device_put`` over ``with_sharding(param_specs
    (...))``: each becomes an ``nn.Parameter`` holding a ``DTensor``
    placed by its sanitized ``param_specs`` entry, its local part a copy
    of this rank's slice.  AdamW moments made after it
    (optim/adamw.py ``init_opt_state``) follow each parameter's
    placements, which is ``opt_state_specs``.  Returns the module."""
    import torch.nn as nn
    specs = param_specs(model, inference)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        placed = place(mesh, p.detach(), specs[name], copy=True)
        mod._parameters[leaf] = nn.Parameter(placed,
                                             requires_grad=p.requires_grad)
    return model


def shard_batch(mesh, batch):
    """A batch ({name: tensor}, each with the batch leading) laid out on
    ``mesh`` by ``batch_spec_for``: the batch over ("pod", "data") where
    they divide it, replicated otherwise."""
    return {k: place(mesh, t, batch_spec_for(mesh, t.shape[0], t.ndim - 1))
            for k, t in batch.items()}


def shard_decode_state(mesh, cfg, global_batch: int, state):
    """A decode state (the port's per-layer lists of caches and SSM
    states) laid out on ``mesh`` by ``decode_state_specs``, each leaf's
    spec sanitized against its shape as ``with_sharding`` does: a plain
    leaf placed (its local part a copy of this rank's slice), a placed
    one (a prefill's) redistributed to that layout.  Returns the new
    tree; the given one is not changed."""
    from torch.distributed.tensor import DTensor

    def one(leaf, spec):
        spec = sanitize_spec(spec, tuple(leaf.shape), mesh)
        if isinstance(leaf, DTensor):
            return leaf.redistribute(mesh, placements(spec, mesh))
        return place(mesh, leaf, spec, copy=True)
    return zip_map(one, state,
                   decode_state_specs(mesh, cfg, global_batch, state))


def local_part(t):
    """(this rank's part, mesh, sharded tensor dim or None) of a placed
    operand; ``(t, None, None)`` for anything else."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t, None, None
    dims = [p.dim for p in t.placements if p.is_shard()]
    return t.to_local(), t.device_mesh, (dims[0] if dims else None)


# bytes this rank handed to each kind of collective of the sharded
# engines (a buffer's size, whatever the world size): core/collab.py's
# all_reduce and broadcast, and ``gather``'s all_gather
COMM_BYTES: Dict[str, int] = {}


def count_bytes(kind: str, t: torch.Tensor) -> None:
    COMM_BYTES[kind] = COMM_BYTES.get(kind, 0) + t.numel() * t.element_size()


def gather(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Every rank's part of a tensor cut along ``dim`` over ``mesh``'s
    (1-D) ranks, concatenated in rank order: the whole tensor."""
    import torch.distributed as dist
    group = mesh.get_group()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    count_bytes("all_gather", t)
    return torch.cat(parts, dim=dim)


def whole(t):
    """The whole value of a placed operand (``gather`` where it is cut);
    anything else as it is."""
    local, mesh, dim = local_part(t)
    return local if dim is None else gather(local, mesh, dim)


def shard_round_batches(mesh, xs, ys, mask=None):
    """Place padded round stacks (n_batches, k, B, ...) and their validity
    mask on ``mesh`` with the client axis (dim 1) sharded: a (client,
    batch) cell and its validity always live on the same rank."""
    put = lambda a: place(mesh, a, client_batch_spec(np.ndim(a)))
    return put(xs), put(ys), None if mask is None else put(mask)


def shard_cohort_round(mesh, xs, ys, mask, uids):
    """Place one federated round's operands (train/rounds.py's padded
    cohort stacks and the (tier,) uid vector) on ``mesh``: a cohort slot,
    its validity and its uid always live on the same rank."""
    xs, ys, mask = shard_round_batches(mesh, xs, ys, mask)
    return xs, ys, mask, place(mesh, uids, cohort_uid_spec())


def slot_owners(mesh, n_slots: int):
    """The clients-axis rank that owns each of ``n_slots`` stacked slots
    (slot c on rank c // (n_slots / world)), or None when the mesh does
    not divide them and every rank holds every slot."""
    spec = sanitize_spec(client_opt_specs({})["step"], (n_slots,), mesh)
    if spec[0] is None:
        return None
    per = n_slots // axis_sizes(mesh)[CLIENT_AXIS]
    return [c // per for c in range(n_slots)]


def shard_vectorized_state(state, mesh):
    """Lay a ``core.collab.VectorizedCollabState`` on ``mesh``: the server
    model and AdamW state replicated, the client slots over the
    ``clients`` axis (``client_stacked_specs`` / ``client_opt_specs``).
    The port keeps one module a slot on every rank, so this records the
    mesh and each slot's owning rank (``state.owners``, None when
    replicated); ``train_round_vectorized`` then updates each slot on its
    owner and sends it to every rank."""
    state.mesh = mesh
    state.owners = slot_owners(mesh, state.n_clients)
    return state


def _place_tuple(mesh, tree, spec_tree):
    return type(tree)(*(place(mesh, a, s) for a, s in zip(tree, spec_tree)))


def shard_sample_plan(mesh, tables):
    """Place a ``sample_plan.PlanTables`` on ``mesh`` with the sampling
    specs: the group and request axes over "clients" where it divides
    them, each on its own."""
    return _place_tuple(mesh, tables, sample_plan_specs(tables))


def shard_inject(mesh, inject):
    """Place a plan's injected cache-hit rows (``InjectTables``) on
    ``mesh``, laid out like the scanned stacks."""
    return _place_tuple(mesh, inject, inject_specs(inject))


def make_client_mesh(n_clients: int, device=None):
    """A 1-D ``("clients",)`` ``DeviceMesh`` over the first ranks of the
    process group, as many as the largest count that divides
    ``n_clients`` (one rank, set up as ``launch.mesh.make_debug_mesh``
    does, where no group exists), on ``device``'s type (CUDA unless asked
    otherwise)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch.mesh import ensure_group
    dev = ensure_group(device)
    use = max(d for d in range(1, dist.get_world_size() + 1)
              if n_clients % d == 0)
    return DeviceMesh(dev.type, torch.arange(use),
                      mesh_dim_names=(CLIENT_AXIS,))


# ---------------------------------------------------------------------------
# Activations / inputs
# ---------------------------------------------------------------------------


def mesh_batch_axes(mesh) -> Tuple[str, ...]:
    """The mesh's batch axes, of ``("pod", "data")``, in that order."""
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def batch_axis_size(mesh) -> int:
    """How many shards the batch is cut into: the product of the batch
    axes' sizes."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in mesh_batch_axes(mesh))


def batch_spec_for(mesh, global_batch: int, trailing: int) -> Spec:
    """Shard the leading batch dim over ("pod", "data") when divisible,
    else replicate (long_500k has global_batch = 1)."""
    if global_batch % batch_axis_size(mesh) == 0:
        return (_entry(mesh_batch_axes(mesh)),) + (None,) * trailing
    return (None,) * (trailing + 1)


def _batch_entry(mesh, global_batch: int):
    return _entry(mesh_batch_axes(mesh)) \
        if global_batch % batch_axis_size(mesh) == 0 else None


def _heads_ok(cfg, mesh) -> bool:
    return bool(cfg.n_kv_heads) and \
        cfg.n_kv_heads % axis_sizes(mesh)["model"] == 0


def kv_cache_spec(mesh, cfg, global_batch: int) -> Spec:
    """One layer's cache (B, Hkv, C, dh) (JAX stacks a leading layer
    axis).  Heads over "model" when divisible, else the sequence dim over
    "model"; batch over ("pod", "data") when divisible."""
    b = _batch_entry(mesh, global_batch)
    if _heads_ok(cfg, mesh):
        return (b, "model", None, None)
    return (b, None, "model", None)


def ssm_state_specs(mesh, cfg, global_batch: int, state_tree) -> Any:
    """The hybrid/SSM decode state (per-layer lists): each Mamba2 layer's
    ``ssm`` (B, H, P, N) with heads over "model" when divisible and
    ``conv`` (B, K, C), and the shared block's ring caches ``k`` / ``v``
    as ``kv_cache_spec``; batch over ("pod", "data") when divisible."""
    b = _batch_entry(mesh, global_batch)
    model = axis_sizes(mesh)["model"]

    def rule(name, leaf):
        if name == "ssm":
            h_ok = cfg.ssm_n_heads % model == 0
            return (b, "model" if h_ok else None, None, None)
        if name == "conv":
            return (b, None, None)
        if name in ("k", "v"):
            return kv_cache_spec(mesh, cfg, global_batch)
        return (None,) * leaf.ndim

    return _map_named(rule, state_tree)


def decode_state_specs(mesh, cfg, global_batch: int, state_tree) -> Any:
    """Specs of a decode state: ``ssm_state_specs`` for the SSM families,
    else every cache (``k`` / ``v``, the encoder-decoder's ``cross_k`` /
    ``cross_v``) as ``kv_cache_spec``."""
    if cfg.family in ("ssm", "hybrid"):
        return ssm_state_specs(mesh, cfg, global_batch, state_tree)
    kv = kv_cache_spec(mesh, cfg, global_batch)
    return _map_named(lambda name, leaf: kv if name in (
        "k", "v", "cross_k", "cross_v") else (None,) * leaf.ndim,
        state_tree)


def _map_named(fn, tree, name: str = ""):
    """``fn(dict key of the leaf, leaf)`` over nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, name) for v in tree)
    return fn(name, tree)


def sanitize_spec(spec: Spec, shape, mesh) -> Spec:
    """Drop mesh axes from dims they don't evenly divide (e.g. vocab
    51,865 on a 16-way axis) and axes the mesh doesn't have (a
    clients-only mesh has no "data" / "model")."""
    sizes = axis_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept = tuple(a for a in axes if a in sizes)
        if not kept or shape[i] % math.prod(sizes[a] for a in kept):
            out.append(None)
        else:
            out.append(_entry(kept))
    return tuple(out)


def shards(spec: Spec, mesh, axes=None) -> int:
    """Into how many pieces a (sanitized) spec cuts its tensor: the
    product of the sizes of the axes it names (of ``axes`` only, when
    given)."""
    sizes = axis_sizes(mesh)
    n = 1
    for entry in spec:
        for a in (() if entry is None else
                  entry if isinstance(entry, tuple) else (entry,)):
            if axes is None or a in axes:
                n *= sizes[a]
    return n


def local_shape(shape, spec: Spec, mesh, axes) -> Tuple[int, ...]:
    """The shape of one shard of a tensor laid out by ``spec`` and cut
    over the mesh axes ``axes`` only."""
    return tuple(d // shards((e,), mesh, axes) for d, e in zip(shape, spec))


def with_sharding(tree, spec_tree, mesh):
    """Meta stand-ins for the tensors of ``tree`` laid out by
    ``spec_tree`` on ``mesh``: meta tensors of the global shapes, each
    with its spec sanitized against its shape attached as ``.spec``."""
    def one(leaf, spec):
        out = torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")
        out.spec = sanitize_spec(spec, leaf.shape, mesh)
        return out
    return zip_map(one, tree, spec_tree)


def zip_map(fn, tree, spec_tree):
    """``fn(leaf, spec)`` over a tree (dicts, lists, NamedTuples) and its
    spec tree; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, spec_tree[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(zip_map(fn, v, s)
                            for v, s in zip(tree, spec_tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(zip_map(fn, v, s) for v, s in zip(tree, spec_tree))
    return fn(tree, spec_tree)
