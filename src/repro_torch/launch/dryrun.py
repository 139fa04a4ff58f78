"""Multi-pod dry run on the meta device: reckon every (architecture ×
input shape × mesh) pair's step without running it.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape train_4k [--multi-pod] [--moe-mode ep|dense]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The port of the JAX package's ``launch/dryrun.py``, with its flags.  JAX
lowers and compiles each pair on 256 or 512 forced host devices, and
XLA's SPMD pass partitions it; this runs rank 0's program of the pair on
the ``meta`` device (shapes and types, nothing computed) over the
production mesh of a fake process group (launch/mesh.py
``make_production_mesh``), partitioned by ``DTensor`` as JAX's SPMD pass
partitions it (``placed_operands``: every pair's parameters, AdamW
moments, batch or token and decode state laid out by their specs, the
decode pairs' weights in the inference layout), and records per
pair:

* ``flops``: the floating-point operations of rank 0's step — aten's
  products and convolutions (``FlopCounterMode``'s formulas) plus the
  kernels'
  (``kernels.FLOPS``: on meta a kernel's launch returns empty outputs of
  the card's shapes and counts its operations); ``aten_flops`` and
  ``kernel_flops`` by kernel beside it; a ``DTensor`` op is counted on
  the local parts it dispatches;
* ``bytes_per_device`` (``params``, ``opt_state``, ``batch``,
  ``decode_state``, ``total``): over every input leaf, its bytes divided
  by the product of the sizes of the axes its sanitized spec names
  (sharding/specs.py); over a ``DeviceMesh``, the bytes of the placed
  operands' local parts, which are the same;
* ``saved_activation_bytes``: the storages autograd saves for the
  backward (``saved_tensors_hooks``; each storage once, parameters
  apart, ``saved_param_bytes``), ``per_device`` as rank 0 saves them and
  ``global`` over the batch shards;
* ``collectives``: the census (count and bytes of the buffers each
  writes) of the collectives rank 0 issues, by the reference's op names:
  the c10d ops dispatched over the fake group (the MoE's expert-parallel
  all-to-all, all-gather and all-reduce, and the all-reduces of decode
  attention over a cache cut by its slots) and the functional
  collectives that ``DTensor``'s redistributions dispatch (all-gathers,
  reduce-scatters and all-reduces; the record says ``"partitioner":
  "dtensor"``, the collab pairs, launch/collab_dryrun.py, ``null``);
  ``collective_bytes`` is their sum and
  ``collective_bound_s`` that sum over the card's NVLink rate
  (launch/mesh.py ``NVLINK_BW``), the least time rank 0's collectives
  take on its links;
* ``n_params``, ``n_active_params``, ``trace_s``.

Rank 0's program: the pair's step on its placed operands (the batch over
"pod" and "data"; the weights over "model" and, except at decode, over
"data"; caches over "model" by their heads, or by their slots where
"model" does not divide the K/V heads).  MoE pairs run ``moe_ep``
(``moe_ep2d`` at decode) on the experts' local parts over the fake
group's process groups, or ``moe_dense`` with ``--moe-mode dense``.
Records go to
``experiments/dryrun_torch/<tag>.json``, apart from the reference's
``experiments/dryrun/``.  ``reckon`` does the same for any mesh; over a
mesh of axis sizes alone (no process group) the step runs on its batch
shard with every other operand whole, the MoE dense.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, List, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels
from repro_torch.configs.base import ARCH_IDS, SHAPES, get_arch
from repro_torch.launch import shapes as SH
from repro_torch.launch.mesh import NVLINK_BW, make_production_mesh
from repro_torch.models import api
from repro_torch.models.transformer import CPU
from repro_torch.optim.adamw import init_opt_state
from repro_torch.sharding import specs as S

OUT_DIR = "experiments/dryrun_torch"

# c10d's op names -> the reference's census names
COLLECTIVE_NAMES = {
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
}
# the functional collectives' (``_c10d_functional``, which ``DTensor``
# dispatches) -> the same names
FUNCTIONAL_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}


def tensor_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts / lists (an ``nn.Module``'s
    parameters); anything else is skipped."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def device_bytes(tree, mesh) -> int:
    """Bytes a device holds of a tree of abstract leaves: each leaf's
    global bytes over the product of its spec's axis sizes."""
    return sum(t.numel() * t.element_size() // S.shards(t.spec, mesh)
               for t in tensor_leaves(tree))


def run_operands(tree, mesh):
    """Rank 0's operands of a tree of abstract leaves: meta tensors cut
    over the mesh's batch axes alone (the port shards the batch; a
    rank's caches hold all their heads and positions)."""
    axes = S.mesh_batch_axes(mesh)

    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        return torch.empty(S.local_shape(t.shape, t.spec, mesh, axes),
                           dtype=t.dtype, device="meta")
    return _map(one, tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _group_norm(x, weight, bias, N, C, HxW, group, eps):
    stat = torch.empty((N, group), dtype=x.dtype, device=x.device)
    return torch.empty_like(x), stat, torch.empty_like(stat)


def _group_norm_backward(dout, x, mean, rstd, weight, N, C, HxW, group,
                         mask):
    param = lambda: torch.empty((C,), dtype=x.dtype, device=x.device)
    return (torch.empty_like(x) if mask[0] else None,
            param() if mask[1] else None, param() if mask[2] else None)


# ops whose meta kernel is a slow Python decomposition (group norm and its
# backward, ~2 and ~5 ms a call: most of a meta U-Net step), answered from
# their shapes: the decomposition's output shapes and types
_META_SHAPES = {torch.ops.aten.native_group_norm.default: _group_norm,
                torch.ops.aten.native_group_norm_backward.default:
                    _group_norm_backward}

# FlopCounterMode's rule: these queries are neither run nor counted here
_QUERIES = {torch.ops.aten.sym_is_contiguous.default,
            torch.ops.aten.is_contiguous.default,
            torch.ops.aten.is_contiguous.memory_format,
            torch.ops.aten.is_strides_like_format.default,
            torch.ops.aten.is_non_overlapping_and_dense.default,
            torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
            torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
            torch.ops.aten.storage_offset.default,
            torch.ops.aten.sym_storage_offset.default,
            torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
            torch.ops.aten.dim.default, torch.ops.prim.layout.default}


_DECOMPOSES: Dict[Any, bool] = {}


def _decomposes(func) -> bool:
    """Whether ``func.decompose`` runs a decomposition (a
    CompositeImplicitAutograd kernel), cached by op."""
    if func not in _DECOMPOSES:
        key = torch._C.DispatchKey.CompositeImplicitAutograd
        _DECOMPOSES[func] = func is not torch.ops.prim.device.default and (
            key in func.py_kernels or
            torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), key))
    return _DECOMPOSES[func]


_FUNCTIONAL: Dict[Any, bool] = {}
_META_OUT: Dict[Any, Any] = {}


def _functional(func) -> bool:
    """Whether ``func`` neither mutates nor aliases (its outputs are new
    tensors), cached by op."""
    if func not in _FUNCTIONAL:
        schema = func._schema
        _FUNCTIONAL[func] = not schema.is_mutable and all(
            r.alias_info is None for r in schema.returns)
    return _FUNCTIONAL[func]


def _key(a):
    """A hashable key of an op's argument; None where it has none (a
    tensor off the meta device ends the caching of that call)."""
    if isinstance(a, torch.Tensor):
        if not a.is_meta:
            raise TypeError
        return (tuple(a.shape), a.stride(), a.dtype, a.storage_offset())
    if isinstance(a, (list, tuple)):
        return tuple(_key(x) for x in a)
    if isinstance(a, dict):
        return tuple((k, _key(v)) for k, v in sorted(a.items()))
    hash(a)
    return (type(a), a)


def _rebuild(spec):
    if isinstance(spec, tuple) and spec and spec[0] == "T":
        return torch.empty_strided(spec[1], spec[2], dtype=spec[3],
                                   device="meta")
    if isinstance(spec, list):
        return [_rebuild(x) for x in spec]
    if isinstance(spec, tuple):
        return tuple(_rebuild(x) for x in spec)
    return spec


def _spec(out):
    if isinstance(out, torch.Tensor):
        return ("T", tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, list):
        return [_spec(x) for x in out]
    if isinstance(out, tuple):
        return tuple(_spec(x) for x in out)
    return out


def _meta_cached(func, args, kwargs):
    """``func(*args, **kwargs)``; for a functional op on meta tensors its
    outputs' shapes, strides and types are looked up by its arguments'
    (torch's meta kernels of elementwise ops are Python references, ~0.1
    ms a call; a U-Net step repeats the same few hundred calls)."""
    if not _functional(func):
        return func(*args, **kwargs)
    try:
        key = (func, _key(args), _key(kwargs))
    except TypeError:            # off the meta device, or unhashable
        return func(*args, **kwargs)
    spec = _META_OUT.get(key)
    if spec is None:
        out = func(*args, **kwargs)
        if all(t.is_meta for t in tensor_leaves(out)):
            _META_OUT[key] = _spec(out)
        return out
    return _rebuild(spec)


class StepCounters(TorchDispatchMode):
    """One dispatch mode for the step's counts:

    * ``flops``: aten's, by ``FlopCounterMode``'s own rules (its
      ``flop_registry``, and an op without a formula decomposed first),
      without its module tracker, which costs more than a meta op;
    * ``census``: per op, the collectives dispatched and the bytes of the
      buffers each writes (a c10d op's first argument, a functional
      collective's output), by the reference's names;

    and on the meta device the ops of ``_META_SHAPES`` answered from their
    shapes.  An op on ``DTensor``s is handed back to ``DTensor``
    (``NotImplemented``, as ``CommDebugMode`` does), whose local ops and
    collectives then come here: rank 0's own work.  The ops its sharding
    propagation runs on fake tensors of the global shapes (for the
    output's metadata) run uncounted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.census: Dict[str, Dict[str, int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES or any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry and _decomposes(func):
            with self:
                return func.decompose(*args, **kwargs)
        fast = _META_SHAPES.get(func)
        if fast is not None and args[0].is_meta:
            out = fast(*args, **kwargs)
        else:
            out = _meta_cached(func, args, kwargs)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif func.namespace == "c10d" and args:
            self._count(COLLECTIVE_NAMES.get(packet.__name__,
                                             packet.__name__), args[0])
        elif packet.__name__ in FUNCTIONAL_NAMES and \
                func.namespace == "_c10d_functional":
            self._count(FUNCTIONAL_NAMES[packet.__name__], out)
        return out

    def _count(self, op: str, written) -> None:
        c = self.census.setdefault(op, {"count": 0, "bytes": 0})
        c["count"] += 1
        c["bytes"] += sum(t.numel() * t.element_size()
                          for t in tensor_leaves(written))


class SavedBytes:
    """Bytes of the distinct storages autograd saves for the backward
    while active (``saved_tensors_hooks``): a storage saved twice, or
    through two views, counts once; parameters' apart.  A ``DTensor``
    counts its local part's storage."""

    def __init__(self):
        self.activation_bytes = self.param_bytes = 0
        self._seen = {}

    def _pack(self, t):
        local = t._local_tensor if isinstance(t, DTensor) else t
        storage = local.untyped_storage()
        if storage._cdata not in self._seen:
            self._seen[storage._cdata] = t       # keeps the storage alive
            base = t if t._base is None else t._base
            if base.is_leaf and base.requires_grad:
                self.param_bytes += storage.nbytes()
            else:
                self.activation_bytes += storage.nbytes()
        return t

    def __enter__(self):
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, lambda t: t)
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self._seen.clear()
        return self._hooks.__exit__(*exc)


def measure(fn, args) -> dict:
    """Run ``fn(*args)`` once under the counters (``StepCounters``,
    ``SavedBytes``; grad off but where the step enables it); returns its
    FLOPs (aten's plus the kernels'), saved bytes, census and wall
    time."""
    kernels.reset_flops()
    t0 = time.perf_counter()
    with StepCounters() as counts, SavedBytes() as saved, torch.no_grad():
        fn(*args)
    trace_s = time.perf_counter() - t0
    kflops = dict(kernels.FLOPS)
    coll = sum(c["bytes"] for c in counts.census.values())
    return {"trace_s": round(trace_s, 3),
            "flops": counts.flops + sum(kflops.values()),
            "aten_flops": counts.flops, "kernel_flops": kflops,
            "saved_activation_bytes": saved.activation_bytes,
            "saved_param_bytes": saved.param_bytes,
            "collectives": counts.census, "collective_bytes": coll,
            "collective_bound_s": coll / NVLINK_BW}


def local_bytes(tree) -> int:
    """Bytes this rank holds of a tree of operands: each ``DTensor``'s
    local part, any other tensor whole."""
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel() *
               t.element_size() for t in tensor_leaves(tree))


def placed_operands(cfg, shape, mesh, args):
    """({part: operands}, the step's arguments) of rank 0 with the pair's
    operands laid out on ``mesh`` (a ``DeviceMesh``) as ``DTensor``s:
    the meta model's parameters by ``shard_params`` (the inference
    layout for a decode pair), AdamW moments following them, the batch
    or token by ``shard_batch`` / its spec, the decode state by
    ``shard_decode_state``.  ``args``: ``input_specs``'s stand-ins."""
    decode = shape.kind == "decode"
    model = S.shard_params(api.empty_params(cfg, "meta"), mesh,
                           inference=decode)
    if decode:
        _, token, _, pos = args
        B = shape.global_batch
        token = S.place(mesh, token, token.spec)
        state = S.shard_decode_state(mesh, cfg, B, api.init_decode_state(
            cfg, B, shape.seq_len, device="meta"))
        return ({"params": model, "opt_state": None, "batch": token,
                 "decode_state": state}, (model, token, state, pos))
    batch = S.shard_batch(mesh, args[-1])
    opt = init_opt_state(model) if shape.kind == "train" else None
    return ({"params": model, "opt_state": opt, "batch": batch,
             "decode_state": None},
            (model, batch) if opt is None else (model, opt, batch))


def batch_cut_operands(shape, args, mesh):
    """({part: abstract operands}, the step's arguments) of rank 0 with
    the batch, the token and the decode state cut over the mesh's batch
    axes alone (``run_operands``), the parameters and AdamW state whole.
    ``args``: ``input_specs``'s stand-ins."""
    if shape.kind == "train":
        params, opt, batch = args
        return ({"params": params, "opt_state": opt, "batch": batch,
                 "decode_state": None},
                (params, whole(opt), run_operands(batch, mesh)))
    if shape.kind == "prefill":
        params, batch = args
        return ({"params": params, "opt_state": None, "batch": batch,
                 "decode_state": None},
                (params, run_operands(batch, mesh)))
    params, token, state, pos = args
    return ({"params": params, "opt_state": None, "batch": token,
             "decode_state": state},
            (params, run_operands(token, mesh), run_operands(state, mesh),
             pos))


def reckon(cfg, shape, mesh, runtime=None) -> dict:
    """The dry run's record of ``cfg`` at ``shape`` (a ``ShapeConfig``
    or its name) on ``mesh``: its abstract inputs' bytes per device and
    rank 0's step on the meta device under the counters.  ``runtime``
    defaults to ``runtime_for`` the mesh over a ``DeviceMesh`` and to
    ``CPU`` (no mesh, MoE dense) over a mesh of axis sizes alone.  Over a
    ``DeviceMesh`` the step runs on ``DTensor`` operands
    (``placed_operands``); over axis sizes alone on its batch shard,
    every other operand whole."""
    shape = SH.shape_of(shape)
    fake = getattr(mesh, "mesh_dim_names", None) is not None
    if runtime is None:
        runtime = SH.runtime_for(cfg, shape, mesh) if fake else CPU
    args = SH.input_specs(cfg, shape, mesh)
    batch = args[1] if shape.kind == "decode" else args[-1]  # or the token
    first = tensor_leaves(batch)[0]
    batch_shards = S.shards(first.spec[:1], mesh, S.mesh_batch_axes(mesh))
    if fake:
        parts, run = placed_operands(cfg, shape, mesh, args)
        per_part = {k: local_bytes(v) for k, v in parts.items()}
    else:
        parts, run = batch_cut_operands(shape, args, mesh)
        per_part = {k: device_bytes(v, mesh) for k, v in parts.items()}
    per_part["total"] = sum(per_part.values())
    rec = measure(SH.step_fn(cfg, shape, runtime), run)
    act = rec.pop("saved_activation_bytes")
    rec.update(bytes_per_device=per_part,
               saved_activation_bytes={"per_device": act,
                                       "global": act * batch_shards},
               partitioner="dtensor" if fake else None,
               moe_mode=runtime.moe_mode if cfg.n_experts else None,
               n_params=cfg.n_params(), n_active_params=cfg.n_active_params())
    return rec


def whole(tree):
    """Plain meta tensors of the global shapes (the AdamW state every
    rank holds whole); host tensors as they are."""
    return _map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
                if isinstance(t, torch.Tensor) and t.is_meta else t, tree)


def mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_pair(arch_name: str, shape_name: str, multi_pod: bool,
             moe_mode: str = "ep", out_dir: str = OUT_DIR,
             mesh=None) -> dict:
    """One pair's record, written to ``out_dir/<tag>.json``; ``mesh``
    defaults to a new production mesh (which needs a process without a
    group)."""
    cfg = get_arch(arch_name)
    shape = SH.shape_of(shape_name)
    tag = f"{cfg.name}__{shape.name}__{mesh_tag(multi_pod)}"
    reason = SH.skip_reason(cfg, shape)
    if reason is not None:
        print(f"SKIP {tag}: {reason}")
        return {"tag": tag, "status": "skip", "reason": reason}
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod)
    runtime = (SH.runtime_for(cfg, shape, mesh) if moe_mode == "ep"
               else SH.make_runtime(mesh, moe_mode=moe_mode))
    rec = {"tag": tag, "status": "ok", "arch": cfg.name, "shape": shape.name,
           "mesh": mesh_tag(multi_pod), "n_devices": mesh.size(),
           **reckon(cfg, shape, mesh, runtime)}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    counts = {k: v["count"] for k, v in rec["collectives"].items()}
    print(f"OK   {tag}: trace={rec['trace_s']:.1f}s flops={rec['flops']:.4g} "
          f"bytes/device={rec['bytes_per_device']['total']:.4g} "
          f"saved/device={rec['saved_activation_bytes']['per_device']:.4g} "
          f"coll={rec['collective_bytes']:.4g}B ({counts})")
    return rec


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--moe-mode", default="ep", choices=["ep", "dense"])
    ap.add_argument("--out", default=OUT_DIR)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[dict]:
    args = parse(argv)
    if args.all:
        pairs = [(a, s) for a in ARCH_IDS for s in SHAPES]
    elif args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    else:
        raise SystemExit("--arch/--shape or --all required")
    mesh = make_production_mesh(args.multi_pod)
    records, failures = [], []
    for a, s in pairs:
        try:
            records.append(run_pair(a, s, args.multi_pod, args.moe_mode,
                                    args.out, mesh))
        except Exception as e:   # a failure here is a fault of the port
            failures.append((a, s, repr(e)))
            print(f"FAIL {a} {s}: {e}")
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: "
                         f"{[(a, s) for a, s, _ in failures]}")
    return records


if __name__ == "__main__":
    main()
