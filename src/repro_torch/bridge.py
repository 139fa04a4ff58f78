"""Parameters of the JAX package → the port's modules and tensors.

The JAX package keeps parameters as nested dicts and lists of arrays;
the bridge takes them as numpy arrays (``np.asarray`` of each leaf on the
JAX side — no JAX is imported here) and:

* ``load_unet`` copies a ``core/unet.py`` parameter tree into a UNet
  module: HWIO conv kernels become OIHW, ``(in, out)`` dense weights
  become ``nn.Linear``'s ``(out, in)``, GroupNorm ``scale``/``bias``
  become ``weight``/``bias`` (a LayerNorm keeps JAX's ``scale`` and
  ``bias``); ``None`` attention slots stay ``None``.
* ``load_dit`` copies a ``core/dit.py`` parameter tree into a DiT
  module the same way, with its layer stacks unstacked; a bare array
  (``pos``, ``A_log``, an RMSNorm ``scale``, an MoE block's
  ``moe.{router, w_gate, w_up, w_down}``, which the port keeps in JAX's
  (d, E) / (E, d, F) / (E, F, d) layouts) goes into the parameter of the
  same name without a transpose, and bf16 leaves come in exactly through
  float32.
* ``load_params`` also copies the evaluation nets (eval/: the FD
  proxy's feature-net tuple, the reconstructor's and the classifier's
  dicts), whose bare HWIO kernels become bias-free OIHW convs;
  ``load_dit`` also copies a language model or the encoder-decoder
  (models/api.init_params: the DiT's stacks ``layers`` / ``mamba``, the
  encoder-decoder's ``enc_layers`` / ``dec_layers``, the embedding (V,
  D) as it is).
* ``unstack`` splits params stacked on a leading client axis k (the
  JAX package's stacked-clients layout) into k per-client trees.
* ``load_opt_state`` turns a JAX AdamW state (``{"m", "v", "step"}``)
  into the port's for a module through the same transforms, and
  ``dump_params`` / ``dump_opt_state`` go back to the JAX layout.
* ``to_torch`` turns any numpy tree (e.g. a toy denoiser's ``{"a", "b"}``)
  into the same tree of tensors on a device.
"""
from __future__ import annotations

from typing import Any, List

import numpy as np
import torch
import torch.nn as nn


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of nested dicts/lists/tuples; ``None``
    stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def leaves(tree) -> List[Any]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def _check_numpy(a) -> np.ndarray:
    if not isinstance(a, (np.ndarray, np.generic)):
        raise TypeError(f"bridge takes numpy arrays, got {type(a).__name__}")
    return np.asarray(a)


def unstack(tree) -> List[Any]:
    """Stacked (k, ...) leaves → a list of k per-client trees."""
    ls = [_check_numpy(a) for a in leaves(tree)]
    if not ls:
        raise ValueError("unstack: empty parameter tree")
    k = ls[0].shape[0]
    return [tree_map(lambda a, i=i: _check_numpy(a)[i], tree)
            for i in range(k)]


def to_torch(tree, device=None):
    """numpy tree → tensor tree on ``device`` (dtypes kept)."""
    return tree_map(
        lambda a: torch.as_tensor(np.array(_check_numpy(a)), device=device),
        tree)


# A leaf's layout: as it is, an HWIO conv kernel (the port's OIHW), or a
# dense (in, out) weight (nn.Linear's (out, in)).  PERM[layout][i] is the
# JAX dim that the port's dim i holds: the copy transposes by it, and
# sharding/specs.py permutes a JAX spec by it.
PERM = {"as_is": None, "hwio": (3, 2, 0, 1), "dense": (1, 0)}
_TO_PORT = {k: (lambda a, p=p: a if p is None else a.transpose(p))
            for k, p in PERM.items()}
_TO_JAX = {k: (lambda a, p=p: a if p is None else
               a.transpose(tuple(np.argsort(p))))
           for k, p in PERM.items()}


def _copy(param: torch.Tensor, value: np.ndarray, layout: str,
          name: str) -> None:
    value = np.array(_TO_PORT[layout](_check_numpy(value)), copy=True)
    if value.dtype.name == "bfloat16":       # ml_dtypes: exact in float32
        value = value.astype(np.float32)
    if tuple(param.shape) != value.shape:
        raise ValueError(f"{name}: module {tuple(param.shape)} vs "
                         f"params {value.shape}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(value))


# the stacked layer axes of core/dit.py, the LMs and the encoder-decoder
STACKS = ("mamba", "layers", "enc_layers", "dec_layers")


def is_stacked(path) -> bool:
    """Whether a JAX parameter path lies in a stacked layer subtree."""
    return any(n in STACKS for n in path[:-1]) or \
        (bool(path) and path[0] in STACKS)


def param_layouts(model: nn.Module) -> dict:
    """{parameter name: (JAX path, layout)} of a module, by the rules of
    ``_walk``: an ``nn.Linear``'s weight is its JAX dense leaf, an
    ``nn.Embedding``'s its (V, D) leaf as it is, a bias-free ``nn.Conv2d``
    its HWIO kernel, a biased one ``{w, b}``, a GroupNorm's ``weight`` /
    ``bias`` JAX's ``scale`` / ``bias``, a bare parameter its own name.
    The path holds JAX's dict keys and "[i]" for a list entry; the entries
    of a stacked layer list (``STACKS``) share their stack's path, as JAX
    stacks them on a leading axis."""
    out = {}

    def visit(module, path, prefix):
        if isinstance(module, nn.Embedding):
            out[prefix + "weight"] = (path, "as_is")
        elif isinstance(module, nn.Linear):
            out[prefix + "weight"] = (path, "dense")
        elif isinstance(module, nn.Conv2d) and module.bias is None:
            out[prefix + "weight"] = (path, "hwio")
        elif isinstance(module, nn.Conv2d):
            out[prefix + "weight"] = (path + ("w",), "hwio")
            out[prefix + "bias"] = (path + ("b",), "as_is")
        else:
            for n, _ in module.named_parameters(recurse=False):
                key = "scale" if n == "weight" else n
                out[prefix + n] = (path + (key,), "as_is")
            for n, child in module.named_children():
                if n.isdigit():
                    sub = path if path and path[-1] in STACKS \
                        else path + (f"[{n}]",)
                else:
                    sub = path + (n,)
                visit(child, sub, prefix + n + ".")

    visit(model, (), "")
    return out


def _walk(module, tree, name: str, leaf):
    """Walk a module and a JAX-layout tree of the same layout together,
    calling ``leaf(param, value, layout, name)`` for every parameter;
    returns the tree of what ``leaf`` returned."""
    if tree is None or module is None:
        if (tree is None) != (module is None):
            raise ValueError(f"{name}: None slot on one side only")
        return None
    if isinstance(module, torch.Tensor):        # a bare parameter
        return leaf(module, tree, "as_is", name)
    if isinstance(module, nn.Embedding):        # (V, D) in both layouts
        return leaf(module.weight, tree, "as_is", name)
    if isinstance(module, nn.Conv2d) and module.bias is None:
        return leaf(module.weight, tree, "hwio", name)   # a bare kernel
    if isinstance(module, nn.Conv2d):
        return {"w": leaf(module.weight, tree["w"], "hwio", name + ".w"),
                "b": leaf(module.bias, tree["b"], "as_is", name + ".b")}
    if isinstance(module, nn.Linear):
        return leaf(module.weight, tree, "dense", name)
    if isinstance(tree, dict) and set(tree) == {"scale", "bias"} and \
            hasattr(module, "weight"):        # GroupNorm's torch names
        return {"scale": leaf(module.weight, tree["scale"], "as_is",
                              name + ".scale"),
                "bias": leaf(module.bias, tree["bias"], "as_is",
                             name + ".bias")}
    if isinstance(tree, dict):
        return {k: _walk(module[k] if isinstance(module, nn.ModuleDict)
                         else getattr(module, k), v, f"{name}.{k}", leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if len(tree) != len(module):
            raise ValueError(f"{name}: {len(tree)} entries vs "
                             f"{len(module)} modules")
        return [_walk(module[i], v, f"{name}[{i}]", leaf)
                for i, v in enumerate(tree)]
    raise TypeError(f"{name}: cannot load {type(tree).__name__} into "
                    f"{type(module).__name__}")


def _unstack_layers(params):
    """A DiT tree with its layer stacks (a leading layer axis in JAX,
    ``stacked_init``) split into lists; any other tree as it is."""
    if not isinstance(params, dict):
        return params
    tree = dict(params)
    for stack in STACKS:
        if stack in tree:
            tree[stack] = unstack(tree[stack])
    return tree


def _stack(trees: List[Any]):
    """The inverse of ``unstack``: k trees of one layout → one tree with a
    leading (k,) axis on every leaf."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees])
                           for i in range(len(first)))
    return np.stack(trees)


def _restack_layers(tree):
    if not isinstance(tree, dict):
        return tree
    tree = dict(tree)
    for stack in STACKS:
        if stack in tree:
            tree[stack] = _stack(tree[stack])
    return tree


def load_opt_state(model: nn.Module, state) -> dict:
    """A JAX AdamW state (``{"m": tree, "v": tree, "step"}``, numpy
    leaves, the layout of ``model``'s JAX parameter tree) → the port's
    state for ``model`` (optim/adamw.py: float32 moments by parameter
    name, the step an int32 0-dim host tensor), through the layout
    transforms of ``load_params`` (HWIO → OIHW, dense transposes, DiT
    stacks unstacked), on each parameter's device."""
    names = {id(p): n for n, p in model.named_parameters()}

    def moments(tree, which: str) -> dict:
        out = {}

        def put(param, value, layout, name):
            a = _TO_PORT[layout](_check_numpy(value)).astype(np.float32)
            if tuple(param.shape) != a.shape:
                raise ValueError(f"{name}: module {tuple(param.shape)} vs "
                                 f"moment {a.shape}")
            out[names[id(param)]] = torch.from_numpy(np.ascontiguousarray(
                a)).to(param.device)

        _walk(model, _unstack_layers(tree), which, put)
        if set(out) != set(names.values()):
            raise ValueError(f"{which}: the tree does not cover the module")
        return {n: out[n] for n in names.values()}

    return {"m": moments(state["m"], "m"), "v": moments(state["v"], "v"),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32)}


def dump_params(model: nn.Module, like, values=None):
    """The JAX-layout tree of ``model``'s parameters (numpy leaves), laid
    out as ``like`` (a JAX parameter tree of the same model: its leaves
    are not read, only its layout), in float32.  With ``values``
    ({name: tensor}, e.g. an AdamW moment) the tree holds those tensors
    instead."""
    names = {id(p): n for n, p in model.named_parameters()}

    def get(param, _, layout, name):
        t = param if values is None else values[names[id(param)]]
        return _TO_JAX[layout](t.detach().float().cpu().numpy())

    return _restack_layers(_walk(model, _unstack_layers(like), "params",
                                 get))


def dump_opt_state(model: nn.Module, state, like) -> dict:
    """The inverse of ``load_opt_state``: the port's AdamW state of
    ``model`` as a JAX-layout ``{"m", "v", "step"}`` of numpy arrays laid
    out as ``like``."""
    return {"m": dump_params(model, like, state["m"]),
            "v": dump_params(model, like, state["v"]),
            "step": np.int32(int(state["step"]))}


def load_params(model: nn.Module, params) -> nn.Module:
    """Copy a JAX-layout parameter tree (numpy leaves) into the module of
    the same layout in place; every parameter of the module must be
    covered."""
    _walk(model, params, "params", _copy)
    n_tree = sum(_check_numpy(a).size for a in leaves(params))
    n_model = sum(p.numel() for p in model.parameters())
    if n_tree != n_model:
        raise ValueError(f"params hold {n_tree} values, module {n_model}")
    return model


def load_unet(model: nn.Module, params) -> nn.Module:
    """Copy a JAX-layout U-Net parameter tree (numpy leaves) into
    ``model`` in place; every parameter of the module must be covered."""
    return load_params(model, params)


def load_dit(model: nn.Module, params) -> nn.Module:
    """Copy a JAX-layout DiT parameter tree (core/dit.init_dit, numpy
    leaves) into a ``core.dit.DiT`` in place, or a language model's
    (models/api.init_params) into its module.  The layer stacks
    (``STACKS``) carry a leading layer axis in JAX
    (``stacked_init``); they are unstacked into the module's layer lists.
    Every parameter of the module must be covered."""
    return load_params(model, _unstack_layers(params))
