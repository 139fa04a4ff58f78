"""Parameters of the JAX package → the port's modules and tensors.

The JAX package keeps parameters as nested dicts and lists of arrays;
the bridge takes them as numpy arrays (``np.asarray`` of each leaf on the
JAX side — no JAX is imported here) and:

* ``load_unet`` copies a ``core/unet.py`` parameter tree into a UNet
  module: HWIO conv kernels become OIHW, ``(in, out)`` dense weights
  become ``nn.Linear``'s ``(out, in)``, GroupNorm ``scale``/``bias``
  become ``weight``/``bias``; ``None`` attention slots stay ``None``.
* ``load_dit`` copies a ``core/dit.py`` parameter tree into a DiT
  module the same way, with its layer stacks unstacked; a bare array
  (``pos``, ``A_log``, an RMSNorm ``scale``, an MoE block's
  ``moe.{router, w_gate, w_up, w_down}``, which the port keeps in JAX's
  (d, E) / (E, d, F) / (E, F, d) layouts) goes into the parameter of the
  same name without a transpose, and bf16 leaves come in exactly through
  float32.
* ``unstack`` splits params stacked on a leading client axis k (the
  JAX package's stacked-clients layout) into k per-client trees.
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


def _copy(param: torch.Tensor, value: np.ndarray, name: str) -> None:
    value = np.array(value, copy=True)
    if value.dtype.name == "bfloat16":       # ml_dtypes: exact in float32
        value = value.astype(np.float32)
    if tuple(param.shape) != value.shape:
        raise ValueError(f"{name}: module {tuple(param.shape)} vs "
                         f"params {value.shape}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(value))


def _load(module: nn.Module, tree, name: str) -> None:
    if tree is None or module is None:
        if (tree is None) != (module is None):
            raise ValueError(f"{name}: None slot on one side only")
        return
    if isinstance(module, torch.Tensor):        # a bare parameter
        _copy(module, _check_numpy(tree), name)
    elif isinstance(module, nn.Conv2d):
        _copy(module.weight, _check_numpy(tree["w"]).transpose(3, 2, 0, 1),
              name + ".w")
        _copy(module.bias, _check_numpy(tree["b"]), name + ".b")
    elif isinstance(module, nn.Linear):
        _copy(module.weight, _check_numpy(tree).T, name)
    elif isinstance(tree, dict) and set(tree) == {"scale", "bias"}:
        _copy(module.weight, _check_numpy(tree["scale"]), name + ".scale")
        _copy(module.bias, _check_numpy(tree["bias"]), name + ".bias")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            child = module[k] if isinstance(module, nn.ModuleDict) \
                else getattr(module, k)
            _load(child, v, f"{name}.{k}")
    elif isinstance(tree, (list, tuple)):
        if len(tree) != len(module):
            raise ValueError(f"{name}: {len(tree)} entries vs "
                             f"{len(module)} modules")
        for i, v in enumerate(tree):
            _load(module[i], v, f"{name}[{i}]")
    else:
        raise TypeError(f"{name}: cannot load {type(tree).__name__} into "
                        f"{type(module).__name__}")


def load_params(model: nn.Module, params) -> nn.Module:
    """Copy a JAX-layout parameter tree (numpy leaves) into the module of
    the same layout in place; every parameter of the module must be
    covered."""
    _load(model, params, "params")
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
    leaves) into a ``core.dit.DiT`` in place.  The layer stacks
    (``mamba``, ``layers``) carry a leading layer axis in JAX
    (``stacked_init``); they are unstacked into the module's layer lists.
    Every parameter of the module must be covered."""
    tree = dict(params)
    for stack in ("mamba", "layers"):
        if stack in tree:
            tree[stack] = unstack(tree[stack])
    return load_params(model, tree)
