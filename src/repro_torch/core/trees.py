"""Parameter and optimizer-state trees of the port.

The JAX package keeps a model's parameters as a pytree and maps over its
leaves; the port keeps a model as an ``nn.Module`` (or, for a toy
denoiser, a dict of tensors) and an AdamW state as ``{"m": {name:
tensor}, "v": {name: tensor}, "step": tensor}``.  These helpers give both
kinds one tree view:

* ``leaves`` in a fixed order: a module's ``named_parameters()`` order, a
  dict's values by sorted key (``jax.tree.leaves``' order, so a dict
  tree's leaf i is JAX's leaf i), lists and tuples in order;
* ``tree_map`` builds a new tree of the first tree's kind: a module is
  deep-copied and its parameters overwritten, a dict leaf that required
  grad does so again (a toy model stays trainable);
* ``unflatten`` (a template's layout, given leaves), ``copy``
  (independent tensors), ``equal`` (bitwise), ``stack`` /
  ``unstack`` (a leading client axis: the JAX package's stacked-clients
  view of k models, for parity checks and checkpoints).
"""
from __future__ import annotations

import copy as _copy
from typing import Any, Callable, List

import torch
import torch.nn as nn


def _items(tree):
    """(key, child) pairs of a container in leaf order."""
    if isinstance(tree, nn.Module):
        return list(tree.named_parameters())
    if isinstance(tree, dict):
        return sorted(tree.items(), key=lambda kv: kv[0])
    return list(enumerate(tree))


def leaves(tree) -> List[torch.Tensor]:
    """Every tensor of ``tree`` in leaf order (``None`` has none)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for _, v in _items(tree) for x in leaves(v)]


def _like(src, out):
    if isinstance(src, torch.Tensor) and src.requires_grad and \
            out is not src:
        return out.detach().requires_grad_(True)
    return out


@torch.no_grad()
def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of ``rest`` (trees of the
    same layout), as ``jax.tree.map``; see the module docstring for what
    a module or a trainable dict leaf becomes."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return _like(tree, fn(tree, *rest))
    if isinstance(tree, nn.Module):
        out = _copy.deepcopy(tree)
        others = [dict(r.named_parameters()) if isinstance(r, nn.Module)
                  else r for r in rest]
        for name, p in out.named_parameters():
            p.copy_(fn(p, *(o[name] for o in others)))
        return out
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return tree


@torch.no_grad()
def unflatten(template, new_leaves):
    """A tree of ``template``'s kind and layout whose leaves, in leaf
    order, are ``new_leaves`` (a module is deep-copied and overwritten)."""
    it = iter(new_leaves)
    out = _fill(template, it)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the template has")
    return out


def _fill(tree, it):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return _like(tree, next(it))
    if isinstance(tree, nn.Module):
        out = _copy.deepcopy(tree)
        for _, p in out.named_parameters():
            p.copy_(next(it))
        return out
    if isinstance(tree, dict):
        filled = {k: _fill(v, it) for k, v in _items(tree)}
        return {k: filled[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, it) for v in tree)
    return tree


def copy(tree):
    """An independent copy: every tensor cloned, a module deep-copied."""
    if isinstance(tree, nn.Module):
        return _copy.deepcopy(tree)
    return tree_map(lambda x: x.detach().clone(), tree)


def equal(a, b) -> bool:
    """Bitwise equality of two trees' leaves (and of their leaf counts)."""
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and
        torch.equal(x.detach().cpu(), y.detach().cpu())
        for x, y in zip(la, lb))


def as_tree(tree):
    """A module as its ``{name: tensor}`` parameter dict (detached);
    anything else as it is."""
    if isinstance(tree, nn.Module):
        return {n: p.detach() for n, p in tree.named_parameters()}
    return tree


def stack(trees: List[Any]):
    """k trees of one layout → one tree with a leading (k,) axis on every
    leaf (a module as its parameter dict)."""
    trees = [as_tree(t) for t in trees]
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack([t.detach() for t in trees])
    if isinstance(first, dict):
        return {k: stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack([t[i] for t in trees])
                           for i in range(len(first)))
    raise TypeError(f"stack: cannot stack {type(first).__name__}")


def unstack(stacked, n: int) -> List[Any]:
    """The inverse of ``stack``: the i-th slice of every leaf, i < n."""
    if isinstance(stacked, torch.Tensor):
        return [stacked[i] for i in range(n)]
    if isinstance(stacked, dict):
        parts = {k: unstack(v, n) for k, v in stacked.items()}
        return [{k: parts[k][i] for k in stacked} for i in range(n)]
    if isinstance(stacked, (list, tuple)):
        parts = [unstack(v, n) for v in stacked]
        return [type(stacked)(p[i] for p in parts) for i in range(n)]
    raise TypeError(f"unstack: cannot unstack {type(stacked).__name__}")
