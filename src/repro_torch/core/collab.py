"""Multi-client CollaFuse (paper §4: k = 5 clients, one trusted server):
the configuration, the denoiser of a collaboration, the two training
engines of Alg. 1 and a client's sample (Alg. 2).

The port of the JAX package's ``core/collab.py``.  ``denoiser`` is
``"unet"`` (the paper's U-Net, SMALL resized) or an architecture id,
served through the DiT bridge at the same reduced widths as in JAX
(``configs.base.reduced``): the MoE ids (``"dbrx-132b"``,
``"kimi-k2-1t-a32b"``) give reduced MoE DiTs of 4 experts, top-2, as
JAX's do.

**Sequential** (``setup`` + ``train_round``): Alg. 1's outer loops
verbatim, for each client, for each batch, one step, with the keys
chained by ``split`` in client-major order as in the reference.

**Vectorized** (``setup_vectorized`` + ``train_round_vectorized``,
``make_vectorized_round``): the reference's one-program round, with its
semantics and key discipline: per batch b the key ``fold_in(round_key,
b)``, per client slot ``fold_in(batch_key, c)`` (or the slot's registry
uid, ``identity_keyed``), per sample ``fold_in(draw_key, i)`` inside the
protocol; each slot's client update on its own model, then ONE server
AdamW step on the concatenated payloads of the batch.  The JAX package
vmaps the slots and scans the batches inside one jit; eager PyTorch has
neither, so the port loops over batches and slots in Python:

* each slot keeps its own model (one ``nn.Module`` a client) and its
  own AdamW state, updated in place; the "stacked" state
  (``stack_clients``) is a view built when asked, for parity checks and
  checkpoints.  A slot's bits depend only on its own inputs, never on
  the tier it sits in;
* the (n_batches, k, B) validity mask is a host numpy array, so "an
  all-zero cell keeps its params, moments and step" is decided on the
  host without a device sync: such a cell is not computed at all (the
  reference computes it and ``where``-selects the old state back);
* the server batch holds the payload rows of weight > 0, at most k·B of
  them, weighted by the flattened mask.  A row of weight 0 adds exactly
  zero to the weighted loss and its gradient, so leaving it out is the
  reference's update; keeping it would make every reduction over the
  batch (torch's sums group their terms by length) depend on how many
  padded slots the tier added.

``train_round_reference`` is the differential oracle of the same
semantics written the plain way: every slot computed, every payload row
in the server batch at its weight.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.configs.ddpm_unet import SMALL, UNetConfig
from repro_torch.core import prng, trees
from repro_torch.core.dit import DiTConfig, init_dit, make_dit_apply
from repro_torch.core.protocol import (ServerPayload, _grads, client_keys,
                                       client_losses, make_collab_step,
                                       server_loss)
from repro_torch.core.sampler import collaborative_sample
from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.core.splitting import CutPoint
from repro_torch.core.unet import init_unet, unet_apply
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamWConfig, adamw_update, \
    init_opt_state, named
from repro_torch.sharding.specs import count_bytes, gather, local_part, \
    shard_round_batches, whole


@dataclasses.dataclass(frozen=True)
class CollabConfig:
    n_clients: int = 5           # paper §4
    T: int = 1000                # paper §4.1
    t_cut: int = 200
    denoiser: str = "unet"       # "unet" | an architecture id (DiT bridge)
    image_size: int = 16
    channels: int = 3
    n_classes: int = 8
    batch_size: int = 8          # paper §4.1
    lr: float = 1e-3             # paper §4.1
    schedule: str = "linear"
    unet: Optional[UNetConfig] = None       # defaults to SMALL resized
    dit_patch: int = 4

    def cut(self) -> CutPoint:
        return CutPoint(self.T, self.t_cut)

    def sched(self, device=None) -> DiffusionSchedule:
        mk = (DiffusionSchedule.linear if self.schedule == "linear"
              else DiffusionSchedule.cosine)
        return mk(self.T, device=device)

    def image_shape(self, batch: Optional[int] = None):
        b = batch or self.batch_size
        return (b, self.image_size, self.image_size, self.channels)


@dataclasses.dataclass
class CollabState:
    """The server's model and each client's, their AdamW states and the
    number of Alg.-1 steps taken (the reference's fields, in its order).
    A state that only samples may hold ``None`` for the optimizer
    states; ``train_round`` refuses it."""
    server_params: Any
    server_opt: Optional[Dict]
    client_params: List[Any]
    client_opt: Optional[List[Dict]]
    step: int = 0


def build_denoiser(key, cfg: CollabConfig, device=None
                   ) -> Tuple[Callable, Callable]:
    """(init_one_model_fn(key) -> model on ``device``, apply_fn)."""
    if cfg.denoiser == "unet":
        ucfg = cfg.unet or dataclasses.replace(
            SMALL, image_size=cfg.image_size, channels=cfg.channels,
            n_classes=cfg.n_classes)
        return (lambda k: init_unet(k, ucfg, device),
                lambda p, x, t, y: unet_apply(p, x, t, y, ucfg))
    arch = reduced(get_arch(cfg.denoiser))
    if arch.family == "audio":
        raise ValueError(
            "whisper-base is an enc-dec audio arch; CollaFuse's denoising "
            "split is inapplicable (DESIGN.md §Arch-applicability)")
    dit = DiTConfig(image_size=cfg.image_size, channels=cfg.channels,
                    patch_size=cfg.dit_patch, n_classes=cfg.n_classes)
    return (lambda k: init_dit(k, arch, dit, device),
            make_dit_apply(arch, dit))


def setup(key: torch.Tensor, cfg: CollabConfig, device=None
          ) -> Tuple[CollabState, Callable, Callable]:
    """(state, collab step fn, apply_fn): the server's model from
    ``split(key, k + 1)[0]`` and client c's from entry c + 1, fresh AdamW
    states, on ``device`` (CUDA unless asked otherwise)."""
    dev = resolve_device(device)
    init_one, apply_fn = build_denoiser(key, cfg, dev)
    ks, *kc = prng.split(key.to(dev), cfg.n_clients + 1)
    server_params = init_one(ks)
    client_params = [init_one(k) for k in kc]
    state = CollabState(
        server_params=server_params,
        server_opt=init_opt_state(server_params),
        client_params=client_params,
        client_opt=[init_opt_state(p) for p in client_params])
    opt_cfg = AdamWConfig(lr=cfg.lr)
    step = make_collab_step(cfg.sched(dev), cfg.cut(), apply_fn, opt_cfg)
    return state, step, apply_fn


def train_round(state: CollabState, step_fn, batches_per_client, key):
    """``batches_per_client``: a list over clients of lists of (x0, y)
    batches.  Mutates ``state`` in place; returns the metrics of the last
    step per client as floats (``{}`` for a client that contributed no
    batches this round)."""
    if state.server_opt is None or state.client_opt is None:
        raise ValueError("train_round: the state has no optimizer states; "
                         "build it with setup")
    last = {}
    for c, batches in enumerate(batches_per_client):
        m = None
        for (x0, y) in batches:
            key, k = prng.split(key)
            (state.client_params[c], state.client_opt[c],
             state.server_params, state.server_opt, m) = step_fn(
                state.client_params[c], state.client_opt[c],
                state.server_params, state.server_opt, x0, y, k)
            state.step += 1
        last[c] = {} if m is None else {k_: float(v) for k_, v in m.items()}
    return last


# ---------------------------------------------------------------------------
# The vectorized engine: one round function, per-slot models.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VectorizedCollabState:
    """``CollabState`` for the vectorized engine: the same fields, with
    ``client_params`` / ``client_opt`` one model and one AdamW state a
    client (``stack_clients`` gives the JAX package's stacked view).
    ``mesh`` and ``owners`` (each slot's rank, None when replicated) are
    set by sharding/specs.py ``shard_vectorized_state``."""
    server_params: Any
    server_opt: Dict
    client_params: List[Any]
    client_opt: List[Dict]
    step: int = 0
    mesh: Any = None
    owners: Optional[List[int]] = None

    @property
    def n_clients(self) -> int:
        return len(self.client_params)


def stack_clients(models: List[Any]) -> Dict:
    """k models (or AdamW states, or dicts of tensors) of one layout → one
    tree with a leading (k,) axis on every leaf: a module becomes its
    ``{name: tensor}`` parameter dict.  A copy, for parity checks and
    checkpoints; training never reads it."""
    return trees.stack(list(models))


def unstack_clients(stacked: Dict, n_clients: int) -> List[Dict]:
    return trees.unstack(stacked, n_clients)


def to_vectorized(state: CollabState) -> VectorizedCollabState:
    """The same models and states (not copies) under the vectorized
    engine's state."""
    return VectorizedCollabState(
        server_params=state.server_params, server_opt=state.server_opt,
        client_params=list(state.client_params),
        client_opt=list(state.client_opt), step=state.step)


def to_sequential(state: VectorizedCollabState) -> CollabState:
    return CollabState(
        server_params=state.server_params, server_opt=state.server_opt,
        client_params=list(state.client_params),
        client_opt=list(state.client_opt), step=state.step)


def _stack_nested(rows, k: int, nb: int, which: int):
    return torch.stack([torch.stack([rows[c][b][which] for c in range(k)])
                        for b in range(nb)])


def stack_round_batches(batches_per_client, pad: bool = True):
    """A list over clients of lists of (x0, y) batches → padded stacks.

    ``pad=True`` (the engine's default): zero-pads ragged clients (unequal
    batch counts and sizes) to ``(n_batches_max, k, B_max, ...)`` tensors
    on the batches' device and returns ``(xs, ys, mask)``, ``mask`` a
    host ``(n_batches_max, k, B_max)`` float32 numpy array of 0/1 (1 = a
    real sample).  No sample is dropped.  ``(None, None, None)`` only
    when no client has a batch.

    ``pad=False``: the dense layout, every client truncated to the
    shortest client's batch count (with a ``UserWarning`` naming the
    dropped batches), equal batch shapes required; ``(xs, ys)``, or
    ``(None, None)`` when a client has no batch."""
    k = len(batches_per_client)
    if not pad:
        nb = min((len(b) for b in batches_per_client), default=0)
        if nb == 0:
            return None, None
        dropped = sum(len(b) - nb for b in batches_per_client)
        if dropped:
            warnings.warn(
                f"stack_round_batches(pad=False) truncating to the shortest "
                f"client: dropping {dropped} batch(es); use the padded/"
                f"masked engine (pad=True) to train on every sample",
                UserWarning, stacklevel=2)
        return (_stack_nested(batches_per_client, k, nb, 0),
                _stack_nested(batches_per_client, k, nb, 1))

    nb = max((len(b) for b in batches_per_client), default=0)
    if nb == 0:
        return None, None, None
    b_max = max(x.shape[0] for bs in batches_per_client for (x, _) in bs)
    x0, y0 = next((x, y) for bs in batches_per_client for (x, y) in bs)
    xs = torch.zeros((nb, k, b_max) + tuple(x0.shape[1:]), dtype=x0.dtype,
                     device=x0.device)
    ys = torch.zeros((nb, k, b_max) + tuple(y0.shape[1:]), dtype=y0.dtype,
                     device=x0.device)
    mask = np.zeros((nb, k, b_max), dtype=np.float32)
    for c, bs in enumerate(batches_per_client):
        for b, (x, y) in enumerate(bs):
            n = x.shape[0]
            xs[b, c, :n] = x
            ys[b, c, :n] = y
            mask[b, c, :n] = 1.0
    return xs, ys, mask


def bucket_round_batches(batches_per_client, sort: bool = True):
    """Sort each client's batches by size (descending), group batch slots
    by the slot's largest row count and pad each group only to its own
    width: a list of ``(xs, ys, mask)`` stacks in slot order, one per
    width, to drive the masked round over in turn (e.g. with
    ``fold_in(key, bucket)``).  Reordering batches changes which key meets
    which batch, so this is a throughput knob for loops that need no fixed
    batch order, not a transform that keeps a round's bits."""
    lists = [sorted(bs, key=lambda xy: -xy[0].shape[0]) if sort else list(bs)
             for bs in batches_per_client]
    nb_max = max((len(b) for b in lists), default=0)
    if nb_max == 0:
        return []
    widths = [max(l[b][0].shape[0] for l in lists if len(l) > b)
              for b in range(nb_max)]
    stacks = []
    start = 0
    for b in range(1, nb_max + 1):
        if b == nb_max or widths[b] != widths[start]:
            stacks.append(stack_round_batches([l[start:b] for l in lists]))
            start = b
    return stacks


def padded_row_waste(stacks) -> int:
    """Mask cells that carry no real sample across ``(xs, ys, mask)``
    stacks."""
    if stacks and not isinstance(stacks, list):
        stacks = [stacks]
    return int(sum(np.size(m) - np.sum(m) for (_, _, m) in stacks))


def _masked_adamw(params, grads, opt, opt_cfg: AdamWConfig, active: bool):
    """AdamW gated on ``active`` (a host bool): an all-padding cell keeps
    params, moments AND the step counter (zero gradients alone would still
    decay the moments and advance the bias correction) and reports a zero
    grad norm; its gradient was never computed (``grads`` may be None).
    One definition for the client and the server."""
    if not active:
        return params, opt, _zero(trees.leaves(params)[0].device)
    return adamw_update(params, grads, opt, opt_cfg)


def _host_mask(mask) -> np.ndarray:
    if isinstance(mask, torch.Tensor):
        return mask.detach().cpu().numpy().astype(np.float32)
    return np.asarray(mask, np.float32)


def _host_ids(uids) -> np.ndarray:
    if isinstance(uids, torch.Tensor):
        uids = uids.detach().cpu().numpy()
    return np.asarray(uids, np.int64)


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def _flat(tensors, name: str, collective) -> List[torch.Tensor]:
    """Run ``collective(buffer)`` on one flat buffer per dtype that holds
    ``tensors`` and return the buffer's pieces, shaped as the tensors (one
    launch a dtype instead of one a tensor); counts the bytes under
    ``name`` (sharding/specs.py ``COMM_BYTES``)."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        buf = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        collective(buf)
        count_bytes(name, buf)
        for i, piece in zip(idx, buf.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = piece.view(tensors[i].shape)
    return out


def _all_reduce(tensors, group) -> List[torch.Tensor]:
    """The sums over ``group``'s ranks of ``tensors``, as new tensors of
    their own storage (a gradient laid out as the unsharded one is)."""
    import torch.distributed as dist
    return [t.clone() for t in _flat(
        tensors, "all_reduce", lambda b: dist.all_reduce(b, group=group))]


@torch.no_grad()
def broadcast_slots(client_params, client_opt, mesh, slots, owners) -> None:
    """Send each slot of ``slots`` (its model's parameters and its AdamW
    moments and step) from the clients-axis rank that owns it
    (``owners[c]``) to every rank of ``mesh``, in place: after a sharded
    round only the owner's copy of a slot is current."""
    import torch.distributed as dist
    group = mesh.get_group()
    for c in slots:
        opt = client_opt[c]
        tensors = trees.leaves(client_params[c]) + \
            trees.leaves(opt["m"]) + trees.leaves(opt["v"])
        # the step travels in the float32 buffer: exact below 2^24
        step = opt["step"].to(device=tensors[0].device, dtype=torch.float32)
        src = dist.get_process_group_ranks(group)[owners[c]]
        got = _flat(tensors + [step.reshape(1)], "broadcast",
                    lambda b: dist.broadcast(b, src=src, group=group))
        for t, g in zip(tensors, got):
            t.copy_(g)
        opt["step"] = got[-1].reshape(()).cpu().to(torch.int32)


def make_vectorized_round(sched: DiffusionSchedule, cut: CutPoint, apply_fn,
                          opt_cfg: AdamWConfig, masked: bool = True,
                          identity_keyed: bool = False):
    """The whole-round function

    (client_params, client_opt, server_params, server_opt, xs, ys, [mask,]
     [uids,] key) -> (client_params, client_opt, server_params, server_opt,
     metrics)

    ``client_params`` / ``client_opt`` are lists with one model and one
    AdamW state a slot, updated in place (a slot whose mask is all-zero in
    every batch may repeat another slot's objects: it is never touched);
    ``xs`` / ``ys`` are (n_batches, k, B, ...) tensors on the models'
    device.  ``metrics`` holds device tensors: ``client_loss`` and
    ``client_grad_norm`` (n_batches, k), ``server_loss`` and, when the
    server trains, ``server_grad_norm`` (n_batches,); a skipped cell
    reports 0.

    ``masked=True`` (default): a (n_batches, k, B) 0/1 validity mask
    (numpy, or a tensor, which is read on the host once) comes between ys
    and key; per-sample losses are weighted by it with real-count
    normalization, the server batch is weighted by the flattened mask, and
    a (client, batch) cell or a whole server batch whose mask is all-zero
    keeps params, moments and step (see the module docstring).
    ``masked=False``: the dense body, no mask argument.

    ``identity_keyed=True`` (needs ``masked``): a (k,) integer ``uids``
    vector comes between mask and key, and slot c draws from
    ``fold_in(batch_key, uids[c])`` instead of ``fold_in(batch_key, c)``:
    a client's randomness depends on its identity, never on its seat, so
    a cohort padded to a participation tier is bitwise the unpadded run.

    Operands placed on a ``("clients",)`` mesh (sharding/specs.py
    ``shard_round_batches`` / ``shard_cohort_round``) are followed as
    ``jit`` follows input shardings in the reference.  Where the mesh
    cuts the slot axis, a rank runs the client updates of its own slots
    only (the other slots' objects are left as they were: see
    ``broadcast_slots``), builds its part of each server batch from its
    slots' rows, takes the server loss's gradient over the global weight
    total (the mask is whole on every rank) and sums it over the ranks
    (``all_reduce``); every rank then takes the same clipped AdamW step
    on its copy of the server.  The per-slot metrics are gathered, so
    every rank returns the whole (n_batches, k) arrays, and the server
    loss is the whole batch's.  An unmasked round cut over ranks divides
    by the batch's row count.  Where the mesh does not divide the slots
    (replicated), every rank runs every slot and nothing is summed.
    """
    train_client = cut.t_cut > 0
    train_server = cut.t_cut < cut.T
    if identity_keyed and not masked:
        raise ValueError("identity_keyed requires the masked engine "
                         "(cohort stacks always carry a validity mask)")

    def run(client_params, client_opt, server_params, server_opt, xs, ys,
            mask, uids, key):
        k = xs.shape[1]                 # the whole slot axis
        xs, mesh, cut_dim = local_part(xs)
        ys = local_part(ys)[0]
        mask, uids = whole(mask), whole(uids)
        nb, k_loc, B = xs.shape[0], xs.shape[1], xs.shape[2]
        group = None if cut_dim is None else mesh.get_group()
        lo = 0 if group is None else mesh.get_local_rank() * k_loc
        dev = xs.device
        m_host = None if mask is None else _host_mask(mask)
        m_dev = None if m_host is None else torch.from_numpy(m_host).to(dev)
        ids = torch.arange(k, device=dev) if uids is None else \
            torch.from_numpy(_host_ids(uids)).to(dev)
        key = key.to(dev)
        out = {n: [] for n in ("client_loss", "client_grad_norm",
                               "server_loss", "server_grad_norm")}
        for b in range(nb):
            bkey = prng.fold_in(key, b)
            ckeys = client_keys(bkey, ids)
            rows, wrows = [], []
            for c in range(lo, lo + k_loc):
                w = None if m_dev is None else m_dev[b, c]
                active = m_host is None or bool(m_host[b, c].any())
                loss_c, g = _zero(dev), None
                if active:
                    with torch.enable_grad():
                        loss_c, payload = client_losses(
                            client_params[c], xs[b, c - lo], ys[b, c - lo],
                            ckeys[c], sched, cut, apply_fn, weights=w)
                        if train_client:
                            g = _grads(loss_c, client_params[c])
                    if m_host is not None:
                        # the server batch keeps the rows of weight > 0
                        keep = np.flatnonzero(m_host[b, c] > 0)
                        if keep.size < B:
                            sel = torch.from_numpy(keep).to(dev)
                            payload = ServerPayload(
                                *(t.index_select(0, sel) for t in payload))
                            w = w.index_select(0, sel)
                        wrows.append(w)
                    rows.append(payload)
                _, _, gn = _masked_adamw(client_params[c], g, client_opt[c],
                                         opt_cfg, active and train_client)
                out["client_loss"].append(loss_c.detach())
                out["client_grad_norm"].append(gn)
            if not train_server:
                out["server_loss"].append(_zero(dev))
                continue
            if group is None:
                loss_s, g, active = _server_grads(server_params, rows,
                                                  wrows)
            else:
                total = float(k * B) if m_host is None else \
                    float(m_host[b].sum())
                loss_s, g, active = _server_grads_cut(
                    server_params, rows, wrows, total, group)
            _, _, gns = _masked_adamw(server_params, g, server_opt, opt_cfg,
                                      active)
            out["server_loss"].append(loss_s.detach())
            out["server_grad_norm"].append(gns)
        metrics = {n: torch.stack(v) for n, v in out.items() if v}
        for n in ("client_loss", "client_grad_norm"):
            if n in metrics:
                metrics[n] = metrics[n].reshape(nb, k_loc)
                if group is not None:
                    metrics[n] = gather(metrics[n], mesh, 1)
        return client_params, client_opt, server_params, server_opt, \
            metrics

    def _server_grads(server_params, rows, wrows, norm=None):
        """(loss, gradient or None, whether any row is real) of the
        server batch made of ``rows``."""
        if not rows:                    # every slot is padding
            return _zero(trees.leaves(server_params)[0].device), None, False
        flat = ServerPayload(*(torch.cat(ts) for ts in zip(*rows)))
        with torch.enable_grad():
            loss_s = server_loss(server_params, flat, sched, apply_fn,
                                 torch.cat(wrows) if wrows else None,
                                 norm=norm)
            g = _grads(loss_s, server_params)
        return loss_s, g, True

    def _server_grads_cut(server_params, rows, wrows, total, group):
        """The server batch cut over the ranks of ``group``: this rank's
        part of the loss over the whole batch's weight ``total``, its
        gradient, and both summed over the ranks."""
        dev = trees.leaves(server_params)[0].device
        if total == 0.0:                # every slot of every rank padding
            return _zero(dev), None, False
        norm = torch.tensor(total, dtype=torch.float32, device=dev)
        loss_s, g, _ = _server_grads(server_params, rows, wrows, norm)
        names = list(named(server_params))
        if g is None:                   # this rank holds no real row
            g = {n: torch.zeros_like(p)
                 for n, p in named(server_params).items()}
        *summed, loss_s = _all_reduce([g[n] for n in names] +
                                      [loss_s.detach().reshape(1)], group)
        return loss_s.reshape(()), dict(zip(names, summed)), True

    if identity_keyed:
        def round_fn(client_params, client_opt, server_params, server_opt,
                     xs, ys, mask, uids, key):
            return run(client_params, client_opt, server_params, server_opt,
                       xs, ys, mask, uids, key)
    elif masked:
        def round_fn(client_params, client_opt, server_params, server_opt,
                     xs, ys, mask, key):
            return run(client_params, client_opt, server_params, server_opt,
                       xs, ys, mask, None, key)
    else:
        def round_fn(client_params, client_opt, server_params, server_opt,
                     xs, ys, key):
            return run(client_params, client_opt, server_params, server_opt,
                       xs, ys, None, None, key)
    return round_fn


def setup_vectorized(key: torch.Tensor, cfg: CollabConfig, device=None
                     ) -> Tuple[VectorizedCollabState, Callable, Callable]:
    """The vectorized counterpart of ``setup``: the same models from the
    same keys, and the masked round function (drive it through
    ``train_round_vectorized``)."""
    dev = resolve_device(device)
    init_one, apply_fn = build_denoiser(key, cfg, dev)
    ks, *kc = prng.split(key.to(dev), cfg.n_clients + 1)
    server_params = init_one(ks)
    client_list = [init_one(k) for k in kc]
    state = VectorizedCollabState(
        server_params=server_params,
        server_opt=init_opt_state(server_params),
        client_params=client_list,
        client_opt=[init_opt_state(p) for p in client_list])
    round_fn = make_vectorized_round(cfg.sched(dev), cfg.cut(), apply_fn,
                                     AdamWConfig(lr=cfg.lr))
    return state, round_fn, apply_fn


def train_round_vectorized(state: VectorizedCollabState, round_fn, xs, ys,
                           key, mask=None):
    """One round through a masked ``round_fn``.  Mutates ``state``;
    returns per-client last-real-batch metrics as ``train_round`` does
    (server entries are the round's shared values; ``{}`` for a client
    whose mask is all padding; ``{}`` for an empty round).
    ``mask=None`` means every sample is real.  ``state.step`` counts only
    real (client, batch) cells.  A state laid on a mesh
    (``shard_vectorized_state``) gets its operands placed on it, and
    after the round each real slot goes from its owner to every rank."""
    if xs is None or xs.shape[0] == 0:
        return {}
    mask_np = np.ones(tuple(xs.shape[:3]), np.float32) if mask is None \
        else _host_mask(mask)
    args = (xs, ys, mask_np) if state.mesh is None else \
        shard_round_batches(state.mesh, xs, ys, mask_np)
    (_, _, state.server_params, state.server_opt, metrics) = round_fn(
        state.client_params, state.client_opt, state.server_params,
        state.server_opt, *args, key)
    if state.owners is not None:
        broadcast_slots(state.client_params, state.client_opt, state.mesh,
                        np.flatnonzero(mask_np.any(axis=(0, 2))),
                        state.owners)
    n_clients = xs.shape[1]
    valid = mask_np.any(axis=2)                    # (n_batches, k)
    state.step += int(valid.sum())
    # the protocol's wire cost: padded rows are never shipped, so per-row
    # payload bytes times the client's real rows in its last batch
    row_bytes = ServerPayload(
        xs[0, 0], xs[0, 0], torch.zeros((xs.shape[2],), dtype=torch.int32),
        ys[0, 0]).nbytes() / xs.shape[2]
    any_rows = np.nonzero(valid.any(axis=1))[0]
    if any_rows.size == 0:
        return {c: {} for c in range(n_clients)}
    b_srv = int(any_rows[-1])
    host = {n: v.cpu().numpy() for n, v in metrics.items()}
    last = {}
    for c in range(n_clients):
        real_b = np.nonzero(valid[:, c])[0]
        if real_b.size == 0:
            last[c] = {}
            continue
        b = int(real_b[-1])
        last[c] = {
            "client_loss": float(host["client_loss"][b, c]),
            "client_grad_norm": float(host["client_grad_norm"][b, c]),
            "server_loss": float(host["server_loss"][b_srv]),
            "payload_bytes": float(row_bytes * mask_np[b, c].sum()),
        }
        if "server_grad_norm" in host:
            last[c]["server_grad_norm"] = float(
                host["server_grad_norm"][b_srv])
    return last


def train_round_reference(state: CollabState, xs, ys, key,
                          sched: DiffusionSchedule, cut: CutPoint, apply_fn,
                          opt_cfg: AdamWConfig, mask=None, uids=None):
    """The differential oracle of the vectorized engine: its semantics and
    keys (per-batch and per-client ``fold_in``, one server update on the
    concatenated batch, masked losses with real-count normalization,
    all-padding cells skipped) written plainly: every slot's loss and
    payload computed, every payload row in the server batch at its
    weight.  Mutates ``state``; ``mask=None`` means every sample is real,
    ``uids`` switches to identity keys."""
    train_client = cut.t_cut > 0
    train_server = cut.t_cut < cut.T
    n_batches, n_clients = xs.shape[0], xs.shape[1]
    m_host = None if mask is None else _host_mask(mask)
    for b in range(n_batches):
        bkey = prng.fold_in(key, b)
        payloads, wrows = [], []
        for c in range(n_clients):
            ckey = prng.fold_in(bkey, c if uids is None else int(uids[c]))
            w = None if m_host is None else \
                torch.from_numpy(m_host[b, c]).to(xs.device)
            active = m_host is None or bool(m_host[b, c].sum() > 0)
            with torch.enable_grad():
                loss_c, payload = client_losses(
                    state.client_params[c], xs[b, c], ys[b, c], ckey, sched,
                    cut, apply_fn, weights=w)
                if train_client and active:
                    g = _grads(loss_c, state.client_params[c])
            if train_client and active:
                adamw_update(state.client_params[c], g, state.client_opt[c],
                             opt_cfg)
            payloads.append(payload)
            wrows.append(w)
            if active:
                state.step += 1
        if train_server:
            flat = ServerPayload(*(torch.cat(ts) for ts in zip(*payloads)))
            wflat = None if m_host is None else torch.cat(wrows)
            if m_host is None or bool(m_host[b].sum() > 0):
                with torch.enable_grad():
                    g = _grads(server_loss(state.server_params, flat, sched,
                                           apply_fn, wflat),
                               state.server_params)
                adamw_update(state.server_params, g, state.server_opt,
                             opt_cfg)
    return state


def sample_for_client(state: CollabState, client: int, key, y,
                      cfg: CollabConfig, apply_fn, adjusted: bool = True,
                      batch: Optional[int] = None,
                      return_handoff: bool = False):
    """Alg. 2 for one client: the server's steps with the server model,
    then the client's with the client's own."""
    shape = cfg.image_shape(batch or y.shape[0])
    return collaborative_sample(
        state.server_params, state.client_params[client], key, y, shape,
        cfg.sched(key.device), cfg.cut(), apply_fn, adjusted=adjusted,
        return_handoff=return_handoff)
