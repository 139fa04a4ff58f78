"""CollaFuse collaborative training — paper Algorithm 1, and the row-keyed
noise that Alg. 2 shares with it.

Per client batch (client node, lines 5–13):
    t_c ~ U[1, t_ζ],  t_s ~ U[t_ζ, T],  ε_c, ε_s ~ N(0, I)
    x_{t_c} = α(t_c)·x_0 + σ(t_c)·ε_c          (client training sample)
    x_{t_ζ} = α(t_ζ)·x_0 + σ(t_ζ)·ε_c          (same ε_c — line 9)
    x_{t_s} = α(t_s)·x_{t_ζ} + σ(t_s)·ε_s      (re-noise; server never sees x_0)
    L_c = ‖ε_θc(x_{t_c}, t_c, y) − ε_c‖²  → update θ_c
    ship (x_{t_s}, ε_s, t_s, y) to the server.

Server node (lines 14–16):
    L_s = ‖ε_θs(x_{t_s}, t_s, y) − ε_s‖²  → update θ_s

Client and server updates are independent: the payload is detached, so no
gradient crosses the cut.  At t_ζ = 0 (GM) the client is not trained; at
t_ζ = T (ICM) the server is not.

The port of the JAX package's ``core/protocol.py``: the same key chain
(``split`` of each step's key, row-keyed draws through ``row_keys``) and
the same denoiser signature ``apply_fn(params, x_t, t, y) -> ε̂``, with
the gradients from ``torch.autograd.grad`` and the parameters and AdamW
moments updated in place.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.core.splitting import CutPoint, row_keys
from repro_torch.optim.adamw import AdamWConfig, adamw_update, named


def rowwise_normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """(B, ...) standard normals with row-keyed draws: row i depends only
    on (key, i), never on B.  A batched key (..., 2) gives (..., B, ...)
    — one independent row-keyed draw per key, as ``vmap`` over keys gives
    in the JAX package."""
    return prng.normal(row_keys(key, shape[0]), tuple(shape[1:]))


def client_keys(batch_key: torch.Tensor,
                client_ids: torch.Tensor) -> torch.Tensor:
    """One key per client slot: ``fold_in(batch_key, id)`` for a (k,)
    integer tensor of client identities — positions (``arange(k)``) or
    registry uids (identity keying: a client's draws depend only on
    (key, uid), never on where it was seated)."""
    return prng.fold_in(batch_key, client_ids)


class ServerPayload(NamedTuple):
    """What crosses the client→server wire during training (the paper's
    communication claim, against model weights for FL)."""
    x_ts: torch.Tensor   # (B, ...) re-noised samples at server timesteps
    eps_s: torch.Tensor  # (B, ...) the server's regression target
    t_s: torch.Tensor    # (B,)    server timesteps (int32)
    y: torch.Tensor      # (B, n_classes) conditioning

    def nbytes(self) -> int:
        return sum(int(t.numel() * t.element_size()) for t in self)


def mse_eps_loss(apply_fn, params, x_t, t, y, eps, weights=None,
                 norm=None):
    """ω_t ≡ 1 MSE.  ``weights`` (B,) — typically a 0/1 validity mask over
    a padded batch — gives the weighted mean sum(per·w) / max(sum(w), 1):
    padded rows contribute zero gradient, and all-ones weights equal the
    unweighted mean.  ``norm`` (a 0-dim float32 tensor) divides in place
    of the rows' own weight total: a rank's part of a batch cut over
    ranks, whose parts then sum to the whole batch's loss."""
    pred = apply_fn(params, x_t, t, y)
    per = torch.mean(torch.square(pred.float() - eps.float()),
                     dim=tuple(range(1, eps.ndim)))
    if norm is not None:
        num = torch.sum(per) if weights is None else \
            torch.sum(per * weights.float())
        return num / torch.clamp(norm, min=1.0)
    if weights is None:
        return torch.mean(per)
    w = weights.float()
    return torch.sum(per * w) / torch.clamp(torch.sum(w), min=1.0)


def make_payload(x0, y, key, sched: DiffusionSchedule, cut: CutPoint,
                 eps_c: Optional[torch.Tensor] = None,
                 dp_sigma: float = 0.0, dp_clip: float = 0.0
                 ) -> ServerPayload:
    """Lines 6–10 of Alg. 1 (the diffusion process on the client node).
    With ``dp_sigma`` > 0 and ``dp_clip`` > 0 the shipped x_{t_s} also
    goes through the Gaussian mechanism (privacy/dp.privatize_payload:
    per-row L2 clip to ``dp_clip``, then N(0, (dp_sigma·dp_clip)²)
    row-keyed noise from the fourth key of the split); ε_s is unchanged,
    so the server sees the noise as label noise."""
    B = x0.shape[0]
    k_ts, k_es, k_ec, k_dp = prng.split(key, 4)
    if eps_c is None:
        eps_c = rowwise_normal(k_ec, x0.shape)
    t_s = cut.sample_server_t(k_ts, B)
    eps_s = rowwise_normal(k_es, x0.shape)
    t_cut = torch.full((B,), float(cut.t_cut), device=x0.device)
    x_cut = sched.q_sample(x0, t_cut, eps_c)
    x_ts = sched.renoise(x_cut, cut.t_cut, t_s, eps_s)
    if dp_sigma > 0.0 and dp_clip > 0.0:
        from repro_torch.privacy.dp import privatize_payload  # no cycle
        x_ts = privatize_payload(x_ts, k_dp, dp_sigma, dp_clip)
    return ServerPayload(x_ts, eps_s, t_s, y)


def client_losses(client_params, x0, y, key, sched: DiffusionSchedule,
                  cut: CutPoint, apply_fn, weights=None
                  ) -> Tuple[torch.Tensor, ServerPayload]:
    """(client loss, server payload).  Differentiable in client_params
    only; the payload is detached.  ``weights`` (B,): the validity mask of
    a padded batch; masked rows carry no loss or gradient, and since every
    draw is row-keyed the real rows draw what their unpadded batch would.
    The payload holds every row; the caller weights the server loss."""
    B = x0.shape[0]
    k_tc, k_ec, k_pay = prng.split(key, 3)
    eps_c = rowwise_normal(k_ec, x0.shape)
    if cut.t_cut > 0:
        t_c = cut.sample_client_t(k_tc, B)
        x_tc = sched.q_sample(x0, t_c, eps_c)
        loss_c = mse_eps_loss(apply_fn, client_params, x_tc, t_c, y, eps_c,
                              weights=weights)
    else:
        loss_c = torch.zeros((), dtype=torch.float32, device=x0.device)
    payload = make_payload(x0, y, k_pay, sched, cut, eps_c=eps_c)
    return loss_c, ServerPayload(*(t.detach() for t in payload))


def server_loss(server_params, payload: ServerPayload,
                sched: DiffusionSchedule, apply_fn,
                weights=None, norm=None) -> torch.Tensor:
    return mse_eps_loss(apply_fn, server_params, payload.x_ts, payload.t_s,
                        payload.y, payload.eps_s, weights=weights, norm=norm)


def _grads(loss: torch.Tensor, params) -> Dict[str, torch.Tensor]:
    """d loss / d params as {name: tensor}; zeros for a parameter the loss
    does not reach (as ``jax.grad`` gives)."""
    ps = named(params)
    gs = torch.autograd.grad(loss, list(ps.values()), allow_unused=True,
                             materialize_grads=True)
    return dict(zip(ps, gs))


# ---------------------------------------------------------------------------
# One full Alg.-1 step (client update + server update).
# ---------------------------------------------------------------------------


def make_collab_step(sched: DiffusionSchedule, cut: CutPoint, apply_fn,
                     opt_cfg: AdamWConfig):
    """Builds
    (client_params, client_opt, server_params, server_opt, x0, y, key)
      -> (client_params, client_opt, server_params, server_opt, metrics)
    with the parameters and optimizer states updated in place.  Metrics
    are 0-dim tensors on the batch's device."""
    train_client = cut.t_cut > 0
    train_server = cut.t_cut < cut.T

    def step(client_params, client_opt, server_params, server_opt, x0, y,
             key):
        metrics: Dict[str, torch.Tensor] = {}
        with torch.enable_grad():
            loss_c, payload = client_losses(client_params, x0, y, key, sched,
                                            cut, apply_fn)
            if train_client:
                grads_c = _grads(loss_c, client_params)
        if train_client:
            _, client_opt, gn = adamw_update(client_params, grads_c,
                                             client_opt, opt_cfg)
            metrics["client_grad_norm"] = gn
        metrics["client_loss"] = loss_c.detach()

        if train_server:
            with torch.enable_grad():
                loss_s = server_loss(server_params, payload, sched, apply_fn)
                grads_s = _grads(loss_s, server_params)
            _, server_opt, gns = adamw_update(server_params, grads_s,
                                              server_opt, opt_cfg)
            metrics["server_loss"] = loss_s.detach()
            metrics["server_grad_norm"] = gns
        else:
            metrics["server_loss"] = torch.zeros((), dtype=torch.float32,
                                                 device=x0.device)
        metrics["payload_bytes"] = torch.tensor(
            min(payload.nbytes(), 2 ** 31 - 1), dtype=torch.int32)
        return client_params, client_opt, server_params, server_opt, metrics

    return step
