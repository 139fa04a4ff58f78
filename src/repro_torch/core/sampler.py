"""CollaFuse collaborative inference — paper Algorithm 2, plus the batched
planner/executor sampling engine that serves it at scale.

Per-request samplers (paper Alg. 2 verbatim)
--------------------------------------------
Server: x_T ~ N(0, I), denoise T … t_ζ+1 with ε_θs → ship x̂_{t_ζ}.
Client: remap its schedule over [1, M], M = ⌊t_ζ + (t_ζ/T)(T − t_ζ)⌋, then
run its t_ζ steps with interpolated coefficients.  ``adjusted=False``
ablates the M-remap.  They draw with JAX's chained ``split`` keys, so for
the same key they follow the JAX package's samplers draw for draw.  Each
step goes through the scalar entry of the fused DDPM-step kernel.

Batched sampling engine (``make_sample_engine``)
------------------------------------------------
One wave of requests (core/sample_plan.plan_requests tables) runs as two
masked step loops:

* **Server stage.**  Over the step axis of the (G, S_max) server table:
  each of the G groups' (B, H, W, C) batch goes through the server model
  in its own call, then one batched DDPM-step launch advances all G
  states, each at its own timestep (``server_ddim=True`` takes the
  deterministic DDIM update instead, for strided tables).
* **Client stage.**  Each request gathers its handoff from the combined
  ``[scanned | injected]`` group axis (cache hits arrive as injected rows
  and cost zero server calls), then the (R, C_max) client table is
  stepped with each request's own client model, one call per request, and
  one batched kernel launch per step.
* **Masked steps pass x through bitwise** (``where(active, xn, x)``), so
  padding S_max/C_max/G/R never perturbs a real row.  A masked step still
  runs its model call (the physical accounting counts it).
* **Row-keyed noise, stable seeds.**  Every draw is ``rowwise_normal``
  keyed by (phase key, group/request seed, step index, row), so padding
  consumes no real row's randomness; the serve runtime passes content-
  and arrival-stable seeds.
* **One batch per model call.**  A row's bits never depend on which
  other requests share its wave: every call sees exactly one group's or
  one request's batch, and on CUDA the serve runtime pins cuDNN to
  deterministic, shape-chosen algorithms (device.deterministic_cuda).

``split=True`` returns the two stages separately — the serve runtime
pipelines wave i+1's server stage against wave i's client stage; each
stage derives its phase key from the same ``split(key)``, so
``client_stage(cp, key, t, server_stage(sp, key, t), i)`` equals the fused
engine's samples bitwise.  Stages take device tables
(``sample_plan.tables_to_device``) and run under ``torch.no_grad``.

Client parameters are a sequence of per-client params (a list of models,
or a stacked tree of tensors with a leading client axis, unstacked with
``client_list``); ``tables.request_client`` (host) picks each request's.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.protocol import rowwise_normal as _rowwise_normal
from repro_torch.core.sample_plan import (InjectTables, PlanTables,
                                          SamplePlan, strided_server_table)
from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.core.splitting import CutPoint
from repro_torch.kernels.ddpm_step.ops import (ddpm_step as fused_ddpm_step,
                                               ddpm_step_batched)


def client_list(client_params) -> List:
    """Per-client params: a list/tuple as given, or a dict of tensors
    stacked on a leading client axis k split into k dicts."""
    if isinstance(client_params, (list, tuple)):
        return list(client_params)
    if isinstance(client_params, dict):
        k = next(iter(client_params.values())).shape[0]
        return [{n: v[i] for n, v in client_params.items()}
                for i in range(k)]
    raise TypeError("client params must be a list of per-client params or "
                    "a dict of stacked tensors")


def _full(t: torch.Tensor, B: int) -> torch.Tensor:
    return t.reshape(()).expand(B)


@torch.no_grad()
def server_denoise(server_params, key, y, shape, sched: DiffusionSchedule,
                   cut: CutPoint, apply_fn):
    """Run the T − t_ζ server steps.  Returns x̂_{t_ζ} (noise if t_ζ = T)."""
    k0, kloop = prng.split(key)
    x = prng.normal(k0, shape)
    if cut.n_server_steps == 0:
        return x
    t_list = torch.from_numpy(cut.server_t_list()).float().to(x.device)
    k = kloop
    for i in range(cut.n_server_steps):
        k, kn = prng.split(k)
        t = t_list[i]
        eps = apply_fn(server_params, x, _full(t, x.shape[0]), y)
        noise = prng.normal(kn, x.shape)
        x = fused_ddpm_step(x, eps, noise, sched, t)
    return x


@torch.no_grad()
def client_denoise(client_params, key, x_cut, y, sched: DiffusionSchedule,
                   cut: CutPoint, apply_fn, adjusted: bool = True):
    """Run the client's t_ζ steps from the server handoff x̂_{t_ζ}."""
    if cut.n_client_steps == 0:
        return x_cut
    t_np, tp_np = cut.client_step_table(adjusted)
    t_list = torch.from_numpy(t_np).to(x_cut.device)
    t_prev = torch.from_numpy(tp_np).to(x_cut.device)
    x, k = x_cut, key
    for i in range(cut.n_client_steps):
        k, kn = prng.split(k)
        eps = apply_fn(client_params, x, _full(t_list[i], x.shape[0]), y)
        noise = prng.normal(kn, x.shape)
        x = fused_ddpm_step(x, eps, noise, sched, t_list[i],
                            t_prev=t_prev[i])
    return x


@torch.no_grad()
def server_denoise_ddim(server_params, key, y, shape,
                        sched: DiffusionSchedule, cut: CutPoint, apply_fn,
                        stride: int = 4):
    """Beyond-paper server schedule: deterministic DDIM with a stride —
    ⌈(T − t_ζ)/stride⌉ model calls; the last step lands exactly at t_ζ."""
    k0, _ = prng.split(key)
    x = prng.normal(k0, shape)
    if cut.n_server_steps == 0:
        return x
    t_np, tp_np = strided_server_table(cut, stride)
    t_list = torch.from_numpy(t_np).to(x.device)
    t_prev = torch.from_numpy(tp_np).to(x.device)
    for i in range(t_list.shape[0]):
        eps = apply_fn(server_params, x, _full(t_list[i], x.shape[0]), y)
        x = sched.ddim_step(x, eps, t_list[i], t_prev[i])
    return x


# ---------------------------------------------------------------------------
# Batched planner/executor sampling engine (see module docstring).
# ---------------------------------------------------------------------------


def check_engine_plan(server_ddim: bool, plan: SamplePlan) -> None:
    """Stride and update rule travel together: a strided plan needs the
    DDIM engine and a stride-1 plan the DDPM engine — a mismatch gives
    finite, statistically WRONG samples, not an error."""
    if (plan.server_stride > 1) != server_ddim:
        raise ValueError(
            f"plan server_stride={plan.server_stride} but engine was "
            f"built with server_ddim={server_ddim}: a strided plan needs "
            "make_sample_engine(server_ddim=True) and vice versa")


def _lead(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(K,) → (K, 1, …) broadcasting against a rank-``ndim`` stack."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


def make_sample_engine(sched: DiffusionSchedule, apply_fn,
                       image_shape: Tuple[int, ...],
                       server_ddim: bool = False, split: bool = False):
    """Build the batched executor:

        engine(server_params, client_params, key, tables, inject=None)
            -> (samples (R, B, *image_shape), handoffs (G, B, ...))

    ``tables`` is a device ``PlanTables`` (``tables_to_device``) and
    ``inject`` an optional device ``InjectTables`` of cache hits.  The
    returned handoffs are the SCANNED groups only, rows aligned with
    ``plan.group_keys``.  ``split=True`` returns ``(server_stage,
    client_stage)``:

        server_stage(server_params, key, tables) -> handoffs
        client_stage(client_params, key, tables, handoffs, inject=None)
            -> samples
    """
    shape_of = lambda B: (B,) + tuple(image_shape)

    @torch.no_grad()
    def server_stage(server_params, key, tables: PlanTables):
        gy, gt, gtp, ga, gseed = tables[:5]
        G, B = gy.shape[0], gy.shape[1]
        shape = shape_of(B)
        skey, _ = prng.split(key)
        gkeys = prng.fold_in(skey, gseed)                    # (G, 2)
        x = _rowwise_normal(prng.fold_in(gkeys, 0), shape)   # (G, B, ...)
        for s in range(gt.shape[1]):
            t, t_prev, active = gt[:, s], gtp[:, s], ga[:, s]
            eps = torch.stack([
                apply_fn(server_params, x[g], _full(t[g], B), gy[g])
                for g in range(G)])
            if server_ddim:
                xn = sched.ddim_step(x, eps, _lead(t, x.ndim),
                                     _lead(t_prev, x.ndim))
            else:
                noise = _rowwise_normal(prng.fold_in(gkeys, 1 + s), shape)
                xn = ddpm_step_batched(x, eps, noise, sched, t,
                                       t_prev=t_prev)
            x = torch.where(_lead(active, x.ndim) > 0, xn, x)
        return x

    @torch.no_grad()
    def client_stage(client_params, key, tables: PlanTables, handoff,
                     inject: InjectTables = None):
        (gy, _gt, _gtp, _ga, _gseed, rgroup, rclient, rseed, ct, ctp,
         ca) = tables
        B = gy.shape[1]
        shape = shape_of(B)
        _, ckey = prng.split(key)
        models = client_list(client_params)
        params_r = [models[int(c)] for c in rclient]
        if inject is not None:
            handoff_all = torch.cat([handoff, inject.x], dim=0)
            y_all = torch.cat([gy, inject.y], dim=0)
        else:
            handoff_all, y_all = handoff, gy
        y_r = y_all[rgroup.long()]                           # (R, B, nc)
        x = handoff_all[rgroup.long()]                       # (R, B, ...)
        rkeys = prng.fold_in(ckey, rseed)                    # (R, 2)
        R = x.shape[0]
        for c in range(ct.shape[1]):
            t, t_prev, active = ct[:, c], ctp[:, c], ca[:, c]
            eps = torch.stack([
                apply_fn(params_r[r], x[r], _full(t[r], B), y_r[r])
                for r in range(R)])
            noise = _rowwise_normal(prng.fold_in(rkeys, c), shape)
            xn = ddpm_step_batched(x, eps, noise, sched, t, t_prev=t_prev)
            x = torch.where(_lead(active, x.ndim) > 0, xn, x)
        return x

    def engine(server_params, client_params, key, tables: PlanTables,
               inject=None):
        handoff = server_stage(server_params, key, tables)
        out = client_stage(client_params, key, tables, handoff, inject)
        return out, handoff

    if split:
        return server_stage, client_stage
    return engine


@torch.no_grad()
def sample_plan_reference(server_params, client_params_list, key,
                          plan: SamplePlan, sched: DiffusionSchedule,
                          apply_fn, image_shape: Tuple[int, ...]):
    """Differential-testing oracle for the batched engine: the same
    semantics and PRNG discipline, but plain Python loops over the host
    plan — no stacking, no ``where`` (a masked step is simply not run) —
    through the scalar DDPM-step entry.  Honors ``server_stride`` and the
    plan's ``inject`` rows.  Returns the same (samples, handoffs) pair."""
    t = plan.tables
    gy = torch.as_tensor(t.group_y, device=key.device)
    G, B = gy.shape[0], gy.shape[1]
    shape = (B,) + tuple(image_shape)
    skey, ckey = prng.split(key)
    handoffs = []
    for g in range(G):
        gk = prng.fold_in(skey, int(t.group_seed[g]))
        x = _rowwise_normal(prng.fold_in(gk, 0), shape)
        for s in range(plan.group_steps[g]):
            tt, tp = float(t.group_t[g, s]), float(t.group_t_prev[g, s])
            tt_b = torch.full((B,), tt, device=key.device)
            eps = apply_fn(server_params, x, tt_b, gy[g])
            if plan.server_stride > 1:
                x = sched.ddim_step(x, eps, tt, tp)
            else:
                noise = _rowwise_normal(prng.fold_in(gk, 1 + s), shape)
                x = fused_ddpm_step(x, eps, noise, sched, tt, t_prev=tp)
        handoffs.append(x)
    inj = plan.inject
    combined = handoffs + ([inj.x[h].to(key.device)
                            for h in range(plan.n_hits)] if inj else [])
    y_all = [gy[g] for g in range(G)] + \
        ([torch.as_tensor(inj.y[h], device=key.device)
          for h in range(plan.n_hits)] if inj else [])
    clients = client_list(client_params_list)
    outs = []
    for r in range(plan.n_requests):
        rk = prng.fold_in(ckey, int(t.request_seed[r]))
        g = int(t.request_group[r])
        x = combined[g]
        cp = clients[int(t.request_client[r])]
        for c in range(plan.request_t_cut[r]):
            tt, tp = float(t.client_t[r, c]), float(t.client_t_prev[r, c])
            eps = apply_fn(cp, x, torch.full((B,), tt, device=key.device),
                           y_all[g])
            noise = _rowwise_normal(prng.fold_in(rk, c), shape)
            x = fused_ddpm_step(x, eps, noise, sched, tt, t_prev=tp)
        outs.append(x)
    return torch.stack(outs), (torch.stack(handoffs) if handoffs else
                               torch.zeros((0,) + shape, device=key.device))


def make_per_request_sampler(sched: DiffusionSchedule, apply_fn,
                             shape: Tuple[int, ...]) -> Callable:
    """The pre-engine serving baseline: ``fn_for(t_cut)`` yields a
    one-request Alg.-2 program ``(server_params, client_params, key, y) ->
    samples``, built once per distinct cut point.  ``shape`` is the full
    (B, H, W, C) request shape."""
    built = {}

    def fn_for(t_cut: int):
        if t_cut not in built:
            cut = CutPoint(sched.T, t_cut)
            built[t_cut] = lambda sp, cp, k, y: collaborative_sample(
                sp, cp, k, y, shape, sched, cut, apply_fn)
        return built[t_cut]

    return fn_for


# ---------------------------------------------------------------------------
# Per-request entry points and the single-(y, t_ζ) fast path.
# ---------------------------------------------------------------------------


def shared_handoff_sample(server_params, client_params_list, key, y, shape,
                          sched: DiffusionSchedule, cut: CutPoint, apply_fn,
                          adjusted: bool = True, server_stride: int = 0):
    """Paper §3.2: for a shared label the server prefix runs ONCE and every
    client finishes locally from the same handoff (client i keyed
    ``fold_in(kc, i)``).  ``client_params_list`` is a list of per-client
    params or a stacked tree; returns (stacked (k, B, ...) outputs,
    handoff)."""
    ks, kc = prng.split(key)
    if server_stride and server_stride > 1:
        x_cut = server_denoise_ddim(server_params, ks, y, shape, sched, cut,
                                    apply_fn, stride=server_stride)
    else:
        x_cut = server_denoise(server_params, ks, y, shape, sched, cut,
                               apply_fn)
    outs = [client_denoise(cp, prng.fold_in(kc, i), x_cut, y, sched, cut,
                           apply_fn, adjusted)
            for i, cp in enumerate(client_list(client_params_list))]
    return torch.stack(outs), x_cut


def collaborative_sample(server_params, client_params, key, y, shape,
                         sched: DiffusionSchedule, cut: CutPoint, apply_fn,
                         adjusted: bool = True, return_handoff: bool = False):
    """Full Alg. 2: server then client.  GM (t_ζ=0) and ICM (t_ζ=T) are
    the degenerate cases and need no special-casing."""
    ks, kc = prng.split(key)
    x_cut = server_denoise(server_params, ks, y, shape, sched, cut, apply_fn)
    x0 = client_denoise(client_params, kc, x_cut, y, sched, cut, apply_fn,
                        adjusted)
    if return_handoff:
        return x0, x_cut
    return x0


def server_handoff_for_eval(server_params, key, y, shape,
                            sched: DiffusionSchedule, cut: CutPoint,
                            apply_fn):
    """The x̂_{t_ζ} images the server would send — what the paper
    evaluates for information disclosure."""
    return server_denoise(server_params, key, y, shape, sched, cut, apply_fn)
