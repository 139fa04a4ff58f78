"""CollaFuse Alg. 2 for a few requests, row by row, in plain PyTorch: the
reference the served samples are held against.

For each checked request the server prefix is recomputed from the run's
key (the program may have served it from its cache): x_T and the noise of
server step s are the row-keyed normals of fold_in(fold_in(skey, seed),
0) and of fold_in(…, 1 + s), where ``seed`` is the prefix's content digest
and (skey, ckey) = split(key).  The client then finishes with its own
model, the noise of its step c from fold_in(fold_in(ckey, arrival id), c),
over the remapped timesteps.  Only the rows asked for are computed: every
draw is keyed by its row.  Requests run in lockstep, one model call a
step over the rows of every request still in its server phase (they share
the timestep T − s), then one call a step per request for the client
phases.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from bench.reference import diffusion as dif
from bench.reference import threefry as tf


class Checked(NamedTuple):
    client: int
    t_cut: int
    y: np.ndarray            # (images, n_classes): the whole request's
    rid: int                 # arrival id: the order the runtime got it in
    rows: np.ndarray         # the row indices compared


@torch.no_grad()
def sample(eps_fn: Callable, server_w, client_w: Sequence, key, T: int,
           image_shape, reqs: List[Checked], device) -> List[torch.Tensor]:
    """The rows ``r.rows`` of each request's sample, float32.
    ``eps_fn(weights, x, t, y)`` is the denoiser."""
    sched = dif.Schedule(T, device)
    skey, ckey = tf.split(key.to(device))
    xs, gkeys, steps, ys = [], [], [], []
    for r in reqs:
        rows = torch.as_tensor(r.rows, device=device)
        gk = tf.fold_in(skey, dif.prefix_seed(r.t_cut, r.y))
        shape = (len(r.y),) + tuple(image_shape)
        xs.append(tf.rowwise_normal(tf.fold_in(gk, 0), shape, rows))
        gkeys.append(gk)
        steps.append(T - r.t_cut)
        ys.append(torch.as_tensor(r.y[r.rows], device=device))
    # server phases in lockstep: every live request is at t = T − s
    for s in range(max(steps, default=0)):
        live = [i for i, n in enumerate(steps) if s < n]
        x = torch.cat([xs[i] for i in live])
        y = torch.cat([ys[i] for i in live])
        t = float(T - s)
        eps = eps_fn(server_w, x, torch.full((x.shape[0],), t,
                                             device=device), y)
        at = 0
        for i in live:
            n = xs[i].shape[0]
            tp = float(reqs[i].t_cut) if s == steps[i] - 1 else t - 1.0
            a, c, sg = sched.coefficients(t, tp)
            rows = torch.as_tensor(reqs[i].rows, device=device)
            shape = (len(reqs[i].y),) + tuple(image_shape)
            noise = tf.rowwise_normal(tf.fold_in(gkeys[i], 1 + s), shape,
                                      rows)
            xs[i] = dif.reverse_step(xs[i], eps[at:at + n], noise, a, c, sg)
            at += n
    out = []
    for i, r in enumerate(reqs):
        rk = tf.fold_in(ckey, r.rid & 0x7FFFFFFF)
        tl, tpl = dif.client_steps(T, r.t_cut)
        rows = torch.as_tensor(r.rows, device=device)
        shape = (len(r.y),) + tuple(image_shape)
        x = xs[i]
        for c in range(r.t_cut):
            t = float(tl[c])
            eps = eps_fn(client_w[r.client], x,
                         torch.full((x.shape[0],), t, device=device), ys[i])
            a, cf, sg = sched.coefficients(t, float(tpl[c]))
            noise = tf.rowwise_normal(tf.fold_in(rk, c), shape, rows)
            x = dif.reverse_step(x, eps, noise, a, cf, sg)
        out.append(x)
    return out
