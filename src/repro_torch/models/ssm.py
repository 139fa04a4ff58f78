"""Mamba2 (SSD, state-space duality) mixer layer [arXiv:2405.21060].

The port of the JAX package's ``models/ssm.py``: ``mamba_init``,
``_causal_conv`` and ``mamba_forward`` (train / prefill; with
``return_state`` also the decode state it leaves), and the O(1) decode
step: ``ssd_decode_step``, ``_conv_decode``, ``mamba_init_state`` and
``mamba_decode``.  The chunked scan goes through ``kernels.ssd_scan.ops``
(the CUDA kernel on the card; on the CPU its plain version, the port of
``ssd_chunked``), whose final state seeds the decode.  The decode step is
plain torch, as it is plain JAX in the reference.

Shapes per layer: d_inner = expand · d_model, P = ssm_head_dim,
H = d_inner / P, N = ssm_state; x, B and C go through the depthwise conv.

Partitioned (``DTensor`` parameters and activations, models/
transformer.py): z, x and dt are cut over "model" by heads and channels,
B and C (``bc_proj``) are whole on every rank, ``A_log``, ``D``,
``dt_bias`` and the conv weights are replicated and meet the cut
operands as this rank's slice; ``out_norm`` is an RMSNorm over the cut
d_inner (its row statistic all-reduced), and ``out_proj``'s partial sums
are all-reduced into the residual.  The depthwise conv and the scan take
their local parts through ``local_map``.  The decode step takes its
state as ``ssm_state_specs`` lays it out: the SSM state by heads over
"model", the conv window whole (``mamba_decode``).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.core.schedules import linspace_f32
from repro_torch.kernels.mamba_mixer import kernel as mixer_kernel
from repro_torch.kernels.mamba_mixer import ops as mixer_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import (dense, fill, fill_dense, rmsnorm,
                                       rmsnorm_init)
from repro_torch.sharding import specs


class Mamba(nn.Module):
    """One Mamba2 mixer; attribute names are the JAX parameter keys.  The
    input projections stay split (z / x / BC / dt) as in JAX."""

    def __init__(self, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        d, di, n, h = (cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state,
                       cfg.ssm_n_heads)
        K = cfg.ssm_conv_kernel
        f32 = torch.float32
        empty = lambda *shape, dt=dtype: nn.Parameter(
            torch.empty(shape, dtype=dt, device=device))
        self.norm = rmsnorm_init(d, dtype, device)
        self.z_proj = dense(d, di, dtype, device)
        self.x_proj = dense(d, di, dtype, device)
        self.bc_proj = dense(d, 2 * n, dtype, device)
        self.dt_proj = dense(d, h, dtype, device)
        self.conv_x_w = empty(K, di)              # JAX (K, C) layout
        self.conv_x_b = empty(di)
        self.conv_bc_w = empty(K, 2 * n)
        self.conv_bc_b = empty(2 * n)
        self.A_log = empty(h, dt=f32)
        self.D = empty(h, dt=f32)
        self.dt_bias = empty(h, dt=f32)
        self.out_norm = rmsnorm_init(di, dtype, device)
        self.out_proj = dense(di, d, dtype, device)


def fill_mamba(m: Mamba, key: torch.Tensor, cfg: ArchConfig) -> None:
    """Draw a mixer's weights as JAX's ``mamba_init`` does for ``key``."""
    h, K = cfg.ssm_n_heads, cfg.ssm_conv_kernel
    dev = key.device
    k1, k2, k3, k4, k5, k6 = prng.split(key, 6)
    conv_scale = 1.0 / math.sqrt(K)
    fill_dense(m.z_proj, k1)
    fill_dense(m.x_proj, k2)
    fill_dense(m.bc_proj, k3)
    fill_dense(m.dt_proj, k4)
    fill(m.conv_x_w, prng.normal(k5, tuple(m.conv_x_w.shape)) * conv_scale)
    fill(m.conv_bc_w, prng.normal(k6, tuple(m.conv_bc_w.shape)) * conv_scale)
    fill(m.conv_x_b, torch.zeros_like(m.conv_x_b))
    fill(m.conv_bc_b, torch.zeros_like(m.conv_bc_b))
    fill(m.A_log, torch.log(torch.from_numpy(linspace_f32(1.0, 16.0, h))
                            ).to(dev))
    fill(m.D, torch.ones_like(m.D))
    fill(m.dt_bias, torch.full((h,), math.log(math.expm1(0.01)),
                               dtype=torch.float32, device=dev))
    fill_dense(m.out_proj, prng.fold_in(k1, 7))


def mamba_init(key: torch.Tensor, cfg: ArchConfig, dtype) -> Mamba:
    m = Mamba(cfg, dtype, key.device)
    fill_mamba(m, key, cfg)
    return m


def _causal_conv(xBC, w, b):
    """Depthwise causal conv then SiLU.  xBC: (B, S, C); w: (K, C)."""
    if isinstance(xBC, DTensor):
        return _conv_on_shards(xBC, w, b)
    K, C = w.shape
    lhs = F.pad(xBC.transpose(1, 2), (K - 1, 0))          # (B, C, S+K-1)
    out = F.conv1d(lhs, w.t().unsqueeze(1), groups=C)     # (B, C, S)
    return F.silu(out.transpose(1, 2) + b)


def _conv_on_shards(xBC, w, b):
    """``_causal_conv`` over a placed input: each rank's batch shard and
    channels, with the weight and bias sliced to its channels; their
    gradients are partial sums over the batch shards."""
    from torch.distributed.tensor.experimental import local_map
    (x_pl, _), (w_pl, w_grad), (b_pl, b_grad) = specs.local_map_placements(
        specs.mesh_kinds(xBC, 0, 2), (0, 2), (None, 1), (None, 0))
    return local_map(_causal_conv, out_placements=x_pl,
                     in_placements=(x_pl, w_pl, b_pl),
                     in_grad_placements=(x_pl, w_grad, b_grad),
                     device_mesh=xBC.device_mesh,
                     redistribute_inputs=True)(xBC, w, b)


def _conv_decode(conv_state, xBC_new, w, b):
    """conv_state: (B, K−1, Cd) the previous raw inputs; xBC_new: (B, Cd).
    Returns (SiLU of the conv's newest output, the next state).  A placed
    state (whole over "model", as ``ssm_state_specs`` lays it out) runs
    on each rank's batch shard through ``local_map``, with every channel
    of ``xBC_new`` (the caller gathers them)."""
    if isinstance(conv_state, DTensor):
        from torch.distributed.tensor.experimental import local_map
        (s_pl, _), (w_pl, _) = specs.local_map_placements(
            specs.mesh_kinds(conv_state, 0), (0, None), (None, None))
        return local_map(_conv_decode, out_placements=(s_pl, s_pl),
                         in_placements=(s_pl, s_pl, w_pl, w_pl),
                         device_mesh=conv_state.device_mesh,
                         redistribute_inputs=True)(conv_state, xBC_new, w, b)
    window = torch.cat([conv_state, xBC_new[:, None, :]], dim=1)  # (B,K,Cd)
    out = torch.einsum("bkc,kc->bc", window, w) + b
    return F.silu(out), window[:, 1:, :]


def ssd_decode_step(state, x, dt, A, B, C):
    """O(1) recurrent update.  state: (b, h, p, n); x: (b, h, p); dt:
    (b, h); B, C: (b, n).  Returns (y (b, h, p) in x's type, new state
    float32)."""
    f32 = torch.float32
    dA = torch.exp(dt.to(f32) * A.to(f32))                  # (b, h)
    dBx = torch.einsum("bn,bhp,bh->bhpn", B.to(f32), x.to(f32), dt.to(f32))
    new = dA[:, :, None, None] * state.to(f32) + dBx
    y = torch.einsum("bn,bhpn->bhp", C.to(f32), new)
    return y.to(x.dtype), new


def _ssd_decode_on_shards(state, x, dt, A, B, C):
    """``ssd_decode_step`` on placed operands through ``local_map``: each
    rank its batch shard and the heads the state's placements give it,
    with its slice of x, dt and A; B and C whole."""
    from torch.distributed.tensor.experimental import local_map
    (h_pl, _), (a_pl, _), (n_pl, _) = specs.local_map_placements(
        specs.mesh_kinds(state, 0, 1), (0, 1), (None, 0), (0, None))
    return local_map(ssd_decode_step, out_placements=(h_pl, h_pl),
                     in_placements=(h_pl, h_pl, h_pl, a_pl, n_pl, n_pl),
                     device_mesh=state.device_mesh,
                     redistribute_inputs=True)(state, x, dt, A, B, C)


def mamba_forward(params: Mamba, x, cfg: ArchConfig,
                  return_state: bool = False):
    """Full-sequence mixer with its residual.  x: (B, S, D).  With
    ``return_state``, also the decode state it leaves: the scan's final
    state (``ssm``, float32) and the last K−1 RAW conv inputs, x_raw ‖
    bc_raw (``conv``).

    Where ``mixer_ops.takes_kernels`` says so (plain CUDA or meta tensors,
    no gradient needed), the glue around the products and the scan runs
    as three fused kernels: the input norm, both convs + SiLU in one
    launch, and the D skip, gate and output norm in one; elsewhere the
    eager code below, whose bits the fused kernels give."""
    B_, S, _ = x.shape
    di, n, h, p = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads,
                   cfg.ssm_head_dim)
    eps = cfg.norm_eps
    fused = mixer_ops.takes_kernels(x, params)
    xn = mixer_kernel.launch_rmsnorm(x, params.norm.scale, eps) if fused \
        else rmsnorm(params.norm, x, eps)
    z = params.z_proj(xn)
    x_raw = params.x_proj(xn)
    bc_raw = params.bc_proj(xn)
    if fused:
        xc, Bm, Cm = mixer_kernel.launch_conv_silu(
            x_raw, bc_raw, params.conv_x_w, params.conv_x_b,
            params.conv_bc_w, params.conv_bc_b)
    else:
        xc = _causal_conv(x_raw, params.conv_x_w, params.conv_x_b)
        bc = _causal_conv(bc_raw, params.conv_bc_w, params.conv_bc_b)
        Bm, Cm = bc[..., :n], bc[..., n:]
    xs = xc.reshape(B_, S, h, p)
    dt = F.softplus(params.dt_proj(xn).float() + params.dt_bias)
    A = -torch.exp(params.A_log)
    y, final_state = ssd_ops.ssd_scan(xs, dt, A, Bm, Cm,
                                      min(cfg.ssm_chunk, S))
    if fused:
        y = mixer_kernel.launch_rmsnorm(y.reshape(B_, S, di),
                                        params.out_norm.scale, eps, xc,
                                        params.D, z)
    else:
        y = y + xs * params.D[None, None, :, None].to(y.dtype)
        y = y.reshape(B_, S, di)
        y = rmsnorm(params.out_norm, y * F.silu(z), eps)
    out = x + params.out_proj(y)
    if return_state:
        K = cfg.ssm_conv_kernel
        tails = [t[:, -(K - 1):] for t in (x_raw, bc_raw)]
        if isinstance(x, DTensor):
            # both as the batch is cut, whole on every other mesh dim
            tails = [t.redistribute(t.device_mesh, [
                p if p == Shard(0) else Replicate() for p in t.placements])
                for t in tails]
        conv_state = torch.cat(tails, dim=-1)
        return out, {"ssm": final_state, "conv": conv_state}
    return out


def mamba_init_state(cfg: ArchConfig, batch: int, dtype, device=None):
    """A zero decode state: the SSM state in float32, the conv state in
    the model's type."""
    di, n, h, p = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads,
                   cfg.ssm_head_dim)
    K = cfg.ssm_conv_kernel
    return {"ssm": torch.zeros((batch, h, p, n), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, K - 1, di + 2 * n), dtype=dtype,
                                device=device)}


def _batch_only(t):
    """A placed tensor whole on every mesh dim but those that cut its
    batch (dim 0); anything else as it is."""
    if not isinstance(t, DTensor):
        return t
    want = [p if p == Shard(0) else Replicate() for p in t.placements]
    return t if want == list(t.placements) else \
        t.redistribute(t.device_mesh, want)


def mamba_decode(params: Mamba, x, state, cfg: ArchConfig):
    """One-token step.  x: (B, 1, D); ``state`` from ``mamba_init_state``
    or a prefill.  Returns (out (B, 1, D), new state).

    Partitioned (the decode layout: ``ssm`` heads over "model", the conv
    window whole), the new column of x channels, cut over "model" by
    ``x_proj``, is gathered whole (B, di) on every rank, so the conv and
    its window run whole there; the SSD step then takes each rank's heads
    of it (a slice) with its heads of the state (``local_map``)."""
    B_ = x.shape[0]
    di, n, h, p = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads,
                   cfg.ssm_head_dim)
    xn = rmsnorm(params.norm, x[:, 0], cfg.norm_eps)
    z = params.z_proj(xn)
    xBC_raw = torch.cat([_batch_only(params.x_proj(xn)),
                         _batch_only(params.bc_proj(xn))], dim=-1)
    conv_w = torch.cat([params.conv_x_w, params.conv_bc_w], dim=-1)
    conv_b = torch.cat([params.conv_x_b, params.conv_bc_b], dim=-1)
    xBC, conv_state = _conv_decode(state["conv"], xBC_raw, conv_w, conv_b)
    xs = xBC[..., :di].reshape(B_, h, p)
    Bm, Cm = xBC[..., di:di + n], xBC[..., di + n:]
    dt = F.softplus(params.dt_proj(xn).float() + params.dt_bias)
    A = -torch.exp(params.A_log)
    if isinstance(state["ssm"], DTensor):
        y, ssm_state = _ssd_decode_on_shards(state["ssm"], xs, dt, A, Bm, Cm)
    else:
        y, ssm_state = ssd_decode_step(state["ssm"], xs, dt, A, Bm, Cm)
    y = y + xs * params.D[None, :, None].to(y.dtype)
    y = y.reshape(B_, di)
    y = rmsnorm(params.out_norm, y * F.silu(z), cfg.norm_eps)
    out = x + params.out_proj(y)[:, None, :]
    return out, {"ssm": ssm_state, "conv": conv_state}
