"""Plain PyTorch version of the SSD scan kernel: the port of the JAX
package's ``models/ssm.ssd_chunked`` (which ``kernels/ssd_scan/ref.py``
re-exports there as the kernel's oracle).

As in JAX, the heavy (q- and p-sized) tensors stay in the input type (bf16
at full width) and only dt, the log-decay L and the recurrent state are
float32; each contraction runs on float32 copies of its operands (JAX's
``preferred_element_type=float32``) and is cast back where JAX casts.
The CUDA kernel computes in float32 throughout, so the two agree to bf16
tolerance in bf16 and to 1e-4 / 1e-3 in float32.

``ssd_chunked_bwd_ref`` is the backward kernel's algorithm
(csrc/ssd_scan_bwd.cu) written out step by step in float32: the chunk
states recomputed, the state gradient carried backwards over the chunks,
then every chunk's gradients from its own inputs and the two states at its
ends.  The tests hold it against autograd of ``ssd_chunked`` and
``jax.vjp`` of the JAX package's; chip_smoke.py holds the CUDA backward
against it on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """Chunked state-space-duality scan.

    x:  (b, s, h, p)   per-head inputs
    dt: (b, s, h)      positive step sizes (softplus applied by the caller)
    A:  (h,)           negative per-head decay rates
    B:  (b, s, n)      input projections (one group, shared by all heads)
    C:  (b, s, n)      output projections
    Returns (y (b, s, h, p) in x's type, final_state (b, h, p, n) float32).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    # pad the tail with dt = 0 steps: decay e^0 = 1 and zero input keep the
    # recurrence exact; the padded rows of y are dropped
    pad = (-s) % chunk
    if pad:
        zpad = lambda t: F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        x, dt, B, C = zpad(x), zpad(dt), zpad(B), zpad(C)
    s_p = s + pad
    nc, q = s_p // chunk, chunk
    f32 = torch.float32
    cdt = x.dtype
    xr = x.reshape(b, nc, q, h, p)
    dtr = dt.to(f32).reshape(b, nc, q, h)
    Br = B.to(cdt).reshape(b, nc, q, n)
    Cr = C.to(cdt).reshape(b, nc, q, n)

    dtx = xr * dtr.to(cdt)[..., None]                    # (b,nc,q,h,p)
    dA = dtr * A.to(f32)                                 # <= 0
    L = torch.cumsum(dA, dim=2)                          # (b,nc,q,h) fp32

    # intra-chunk; e^{L_t - L_s} only on and below the diagonal (above it
    # overflows)
    diff = L[:, :, :, None, :] - L[:, :, None, :, :]     # (b,nc,t,s,h)
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    causal = causal[None, None, :, :, None]
    decay = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)),
                        0.0).to(cdt)
    CB = torch.einsum("bctn,bcsn->bcts", Cr.to(f32), Br.to(f32)).to(cdt)
    y_intra = torch.einsum("bcts,bctsh,bcshp->bcthp", CB.to(f32),
                           decay.to(f32), dtx.to(f32))

    # chunk summary states
    decay_to_end = torch.exp(L[:, :, -1:, :] - L).to(cdt)   # (b,nc,q,h)
    S_c = torch.einsum("bcqn,bcqhp,bcqh->bchpn", Br.to(f32), dtx.to(f32),
                       decay_to_end.to(f32))

    # inter-chunk recurrence over chunks, fp32 state
    chunk_decay = torch.exp(L[:, :, -1, :])                  # (b,nc,h)
    hcur = (torch.zeros(b, h, p, n, dtype=f32, device=x.device)
            if initial_state is None else initial_state.to(f32))
    before = []
    for c in range(nc):
        before.append(hcur)                                  # state BEFORE c
        hcur = chunk_decay[:, c, :, None, None] * hcur + S_c[:, c]
    h_before = torch.stack(before, dim=1)                    # (b,nc,h,p,n)

    y_inter = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cr.to(f32),
                           h_before.to(cdt).to(f32),
                           torch.exp(L).to(cdt).to(f32))
    y = (y_intra + y_inter).reshape(b, s_p, h, p)[:, :s]
    return y.to(x.dtype), hcur


def ssd_chunked_bwd_ref(x, dt, A, B, C, chunk: int, dy, dfinal=None):
    """(dx, ddt, dA, dB, dC) of ``ssd_chunked(x, dt, A, B, C, chunk)``
    from a zero state, for the gradients ``dy`` of y and ``dfinal`` of
    the final state (None: zero, as in training).  Float32 throughout;
    dx, dB and dC come back in the types of x, B and C, ddt and dA in
    float32.

    Per chunk c of q steps with dtx_s = dt_s·x_s, L the in-chunk cumsum
    of dt·A, h_c the state before the chunk and G_c = ∂/∂h_{c+1} (the
    gradient of the state after it):

    * states: h_{c+1} = e^{L_end} h_c + Σ_s e^{L_end−L_s} dtx_s B_sᵀ
      forwards, G_{c−1} = e^{L_end} G_c + Σ_t e^{L_t} dy_t C_tᵀ backwards
      from G = dfinal;
    * with W_ts = e^{L_t−L_s} for s <= t (else 0) and DD_ts = dy_t·dtx_s:
      d(dtx)_s = Σ_t (C_t·B_s) W_ts dy_t + e^{L_end−L_s} G_c B_s,
      dB_s = Σ_t W_ts DD_ts C_t + e^{L_end−L_s} G_cᵀ dtx_s,
      dC_t = Σ_s W_ts DD_ts B_s + e^{L_t} h_cᵀ dy_t;
    * dL_t = Σ_s M_ts − Σ_s M_st + e^{L_t} dy_t·h_c C_t − Q_t, with
      M_ts = (C_t·B_s) W_ts DD_ts and Q_s = e^{L_end−L_s} dtx_sᵀ G_c B_s;
      the chunk's last step adds Σ_s Q_s + e^{L_end} ⟨G_c, h_c⟩;
    * da = the reverse cumsum of dL in the chunk; dx = dt·d(dtx),
      ddt = x·d(dtx) + A·da, dA = Σ dt·da.

    The tail is padded with dt = 0 steps (x, B, C, dy zero), as the
    forward pads it: their gradients are dropped, and dt = 0 keeps them
    out of dA."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    f32 = torch.float32
    pad = (-s) % chunk
    zpad = lambda t: F.pad(t.to(f32), (0, 0) * (t.ndim - 2) + (0, pad))
    s_p = s + pad
    nc, q = s_p // chunk, chunk
    xr = zpad(x).reshape(b, nc, q, h, p)
    dtr = zpad(dt).reshape(b, nc, q, h)
    Br = zpad(B).reshape(b, nc, q, n)
    Cr = zpad(C).reshape(b, nc, q, n)
    dyr = zpad(dy).reshape(b, nc, q, h, p)
    Af = A.to(f32)

    dtx = xr * dtr[..., None]                                # (b,nc,q,h,p)
    L = torch.cumsum(dtr * Af, dim=2)                        # (b,nc,q,h)
    Lend = L[:, :, -1]                                       # (b,nc,h)
    to_end = torch.exp(Lend[:, :, None] - L)                 # e^{L_end−L_s}
    eL = torch.exp(L)

    # the states at both ends of every chunk
    S_c = torch.einsum("bcsn,bcshp,bcsh->bchpn", Br, dtx, to_end)
    U_c = torch.einsum("bcthp,bctn,bcth->bchpn", dyr, Cr, eL)
    hcur = torch.zeros(b, h, p, n, dtype=f32, device=x.device)
    before = []
    for c in range(nc):
        before.append(hcur)
        hcur = torch.exp(Lend[:, c])[..., None, None] * hcur + S_c[:, c]
    gcur = (torch.zeros(b, h, p, n, dtype=f32, device=x.device)
            if dfinal is None else dfinal.to(f32))
    after = [None] * nc
    for c in reversed(range(nc)):
        after[c] = gcur
        gcur = torch.exp(Lend[:, c])[..., None, None] * gcur + U_c[:, c]
    Hb = torch.stack(before, dim=1)                          # (b,nc,h,p,n)
    Ga = torch.stack(after, dim=1)

    # in-chunk products; W only on and below the diagonal
    tril = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    tril = tril[None, None, :, :, None]
    diff = L[:, :, :, None, :] - L[:, :, None, :, :]         # (b,nc,t,s,h)
    W = torch.where(tril, torch.exp(torch.where(tril, diff, 0.0)), 0.0)
    CB = torch.einsum("bctn,bcsn->bcts", Cr, Br)
    DD = torch.einsum("bcthp,bcshp->bctsh", dyr, dtx)
    CBW = CB[..., None] * W
    WDD = W * DD
    M = CBW * DD

    GB = torch.einsum("bchpn,bcsn->bcshp", Ga, Br)           # G_c B_s
    ddtx = torch.einsum("bctsh,bcthp->bcshp", CBW, dyr) + \
        to_end[..., None] * GB
    dBr = torch.einsum("bctsh,bctn->bcsn", WDD, Cr) + \
        torch.einsum("bcsh,bchpn,bcshp->bcsn", to_end, Ga, dtx)
    hC = torch.einsum("bchpn,bctn->bcthp", Hb, Cr)           # h_c C_t
    dCr = torch.einsum("bctsh,bcsn->bctn", WDD, Br) + \
        torch.einsum("bcth,bchpn,bcthp->bctn", eL, Hb, dyr)

    Q = to_end * (dtx * GB).sum(-1)                          # (b,nc,q,h)
    dL = M.sum(dim=3) - M.sum(dim=2) + eL * (dyr * hC).sum(-1) - Q
    dL[:, :, -1] += Q.sum(dim=2) + torch.exp(Lend) * (Ga * Hb).sum((-1, -2))
    da = torch.flip(torch.cumsum(torch.flip(dL, [2]), dim=2), [2])

    dx = dtr[..., None] * ddtx
    ddt = (xr * ddtx).sum(-1) + Af * da
    dA = (dtr * da).sum((0, 1, 2))
    unpad = lambda t, *tail: t.reshape(b, s_p, *tail)[:, :s]
    return (unpad(dx, h, p).to(x.dtype), unpad(ddt, h), dA,
            unpad(dBr, n).to(B.dtype), unpad(dCr, n).to(C.dtype))
