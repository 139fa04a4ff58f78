"""Plain PyTorch version of the SSD scan kernel: the port of the JAX
package's ``models/ssm.ssd_chunked`` (which ``kernels/ssd_scan/ref.py``
re-exports there as the kernel's oracle).

As in JAX, the heavy (q- and p-sized) tensors stay in the input type (bf16
at full width) and only dt, the log-decay L and the recurrent state are
float32; each contraction runs on float32 copies of its operands (JAX's
``preferred_element_type=float32``) and is cast back where JAX casts.
The CUDA kernel computes in float32 throughout, so the two agree to bf16
tolerance in bf16 and to 1e-4 / 1e-3 in float32.
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
