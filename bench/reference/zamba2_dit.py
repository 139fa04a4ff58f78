"""Zamba2 (arXiv:2411.15242) as a CollaFuse denoiser in the manner of DiT
(arXiv:2212.09748), in plain PyTorch over a ``{name: tensor}`` dict of
parameters, computed in float32 whatever type the weights are held in.

Images (B, H, W, C) are cut into p×p patches in raster order; a linear
map and a learned position table make the tokens; the sinusoidal
embedding of t through a two-layer SiLU MLP, plus a linear map of the
multi-hot labels, is added to every token.  The backbone is ``n_layers``
Mamba2 mixers with one shared attention + MLP block after every
``shared_attn_every`` of them, then an RMSNorm and a linear map back to
the patches.

* Mamba2 mixer (residual): RMSNorm; z, x, B·C and dt projections; a
  depthwise causal conv of width K then SiLU on x and on B·C; dt =
  softplus(dt + bias); A = −exp(A_log); the selective state-space scan
  over the sequence in its quadratic form, y_t = Σ_{s≤t} (C_t·B_s)
  exp(Σ_{s<r≤t} dt_r A) dt_s x_s per head, B and C shared by the heads;
  y + D·x; RMSNorm of y·SiLU(z); the output projection.
* Shared block: RMSNorm, multi-head attention with rotary positions over
  the whole (bidirectional) sequence, residual; RMSNorm, SwiGLU MLP,
  residual.

``precision="fp8"`` rounds both operands of every matrix product to
float8 e4m3 with a per-tensor scale (the control of a bfloat16 model).
The parameter names follow the program's modules.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 e4m3 rounding, back in float32."""
    s = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


PRECISIONS = {"fp32": lambda t: t, "fp8": round_fp8}


def dims(cfg: Dict) -> Dict[str, int]:
    d = cfg["d_model"]
    di = cfg["ssm_expand"] * d
    return {"d": d, "di": di, "n": cfg["ssm_state"],
            "h": di // cfg["ssm_head_dim"], "p": cfg["ssm_head_dim"],
            "K": cfg["ssm_conv_kernel"],
            "dh": cfg["head_dim"] or d // cfg["n_heads"],
            "patch": cfg["patch_size"] ** 2 * cfg["channels"],
            "tokens": (cfg["image_size"] // cfg["patch_size"]) ** 2}


def param_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter; kind says how it is drawn:
    ``w<fan in>`` a weight, ``conv``, ``pos``, ``one``, ``zero``, ``A``,
    ``dt``."""
    m = dims(cfg)
    d, di, n, h, K = m["d"], m["di"], m["n"], m["h"], m["K"]
    out = [("pos", (m["tokens"], d), "pos"),
           ("patch_in.weight", (d, m["patch"]), f"w{m['patch']}"),
           ("time_mlp.w1.weight", (d, d), f"w{d}"),
           ("time_mlp.w2.weight", (d, d), f"w{d}"),
           ("label_proj.weight", (d, cfg["n_classes"]),
            f"w{cfg['n_classes']}"),
           ("final_norm.scale", (d,), "one"),
           ("patch_out.weight", (m["patch"], d), f"w{d}")]
    for i in range(cfg["n_layers"]):
        pre = f"mamba.{i}."
        out += [(pre + "conv_x_w", (K, di), "conv"),
                (pre + "conv_x_b", (di,), "zero"),
                (pre + "conv_bc_w", (K, 2 * n), "conv"),
                (pre + "conv_bc_b", (2 * n,), "zero"),
                (pre + "A_log", (h,), "A"), (pre + "D", (h,), "one"),
                (pre + "dt_bias", (h,), "dt"),
                (pre + "norm.scale", (d,), "one"),
                (pre + "z_proj.weight", (di, d), f"w{d}"),
                (pre + "x_proj.weight", (di, d), f"w{d}"),
                (pre + "bc_proj.weight", (2 * n, d), f"w{d}"),
                (pre + "dt_proj.weight", (h, d), f"w{d}"),
                (pre + "out_norm.scale", (di,), "one"),
                (pre + "out_proj.weight", (d, di), f"w{di}")]
    if cfg["shared_attn_every"] > 0:
        hd = cfg["n_heads"] * m["dh"]
        kv = cfg["n_kv_heads"] * m["dh"]
        f = cfg["d_ff"]
        out += [("shared.norm1.scale", (d,), "one"),
                ("shared.attn.wq.weight", (hd, d), f"w{d}"),
                ("shared.attn.wk.weight", (kv, d), f"w{d}"),
                ("shared.attn.wv.weight", (kv, d), f"w{d}"),
                ("shared.attn.wo.weight", (d, hd), f"w{hd}"),
                ("shared.norm2.scale", (d,), "one"),
                ("shared.mlp.w_gate.weight", (f, d), f"w{d}"),
                ("shared.mlp.w_up.weight", (f, d), f"w{d}"),
                ("shared.mlp.w_down.weight", (d, f), f"w{f}")]
    return out


class _Net:
    def __init__(self, p, cfg, rnd):
        self.p, self.cfg, self.rnd = p, cfg, rnd
        self.eps = cfg["norm_eps"]

    def w(self, name):
        return self.p[name].float()

    def dense(self, name, x):
        return self.rnd(x) @ self.rnd(self.w(f"{name}.weight")).t()

    def norm(self, name, x):
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * self.w(f"{name}.scale")

    def conv(self, x, w, b):
        """Depthwise causal conv of width K, then SiLU; x (B, S, C)."""
        K, C = w.shape
        lhs = F.pad(x.transpose(1, 2), (K - 1, 0))
        out = F.conv1d(lhs, w.t().unsqueeze(1), groups=C)
        return F.silu(out.transpose(1, 2) + b)

    def mamba(self, i, x):
        m, pre = dims(self.cfg), f"mamba.{i}."
        B_, S, _ = x.shape
        h, p, n = m["h"], m["p"], m["n"]
        xn = self.norm(pre + "norm", x)
        z = self.dense(pre + "z_proj", xn)
        xs = self.conv(self.dense(pre + "x_proj", xn), self.w(pre + "conv_x_w"),
                       self.w(pre + "conv_x_b")).reshape(B_, S, h, p)
        bc = self.conv(self.dense(pre + "bc_proj", xn),
                       self.w(pre + "conv_bc_w"), self.w(pre + "conv_bc_b"))
        Bm, Cm = bc[..., :n], bc[..., n:]
        dt = F.softplus(self.dense(pre + "dt_proj", xn) +
                        self.w(pre + "dt_bias"))                  # (B,S,h)
        A = -torch.exp(self.w(pre + "A_log"))
        L = torch.cumsum(dt * A, dim=1)                           # (B,S,h)
        diff = L[:, :, None, :] - L[:, None, :, :]                # (B,t,s,h)
        keep = torch.tril(torch.ones(S, S, dtype=torch.bool,
                                     device=x.device))[None, :, :, None]
        decay = torch.exp(torch.where(keep, diff, torch.full_like(diff,
                                                                  -1e30)))
        cb = self.rnd(Cm) @ self.rnd(Bm).transpose(1, 2)          # (B,t,s)
        scores = cb[..., None] * decay * dt[:, None, :, :]        # (B,t,s,h)
        y = torch.einsum("btsh,bshp->bthp", self.rnd(scores), self.rnd(xs))
        y = y + xs * self.w(pre + "D")[None, None, :, None]
        y = y.reshape(B_, S, m["di"])
        y = self.norm(pre + "out_norm", y * F.silu(z))
        return x + self.dense(pre + "out_proj", y)

    def rope(self, x):
        """x (B, H, S, dh) at positions 0..S−1, the pairs (2j, 2j+1)."""
        dh, S = x.shape[-1], x.shape[-2]
        rot = int(dh * self.cfg["rope_fraction"])
        rot -= rot % 2
        idx = torch.arange(0, rot, 2, device=x.device).float()
        inv = 1.0 / (self.cfg["rope_theta"] ** (idx / rot))
        ang = torch.arange(S, device=x.device).float()[:, None] * inv
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., :rot:2], x[..., 1:rot:2]
        y = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return torch.cat([y.reshape(x[..., :rot].shape), x[..., rot:]], -1)

    def shared(self, x):
        m, cfg = dims(self.cfg), self.cfg
        B_, S, _ = x.shape
        hn = self.norm("shared.norm1", x)
        heads = lambda t, k: t.reshape(B_, S, k, m["dh"]).transpose(1, 2)
        q = self.rope(heads(self.dense("shared.attn.wq", hn), cfg["n_heads"]))
        k = self.rope(heads(self.dense("shared.attn.wk", hn),
                            cfg["n_kv_heads"]))
        v = heads(self.dense("shared.attn.wv", hn), cfg["n_kv_heads"])
        rep = cfg["n_heads"] // cfg["n_kv_heads"]
        k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        s = (self.rnd(q) @ self.rnd(k).transpose(-1, -2)) / \
            math.sqrt(m["dh"])
        a = self.rnd(torch.softmax(s, dim=-1)) @ self.rnd(v)
        x = x + self.dense("shared.attn.wo",
                           a.transpose(1, 2).reshape(B_, S, -1))
        hn = self.norm("shared.norm2", x)
        g = F.silu(self.dense("shared.mlp.w_gate", hn)) * \
            self.dense("shared.mlp.w_up", hn)
        return x + self.dense("shared.mlp.w_down", g)


def _embedding(t, dim: int):
    half = dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=t.device)
    args = t.float()[:, None] * torch.exp(-math.log(10_000.0) * idx / half)
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def forward(p: Dict[str, torch.Tensor], cfg: Dict, x, t, y,
            precision: str = "fp32") -> torch.Tensor:
    """ε̂ (B, H, W, C) in float32."""
    net = _Net(p, cfg, PRECISIONS[precision])
    B_, H, W, C = x.shape
    ps = cfg["patch_size"]
    tok = x.float().reshape(B_, H // ps, ps, W // ps, ps, C) \
        .permute(0, 1, 3, 2, 4, 5).reshape(B_, -1, ps * ps * C)
    h = net.dense("patch_in", tok) + net.w("pos")[None]
    temb = _embedding(torch.as_tensor(t), cfg["d_model"])
    cond = net.dense("time_mlp.w2", F.silu(net.dense("time_mlp.w1", temb)))
    cond = cond + net.dense("label_proj", y.float())
    h = h + cond[:, None, :]
    g = cfg["shared_attn_every"]
    groups = cfg["n_layers"] // g if g > 0 else 0
    i = 0
    for _ in range(groups):
        for _ in range(g):
            h = net.mamba(i, h)
            i += 1
        h = net.shared(h)
    for j in range(i, cfg["n_layers"]):
        h = net.mamba(j, h)
    h = net.norm("final_norm", h)
    out = net.dense("patch_out", h)
    return out.reshape(B_, H // ps, W // ps, ps, ps, C) \
        .permute(0, 1, 3, 2, 4, 5).reshape(B_, H, W, C).contiguous()
