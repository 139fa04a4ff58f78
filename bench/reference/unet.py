"""The DDPM U-Net denoiser ε(x_t, t, y) of Ho et al. (arXiv:2006.11239)
as CollaFuse (arXiv:2406.14429 §4.1) uses it: a plain PyTorch forward over
a ``{name: tensor}`` dict of parameters, with no module of the program.

x is NHWC (B, H, W, C), t real timesteps (B,), y multi-hot labels
(B, n_classes).  Layout: a stem conv, levels of residual blocks (GroupNorm
in float32 with the biased variance and eps 1e-5, SiLU, 3×3 convs, the
time and label embedding added per channel, a 1×1 skip where the width
changes), self-attention at the resolutions listed, stride-2 3×3 convs
down with the odd padding at the end, nearest 2× upsampling then a 3×3
conv up, skip concatenation, and GroupNorm, SiLU and a 3×3 conv out.
The parameter names follow the program's modules, so one dict of weights
loads into both.

``rnd`` rounds every operand of a convolution or a matrix product before
it is taken (the identity for float32; ``tf32`` for the control, which
rounds to the 10-bit mantissa that TF32 tensor cores read).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F


def ident(t: torch.Tensor) -> torch.Tensor:
    return t


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 mantissa bits, to nearest even; the
    gradient passes through unchanged."""
    b = t.detach().contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    r = ((b + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    return t + (r - t.detach()) if t.requires_grad else r


PRECISIONS: Dict[str, Callable] = {"fp32": ident, "tf32": round_tf32}


def _groups(channels: int, groups: int) -> int:
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


def param_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], int]]:
    """(name, shape, fan_in) of every parameter, in the program's order;
    fan_in 0 marks a GroupNorm scale (ones) or a bias (zeros)."""
    out: List = []
    td = cfg["time_dim"]
    widths = [cfg["base_width"] * m for m in cfg["width_mults"]]

    def dense(name, d_in, d_out):
        out.append((f"{name}.weight", (d_out, d_in), d_in))

    def conv(name, cin, cout, k):
        out.append((f"{name}.weight", (cout, cin, k, k), cin * k * k))
        out.append((f"{name}.bias", (cout,), 0))

    def gn(name, c):
        out.append((f"{name}.weight", (c,), -1))
        out.append((f"{name}.bias", (c,), 0))

    def res(name, cin, cout):
        gn(f"{name}.gn1", cin)
        conv(f"{name}.conv1", cin, cout, 3)
        dense(f"{name}.time", td, cout)
        gn(f"{name}.gn2", cout)
        conv(f"{name}.conv2", cout, cout, 3)
        if cin != cout:
            conv(f"{name}.skip", cin, cout, 1)

    def attn(name, c):
        gn(f"{name}.gn", c)
        for w in ("wq", "wk", "wv", "wo"):
            dense(f"{name}.{w}", c, c)

    dense("time_mlp.w1", td, td)
    dense("time_mlp.w2", td, td)
    dense("label_proj", cfg["n_classes"], td)
    conv("stem", cfg["channels"], widths[0], 3)
    gn("out_gn", widths[0])
    conv("out_conv", widths[0], cfg["channels"], 3)
    res_px, skips, cin = cfg["image_size"], [widths[0]], widths[0]
    for i, w in enumerate(widths):
        for j in range(cfg["n_res_blocks"]):
            res(f"down.{i}.res.{j}", cin, w)
            cin = w
            skips.append(w)
        for j in range(cfg["n_res_blocks"]):
            if res_px in cfg["attn_resolutions"]:
                attn(f"down.{i}.attn.{j}", w)
        if i < len(widths) - 1:
            conv(f"down.{i}.down", w, w, 3)
            skips.append(w)
            res_px //= 2
    res(f"mid.res1", cin, cin)
    attn("mid.attn", cin)
    res(f"mid.res2", cin, cin)
    for n, (i, w) in enumerate(reversed(list(enumerate(widths)))):
        for j in range(cfg["n_res_blocks"] + 1):
            res(f"up.{n}.res.{j}", cin + skips.pop(), w)
            cin = w
        for j in range(cfg["n_res_blocks"] + 1):
            if res_px in cfg["attn_resolutions"]:
                attn(f"up.{n}.attn.{j}", w)
        if i > 0:
            conv(f"up.{n}.up", w, w, 3)
            res_px *= 2
    return out


def _embedding(t, dim: int) -> torch.Tensor:
    half = dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(-math.log(10_000.0) * idx / half)
    args = t.float()[:, None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class _Net:
    def __init__(self, p: Dict[str, torch.Tensor], cfg: Dict, rnd):
        self.p, self.cfg, self.rnd = p, cfg, rnd

    def dense(self, name, x):
        return self.rnd(x) @ self.rnd(self.p[f"{name}.weight"]).t()

    def conv(self, name, x, stride: int = 1):
        w = self.p[f"{name}.weight"]
        k = w.shape[-1]
        if stride == 1 and k % 2 == 1:
            pad = k // 2
        else:
            pads = []
            for n in (x.shape[-1], x.shape[-2]):
                total = max((-(-n // stride) - 1) * stride + k - n, 0)
                pads += [total // 2, total - total // 2]
            x, pad = F.pad(x, pads), 0
        return F.conv2d(self.rnd(x), self.rnd(w), self.p[f"{name}.bias"],
                        stride=stride, padding=pad)

    def gn(self, name, x):
        g = _groups(x.shape[1], self.cfg["groupnorm_groups"])
        return F.group_norm(x, g, self.p[f"{name}.weight"],
                            self.p[f"{name}.bias"], 1e-5)

    def res(self, name, x, emb):
        h = self.conv(f"{name}.conv1", F.silu(self.gn(f"{name}.gn1", x)))
        h = h + self.dense(f"{name}.time", F.silu(emb))[:, :, None, None]
        h = self.conv(f"{name}.conv2", F.silu(self.gn(f"{name}.gn2", h)))
        skip = self.conv(f"{name}.skip", x) \
            if f"{name}.skip.weight" in self.p else x
        return skip + h

    def attn(self, name, x):
        B, C, H, W = x.shape
        nh = self.cfg["n_heads"]
        dh = C // nh
        h = self.gn(f"{name}.gn", x).flatten(2).transpose(1, 2)
        split = lambda t: t.reshape(B, H * W, nh, dh).transpose(1, 2)
        q, k, v = (split(self.dense(f"{name}.{w}", h))
                   for w in ("wq", "wk", "wv"))
        logits = self.rnd(q) @ self.rnd(k).transpose(-1, -2)
        w = torch.softmax(logits / math.sqrt(dh), dim=-1)
        o = (self.rnd(w) @ self.rnd(v)).transpose(1, 2).reshape(B, H * W, C)
        o = self.dense(f"{name}.wo", o)
        return x + o.transpose(1, 2).reshape(B, C, H, W)


def forward(p: Dict[str, torch.Tensor], cfg: Dict, x, t, y,
            precision: str = "fp32") -> torch.Tensor:
    """ε̂ (B, H, W, C) in float32."""
    n = _Net(p, cfg, PRECISIONS[precision])
    widths = [cfg["base_width"] * m for m in cfg["width_mults"]]
    temb = _embedding(t, cfg["time_dim"])
    emb = n.dense("time_mlp.w2", F.silu(n.dense("time_mlp.w1", temb)))
    emb = emb + n.dense("label_proj", y.float())
    h = n.conv("stem", x.float().permute(0, 3, 1, 2).contiguous())
    skips = [h]
    res_px = cfg["image_size"]
    for i in range(len(widths)):
        for j in range(cfg["n_res_blocks"]):
            h = n.res(f"down.{i}.res.{j}", h, emb)
            if res_px in cfg["attn_resolutions"]:
                h = n.attn(f"down.{i}.attn.{j}", h)
            skips.append(h)
        if i < len(widths) - 1:
            h = n.conv(f"down.{i}.down", h, stride=2)
            skips.append(h)
            res_px //= 2
    h = n.res("mid.res1", h, emb)
    h = n.attn("mid.attn", h)
    h = n.res("mid.res2", h, emb)
    for k, i in enumerate(reversed(range(len(widths)))):
        for j in range(cfg["n_res_blocks"] + 1):
            h = torch.cat([h, skips.pop()], dim=1)
            h = n.res(f"up.{k}.res.{j}", h, emb)
            if res_px in cfg["attn_resolutions"]:
                h = n.attn(f"up.{k}.attn.{j}", h)
        if i > 0:
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = n.conv(f"up.{k}.up", h)
            res_px *= 2
    h = F.silu(n.gn("out_gn", h))
    return n.conv("out_conv", h).permute(0, 2, 3, 1).contiguous()
