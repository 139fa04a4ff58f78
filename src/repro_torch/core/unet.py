"""DDPM U-Net denoiser ε_θ(x_t, t, y) [Ho et al. 2020; CollaFuse §4.1].

The public interface is NHWC, as in the JAX package: ``UNet(cfg)(x, t, y)``
takes x (B, H, W, C), real-valued timesteps t (B,) and multi-hot labels y
(B, n_classes) and returns ε̂ of x's shape.  Inside it runs NCHW.  Module
attribute names follow the JAX parameter tree (``time_mlp.w1``,
``down[i].res[j].conv1`` …) so bridge.py maps one onto the other, and
``init_unet`` draws every weight with the port's threefry in the JAX
package's key order, so both packages hold the same weights for the same
key.

Numerics kept from the reference: GroupNorm statistics in fp32 with the
biased variance and eps 1e-5, with the group count lowered until it
divides C; attention as matmul + softmax over fp32 logits; 2× nearest
upsampling; XLA's ``SAME`` padding, which for the stride-2 downsampling
conv of an even input puts the one padded row and column at the end.

The parameters are in ``cfg.dtype``, drawn in float32, scaled, then
cast, as the reference draws them, and the forward runs in that dtype:
x is cast to it on entry (the reference's convolution takes its input
in the weights' dtype), the time embedding takes x's dtype, GroupNorm
runs in float32 and casts back, and ε̂ comes out in ``cfg.dtype`` (the
samplers cast it to float32 for the DDPM-step kernels).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch import bridge
from repro_torch.configs.ddpm_unet import UNetConfig
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.models.layers import dense_init, sinusoidal_embedding


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def norm_groups(channels: int, groups: int) -> int:
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


class GroupNorm(nn.Module):
    def __init__(self, channels: int, groups: int, eps: float = 1e-5):
        super().__init__()
        self.groups = norm_groups(channels, groups)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        y = F.group_norm(x.float(), self.groups, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class Conv2dSame(nn.Conv2d):
    """Square-kernel conv with XLA's ``SAME`` padding: the total padding
    max((⌈n/s⌉−1)·s + k − n, 0) is split with the odd row/column at the
    end.  ``bias=False`` gives the bare ``conv_general_dilated`` of the
    evaluation nets (eval/)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 bias: bool = True):
        symmetric = stride == 1 and k % 2 == 1
        super().__init__(cin, cout, k, stride=stride,
                         padding=k // 2 if symmetric else 0, bias=bias)
        self._symmetric = symmetric

    def forward(self, x):
        if not self._symmetric:
            k, s = self.kernel_size[0], self.stride[0]
            pads = []
            for n in (x.shape[-1], x.shape[-2]):
                total = max((-(-n // s) - 1) * s + k - n, 0)
                pads += [total // 2, total - total // 2]
            x = F.pad(x, pads)
        return super().forward(x)


def _dense(d_in: int, d_out: int) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=False)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, time_dim: int, groups: int):
        super().__init__()
        self.gn1 = GroupNorm(cin, groups)
        self.conv1 = Conv2dSame(cin, cout, 3)
        self.time = _dense(time_dim, cout)
        self.gn2 = GroupNorm(cout, groups)
        self.conv2 = Conv2dSame(cout, cout, 3)
        self.skip = Conv2dSame(cin, cout, 1) if cin != cout else None

    def forward(self, x, emb):
        h = self.conv1(F.silu(self.gn1(x)))
        h = h + self.time(F.silu(emb))[:, :, None, None]
        h = self.conv2(F.silu(self.gn2(h)))
        skip = self.skip(x) if self.skip is not None else x
        return skip + h


class AttnBlock(nn.Module):
    def __init__(self, c: int, n_heads: int, groups: int):
        super().__init__()
        self.n_heads = n_heads
        self.gn = GroupNorm(c, groups)
        self.wq, self.wk, self.wv, self.wo = (_dense(c, c) for _ in range(4))

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.gn(x).flatten(2).transpose(1, 2)            # (B, HW, C)
        dh = C // self.n_heads
        split = lambda t: t.reshape(B, H * W, self.n_heads, dh).transpose(1, 2)
        q, k, v = split(self.wq(h)), split(self.wk(h)), split(self.wv(h))
        logits = (q @ k.transpose(-1, -2)).float()
        w = torch.softmax(logits / math.sqrt(dh), dim=-1).to(v.dtype)
        o = (w @ v).transpose(1, 2).reshape(B, H * W, C)
        o = self.wo(o)
        return x + o.transpose(1, 2).reshape(B, C, H, W)


class Level(nn.Module):
    """One resolution level: res blocks, their attention slots (None where
    the resolution has no attention), and the down- or up-sampling conv."""

    def __init__(self, res: List[ResBlock], attn: List[Optional[AttnBlock]],
                 down: Optional[nn.Module] = None,
                 up: Optional[nn.Module] = None):
        super().__init__()
        self.res = nn.ModuleList(res)
        self.attn = nn.ModuleList(attn)
        self.down = down
        self.up = up


# ---------------------------------------------------------------------------
# U-Net
# ---------------------------------------------------------------------------


def _level_widths(cfg: UNetConfig) -> List[int]:
    return [cfg.base_width * m for m in cfg.width_mults]


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        td, g = cfg.time_dim, cfg.groupnorm_groups
        widths = _level_widths(cfg)
        attn = lambda c: AttnBlock(c, cfg.n_heads, g)
        self.time_mlp = nn.ModuleDict({"w1": _dense(td, td),
                                       "w2": _dense(td, td)})
        self.label_proj = _dense(cfg.n_classes, td)
        self.stem = Conv2dSame(cfg.channels, widths[0], 3)
        self.out_gn = GroupNorm(widths[0], g)
        self.out_conv = Conv2dSame(widths[0], cfg.channels, 3)

        res = cfg.image_size
        down, skips_c = [], [widths[0]]
        cin = widths[0]
        for i, w in enumerate(widths):
            blocks, attns = [], []
            for _ in range(cfg.n_res_blocks):
                blocks.append(ResBlock(cin, w, td, g))
                attns.append(attn(w) if res in cfg.attn_resolutions
                             else None)
                cin = w
                skips_c.append(w)
            dconv = None
            if i < len(widths) - 1:
                dconv = Conv2dSame(w, w, 3, stride=2)
                skips_c.append(w)
                res //= 2
            down.append(Level(blocks, attns, down=dconv))
        self.down = nn.ModuleList(down)
        self.mid = nn.ModuleDict({"res1": ResBlock(cin, cin, td, g),
                                  "attn": attn(cin),
                                  "res2": ResBlock(cin, cin, td, g)})
        up = []
        for i, w in reversed(list(enumerate(widths))):
            blocks, attns = [], []
            for _ in range(cfg.n_res_blocks + 1):
                sc = skips_c.pop()
                blocks.append(ResBlock(cin + sc, w, td, g))
                attns.append(attn(w) if res in cfg.attn_resolutions
                             else None)
                cin = w
            uconv = None
            if i > 0:
                uconv = Conv2dSame(w, w, 3)
                res *= 2
            up.append(Level(blocks, attns, up=uconv))
        self.up = nn.ModuleList(up)
        self.to(getattr(torch, cfg.dtype))

    def forward(self, x, t, y):
        """x: (B,H,W,C); t: (B,) real-valued timesteps; y: (B, n_classes)
        multi-hot conditioning (zeros = unconditional).  Returns ε̂ (NHWC,
        contiguous)."""
        td = self.cfg.time_dim
        x = x.to(self.stem.weight.dtype)
        temb = sinusoidal_embedding(t, td).to(x.dtype)
        tm = self.time_mlp
        emb = tm["w2"](F.silu(tm["w1"](temb)))
        emb = emb + self.label_proj(y.to(emb.dtype))

        h = self.stem(x.permute(0, 3, 1, 2).contiguous())
        skips = [h]
        for level in self.down:
            for rb, ab in zip(level.res, level.attn):
                h = rb(h, emb)
                if ab is not None:
                    h = ab(h)
                skips.append(h)
            if level.down is not None:
                h = level.down(h)
                skips.append(h)

        h = self.mid["res1"](h, emb)
        h = self.mid["attn"](h)
        h = self.mid["res2"](h, emb)

        for level in self.up:
            for rb, ab in zip(level.res, level.attn):
                h = torch.cat([h, skips.pop()], dim=1)
                h = rb(h, emb)
                if ab is not None:
                    h = ab(h)
            if level.up is not None:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = level.up(h)

        h = F.silu(self.out_gn(h))
        return self.out_conv(h).permute(0, 2, 3, 1).contiguous()


def unet_apply(model: UNet, x, t, y, cfg: Optional[UNetConfig] = None):
    """``apply_fn(params, x, t, y)`` form of the forward pass (the
    samplers' denoiser signature); ``cfg`` is carried by the module."""
    return model(x, t, y)


def unet_param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


# ---------------------------------------------------------------------------
# threefry-keyed initialisation, in the JAX package's parameter layout
# ---------------------------------------------------------------------------


def _np(t: torch.Tensor, dtype: torch.dtype) -> np.ndarray:
    """``t`` rounded to ``dtype``, as float32 numpy (exact: numpy has no
    bfloat16)."""
    return t.to(dtype).float().cpu().numpy()


def _conv_init(key, kh, kw, cin, cout, dtype=torch.float32,
               scale=None) -> Dict:
    scale = scale if scale is not None else 1.0 / math.sqrt(kh * kw * cin)
    w = prng.normal(key, (kh, kw, cin, cout)) * scale      # HWIO
    return {"w": _np(w, dtype), "b": np.zeros((cout,), np.float32)}


def _gn_init(c) -> Dict:
    return {"scale": np.ones((c,), np.float32),
            "bias": np.zeros((c,), np.float32)}


def _dense_np(key, d_in, d_out, dtype=torch.float32,
              scale=None) -> np.ndarray:
    return _np(dense_init(key, d_in, d_out, scale=scale), dtype)


def _res_block_init(key, cin, cout, time_dim, dtype) -> Dict:
    k1, k2, k3, k4 = prng.split(key, 4)
    p = {"gn1": _gn_init(cin),
         "conv1": _conv_init(k1, 3, 3, cin, cout, dtype),
         "time": _dense_np(k2, time_dim, cout, dtype), "gn2": _gn_init(cout),
         "conv2": _conv_init(k3, 3, 3, cout, cout, dtype, scale=1e-3)}
    if cin != cout:
        p["skip"] = _conv_init(k4, 1, 1, cin, cout, dtype)
    return p


def _attn_block_init(key, c, dtype) -> Dict:
    kq, kk, kv, ko = prng.split(key, 4)
    return {"gn": _gn_init(c), "wq": _dense_np(kq, c, c, dtype),
            "wk": _dense_np(kk, c, c, dtype),
            "wv": _dense_np(kv, c, c, dtype),
            "wo": _dense_np(ko, c, c, dtype, scale=1e-3)}


def init_params(key: torch.Tensor, cfg: UNetConfig) -> Dict:
    """The JAX package's ``init_unet`` parameter tree (numpy, HWIO convs,
    (in, out) dense weights), drawn with the port's threefry in the same
    key order, each weight rounded to ``cfg.dtype`` (held as float32
    numpy).  Draws run on ``key``'s device."""
    dt = getattr(torch, cfg.dtype)
    widths = _level_widths(cfg)
    keys = iter(prng.split(key, 1024))
    nk = lambda: next(keys)
    td = cfg.time_dim
    params: Dict = {
        "time_mlp": {"w1": _dense_np(nk(), td, td, dt),
                     "w2": _dense_np(nk(), td, td, dt)},
        "label_proj": _dense_np(nk(), cfg.n_classes, td, dt),
        "stem": _conv_init(nk(), 3, 3, cfg.channels, widths[0], dt),
        "out_gn": _gn_init(widths[0]),
        "out_conv": _conv_init(nk(), 3, 3, widths[0], cfg.channels, dt,
                               scale=1e-3),
    }
    res = cfg.image_size
    down, skips_c = [], [widths[0]]
    cin = widths[0]
    for i, w in enumerate(widths):
        level = {"res": [], "attn": []}
        for _ in range(cfg.n_res_blocks):
            level["res"].append(_res_block_init(nk(), cin, w, td, dt))
            level["attn"].append(_attn_block_init(nk(), w, dt)
                                 if res in cfg.attn_resolutions else None)
            cin = w
            skips_c.append(w)
        if i < len(widths) - 1:
            level["down"] = _conv_init(nk(), 3, 3, w, w, dt)
            skips_c.append(w)
            res //= 2
        down.append(level)
    params["down"] = down
    params["mid"] = {"res1": _res_block_init(nk(), cin, cin, td, dt),
                     "attn": _attn_block_init(nk(), cin, dt),
                     "res2": _res_block_init(nk(), cin, cin, td, dt)}
    up = []
    for i, w in reversed(list(enumerate(widths))):
        level = {"res": [], "attn": []}
        for _ in range(cfg.n_res_blocks + 1):
            sc = skips_c.pop()
            level["res"].append(_res_block_init(nk(), cin + sc, w, td, dt))
            level["attn"].append(_attn_block_init(nk(), w, dt)
                                 if res in cfg.attn_resolutions else None)
            cin = w
        if i > 0:
            level["up"] = _conv_init(nk(), 3, 3, w, w, dt)
            res *= 2
        up.append(level)
    params["up"] = up
    return params


def init_unet(key: torch.Tensor, cfg: UNetConfig, device=None) -> UNet:
    """A UNet on ``device`` (CUDA unless asked otherwise) whose weights
    equal ``repro.core.unet.init_unet(key, cfg)``'s (normals within the
    few ulps of ``torch.erfinv``)."""
    dev = resolve_device(device)
    model = UNet(cfg)
    bridge.load_unet(model, init_params(key.to(dev), cfg))
    return model.to(dev)
