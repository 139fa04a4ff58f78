"""The backward kernels' wgmma variants (flash attention's and the SSD
scan's), pinned on the CPU without a card, and held to a model of their
rounding on the card.

* ``choose_variant_backward`` decides from dtype, shape and alignment
  alone: bf16 at the LM training step's, the DiT's and the DBRX block's
  shapes takes ``wgmma``; float32, other head dims and states, a chunk
  over ``BWD_WGMMA_MAX_CHUNK`` and misaligned pointers take ``simt``.
* ``launch_backward``'s ``variant=``: ``simt`` is accepted anywhere (it
  reaches the device check), anything else the choice is not raises
  before the device is looked at; a refused call moves no counter.
* Each new block's shared memory fits the 232,448 bytes of a block at the
  path's and the sweeps' shapes; the tensor maps are the forwards'.
* ``flash_bwd_rounding_model`` and ``ssd_bwd_rounding_model``: plain-torch
  models that round to bf16 exactly where the kernels do (every float32
  intermediate that is a tensor-core operand goes as a bf16 hi part plus
  a bf16 lo part; the stored bf16 inputs go as they are; sums float32;
  outputs rounded once).  Held against the float32 plain versions
  (``flash_attention_bwd_ref``, ``ssd_chunked_bwd_ref``) with
  ``chip_smoke.row_gap`` within ``BWD_BF16_ROW`` on every gradient, dA
  and ddt included.  The same models with one bf16 part (the operand
  rounded once, as a plain bf16 wgmma would take it) leave less than half
  that limit at the DiT's shape: that is why the kernels split.
* On the card (``cuda`` marker; skips without a device): each wgmma
  kernel against its model, within a quarter of ``BWD_BF16_ROW``.
"""
import math
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import tma
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.flash_attention.ref import (
    attention_lse, attention_ref, flash_attention_bwd_ref, keep_mask)
from repro_torch.kernels.ssd_scan import kernel as skernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd_ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import BWD_BF16_ROW, row_gap  # noqa: E402

torch.set_num_threads(1)

BF16 = torch.bfloat16
SMEM_BYTES = 232448
# (B, H, Hkv, S, dh): the LM training step, the Zamba2 DiT, the DBRX block
FLASH_LM, FLASH_DIT, FLASH_DBRX = ((4, 32, 32, 1024, 64), (4, 32, 32, 64, 64),
                                   (4, 48, 8, 64, 128))
# (b, s, h, p, n, chunk): the LM training step, the DiT, Mamba2-2.7B
SSD_LM, SSD_DIT, SSD_MAMBA2 = ((4, 1024, 64, 64, 64, 256),
                               (4, 64, 64, 64, 64, 64),
                               (4, 256, 80, 64, 128, 256))
# small sweep-like cases: (shape, causal, window) and (shape, d(final))
FLASH_CASES = [((4, 48, 8, 64, 128), False, 0), ((2, 4, 4, 333, 64), True, 0),
               ((1, 4, 2, 200, 64), False, 70), ((2, 4, 2, 100, 32), True, 0),
               ((1, 2, 1, 150, 16), True, 40)]
SSD_CASES = [((2, 333, 4, 64, 64, 256), True), ((1, 130, 3, 64, 128, 32), False),
             ((1, 37, 2, 64, 64, 4), True), ((2, 200, 4, 64, 64, 64), False)]


def _meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _misaligned(*shape, dtype=BF16):
    n = math.prod(shape)
    return torch.zeros(n + 8, dtype=dtype)[1:1 + n].view(shape)


def _check_map(m: tma.TmaMap):
    """What TMA requires of a map the kernels encode."""
    assert len(m.dims) in (2, 3) and len(m.box) == len(m.dims)
    assert len(m.strides) == len(m.dims) - 1
    assert all(s % 16 == 0 for s in m.strides)
    assert all(1 <= b <= 256 for b in m.box)
    assert m.swizzle in (32, 64, 128)
    assert m.box[0] * tma.BF16_BYTES <= m.swizzle


def _flash_meta(B, H, Hkv, S, dh, dtype=BF16):
    return (_meta(B, H, S, dh, dtype=dtype), _meta(B, Hkv, S, dh, dtype=dtype),
            _meta(B, Hkv, S, dh, dtype=dtype), _meta(B, H, S, dh, dtype=dtype))


def _ssd_meta(b, s, h, p, n, dtype=BF16):
    return (_meta(b, s, h, p, dtype=dtype), _meta(b, s, n, dtype=dtype),
            _meta(b, s, n, dtype=dtype), _meta(b, s, h, p, dtype=dtype))


# ---- the rounding models -----------------------------------------------------

def split(v: torch.Tensor, parts: int = 2) -> torch.Tensor:
    """v as the sum of ``parts`` bf16 values (hi = bf16(v), lo =
    bf16(v - hi), ...), in float32: what the kernels hand the tensor
    cores for a float32 operand (parts 2)."""
    out, rest = torch.zeros_like(v), v
    for _ in range(parts):
        part = rest.to(BF16).float()
        out, rest = out + part, rest - part
    return out


def flash_bwd_rounding_model(q, k, v, out, dout, lse, causal, window,
                             parts=2):
    """Where csrc/flash_attention_bwd.cu's wgmma variant rounds, in plain
    torch: S and dP from the bf16 inputs in float32, the scale on the
    float32 scores, P = exp(scale S - lse) and dS = P (dP - D) in float32;
    P and dS as ``parts`` bf16 parts for dV = P^T dO, dK = dS^T q and
    dQ = dS k (float32 sums, the scale on the float32 sums); each output
    rounded once to the inputs' type."""
    B, H, S, dh = q.shape
    Hkv = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    f = lambda t: t.float().reshape(B, Hkv, H // Hkv, S, dh)
    qf, of, dof = f(q), f(out), f(dout)
    kf, vf = k.float(), v.float()
    lse = lse.float().reshape(B, Hkv, H // Hkv, S)
    D = (dof * of).sum(-1)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
    keep = keep_mask(S, causal, window, q.device)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    ds = p * (dp - D[..., None])
    p, ds = split(p, parts), split(ds, parts)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * scale
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    return (dq.reshape(B, H, S, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def ssd_bwd_rounding_model(x, dt, A, B, C, chunk, dy, dfinal=None, parts=2):
    """Where csrc/ssd_scan_bwd.cu's wgmma variant rounds, in plain torch
    (its algorithm is ``ssd_chunked_bwd_ref``'s): the chunk sums from
    (dt e^{L_end - L} x) and (e^{L} dy) as ``parts`` bf16 parts against
    the bf16 B and C; the recurrences float32; the states h_c and G_c as
    ``parts`` parts in G B^T, x G and dy h; C.B and dy.x from the bf16
    inputs in float32; W o CB and W o DD as ``parts`` parts in d(dtx),
    dB and dC; the scalings (e^{L_end - L_s}, dt_s, e^{L_t}) on float32
    sums; M, Q, the h.C term, <G, h> and every dL sum float32; dB and dC
    summed over the heads in float32; outputs rounded once."""
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
    L = torch.cumsum(dtr * Af, dim=2)
    Lend = L[:, :, -1]
    to_end = torch.exp(Lend[:, :, None] - L)
    eL = torch.exp(L)
    S_c = torch.einsum("bcshp,bcsn->bchpn",
                       split((dtr * to_end)[..., None] * xr, parts), Br)
    U_c = torch.einsum("bcthp,bctn->bchpn", split(eL[..., None] * dyr, parts),
                       Cr)
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
    Hb, Ga = torch.stack(before, 1), torch.stack(after, 1)
    Hs, Gs = split(Hb, parts), split(Ga, parts)
    tril = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    tril = tril[None, None, :, :, None]
    diff = L[:, :, :, None, :] - L[:, :, None, :, :]
    W = torch.where(tril, torch.exp(torch.where(tril, diff, 0.0)), 0.0)
    CB = torch.einsum("bctn,bcsn->bcts", Cr, Br)
    DD = torch.einsum("bcthp,bcshp->bctsh", dyr, xr) * dtr[:, :, None]
    CBW = CB[..., None] * W
    WDD = W * DD
    M = CBW * DD
    CBWs, WDDs = split(CBW, parts), split(WDD, parts)
    GB = torch.einsum("bchpn,bcsn->bcshp", Gs, Br)
    ddtx = torch.einsum("bctsh,bcthp->bcshp", CBWs, dyr) + \
        to_end[..., None] * GB
    dBr = torch.einsum("bctsh,bctn->bcsn", WDDs, Cr) + torch.einsum(
        "bcsh,bchpn,bcshp->bcsn", to_end * dtr, Gs, xr)
    HY = torch.einsum("bchpn,bcthp->bcthn", Hs, dyr)
    dCr = torch.einsum("bctsh,bcsn->bctn", WDDs, Br) + torch.einsum(
        "bcth,bcthn->bctn", eL, HY)
    Q = to_end * dtr * (xr * GB).sum(-1)
    hC = eL * (HY * Cr[:, :, :, None, :]).sum(-1)
    dL = M.sum(dim=3) - M.sum(dim=2) + hC - Q
    dL[:, :, -1] += Q.sum(dim=2) + torch.exp(Lend) * (Ga * Hb).sum((-1, -2))
    da = torch.flip(torch.cumsum(torch.flip(dL, [2]), dim=2), [2])
    dx = dtr[..., None] * ddtx
    ddt = (xr * ddtx).sum(-1) + Af * da
    dA = (dtr * da).sum((0, 1, 2))
    unpad = lambda t, *tail: t.reshape(b, s_p, *tail)[:, :s]
    return (unpad(dx, h, p).to(x.dtype), unpad(ddt, h), dA,
            unpad(dBr, n).to(B.dtype), unpad(dCr, n).to(C.dtype))


def _flash_inputs(shape, causal, window, device="cpu", seed=20):
    B, H, Hkv, S, dh = shape
    g = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *sh: torch.randn(sh, generator=g, device=device)
    q = rn(B, H, S, dh).to(BF16)
    k, v = rn(B, Hkv, S, dh).to(BF16), rn(B, Hkv, S, dh).to(BF16)
    dout = rn(B, H, S, dh).to(BF16)
    return (q, k, v, attention_ref(q, k, v, causal, window), dout,
            attention_lse(q, k, causal, window))


def _ssd_inputs(shape, dfinal, device="cpu", seed=20):
    b, s, h, p, n, chunk = shape
    g = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *sh: torch.randn(sh, generator=g, device=device)
    x = rn(b, s, h, p).to(BF16)
    dt = F.softplus(rn(b, s, h) - 1)
    A = -torch.exp(rn(h))
    Bm, Cm = rn(b, s, n).to(BF16), rn(b, s, n).to(BF16)
    dy = rn(b, s, h, p).to(BF16)
    return x, dt, A, Bm, Cm, chunk, dy, rn(b, h, p, n) if dfinal else None


def _gaps(got, ref):
    return [row_gap(a, r) for a, r in zip(got, ref)]


@pytest.mark.parametrize("shape,causal,window", FLASH_CASES)
def test_flash_rounding_model_within_the_row_limit(shape, causal, window):
    args = _flash_inputs(shape, causal, window)
    ref = flash_attention_bwd_ref(*args, causal, window)
    got = flash_bwd_rounding_model(*args, causal, window)
    assert [g.dtype for g in got] == [BF16] * 3
    gaps = _gaps(got, ref)
    assert max(gaps) <= BWD_BF16_ROW, gaps


@pytest.mark.parametrize("shape,dfinal", SSD_CASES)
def test_ssd_rounding_model_within_the_row_limit(shape, dfinal):
    args = _ssd_inputs(shape, dfinal)
    ref = ssd_chunked_bwd_ref(*args)
    got = ssd_bwd_rounding_model(*args)
    assert [g.dtype for g in got] == [BF16, torch.float32, torch.float32,
                                      BF16, BF16]
    gaps = _gaps(got, ref)
    assert max(gaps) <= BWD_BF16_ROW, gaps
    # dA and ddt: float32 outputs whose float32 operands are split; dA's
    # sums over the batch and steps cancel
    assert gaps[1] <= BWD_BF16_ROW / 50 and gaps[2] <= BWD_BF16_ROW / 50, gaps


@pytest.mark.parametrize("which", ["flash", "ssd"])
def test_one_bf16_part_leaves_under_half_the_margin(which):
    """At the DiT's shape (seed 20) the operands rounded once to bf16 put
    some gradient row beyond half of BWD_BF16_ROW; hi + lo parts keep
    every gradient under a third of it."""
    if which == "flash":
        args = _flash_inputs(FLASH_DIT, False, 0)
        ref = flash_attention_bwd_ref(*args, False, 0)
        model = lambda parts: flash_bwd_rounding_model(*args, False, 0,
                                                       parts=parts)
    else:
        args = _ssd_inputs(SSD_DIT, False)
        ref = ssd_chunked_bwd_ref(*args)
        model = lambda parts: ssd_bwd_rounding_model(*args, parts=parts)
    one, two = max(_gaps(model(1), ref)), max(_gaps(model(2), ref))
    assert one > BWD_BF16_ROW / 2 and two < BWD_BF16_ROW / 3, (one, two)


def test_ssd_states_split_keep_dA():
    """dA cancels in its sums over the batch and steps: the chunk sums
    and the states rounded once to bf16 (the pair operands split) move it
    by more than a hundred times as much as their hi + lo parts do."""
    args = _ssd_inputs((2, 333, 4, 64, 64, 256), True)
    ref = ssd_chunked_bwd_ref(*args)
    dA = lambda parts: row_gap(ssd_bwd_rounding_model(*args, parts=parts)[2],
                               ref[2])
    assert dA(1) > 100 * dA(2), (dA(1), dA(2))


# ---- choose_variant_backward --------------------------------------------------

@pytest.mark.parametrize("shape", [FLASH_LM, FLASH_DIT, FLASH_DBRX,
                                   (2, 4, 2, 100, 32), (1, 2, 1, 150, 16)],
                         ids=["lm_train", "dit", "dbrx", "dh32", "dh16"])
def test_flash_bwd_bf16_at_wgmma_head_dims_takes_wgmma(shape):
    assert fkernel.choose_variant_backward(*_flash_meta(*shape)) == "wgmma"


@pytest.mark.parametrize("shape", [FLASH_LM, FLASH_DIT, FLASH_DBRX])
def test_flash_bwd_float32_takes_simt(shape):
    ops_ = _flash_meta(*shape, dtype=torch.float32)
    assert fkernel.choose_variant_backward(*ops_) == "simt"


@pytest.mark.parametrize("dh", [112, 8, 96])
def test_flash_bwd_other_head_dims_take_simt(dh):
    assert fkernel.choose_variant_backward(*_flash_meta(1, 2, 1, 48, dh)) == \
        "simt"


def test_flash_bwd_misaligned_pointers_take_simt():
    ok = torch.zeros(1, 2, 64, 64, dtype=BF16)
    bad = _misaligned(1, 2, 64, 64)
    assert fkernel.choose_variant_backward(ok, ok, ok, ok) == "wgmma"
    for args in ((bad, ok, ok, ok), (ok, bad, ok, ok), (ok, ok, bad, ok),
                 (ok, ok, ok, bad)):
        assert fkernel.choose_variant_backward(*args) == "simt"


@pytest.mark.parametrize("shape", [SSD_LM, SSD_DIT, SSD_MAMBA2,
                                   (1, 130, 3, 64, 128, 32),
                                   (1, 37, 2, 64, 64, 4)],
                         ids=["lm_train", "dit", "mamba2_2p7b", "n128",
                              "chunk4"])
def test_ssd_bwd_bf16_model_shapes_take_wgmma(shape):
    *dims, chunk = shape
    assert skernel.choose_variant_backward(*_ssd_meta(*dims), chunk) == \
        "wgmma"


@pytest.mark.parametrize("p,n,chunk,dtype", [
    (64, 64, 256, torch.float32), (112, 64, 256, BF16), (64, 16, 256, BF16),
    (64, 32, 64, BF16), (16, 16, 16, BF16),
    (64, 64, skernel.BWD_WGMMA_MAX_CHUNK + 1, BF16)],
    ids=["float32", "head_dim_112", "state_16", "state_32", "small",
         "chunk_over_max"])
def test_ssd_bwd_other_inputs_take_simt(p, n, chunk, dtype):
    ops_ = _ssd_meta(2, 64, 4, p, n, dtype=dtype)
    assert skernel.choose_variant_backward(*ops_, chunk) == "simt"


def test_ssd_bwd_misaligned_pointers_take_simt():
    x, Bm = torch.zeros(1, 64, 2, 64, dtype=BF16), torch.zeros(1, 64, 64,
                                                                dtype=BF16)
    assert skernel.choose_variant_backward(x, Bm, Bm, x, 64) == "wgmma"
    bad_x, bad_b = _misaligned(1, 64, 2, 64), _misaligned(1, 64, 64)
    for args in ((bad_x, Bm, Bm, x), (x, bad_b, Bm, x), (x, Bm, bad_b, x),
                 (x, Bm, Bm, bad_x)):
        assert skernel.choose_variant_backward(*args, 64) == "simt"


# ---- the variant= rule and the counters --------------------------------------

def _flash_cpu(dtype=BF16):
    q = torch.zeros(1, 2, 64, 64, dtype=dtype)
    k = torch.zeros(1, 1, 64, 64, dtype=dtype)
    return [q, k, k.clone(), q.clone(), q.clone(), torch.zeros(1, 2, 64),
            True, 0]


def _ssd_cpu(dtype=BF16, p=64):
    return [torch.zeros(1, 64, 2, p, dtype=dtype), torch.zeros(1, 64, 2),
            -torch.ones(2), torch.zeros(1, 64, 64, dtype=dtype),
            torch.zeros(1, 64, 64, dtype=dtype), 64,
            torch.zeros(1, 64, 2, p, dtype=dtype)]


@pytest.mark.parametrize("which", ["flash", "ssd"])
@pytest.mark.parametrize("variant,dtype,match", [
    ("simt", BF16, "CUDA"), ("simt", torch.float32, "CUDA"),
    ("wgmma", BF16, "CUDA"), (None, BF16, "CUDA"),
    ("wgmma", torch.float32, "variant 'wgmma'"),
    ("tf32", BF16, "variant 'tf32'"), ("", BF16, "variant ''")],
    ids=["simt-bf16", "simt-f32", "wgmma-bf16", "chosen", "wgmma-f32",
         "unknown", "empty"])
def test_variant_rule_of_launch_backward(which, variant, dtype, match):
    """simt and the choice reach the device check (CPU tensors: refused
    there); any other variant is refused before it; no counter moves."""
    kmod, args = ((fkernel, _flash_cpu(dtype)) if which == "flash"
                  else (skernel, _ssd_cpu(dtype)))
    before = dict(kmod.COUNTS)
    with pytest.raises(ValueError, match=match):
        kmod.launch_backward(*args, variant=variant)
    assert kmod.COUNTS == before


@pytest.mark.parametrize("kmod,name", [(fkernel, "flash_attention_bwd"),
                                       (skernel, "ssd_scan_bwd")])
def test_backward_counters_per_variant(kmod, name):
    assert kmod.BWD_VARIANTS == ("wgmma", "simt")
    assert {k for k in kmod.COUNTS if k.startswith(name)} == \
        {name, f"{name}/wgmma", f"{name}/simt"}


# ---- shared memory and tensor maps -------------------------------------------

@pytest.mark.parametrize("dh", fkernel.WGMMA_HEAD_DIMS)
def test_flash_bwd_shared_memory_fits_a_block(dh):
    """Two tiles held (k, v or q, dO), two ring stages of two tiles, 64
    rows of dh bf16 each: 49 KB at dh 64, two blocks an SM."""
    got = fkernel.bwd_smem_bytes(dh)
    assert got == 1024 + 6 * 64 * dh * 2 + 24
    assert got <= SMEM_BYTES
    assert fkernel.bwd_smem_bytes(64) == 50_200
    assert fkernel.bwd_smem_bytes(128) == 99_352


@pytest.mark.parametrize("n,chunk,states,chunks", [
    (64, 256, 68_632, 106_552), (128, 256, 101_400, 163_896),
    (64, 64, 67_096, 101_944), (128, 32, 99_608, 158_520),
    (64, 4, 66_616, 100_504),
    (128, skernel.BWD_WGMMA_MAX_CHUNK, 107_544, 182_328)])
def test_ssd_bwd_shared_memory_fits_a_block(n, chunk, states, chunks):
    """Pass 1: two ring stages of x, dy, B and C, L and dt.  Pass 3: the
    s tile, two (C, dy) stages, G and h as hi and lo, (W o DD)^T as hi
    and lo, six per-step float arrays: at the path's (n 64, chunk 256)
    two blocks an SM (2 x 106,552 bytes of its 228 KB)."""
    assert skernel.bwd_wgmma_smem_bytes(n, chunk) == (states, chunks)
    assert max(states, chunks) <= SMEM_BYTES
    if (n, chunk) == (64, 256):
        assert 2 * chunks <= 228 * 1024 - 2 * 1024


def test_backward_maps_are_the_forwards_at_the_path():
    """The wgmma backward loads q and dO through the forward's q map, k
    and v through its k/v map; x and dy through the SSD forward's x map,
    B and C through its B/C map."""
    B, H, Hkv, S, dh = FLASH_LM
    q, kv = fkernel.tma_maps(B, H, Hkv, S, dh)
    assert q == tma.TmaMap(dims=(64, 1024, 128), strides=(128, 131_072),
                           box=(64, 64, 1), swizzle=128)
    assert kv == q
    b, s, h, p, n, chunk = SSD_LM
    xm, bcm, _ = skernel.tma_maps(b, s, h, n)
    assert xm == tma.TmaMap(dims=(4096, 1024, 4), strides=(8192, 8_388_608),
                            box=(64, 64, 1), swizzle=128)
    assert bcm == tma.TmaMap(dims=(64, 1024, 4), strides=(128, 131_072),
                             box=(64, 64, 1), swizzle=128)
    for m in (q, kv, xm, bcm):
        _check_map(m)


# ---- on the card ----------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,window",
                         FLASH_CASES + [(FLASH_DIT, False, 0),
                                        ((1, 8, 8, 1024, 64), True, 8192),
                                        ((2, 6, 2, 130, 128), True, 0),
                                        ((1, 4, 4, 200, 32), False, 50)])
def test_cuda_flash_wgmma_matches_the_rounding_model(shape, causal, window):
    _needs_card()
    args = _flash_inputs(shape, causal, window, device="cuda")
    before = fkernel.COUNTS["flash_attention_bwd/wgmma"]
    got = fkernel.launch_backward(*args, causal, window)
    assert fkernel.COUNTS["flash_attention_bwd/wgmma"] == before + 1
    model = flash_bwd_rounding_model(*args, causal, window)
    torch.cuda.synchronize()
    gaps = _gaps(got, model)
    assert max(gaps) <= BWD_BF16_ROW / 4, gaps


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dfinal",
                         SSD_CASES + [(SSD_DIT, False),
                                      ((1, 1024, 8, 64, 64, 256), False),
                                      ((2, 300, 3, 64, 64, 100), True),
                                      ((1, 200, 2, 64, 128, 128), False)])
def test_cuda_ssd_wgmma_matches_the_rounding_model(shape, dfinal):
    _needs_card()
    args = _ssd_inputs(shape, dfinal, device="cuda")
    before = skernel.COUNTS["ssd_scan_bwd/wgmma"]
    got = skernel.launch_backward(*args)
    assert skernel.COUNTS["ssd_scan_bwd/wgmma"] == before + 1
    model = ssd_bwd_rounding_model(*args)
    torch.cuda.synchronize()
    gaps = _gaps(got, model)
    assert max(gaps) <= BWD_BF16_ROW / 4, gaps
