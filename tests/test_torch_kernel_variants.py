"""Which CUDA kernel variant each wrapper picks, and the TMA tensor maps of
the wgmma variants, pinned on the CPU without a card.

``choose_variant`` (grouped matmul, flash attention, SSD scan) decides from
dtype, shape, strides and alignment alone; ``tma_maps`` computes the
dims, byte strides, box and swizzle that the CUDA side encodes as they
are (csrc/hopper.cuh ``encode_map``).  The MoE and DiT paths' shapes (and
Mamba2-2.7B's SSD scan) must reach the wgmma variants; the JAX sweep's odd
shapes, misaligned pointers and float32 keep the older kernels.  The SSD
wgmma kernel's shared memory is pinned against the 227 KB a block can
hold.  Tensors are on the ``meta`` device where a real one would take
gigabytes: the choice reads no data.
"""
import ctypes

import pytest
import torch

from repro_torch.kernels import tma
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.grouped_matmul import kernel as gkernel
from repro_torch.kernels.ssd_scan import kernel as skernel

BF16 = torch.bfloat16
# the MoE path's three products a block (DBRX-132B, batch 4 x 64 tokens)
GATE_UP = (16, 256, 6144, 10752)
DOWN = (16, 256, 10752, 6144)


def _meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _broadcast(E, C, D, dtype=BF16):
    return _meta(C, D, dtype=dtype).unsqueeze(0).expand(E, -1, -1)


def _misaligned(*shape, dtype=BF16):
    n = 1
    for s in shape:
        n *= s
    return torch.zeros(n + 8, dtype=dtype)[1:1 + n].view(shape)


def _check_map(m: tma.TmaMap):
    """What TMA requires of a map the kernels encode."""
    assert len(m.dims) in (2, 3) and len(m.box) == len(m.dims)
    assert len(m.strides) == len(m.dims) - 1
    assert all(s % 16 == 0 for s in m.strides)
    assert all(1 <= b <= 256 for b in m.box)
    assert m.swizzle in (32, 64, 128)
    assert m.box[0] * tma.BF16_BYTES <= m.swizzle


# ---- grouped matmul ----------------------------------------------------------

@pytest.mark.parametrize("shape,broadcast", [(GATE_UP, True), (DOWN, False)],
                         ids=["gate_up", "down"])
def test_gmm_path_shapes_take_wgmma(shape, broadcast):
    E, C, D, F = shape
    tokens = _broadcast(E, C, D) if broadcast else _meta(E, C, D)
    assert gkernel.choose_variant(tokens, _meta(E, D, F)) == "wgmma"


def test_gmm_maps_at_gate_and_up():
    """Tokens broadcast to every expert: a 2-D map over (D, C) read at the
    same coordinates for every expert; weights a 3-D map over (F, D, E)."""
    E, C, D, F = GATE_UP
    se, sc = gkernel.token_strides(_broadcast(E, C, D))
    assert (se, sc) == (0, D)
    tok, w = gkernel.tma_maps(E, C, D, F, se, sc)
    assert tok == tma.TmaMap(dims=(6144, 256), strides=(12288,),
                             box=(64, 256), swizzle=128)
    assert w == tma.TmaMap(dims=(10752, 6144, 16),
                           strides=(21504, 132_120_576), box=(64, 64, 1),
                           swizzle=128)
    for m in (tok, w):
        _check_map(m)


def test_gmm_maps_at_down():
    """Contiguous tokens: a 3-D map over (D, C, E) at their strides."""
    E, C, D, F = DOWN
    se, sc = gkernel.token_strides(_meta(E, C, D))
    assert (se, sc) == (C * D, D)
    tok, w = gkernel.tma_maps(E, C, D, F, se, sc)
    assert tok == tma.TmaMap(dims=(10752, 256, 16), strides=(21504, 5_505_024),
                             box=(64, 256, 1), swizzle=128)
    assert w == tma.TmaMap(dims=(6144, 10752, 16),
                           strides=(12288, 132_120_576), box=(64, 64, 1),
                           swizzle=128)
    for m in (tok, w):
        _check_map(m)


def test_gmm_tile_covers_the_path_rows_and_one_swizzle_row():
    """One tile takes all 256 token rows of the path, so each weight byte
    is read once; a stage's depth and a weight box are one 128-byte
    swizzle row of bf16."""
    assert gkernel.TILE_C == GATE_UP[1] == DOWN[1]
    assert gkernel.TILE_D * tma.BF16_BYTES == gkernel.SWIZZLE == 128
    assert gkernel.BOX_F * tma.BF16_BYTES == gkernel.SWIZZLE


@pytest.mark.parametrize("E,C,D,F", [(4, 32, 64, 48), (8, 16, 16, 16),
                                     (2, 200, 512, 384), (2, 300, 128, 192)])
@pytest.mark.parametrize("broadcast", [False, True])
def test_gmm_aligned_bf16_takes_wgmma(E, C, D, F, broadcast):
    t = torch.zeros(E, C, D, dtype=BF16)
    t = t[0].unsqueeze(0).expand(E, -1, -1) if broadcast else t
    assert gkernel.choose_variant(t, torch.zeros(E, D, F, dtype=BF16)) == \
        "wgmma"
    for m in gkernel.tma_maps(E, C, D, F, *gkernel.token_strides(t)):
        _check_map(m)


@pytest.mark.parametrize("E,C,D,F", [(1, 7, 9, 11), (2, 100, 50, 70),
                                     (2, 16, 64, 44), (2, 16, 60, 48)])
def test_gmm_odd_shapes_take_wmma(E, C, D, F):
    """D or F not a multiple of 8 (the JAX sweep's (1, 7, 9, 11))."""
    t = torch.zeros(E, C, D, dtype=BF16)
    assert gkernel.choose_variant(t, torch.zeros(E, D, F, dtype=BF16)) == \
        "wmma"


def test_gmm_misaligned_or_strided_bf16_takes_wmma():
    w = torch.zeros(2, 64, 48, dtype=BF16)
    assert gkernel.choose_variant(_misaligned(2, 32, 64), w) == "wmma"
    t = torch.zeros(2, 32, 64, dtype=BF16)
    assert gkernel.choose_variant(t, _misaligned(2, 64, 48)) == "wmma"
    # a row stride that is not a multiple of 8 elements
    rows = torch.zeros(2, 32, 68, dtype=BF16)[:, :, :64]
    assert gkernel.token_strides(rows) == (32 * 68, 68)
    assert gkernel.choose_variant(rows, w) == "wmma"
    # rows that overlap (stride below D)
    over = torch.zeros(4096, dtype=BF16).as_strided((2, 32, 64), (2048, 56, 1))
    assert gkernel.choose_variant(over, w) == "wmma"
    # a multiple-of-8 row stride with padding still takes wgmma
    padded = torch.zeros(2, 32, 72, dtype=BF16)[:, :, :64]
    assert gkernel.choose_variant(padded, w) == "wgmma"


@pytest.mark.parametrize("shape", [GATE_UP, DOWN, (1, 7, 9, 11)])
def test_gmm_float32_takes_simt(shape):
    E, C, D, F = shape
    t = _meta(E, C, D, dtype=torch.float32)
    assert gkernel.choose_variant(t, _meta(E, D, F, dtype=torch.float32)) \
        == "simt"


# ---- flash attention ---------------------------------------------------------

@pytest.mark.parametrize("B,H,Hkv,S,dh", [(4, 32, 32, 64, 64),
                                          (4, 48, 8, 64, 128),
                                          (2, 4, 2, 64, 32),
                                          (1, 4, 4, 100, 16),
                                          (2, 6, 2, 100, 128)])
def test_flash_bf16_at_wgmma_head_dims_takes_wgmma(B, H, Hkv, S, dh):
    q, k, v = _meta(B, H, S, dh), _meta(B, Hkv, S, dh), _meta(B, Hkv, S, dh)
    assert fkernel.choose_variant(q, k, v) == "wgmma"


@pytest.mark.parametrize("dh", [8, 24, 96])
def test_flash_other_head_dims_take_simt(dh):
    q, kv = _meta(1, 2, 48, dh), _meta(1, 1, 48, dh)
    assert fkernel.choose_variant(q, kv, kv) == "simt"


@pytest.mark.parametrize("dh", [64, 128])
def test_flash_float32_or_misaligned_takes_simt(dh):
    f32 = _meta(4, 8, 64, dh, dtype=torch.float32)
    assert fkernel.choose_variant(f32, f32, f32) == "simt"
    ok = torch.zeros(1, 2, 64, dh, dtype=BF16)
    bad = _misaligned(1, 2, 64, dh)
    assert fkernel.choose_variant(ok, ok, ok) == "wgmma"
    for q, k, v in ((bad, ok, ok), (ok, bad, ok), (ok, ok, bad)):
        assert fkernel.choose_variant(q, k, v) == "simt"


def test_flash_maps_at_the_dit_and_moe_shapes():
    """(dh, S, B*H) and (dh, S, B*Hkv), 64-row boxes of min(dh, 64)
    columns, swizzled 128 bytes wide: one box a tile at dh 64, two at 128."""
    q, kv = fkernel.tma_maps(4, 32, 32, 64, 64)
    assert q == tma.TmaMap(dims=(64, 64, 128), strides=(128, 8192),
                           box=(64, 64, 1), swizzle=128)
    assert kv == q
    q, kv = fkernel.tma_maps(4, 48, 8, 64, 128)
    assert q == tma.TmaMap(dims=(128, 64, 192), strides=(256, 16384),
                           box=(64, 64, 1), swizzle=128)
    assert kv == tma.TmaMap(dims=(128, 64, 32), strides=(256, 16384),
                            box=(64, 64, 1), swizzle=128)
    for m in (q, kv):
        _check_map(m)


@pytest.mark.parametrize("dh,swizzle", [(16, 32), (32, 64), (64, 128),
                                        (128, 128)])
def test_flash_swizzle_follows_the_head_dim(dh, swizzle):
    q, kv = fkernel.tma_maps(1, 4, 4, 100, dh)
    assert q.swizzle == kv.swizzle == swizzle
    assert q.box == (min(dh, 64), fkernel.TILE, 1)
    assert q.dims == (dh, 100, 4) and q.strides == (dh * 2, 100 * dh * 2)
    _check_map(q)


# the Zamba2-1.2B DiT's and Mamba2-2.7B's scans (b, s, h, p, n), and the
# shapes chip_smoke.py sweeps the SSD wgmma variant at (b, s, h, p, n, chunk)
SSD_DIT = (4, 64, 64, 64, 64)
SSD_MAMBA2 = (4, 256, 80, 64, 128)
SSD_WGMMA = [(2, 200, 4, 64, 64, 64), (1, 256, 3, 64, 128, 256),
             (2, 64, 5, 64, 64, 16), (1, 130, 3, 64, 128, 32)]


def _ssd_operands(b, s, h, p, n, dtype=BF16):
    return _meta(b, s, h, p, dtype=dtype), _meta(b, s, n, dtype=dtype), \
        _meta(b, s, n, dtype=dtype)


# ---- SSD scan ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [SSD_DIT, SSD_MAMBA2, (1, 64, 3, 64, 64),
                                   (2, 200, 5, 64, 128)],
                         ids=["zamba2_dit", "mamba2_2p7b", "odd_heads",
                              "tail"])
def test_ssd_bf16_model_shapes_take_wgmma(shape):
    assert skernel.choose_variant(*_ssd_operands(*shape)) == "wgmma"


@pytest.mark.parametrize("shape", [SSD_DIT, SSD_MAMBA2])
def test_ssd_float32_takes_simt(shape):
    ops_ = _ssd_operands(*shape, dtype=torch.float32)
    assert skernel.choose_variant(*ops_) == "simt"


@pytest.mark.parametrize("p,n", [(32, 64), (128, 64), (16, 8), (64, 32),
                                 (64, 256), (64, 16)])
def test_ssd_other_head_dims_and_states_take_simt(p, n):
    assert skernel.choose_variant(*_ssd_operands(2, 64, 4, p, n)) == "simt"


def test_ssd_misaligned_pointers_take_simt():
    x, Bm = torch.zeros(1, 64, 2, 64, dtype=BF16), torch.zeros(1, 64, 64,
                                                                dtype=BF16)
    assert skernel.choose_variant(x, Bm, Bm) == "wgmma"
    bad_x, bad_b = _misaligned(1, 64, 2, 64), _misaligned(1, 64, 64)
    for args in ((bad_x, Bm, Bm), (x, bad_b, Bm), (x, Bm, bad_b)):
        assert skernel.choose_variant(*args) == "simt"


def test_ssd_maps_at_the_dit_shape():
    """x (and y): (h·64, s, b), a head's 64 columns at column h·64; B and
    C: (n, s, b); the float32 state as bf16 pairs over (2n, p, b·h), two
    boxes of 32 floats a head; boxes of 64 values x 64 rows, 128-byte
    swizzle."""
    b, s, h, p, n = SSD_DIT
    xm, bcm, fm = skernel.tma_maps(b, s, h, n)
    assert xm == tma.TmaMap(dims=(4096, 64, 4), strides=(8192, 524_288),
                            box=(64, 64, 1), swizzle=128)
    assert bcm == tma.TmaMap(dims=(64, 64, 4), strides=(128, 8192),
                             box=(64, 64, 1), swizzle=128)
    assert fm == tma.TmaMap(dims=(128, 64, 256), strides=(256, 16384),
                            box=(64, 64, 1), swizzle=128)
    for m in (xm, bcm, fm):
        _check_map(m)


def test_ssd_maps_at_mamba2_state_128_take_two_boxes():
    b, s, h, p, n = SSD_MAMBA2
    xm, bcm, fm = skernel.tma_maps(b, s, h, n)
    assert xm == tma.TmaMap(dims=(5120, 256, 4), strides=(10240, 2_621_440),
                            box=(64, 64, 1), swizzle=128)
    assert bcm == tma.TmaMap(dims=(128, 256, 4), strides=(256, 65536),
                             box=(64, 64, 1), swizzle=128)
    assert fm == tma.TmaMap(dims=(256, 64, 320), strides=(512, 32768),
                            box=(64, 64, 1), swizzle=128)
    assert bcm.dims[0] // bcm.box[0] == 2 and fm.dims[0] // fm.box[0] == 4
    for m in (xm, bcm, fm):
        _check_map(m)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_WGMMA)
def test_ssd_maps_of_the_sweep_shapes(b, s, h, p, n, chunk):
    xm, bcm, fm = skernel.tma_maps(b, s, h, n)
    for m in (xm, bcm, fm):
        _check_map(m)
        assert m.box[1] == skernel.TILE
    assert xm.dims[1:] == bcm.dims[1:] == (s, b)
    assert fm.dims == (2 * n, p, b * h)


def test_ssd_wgmma_shared_memory_fits_a_block():
    """Two stages of B, C and two heads' x, two bf16 states and y tiles,
    L and dt: 100,368 bytes at n 64, 149,520 at n 128; the float32 final
    states (32 KB a block at n 64, 64 KB at 128) fit the ring."""
    assert skernel.wgmma_smem_bytes(64) == 100_368
    assert skernel.wgmma_smem_bytes(128) == 149_520
    for n in skernel.WGMMA_STATES:
        assert skernel.wgmma_smem_bytes(n) <= skernel.SMEM_BYTES
        ring = 2 * (2 * n * 128 + skernel.HEADS_PER_BLOCK * 64 * 128)
        assert skernel.HEADS_PER_BLOCK * 64 * n * 4 <= ring


# ---- counters and packing ----------------------------------------------------

@pytest.mark.parametrize("kmod,name", [(gkernel, "grouped_matmul"),
                                       (fkernel, "flash_attention"),
                                       (skernel, "ssd_scan")])
def test_every_variant_has_its_own_counter(kmod, name):
    # flash and the SSD scan also count their backward kernel's launches
    bwd = {f"{name}_bwd"} | {f"{name}_bwd/{v}" for v in
                             getattr(kmod, "BWD_VARIANTS", ())}
    assert set(kmod.COUNTS) == {name} | {f"{name}/{v}" for v in
                                         kmod.VARIANTS} | \
        (bwd if hasattr(kmod, "BWD_VARIANTS") else set())
    assert kmod.VARIANTS[0] == "wgmma"
    saved = dict(kmod.COUNTS)
    try:
        for key in kmod.COUNTS:
            kmod.COUNTS[key] = 3
        kmod.reset_counts()
        assert all(n == 0 for n in kmod.COUNTS.values())
    finally:
        kmod.COUNTS.update(saved)


def test_packed_geometry_is_ten_words_for_the_cuda_side():
    two = tma.TmaMap((6144, 256), (12288,), (64, 256), 128)
    assert two.packed() == (2, 6144, 256, 1, 12288, 0, 64, 256, 1, 128)
    three = tma.TmaMap((64, 64, 128), (128, 8192), (64, 64, 1), 128)
    assert three.packed() == (3, 64, 64, 128, 128, 8192, 64, 64, 1, 128)
    arr = tma.as_ctypes(three)
    assert isinstance(arr, ctypes.Array) and len(arr) == tma.MAP_WORDS
    assert tuple(arr) == three.packed()
    assert tma.as_ctypes(three) is arr        # built once per map
