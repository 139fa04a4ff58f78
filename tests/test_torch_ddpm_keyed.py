"""The keyed DDPM-step variants (``ddpm_step_keyed``, ``ddpm_step_rowwise``)
and what the CUDA kernel must reproduce of them.

* (a) ``step_coefficient_table`` equals per-step ``step_coefficients``
  bitwise: server and client tables of a cut (``adjusted`` on and off),
  and a plan's engine tables.
* (b) A numpy uint32 model of the kernel's addressing, built from the
  constants and key schedule written in ``csrc/threefry.cuh`` and the
  block size of ``csrc/ddpm_step.cu``, against ``core/prng.py`` bitwise:
  the split chain, the row keys ``fold_in(fold_in(k, d), b)``, the flat
  index -> (hi32, lo32) counter, and the uniform.
* (c) On the CPU the samplers, the engine and ``sample_plan_reference``
  equal, bitwise, the composition they ran before the kernel drew its own
  noise (written out here: ``prng.split`` / ``prng.normal`` or the
  row-keyed draw, the given-noise step with per-step coefficients, and
  ``torch.where``).
* (d) The keyed wrappers' checks, reachable on the CPU because the device
  is checked last.
* (e) ``cuda``-marked: both keyed variants against their plain
  composition on the card, bitwise; they skip here.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core import sample_plan as tsp
from repro_torch.core import sampler as ts
from repro_torch.core.protocol import rowwise_normal
from repro_torch.core.schedules import DiffusionSchedule
from repro_torch.core.splitting import CutPoint, row_keys
from repro_torch.kernels.ddpm_step import kernel, ops
from repro_torch.kernels.ddpm_step.ref import (ddpm_step_keyed_ref,
                                               ddpm_step_rowwise_ref)

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
T = 16
IMG = (4, 4, 3)
B, NC = 2, 3
SCHEDS = {"linear": DiffusionSchedule.linear(40, device="cpu"),
          "cosine": DiffusionSchedule.cosine(40, device="cpu")}


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


# ---- (a) coefficient tables ---------------------------------------------

def _rows_equal_per_step(sched, t, tp):
    table = ops.step_coefficient_table(sched, t, tp)
    assert table.shape == t.shape + (3,) and table.is_contiguous()
    for i in range(t.shape[0]):
        one = ops.step_coefficients(sched, t[i],
                                    None if tp is None else tp[i])
        assert _bits_equal(table[i], torch.stack(one)), i


@pytest.mark.parametrize("name", sorted(SCHEDS))
@pytest.mark.parametrize("t_cut", [0, 7, 25, 39])
def test_server_table_rows_equal_per_step_calls(name, t_cut):
    cut = CutPoint(40, t_cut)
    t = torch.from_numpy(cut.server_t_list()).float()
    _rows_equal_per_step(SCHEDS[name], t, None)


@pytest.mark.parametrize("name", sorted(SCHEDS))
@pytest.mark.parametrize("t_cut", [1, 9, 33, 40])
@pytest.mark.parametrize("adjusted", [True, False])
def test_client_table_rows_equal_per_step_calls(name, t_cut, adjusted):
    t, tp = CutPoint(40, t_cut).client_step_table(adjusted)
    _rows_equal_per_step(SCHEDS[name], torch.from_numpy(t),
                         torch.from_numpy(tp))


def _y(label):
    return np.broadcast_to(np.eye(NC, dtype=np.float32)[label],
                           (B, NC)).copy()


def _requests():
    """GM (0), ICM (T) and mid cuts, a duplicate (y, t_ζ) for the dedup."""
    return [tsp.SampleRequest(0, 6, _y(0)), tsp.SampleRequest(1, 0, _y(0)),
            tsp.SampleRequest(2, T, _y(1)), tsp.SampleRequest(1, 6, _y(0)),
            tsp.SampleRequest(2, 11, _y(2))]


@pytest.mark.parametrize("adjusted", [True, False])
def test_engine_tables_equal_per_column_calls(adjusted):
    """The (K, S, 3) table of a stage against the engine's former call per
    step, ``step_coefficients(sched, t[:, s], t_prev[:, s])``, padding
    columns included."""
    sched = DiffusionSchedule.linear(T, device="cpu")
    plan = tsp.plan_requests(_requests(), T, adjusted=adjusted, n_clients=3,
                             request_seeds=[5, 9, 11, 2, 7])
    tab = tsp.tables_to_device(plan.tables, "cpu")
    for t, tp in ((tab.group_t, tab.group_t_prev),
                  (tab.client_t, tab.client_t_prev)):
        table = ops.step_coefficient_table(sched, t, tp)
        assert table.shape == t.shape + (3,)
        for s in range(t.shape[1]):
            col = torch.stack(ops.step_coefficients(sched, t[:, s],
                                                    tp[:, s]), dim=1)
            assert _bits_equal(table[:, s], col), s


# ---- (b) the kernel's addressing in numpy uint32 --------------------------

def _source(name: str) -> str:
    return (CSRC / name).read_text()


def _key_schedule():
    """(parity, [(rotations of 4 rounds, x0 += word, x1 += word + n)]) as
    written in threefry.cuh's block()."""
    src = _source("threefry.cuh")
    body = src[src.index("block(Key k"):src.index("#undef THREEFRY_ROUNDS")]
    parity = int(re.search(r"k\.k0 \^ k\.k1 \^ 0x([0-9A-Fa-f]+)u",
                           body).group(1), 16)
    rounds = re.findall(r"THREEFRY_ROUNDS\((\d+), (\d+), (\d+), (\d+)\)",
                        body)
    inject = re.findall(r"x0 \+= (k\.k0|k\.k1|k2); x1 \+= (k\.k0|k\.k1|k2) "
                        r"\+ (\d+)u;", body)
    assert len(rounds) == len(inject) == 5
    return parity, [(tuple(map(int, r)), w0, w1, int(n))
                    for r, (w0, w1, n) in zip(rounds, inject)]


PARITY, SCHEDULE = _key_schedule()


def np_block(k0, k1, x0, x1):
    """threefry.cuh's block() on numpy uint32 arrays (broadcasting)."""
    u = np.uint32
    k0, k1, x0, x1 = (np.asarray(a, dtype=u) for a in (k0, k1, x0, x1))
    words = {"k.k0": k0, "k.k1": k1, "k2": k0 ^ k1 ^ u(PARITY)}
    with np.errstate(over="ignore"):        # uint32 words wrap
        x0, x1 = x0 + k0, x1 + k1
        for rots, w0, w1, n in SCHEDULE:
            for r in rots:
                x0 = x0 + x1
                x1 = ((x1 << u(r)) | (x1 >> u(32 - r))) ^ x0
            x0 = x0 + words[w0]
            x1 = x1 + words[w1] + u(n)
    return x0, x1


def np_key(key: torch.Tensor):
    w = prng.key_data(key)
    return w[..., 0], w[..., 1]


def np_bits(k0, k1, j):
    """bits(key, j): the counter (hi32(j), lo32(j)), the words XORed."""
    j = np.asarray(j, dtype=np.uint64)
    b0, b1 = np_block(k0, k1, (j >> np.uint64(32)).astype(np.uint32),
                      (j & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return b0 ^ b1


def _as_words(k0, k1) -> np.ndarray:
    return np.stack(np.broadcast_arrays(k0, k1), axis=-1)


def test_threefry_constants_are_prng_constants():
    """The schedule parsed from threefry.cuh is prng.py's, and so are the
    normal's float constants and the mantissa trick."""
    assert PARITY == prng._PARITY
    for i, (rots, w0, w1, n) in enumerate(SCHEDULE):
        assert rots == prng._ROTATIONS[i % 2]
        names = ("k.k0", "k.k1", "k2")
        assert (w0, w1, n) == (names[(i + 1) % 3], names[(i + 2) % 3], i + 1)
    src = _source("threefry.cuh")
    lo = float.fromhex(re.search(r"const float lo = (-0x[0-9a-fp.+-]+)f;",
                                 src).group(1))
    sqrt2 = float.fromhex(re.search(r"const float sqrt2 = (0x[0-9a-fp.+-]+)f;",
                                    src).group(1))
    assert np.float32(lo) == prng._NORMAL_LO and np.float32(lo) == lo
    assert np.float32(sqrt2) == prng._SQRT2 and np.float32(sqrt2) == sqrt2
    assert "(bits(k, j) >> 9) | 0x3F800000u" in src
    assert "__funnelshift_l(x, x, r)" in src


def test_split_chain_matches_prng():
    """The keyed launch reads k, writes split(k)[0] and draws with
    split(k)[1]: fold_in(k, 0) and fold_in(k, 1), along a chain."""
    k = prng.PRNGKey(11)
    m0, m1 = np_key(k)
    for _ in range(6):
        nxt, kn = prng.split(k)
        a0, a1 = np_block(m0, m1, 0, 0)
        n0, n1 = np_block(m0, m1, 0, 1)
        np.testing.assert_array_equal(_as_words(a0, a1), prng.key_data(nxt))
        np.testing.assert_array_equal(_as_words(n0, n1), prng.key_data(kn))
        k, (m0, m1) = nxt, (a0, a1)


def _threads() -> int:
    return int(re.search(r"constexpr int kKeyedThreads = (\d+);",
                         _source("ddpm_step.cu")).group(1))


@pytest.mark.parametrize("shape", [(2, 4, 4, 3), (3, 37), (1, 300)])
def test_keyed_grid_draws_prng_normal_bits(shape):
    """Thread i of the keyed grid hashes flat index i under split(k)[1];
    the bits equal random_bits(split(k)[1], shape) in flat order."""
    k = prng.PRNGKey(3)
    per = int(np.prod(shape))
    n = _threads()
    blocks = max(1, -(-per // n))
    i = np.arange(blocks * n)
    i = i[i < per]
    kn = np_block(*np_key(k), 0, 1)
    model = np_bits(kn[0], kn[1], i)
    ref = prng.random_bits(prng.split(k)[1], shape).reshape(-1).numpy()
    np.testing.assert_array_equal(model, ref.astype(np.uint32))


@pytest.mark.parametrize("K,Bn,row_shape,datum",
                         [(4, 2, (4, 4, 3), 1), (3, 5, (37,), 0),
                          (1, 1, (300,), 7), (2, 3, (130,), 2 ** 32 - 1)])
def test_rowwise_grid_draws_rowwise_normal_bits(K, Bn, row_shape, datum):
    """Block (x, b, k), thread t: j = x·threads + t below row, element
    o = (k·B + b)·row + j, key fold_in(fold_in(keys[k], d), b): the bits
    equal those under rowwise_normal's keys, element for element."""
    keys = prng.fold_in(prng.PRNGKey(5), torch.tensor([3, 8, 1, 9][:K]))
    row = int(np.prod(row_shape))
    n = _threads()
    kk, bb, jj = np.meshgrid(np.arange(K), np.arange(Bn),
                             np.arange(-(-row // n) * n), indexing="ij")
    keep = jj < row
    kk, bb, jj = kk[keep], bb[keep], jj[keep]
    o = (kk * Bn + bb) * row + jj
    w0, w1 = np_key(keys)
    d0, d1 = np_block(w0, w1, 0, datum & 0xFFFFFFFF)
    r0, r1 = np_block(d0[kk], d1[kk], 0, bb)
    model = np.zeros(K * Bn * row, np.uint32)
    model[o] = np_bits(r0, r1, jj)
    assert np.unique(o).size == K * Bn * row
    ref = prng.random_bits(row_keys(prng.fold_in(keys, datum), Bn),
                           row_shape).reshape(-1).numpy()
    np.testing.assert_array_equal(model, ref.astype(np.uint32))


def test_counter_splits_the_flat_index_into_hi_and_lo_words():
    k = prng.PRNGKey(9)
    j = np.array([0, 1, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 5, 2 ** 40 + 3],
                 dtype=np.uint64)
    ref = prng._bits_at(k, torch.from_numpy(j.astype(np.int64))).numpy()
    np.testing.assert_array_equal(np_bits(*np_key(k), j),
                                  ref.astype(np.uint32))


def test_uniform_arithmetic_matches_prng():
    """The mantissa trick, then × scale and + lo as two roundings and
    max(lo, ·): float32 numpy against prng's uniform, bitwise."""
    bits = np_bits(*np_key(prng.PRNGKey(2)), np.arange(4096))
    bits = np.concatenate([bits, np.array([0, 1, 511, 512, 2 ** 32 - 1],
                                          np.uint32)])
    lo = np.float32(prng._NORMAL_LO)
    scale = np.float32(1.0) - lo
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) \
        - np.float32(1.0)
    model = np.maximum(lo, f * scale + lo)
    ref = prng._uniform_from_bits(torch.from_numpy(bits.astype(np.int64)),
                                  float(lo), 1.0).numpy()
    np.testing.assert_array_equal(model.view(np.uint32),
                                  ref.view(np.uint32))


# ---- (c) the samplers and the engine, bitwise with their former composition

def apply_fn(p, x, t, y):
    """Param-, time- and label-dependent toy denoiser, row-independent."""
    lead = (-1,) + (1,) * (x.ndim - 1)
    return x * p["a"] + 0.001 * t.reshape(lead) + \
        0.01 * y.sum(-1).reshape(lead)


TSP = {"a": torch.tensor(0.2)}
TCP = [{"a": torch.tensor(v)} for v in (0.1, 0.3, 0.5)]


def _full(t, n):
    return t.reshape(()).expand(n)


def old_server_denoise(sp, key, y, shape, sched, cut):
    k0, k = prng.split(key)
    x = prng.normal(k0, shape)
    t_list = torch.from_numpy(cut.server_t_list()).float()
    for i in range(cut.n_server_steps):
        k, kn = prng.split(k)
        eps = apply_fn(sp, x, _full(t_list[i], shape[0]), y)
        noise = prng.normal(kn, x.shape)
        x = ops.ddpm_step(x, eps, noise, sched, t_list[i])
    return x


def old_client_denoise(cp, key, x, y, sched, cut, adjusted):
    t_np, tp_np = cut.client_step_table(adjusted)
    t_list, t_prev = torch.from_numpy(t_np), torch.from_numpy(tp_np)
    k = key
    for i in range(cut.n_client_steps):
        k, kn = prng.split(k)
        eps = apply_fn(cp, x, _full(t_list[i], x.shape[0]), y)
        noise = prng.normal(kn, x.shape)
        x = ops.ddpm_step(x, eps, noise, sched, t_list[i], t_prev=t_prev[i])
    return x


@pytest.mark.parametrize("t_cut", [0, 5, 20, 31])
@pytest.mark.parametrize("adjusted", [True, False])
def test_per_request_samplers_equal_former_composition(t_cut, adjusted):
    sched = DiffusionSchedule.linear(31, device="cpu")
    cut = CutPoint(31, t_cut)
    shape = (B,) + IMG
    y = torch.from_numpy(_y(1))
    key = prng.PRNGKey(4)
    x0, x_cut = ts.collaborative_sample(TSP, TCP[1], key, y, shape, sched,
                                        cut, apply_fn, adjusted=adjusted,
                                        return_handoff=True)
    ks, kc = prng.split(key)
    ref_cut = old_server_denoise(TSP, ks, y, shape, sched, cut)
    ref = old_client_denoise(TCP[1], kc, ref_cut, y, sched, cut, adjusted)
    assert _bits_equal(x_cut, ref_cut) and _bits_equal(x0, ref)


def old_engine(sched, key, tables):
    """The engine's two stages as they were: a draw, the given-noise
    batched step with per-step coefficients, then where(active)."""
    gy, gt, gtp, ga, gseed, rgroup, rclient, rseed, ct, ctp, ca = tables
    G, Bn = gy.shape[0], gy.shape[1]
    shape = (Bn,) + IMG
    lead = lambda v: v.reshape((-1,) + (1,) * len(shape))
    skey, ckey = prng.split(key)
    gkeys = prng.fold_in(skey, gseed)
    x = rowwise_normal(prng.fold_in(gkeys, 0), shape)
    for s in range(gt.shape[1]):
        eps = torch.stack([apply_fn(TSP, x[g], _full(gt[g, s], Bn), gy[g])
                           for g in range(G)])
        noise = rowwise_normal(prng.fold_in(gkeys, 1 + s), shape)
        xn = ops.ddpm_step_batched(x, eps, noise, sched, gt[:, s],
                                   t_prev=gtp[:, s])
        x = torch.where(lead(ga[:, s]) > 0, xn, x)
    handoff = x
    x = handoff[rgroup.long()]
    rkeys = prng.fold_in(ckey, rseed)
    for c in range(ct.shape[1]):
        eps = torch.stack([apply_fn(TCP[int(rclient[r])], x[r],
                                    _full(ct[r, c], Bn), gy[rgroup[r]])
                           for r in range(x.shape[0])])
        noise = rowwise_normal(prng.fold_in(rkeys, c), shape)
        xn = ops.ddpm_step_batched(x, eps, noise, sched, ct[:, c],
                                   t_prev=ctp[:, c])
        x = torch.where(lead(ca[:, c]) > 0, xn, x)
    return x, handoff


@pytest.mark.parametrize("adjusted", [True, False])
def test_engine_and_reference_equal_former_composition(adjusted):
    sched = DiffusionSchedule.linear(T, device="cpu")
    plan = tsp.plan_requests(_requests(), T, adjusted=adjusted, n_clients=3,
                             request_seeds=[5, 9, 11, 2, 7])
    key = prng.PRNGKey(1)
    tables = tsp.tables_to_device(plan.tables, "cpu")
    out, hand = ts.make_sample_engine(sched, apply_fn, IMG)(
        TSP, TCP, key, tables)
    ref_out, ref_hand = old_engine(sched, key, tables)
    assert _bits_equal(out, ref_out) and _bits_equal(hand, ref_hand)
    rout, rhand = ts.sample_plan_reference(TSP, TCP, key, plan, sched,
                                           apply_fn, IMG)
    assert _bits_equal(rout, out) and _bits_equal(rhand, hand)


def test_cpu_keyed_variants_launch_nothing():
    kernel.reset_counts()
    x = torch.randn(3, 2, 5)
    key, out_key = prng.PRNGKey(2), torch.empty(2, dtype=torch.int64)
    ops.ddpm_step_keyed(x, x, key, torch.ones(3), out_key)
    assert torch.equal(out_key, prng.split(key)[0])
    ops.ddpm_step_rowwise(x, x, prng.split(key, 3), 4, torch.ones(3, 3),
                          torch.tensor([1.0, 0.0, 1.0]))
    assert all(n == 0 for n in kernel.COUNTS.values())


# ---- (d) the wrappers' checks ------------------------------------------

def _keyed_args(**kw):
    x = torch.randn(2, 4, 4, 3)
    args = dict(x_t=x, eps_pred=torch.randn_like(x), key=prng.PRNGKey(1),
                coef=torch.ones(3), key_out=torch.empty(2, dtype=torch.int64))
    args.update(kw)
    return args


def _rowwise_args(**kw):
    x = torch.randn(3, 2, 4, 4, 3)
    table = torch.ones(3, 5, 3)
    args = dict(x_t=x, eps_pred=torch.randn_like(x),
                keys=prng.split(prng.PRNGKey(1), 3), datum=2,
                coef=table[:, 1], active=torch.ones(3, 4)[:, 0])
    args.update(kw)
    return args


@pytest.mark.parametrize("bad,match", [
    (dict(key=torch.zeros(3, dtype=torch.int64)), "key is"),
    (dict(key=torch.zeros(2, dtype=torch.int32)), "key is"),
    (dict(key_out=torch.zeros(1, 2, dtype=torch.int64)), "key_out is"),
    (dict(coef=torch.ones(1, 3)), "coef"),
    (dict(coef=torch.ones(3, dtype=torch.float64)), "coef"),
    (dict(coef=torch.ones(6)[::2]), "coef"),
    (dict(eps_pred=torch.randn(2, 4, 4, 2)), "eps_pred"),
    (dict(x_t=torch.zeros(2, 3, dtype=torch.float16),
          eps_pred=torch.zeros(2, 3, dtype=torch.float16)), "float32"),
])
def test_keyed_launch_checks(bad, match):
    before = dict(kernel.COUNTS)
    with pytest.raises((ValueError, TypeError), match=match):
        kernel.launch_keyed(**_keyed_args(**bad))
    assert kernel.COUNTS == before


def test_keyed_launch_refuses_overlapping_keys_and_cpu_tensors():
    buf = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="overlaps"):
        kernel.launch_keyed(**_keyed_args(key=buf, key_out=buf))
    two = torch.zeros(2, 2, dtype=torch.int64)        # rows 16 bytes apart
    with pytest.raises(ValueError, match="CUDA"):
        kernel.launch_keyed(**_keyed_args(key=two[0], key_out=two[1]))
    with pytest.raises(RuntimeError, match="no backward"):
        kernel.launch_keyed(**_keyed_args(coef=torch.ones(3,
                                                          requires_grad=True)))


@pytest.mark.parametrize("bad,match", [
    (dict(keys=torch.zeros(3, 3, dtype=torch.int64)), "keys is"),
    (dict(keys=torch.zeros(2, 2, dtype=torch.int64)), "keys is"),
    (dict(coef=torch.ones(3, 4)), "coef"),
    (dict(coef=torch.ones(3, 3).t()), "unit column stride"),
    (dict(coef=torch.ones(3, 3, dtype=torch.bfloat16)), "coef"),
    (dict(active=torch.ones(3, 1)), "active"),
    (dict(active=torch.ones(3, dtype=torch.bool)), "active"),
    (dict(x_t=torch.zeros(6), eps_pred=torch.zeros(6)), "stack"),
    (dict(eps_pred=torch.randn(3, 2, 4, 4, 3).transpose(1, 2)
          .contiguous().transpose(1, 2)), "contiguous"),
])
def test_rowwise_launch_checks(bad, match):
    before = dict(kernel.COUNTS)
    with pytest.raises((ValueError, TypeError), match=match):
        kernel.launch_rowwise(**_rowwise_args(**bad))
    assert kernel.COUNTS == before


def test_rowwise_launch_takes_strided_views_then_wants_cuda():
    """A step's column of a (K, S, 3) table and of the (K, S) mask pass
    the shape checks; on the CPU the device check refuses them."""
    with pytest.raises(ValueError, match="CUDA"):
        kernel.launch_rowwise(**_rowwise_args())
    with pytest.raises(RuntimeError, match="no backward"):
        kernel.launch_rowwise(**_rowwise_args(
            active=torch.ones(3, requires_grad=True)))


def test_variant_counters():
    assert set(kernel.COUNTS) == {
        "ddpm_step", "ddpm_step/given", "ddpm_step/keyed",
        "ddpm_step_batched", "ddpm_step_batched/given",
        "ddpm_step_batched/rowwise"}
    saved = dict(kernel.COUNTS)
    try:
        for k in kernel.COUNTS:
            kernel.COUNTS[k] = 3
        kernel.reset_counts()
        assert all(n == 0 for n in kernel.COUNTS.values())
    finally:
        kernel.COUNTS.update(saved)


# ---- (e) on the card -----------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 32, 32, 3), (2, 8, 8, 1), (1, 37),
                                   (3, 129)])
def test_cuda_keyed_matches_plain_composition(dtype, shape):
    _card()
    sched = DiffusionSchedule.linear(100, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    x, e = (torch.randn(shape, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    table = ops.step_coefficient_table(
        sched, torch.tensor([99.0, 50.5, 2.0, 1.0], device="cuda"))
    key = prng.PRNGKey(7, device="cuda")
    buf = torch.empty_like(key)
    for i in range(table.shape[0]):
        before = kernel.COUNTS["ddpm_step/keyed"]
        out = ops.ddpm_step_keyed(x, e, key, table[i], buf)
        assert kernel.COUNTS["ddpm_step/keyed"] == before + 1
        ref, k = ddpm_step_keyed_ref(x, e, key, table[i])
        torch.cuda.synchronize()
        assert torch.equal(buf, k)
        assert out.dtype == dtype and _bits_equal(out.float(), ref.float())
        x, key, buf = out, buf, key


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 4, 32, 32, 3), (3, 2, 37), (1, 1, 129),
                                   (2, 5, 8, 8, 1)])
def test_cuda_rowwise_matches_plain_composition(dtype, shape):
    _card()
    K = shape[0]
    sched = DiffusionSchedule.linear(100, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    x, e = (torch.randn(shape, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    t = torch.linspace(1.0, 99.0, K * 3, device="cuda").reshape(K, 3)
    table = ops.step_coefficient_table(sched, t, torch.clamp(t - 1.5,
                                                             min=0.0))
    active = (torch.arange(K * 3, device="cuda") % 3 != 1).float() \
        .reshape(K, 3)
    keys = prng.split(prng.PRNGKey(3, device="cuda"), K)
    for s in range(3):
        out = ops.ddpm_step_rowwise(x, e, keys, 1 + s, table[:, s],
                                    active[:, s])
        ref = ddpm_step_rowwise_ref(x, e, keys, 1 + s, table[:, s],
                                    active[:, s])
        torch.cuda.synchronize()
        assert out.dtype == dtype and _bits_equal(out.float(), ref.float())
        x = out
