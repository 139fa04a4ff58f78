"""The dry run (launch/dryrun.py) and the kernels' meta routes, on the CPU.

* In a subprocess (the fake process group of ``make_production_mesh``
  must not meet the ``gloo`` groups other test files set up in the same
  worker): ``run_pair`` for granite-8b ``decode_32k``, mamba2-2.7b
  ``long_500k`` and dbrx-132b ``train_4k`` (expert-parallel, ``ep``) on
  the single-pod fake mesh comes out ``ok`` with every field and a
  written record, each ``"partitioner": "dtensor"``; the decode pairs'
  census holds the all-reduces of the row-parallel outputs (and of
  granite's attention over a cache cut by its slots), granite's decode
  a sixth of the FLOPs of the same step with the batch cut alone and the
  same bytes per device; the MoE pair's census holds the
  expert-parallel all-to-alls, the experts' all-gathers over "data" and
  their gradients' reduce-scatters; a reduced granite-8b train step
  partitioned on the fake mesh holds all-gathers, reduce-scatters and
  all-reduces, fewer FLOPs than the same step with the batch cut alone,
  and parameter bytes from its placed tensors equal to
  ``device_bytes``; a pair the JAX package skips comes out ``skip`` with JAX's
  reason; a second production mesh in the same process is refused.
* ``reckon`` of a reduced granite-8b prefill on a one-device mesh of
  axis sizes: its FLOPs equal 2·M·N·K summed over the step's products,
  counted here from the config's shapes, plus flash attention's count
  from its cost, exactly; its bytes per device equal the parameters' and
  the batch's bytes.
* Each kernel op on meta tensors: the card path's output shapes and
  types and the tensors autograd saves (``FlashAttentionFn``,
  ``SsdScanFn``, ``GroupedMatmulFn``, the DDPM step's entries), its
  operations in ``kernels.FLOPS`` by the family's ``cost``, no launch
  counted, nothing computed.
* ``keep_count``'s closed form against the masks, pair by pair.
"""
import json
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_arch as jget_arch
from repro.launch.shapes import skip_reason as jskip_reason
from repro_torch import kernels
from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.kernels.ddpm_step import cost as ddpm_cost
from repro_torch.kernels.ddpm_step import kernel as dkernel
from repro_torch.kernels.ddpm_step import ops as dops
from repro_torch.kernels.flash_attention import cost as fa_cost
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.grouped_matmul import cost as gmm_cost
from repro_torch.kernels.grouped_matmul import kernel as gkernel
from repro_torch.kernels.grouped_matmul import ops as gops
from repro_torch.kernels.ssd_scan import cost as ssd_cost
from repro_torch.kernels.ssd_scan import kernel as skernel
from repro_torch.kernels.ssd_scan import ops as sops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import NVLINK_BW
from repro_torch.models import api

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIELDS = {"tag", "status", "arch", "shape", "mesh", "n_devices", "trace_s",
          "flops", "aten_flops", "kernel_flops", "bytes_per_device",
          "saved_activation_bytes", "saved_param_bytes", "collectives",
          "collective_bytes", "collective_bound_s", "partitioner",
          "moe_mode", "n_params", "n_active_params"}

_PAIRS = r'''
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
mesh = make_production_mesh()
out = [dryrun.run_pair(a, s, False, "ep", {out!r}, mesh) for a, s in (
    ("granite-8b", "decode_32k"), ("mamba2-2.7b", "long_500k"),
    ("dbrx-132b", "train_4k"), ("minicpm-2b", "long_500k"))]
import types
from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.launch import shapes
cfg = reduced(get_arch("granite-8b"))
shape = ShapeConfig("t", 32, 32, "train")
sizes = types.SimpleNamespace(shape={{"data": 16, "model": 16}})
out.append({{"part": dryrun.reckon(cfg, shape, mesh),
            "plain": dryrun.reckon(cfg, shape, sizes),
            "decode_plain": dryrun.reckon(get_arch("granite-8b"),
                                          "decode_32k", sizes),
            "param_bytes": dryrun.device_bytes(
                shapes.abstract_params(cfg, mesh), mesh)}})
try:
    make_production_mesh()
    out.append("second mesh accepted")
except RuntimeError as e:
    out.append(str(e))
print("RESULT " + json.dumps(out))
'''


def test_run_pair_on_the_fake_production_mesh(tmp_path):
    code = _PAIRS.format(src=str(ROOT / "src"), out=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    *recs, red, refused = json.loads(line[-1][len("RESULT "):])
    assert "exists already" in refused
    for rec in recs[:3]:
        assert rec["status"] == "ok" and set(rec) == FIELDS, rec
        assert rec["n_devices"] == 256 and rec["mesh"] == "pod16x16"
        assert rec["partitioner"] == "dtensor"
        assert rec["flops"] > 0
        assert rec["bytes_per_device"]["total"] == sum(
            v for k, v in rec["bytes_per_device"].items() if k != "total")
        saved = json.loads((tmp_path / f"{rec['tag']}.json").read_text())
        assert saved == rec
    decode, long, moe = recs[:3]
    for rec in (decode, long):
        assert rec["collectives"]["all-reduce"]["count"] > 0
        assert "all-to-all" not in rec["collectives"]
    assert decode["saved_activation_bytes"] == {"per_device": 0,
                                                "global": 0}
    # granite's 8 K/V heads over 16 model ranks: the cache is cut by its
    # slots, and each layer all-reduces the max and the two sums
    assert decode["collectives"]["all-reduce"]["count"] >= \
        4 * get_arch("granite-8b").n_layers
    plain = red["decode_plain"]
    assert plain["partitioner"] is None and plain["collectives"] == {}
    assert 0 < 6 * decode["flops"] < plain["flops"]
    assert decode["bytes_per_device"] == plain["bytes_per_device"]
    assert moe["moe_mode"] == "ep" and \
        moe["collectives"]["all-to-all"]["count"] > 0
    # the experts gathered over "data" forward (three tensors a layer),
    # their gradients reduce-scattered back
    layers = get_arch("dbrx-132b").n_layers
    assert moe["collectives"]["all-gather"]["count"] >= 3 * layers
    assert moe["collectives"]["reduce-scatter"]["count"] >= 3 * layers
    assert moe["collective_bytes"] == sum(
        c["bytes"] for c in moe["collectives"].values()) > 0
    assert moe["collective_bound_s"] == moe["collective_bytes"] / NVLINK_BW
    assert moe["kernel_flops"]["grouped_matmul_bwd"] == \
        2 * moe["kernel_flops"]["grouped_matmul"]
    assert moe["saved_activation_bytes"]["global"] == \
        16 * moe["saved_activation_bytes"]["per_device"]
    skip = recs[3]
    assert skip == {"tag": "minicpm-2b__long_500k__pod16x16",
                    "status": "skip",
                    "reason": jskip_reason(jget_arch("minicpm-2b"),
                                           JSHAPES["long_500k"])}
    # a reduced granite-8b train step partitioned on the fake mesh against
    # the same step with the batch cut alone (a mesh of axis sizes)
    part, plain = red["part"], red["plain"]
    assert part["partitioner"] == "dtensor" and plain["partitioner"] is None
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= \
        set(part["collectives"]) and plain["collectives"] == {}
    assert 0 < part["flops"] < plain["flops"]
    assert part["bytes_per_device"] == plain["bytes_per_device"]
    assert part["bytes_per_device"]["params"] == red["param_bytes"]


def _matmul_flops(cfg, B: int, S: int) -> int:
    """2·M·N·K over a dense LM prefill's products: per layer q, k, v, o
    and the SwiGLU's three; the unembedding of the last token."""
    D, H, Hkv, dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim_, cfg.d_ff)
    M = B * S
    per_layer = 2 * M * (D * H * dh + 2 * D * Hkv * dh + H * dh * D +
                         3 * D * F)
    return cfg.n_layers * per_layer + 2 * B * D * cfg.vocab_size


def test_reckoned_flops_and_bytes_of_a_dense_prefill():
    cfg = reduced(get_arch("granite-8b"))
    assert cfg.mlp_type == "swiglu"
    B, S = 2, 48
    one = types.SimpleNamespace(shape={"data": 1, "model": 1})
    rec = dryrun.reckon(cfg, ShapeConfig("t", S, B, "prefill"), one)
    flash = cfg.n_layers * fa_cost.cost(
        (B, cfg.n_heads, S, cfg.head_dim_), (B, cfg.n_kv_heads, S,
                                             cfg.head_dim_),
        True, cfg.sliding_window or 0, 4)[1]
    assert rec["kernel_flops"] == {"flash_attention": flash}
    assert rec["aten_flops"] == _matmul_flops(cfg, B, S)
    assert rec["flops"] == rec["aten_flops"] + flash
    n_param_bytes = 4 * sum(p.numel() for p in
                            api.empty_params(cfg, "meta").parameters())
    assert rec["bytes_per_device"] == {
        "params": n_param_bytes, "opt_state": 0, "batch": 2 * B * S * 4,
        "decode_state": 0, "total": n_param_bytes + 2 * B * S * 4}
    assert rec["collectives"] == {} and rec["moe_mode"] is None


def _saved_shapes(fn):
    shapes = []

    def pack(t):
        shapes.append((tuple(t.shape), t.dtype))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, shapes


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


@pytest.fixture
def counters():
    for kmod in (fkernel, skernel, gkernel, dkernel):
        kmod.reset_counts()
    kernels.reset_flops()
    yield
    for kmod in (fkernel, skernel, gkernel, dkernel):
        assert not any(kmod.COUNTS.values()), kmod.COUNTS
    kernels.reset_flops()


def test_flash_attention_meta_route(counters):
    q = _meta(2, 4, 40, 32, dtype=torch.bfloat16, grad=True)
    k = _meta(2, 2, 40, 32, dtype=torch.bfloat16, grad=True)
    v = _meta(2, 2, 40, 32, dtype=torch.bfloat16, grad=True)
    out, saved = _saved_shapes(
        lambda: fops.flash_attention(q, k, v, causal=True, window=16))
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    assert saved == [((2, 4, 40, 32), torch.bfloat16),
                     ((2, 2, 40, 32), torch.bfloat16),
                     ((2, 2, 40, 32), torch.bfloat16),
                     ((2, 4, 40, 32), torch.bfloat16),
                     ((2, 4, 40), torch.float32)]
    dq, dk, dv = torch.autograd.grad(out, (q, k, v),
                                     torch.empty_like(out))
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    fwd = fa_cost.cost(q.shape, k.shape, True, 16, 2)[1]
    bwd = fa_cost.cost_backward(q.shape, k.shape, True, 16, 2)[1]
    assert kernels.FLOPS == {"flash_attention": fwd,
                             "flash_attention_bwd": bwd}
    with torch.no_grad():
        assert fops.flash_attention(q, k, v).shape == q.shape


def test_ssd_scan_meta_route(counters):
    b, s, h, p, n = 2, 40, 3, 16, 8
    x = _meta(b, s, h, p, grad=True)
    dt, A = _meta(b, s, h, grad=True), _meta(h, grad=True)
    Bm, Cm = _meta(b, s, n, grad=True), _meta(b, s, n, grad=True)
    (y, final), saved = _saved_shapes(
        lambda: sops.ssd_scan(x, dt, A, Bm, Cm, 16))
    assert y.shape == x.shape and y.dtype == x.dtype
    assert final.shape == (b, h, p, n) and final.dtype == torch.float32
    assert [sh for sh, _ in saved] == [(b, s, h, p), (b, s, h), (h,),
                                       (b, s, n), (b, s, n)]
    grads = torch.autograd.grad(y, (x, dt, A, Bm, Cm), torch.empty_like(y))
    assert [g.shape for g in grads] == [t.shape for t in (x, dt, A, Bm, Cm)]
    assert kernels.FLOPS == {
        "ssd_scan": ssd_cost.cost(x.shape, n, 16, 4)[1],
        "ssd_scan_bwd": ssd_cost.cost_backward(x.shape, n, 16, 4)[1]}


def test_grouped_matmul_meta_route(counters):
    E, C, D, F = 4, 24, 16, 40
    tokens = _meta(C, D, dtype=torch.bfloat16, grad=True)
    w = _meta(E, D, F, dtype=torch.bfloat16, grad=True)
    shared = tokens.unsqueeze(0).expand(E, -1, -1)
    out, saved = _saved_shapes(lambda: gops.grouped_matmul(shared, w))
    assert out.shape == (E, C, F) and out.dtype == torch.bfloat16
    assert [sh for sh, _ in saved] == [(E, C, D), (E, D, F)]
    dtok, dw = torch.autograd.grad(out, (tokens, w), torch.empty_like(out))
    assert dtok.shape == (C, D) and dw.shape == (E, D, F)
    assert kernels.FLOPS == {
        "grouped_matmul": gmm_cost.cost(E, C, D, F, 2, True)[1],
        "grouped_matmul_bwd": gmm_cost.cost_backward(E, C, D, F, 2,
                                                     True)[1]}


def test_ddpm_step_meta_routes(counters):
    x = _meta(4, 8, 8, 3)
    key, key_out = _meta(2, dtype=torch.int64), _meta(2, dtype=torch.int64)
    out = dops.ddpm_step_keyed(x, torch.empty_like(x), key, _meta(3),
                               key_out)
    assert out.is_meta and out.shape == x.shape
    xs = _meta(3, 4, 8, 8, 3)
    out = dops.ddpm_step_rowwise(xs, torch.empty_like(xs),
                                 _meta(3, 2, dtype=torch.int64), 1,
                                 _meta(3, 3), _meta(3))
    assert out.shape == xs.shape
    per = x.numel()
    assert kernels.FLOPS == {
        "ddpm_step": per * ddpm_cost.DRAW_FLOAT_OPS,
        "ddpm_step_batched": xs.numel() * ddpm_cost.DRAW_FLOAT_OPS}


@pytest.mark.parametrize("S", [1, 7, 64, 100])
def test_keep_count_closed_form(S):
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    for causal in (False, True):
        for window in (0, 1, 3, 50, 200):
            keep = torch.ones(S, S, dtype=torch.bool)
            if causal:
                keep &= j <= i
            if window > 0:
                keep &= (i - j) < window
            assert fa_cost.keep_count(S, causal, window) == int(keep.sum())
