"""``chip_smoke.py``'s accounting, checked on the CPU: the device time of
a profile, the grouped matmul's bound, and the ``kernels`` line.

A kineto ``key_averages()`` holds a row per CPU op and a row per device
kernel; the CPU op's self device time repeats the time of the kernels it
launched.  Device time is the sum over the device rows alone (the rule of
torch's own profiler table); summing every row counted those kernels
twice.  The grouped matmul's bound counts its bytes (tokens read once,
one set when broadcast to every expert) and its flops, the keyed DDPM
step's its bytes and its draw's operations, the grouped matmul's
backward its two products'; the ``kernels`` line lists all eight
kernels (the five ports and the three backward kernels) with every key
the contract names, and the kernels with variants their launches per
variant; a main path's DDPM-step launches must all be keyed.  Phase 13
asserts no refusal: it trains the MoE DiT, and the MoE training phase's
configuration follows the paths' capacities.  The training
phase's checks (state copies, bitwise and toleranced comparisons of
params, moments and step counters, the per-step recorder) run on a tiny
round on the CPU.  The backward kernels' row check (``row_gap``): a
sound bf16 kernel (another summation order, one rounding) reads within
BWD_BF16_ROW, each planted fault beyond it, and rows that are zero in
exact arithmetic read against the floor.
"""
import dataclasses
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _row(device_type, us, count=1, **kw):
    return SimpleNamespace(device_type=device_type, self_device_time_total=us,
                           count=count, key="k", **kw)


def test_device_rows_count_each_kernel_once():
    cs = _chip_smoke()
    rows = [_row(DeviceType.CPU, 30.0),        # aten::mm: its kernel's time
            _row(DeviceType.CUDA, 30.0),       # the GEMM kernel itself
            _row(DeviceType.CUDA, 5.0, 2),     # a ctypes kernel, no CPU op
            _row(DeviceType.CUDA, 7.0, is_user_annotation=True)]
    picked = cs.device_rows(rows)
    assert sum(e.self_device_time_total for e in picked) == 35.0
    assert sum(e.count for e in picked) == 3


def test_device_rows_of_a_cpu_profile_are_empty():
    with profile(activities=[ProfilerActivity.CPU]) as p:
        torch.ones(4).add_(1)
    assert _chip_smoke().device_rows(p.key_averages()) == []


def test_gmm_bound_counts_bytes_and_flops_of_the_moe_path():
    """(16, 256, 6144) @ (16, 6144, 10752) in bf16 with tokens broadcast:
    the weights, one token set and the output in bytes, 2·E·C·D·F flops;
    bytes bind on the H100."""
    cs = _chip_smoke()
    E, C, D, F = 16, 256, 6144, 10752
    nbytes, flops = cs.gmm_cost.cost(E, C, D, F, 2, True)
    assert nbytes == 2 * (C * D + E * D * F + E * C * F)
    assert flops == 2 * E * C * D * F == 541_165_879_296
    ms, by = cs.gmm_bound(E, C, D, F, 2, True)
    assert by == "bytes"
    assert ms == nbytes / cs.HBM_BYTES_PER_S * 1e3
    assert 0.65 < ms < 0.67
    # without the broadcast every expert's tokens are read
    unshared, _ = cs.gmm_cost.cost(E, C, D, F, 2, False)
    assert unshared - nbytes == 2 * (E - 1) * C * D
    # float32 at the CUDA-core rate: operations bind
    ms32, by32 = cs.gmm_bound(E, C, D, F, 4, True)
    assert by32 == "operations"
    assert ms32 == flops / cs.FP32_FLOPS_PER_S * 1e3


def test_kernels_line_lists_every_kernel_with_every_key():
    """Every kernel carries the contract's keys; the three kernels with
    variants also carry their launches per variant and their card time,
    flash its numbers at head dim 128, the SSD scan its simt variant's
    time and the grouped matmul its three shapes; the two backward
    kernels their shape, card time and events a launch, their largest
    row gap, its limit and the planted faults' gaps; the Mamba2 mixer's
    three glue kernels their card time and their numbers at the LM
    prefill, each naming the JAX function whose glue it takes over."""
    cs = _chip_smoke()
    names = ["ddpm_step_batched", "ddpm_step", "flash_attention",
             "ssd_scan", "grouped_matmul", "flash_attention_bwd",
             "ssd_scan_bwd", "grouped_matmul_bwd", "mamba_conv_silu",
             "mamba_rmsnorm", "mamba_rmsnorm_gated"]
    records = {n: dict(max_abs_err=0.0, ms=1.0, plain_ms=2.0, bound_ms=0.5,
                       bound_by="bytes") for n in names}
    for n in ("flash_attention_bwd", "ssd_scan_bwd", "grouped_matmul_bwd"):
        records[n].update(shape=[4, 8], card_ms=0.9, card_events=3.0,
                          library_ms=None, row_gap=0.003, row_limit=0.01,
                          faults={"dv past the first K/V tile": 0.02})
    records["grouped_matmul_bwd"].update(
        library_ms=30.0, shapes=[dict(what="dense LM", ms=90.0)],
        steps={"dense": {}})
    records["flash_attention_bwd"]["dbrx_train"] = dict(ms=1.0)
    records["grouped_matmul"].update(library_ms=0.8, card_ms=0.79,
                                     shapes=[dict(name="gate", ms=0.8)],
                                     capacity_shapes=[dict(ms=0.3)])
    records["flash_attention"].update(
        library_ms=0.03, card_ms=0.004,
        head_dim_128=dict(ms=0.028, library_ms=0.035, bound_ms=0.0022))
    records["ssd_scan"].update(library_ms=None, card_ms=0.0054,
                               simt_ms=0.082)
    keyed = dict(op_ms=0.004, composed_ms=0.9, composed_card_ms=0.05,
                 composed_events=420, keyed_card_ms=0.002, keyed_events=1,
                 given=dict(ms=0.015, launch_ms=0.012))
    records["ddpm_step"].update(card_ms=0.0016, **keyed)
    records["ddpm_step_batched"].update(card_ms=0.0021, **keyed)
    for n in cs.MIXER_KERNELS:
        records[n].update(library_ms=None, card_ms=0.005,
                          lm_prefill=dict(ms=0.03, bound_ms=0.01))
    launches = {n: i + 1 for i, n in enumerate(names)}
    launches.update({"flash_attention/wgmma": 3, "flash_attention/simt": 0,
                     "grouped_matmul/wgmma": 5, "grouped_matmul/wmma": 0,
                     "grouped_matmul/simt": 0, "ssd_scan/wgmma": 4,
                     "ssd_scan/simt": 0, "ddpm_step/keyed": 2,
                     "ddpm_step/given": 0, "ddpm_step_batched/rowwise": 1,
                     "ddpm_step_batched/given": 0,
                     "flash_attention_bwd/simt": 6, "ssd_scan_bwd/simt": 7,
                     "grouped_matmul_bwd/wgmma": 8,
                     "grouped_matmul_bwd/wmma": 1,
                     "grouped_matmul_bwd/simt": 0})
    line = cs.kernels_line(records, launches)
    assert [k["name"] for k in line["kernels"]] == names
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    extra = {"flash_attention": {"launches_by_variant", "card_ms",
                                 "head_dim_128"},
             "ssd_scan": {"launches_by_variant", "card_ms", "simt_ms"},
             "grouped_matmul": {"launches_by_variant", "card_ms", "shapes",
                                "capacity_shapes"},
             "ddpm_step": {"card_ms", "launches_by_variant"} | set(keyed),
             "ddpm_step_batched": {"card_ms", "launches_by_variant"} |
             set(keyed),
             "flash_attention_bwd": {"launches_by_variant", "card_ms",
                                     "card_events", "shape", "row_gap",
                                     "row_limit", "faults", "dbrx_train"},
             "ssd_scan_bwd": {"launches_by_variant", "card_ms",
                              "card_events", "shape", "row_gap",
                              "row_limit", "faults"},
             "grouped_matmul_bwd": {"launches_by_variant", "card_ms",
                                    "card_events", "shape", "row_gap",
                                    "row_limit", "faults", "shapes"},
             **dict.fromkeys(cs.MIXER_KERNELS, {"card_ms", "lm_prefill"})}
    for k in line["kernels"]:
        assert set(k) == keys | extra.get(k["name"], set())
        assert k["route"] == "cuda"
        assert (ROOT / k["source"]).is_file()
        path, line_no = k["replaces"].split(":")
        src = (ROOT / path).read_text().splitlines()
        assert src[int(line_no) - 1].startswith("def ")
        assert k["launches"] == launches[k["name"]]
    flash, ssd, gmm = line["kernels"][2], line["kernels"][3], \
        line["kernels"][4]
    fbwd, sbwd, gbwd = line["kernels"][5:8]
    assert {k["source"] for k in line["kernels"][8:]} == {
        "src/repro_torch/csrc/mamba_mixer.cu"}
    assert gbwd["source"] == "src/repro_torch/csrc/grouped_matmul_bwd.cu"
    assert gbwd["replaces"] == gmm["replaces"] == \
        "src/repro/kernels/grouped_matmul/kernel.py:39"
    assert gbwd["launches_by_variant"] == {"wgmma": 8, "wmma": 1,
                                           "simt": 0}
    assert gbwd["shapes"] == [dict(what="dense LM", ms=90.0)]
    assert "steps" not in gbwd
    assert gmm["capacity_shapes"] == [dict(ms=0.3)]
    assert fbwd["dbrx_train"] == dict(ms=1.0)
    assert fbwd["source"] == "src/repro_torch/csrc/flash_attention_bwd.cu"
    assert fbwd["replaces"] == flash["replaces"]
    assert sbwd["replaces"] == ssd["replaces"]
    assert fbwd["launches_by_variant"] == {"simt": 6}
    assert sbwd["card_events"] == 3.0
    assert fbwd["faults"] == {"dv past the first K/V tile": 0.02}
    assert ssd["launches_by_variant"] == {"wgmma": 4, "simt": 0}
    assert ssd["card_ms"] == 0.0054 and ssd["simt_ms"] == 0.082
    assert ssd["library_ms"] is None
    assert ssd["replaces"] == "src/repro/kernels/ssd_scan/kernel.py:69"
    assert flash["launches_by_variant"] == {"wgmma": 3, "simt": 0}
    assert flash["head_dim_128"] == records["flash_attention"]["head_dim_128"]
    assert flash["card_ms"] == 0.004 and flash["library_ms"] == 0.03
    assert gmm["launches_by_variant"] == {"wgmma": 5, "wmma": 0, "simt": 0}
    assert gmm["source"] == "src/repro_torch/csrc/grouped_matmul.cu"
    assert gmm["replaces"] == "src/repro/kernels/grouped_matmul/kernel.py:39"
    assert gmm["library_ms"] == 0.8 and gmm["card_ms"] == 0.79
    assert line["kernels"][0]["library_ms"] is None
    assert line["kernels"][1]["card_ms"] == 0.0016
    assert line["kernels"][0]["card_ms"] == 0.0021
    assert line["kernels"][1]["launches_by_variant"] == {"keyed": 2,
                                                         "given": 0}
    assert line["kernels"][0]["launches_by_variant"] == {"rowwise": 1,
                                                         "given": 0}
    assert line["kernels"][1]["given"] == keyed["given"]


def test_keyed_bound_counts_bytes_and_the_draws_operations():
    """At the per-request shape (4, 32, 32, 3) fp32: x and eps read and
    the output written, the two keys and a coefficient row take 0.044 us;
    the draw's integer operations at 64 an SM a clock take longer, 0.060
    us, and bind.  Integer and float operations together at one a lane a
    clock stay under that.  At K = 4 slabs of it: 0.176 us of bytes, 0.241
    us of integer operations; a masked slab moves x only and draws
    nothing."""
    cs = _chip_smoke()
    assert cs.FP32_INSTR_PER_S == cs.FP32_FLOPS_PER_S / 2
    assert cs.INT32_OPS_PER_S == cs.FP32_FLOPS_PER_S / 4
    n = 4 * 32 * 32 * 3
    ms, by = cs.keyed_bound(n, 4, 2, 44)
    t_bytes = (3 * n * 4 + 44) / cs.HBM_BYTES_PER_S * 1e3
    int_ops = n * cs.ddpm_cost.DRAW_INT_OPS + \
        2 * cs.ddpm_cost.THREEFRY_INT_OPS
    assert round(t_bytes * 1e3, 3) == 0.044
    assert by == "operations" and ms == int_ops / cs.INT32_OPS_PER_S * 1e3
    assert round(ms * 1e3, 3) == 0.060
    all_ops = int_ops + n * cs.ddpm_cost.DRAW_FLOAT_OPS
    assert all_ops / cs.FP32_INSTR_PER_S * 1e3 < ms
    msb, byb = cs.keyed_bound(4 * n, 4, 4 + 16, 4 * 32)
    assert byb == "operations" and round(msb * 1e3, 3) == 0.241
    assert (3 * 4 * n * 4 + 4 * 32) / cs.HBM_BYTES_PER_S * 1e3 < msb
    masked, _ = cs.keyed_bound(3 * n, 4, 3 + 12, 4 * 32, passed=n)
    assert masked < msb
    # bytes bind where the draw is small beside what moves: one element
    # of a slab that is masked off but for it
    _, by_masked = cs.keyed_bound(1, 4, 2, 44, passed=n)
    assert by_masked == "bytes"
    assert cs.ddpm_cost.THREEFRY_INT_OPS == 2 + 5 * 4 * 3 + 5 * 3


def test_check_ddpm_launches_wants_only_the_keyed_variants():
    cs = _chip_smoke()
    good = {"ddpm_step": 10, "ddpm_step/keyed": 10, "ddpm_step/given": 0,
            "ddpm_step_batched": 7, "ddpm_step_batched/rowwise": 7,
            "ddpm_step_batched/given": 0}
    cs.check_ddpm_launches("t", good, 10, 7)
    for bad in (dict(good, **{"ddpm_step/given": 1, "ddpm_step": 11}),
                dict(good, **{"ddpm_step_batched/rowwise": 6}),
                {"ddpm_step": 10, "ddpm_step_batched": 7}):
        with pytest.raises(AssertionError, match="DDPM-step launches"):
            cs.check_ddpm_launches("t", bad, 10, 7)


def _small_round_inputs():
    import dataclasses
    from repro_torch.configs.ddpm_unet import SMALL
    from repro_torch.core import prng
    from repro_torch.core.collab import CollabConfig, setup
    from repro_torch.data.synthetic import (SyntheticConfig, batches,
                                            make_client_datasets)
    cfg = CollabConfig(n_clients=2, T=20, t_cut=5, image_size=8,
                       batch_size=2,
                       unet=dataclasses.replace(SMALL, image_size=8))
    state, step_fn, _ = setup(prng.PRNGKey(0), cfg, device="cpu")
    data = make_client_datasets(prng.PRNGKey(1), SyntheticConfig(image_size=8),
                                2, 4, device="cpu")
    rb = [list(batches(x, y, 2, prng.fold_in(prng.PRNGKey(2), c)))
          for c, (x, y) in enumerate(data)]
    return state, step_fn, rb


def test_train_phase_checks_on_the_cpu():
    """The training phase's checks at a tiny size: a copied state equals
    its source bitwise, a round changes every kind of tensor, the same
    round from the copy repeats the first bitwise (metrics of every step
    too), and the per-step recorder keeps one entry a step."""
    from repro_torch.core import prng
    from repro_torch.core.collab import train_round
    cs = _chip_smoke()
    torch.manual_seed(0)
    state, step_fn, rb = _small_round_inputs()
    init = cs.copy_state(state, "cpu")
    names = cs.state_tensors(state)
    assert {"server.step", "client1.step"} <= set(names)
    assert any(n.startswith("client0.m.") for n in names)
    assert cs.compare_states(state, init) == {
        k: (0.0, 0) for k in ("p", "m", "v", "step")}
    rec, rec2 = [], []
    train_round(state, cs.recording(step_fn, rec), rb, prng.PRNGKey(3))
    assert len(rec) == 4 and state.step == 4
    assert set(rec[0]) == {"client_loss", "client_grad_norm", "server_loss",
                           "server_grad_norm", "payload_bytes"}
    moved = cs.compare_states(state, init)
    assert all(bad > 0 for _, bad in moved.values())
    assert moved["step"] == (4.0, 3)          # server 4 and clients 2 + 2
    train_round(init, cs.recording(step_fn, rec2), rb, prng.PRNGKey(3))
    assert cs.compare_states(state, init) == {
        k: (0.0, 0) for k in ("p", "m", "v", "step")}
    assert cs.metrics_diff(rec, rec2) == 0.0
    # within a tolerance: nothing beyond it for equal states
    assert all(bad == 0 for _, bad in
               cs.compare_states(state, init, cs.TRAIN_TOL).values())
    assert cs.moment_gaps(state, init) == {"m": 0.0, "v": 0.0}
    assert cs.train_parity(state, init, rec, rec2)[1] == []
    rec2[0] = dict(rec2[0], client_loss=rec2[0]["client_loss"] * 1.5)
    assert cs.metrics_diff(rec, rec2) > cs.TRAIN_METRIC_RTOL
    assert cs.train_parity(state, init, rec, rec2)[1] == [
        f"metrics {cs.metrics_diff(rec, rec2):.3g}"]


@pytest.mark.parametrize("kind", ["m", "v"])
def test_train_parity_holds_moments_to_their_scale(kind):
    """A moment 1% off, or zero, is not within TRAIN_MOMENT_RTOL of its own
    scale, however small the moment is against TRAIN_TOL's atol."""
    from repro_torch.core import prng
    from repro_torch.core.collab import train_round
    cs = _chip_smoke()
    torch.manual_seed(0)
    state, step_fn, rb = _small_round_inputs()
    rec = []
    train_round(state, cs.recording(step_fn, rec), rb, prng.PRNGKey(3))
    for scale in (1.01, 0.0):
        off = cs.copy_state(state, "cpu")
        for t in off.server_opt[kind].values():
            t.mul_(scale)
        gaps = cs.moment_gaps(off, state)
        assert gaps[kind] == pytest.approx(abs(1 - scale), rel=1e-3)
        assert f"{kind} scaled {gaps[kind]:.3g}" in \
            cs.train_parity(off, state, rec, rec)[1]


def test_train_phase_is_the_paper_round():
    """Six models (server + 5 clients, paper §4), 2 batches of 8 per
    client: 10 Alg.-1 steps at cut 250 of T = 1000."""
    cs = _chip_smoke()
    assert (cs.TRAIN_CLIENTS, cs.TRAIN_CUT, cs.TRAIN_BATCH,
            cs.TRAIN_BATCHES) == (5, 250, 8, 2)
    assert cs.TRAIN_TOL == dict(atol=2e-5, rtol=2e-3)
    assert cs.TRAIN_MOMENT_RTOL == 2e-3


def _toy_runtime(**kw):
    import numpy as np
    from repro_torch.core import prng
    from repro_torch.launch.collab_train import toy_apply, toy_init
    from repro_torch.train import ParticipationConfig, TrainConfig, \
        TrainRuntime
    cfg = TrainConfig(T=20, t_cut=5, image_shape=(6, 6, 3), n_classes=4,
                      batch_size=4, batches_per_round=2,
                      participation=ParticipationConfig(policy="full"), **kw)
    rt = TrainRuntime(cfg, toy_init, toy_apply, prng.PRNGKey(0),
                      device="cpu")
    rng = np.random.default_rng(0)
    for n in (8, 6, 4):
        rt.register_client(
            torch.from_numpy(rng.normal(size=(n, 6, 6, 3)).astype(
                np.float32)),
            torch.from_numpy(np.eye(4, dtype=np.float32)[
                rng.integers(0, 4, n)]))
    return cfg, rt


def test_runtime_phase_checks_on_the_cpu():
    """The training-runtime phase's checks on a toy runtime: its tensors
    name every model, moment, step, the EMA and the DP reference; equal
    runs compare bitwise, a run one round further does not; a cohort of 3
    seated in 4 slots (and 3 seated in 8) leaves a zero gap."""
    from repro_torch.launch.collab_train import toy_apply
    from repro_torch.train import PrivacyConfig
    cs = _chip_smoke()
    cfg, a = _toy_runtime(ema_decay=0.9, fedavg_every=1,
                          privacy=PrivacyConfig(clip=1.0,
                                                noise_multiplier=0.5))
    _, b = _toy_runtime(ema_decay=0.9, fedavg_every=1,
                        privacy=PrivacyConfig(clip=1.0,
                                              noise_multiplier=0.5))
    names = cs.runtime_tensors(a)
    assert {"server.p.a", "server.m.b", "server.step", "client2.v.a",
            "client0.step", "ema.p.a", "dpref.p.b"} <= set(names)
    a.run(2)
    b.run(2)
    cs.assert_runtime_bitwise("twins", a, b)
    assert cs.runtime_counters(a)[2] == 2            # two DP releases
    b.run_round()
    with pytest.raises(AssertionError, match="not bitwise"):
        cs.assert_runtime_bitwise("one round apart", a, b)
    assert cs.padding_gap(a, cfg, toy_apply, [0, 1, 2], {}) == 0.0
    assert cs.padding_gap(a, cfg, toy_apply, [0, 2], {0: 1}) == 0.0


def test_kernels_line_counts_launches_per_path():
    cs = _chip_smoke()
    names = list(cs.KERNELS)
    records = {n: dict(max_abs_err=0.0, ms=1.0, plain_ms=2.0, bound_ms=0.5,
                       bound_by="bytes", library_ms=None) for n in names}
    by_path = {"serve": {"ddpm_step": 1000, "ddpm_step_batched": 3875},
               "train": {"ddpm_step": 1000},
               "train_runtime": {"ddpm_step": 1000},
               "dit": {"ddpm_step": 1000, "flash_attention": 6}}
    launches = {n: sum(p.get(n, 0) for p in by_path.values())
                for n in names}
    line = cs.kernels_line(records, launches, by_path)
    ddpm = line["kernels"][1]
    assert ddpm["launches"] == 4000
    assert ddpm["launches_by_path"] == {"serve": 1000, "train": 1000,
                                        "train_runtime": 1000, "dit": 1000}
    assert line["kernels"][4]["launches_by_path"] == dict.fromkeys(
        by_path, 0)


def test_runtime_phase_configuration():
    """The runtime phase's configuration: 4 rounds, bernoulli p 0.8 with
    dropout 0.1, FedAvg every 2, EMA 0.99, base key 1, DP clip 1.0 and
    noise 0.8, on the training phase's six U-Nets and batches."""
    cs = _chip_smoke()
    assert (cs.RT_ROUNDS, cs.RT_P, cs.RT_DROP, cs.RT_FEDAVG, cs.RT_EMA,
            cs.RT_SEED) == (4, 0.8, 0.1, 2, 0.99, 1)
    assert cs.RT_DP == dict(clip=1.0, noise_multiplier=0.8)


def test_main_runs_every_phase_in_order():
    """The phases main() drives, in order: the Mamba2 mixer's glue kernels
    right after flash and the SSD scan, the evaluation scores what the
    training runtime trained, the MoE training path follows the MoE
    DiT's, the LM serving path runs after the DiT's and the MoE's kernel
    shapes, the partitioned dense, decode and MoE paths after the LM's,
    then the encoder-decoder and the examples, then the card check of the
    meta
    route while the dry runs (started just before it, after every phase
    that times the host) run on the CPU, then the dry runs' checks."""
    import inspect
    import re
    cs = _chip_smoke()
    calls = re.findall(r"\b(phase_\w+)\(", inspect.getsource(cs.main))
    assert calls == ["phase_build", "phase_keyed", "phase_kernels",
                     "phase_flash_ssd", "phase_mamba_mixer", "phase_unet",
                     "phase_main_path",
                     "phase_contracts", "phase_train", "phase_train_runtime",
                     "phase_clients_mesh", "phase_eval", "phase_dit",
                     "phase_grouped_matmul", "phase_moe", "phase_moe_train",
                     "phase_lm_serve", "phase_lm_train",
                     "phase_dense_partition", "phase_decode_partition",
                     "phase_moe_partition", "phase_whisper",
                     "phase_examples", "phase_meta_check", "phase_dryrun"]
    assert cs.PATHS == ("serve", "train", "train_runtime", "eval", "dit",
                        "moe", "moe_train", "lm_serve", "lm_train",
                        "whisper_serve", "whisper_train", "examples",
                        "clients_mesh", "dense_partition",
                        "decode_partition", "moe_partition")
    assert "partition_meta_check()" in inspect.getsource(cs.phase_meta_check)
    src = inspect.getsource(cs.main)
    assert src.index("phase_examples()") < src.index("start_dryrun()") \
        < src.index("phase_meta_check()") < src.index("stop_dryrun(") \
        < src.index("phase_dryrun(")
    for name in calls:
        assert callable(getattr(cs, name))


def test_kernels_line_carries_the_new_paths_and_lm_shapes():
    """``launches_by_path`` has an entry for every path of PATHS (eval,
    lm_serve, lm_train, whisper's two, the examples and the partitioned
    dense, decode and MoE paths included); flash
    and the SSD
    scan carry their numbers at the LM prefill's shapes, flash and its
    backward theirs at whisper's encoder and decoder shapes."""
    cs = _chip_smoke()
    names = list(cs.KERNELS)
    records = {n: dict(max_abs_err=0.0, ms=1.0, plain_ms=2.0, bound_ms=0.5,
                       bound_by="bytes", library_ms=None) for n in names}
    lm = {"flash_attention": dict(shape=[4, 32, 512, 64], ms=0.03,
                                  library_ms=0.04, card_ms=0.02),
          "ssd_scan": dict(shape=[4, 512, 64, 64], chunk=256, ms=0.05,
                           library_ms=None, card_ms=0.04)}
    for n, r in lm.items():
        records[n]["lm_prefill"] = r
    per = {"serve": {"ddpm_step": 1000}, "train": {"ddpm_step": 1000},
           "train_runtime": {"ddpm_step": 1000},
           "eval": {"ddpm_step": 1250}, "dit": {"flash_attention": 6},
           "moe": {"grouped_matmul": 6, "grouped_matmul_bwd": 6},
           "moe_train": {"grouped_matmul": 132, "grouped_matmul_bwd": 132,
                         "flash_attention": 44},
           "lm_serve": {"flash_attention": 6, "ssd_scan": 38},
           "lm_train": {"flash_attention": 120, "flash_attention_bwd": 120,
                        "ssd_scan": 760, "ssd_scan_bwd": 760},
           "whisper_serve": {"flash_attention": 12},
           "whisper_train": {"flash_attention": 240,
                             "flash_attention_bwd": 240},
           "examples": {"ddpm_step": 150, "ssd_scan": 80,
                        "ssd_scan_bwd": 40, "flash_attention": 90,
                        "flash_attention_bwd": 60},
           "clients_mesh": {"ddpm_step": 200, "ddpm_step_batched": 200},
           "dense_partition": {"flash_attention": 18,
                               "flash_attention_bwd": 12, "ssd_scan": 114,
                               "ssd_scan_bwd": 76},
           "decode_partition": {"flash_attention": 6, "ssd_scan": 38},
           "moe_partition": {"grouped_matmul": 60, "grouped_matmul_bwd": 6,
                             "flash_attention": 4,
                             "flash_attention_bwd": 2}}
    enc = dict(shape=[4, 8, 1500, 64], causal=False, ms=0.05)
    bwd = dict(shape=[8, 8, 1500, 64], causal=False, ms=0.3, simt_ms=9.0)
    records["flash_attention"]["whisper_encoder"] = enc
    records["flash_attention_bwd"]["whisper_encoder"] = bwd
    by_path = dict(zip(cs.PATHS, (per[p] for p in cs.PATHS)))
    launches = {n: sum(p.get(n, 0) for p in by_path.values())
                for n in names}
    line = cs.kernels_line(records, launches, by_path)["kernels"]
    for k in line:
        assert list(k["launches_by_path"]) == list(cs.PATHS)
    assert line[1]["launches_by_path"]["eval"] == 1250
    assert line[0]["launches_by_path"]["clients_mesh"] == 200
    assert line[1]["launches_by_path"]["clients_mesh"] == 200
    assert line[2]["launches_by_path"]["clients_mesh"] == 0
    assert line[2]["launches_by_path"]["lm_serve"] == 6
    assert line[3]["launches_by_path"]["examples"] == 80
    assert line[3]["launches_by_path"]["lm_serve"] == 38
    assert line[5]["launches_by_path"]["lm_train"] == 120
    assert line[6]["launches_by_path"]["lm_train"] == 760
    assert line[6]["launches_by_path"]["lm_serve"] == 0
    assert line[2]["lm_prefill"] == lm["flash_attention"]
    assert line[3]["lm_prefill"] == lm["ssd_scan"]
    assert "lm_prefill" not in line[0]
    assert line[2]["launches_by_path"]["whisper_serve"] == 12
    assert line[7]["name"] == "grouped_matmul_bwd"
    assert line[7]["launches_by_path"]["moe_train"] == 132
    assert line[7]["launches_by_path"]["moe"] == 6
    assert line[7]["launches_by_path"]["lm_train"] == 0
    assert line[2]["launches_by_path"]["dense_partition"] == 18
    assert line[6]["launches_by_path"]["dense_partition"] == 76
    assert line[0]["launches_by_path"]["dense_partition"] == 0
    assert line[3]["launches_by_path"]["decode_partition"] == 38
    assert line[7]["launches_by_path"]["moe_partition"] == 6
    assert line[3]["launches_by_path"]["moe_partition"] == 0
    assert line[5]["launches_by_path"]["whisper_train"] == 240
    assert line[3]["launches_by_path"]["whisper_train"] == 0
    assert line[2]["whisper_encoder"] == enc
    assert line[5]["whisper_encoder"] == bwd
    assert "whisper_encoder" not in line[3]


def test_clients_mesh_phase_configuration_and_reckoning():
    """The clients-mesh phase: two rounds, three requests, bytes reckoned
    for 2, 4 and 8 ranks (a ring all-reduce moves 2(W-1)/W of its buffer
    through each rank, a broadcast or all-gather the (W-1)/W a rank does
    not own); it runs on the runtime phase's configuration and tears
    down the process group it makes."""
    import inspect
    cs = _chip_smoke()
    assert (cs.CM_ROUNDS, cs.CM_REQUESTS, cs.CM_WORLDS) == (2, 3, (2, 4, 8))
    assert (cs.CM_SAMPLE_T, cs.CM_SAMPLE_CUT) == (100, 25)
    got = cs.collective_reckoning(
        {"all_reduce": 1000, "broadcast": 800, "all_gather": 64})
    assert list(got) == [2, 4, 8]
    for w, v in got.items():
        want = 2 * (w - 1) / w * 1000 + (w - 1) / w * 864
        assert v["bytes"] == pytest.approx(want)
        assert v["bound_ms"] == pytest.approx(1e3 * want / cs.card.NVLINK_BW)
    assert got[8]["bytes"] > got[2]["bytes"]
    src = inspect.getsource(cs.phase_clients_mesh)
    for name in ("make_client_mesh", "shard_sample_plan", "mesh=m",
                 "assert_runtime_bitwise", "destroy_process_group",
                 "check_ddpm_launches", '"bfloat16"', "reset_counts",
                 "COMM_BYTES", "collective_reckoning", "RT_SEED", "RT_P",
                 "RT_DROP", "RT_FEDAVG", "RT_EMA", "TRAIN_CUT"):
        assert name in src, name


def test_whisper_phase_configuration():
    """whisper-base at its published widths and depth; 1,500 frames, a
    23-tile K/V sweep with a 28-row tail; decoder prompts below, at and
    past the 448-slot cache; 8 x 1,500 frames to train; 2 + 2 layers on
    the CPU."""
    from repro_torch.configs.base import get_arch
    cs = _chip_smoke()
    cfg = get_arch(cs.WHISPER_ARCH)
    assert (cfg.n_encoder_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.head_dim_, cfg.d_ff, cfg.vocab_size, cfg.max_decoder_len,
            cfg.dtype) == (6, 6, 512, 8, 64, 2048, 51_865, 448, "bfloat16")
    assert cs.WHISPER_FRAMES == 1500 and divmod(1500, 64) == (23, 28)
    assert (cs.WHISPER_BATCH, cs.WHISPER_NEW) == (4, 32)
    lo, at, past = cs.WHISPER_PROMPTS
    assert lo < cfg.max_decoder_len == at < past
    assert (cs.WHISPER_TRAIN_STEPS, cs.WHISPER_TRAIN_BATCH,
            cs.WHISPER_TRAIN_SEQ) == (20, 8, 1500)
    enc, dec = cs.WHISPER_FLASH_BWD
    assert enc == ((8, 8, 8, 1500, 64), False)
    assert dec == ((8, 8, 8, cfg.max_decoder_len, 64), True)
    assert cs.WHISPER_CPU_LAYERS == 2 and cs.WHISPER_GRAD_SEQ % 64


def test_flash_tally_counts_by_causal_flag():
    cs = _chip_smoke()
    calls = []
    fake = SimpleNamespace(
        launch=lambda q, k, v, causal, window=0, lse=None: calls.append(
            ("f", causal)) or "out",
        launch_backward=lambda q, k, v, o, do, lse, causal, window, **kw:
            calls.append(("b", causal)) or "grads")
    orig = fake.launch, fake.launch_backward
    with cs.flash_tally(fake) as tally:
        assert fake.launch(1, 2, 3, False, 0) == "out"
        assert fake.launch(1, 2, 3, True, 0, lse=4) == "out"
        assert fake.launch_backward(1, 2, 3, 4, 5, 6, True, 0) == "grads"
        assert tally == {"fwd": {True: 1, False: 1},
                         "bwd": {True: 1, False: 0}}
        with pytest.raises(AssertionError, match="by causal flag"):
            cs.check_tally("t", tally, 1, 1)
        fake.launch_backward(1, 2, 3, 4, 5, 6, False, 0)
        cs.check_tally("t", tally, 1, 1)
    assert (fake.launch, fake.launch_backward) == orig
    assert calls == [("f", False), ("f", True), ("b", True), ("b", False)]


def test_repeat_step_bitwise_on_the_cpu():
    """The bitwise-repeat check on a reduced whisper's step on the CPU
    (deterministic there), and a step that is not repeatable fails it."""
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.core import prng
    from repro_torch.launch import shapes, train
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    cs = _chip_smoke()
    cfg = reduced(get_arch("whisper-base"))
    params = api.init_params(prng.PRNGKey(0), cfg, "cpu")
    opt = init_opt_state(params)
    step = shapes.make_train_step(cfg, AdamWConfig(lr=1e-3))
    batch = train.build_batch(prng.PRNGKey(1), cfg, 2, 20)
    loss, gnorm = cs.repeat_step_bitwise("t", step, params, opt, batch)
    assert np.isfinite(loss) and np.isfinite(gnorm)
    assert int(opt["step"]) == 1
    drift = iter(range(10))

    def noisy(p, o, b):
        out = step(p, o, b)
        with torch.no_grad():
            next(iter(p.parameters())).add_(next(drift) * 1e-3)
        return out
    with pytest.raises(AssertionError, match="repeated step differs"):
        cs.repeat_step_bitwise("t", noisy, params, opt, batch)


def test_eval_and_lm_phase_configuration():
    """The evaluation scores N_EVAL = 96 samples (the privacy frontier's),
    intermediates at t 0 / 250 / 500, the inversion at 250; the LM phase
    runs Zamba2-1.2B with prompts of 512 (two SSD chunks of 256) and 333
    tokens (a ragged tail) at batch 4, and a 7-layer CPU model (one shared
    group of 6 and a tail layer)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models.hybrid import _grouping
    cs = _chip_smoke()
    assert (cs.EVAL_N, cs.EVAL_TS, cs.EVAL_INV_T, cs.EVAL_SHORT_STEPS) == \
        (96, (0, 250, 500), 250, 20)
    cfg = get_arch(cs.LM_ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.ssm_n_heads, cfg.ssm_head_dim,
            cfg.ssm_state, cfg.vocab_size, cfg.dtype) == \
        (38, 2048, 64, 64, 64, 32_000, "bfloat16")
    assert (cs.LM_BATCH, cs.LM_PROMPTS, cs.LM_NEW) == (4, (512, 333), 32)
    assert cfg.ssm_chunk == 256 and 512 // cfg.ssm_chunk == 2
    assert 333 % cfg.ssm_chunk and 333 % 64
    g, G, r = _grouping(cfg)
    assert (g, G, r) == (6, 6, 2)
    small = dataclasses.replace(cfg, n_layers=cs.LM_CPU_LAYERS)
    assert _grouping(small) == (6, 1, 1)


def test_lm_helpers():
    cs = _chip_smoke()
    a = torch.tensor([[0.5, 3.0]], dtype=torch.bfloat16)
    assert cs.lm_gap(a, a) == 0.0
    assert cs.lm_gap(torch.tensor([0.1]), torch.tensor([0.3])) == \
        pytest.approx(0.2)
    assert cs.lm_gap(torch.tensor([4.0]), torch.tensor([2.0])) == 1.0
    per = {"flash_attention": 6, "ssd_scan": 38}
    cs.check_lm_launches("t", {"flash_attention": 12, "ssd_scan": 76}, per, 2)
    cs.check_lm_launches("t", {"flash_attention": 0, "ssd_scan": 0}, per, 0)
    with pytest.raises(AssertionError, match="kernel launches"):
        cs.check_lm_launches("t", {"flash_attention": 1, "ssd_scan": 0}, per,
                             0)


def test_eval_path_on_the_cpu():
    """The evaluation path with a toy denoiser at T = 1000, cut 250, on
    8x8 images of 16 a client: samples and handoff of the right shapes,
    finite FD, F1 and inversion metrics, and the same numbers again."""
    from repro_torch.core import prng
    from repro_torch.core.schedules import DiffusionSchedule
    from repro_torch.core.splitting import CutPoint
    from repro_torch.data.synthetic import (SyntheticConfig,
                                            make_client_datasets)
    cs = _chip_smoke()

    def toy(p, x, t, y):
        return x * p["a"]

    trained = dict(server={"a": torch.tensor(0.3)},
                   clients=[{"a": torch.tensor(0.1)},
                            {"a": torch.tensor(0.2)}],
                   sched=DiffusionSchedule.linear(1000, device="cpu"),
                   cut=CutPoint(1000, 250), apply_fn=toy)
    data = make_client_datasets(prng.PRNGKey(1), SyntheticConfig(
        image_size=8), 2, 16, device="cpu")
    out = cs.eval_scores(trained, data, prng.PRNGKey(19), n=16)
    assert out["samples"].shape == (2, 16, 8, 8, 3)
    assert out["handoff"].shape == (16, 8, 8, 3)
    assert set(out["fd"]) == {"client0/samples", "client0/handoff",
                              "client1/samples", "client1/handoff"}
    assert set(out["f1"]) == set(cs.EVAL_TS)
    assert torch.equal(out["inter"][1, 0], data[1][0])
    assert not torch.equal(out["inter"][1, 250], data[1][0])
    assert set(out["inversion"]) == {"mse_own", "mse_cross", "fd_own",
                                     "fd_cross"}
    again = cs.eval_scores(trained, data, prng.PRNGKey(19), n=16)
    assert again["fd"] == out["fd"] and again["inversion"] == \
        out["inversion"]
    for t in cs.EVAL_TS:
        assert torch.equal(again["f1"][t], out["f1"][t])


def test_backward_bounds_and_the_lm_train_helpers():
    """The backward kernels' bounds at the LM training step's shapes:
    flash's binds on its five products over the kept pairs, the SSD
    scan's on its bytes; ``no_bwd`` and ``grad_gaps``."""
    cs = _chip_smoke()
    q = torch.empty(4, 32, 1024, 64, dtype=torch.bfloat16, device="meta")
    keep = 1024 * 1025 // 2
    assert cs.fa_cost.keep_count(1024, True, 8192) == keep
    assert cs.fa_cost.keep_count(10, False, 3) == sum(
        1 for i in range(10) for j in range(10) if i - j < 3)
    assert cs.fa_cost.keep_count(10, True, 3) == sum(
        1 for i in range(10) for j in range(10) if 0 <= i - j < 3)
    ms, by = cs.flash_bwd_bound(q, q, True, 8192)
    assert by == "operations"
    assert ms == 10 * 4 * 32 * 64 * keep / cs.BF16_FLOPS_PER_S * 1e3
    assert (8 * q.numel() * 2 + 4 * 32 * 1024 * 4) / cs.HBM_BYTES_PER_S * \
        1e3 < ms
    x = torch.empty(4, 1024, 64, 64, dtype=torch.bfloat16, device="meta")
    Bm = torch.empty(4, 1024, 64, dtype=torch.bfloat16, device="meta")
    ms, by = cs.ssd_bwd_bound(x, Bm, 256)
    nbytes = (3 * x.numel() + 4 * Bm.numel()) * 2 + 2 * 4 * 1024 * 64 * 4 + \
        2 * 64 * 4
    assert by == "bytes" and ms == nbytes / cs.HBM_BYTES_PER_S * 1e3
    assert cs.no_bwd("flash_attention") == {"flash_attention_bwd": 0,
                                            "flash_attention_bwd/wgmma": 0,
                                            "flash_attention_bwd/simt": 0}
    gaps = cs.grad_gaps({"a": torch.ones(4), "b": torch.zeros(2)},
                        {"a": 2 * torch.ones(4), "b": torch.ones(2)})
    assert gaps == {"a": 0.5, "b": 1.0}
    assert (cs.LM_TRAIN_STEPS, cs.LM_TRAIN_BATCH, cs.LM_TRAIN_SEQ) == \
        (20, 4, 1024)
    assert cs.FLASH_BWD_PATH == ((4, 32, 32, 1024, 64), True, 8192)
    assert cs.SSD_BWD_PATH == (4, 1024, 64, 64, 64, 256)


def _bf16_pair(g32: torch.Tensor, seed: int):
    """(kernel, plain) for a float32 gradient: the plain version rounds it
    to bf16 once; a sound kernel sums in another order (a relative 1e-6
    each) and rounds once too."""
    rng = np.random.default_rng(seed)
    noise = torch.from_numpy(rng.standard_normal(g32.shape).astype(
        np.float32))
    return (g32 * (1 + 1e-6 * noise)).bfloat16(), g32.bfloat16()


def _flash_grads():
    """(kernel, plain) gradients of a causal bf16 attention at S 256,
    where the first keys' gradients dwarf the later ones'."""
    from repro_torch.kernels.flash_attention.ref import (
        attention_lse, attention_ref, flash_attention_bwd_ref)
    rng = np.random.default_rng(0)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).bfloat16().float()
    q, k, v, dout = r(1, 2, 256, 16), r(1, 2, 256, 16), r(1, 2, 256, 16), \
        r(1, 2, 256, 16)
    out = attention_ref(q.bfloat16(), k.bfloat16(), v.bfloat16()).float()
    g32 = flash_attention_bwd_ref(q, k, v, out, dout,
                                  attention_lse(q, k), True, 0)
    pairs = [_bf16_pair(g, i) for i, g in enumerate(g32)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _ssd_grads(chunk=32, h=4):
    """(kernel, plain) gradients of a bf16 SSD scan over 4 chunks; dx, dB
    and dC round to bf16, ddt and dA stay float32."""
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd_ref
    rng = np.random.default_rng(1)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    bf = lambda t: t.bfloat16().float()
    x, B, C, dy = bf(r(1, 4 * chunk, h, 16)), bf(r(1, 4 * chunk, 8)), \
        bf(r(1, 4 * chunk, 8)), bf(r(1, 4 * chunk, h, 16))
    dt = torch.nn.functional.softplus(r(1, 4 * chunk, h) - 1)
    A = -torch.exp(r(h))
    g32 = ssd_chunked_bwd_ref(x, dt, A, B, C, chunk, dy)
    kern, plain = [], []
    for i, g in enumerate(g32):
        if i in (1, 2):
            kern.append(g * (1 + 1e-6 * torch.from_numpy(
                rng.standard_normal(g.shape).astype(np.float32))))
            plain.append(g)
        else:
            a, b = _bf16_pair(g, 10 + i)
            kern.append(a)
            plain.append(b)
    return kern, plain


@pytest.mark.parametrize("case", ["flash", "ssd"])
def test_row_gap_holds_a_sound_bf16_kernel_within_its_limit(case):
    """A kernel that sums in another order and rounds once reads below
    BWD_BF16_ROW in every gradient: a value is at most one bf16 ulp (2^-7
    of it) from the plain one."""
    cs = _chip_smoke()
    kern, plain = _flash_grads() if case == "flash" else _ssd_grads()
    gaps = [cs.row_gap(a, b) for a, b in zip(kern, plain)]
    assert max(gaps) <= 2 ** -7 < cs.BWD_BF16_ROW
    assert max(gaps) > 0            # the rounding shows


@pytest.mark.parametrize("case,fault", [
    ("flash", f) for f in ("dk past the first K/V tile",
                           "dv past the first K/V tile",
                           "dq from the next head")] + [
    ("ssd", f) for f in ("dx past the first chunk", "ddt from the next head",
                         "dA past the first head", "dB past the first chunk",
                         "dC past the first chunk")])
def test_each_planted_fault_reads_beyond_the_row_limit(case, fault):
    """chip_smoke's planted faults fail the row check; flash's scaled
    faults read by each gradient's range (max |k − r| / max(1, max |r|),
    the check this one replaced, at the same limit) pass it: the first
    keys' gradients set that scale."""
    cs = _chip_smoke()
    if case == "flash":
        kern, plain = _flash_grads()
        faults = cs.flash_faults()
    else:
        kern, plain = _ssd_grads()
        faults = cs.ssd_faults(32)
    gaps = cs.fault_gaps(kern, plain, {fault: faults[fault]})
    assert gaps[fault] > cs.BWD_BF16_ROW
    cs.check_faults(fault, gaps, cs.BWD_BF16_ROW)
    i, fn = faults[fault]
    if "past" in fault and case == "flash":
        assert cs.lm_gap(fn(kern[i].float()), plain[i]) < cs.BWD_BF16_ROW


def test_row_gap_floors_rows_that_are_zero_in_exact_arithmetic():
    """Causal dq's first row is zero but for rounding: it reads against
    ROW_FLOOR of the median row's norm, not against its own."""
    cs = _chip_smoke()
    b = torch.ones(8, 4)
    b[0] = 0.0
    a = b.clone()
    a[0] = 1e-7
    assert cs.row_gap(a, b) == pytest.approx(2e-7 / (cs.ROW_FLOOR * 2),
                                             rel=1e-4)
    assert cs.row_gap(b, b) == 0.0
    assert cs.row_gap(torch.tensor([1.0, 2.04]), torch.tensor([1.0, 2.0])) \
        == pytest.approx(0.02, rel=1e-5)     # a vector: each element a row


def test_check_faults_raises_where_a_fault_reads_within_the_limit():
    cs = _chip_smoke()
    cs.check_faults("x", {"a": 0.5, "b": 0.02}, 1e-2)
    with pytest.raises(AssertionError, match="cannot fail"):
        cs.check_faults("x", {"a": 0.5, "b": 0.005}, 1e-2)
    g = torch.ones(2, 5, 3)
    assert torch.equal(cs.scaled_past(1, 2)(g)[:, :2], g[:, :2])
    assert torch.equal(cs.scaled_past(1, 2)(g)[:, 2:],
                       torch.full((2, 3, 3), 1 + cs.FAULT))


@pytest.mark.parametrize("what,C,broadcast", [
    ("dense DiT", 256, True), ("EP DiT", 80, False), ("EP LM", 1280, False),
    ("dense LM", 4096, True)])
def test_gmm_bwd_bound_counts_both_products(what, C, broadcast):
    """The backward's bound at DBRX's expert shapes: the tokens, weights
    and dout read once, dtokens (one (C, D) sum when broadcast) and
    dweights written once, 4·E·C·D·F flops; bytes bind below the ridge
    (C 256, 80), operations above it (C 1,280, 4,096), in float32
    operations at every C."""
    cs = _chip_smoke()
    E, D, F = 16, 6144, 10752
    tok = (1 if broadcast else E) * C * D
    nbytes, flops = cs.gmm_cost.cost_backward(E, C, D, F, 2, broadcast)
    assert nbytes == 2 * (2 * tok + 2 * E * D * F + E * C * F)
    assert flops == 4 * E * C * D * F
    ms, by = cs.gmm_bwd_bound(E, C, D, F, 2, broadcast)
    assert by == ("bytes" if C <= 256 else "operations")
    assert ms == max(nbytes / cs.HBM_BYTES_PER_S,
                     flops / cs.BF16_FLOPS_PER_S) * 1e3
    assert cs.gmm_bwd_bound(E, C, D, F, 4, broadcast)[1] == "operations"
    assert (what, C, broadcast) in cs.GMM_BWD_CASES


def test_moe_train_configuration_follows_the_paths_capacities():
    """GMM_BWD_CASES holds the C each path feeds the backward: the DiT's
    B x 64 tokens and the LM's B x S dense, and ``moe._capacity`` of
    those token counts at DBRX's configured capacity factor for the
    expert-parallel paths; the phase runs the DBRX shapes of the
    published config, cut in depth only."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import moe
    cs = _chip_smoke()
    arch = get_arch(cs.MOE_ARCH)
    dit_tokens = cs.B * (cs.IMG[0] // 4) ** 2
    lm_tokens = cs.MOE_TRAIN_BATCH * cs.MOE_TRAIN_SEQ
    assert dict((w, (c, b)) for w, c, b in cs.GMM_BWD_CASES) == {
        "dense DiT": (dit_tokens, True),
        "EP DiT": (moe._capacity(arch, dit_tokens), False),
        "EP LM": (moe._capacity(arch, lm_tokens), False),
        "dense LM": (lm_tokens, True)}
    assert [c for _, c, _ in cs.GMM_BWD_CASES] == [256, 80, 1280, 4096]
    assert (arch.d_model, arch.n_heads, arch.n_kv_heads, arch.head_dim_,
            arch.n_experts, arch.d_ff, arch.top_k, arch.capacity_factor,
            arch.vocab_size) == (6144, 48, 8, 128, 16, 10752, 4, 1.25,
                                 100352)
    assert cs.FLASH_BWD_DBRX == ((4, 48, 8, 1024, 128), True)
    assert cs.MOE_EP_TOKENS == 256 and cs.MOE_EP_ROOMY == 8.0
    assert moe._capacity(dataclasses.replace(arch, capacity_factor=8.0),
                         256) == 512
    assert {(2, 80, 256, 192), (2, 1280, 64, 128), (1, 4096, 64, 64)} <= \
        set(cs.GMM_WGMMA)


def test_moe_phase_trains_and_refuses_nothing():
    """Phase 13 trains where it refused: no refusal check is left in the
    script, and the phase runs the runtime round and the gradient check."""
    import inspect
    cs = _chip_smoke()
    src = (ROOT / "chip_smoke.py").read_text()
    assert "refuse_" not in src and "no backward" not in src
    body = inspect.getsource(cs.phase_moe)
    assert "moe_runtime_round(" in body and "moe_dit_grad_check(" in body
    train = inspect.getsource(cs.phase_moe_train)
    for call in ("gmm_bwd_checks(", "moe_ep_checks(", "moe_flash_bwd(",
                 "make_debug_mesh(", "destroy_process_group("):
        assert call in train


def test_with_backward_and_no_bwd_name_each_variant():
    cs = _chip_smoke()
    per = {"grouped_matmul": 6, "flash_attention": 2}
    want = cs.with_backward(per, "grouped_matmul", "flash_attention")
    assert want == {**per, "grouped_matmul_bwd": 6,
                    "grouped_matmul_bwd/wgmma": 6,
                    "grouped_matmul_bwd/wmma": 0,
                    "grouped_matmul_bwd/simt": 0, "flash_attention_bwd": 2,
                    "flash_attention_bwd/wgmma": 2,
                    "flash_attention_bwd/simt": 0}
    assert cs.with_backward(per, "grouped_matmul", variant="simt") == {
        **per, "grouped_matmul_bwd": 6, "grouped_matmul_bwd/wgmma": 0,
        "grouped_matmul_bwd/wmma": 0, "grouped_matmul_bwd/simt": 6}
    assert cs.no_bwd("grouped_matmul") == {"grouped_matmul_bwd": 0,
                                           "grouped_matmul_bwd/wgmma": 0,
                                           "grouped_matmul_bwd/wmma": 0,
                                           "grouped_matmul_bwd/simt": 0}


def test_gmm_bwd_cases_reach_the_variants_they_must():
    """Built as ``gmm_bwd_case`` builds them (meta tensors at DBRX's
    expert shapes: the choice reads shapes, strides and pointers alone),
    every bf16 case of GMM_BWD_CASES reaches ``wgmma``; the
    GMM_BWD_MISALIGNED case, one element past a 16-byte boundary,
    ``wmma``; float32 ``simt``."""
    cs = _chip_smoke()
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.grouped_matmul import kernel as gkernel
    arch = get_arch(cs.MOE_ARCH)
    E, D, F = arch.n_experts, arch.d_model, arch.d_ff
    for dtype, want in ((torch.bfloat16, "wgmma"), (torch.float32, "simt")):
        for _, C, broadcast in cs.GMM_BWD_CASES:
            meta = lambda *shape: torch.empty(shape, dtype=dtype,
                                              device="meta")
            tok = meta(C, D).unsqueeze(0).expand(E, -1, -1) if broadcast \
                else meta(E, C, D)
            assert gkernel.choose_variant_backward(
                tok, meta(E, D, F), meta(E, C, F), meta(E, C, D),
                meta(E, D, F)) == want
    mE, mC, mD, mF = cs.GMM_BWD_MISALIGNED
    tok = torch.zeros(mE, mC, mD, dtype=torch.bfloat16)
    tok = torch.cat([tok.new_zeros(1), tok.flatten()])[1:].view(mE, mC, mD)
    assert tok.data_ptr() % 16 and mD % 8 == 0 and mF % 8 == 0
    assert gkernel.choose_variant_backward(
        tok, torch.zeros(mE, mD, mF, dtype=torch.bfloat16),
        torch.zeros(mE, mC, mF, dtype=torch.bfloat16)) == "wmma"
    assert cs.GMM_BWD_HALF_FROM_C == 1280


def test_reduced_moe_round_keeps_only_the_norm_scales_on_the_cpu():
    """The round ``moe_runtime_round`` runs on the card (reduced DBRX-132B
    DiTs in bf16, one client, one batch), here on the CPU port: the
    leaves that keep their bits are exactly the RMSNorm scales, each
    with a nonzero first moment (its gradient reached it), because
    AdamW's first step of about the learning rate is under half a bf16
    ulp at 1.0 (2^-9 below it)."""
    import dataclasses
    cs = _chip_smoke()
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.core import prng
    from repro_torch.core.dit import DiTConfig, init_dit, make_dit_apply
    from repro_torch.train import (ParticipationConfig, TrainConfig,
                                   TrainRuntime)
    dcfg = DiTConfig(image_size=cs.IMG[0], channels=cs.IMG[2], patch_size=4,
                     n_classes=8)
    small = dataclasses.replace(reduced(get_arch(cs.MOE_ARCH)),
                                dtype="bfloat16")
    cfg = TrainConfig(T=1000, t_cut=250, image_shape=cs.IMG,
                      n_classes=dcfg.n_classes, batch_size=cs.B,
                      batches_per_round=1,
                      participation=ParticipationConfig(policy="full"))
    rt = TrainRuntime(cfg, lambda k: init_dit(k, small, dcfg, "cpu"),
                      make_dit_apply(small, dcfg), prng.PRNGKey(0),
                      device="cpu")
    gen = torch.Generator().manual_seed(5)
    rt.register_client(torch.randn((cs.B,) + cs.IMG, generator=gen),
                       torch.eye(8)[torch.arange(cs.B) % 8])
    before = {n: p.detach().clone()
              for n, p in rt.server_params.named_parameters()}
    rt.run_round()
    still = sorted(n for n, p in rt.server_params.named_parameters()
                   if torch.equal(p, before[n]))
    assert still == sorted(n for n in before if n.endswith(".scale"))
    assert len(still) == 5 and len(before) == 27
    assert all(rt.server_opt["m"][n].abs().max() > 0 for n in still)
    assert all(torch.all(before[n] == 1) for n in still)
    assert cfg.lr < 2 ** -9


def _gmm_grads():
    """(kernel, plain) gradients of a bf16 grouped matmul over 80 token
    rows and D 96 (past the faults' first 64 rows)."""
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_bwd_ref
    rng = np.random.default_rng(2)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).bfloat16().float()
    g32 = grouped_matmul_bwd_ref(r(3, 80, 96), r(3, 96, 40), r(3, 80, 40))
    pairs = [_bf16_pair(g, 20 + i) for i, g in enumerate(g32)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def test_gmm_bwd_row_check_and_its_planted_faults():
    """A sound bf16 backward reads within BWD_BF16_ROW; each of
    ``gmm_faults`` beyond it."""
    cs = _chip_smoke()
    kern, plain = _gmm_grads()
    gaps = [cs.row_gap(a, b) for a, b in zip(kern, plain)]
    assert 0 < max(gaps) <= 2 ** -7 < cs.BWD_BF16_ROW
    faults = cs.fault_gaps(kern, plain, cs.gmm_faults())
    assert set(faults) == {"dX past the first 64 rows",
                           "dW past the first 64 rows",
                           "dX from the next expert"}
    cs.check_faults("gmm", faults, cs.BWD_BF16_ROW)


def test_plain_expert_products_give_autograds_gradients():
    """On the CPU the MoE's products are the plain version under
    autograd; ``plain_expert_products`` (its forward and backward plain
    versions as one Function) gives the same output and gradients, and
    restores the op after."""
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.core import prng
    from repro_torch.models import moe
    cs = _chip_smoke()
    cfg = reduced(get_arch("dbrx-132b"))
    m = moe.moe_init(prng.PRNGKey(1), cfg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    orig = moe.gmm_ops.grouped_matmul
    y, _ = moe.moe_dense(m, x, cfg)
    g = torch.autograd.grad(y.square().sum(), list(m.parameters()))
    with cs.plain_expert_products():
        assert moe.gmm_ops.grouped_matmul is not orig
        y2, _ = moe.moe_dense(m, x, cfg)
        g2 = torch.autograd.grad(y2.square().sum(), list(m.parameters()))
    assert moe.gmm_ops.grouped_matmul is orig
    assert torch.equal(y, y2)
    for a, b in zip(g, g2):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
