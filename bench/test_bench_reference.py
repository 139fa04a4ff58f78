"""CPU tests that hold the benchmark's plain reference against the port at
a tiny size, and that a run whose timed path is broken underneath, or
whose control takes the program's place, comes out not correct.

The harness's look for a chip is skipped: the loops run on the CPU at
a few images of 8×8 and T = 8.  The limits are the cells' own
(``bench/limits``)."""
import json
import time
from pathlib import Path

import pytest
import torch

from bench import spec
from bench.loops import serve
from bench.models import unet as fam
from bench.reference import unet as ref_unet

BENCH = Path(__file__).resolve().parent
CPU = torch.device("cpu")
SEED = 2 ** 31 + 4321
TINY = {"model_code": "unet", "image_size": 8, "channels": 3, "base_width": 8,
        "width_mults": [1, 2], "n_res_blocks": 1, "attn_resolutions": [4],
        "n_heads": 2, "time_dim": 16, "n_classes": 8, "groupnorm_groups": 4,
        "dropout": 0.0, "dtype": "float32", "T": 8, "check_rows": 2}


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny models run fastest on one CPU thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell(workload: str, **mix_over):
    bench = spec.load_benchmark(BENCH.parent)
    real = spec.Cell.load(bench, workload, BENCH.parent)
    mix = dict(real.mix, **mix_over)
    return spec.Cell(workload, dict(TINY), mix, real.limits,
                     bench["end_to_end"], bench["per_layer"])


def _serve_cell():
    return _cell("unet-serve-shared", images=4,
                 cut_fractions=[0.25, 0.5], cycle_requests=2)


def _correct(out, cell):
    return all(v <= cell.limits[n] for n, v in out["compared"].items())


def test_reference_unet_is_the_program_s():
    w = fam.make_weights(TINY, SEED, 1, CPU)
    model = fam.build_program(TINY, w, CPU)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 8, 8, 3), generator=g)
    t = torch.tensor([1.0, 4.5, 8.0])
    y = (torch.rand((3, 8), generator=g) < 0.5).float()
    with torch.no_grad():
        got = fam.apply_fn()(model, x, t, y)
    want = ref_unet.forward(w, TINY, x, t, y)
    assert torch.allclose(got, want, rtol=0, atol=1e-6)
    assert float(want.abs().mean()) > 0.1      # every layer shapes ε̂


DIT = {"model_code": "zamba2_dit", "name": "tiny", "family": "hybrid",
       "n_layers": 5,
       "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
       "vocab_size": 32, "head_dim": 16, "rope_theta": 10000.0,
       "rope_fraction": 1.0, "sliding_window": 0, "mlp_type": "swiglu",
       "ssm_state": 16, "ssm_head_dim": 16, "ssm_expand": 2,
       "ssm_conv_kernel": 4, "ssm_chunk": 256, "shared_attn_every": 2,
       "dtype": "float32", "norm_eps": 1e-5, "image_size": 16,
       "channels": 3, "patch_size": 4, "n_classes": 8, "T": 8,
       "check_rows": 2}


def test_reference_dit_is_the_program_s():
    """Mamba2 mixers, the shared attention block (4 heads over 2 K/V
    heads) and the patch maps, in float32 on the CPU; the float8 control
    is far off."""
    from bench.models import zamba2_dit as dit
    from bench.reference import zamba2_dit as ref_dit
    w = dit.make_weights(DIT, SEED, 2, CPU)
    model = dit.build_program(DIT, w, CPU)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((3, 16, 16, 3), generator=g)
    t = torch.tensor([1.0, 3.5, 8.0])
    y = (torch.rand((3, 8), generator=g) < 0.5).float()
    with torch.no_grad():
        got = dit.apply_fn()(model, x, t, y)
    want = ref_dit.forward(w, DIT, x, t, y)
    assert torch.allclose(got, want, rtol=0, atol=2e-5)
    low = ref_dit.forward(w, DIT, x, t, y, "fp8")
    assert (low - want).abs().max() > 100 * (got - want).abs().max()


def test_dit_serve_run_is_correct():
    bench = spec.load_benchmark(BENCH.parent)
    real = spec.Cell.load(bench, "zamba2-dit-serve-shared", BENCH.parent)
    cell = spec.Cell(real.name, dict(DIT),
                     dict(real.mix, images=2, cut_fractions=[0.25, 0.5],
                          cycle_requests=2), real.limits,
                     bench["end_to_end"], bench["per_layer"])
    out = serve.run(cell, SEED, 1.0, False, CPU, time.perf_counter())
    assert _correct(out, cell), out["compared"]


def _fault_step(x, e, keys, datum, coef, active):
    return x                                   # the state unchanged


def _half_batch_step(real):
    def step(x, e, keys, datum, coef, active):
        out = real(x, e, keys, datum, coef, active)
        half = x.shape[1] // 2
        return torch.cat([out[:, :half], x[:, half:]], dim=1)
    return step


def _altered_engine(real):
    def make(*a, **kw):
        server, client = real(*a, **kw)

        def altered(*b, **kwb):
            out = client(*b, **kwb).clone()
            out[0, 0] = -out[0, 0]             # one image turned over
            return out
        return server, altered
    return make


@pytest.mark.parametrize("fault", [None, "unchanged_step", "half_batch",
                                   "altered_answer"])
def test_serve_run_is_correct_only_when_sound(fault, monkeypatch):
    import repro_torch.core.sampler as sampler
    import repro_torch.serve.runtime as runtime
    if fault == "unchanged_step":
        monkeypatch.setattr(sampler, "ddpm_step_rowwise", _fault_step)
    elif fault == "half_batch":
        monkeypatch.setattr(sampler, "ddpm_step_rowwise",
                            _half_batch_step(sampler.ddpm_step_rowwise))
    elif fault == "altered_answer":
        monkeypatch.setattr(runtime, "make_sample_engine",
                            _altered_engine(runtime.make_sample_engine))
    cell = _serve_cell()
    out = serve.run(cell, SEED, 1.0, False, CPU, time.perf_counter())
    assert out["e2e"]["samples_per_s"] > 0
    assert _correct(out, cell) is (fault is None), out["compared"]


def test_serve_control_is_not_correct():
    cell = _serve_cell()
    got = serve.control(cell, SEED, CPU, "tf32")
    assert got["sample_gap"] > cell.limits["sample_gap"]


def test_limits_name_the_compared_numbers():
    for w in spec.load_benchmark(BENCH.parent)["workloads"]:
        limits = json.loads((BENCH / "limits" / f"{w['name']}.json")
                            .read_text())
        assert limits and all(v > 0 for v in limits.values())
