"""The port's examples (examples/torch_*.py) on the CPU.

* Each example's ``run(device="cpu", ...)`` at small sizes: the
  reference script's steps through ``repro_torch``, outputs finite and of
  their shapes.
* Without a card, each ``main`` (``--device`` defaults to cuda) raises
  instead of falling back to the CPU.
* The quickstart's steps at T 8, 4×4 images and one round of two
  batches a client against the same calls of the JAX package (its
  ``examples/quickstart.py``): the round's metrics and the samples and
  handoff within TOL (the reference's fp32 tolerance; the port's
  ``normal`` differs from JAX's by the few ulps of ``erfinv``), the
  synthetic data and labels within TOL and bitwise.
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import collab as jcollab
from repro.data import synthetic as jsyn
from repro.eval.fd_proxy import fd_proxy as jfd_proxy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=2e-5, rtol=2e-3)
NAMES = ("torch_quickstart", "torch_cutpoint_sweep", "torch_dit_backbone",
         "torch_train_lm")
QUICK = dict(T=8, t_cut=2, image_size=4, n_per_client=8, rounds=1,
             n_batches=2, batch=2, n_samples=4, n_real=8)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _finite(t) -> bool:
    return bool(torch.isfinite(torch.as_tensor(t)).all())


def test_quickstart_runs_small():
    out = _example("torch_quickstart").run(device="cpu", **QUICK)
    assert out["samples"].shape == out["handoff"].shape == (4, 4, 4, 3)
    assert _finite(out["samples"]) and _finite(out["fd_samples"])
    assert set(out["metrics"][0]) == {0, 1}


def test_cutpoint_sweep_runs_small():
    rows = _example("torch_cutpoint_sweep").run(
        device="cpu", T=8, image_size=4, n_per_client=8, n_batches=1,
        batch=2, n_samples=4, n_real=8)
    assert [r["t_cut"] for r in rows] == [0, 2, 4, 8]
    assert [r["client_share"] for r in rows] == [0.0, 25.0, 50.0, 100.0]
    assert all(_finite(r["fd_sample"]) and _finite(r["fd_handoff"])
               for r in rows)


def test_dit_backbone_runs_small():
    out = _example("torch_dit_backbone").run(
        "zamba2-1.2b", device="cpu", T=6, t_cut=2, image_size=4,
        n_per_client=8, n_batches=1, batch=2, n_samples=4, n_real=8)
    assert out["samples"].shape == (4, 4, 4, 3) and _finite(out["samples"])
    assert _finite(out["metrics"][0]["server_loss"])


def test_train_lm_runs_small():
    out = _example("torch_train_lm").run(
        "granite-8b", device="cpu", steps=2, batch=2, seq=16, serve_batch=2,
        prompt_len=8, new_tokens=3)
    assert len(out["losses"]) == 2 and _finite(out["losses"])
    assert out["tokens"].shape == (2, 3)


@pytest.mark.parametrize("name", NAMES)
def test_main_without_a_card_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example(name).main([])


def test_quickstart_matches_the_jax_steps(monkeypatch):
    out = _example("torch_quickstart").run(device="cpu", **QUICK)
    build = jcollab.build_denoiser
    # JAX's setup draws each model through one jitted init (eager, its
    # threefry draws compile op by op: 16 s of this test)
    monkeypatch.setattr(jcollab, "build_denoiser", lambda key, cfg: (
        jax.jit(build(key, cfg)[0]), build(key, cfg)[1]))
    q = QUICK
    key = jax.random.PRNGKey(0)
    ccfg = jcollab.CollabConfig(n_clients=2, T=q["T"], t_cut=q["t_cut"],
                                image_size=q["image_size"],
                                batch_size=q["batch"], n_classes=8)
    dcfg = jsyn.SyntheticConfig(image_size=q["image_size"], n_attrs=8)
    data = jsyn.make_client_datasets(key, dcfg, 2, q["n_per_client"],
                                     non_iid=True)
    state, step_fn, apply_fn = jcollab.setup(key, ccfg)
    kr = jax.random.fold_in(key, 0)
    per_client = [list(jsyn.batches(x, y, q["batch"], kr))[:q["n_batches"]]
                  for x, y in data]
    metrics = jcollab.train_round(state, step_fn, per_client, kr)
    y = data[0][1][:q["n_samples"]]
    samples, handoff = jcollab.sample_for_client(
        state, 0, key, y, ccfg, apply_fn, return_handoff=True)
    got = out["metrics"][0]
    assert set(got) == set(metrics)
    for c in metrics:
        assert set(got[c]) == set(metrics[c])
        for k, v in metrics[c].items():
            np.testing.assert_allclose(got[c][k], v, **TOL, err_msg=k)
    np.testing.assert_allclose(out["samples"].numpy(), np.asarray(samples),
                               **TOL)
    np.testing.assert_allclose(out["handoff"].numpy(), np.asarray(handoff),
                               **TOL)
    real = np.asarray(data[0][0][:q["n_real"]])
    np.testing.assert_allclose(
        out["fd_samples"], float(jfd_proxy(real, samples)), **TOL)
