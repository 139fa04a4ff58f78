"""The port's training CLI (``python -m repro_torch.launch.collab_train``).

* ``--smoke --device cpu`` asserts the reference's contracts (a)–(f):
  strict-subset cohorts and one engine signature per tier, bitwise
  resume at the midpoint, the sync straggler barrier bitwise equal to
  the lag-free run and async within atol 5e-2, the privacy identity
  ladder and secagg on == off bitwise with a monotone ε, and obs a pure
  observer;
* a plain run with a checkpoint, then ``--resume`` to more rounds, ends
  bitwise where an uninterrupted run ends; the churn flags (join, leave)
  run;
* its base key is the reference CLI's (``PRNGKey(seed)``), so the same
  flags draw the reference's cohorts;
* without ``--device cpu`` and without a card the CLI raises;
* ``main`` runs the runtime on a one-rank ``("clients",)`` mesh whose
  process group it makes and tears down before returning; a group the
  caller made is left to the caller.
"""
import jax
import numpy as np
import pytest
import torch

from repro.train import ParticipationConfig as JPart
from repro.train.participation import sample_cohort as jsample
from repro_torch.core import prng, trees
from repro_torch.launch import collab_train
from repro_torch.train.participation import sample_cohort

torch.set_num_threads(1)

SMALL_RUN = ["--denoiser", "toy", "--clients", "3", "--T", "20", "--t-cut",
             "5", "--batch", "4", "--batches-per-round", "2",
             "--image-size", "8", "--n-per-client", "8", "--policy",
             "bernoulli", "--p", "0.7", "--fedavg-every", "2", "--ema",
             "0.9", "--device", "cpu"]


def test_smoke_cpu():
    last = collab_train.main(["--smoke", "--device", "cpu"])
    assert last["max_signatures_per_tier"] == 1
    assert last["round"] == 5


def test_resume_cli_equals_uninterrupted(tmp_path):
    path = str(tmp_path / "ck.msgpack")
    full = collab_train.main(SMALL_RUN + ["--rounds", "4"])
    collab_train.main(SMALL_RUN + ["--rounds", "2", "--checkpoint", path])
    resumed = collab_train.main(SMALL_RUN + ["--rounds", "4",
                                             "--checkpoint", path,
                                             "--resume"])
    assert resumed.round == full.round == 4
    assert trees.equal(resumed.server_params, full.server_params)
    assert trees.equal(resumed.ema_server, full.ema_server)
    for u in full.registry.uids():
        assert trees.equal(resumed.registry.get(u).params,
                           full.registry.get(u).params)
    churn = collab_train.main(SMALL_RUN + ["--rounds", "3", "--join-at",
                                           "1", "--leave-at", "2"])
    assert len(churn.registry) == 4 and not churn.registry.get(0).active


def test_cohorts_are_the_reference_cli_cohorts():
    rt = collab_train.main(SMALL_RUN + ["--rounds", "3", "--seed", "4"])
    jkey = jax.random.PRNGKey(4)          # the reference CLI's base key
    np.testing.assert_array_equal(prng.key_data(rt._key), np.asarray(jkey))
    cfg = JPart(policy="bernoulli", p=0.7)
    for r in range(8):
        assert sample_cohort(rt.config.participation, rt._key, r,
                             [0, 1, 2]) == jsample(cfg, jkey, r, [0, 1, 2])


def test_main_leaves_no_process_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    rt = collab_train.main(SMALL_RUN + ["--rounds", "2"])
    assert not dist.is_initialized()
    assert rt.mesh.mesh_dim_names == ("clients",) and rt.mesh.size() == 1
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        again = collab_train.main(SMALL_RUN + ["--rounds", "2"])
        assert dist.is_initialized()
        assert trees.equal(again.server_params, rt.server_params)
    finally:
        dist.destroy_process_group()


def test_cli_without_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        collab_train.main(["--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        collab_train.main(["--denoiser", "toy", "--rounds", "1"])
