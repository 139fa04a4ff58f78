"""The port's serve runtime against the JAX package's under the
continuous and strided (DDIM server phase) policies; the helpers and the
tolerances are test_torch_serve.py's (outputs within SAMPLE, integer
counters and report keys bitwise)."""
import pytest
import torch

from test_torch_serve import assert_runtime_matches_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("over,passes", [
    (dict(policy="continuous", max_wave=3), 1),
    (dict(policy="depth", server_stride=3, pipeline=False), 1)],
    ids=["continuous", "strided"])
def test_runtime_matches_jax(over, passes):
    assert_runtime_matches_jax(over, passes)
