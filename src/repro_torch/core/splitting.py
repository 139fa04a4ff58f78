"""The cut point t_ζ — CollaFuse's single split hyperparameter — and the
client-side schedule remap of Alg. 2.

  * t_ζ = 0  → GM baseline: the server performs all denoising.
  * t_ζ = T  → ICM baseline: each client runs its own full model.
  * 0 < t_ζ < T → collaborative: server does steps T…t_ζ+1, client t_ζ…1.

Client schedule remap (Alg. 2 lines 2–3): the handoff still carries more
residual noise than a vanilla schedule at step t_ζ would imply, so the
client stretches its t_ζ steps over [1, M] with
M = ⌊t_ζ + (t_ζ/T)·(T − t_ζ)⌋, via a linearly spaced float timestep list
evaluated with interpolated schedule coefficients.

Step tables are host numpy arrays (float32, the JAX package's exact
values): the planner builds its padded tables from them on the host, and
the samplers move them to the device once per call.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.schedules import linspace_f32


def row_keys(key: torch.Tensor, batch: int) -> torch.Tensor:
    """One PRNG key per batch row: ``fold_in(key, i)``, so row i's
    randomness depends only on (key, i), never on the batch size.  A
    batched key (..., 2) gives (..., batch, 2)."""
    rows = torch.arange(batch, device=key.device)
    return prng.fold_in(key.unsqueeze(-2), rows)


@dataclasses.dataclass(frozen=True)
class CutPoint:
    T: int
    t_cut: int

    def __post_init__(self):
        if not 0 <= self.t_cut <= self.T:
            raise ValueError(f"t_cut {self.t_cut} outside [0, {self.T}]")

    # --- roles -----------------------------------------------------------
    @property
    def is_global_model(self) -> bool:
        return self.t_cut == 0

    @property
    def is_independent_clients(self) -> bool:
        return self.t_cut == self.T

    @property
    def n_client_steps(self) -> int:
        return self.t_cut

    @property
    def n_server_steps(self) -> int:
        return self.T - self.t_cut

    # --- training timestep ranges (Alg. 1 line 6) -------------------------
    # Drawn row-keyed (one fold_in(key, i) per sample, a scalar randint
    # each), so sample i's timestep never depends on the batch size.
    def sample_client_t(self, key: torch.Tensor, batch: int) -> torch.Tensor:
        """t_c ~ U[1, t_ζ] (integer, inclusive), int32 (B,)."""
        return prng.randint(row_keys(key, batch), (), 1,
                            max(self.t_cut, 1) + 1)

    def sample_server_t(self, key: torch.Tensor, batch: int) -> torch.Tensor:
        """t_s ~ U[t_ζ, T] (integer, inclusive), int32 (B,): indices of
        the global schedule for the re-noising x_{t_s} = α(t_s)·x_{t_ζ} +
        σ(t_s)·ε_s."""
        return prng.randint(row_keys(key, batch), (), max(self.t_cut, 1),
                            self.T + 1)

    # --- inference schedules (Alg. 2) --------------------------------------
    @property
    def M(self) -> int:
        return int(self.t_cut + (self.t_cut / self.T) * (self.T - self.t_cut))

    def client_t_list(self, adjusted: bool = True) -> np.ndarray:
        """Float timesteps the client sweeps (descending), length t_ζ.
        ``adjusted=False`` ablates the M-remap: the vanilla t_ζ…1."""
        if self.t_cut == 0:
            return np.zeros((0,), np.float32)
        hi = float(self.M) if adjusted else float(self.t_cut)
        return linspace_f32(hi, 1.0, self.t_cut)

    def client_step_table(self, adjusted: bool = True
                          ) -> tuple[np.ndarray, np.ndarray]:
        """(t, t_prev) pairs for the client sweep: the remapped descending
        t_list and its shifted predecessor (the last step lands at 0; both
        empty for the GM cut t_ζ=0)."""
        t = self.client_t_list(adjusted)
        t_prev = np.concatenate(
            [t[1:], np.zeros((min(t.shape[0], 1),), np.float32)])
        return t, t_prev.astype(np.float32)

    def server_t_list(self) -> np.ndarray:
        """Integer timesteps the server sweeps: T, T-1, …, t_ζ+1."""
        return np.arange(self.T, self.t_cut, -1, dtype=np.int32)
