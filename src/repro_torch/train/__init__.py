"""Federated training runtime (partial-participation round orchestrator
with shape-stable cohort tiers and bitwise mid-run resume) over the
masked cohort round of core/collab.py; the port of the JAX package's
``train/``.  See train/runtime.py for the design notes."""
from repro_torch.privacy.dp import PrivacyConfig
from repro_torch.train.participation import (ParticipationConfig,
                                             sample_cohort, sample_drops,
                                             sample_lags, sampling_rate,
                                             uid_scores)
from repro_torch.train.registry import ClientRecord, ClientRegistry
from repro_torch.train.rounds import (RoundPlan, participation_tier,
                                      plan_round)
from repro_torch.train.runtime import TrainConfig, TrainRuntime

__all__ = ["ClientRecord", "ClientRegistry", "ParticipationConfig",
           "PrivacyConfig", "RoundPlan", "TrainConfig", "TrainRuntime",
           "participation_tier", "plan_round", "sample_cohort",
           "sample_drops", "sample_lags", "sampling_rate", "uid_scores"]
