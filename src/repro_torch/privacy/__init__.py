"""Privacy subsystem (DP-FedAvg + secure-aggregation cohorts + an RDP
epsilon-accountant) for the federated training runtime; the port of the
JAX package's ``privacy/``:

  * privacy/dp.py         — the clip+noise mechanism: per-member global-L2
                            update clipping and calibrated Gaussian noise at
                            the ``average_cohort`` boundary (DP-FedAvg),
                            and the per-row payload-DP primitives
                            core/protocol delegates to;
  * privacy/secagg.py     — pairwise-masking secure-aggregation simulation
                            in exact fixed-point arithmetic on the host
                            (masks cancel bitwise; dropout recovery);
  * privacy/accountant.py — integer-order RDP accountant for the
                            subsampled Gaussian mechanism (pure numpy).

Wired into repro_torch.train through
``TrainConfig(privacy=PrivacyConfig(...))``.
"""
from repro_torch.privacy import secagg  # noqa: F401  (before dp: dp imports it)
from repro_torch.privacy.accountant import (DEFAULT_ORDERS, RdpAccountant,
                                            epsilon_for,
                                            noise_multiplier_for_epsilon,
                                            rdp_subsampled_gaussian,
                                            rdp_to_epsilon)
from repro_torch.privacy.dp import (DP_CLIP, TAG_DP, PrivacyConfig,
                                    clip_by_global_norm, clip_rows,
                                    dp_average_cohort, dp_noise_key,
                                    gaussian_noise_like, global_l2_norm,
                                    privatize_payload)
from repro_torch.privacy.secagg import (SCALE_BITS, TAG_SECAGG,
                                        dequantize, mask_for, masked_upload,
                                        quantize, secagg_sum)

__all__ = [
    "DEFAULT_ORDERS", "DP_CLIP", "PrivacyConfig", "RdpAccountant",
    "SCALE_BITS", "TAG_DP", "TAG_SECAGG", "clip_by_global_norm",
    "clip_rows", "dequantize", "dp_average_cohort", "dp_noise_key",
    "epsilon_for", "gaussian_noise_like", "global_l2_norm", "mask_for",
    "masked_upload", "noise_multiplier_for_epsilon", "privatize_payload",
    "quantize", "rdp_subsampled_gaussian", "rdp_to_epsilon", "secagg",
    "secagg_sum",
]
