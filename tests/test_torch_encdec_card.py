"""The encoder-decoder on the card (``cuda`` marker; each test skips
without a device): flash forward and backward at whisper's encoder shape,
non-causal over S 1,500 = 23 × 64 + 28 (a ragged tail), against their
plain versions (TOL_BF16; ``row_gap`` within BWD_BF16_ROW), through the
op's autograd route with its launches counted; and a whisper cut to 2 +
2 layers at the published widths on the card against the CPU port with
the same weights.  Run on the card with
``python3 -m pytest -q -m cuda tests/test_torch_encdec_card.py``.
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core import prng
from repro_torch.models import api

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (BWD_BF16_ROW, LM_BF16_RTOL, LM_LOSS_RTOL,  # noqa
                        TOL_BF16, row_gap)

ARCH = "whisper-base"


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")


@pytest.mark.cuda
def test_cuda_flash_at_the_encoders_noncausal_ragged_shape():
    _cuda()
    from repro_torch.kernels.flash_attention import kernel, ops
    from repro_torch.kernels.flash_attention.ref import (
        attention_lse, attention_ref, flash_attention_bwd_ref)
    g = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=g, device="cuda").bfloat16()
    q, k, v, do = (rn(2, 8, 1500, 64) for _ in range(4))
    out = kernel.launch(q, k, v, False, 0)
    assert torch.allclose(out.float(), attention_ref(q, k, v, False,
                                                     0).float(), **TOL_BF16)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    before = dict(kernel.COUNTS)
    with torch.enable_grad():
        o = ops.flash_attention(qg, kg, vg, causal=False)
        grads = torch.autograd.grad(o, (qg, kg, vg), do)
    assert kernel.COUNTS["flash_attention_bwd/wgmma"] == \
        before["flash_attention_bwd/wgmma"] + 1
    assert torch.equal(o.detach(), out)
    refs = flash_attention_bwd_ref(q, k, v, out, do,
                                   attention_lse(q, k, False, 0), False, 0)
    for gr, r in zip(grads, refs):
        assert row_gap(gr, r) <= BWD_BF16_ROW


@pytest.mark.cuda
def test_cuda_whisper_forward_matches_the_cpu_port():
    """2 + 2 layers at the published widths, bf16, the same weights: the
    loss within LM_LOSS_RTOL of the CPU port's, the logits of a prefill
    within LM_BF16_RTOL of max(1, max |logit|)."""
    _cuda()
    import copy
    from repro_torch.launch import train
    cfg = dataclasses.replace(get_arch(ARCH), n_layers=2,
                              n_encoder_layers=2)
    card = api.init_params(prng.PRNGKey(0), cfg, "cuda")
    cpu = copy.deepcopy(card).to("cpu")
    batch = train.build_batch(prng.PRNGKey(3, device="cuda"), cfg, 1, 300)
    with torch.no_grad():
        l_card = api.loss_fn(card, batch, cfg).item()
        l_cpu = api.loss_fn(cpu, {k: v.cpu() for k, v in batch.items()},
                            cfg).item()
        lg_card, _ = api.prefill_fn(card, batch, cfg)
        lg_cpu, _ = api.prefill_fn(cpu, {k: v.cpu() for k, v in
                                         batch.items()}, cfg)
    assert abs(l_card - l_cpu) <= LM_LOSS_RTOL * abs(l_cpu)
    b = lg_cpu.float()
    assert (lg_card.float().cpu() - b).abs().max().item() <= \
        LM_BF16_RTOL * max(1.0, b.abs().max().item())
