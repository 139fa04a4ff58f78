"""The serving CLI of the language models: batched prefill, then
autoregressive decode against the fixed-size KV / SSM state.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --reduced --device cpu
    python -m repro_torch.launch.serve --arch zamba2-1.2b --batch 4 \\
        --prompt-len 512 --new-tokens 32

The port of the JAX package's ``launch/serve.py``, with its flags plus
``--device`` (CUDA unless ``--device cpu``).  Weights come from threefry
``PRNGKey(0)`` (``api.init_params``), and so does the prompt,
``randint(PRNGKey(0), (B, S), 0, vocab)``, so on the CPU the reference
and the port decode the same tokens.  A VLM's stub vision embeddings and
the audio family's stub frames (B, prompt_len, d_model) are drawn in
float32 and cast to the model's type (the reference draws them in that
type; equal for float32 models); the audio family's decoder prompt is
the prompt's first min(8, prompt_len) tokens, and decoding starts after
it.  ``--no-greedy`` samples from
softmax(logits / ``--temperature``) with ``prng.categorical``, keyed
``fold_in(PRNGKey(0), i)`` for the i-th token.  Prefill and the decode
loop are timed on the host's clock, synchronised with the card at each
end.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.models import api


def _now(dev: torch.device) -> float:
    """The host's clock, after the card has finished what was queued."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--greedy", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="softmax temperature for --no-greedy sampling")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(argv: Optional[List[str]] = None
        ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """Serve one batch; returns (generated tokens (B, new_tokens) int64,
    report: prefill_ms, decode_ms_per_token, tok_per_s)."""
    args = parse(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    key = prng.PRNGKey(0, device=dev)
    params = api.init_params(key, cfg, dev)

    B, S = args.batch, args.prompt_len
    prompt = prng.randint(key, (B, S), 0, cfg.vocab_size).long()
    batch = {"tokens": prompt}
    prefix = 0
    if cfg.family == "vlm":
        prefix = cfg.n_vision_tokens
        batch["vision_embeds"] = prng.normal(
            key, (B, prefix, cfg.d_model)).to(cfg.torch_dtype)
    if cfg.family == "audio":
        batch["frames"] = prng.normal(key, (B, S, cfg.d_model)).to(
            cfg.torch_dtype)
        batch["tokens"] = prompt[:, :min(8, S)]

    def pick(logits, k):
        last = logits[:, -1, :]
        if args.greedy:
            tok = torch.argmax(last, dim=-1)
        else:
            tok = prng.categorical(
                k, last.float() / max(args.temperature, 1e-6))
        return tok[:, None]

    with torch.no_grad():
        t0 = _now(dev)
        logits, state = api.prefill_fn(params, batch, cfg,
                                       cache_len=S + prefix + args.new_tokens)
        prefill_ms = (_now(dev) - t0) * 1e3
        print(f"prefill: {tuple(logits.shape)} in {prefill_ms:.1f} ms")
        tok = pick(logits, prng.fold_in(key, 0))
        out = [tok]
        start = batch["tokens"].shape[1] + prefix
        t0 = _now(dev)
        for i in range(args.new_tokens - 1):
            logits, state = api.decode_fn(params, tok, state, start + i,
                                          cfg)
            tok = pick(logits, prng.fold_in(key, i + 1))
            out.append(tok)
        decode_ms = (_now(dev) - t0) * 1e3
    gen = torch.cat(out, dim=1)
    steps = max(args.new_tokens - 1, 1)
    report = {"prefill_ms": prefill_ms,
              "decode_ms_per_token": decode_ms / steps,
              "tok_per_s": B * (args.new_tokens - 1) /
              max(decode_ms / 1e3, 1e-9)}
    print(f"decoded {gen.shape[1]} tokens/seq: {args.new_tokens - 1} decode "
          f"steps in {decode_ms:.1f} ms ({report['decode_ms_per_token']:.2f}"
          f" ms a step, {report['tok_per_s']:.1f} tok/s)")
    print("sample row:", gen[0, :16].tolist())
    return gen, report


def main(argv: Optional[List[str]] = None) -> torch.Tensor:
    return run(argv)[0]


if __name__ == "__main__":
    main()
