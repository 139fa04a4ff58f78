#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA device, nvcc and nothing
beyond the repository's own sources (it imports neither JAX nor the JAX
package).  Phases, each of which fails the run on any error:

1. card: the nvidia-smi name/power-limit line, torch and CUDA versions;
2. build: nvcc builds every kernel source of the port, all started
   together;
3. kernel vs plain: each kernel entry against its plain PyTorch version on
   the card, at the JAX package's parity shapes and the serve path's
   shapes, fp32 and bf16, with times beside the byte bound; the keyed
   DDPM-step variants (threefry draw, coefficient row and the engine's
   mask inside the launch) against their plain composition, bitwise in
   fp32 (KEYED_FP32_ULPS), with the output key and the coefficient tables
   bitwise, each timed and profiled beside the composed step it replaces
   (draw, per-step coefficients, the given-noise launch, where);
4. the full-width U-Net (configs CONFIG) on the card against the port on
   the CPU, same threefry weights, one forward of B=4;
5. the main path: ``ServeRuntime`` on CUDA with the CONFIG U-Net, T=1000,
   3 clients at cuts 125/250/500, 2 requests x batch 4, max_wave 4, depth
   policy, cache on, 2 passes, then one per-request Alg.-2 sample
   (``make_per_request_sampler``); kernel launch counters are zeroed just
   before and read just after, and must equal the scheduled steps, every
   one on the keyed variants (``keyed``, ``rowwise``); then the device
   events per per-request step from a T=10 sample's profile, and each
   pass's wall split by the runtime's own spans;
6. serve contracts at CONFIG width on the card (the CLI's ``--smoke``,
   T=20: warm==cold==fifo, pipelined==sequential, continuous==depth, obs
   on==off, all bitwise) and the batched engine against its per-request
   reference, bitwise;
7. the training path (Alg. 1): ``setup`` with six CONFIG U-Nets (server
   + 5 clients, T=1000, cut 250) and one ``train_round`` of 10 steps
   over non-IID synthetic data (``make_client_datasets``, 2 batches of 8
   per client); the same round on the CPU port from the same state and
   key must agree within TRAIN_TOL (params, both moments, step counters),
   TRAIN_MOMENT_RTOL (each moment leaf against its own largest value) and
   TRAIN_METRIC_RTOL (every step's losses and grad norms), while the same
   round on the card with TF32 allowed must not; and the round repeated
   on the card must equal the first bitwise.  Per step:
   wall (CUDA events), device time (profiler), idle share, AdamW's share,
   peak memory.  Then, with the DDPM-step counters zeroed just before, one
   Alg.-2 sample (``sample_for_client``) from the trained server and
   client 0: exactly T = 1000 keyed DDPM-step launches;
8. the federated training runtime: the CLI's ``--smoke`` contracts (a)-(f)
   on the card with the toy denoiser, then ``TrainRuntime`` with the same
   six CONFIG U-Nets and batches (bernoulli p 0.8, mid-round dropout 0.1,
   FedAvg every 2 rounds, EMA 0.99, RT_ROUNDS rounds): one engine
   signature per participation tier, a restore of the round-2 checkpoint
   that finishes bitwise equal to the uninterrupted run, round 1 against
   the same round on the CPU port (cohorts bitwise; params, moments and
   steps within TRAIN_TOL and TRAIN_MOMENT_RTOL), the gap between a
   cohort padded to its tier and the cohort alone (within TRAIN_TOL,
   "bitwise" when 0), a DP run (clip 1.0, noise 0.8) with secagg on
   bitwise equal to off; per round the wall (CUDA events), rounds/s,
   Alg.-1 steps/s, device ms (profiler) and idle share, peak memory and
   the checkpoint's save / restore seconds; then, with the DDPM-step
   counters zeroed just before, one Alg.-2 sample from the EMA server
   (``sampling_server_params``) and client 0: exactly 1,000 keyed
   launches;
8b. the clients mesh (``phase_clients_mesh``): on a one-rank NCCL
   ``("clients",)`` mesh (``make_client_mesh``), the same six CONFIG
   U-Nets, data and participation: CM_ROUNDS ``TrainRuntime`` rounds
   with ``mesh=`` bitwise equal to as many without (the cohort placed by
   ``shard_cohort_round``, the server's gradient all-reduced, each real
   slot broadcast from its owner), a ``make_sample_engine`` pass of
   CM_REQUESTS requests on tables placed by ``shard_sample_plan``
   bitwise equal to the unplaced pass, and one keyed per-request sample
   from bf16 CONFIG U-Nets bitwise across two runs, both at T=100, cut
   25; counters zeroed just before: 200 rowwise and 200 keyed
   launches.  The walls (events) and device ms (profiler) of the
   sharded and unsharded rounds, the bytes each round handed to the
   all-reduce, the broadcasts and the all-gathers, and those bytes
   reckoned per rank at 2, 4 and 8 ranks with their NVLINK_BW time;
9. the evaluation (eval/) of the models phase 8 trained: one
   shared-handoff pass of EVAL_N samples for clients 0 and 1 on client
   1's labels (750 server + 2 x 250 client steps: exactly 1,250 keyed
   launches, counted from zero just before), the FD proxy of each
   client's real data against its samples and against the handoff,
   attribute-inference F1 on client 1's q_sample intermediates at
   EVAL_TS, the inversion attack at EVAL_INV_T (client 0 attacks client
   1); ``features`` and ``frechet_distance`` against the CPU port on the
   same inputs (TRAIN_TOL, EVAL_FD_RTOL), the two trainers over
   EVAL_SHORT_STEPS steps (the classifier at TRAIN_TOL, the inverter at
   EVAL_INV_ATOL);
10. flash attention and the SSD scan against their plain versions on the
   card at the JAX package's test shapes (tests/test_kernels.py sweeps)
   and shapes that reach the wgmma variants (flash at head dim 128 and
   over three K/V tiles; the SSD scan's SSD_WGMMA, in bf16), float32 and
   bfloat16, with those tests' tolerances (SSD_WGMMA: SSD_BF16_RANGE);
   both variants (wgmma, simt) of each must be launched; then the Mamba2
   mixer's three glue kernels (``phase_mamba_mixer``: the causal conv +
   SiLU, the input norm, the gated output norm) bitwise the eager route
   at Zamba2-1.2B's widths in bf16 and the shapes of the DiT (64 x 64
   tokens) and the LM prefills, planted faults of the eager version
   differing, each timed beside its eager composition and its bound;
11. the DiT path: server and three client Zamba2-1.2B DiTs at full width
   (configs/zamba2_1p2b.py, bf16, 38 Mamba2 layers, the shared
   attention+MLP block every 6) on 32x32x3 images in 4x4 patches (64
   tokens), threefry-initialised on the card.  One Alg.-1 loss through
   the server DiT and its backward: finite gradients on every parameter,
   and as many flash and SSD backward launches as forward ones (6 and
   38), every one on the wgmma variants.  The flash and SSD kernels
   are held against their plain versions on the inputs the first forward
   feeds them and timed there; then, with every launch counter zeroed just
   before, one per-request Alg.-2 sample (T=250, cut 125, batch 4) and
   one ``ServeRuntime`` pass (T=60, cuts 8/15/30, three requests of
   batch 4, max_wave 4, depth policy, cache on), counters read just
   after: 6 flash and 38 SSD launches per forward, every one on the wgmma
   variants, and 38 of each mixer glue kernel (none under the loss's
   autograd, which keeps the eager route), their card ms a launch from
   the forward's profile.  Flash's and the SSD scan's rows of batch 1
   must equal those of batch 4 bitwise.  The pass's outputs must equal
   ``sample_plan_reference`` bitwise on the card;
12. the grouped matmul against its plain version on the card at the JAX
   package's test shapes (tests/test_kernels.py sweep) and shapes that
   reach the wgmma variant (C over one 256-row tile, ragged F), float32
   and bfloat16, with contiguous tokens and tokens broadcast to every
   expert (expert stride 0), and a misaligned token pointer; the wgmma,
   wmma and simt variants must all be launched;
13. the MoE path: the Zamba2 models are freed; a ``TrainRuntime`` round
   with MoE DiTs at the reduced DBRX-132B widths in bf16 (the round
   completes, the server's parameters move but for the RMSNorm scales,
   whose AdamW step is under half a bf16 ulp at 1.0 and whose gradients
   reach them, its moments stay finite, the grouped matmul's backward
   kernel launched in the variant ``choose_variant_backward`` picks,
   ``wgmma``); then server and three
   client DiTs with DBRX-132B blocks at full width (configs/dbrx_132b.py:
   d_model 6144, 48 query / 8 KV heads of 128, 16 experts of FFN width
   10,752, top-4, bf16) cut to 2 blocks (MOE_LAYERS), on the same 64
   tokens, threefry-initialised on the card; between the server's draw
   and the clients', one Alg.-1 loss through the server DiT and its
   backward, counters zeroed just before: 6 grouped-matmul and 2 flash
   backward launches (both ``wgmma``), every gradient leaf within
   LM_GRAD_RTOL of the same loss's with the expert products through the
   plain versions, another noise's outside.  Flash attention at head dim
   128 and the three grouped-matmul launches of the first block are held
   against their plain versions on the inputs the first forward feeds
   them and timed there, beside ``torch.bmm`` and SDPA, with their card
   time from the profiler; the grouped matmul's output rows at C = 64 must
   equal the first 64 rows at C = 256, and flash's rows of batch 1 those
   of batch 4, bitwise.  Then, with every launch counter zeroed just
   before, one per-request Alg.-2 sample (T=250, cut 125) and one
   ``ServeRuntime`` pass (T=60, cuts 8/15/30), counters read just after:
   6 grouped-matmul and 2 flash launches per forward, all on the wgmma
   variants.  The pass's outputs must equal ``sample_plan_reference``
   bitwise.  The path's launches: the gradient's, the round's and the
   pass's and sample's;
13b. the MoE training path (``phase_moe_train``): (a) the grouped
   matmul's backward kernel (csrc/grouped_matmul_bwd.cu) against
   ``grouped_matmul_bwd_ref`` at DBRX's expert shapes for the C each path
   feeds it (GMM_BWD_CASES: dense DiT 256 broadcast, expert-parallel DiT
   80, expert-parallel LM 1,280, dense LM 4,096 broadcast), bf16
   (``wgmma``) and float32 (``simt``), and one small bf16 case with a
   misaligned token pointer (``wmma``), each row within BWD_BF16_ROW /
   BWD_FP32_ROW, planted faults beyond it, two launches and dX's rows
   across C bitwise, timed beside the plain version, the ``torch.bmm``
   pair, the bound and, in bf16, the older ``wmma`` design (at C >=
   GMM_BWD_HALF_FROM_C the ``wgmma`` variant must take at most half its
   time), and the forward at the same C beside
   ``torch.bmm``; the flash backward at DBRX's attention
   (FLASH_BWD_DBRX); (b) ``moe_ep`` and ``moe_ep2d`` on a one-card NCCL
   mesh (``make_debug_mesh``) for one full-width layer of 256 tokens,
   within MOE_EP_RTOL of ``moe_dense`` at capacity factor 8 and with
   their drops at 1.25, two calls bitwise; (d) the ``train`` CLI on the
   reduced DBRX-132B (float32) for 20 steps, counters checked every step,
   losses within LM_LOSS_RTOL of the CPU CLI's; at full width (2 blocks,
   B 4 x S 1,024) ``loss_and_grads`` dense and expert-parallel, counted
   from zero just before each: 6 grouped-matmul and 2 flash forward
   launches and as many backward; loss, wall, device time, idle, peak
   memory; the reduced config's gradients on the card against the CPU
   port, dense and expert-parallel, within LM_GRAD_RTOL, another batch's
   outside;
14. the LM serving path: Zamba2-1.2B as a language model at the
   published widths (38 Mamba2 layers, d_model 2048, 64 SSD heads of 64,
   state 64, the shared block every 6 layers, vocab 32,000, bf16,
   threefry seed 0): (a) the ``serve`` CLI twice (batch 4, 512 prompt
   tokens, 32 new, greedy), counters zeroed just before each: tokens
   bitwise equal, 6 flash and 38 SSD launches (all wgmma) and 38 of each
   mixer glue kernel for the prefill and none for the 31 decode steps;
   (b) prefill + one decode step against the full forward at S, for S in
   LM_PROMPTS (512: two SSD chunks; 333: a ragged tail); (c) four greedy
   decode steps against repeated full forwards at 512; (d) flash and the
   SSD scan (y, its tail rows and the final state) against their plain
   versions on each
   prefill's own inputs, rows bitwise across the batch, timed beside
   SDPA and the bound; (e) a model cut to LM_CPU_LAYERS layers on the
   card against the CPU port with the same weights; every logit gap
   within LM_BF16_RTOL; (g) prefill and decode wall (events), device
   time and idle share; then flash and the SSD scan at the DiT's shapes
   again, after the LM's tensor maps;
15. the LM training path (``phase_lm_train``): (a) the two backward
   kernels (flash attention's, csrc/flash_attention_bwd.cu; the SSD
   scan's, csrc/ssd_scan_bwd.cu) against their plain versions
   (``flash_attention_bwd_ref``, ``ssd_chunked_bwd_ref``) at the
   training step's shapes and in a sweep (FLASH_BWD_SWEEP,
   SSD_BWD_SWEEP, which must launch both variants, wgmma and simt)
   within BWD_BF16_ROW / BWD_FP32_ROW of each row (``row_gap``); at the
   step's shapes the wgmma variant (the wrappers' choice there) and simt
   on the same inputs (``variant="simt"``), each with planted faults
   outside that limit, rows bitwise across the batch and two launches
   bitwise; the forward's output bitwise with and without its
   log-sum-exp; (b) both variants' times beside the plain versions',
   SDPA's backward and the bound; (c) ``launch/train.py``'s
   ``main`` on Zamba2-1.2B at the published widths and depth,
   LM_TRAIN_STEPS steps of LM_TRAIN_BATCH x LM_TRAIN_SEQ tokens, the
   counters read after every step (6 + 6 flash, 38 + 38 SSD launches,
   every backward launch wgmma),
   losses finite and falling; step wall, device time, events, idle share
   and peak memory; (d) a repeated step bitwise; (e) a 7-layer model's
   loss and gradients on the card against the CPU port within
   LM_LOSS_RTOL / LM_GRAD_RTOL, another batch's gradients outside;
15b. the partitioned dense path (``phase_dense_partition``):
   Zamba2-1.2B at full width in bf16, B 4 x S 1,024, laid out by
   ``shard_params`` / ``shard_batch`` on a one-rank NCCL ("data",
   "model") (1, 1) mesh, against the unpartitioned path from the same
   weights: the loss and every gradient, the prefill logits and one
   AdamW step bitwise; the flash and SSD launches, forward and backward,
   equal each way (path ``dense_partition``); the training step's wall,
   device time, idle share and peak memory each way;
15c. decode under the inference layout (``phase_decode_partition``):
   Zamba2-1.2B at full width in bf16 placed by ``shard_params(inference=
   True)`` on the one-rank mesh, a prefill of 4 x 1,024 tokens (its state
   laid out by ``shard_decode_state``) and 32 greedy steps against the
   unpartitioned path: every step's logits and the final state bitwise,
   the flash and SSD launches equal each way (path
   ``decode_partition``); each way's decode-step wall, device time, idle
   share and peak memory;
15d. the MoE architecture partitioned (``phase_moe_partition``):
   DBRX-132B at its published widths and 2 blocks, bf16, on the
   one-rank mesh against today's expert-parallel path on whole
   parameters: a prefill of 128 tokens and 8 greedy ``moe_ep2d`` steps
   in the inference layout, then ``moe_ep``'s ``loss_and_grads`` at
   4 x 1,024 tokens in the training layout, every logit, the state, the
   loss and every gradient bitwise, the grouped matmul's and flash's
   launches (forward and backward) equal (path ``moe_partition``); each
   way's step and decode-step wall and device time; one AdamW step on the
   reduced config, placed against whole, bitwise;
16. the encoder-decoder (``phase_whisper``): whisper-base at its
   published widths and depth (6 + 6 layers, d_model 512, 8 heads of 64,
   vocab 51,865, bf16): (a) the ``serve`` CLI twice (batch 4, 1,500
   frames, 8 prompt tokens, 32 new), tokens bitwise, 6 non-causal + 6
   causal flash launches (all wgmma) a prefill and none in decode; (b)
   prefill and decode steps against ``decode_train`` at decoder prompts
   of 8, 448 and 460 tokens within LM_BF16_RTOL, a zero cache outside;
   (c) flash on the prefill's own encoder (non-causal, S 1,500) and
   decoder inputs against the plain version, timed beside SDPA and the
   bound; (d) the flash backward at the training step's encoder and
   decoder shapes, both variants, with planted faults; (e) ``launch/
   train.py``'s ``main`` for 20 steps of 8 x 1,500 frames and 448 tokens,
   12 + 12 flash launches a step (backward all wgmma), the loss falling,
   a repeated step bitwise; (f) 2 + 2 layers against the CPU port;
17. the port's examples (``phase_examples``): examples/torch_{quickstart,
   cutpoint_sweep,dit_backbone,train_lm}.py at the reference's numbers
   on the card, counters zeroed just before and read just after (path
   ``examples``): the keyed DDPM step, the SSD scan's and flash
   attention's forward and backward kernels each launched, outputs
   finite;
18. the card check of the meta route (``phase_meta_check``): Zamba2-1.2B
   at full width, B 1 x S 1,024, its parameter and AdamW bytes on the
   card within META_BYTES_RTOL of ``dryrun.reckon``'s, one training
   step's saved-tensor bytes and FLOPs (``FlopCounterMode`` plus
   ``kernels.FLOPS``) equal to the meta run's; then one Alg.-1 step of
   the collab dry run's U-Net at META_CHECK_UNET (group norm and the
   cached output shapes of ``dryrun.StepCounters``), its saved bytes and
   FLOPs on the card equal to the meta run's; and the partitioned step
   at META_PARTITION_SHAPE on a one-rank NCCL (1, 1) mesh, its saved
   bytes and FLOPs equal to ``reckon``'s over a fake (1, 1) mesh.  It
   compares counts and times nothing the records read, so the dry runs
   run beside it;
19. the dry runs (``start_dryrun`` / ``phase_dryrun``), started just
   before phase 18, both at once, each in a process of its own on the
   CPU with no card visible (output in experiments/dryrun_torch/):
   launch/dryrun.py ``--all`` on the fake single-pod mesh, every pair
   that ``skip_reason`` runs ``OK`` and every other ``SKIP`` with its
   reason, and launch/collab_dryrun.py at COLLAB_DRYRUN_ARGS writing its
   six programs;
20. a ``kernels`` JSON line (eleven kernels, ``launches_by_path`` over
   the sixteen paths), the card line again, and the result line.

Exits nonzero, printing no result line, without a CUDA device or outside
a checkout.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
    print("chip_smoke: src/repro_torch not found; run from the root of a "
          "checkout", file=sys.stderr)
    sys.exit(2)
sys.path.insert(0, str(ROOT / "src"))
# the card's rates and each kernel's work: one source, the package's
from repro_torch.kernels.ddpm_step import cost as ddpm_cost  # noqa: E402
from repro_torch.kernels.flash_attention import cost as fa_cost  # noqa: E402
from repro_torch.kernels.grouped_matmul import cost as gmm_cost  # noqa: E402
from repro_torch.kernels.mamba_mixer import cost as mixer_cost  # noqa: E402
from repro_torch.kernels.ssd_scan import cost as ssd_cost  # noqa: E402
from repro_torch.launch import mesh as card  # noqa: E402
TOL_BF16 = dict(atol=5e-2, rtol=5e-2)   # the JAX package's kernel tolerance
TOL_FLASH = dict(atol=2e-5, rtol=2e-3)  # tests/test_kernels.py TOL (fp32)
TOL_SSD = dict(atol=1e-4, rtol=1e-3)    # tests/test_kernels.py ssd (fp32)
# bf16 SSD at the DiT's shape: the plain version rounds five intermediates
# (C·B, the decay, dt·x, e^L, the carried state) to bf16, so its error
# grows with |y|; the kernel keeps them in float32.  TOL_BF16's atol scaled
# to the output's range: max |kernel - plain| <= 5e-2 * max(1, max |plain|).
SSD_BF16_RANGE = 5e-2
BF16_FLOPS_PER_S = card.PEAK_FLOPS_BF16
FP32_ULPS = 1          # kernel vs plain in fp32 (the kernel forbids FMAs)
# the keyed variants vs their plain composition in fp32: bitwise (the
# draw is prng.py's threefry, erfinvf is the function torch.erfinv calls)
KEYED_FP32_ULPS = 0
UNET_RTOL = 1e-4       # card vs CPU forward, relative to max |output|
HBM_BYTES_PER_S = card.HBM_BW
FP32_FLOPS_PER_S = card.PEAK_FLOPS_FP32
# that rate counts an FMA as two flops: a single fmul or fadd (the DDPM
# step forbids FMAs) runs at half of it, 128 results an SM a clock
FP32_INSTR_PER_S = FP32_FLOPS_PER_S / 2
# 32-bit integer add, xor, shift and funnel shift: 64 results an SM a
# clock on compute capability 9.0 (CUDA C++ Programming Guide, table of
# arithmetic instruction throughput), a quarter of the fp32 flop rate
INT32_OPS_PER_S = FP32_FLOPS_PER_S / 4
IMG = (32, 32, 3)
B = 4
MAIN_REQUESTS = 2           # the U-Net serve path's requests a pass (cut
                            # from 3 to keep the script in its limit:
                            # PERF.md section 4)
DIT_ARCH = "zamba2-1.2b"
FLASH_SWEEP = [(2, 4, 2, 64, 32), (1, 4, 4, 100, 16), (2, 8, 2, 128, 64),
               (1, 2, 1, 48, 8)]          # test_flash_attention_sweep
FLASH_WINDOWS = [8, 24, 64]               # test_flash_attention_window
# wgmma at head dim 128 over two K/V tiles; three tiles, with a window
FLASH_WGMMA = [((2, 6, 2, 100, 128), 0), ((1, 2, 1, 200, 64), 0),
               ((1, 2, 1, 200, 64), 70)]
SSD_SWEEP = [(2, 64, 4, 16, 8, 16), (1, 48, 2, 8, 4, 16),
             (2, 100, 3, 16, 8, 32), (1, 32, 1, 4, 4, 8)]  # test_ssd_scan_sweep
# bf16 shapes of the SSD wgmma variant (p 64, n 64 or 128): tiles with a
# tail, chunk 256 at n 128, a chunk below the 64-step tile, head counts
# that its two-head blocks do not divide.  Held to SSD_BF16_RANGE: at
# p = 64 the plain version's own bf16 roundings exceed TOL_BF16
# elementwise (tests/test_torch_ssd_variants.py)
SSD_WGMMA = [(2, 200, 4, 64, 64, 64), (1, 256, 3, 64, 128, 256),
             (2, 64, 5, 64, 64, 16), (1, 130, 3, 64, 128, 32)]
# the DiT main path: one per-request sample and one serve pass at cut
# T's: the full-width forward is 46-86 ms of host-bound eager launches
# (H100 hosts differ by 2x), so a T=1000 pass with its reference would
# take ~10 min; the sample was at T=1000 and the pass at T=120 until the
# LM training phase joined the script (whole runs reached 1,083 s of the
# 1,200 s limit on a slow host), then T=500 and T=60, and the sample at
# T=250 since the partitioned path joined (a slow host had run 1,163 s
# before the dry runs ended)
DIT_SAMPLE_T, DIT_SAMPLE_CUT = 250, 125
DIT_T = 60                      # the serve pass's T
DIT_CUTS = [8, 15, 30]          # its three clients' cuts (T/8, T/4, T/2)
GMM_SWEEP = [(4, 32, 64, 48), (2, 100, 50, 70), (8, 16, 16, 16),
             (1, 7, 9, 11)]     # test_grouped_matmul_sweep (E, C, D, F)
# the wgmma variant over two C-tiles, and with F not a multiple of 192;
# the capacity-packed C of the expert-parallel DiT (80, below the 256-row
# tile) and LM (1,280), and the dense LM's C 4,096 (16 tiles)
GMM_WGMMA = [(2, 200, 512, 384), (2, 300, 128, 200), (2, 80, 256, 192),
             (2, 1280, 64, 128), (1, 4096, 64, 64)]
TOL_GMM = dict(atol=1e-4, rtol=1e-3)      # that test's fp32 tolerance
# the MoE path: DBRX-132B at its published widths, 40 blocks cut to 2 so
# that four models (server + 3 clients, 13.19 GB each in bf16) fit the
# card's 80 GB; three blocks each would take 78.8 GB
MOE_ARCH, MOE_LAYERS = "dbrx-132b", 2
# the MoE training path (phase_moe_train): the grouped matmul's backward
# at DBRX's expert shapes (E 16, D 6,144, F 10,752; the gate/up product),
# one case per C the paths feed it: (what, C, tokens broadcast to every
# expert); the dense DiT (B 4 x 64 tokens), the expert-parallel DiT's
# capacity int(4 * 256 / 16 * 1.25) = 80, the expert-parallel LM's
# int(4 * 4096 / 16 * 1.25) = 1,280 and the dense LM's 4 x 1,024 tokens
GMM_BWD_CASES = [("dense DiT", 256, True), ("EP DiT", 80, False),
                 ("EP LM", 1280, False), ("dense LM", 4096, True)]
# from this C on, where the operations bind, the backward's wgmma variant
# must take at most half the time of the older wmma design at DBRX's
# shapes; the small bf16 case whose misaligned token pointer keeps the
# wmma variant held against its plain version: (E, C, D, F)
GMM_BWD_HALF_FROM_C = 1280
GMM_BWD_MISALIGNED = (4, 100, 136, 200)
# one full-width MoE layer's tokens through moe_ep / moe_ep2d against
# moe_dense: capacity factor 8 drops nothing (the grouped matmul's bf16
# limit, PERF.md section 6), the configured 1.25 drops some
MOE_EP_TOKENS, MOE_EP_RTOL, MOE_EP_ROOMY = 256, 0.0312, 8.0
# the LM: 2 of DBRX-132B's 40 blocks at the published widths, bf16, B x
# S = 4 x 1,024 (train_4k's 4,096 cut as phase 15's), loss and
# gradients (two float32 AdamW states would not fit: PERF.md section 4);
# the reduced config's CLI and gradients against the CPU port
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_PEAK_GB = 4, 1024, 72.0
MOE_GRAD_SEQ = 64
# the flash backward at DBRX's attention shape (48 query / 8 KV heads of
# 128, causal) at the LM step's batch and length
FLASH_BWD_DBRX = ((MOE_TRAIN_BATCH, 48, 8, MOE_TRAIN_SEQ, 128), True)
# the training path: Alg. 1 with six CONFIG U-Nets (paper §4: 5 clients),
# 2 batches of 8 per client, one round of 10 steps at cut 250 of T=1000
TRAIN_CLIENTS, TRAIN_CUT, TRAIN_BATCH, TRAIN_BATCHES = 5, 250, 8, 2
# card vs CPU after the round: the JAX package's fp32 TOL elementwise on
# params and both moments (summation orders of cuDNN/cuBLAS vs the CPU's
# and the erfinv ulps of the noise, through at most 10 AdamW steps); each
# moment leaf also within TRAIN_MOMENT_RTOL of its own largest value (the
# moments lie far below TOL's atol: m ~ 1e-4, v ~ 1e-9); the per-step
# losses and grad norms relative to max(1, |value|).  A control round on
# the card with TF32 allowed must fall outside these limits.
TRAIN_TOL = dict(atol=2e-5, rtol=2e-3)
TRAIN_MOMENT_RTOL = 2e-3
# the training runtime: the same six CONFIG U-Nets and batches under
# bernoulli participation p 0.8 with mid-round dropout 0.1, FedAvg every 2
# rounds, server EMA 0.99, 4 rounds from base key PRNGKey(RT_SEED): seed 1
# seats cohorts of 5, 5, 5 and 4 clients (tiers 8, 8, 8, 4; rounds 1-3
# drop members at slots 0 and 1), so pad slots and a strict subset both
# occur; the DP run clips at 1.0 with noise multiplier 0.8
RT_ROUNDS, RT_P, RT_DROP, RT_FEDAVG, RT_EMA, RT_SEED = 4, 0.8, 0.1, 2, 0.99, 1
RT_DP = dict(clip=1.0, noise_multiplier=0.8)
TRAIN_METRIC_RTOL = 1e-4
# the backward kernels replace no TPU kernel (the JAX package
# differentiates plain XLA code): each names the Pallas kernel of the
# function it differentiates; nor do the Mamba2 mixer's glue kernels (XLA
# fuses that glue): they name the JAX function whose glue they take over
REPLACES = {"ddpm_step": "src/repro/kernels/ddpm_step/kernel.py:43",
            "ddpm_step_batched": "src/repro/kernels/ddpm_step/kernel.py:85",
            "flash_attention": "src/repro/kernels/flash_attention/kernel.py:76",
            "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:69",
            "grouped_matmul": "src/repro/kernels/grouped_matmul/kernel.py:39",
            "flash_attention_bwd":
                "src/repro/kernels/flash_attention/kernel.py:76",
            "ssd_scan_bwd": "src/repro/kernels/ssd_scan/kernel.py:69",
            "grouped_matmul_bwd":
                "src/repro/kernels/grouped_matmul/kernel.py:39",
            "mamba_conv_silu": "src/repro/models/ssm.py:151",
            "mamba_rmsnorm": "src/repro/models/ssm.py:171",
            "mamba_rmsnorm_gated": "src/repro/models/ssm.py:171"}
SOURCES = {"ddpm_step": "ddpm_step.cu", "ddpm_step_batched": "ddpm_step.cu",
           "flash_attention": "flash_attention.cu",
           "ssd_scan": "ssd_scan.cu", "grouped_matmul": "grouped_matmul.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu",
           "ssd_scan_bwd": "ssd_scan_bwd.cu",
           "grouped_matmul_bwd": "grouped_matmul_bwd.cu",
           "mamba_conv_silu": "mamba_mixer.cu",
           "mamba_rmsnorm": "mamba_mixer.cu",
           "mamba_rmsnorm_gated": "mamba_mixer.cu"}
MIXER_KERNELS = ("mamba_conv_silu", "mamba_rmsnorm", "mamba_rmsnorm_gated")
KERNELS = ("ddpm_step_batched", "ddpm_step", "flash_attention", "ssd_scan",
           "grouped_matmul", "flash_attention_bwd", "ssd_scan_bwd",
           "grouped_matmul_bwd") + MIXER_KERNELS


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    sources = sorted(p.name for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as ex:
        results = list(ex.map(build.load, sources))
    wall = time.perf_counter() - t0
    for src, (_, secs, nvcc_log) in zip(sources, results):
        regs = [l.strip() for l in nvcc_log.splitlines()
                if "registers" in l or "spill" in l]
        log(f"build/{src}: nvcc {secs:.2f} s")
        for l in regs:
            log(f"  {l}")
    log(f"build/wall_s: {wall:.2f}")
    return wall


def _ulps(a, b):
    """Largest distance in units of the last place of a's type (float32
    or bfloat16) between two tensors of that type."""
    import torch
    word = torch.int32 if a.element_size() == 4 else torch.int16
    return int((a.view(word).long() - b.view(word).long())
               .abs().max().item())


def _bound(nbytes: float, flops: float, flops_per_s: float):
    """(least time in ms, "bytes" or "operations") on this card."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _rate(dtype) -> float:
    import torch
    return BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S


def flash_bound(q, k, causal: bool, window: int):
    """Flash attention's forward (kernels/flash_attention/cost.py)."""
    return _bound(*fa_cost.cost(q.shape, k.shape, causal, window,
                                q.element_size()), _rate(q.dtype))


def ssd_bound(x, Bm, chunk: int):
    """The SSD scan's forward (kernels/ssd_scan/cost.py)."""
    return _bound(*ssd_cost.cost(x.shape, Bm.shape[-1], chunk,
                                 x.element_size()), _rate(x.dtype))


def flash_bwd_bound(q, k, causal: bool, window: int):
    """Flash attention's backward (kernels/flash_attention/cost.py)."""
    return _bound(*fa_cost.cost_backward(q.shape, k.shape, causal, window,
                                         q.element_size()), _rate(q.dtype))


def ssd_bwd_bound(x, Bm, chunk: int):
    """The SSD scan's backward (kernels/ssd_scan/cost.py)."""
    return _bound(*ssd_cost.cost_backward(x.shape, Bm.shape[-1], chunk,
                                          x.element_size()), _rate(x.dtype))


def gmm_bound(E: int, C: int, D: int, F: int, itemsize: int,
              shared_tokens: bool):
    """(least time in ms, what binds it) of a grouped matmul on this
    card; bf16 (itemsize 2) at the tensor rate, float32 at the CUDA-core
    rate."""
    return _bound(*gmm_cost.cost(E, C, D, F, itemsize, shared_tokens),
                  BF16_FLOPS_PER_S if itemsize == 2 else FP32_FLOPS_PER_S)


def gmm_bwd_bound(E: int, C: int, D: int, F: int, itemsize: int,
                  shared_tokens: bool):
    """(least time in ms, what binds it) of the grouped matmul's backward
    on this card, rated as ``gmm_bound``."""
    return _bound(*gmm_cost.cost_backward(E, C, D, F, itemsize,
                                          shared_tokens),
                  BF16_FLOPS_PER_S if itemsize == 2 else FP32_FLOPS_PER_S)


def kernels_line(records, launches, by_path=None):
    """The ``kernels`` JSON object: one entry per kernel with its route,
    source, the TPU kernel it replaces, its main-path launches and the
    numbers measured in this run, with its card time (from a profile of
    the path) where measured.  With ``by_path`` ({path: launches}) each
    entry also carries its launches per main path.  A kernel with
    variants also carries its
    launches per variant (``launches`` keys ``<name>/<variant>``); flash
    attention its numbers at head dim 128 as well, flash and the SSD scan
    their numbers at the LM prefill's shapes (``lm_prefill``), flash and
    its backward at whisper's encoder (non-causal) and decoder shapes
    (``whisper_encoder``, ``whisper_decoder``), the SSD
    scan the simt variant's time at the path's shape, the two DDPM
    entries (whose main numbers are the keyed variants') the composed
    step they replace and the given-noise variant's numbers, the
    backward kernels their shape and device events a launch, flash's
    backward its numbers at DBRX's attention (``dbrx_train``), the
    grouped matmul its forward at the capacity-packed and dense LM's C
    (``capacity_shapes``) and its backward every shape of
    GMM_BWD_CASES (``shapes``)."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    extra = ("card_ms", "simt_ms", "head_dim_128", "lm_prefill",
             "whisper_encoder", "whisper_decoder", "dbrx_train", "shapes",
             "capacity_shapes",
             "op_ms", "composed_ms", "composed_card_ms", "composed_events",
             "keyed_card_ms", "keyed_events", "given", "shape", "chunk",
             "card_events", "row_gap", "row_limit", "faults",
             "simt_row_gap", "simt_faults")
    line = []
    for name in KERNELS:
        entry = dict(name=name, route="cuda",
                     source=f"src/repro_torch/csrc/{SOURCES[name]}",
                     replaces=REPLACES[name], launches=launches[name],
                     **{k: records[name].get(k) for k in keys})
        by_variant = {k.split("/", 1)[1]: n for k, n in launches.items()
                      if k.startswith(name + "/")}
        if by_variant:
            entry["launches_by_variant"] = by_variant
        if by_path is not None:
            entry["launches_by_path"] = {p: n.get(name, 0)
                                         for p, n in by_path.items()}
        entry.update({k: records[name][k] for k in extra
                      if k in records[name]})
        line.append(entry)
    return {"kernels": line}


def phase_kernels():
    """Kernel vs plain on the card; returns per-entry records at the
    serve path's shapes."""
    import torch
    from repro_torch.core.schedules import DiffusionSchedule
    from repro_torch.kernels.ddpm_step import kernel, ops
    from repro_torch.kernels.ddpm_step.ref import ddpm_step_ref

    sched = DiffusionSchedule.linear(100, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    per_main = B * IMG[0] * IMG[1] * IMG[2]
    batched_shapes = [(5, 4, 8, 8, 3), (3, 2, 37), (1, 129),
                      (1, per_main), (2, per_main), (4, per_main)]
    scalar_shapes = [(4, 16, 16, 3), (2, 8, 8, 1), (1, 37), (B,) + IMG]
    records = {}

    def inputs(shape, dtype):
        return [torch.randn(shape, generator=g, device="cuda").to(dtype)
                for _ in range(3)]

    def check(out, ref, dtype, what):
        err = (out.float() - ref.float()).abs().max().item()
        if dtype == torch.float32:
            u = _ulps(out, ref)
            if u > FP32_ULPS:
                raise AssertionError(f"{what}: {u} ulps > {FP32_ULPS}")
        elif not torch.allclose(out.float(), ref.float(), **TOL_BF16):
            raise AssertionError(f"{what}: max abs {err} beyond TOL_BF16")
        return err

    def bound_ms(K, per, itemsize):
        return _bound(*ddpm_cost.cost(K, per, itemsize), FP32_INSTR_PER_S)

    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for shape in batched_shapes:
            K = shape[0]
            x, e, n = inputs(shape, dtype)
            t = torch.linspace(1.0, 99.0, K, device="cuda")
            tp = torch.clamp(t - 1.5, min=0.0)
            out = ops.ddpm_step_batched(x, e, n, sched, t, tp)
            a, c, s = ops.step_coefficients(sched, t, tp)
            bs = (K,) + (1,) * (len(shape) - 1)
            a, c, s = a.reshape(bs), c.reshape(bs), s.reshape(bs)
            ref = ddpm_step_ref(x, e, n, a, c, s)
            err = check(out, ref, dtype, f"batched {shape} {tag}")
            for k in range(K):        # each slab equals the scalar kernel
                row = ops.ddpm_step(x[k], e[k], n[k], sched, t[k], tp[k])
                if not torch.equal(row, out[k]):
                    raise AssertionError(f"slab {k} of {shape} {tag} != "
                                         "scalar kernel")
            coef = torch.stack([a.reshape(K), c.reshape(K), s.reshape(K)],
                               dim=1).contiguous()
            ms = time_ms(lambda: kernel.launch(x, e, n, coef,
                                               "ddpm_step_batched"))
            wrap = time_ms(lambda: ops.ddpm_step_batched(x, e, n, sched, t,
                                                         tp))
            plain = time_ms(lambda: ddpm_step_ref(x, e, n, a, c, s))
            per = x[0].numel()
            bnd, by = bound_ms(K, per, x.element_size())
            log(f"kernel/ddpm_step_batched {shape} {tag}: max_abs_err "
                f"{err:.3g} kernel {ms * 1e3:.2f} us (with coefficients "
                f"{wrap * 1e3:.2f} us) plain {plain * 1e3:.2f} us bound "
                f"{bnd * 1e3:.3f} us ({by})")
            if dtype == torch.float32 and shape == (4, per_main):
                records["ddpm_step_batched"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                    bound_by=by)
        for shape in scalar_shapes:
            x, e, n = inputs(shape, dtype)
            out = ops.ddpm_step(x, e, n, sched, 50.5)
            a, c, s = ops.step_coefficients(sched, 50.5)
            ref = ddpm_step_ref(x, e, n, a, c, s)
            err = check(out, ref, dtype, f"scalar {shape} {tag}")
            coef = torch.stack([a, c, s]).reshape(1, 3)
            ms = time_ms(lambda: kernel.launch(x, e, n, coef, "ddpm_step"))
            wrap = time_ms(lambda: ops.ddpm_step(x, e, n, sched, 50.5))
            plain = time_ms(lambda: ddpm_step_ref(x, e, n, a, c, s))
            bnd, by = bound_ms(1, x.numel(), x.element_size())
            log(f"kernel/ddpm_step {shape} {tag}: max_abs_err {err:.3g} "
                f"kernel {ms * 1e3:.2f} us (with coefficients "
                f"{wrap * 1e3:.2f} us) plain {plain * 1e3:.2f} us bound "
                f"{bnd * 1e3:.3f} us ({by})")
            if dtype == torch.float32 and shape == (B,) + IMG:
                records["ddpm_step"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                    bound_by=by)
    log("kernel/library_ms: null (no single PyTorch call computes "
        "(x - c*e)*a + s*n)")
    return records


def keyed_bound(elements: int, itemsize: int, derivations: int,
                extra_bytes: int, passed: int = 0):
    """(least time in ms, what binds it) of a keyed DDPM step on this card:
    x and eps read and the output written for the ``elements`` that step,
    x read and written for the ``passed`` ones of masked slabs, plus keys,
    coefficients and mask (``extra_bytes``); against the draw's
    operations (kernels/ddpm_step/cost.py): its integer ones
    (``DRAW_INT_OPS`` an element and a Threefry block per key
    ``derivations``) at INT32_OPS_PER_S, or all of them, float ones
    (``DRAW_FLOAT_OPS`` an element) included, at one a lane a clock
    (FP32_INSTR_PER_S), whichever takes longer.  Counted in integer
    slots: FP32_INSTR_PER_S is twice INT32_OPS_PER_S."""
    nbytes, int_ops, flops = ddpm_cost.cost_keyed(
        elements, itemsize, derivations, extra_bytes, passed)
    all_ops = int_ops + flops
    slots = max(int_ops, all_ops * INT32_OPS_PER_S / FP32_INSTR_PER_S)
    return _bound(nbytes, slots, INT32_OPS_PER_S)


def phase_keyed(records):
    """Phase 3, the keyed variants: coefficient tables against per-step
    calls and both keyed variants against their plain composition on the
    card, bitwise in float32, then each beside the composed step it
    replaces (draw, per-step coefficients, the given-noise launch and, in
    the engine, where(active)) at the main path's shapes.  Replaces the
    two DDPM records by the keyed variants' numbers, with the given
    variant's under ``given``."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.protocol import rowwise_normal
    from repro_torch.core.schedules import DiffusionSchedule
    from repro_torch.core.splitting import CutPoint
    from repro_torch.kernels import raw_stream
    from repro_torch.kernels.ddpm_step import kernel, ops
    from repro_torch.kernels.ddpm_step.ref import (ddpm_step_keyed_ref,
                                                   ddpm_step_rowwise_ref)

    sched = DiffusionSchedule.linear(1000, device="cuda")
    for cut in (250, 0, 999):
        cp = CutPoint(1000, cut)
        tables = [(torch.from_numpy(cp.server_t_list()).float(), None)] + [
            tuple(torch.from_numpy(a) for a in cp.client_step_table(adj))
            for adj in (True, False)]
        for t, tp in tables:
            t = t.cuda()
            tp = None if tp is None else tp.cuda()
            table = ops.step_coefficient_table(sched, t, tp)
            for i in range(t.shape[0]):
                one = torch.stack(ops.step_coefficients(
                    sched, t[i], None if tp is None else tp[i]))
                if not torch.equal(table[i].view(torch.int32),
                                   one.view(torch.int32)):
                    raise AssertionError(f"keyed: coefficient table row {i}"
                                         f" at cut {cut} != per-step call")
    log("keyed/coefficient_tables: bitwise equal to per-step calls (T=1000,"
        " cuts 250/0/999, server and client, adjusted on and off)")

    # every launch passes kernels.raw_stream (a private torch call): it
    # must name the current stream, also a side stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        if raw_stream(0) != torch.cuda.current_stream(0).cuda_stream:
            raise AssertionError("kernels.raw_stream is not the current "
                                 "stream's handle")
    if raw_stream(0) != torch.cuda.current_stream(0).cuda_stream:
        raise AssertionError("kernels.raw_stream is not the default "
                             "stream's handle")
    log(f"keyed/raw_stream: the current stream's handle (torch "
        f"{torch.__version__})")

    g = torch.Generator(device="cuda").manual_seed(2)
    tt = torch.tensor([999.0, 500.5, 250.0, 2.0, 1.0], device="cuda")
    rows = ops.step_coefficient_table(sched, tt)

    def inputs(shape, dtype):
        return [torch.randn(shape, generator=g, device="cuda").to(dtype)
                for _ in range(2)]

    def check(out, ref, dtype, what):
        err = (out.float() - ref.float()).abs().max().item()
        if dtype == torch.float32:
            u = _ulps(out, ref)
            if u > KEYED_FP32_ULPS:
                raise AssertionError(f"{what}: {u} ulps > {KEYED_FP32_ULPS}")
        elif not torch.allclose(out.float(), ref.float(), **TOL_BF16):
            raise AssertionError(f"{what}: max abs {err} beyond TOL_BF16")
        else:
            u = _ulps(out, ref)
        return err, u

    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        # (EVAL_N,) + IMG: the eval path's shared-handoff samples
        for shape in [(B,) + IMG, (EVAL_N,) + IMG, (4, 16, 16, 3),
                      (2, 8, 8, 1), (1, 37), (3, 129)]:
            x, e = inputs(shape, dtype)
            key = prng.PRNGKey(7, device="cuda")
            buf = torch.empty_like(key)
            worst = (0.0, 0)
            for i in range(rows.shape[0]):        # a chain of keyed steps
                out = ops.ddpm_step_keyed(x, e, key, rows[i], buf)
                ref, k = ddpm_step_keyed_ref(x, e, key, rows[i])
                if not torch.equal(buf, k):
                    raise AssertionError(f"keyed {shape} {tag}: output key "
                                         "!= split(k)[0]")
                worst = max(worst, check(out, ref, dtype,
                                         f"keyed {shape} {tag} step {i}"))
                x, key, buf = out, buf, key
            log(f"kernel/ddpm_step keyed {shape} {tag}: max_abs_err "
                f"{worst[0]:.3g} ({worst[1]} ulps) over {rows.shape[0]} "
                "chained steps; output key bitwise")
        for shape in [(4, B) + IMG, (1, B) + IMG, (2, B) + IMG,
                      (5, 4, 8, 8, 3), (3, 2, 37), (1, 1, 129)]:
            K = shape[0]
            x, e = inputs(shape, dtype)
            t = torch.linspace(1.0, 999.0, K * 3, device="cuda")
            table = ops.step_coefficient_table(
                sched, t.reshape(K, 3), torch.clamp(t - 1.5, min=0.0)
                .reshape(K, 3))
            active = (torch.arange(K * 3, device="cuda") % 4 != 1).float() \
                .reshape(K, 3)
            keys = prng.split(prng.PRNGKey(3, device="cuda"), K)
            worst = (0.0, 0)
            for s in range(3):
                out = ops.ddpm_step_rowwise(x, e, keys, 1 + s, table[:, s],
                                            active[:, s])
                ref = ddpm_step_rowwise_ref(x, e, keys, 1 + s, table[:, s],
                                            active[:, s])
                worst = max(worst, check(out, ref, dtype,
                                         f"rowwise {shape} {tag} step {s}"))
                x = out
            log(f"kernel/ddpm_step_batched rowwise {shape} {tag}: "
                f"max_abs_err {worst[0]:.3g} ({worst[1]} ulps) over 3 "
                "steps, masked slabs included")

    # the keyed launches beside the composed steps they replace, float32 at
    # the main path's shapes: (B, 32, 32, 3) per request, K = 4 slabs
    shape = (B,) + IMG
    x, e = inputs(shape, torch.float32)
    n = torch.randn(shape, generator=g, device="cuda")
    key = prng.PRNGKey(9, device="cuda")
    buf = torch.empty_like(key)
    t0 = tt[1]
    row = rows[1]
    coef13 = row.reshape(1, 3).contiguous()

    def composed():
        _, kn = prng.split(key)
        return ops.ddpm_step(x, e, prng.normal(kn, shape), sched, t0)

    out = ops.ddpm_step_keyed(x, e, key, row, buf)
    err = (out - ddpm_step_keyed_ref(x, e, key, row)[0]).abs().max().item()
    rec = dict(
        max_abs_err=err,
        ms=time_ms(lambda: kernel.launch_keyed(x, e, key, row, buf)),
        op_ms=time_ms(lambda: ops.ddpm_step_keyed(x, e, key, row, buf)),
        plain_ms=time_ms(lambda: ddpm_step_keyed_ref(x, e, key, row),
                         iters=50),
        composed_ms=time_ms(composed, iters=50),
        library_ms=None)
    rec["bound_ms"], rec["bound_by"] = keyed_bound(
        x.numel(), 4, 2, 2 * 16 + 12)
    given = dict(records["ddpm_step"],
                 launch_ms=time_ms(lambda: kernel.launch(
                     x, e, n, coef13, "ddpm_step")))
    comp = device_ms("keyed/composed_step", composed, n=20, per="step",
                     shares=["ddpm_step"])
    mine = device_ms("keyed/keyed_step", lambda: (
        ops.ddpm_step_keyed(x, e, key, row, buf), e.neg()), n=20,
        per="step (with one marker op)", shares=["ddpm_step"])
    rec.update(composed_card_ms=comp["_ms"], composed_events=comp["_events"],
               keyed_card_ms=mine["ddpm_step"],
               keyed_events=mine["ddpm_step/events"], given=given)
    log(f"kernel/ddpm_step keyed {shape} fp32: launch {rec['ms'] * 1e3:.2f}"
        f" us (op {rec['op_ms'] * 1e3:.2f} us; given-noise launch "
        f"{given['launch_ms'] * 1e3:.2f} us) plain {rec['plain_ms'] * 1e3:.1f}"
        f" us composed step {rec['composed_ms'] * 1e3:.1f} us bound "
        f"{rec['bound_ms'] * 1e3:.4f} us ({rec['bound_by']}); card: composed "
        f"{fmt_ms(comp['_ms'])} over {comp['_events']} events, keyed "
        f"{fmt_ms(mine['ddpm_step'])} over {mine['ddpm_step/events']} "
        "events (profiler)")
    records["ddpm_step"] = rec

    K = 4
    xs, es = inputs((K,) + shape, torch.float32)
    ns = torch.randn((K,) + shape, generator=g, device="cuda")
    keys = prng.split(prng.PRNGKey(5, device="cuda"), K)
    tk = torch.linspace(2.0, 500.0, K, device="cuda")
    table = ops.step_coefficient_table(sched, tk.reshape(K, 1),
                                       (tk - 1.0).reshape(K, 1))
    act = torch.ones(K, 1, device="cuda")
    coefs, active = table[:, 0], act[:, 0]
    lead = (K,) + (1,) * len(shape)

    def composed_b():
        noise = rowwise_normal(prng.fold_in(keys, 3), shape)
        xn = ops.ddpm_step_batched(xs, es, noise, sched, tk, tk - 1.0)
        return torch.where(active.reshape(lead) > 0, xn, xs)

    out = ops.ddpm_step_rowwise(xs, es, keys, 3, coefs, active)
    err = (out - ddpm_step_rowwise_ref(xs, es, keys, 3, coefs, active)) \
        .abs().max().item()
    recb = dict(
        max_abs_err=err,
        ms=time_ms(lambda: kernel.launch_rowwise(xs, es, keys, 3, coefs,
                                                 active)),
        op_ms=time_ms(lambda: ops.ddpm_step_rowwise(xs, es, keys, 3, coefs,
                                                    active)),
        plain_ms=time_ms(lambda: ddpm_step_rowwise_ref(
            xs, es, keys, 3, coefs, active), iters=50),
        composed_ms=time_ms(composed_b, iters=50),
        library_ms=None)
    recb["bound_ms"], recb["bound_by"] = keyed_bound(
        xs.numel(), 4, K + K * B, K * (16 + 12 + 4))
    givenb = dict(records["ddpm_step_batched"],
                  launch_ms=time_ms(lambda: kernel.launch(
                      xs, es, ns, table[:, 0].contiguous(),
                      "ddpm_step_batched")))
    comp = device_ms("keyed/composed_batched_step", composed_b, n=20,
                     per="step", shares=["ddpm_step"])
    mine = device_ms("keyed/rowwise_step", lambda: (
        ops.ddpm_step_rowwise(xs, es, keys, 3, coefs, active), es.neg()),
        n=20, per="step (with one marker op)", shares=["ddpm_step"])
    recb.update(composed_card_ms=comp["_ms"],
                composed_events=comp["_events"],
                keyed_card_ms=mine["ddpm_step"],
                keyed_events=mine["ddpm_step/events"], given=givenb)
    log(f"kernel/ddpm_step_batched rowwise K={K} x {shape} fp32: launch "
        f"{recb['ms'] * 1e3:.2f} us (op {recb['op_ms'] * 1e3:.2f} us; "
        f"given-noise launch {givenb['launch_ms'] * 1e3:.2f} us) plain "
        f"{recb['plain_ms'] * 1e3:.1f} us composed step "
        f"{recb['composed_ms'] * 1e3:.1f} us bound "
        f"{recb['bound_ms'] * 1e3:.4f} us ({recb['bound_by']}); card: "
        f"composed {fmt_ms(comp['_ms'])} over {comp['_events']} events, "
        f"rowwise {fmt_ms(mine['ddpm_step'])} over "
        f"{mine['ddpm_step/events']} events (profiler)")
    records["ddpm_step_batched"] = recb
    return records


def phase_unet():
    """CONFIG U-Net: card vs CPU forward on the same weights; returns the
    card's forward wall time per call (ms)."""
    import numpy as np
    import torch
    from repro_torch.configs.ddpm_unet import CONFIG
    from repro_torch.core import prng
    from repro_torch.core.unet import UNet, init_unet, unet_param_count
    from repro_torch.device import deterministic_cuda

    deterministic_cuda()          # TF32 off, deterministic cuDNN (as serving)
    gpu = init_unet(prng.PRNGKey(0), CONFIG, device="cuda")
    cpu = UNet(CONFIG)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    log(f"unet/params: {unet_param_count(gpu)}")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B,) + IMG).astype(np.float32)
    t = rng.uniform(1.0, 1000.0, B).astype(np.float32)
    y = np.eye(CONFIG.n_classes, dtype=np.float32)[
        rng.integers(0, CONFIG.n_classes, B)]
    args = [torch.from_numpy(a) for a in (x, t, y)]
    with torch.no_grad():
        ref = cpu(*args)
        out = gpu(*[a.cuda() for a in args]).cpu()
        xs = [a.cuda() for a in args]
        fwd_ms = time_ms(lambda: gpu(*xs), iters=50, warmup=5)
    if not torch.isfinite(out).all():
        raise AssertionError("unet: non-finite output on the card")
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    log(f"unet/max_abs_err: {err:.3g} (max |out| {scale:.3g}, tolerance "
        f"{UNET_RTOL:g} x max |out|)")
    if err > UNET_RTOL * scale:
        raise AssertionError(f"unet card vs cpu: {err} > {UNET_RTOL}*{scale}")
    log(f"unet/forward_ms (B={B}, wall per call, eager): {fwd_ms:.3f}")
    device_ms("unet", lambda: gpu(*xs))
    return fwd_ms


def device_rows(rows):
    """The rows of a kineto ``key_averages()`` that are device activity
    (kernels, copies, sets).  A CPU op's row repeats, as its self device
    time, the time of the kernels it launched, so a sum over every row
    counts each such kernel twice; a kernel launched outside any torch op
    (the port's ctypes kernels) has only its device row."""
    from torch.autograd import DeviceType
    return [e for e in rows if e.device_type == DeviceType.CUDA and
            not getattr(e, "is_user_annotation", False)]


def device_ms(tag: str, fn, n: int = 5, top: int = 0, shares=(),
              per: str = "forward") -> dict:
    """Device time of one ``fn()`` (a ``per``) from torch.profiler (kernel
    time summed over n calls, per call) and, with ``top``, its largest
    device kernels,
    printed for the time breakdown; 'not measured' if the profiler
    reports no device time on this machine.  Returns, for each name in
    ``shares``, the device ms per call of the kernels whose name holds it
    and, under ``<name>/events``, their device events per call; under
    ``_ms`` and ``_events`` the totals per call (None if not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as p:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = device_rows(p.key_averages())
    total_us = sum(e.self_device_time_total for e in rows)
    parts = {}
    if total_us > 0:
        log(f"{tag}/device_ms per {per} (profiler): "
            f"{total_us / (n * 1e3):.3f} over "
            f"{sum(e.count for e in rows) / n:.0f} device events")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
            log(f"{tag}/device_top: {e.self_device_time_total / n:9.1f} us "
                f"per {per}, {e.count / n:5.0f} calls  {e.key[:70]}")
        parts["_ms"] = total_us / (n * 1e3)
        parts["_events"] = sum(e.count for e in rows) / n
        for name in shares:
            mine = [e for e in rows if name in e.key]
            part = sum(e.self_device_time_total for e in mine)
            parts[name] = part / (n * 1e3) if part > 0 else None
            parts[f"{name}/events"] = sum(e.count for e in mine) / n
            log(f"{tag}/device_share of {name}: {part / (n * 1e3):.4f} ms "
                f"per {per} over {parts[f'{name}/events']:.0f} device "
                f"events, {100 * part / total_us:.1f}%")
    else:
        log(f"{tag}/device_ms per {per}: not measured (profiler reported "
            "no device time)")
    keys = ["_ms", "_events"] + [k for name in shares
                                 for k in (name, f"{name}/events")]
    return {k: parts.get(k) for k in keys}


def phase_main_path(fwd_ms: float):
    """The serve path at full width; returns launches per kernel entry and
    the batched DDPM step's card ms a launch.
    ``fwd_ms`` is the U-Net's wall time per forward (phase 4)."""
    import numpy as np
    import torch
    from repro_torch.configs.ddpm_unet import CONFIG
    from repro_torch.core import prng
    from repro_torch.core.sampler import make_per_request_sampler
    from repro_torch.core.schedules import DiffusionSchedule
    from repro_torch.core.unet import init_unet, unet_apply
    from repro_torch.kernels.ddpm_step import kernel
    from repro_torch.kernels.ddpm_step.ops import (ddpm_step_rowwise,
                                                   step_coefficient_table)
    from repro_torch.launch.collab_serve import synth_queue
    from repro_torch.obs import ObsConfig
    from repro_torch.serve import ServeConfig, ServeRuntime

    # the paper's T and cuts; MAIN_REQUESTS requests of batch 4 a pass
    T, cuts, n_req, passes = 1000, [125, 250, 500], MAIN_REQUESTS, 2
    key = prng.PRNGKey(0, device="cuda")
    ks, *kc = prng.split(key, len(cuts) + 1)
    sp = init_unet(ks, CONFIG, "cuda")
    cp = [init_unet(k, CONFIG, "cuda") for k in kc]
    sched = DiffusionSchedule.linear(T, device="cuda")
    queue = synth_queue(np.random.default_rng(0), clients=len(cuts),
                        cuts=cuts, requests=n_req, batch=B,
                        n_classes=CONFIG.n_classes, zipf=1.1)
    rt = ServeRuntime(ServeConfig(T=T, image_shape=IMG, max_wave=4,
                                  policy="depth", cache=True),
                      sp, cp, unet_apply, sched, key,
                      obs=ObsConfig(enabled=True), device="cuda")
    sampler = make_per_request_sampler(sched, unet_apply, (B,) + IMG)
    y0 = torch.from_numpy(queue[0].y).cuda()
    torch.cuda.synchronize()

    steps = rt.registry.counter("scan_steps")
    steps0 = steps.value
    kernel.reset_counts()                        # --- main path starts
    reports, pass_steps = [], []
    for _ in range(passes):
        before = steps.value
        outs, rep = rt.process(queue)
        reports.append((outs, rep))
        pass_steps.append(steps.value - before)
    t0 = time.perf_counter()
    single = sampler(cuts[1])(sp, cp[1], prng.fold_in(key, 7), y0)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    launches = dict(kernel.COUNTS)               # --- main path ends
    n_steps = steps.value - steps0

    for p, (outs, rep) in enumerate(reports, 1):
        for o in outs:
            if tuple(o.shape) != (B,) + IMG or not torch.isfinite(o).all():
                raise AssertionError(f"pass {p}: bad output {tuple(o.shape)}")
        log(f"main/pass{p}: wall_s {rep['wall_s']:.3f} req_per_s "
            f"{rep['req_per_s']:.4f} samples_per_s "
            f"{rep['samples_per_s']:.4f} waves {rep['waves']} "
            f"server_calls_physical {rep['server_calls_physical']} "
            f"client_calls_physical {rep['client_calls_physical']} "
            f"cache_hits {rep['cache_hits']}")
    if reports[1][1]["cache_hits"] < 1:
        raise AssertionError("main: no cache hit in pass 2")
    if not torch.isfinite(single).all():
        raise AssertionError("main: per-request sample not finite")
    log(f"main/per_request_sample: T={T} cut {cuts[1]} wall_s "
        f"{single_s:.3f}")
    log(f"main/launches: {launches} scheduled batched steps {n_steps} "
        f"per-request steps {T}")
    if n_steps == 0:
        raise AssertionError("main: no batched step scheduled")
    check_ddpm_launches("main", launches, T, n_steps)

    # device events per per-request step: a short sample's profile (T=10,
    # cut 3: ten steps), beside the U-Net forward's events (phase 4)
    short = make_per_request_sampler(DiffusionSchedule.linear(
        10, device="cuda"), unet_apply, (B,) + IMG)(3)
    prof = device_ms("main/per_request_sample_T10", lambda: short(
        sp, cp[1], prng.fold_in(key, 8), y0), n=1, per="sample",
        shares=["ddpm_step"])
    if prof["_events"] is not None:
        log(f"main/per_request_step: {prof['_events'] / 10:.1f} device "
            f"events and {prof['_ms'] / 10:.4f} ms of device a step "
            "(profiler, T=10 sample; the forward's own in unet/device_ms)")

    # where a pass's time goes: the host's spans of its waves (planning,
    # the server and client scans' dispatch, the wait for the device at
    # retirement) and the rest (admission, Python); beside them an
    # estimate of the scans' parts, model calls and scan steps times their
    # per-call wall measured alone (the forward's in phase 4, the step's
    # at the client stage's K=4), which the host's speed, varying between
    # phases, can put above the scans it estimates
    keys = prng.fold_in(key, torch.arange(4, device="cuda"))
    shape = (B,) + IMG
    xs = [torch.randn((4,) + shape, device="cuda") for _ in range(2)]
    tk = torch.linspace(2.0, 500.0, 4, device="cuda").reshape(4, 1)
    coefs = step_coefficient_table(sched, tk, tk - 1.0)[:, 0]
    active = torch.ones(4, device="cuda")
    step = lambda: ddpm_step_rowwise(xs[0], xs[1], keys, 5, coefs, active)
    per_ms = {"ddpm_step": time_ms(step, iters=50),
              "stack": time_ms(lambda: torch.stack(list(xs[0])), iters=50)}
    # the rowwise DDPM step's own card time a launch, at the client
    # stage's K=4, in a profile with the step's torch op (the stack of
    # the model outputs) beside it
    part = device_ms("main/ddpm_step_batched", lambda: (
        torch.stack(list(xs[1])), step()), n=20, shares=["ddpm_step"],
        per="call")
    card_ms = part["ddpm_step"]
    log(f"kernel/ddpm_step_batched card_ms per launch (profiler, K=4 x "
        f"{shape}): {fmt_ms(card_ms)}")
    log("main/per_call_ms: " + json.dumps(
        {"unet_forward": round(fwd_ms, 4),
         **{k: round(v, 4) for k, v in per_ms.items()}}))
    spans = rt.obs.spans()
    for p, (_, rep) in enumerate(reports, 1):
        parts = {name: sum(s.duration_s for s in spans
                           if s.frame == p - 1 and s.name == name)
                 for name in ("plan", "server_scan", "client_scan",
                              "retire")}
        parts["other"] = rep["wall_s"] - sum(parts.values())
        calls = rep["server_calls_physical"] + rep["client_calls_physical"]
        n = pass_steps[p - 1]
        est = {"unet": calls * fwd_ms / 1e3,
               **{k: n * v / 1e3 for k, v in per_ms.items()}}
        log(f"main/pass{p}/breakdown_s (wall {rep['wall_s']:.2f}, "
            f"{calls} model calls, {n} scan steps): " + json.dumps(
                {k: round(v, 3) for k, v in parts.items()}) +
            "; scans estimated from per-call walls: " + json.dumps(
                {k: round(v, 3) for k, v in est.items()}))
    return launches, card_ms


def check_ddpm_launches(tag: str, launches: dict, per_request: int,
                        batched: int) -> None:
    """The DDPM-step launches of a main path: ``per_request`` keyed and
    ``batched`` rowwise launches, none of the given-noise variant."""
    want = {"ddpm_step": per_request, "ddpm_step/keyed": per_request,
            "ddpm_step/given": 0, "ddpm_step_batched": batched,
            "ddpm_step_batched/rowwise": batched,
            "ddpm_step_batched/given": 0}
    got = {k: launches.get(k) for k in want}
    if got != want:
        raise AssertionError(f"{tag}: DDPM-step launches {got} != {want}")


def phase_contracts():
    import numpy as np
    import torch
    from repro_torch.configs.ddpm_unet import CONFIG
    from repro_torch.core import prng
    from repro_torch.core.sample_plan import (SampleRequest, plan_requests,
                                              tables_to_device)
    from repro_torch.core.sampler import (make_sample_engine,
                                          sample_plan_reference)
    from repro_torch.core.schedules import DiffusionSchedule
    from repro_torch.core.unet import init_unet, unet_apply
    from repro_torch.launch import collab_serve

    t0 = time.perf_counter()
    collab_serve.main(["--smoke", "--full-unet", "--device", "cuda"])
    log(f"contracts/smoke_s: {time.perf_counter() - t0:.1f}")

    T = 12
    key = prng.PRNGKey(3, device="cuda")
    ks, *kc = prng.split(key, 3)
    sp = init_unet(ks, CONFIG, "cuda")
    cp = [init_unet(k, CONFIG, "cuda") for k in kc]
    sched = DiffusionSchedule.linear(T, device="cuda")
    eye = np.eye(CONFIG.n_classes, dtype=np.float32)
    y = lambda l: np.broadcast_to(eye[l], (B, CONFIG.n_classes)).copy()
    reqs = [SampleRequest(0, 4, y(0)), SampleRequest(1, 0, y(0)),
            SampleRequest(1, T, y(1)), SampleRequest(0, 4, y(0))]
    plan = plan_requests(reqs, T)
    engine = make_sample_engine(sched, unet_apply, IMG)
    out, hand = engine(sp, cp, key, tables_to_device(plan.tables, "cuda"))
    rout, rhand = sample_plan_reference(sp, cp, key, plan, sched,
                                        unet_apply, IMG)
    if not (torch.equal(out, rout) and torch.equal(hand, rhand)):
        raise AssertionError("engine != per-request reference on the card")
    log("contracts/engine_vs_reference: bitwise equal (CONFIG width, "
        "GM/ICM/mid cuts)")


def copy_state(state, device):
    """A deep copy of a ``CollabState`` (models, AdamW states, step count)
    on ``device``."""
    import copy
    from repro_torch.core.collab import CollabState
    mv = lambda t: t.detach().to(device, copy=True)
    opt = lambda o: {"m": {n: mv(t) for n, t in o["m"].items()},
                     "v": {n: mv(t) for n, t in o["v"].items()},
                     "step": o["step"].clone()}
    model = lambda m: copy.deepcopy(m).to(device)
    return CollabState(
        server_params=model(state.server_params),
        client_params=[model(m) for m in state.client_params],
        server_opt=opt(state.server_opt),
        client_opt=[opt(o) for o in state.client_opt], step=state.step)


def state_tensors(state) -> dict:
    """Every tensor of a ``CollabState`` by name: each model's parameters
    (``server.p.<name>``, ``client<c>.p.<name>``), both AdamW moments
    (``.m.``, ``.v.``) and its step counter (``.step``)."""
    out = {}
    models = [("server", state.server_params, state.server_opt)] + [
        (f"client{c}", m, o) for c, (m, o) in
        enumerate(zip(state.client_params, state.client_opt))]
    for tag, model, opt in models:
        for n, p in model.named_parameters():
            out[f"{tag}.p.{n}"] = p.detach()
        for kind in ("m", "v"):
            for n, t in opt[kind].items():
                out[f"{tag}.{kind}.{n}"] = t
        out[f"{tag}.step"] = opt["step"]
    return out


def compare_states(a, b, tol=None) -> dict:
    """Per kind of tensor ("p", "m", "v", "step"): (max |a − b|, elements
    beyond ``tol`` — any that differ when ``tol`` is None) over two
    ``CollabState``s of one layout, b's tensors moved to a's device."""
    return compare_tensors(state_tensors(a), state_tensors(b), tol)


def compare_tensors(ta: dict, tb: dict, tol=None) -> dict:
    """``compare_states`` over two ``{name: tensor}`` maps named as
    ``state_tensors`` names them (``<model>.<kind>.<param>`` and
    ``<model>.step``)."""
    import torch
    if set(ta) != set(tb):
        raise AssertionError("compare_states: the states differ in layout")
    out = {}
    for name, x in ta.items():
        y = tb[name].to(x.device)
        kind = "step" if name.endswith(".step") else name.split(".")[1]
        err = (x.double() - y.double()).abs().max().item() if x.numel() \
            else 0.0
        bad = int((~torch.isclose(x, y, **tol)).sum()) if tol and \
            kind != "step" else int((x != y).sum())
        e0, b0 = out.get(kind, (0.0, 0))
        out[kind] = (max(e0, err), b0 + bad)
    return out


def moment_gaps(a, b) -> dict:
    """For "m" and "v": the largest over leaves of max |a − b| / max |b|
    (0 where both are zero, inf where only b is) over two ``CollabState``s
    of one layout, b's tensors moved to a's device."""
    return tensor_moment_gaps(state_tensors(a), state_tensors(b))


def tensor_moment_gaps(ta: dict, tb: dict) -> dict:
    """``moment_gaps`` over two ``{name: tensor}`` maps."""
    out = {"m": 0.0, "v": 0.0}
    for name, x in ta.items():
        kind = name.split(".")[1]
        if kind not in out or not x.numel():
            continue
        y = tb[name].to(x.device).double()
        err = (x.double() - y).abs().max().item()
        scale = y.abs().max().item()
        gap = err / scale if scale else (float("inf") if err else 0.0)
        out[kind] = max(out[kind], gap)
    return out


def train_parity(a, b, rec_a: list, rec_b: list):
    """(summary line, failures) of a trained ``CollabState`` and its
    per-step metrics against another's: TRAIN_TOL elementwise and step
    counters exact, TRAIN_MOMENT_RTOL on each moment leaf's scale,
    TRAIN_METRIC_RTOL on every step's metrics."""
    diff = compare_states(a, b, TRAIN_TOL)
    gaps = moment_gaps(a, b)
    mdiff = metrics_diff(rec_a, rec_b)
    fails = [f"{k}: {n} beyond" for k, (_, n) in diff.items() if n] + [
        f"{k} scaled {g:.3g}" for k, g in gaps.items()
        if not g <= TRAIN_MOMENT_RTOL]
    if not mdiff <= TRAIN_METRIC_RTOL:
        fails.append(f"metrics {mdiff:.3g}")
    line = "; ".join(f"{k} max abs {e:.3g}, {n} beyond"
                     for k, (e, n) in diff.items()) + \
        f" (tolerance {TRAIN_TOL}, steps exact); moments scaled " + \
        ", ".join(f"{k} {g:.3g}" for k, g in gaps.items()) + \
        f" (tolerance {TRAIN_MOMENT_RTOL}); metrics max rel {mdiff:.3g} " \
        f"(tolerance {TRAIN_METRIC_RTOL})"
    return line, fails


def recording(step_fn, rec: list, events: bool = False):
    """``step_fn`` that appends each step's metrics (copies on their
    device) to ``rec``, with a pair of CUDA events around the step when
    ``events``."""
    import torch

    def step(*args):
        if events:
            start, end = torch.cuda.Event(True), torch.cuda.Event(True)
            start.record()
        out = step_fn(*args)
        metrics = {k: v.detach().clone() for k, v in out[-1].items()}
        if events:
            end.record()
            rec.append((start, end, metrics))
        else:
            rec.append(metrics)
        return out
    return step


def metrics_diff(a: list, b: list) -> float:
    """max |a − b| / max(1, |b|) over every metric of every step."""
    worst = 0.0
    for ma, mb in zip(a, b, strict=True):
        for k in ma:
            x, y = float(ma[k]), float(mb[k])
            worst = max(worst, abs(x - y) / max(1.0, abs(y)))
    return worst


def phase_train():
    """Alg. 1 at full width on the card: six CONFIG U-Nets (server + 5
    clients) through ``setup`` and one ``train_round`` of 10 steps, held
    against the same round on the CPU port and against itself (bitwise);
    then one Alg.-2 sample from the trained models.  Returns the DDPM-step
    launches of the sample and the DDPM step's card ms a launch."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.ddpm_unet import CONFIG
    from repro_torch.core import prng
    from repro_torch.core.collab import (CollabConfig, sample_for_client,
                                         setup, train_round)
    from repro_torch.core.protocol import make_collab_step
    from repro_torch.data.synthetic import (SyntheticConfig, batches,
                                            make_client_datasets)
    from repro_torch.device import deterministic_cuda
    from repro_torch.kernels.ddpm_step import kernel as dkernel
    from repro_torch.optim.adamw import AdamWConfig, adamw_update

    t_phase = time.perf_counter()
    deterministic_cuda()
    card = card_line()
    cfg = CollabConfig(n_clients=TRAIN_CLIENTS, T=1000, t_cut=TRAIN_CUT,
                       denoiser="unet", image_size=IMG[0], channels=IMG[2],
                       n_classes=CONFIG.n_classes, batch_size=TRAIN_BATCH,
                       lr=1e-3, unet=CONFIG)
    t0 = time.perf_counter()
    state, step_fn, apply_fn = setup(prng.PRNGKey(0), cfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.server_params.parameters())
    log(f"train/setup: {cfg.n_clients + 1} U-Nets of {n_params} parameters "
        f"with AdamW states in {time.perf_counter() - t0:.2f} s")
    scfg = SyntheticConfig(image_size=IMG[0], channels=IMG[2],
                           n_attrs=cfg.n_classes)
    data = make_client_datasets(prng.PRNGKey(1), scfg, cfg.n_clients,
                                TRAIN_BATCH * TRAIN_BATCHES, non_iid=True,
                                device="cuda")
    kb = prng.PRNGKey(2, device="cuda")
    round_batches = [list(batches(x, y, TRAIN_BATCH, prng.fold_in(kb, c)))
                     for c, (x, y) in enumerate(data)]
    key = prng.PRNGKey(3, device="cuda")
    n_steps = sum(len(b) for b in round_batches)
    init = copy_state(state, "cuda")
    cpu = copy_state(state, "cpu")

    # round 1: wall per step (CUDA events), peak memory
    rec = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    last = train_round(state, recording(step_fn, rec, events=True),
                       round_batches, key)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wall = [s.elapsed_time(e) for s, e, _ in rec]
    metrics = [m for _, _, m in rec]
    if len(rec) != n_steps or state.step != n_steps:
        raise AssertionError(f"train: {len(rec)} steps, expected {n_steps}")
    for c in range(cfg.n_clients):
        if not all(np.isfinite(v) for v in last[c].values()):
            raise AssertionError(f"train: client {c} metrics {last[c]}")

    # round 2: the same state, batches and key on the card
    again, rec2 = copy_state(init, "cuda"), []
    train_round(again, recording(step_fn, rec2), round_batches, key)
    diff = compare_states(state, again)
    if any(bad for _, bad in diff.values()) or \
            metrics_diff(metrics, rec2) != 0.0:
        raise AssertionError(f"train: the round repeated on the card is not "
                             f"bitwise equal: {diff}")
    log(f"train/determinism: round 2 == round 1 bitwise ({n_steps} steps: "
        "params, both moments, step counters, metrics of every step)")
    # the device time of one more step (client 0's first batch), profiled
    x, y = round_batches[0][0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(again.client_params[0], again.client_opt[0],
                again.server_params, again.server_opt, x, y,
                prng.fold_in(key, 11))
        torch.cuda.synchronize()
    rows = device_rows(prof.key_averages())
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
    log(f"train/step device events: {sum(e.count for e in rows)}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"train/device_top: {e.self_device_time_total:9.1f} us per step, "
            f"{e.count:5d} calls  {e.key[:70]}")

    # the same round on the CPU port
    cpu_step = make_collab_step(cfg.sched("cpu"), cfg.cut(), apply_fn,
                                AdamWConfig(lr=cfg.lr))
    rec_cpu = []
    t0 = time.perf_counter()
    train_round(cpu, recording(cpu_step, rec_cpu),
                [[(x.cpu(), y.cpu()) for x, y in b] for b in round_batches],
                key.cpu())
    cpu_s = time.perf_counter() - t0
    line, fails = train_parity(state, cpu, metrics, rec_cpu)
    log(f"train/card_vs_cpu ({cpu_s:.1f} s on the CPU): {line}")
    if fails:
        raise AssertionError(f"train: card vs CPU beyond tolerance: {fails}")
    # control: the same round on the card with TF32 matmuls and
    # convolutions must fail the same check
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    tf32, rec_tf32 = copy_state(init, "cuda"), []
    train_round(tf32, recording(step_fn, rec_tf32), round_batches, key)
    deterministic_cuda()
    line, fails = train_parity(tf32, cpu, rec_tf32, rec_cpu)
    log(f"train/control_tf32_vs_cpu: {line}; caught by {fails}")
    if not fails:
        raise AssertionError("train: the parity check passed a TF32 round")
    del tf32

    # AdamW alone at the step's shapes (one client and one server update
    # a step), on a copy
    shadow = copy_state(init, "cuda")
    grads = {n: torch.randn_like(p) for n, p in
             shadow.server_params.named_parameters()}
    upd = lambda: adamw_update(shadow.server_params, grads,
                               shadow.server_opt, AdamWConfig(lr=cfg.lr))
    adam_wall = time_ms(upd, iters=20, warmup=2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            upd()
        torch.cuda.synchronize()
    adam_rows = device_rows(prof.key_averages())
    adam_dev = sum(e.self_device_time_total for e in adam_rows) / 1e3 / 5
    log(f"train/adamw device events per update: "
        f"{sum(e.count for e in adam_rows) / 5:.0f}")
    del shadow, grads, again, init, cpu
    step_wall = sum(wall[1:]) / (len(wall) - 1)
    for i, (w, m) in enumerate(zip(wall, metrics), 1):
        log(f"train/step {i}: wall {w:.3f} ms (events); " + ", ".join(
            f"{k} {float(v):.6g}" for k, v in m.items()))
    log(f"train/step: wall {step_wall:.3f} ms (events, mean of steps 2-"
        f"{n_steps}; step 1 {wall[0]:.3f} ms), device {dev_ms:.3f} ms "
        f"(profiler, one more step), idle "
        f"{100 * (1 - dev_ms / step_wall):.1f}%; "
        f"AdamW {adam_dev:.3f} ms device / {adam_wall:.3f} ms wall an update,"
        f" 2 a step: {100 * 2 * adam_dev / dev_ms:.1f}% of the step's device "
        f"time; peak memory {peak_gb:.3f} GB; round wall {round_s:.2f} s "
        f"({n_steps} steps); card {card}")

    # Alg. 2 from the trained server and client 0: the per-request path
    eye = np.eye(cfg.n_classes, dtype=np.float32)
    y0 = torch.from_numpy(np.broadcast_to(eye[0], (B, cfg.n_classes))
                          .copy()).cuda()
    torch.cuda.synchronize()
    dkernel.reset_counts()                       # --- sample starts
    t0 = time.perf_counter()
    x0 = sample_for_client(state, 0, prng.fold_in(key, 7), y0, cfg,
                           apply_fn)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    launches = dict(dkernel.COUNTS)              # --- sample ends
    if tuple(x0.shape) != (B,) + IMG or not torch.isfinite(x0).all():
        raise AssertionError(f"train: sample {tuple(x0.shape)} not finite")
    log(f"train/sample: T={cfg.T} cut {cfg.t_cut} batch {B} from the trained "
        f"server and client 0, wall_s {sample_s:.3f}; launches {launches}; "
        f"card {card}")
    check_ddpm_launches("train sample", launches, cfg.T, 0)

    # the DDPM step's own card time a launch, from the profile of a short
    # sample (T=10: 10 launches among the U-Net forwards)
    short = dataclasses.replace(cfg, T=10, t_cut=3)
    part = device_ms("train/sample_T10", lambda: sample_for_client(
        state, 0, prng.fold_in(key, 8), y0, short, apply_fn), n=1,
        shares=["ddpm_step"], per="sample")
    card_ms = None if part["ddpm_step"] is None else \
        part["ddpm_step"] / short.T
    log(f"kernel/ddpm_step card_ms per launch (profiler, in a T=10 sample "
        f"at {(B,) + IMG}): {fmt_ms(card_ms)}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train/phase_s: {time.perf_counter() - t_phase:.1f}")
    return launches, card_ms


def runtime_tensors(rt) -> dict:
    """Every tensor of a ``TrainRuntime`` by name, as ``state_tensors``
    names a ``CollabState``'s: the server, each client (``client<uid>``),
    the EMA track (``ema``) and the DP reference (``dpref``) — parameters,
    both AdamW moments and step counters."""
    from repro_torch.core import trees
    models = [("server", rt.server_params, rt.server_opt)] + [
        (f"client{u}", rt.registry.get(u).params, rt.registry.get(u).opt)
        for u in rt.registry.uids()] + [
        ("ema", rt.ema_server, None), ("dpref", rt._dp_ref, None)]
    out = {}
    for tag, model, opt in models:
        if model is None:
            continue
        for n, p in trees.as_tree(model).items():
            out[f"{tag}.p.{n}"] = p.detach()
        if opt is not None:
            for kind in ("m", "v"):
                for n, t in opt[kind].items():
                    out[f"{tag}.{kind}.{n}"] = t
            out[f"{tag}.step"] = opt["step"]
    return out


def runtime_counters(rt) -> tuple:
    """A runtime's cursor, step and DP counters, its accountant's RDP
    vector and each client's sample counters and membership."""
    acc = None if rt._accountant is None else \
        (rt._accountant.steps, rt._accountant.state_dict()["rdp"].tolist())
    return (rt.round, rt.total_steps, rt.dp_epoch, acc, len(rt._pending),
            [(u, r.seen, r.window_seen, r.window_member, r.active)
             for u, r in ((u, rt.registry.get(u))
                          for u in rt.registry.uids())])


def assert_runtime_bitwise(tag: str, a, b) -> None:
    diff = compare_tensors(runtime_tensors(a), runtime_tensors(b))
    if any(bad for _, bad in diff.values()) or \
            runtime_counters(a) != runtime_counters(b):
        raise AssertionError(f"runtime: {tag} not bitwise: {diff}; "
                             f"{runtime_counters(a)} vs {runtime_counters(b)}")


def padding_gap(rt, cfg, apply_fn, cohort, drops) -> float:
    """The largest |padded − unpadded| over the server's and the cohort's
    params, moments and steps after one engine round from ``rt``'s state:
    the cohort seated in its participation tier (or twice its size when
    it fills its tier), pad slots all-masked, against the cohort alone."""
    import numpy as np
    import torch
    from repro_torch.core import prng, trees
    from repro_torch.core.collab import make_vectorized_round
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import plan_round
    from repro_torch.train.participation import TAG_ROUND
    plan = plan_round(rt.registry, cohort, rt.round, rt._key,
                      n_batches=cfg.batches_per_round,
                      batch_size=cfg.batch_size, image_shape=cfg.image_shape,
                      n_classes=cfg.n_classes, drops=drops, device=rt.device)
    m = len(plan.cohort)
    width = plan.tier if plan.tier > m else 2 * plan.tier
    engine = make_vectorized_round(rt.sched, rt.cut, apply_fn,
                                   AdamWConfig(lr=cfg.lr),
                                   identity_keyed=True)
    rkey = prng.fold_in(prng.fold_in(rt._key, TAG_ROUND), rt.round)

    def seat(k: int) -> dict:
        pad = k - m
        xs, ys = plan.xs[:, :m], plan.ys[:, :m]
        xs = torch.cat([xs, xs.new_zeros((xs.shape[0], pad) + xs.shape[2:])],
                       1)
        ys = torch.cat([ys, ys.new_zeros((ys.shape[0], pad) + ys.shape[2:])],
                       1)
        mask = np.concatenate([plan.mask[:, :m], np.zeros(
            (plan.mask.shape[0], pad, plan.mask.shape[2]), np.float32)], 1)
        uids = np.asarray(list(plan.uids[:m]) + [plan.uids[0]] * pad,
                          np.int32)
        cp = [trees.copy(rt.registry.get(u).params) for u in plan.cohort]
        co = [trees.copy(rt.registry.get(u).opt) for u in plan.cohort]
        sp, so = trees.copy(rt.server_params), trees.copy(rt.server_opt)
        engine(cp + [cp[0]] * pad, co + [co[0]] * pad, sp, so, xs, ys, mask,
               uids, rkey.to(rt.device))
        out = {}
        for tag, model, opt in [("server", sp, so)] + [
                (f"client{u}", p, o) for u, p, o in zip(plan.cohort, cp, co)]:
            for n, t in trees.as_tree(model).items():
                out[f"{tag}.p.{n}"] = t
            for kind in ("m", "v"):
                for n, t in opt[kind].items():
                    out[f"{tag}.{kind}.{n}"] = t
            out[f"{tag}.step"] = opt["step"]
        return out

    padded, alone = seat(width), seat(m)
    diff = compare_tensors(padded, alone, TRAIN_TOL)
    gap = max(e for e, _ in diff.values())
    if any(bad for _, bad in diff.values()):
        raise AssertionError(f"runtime: tier padding beyond TRAIN_TOL: {diff}")
    log(f"runtime/tier_padding: cohort {plan.cohort} seated in {width} slots "
        f"vs alone, one round: max |gap| {gap:.3g} over params, moments and "
        f"steps (tolerance {TRAIN_TOL})" + (": bitwise" if gap == 0 else ""))
    return gap


def phase_train_runtime():
    """The federated training runtime on the card: (A) the CLI's ``--smoke``
    contracts with the toy denoiser; (B) ``TrainRuntime`` with six CONFIG
    U-Nets over RT_ROUNDS rounds of cohort sampling, FedAvg and EMA — one
    signature per tier, a bitwise resume from the round-2 checkpoint,
    round 1 against the CPU port, the tier-padding gap, a DP run with
    secagg on equal to off — then one Alg.-2 sample from the EMA server
    and client 0.  Returns the DDPM-step launches of the sample and the
    trained models (the EMA server, clients 0 and 1) with their schedule,
    cut and denoiser, which the evaluation phase scores."""
    import tempfile
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.ddpm_unet import CONFIG
    from repro_torch.core import prng
    from repro_torch.core.collab import CollabConfig, build_denoiser
    from repro_torch.core.sampler import collaborative_sample
    from repro_torch.core.unet import UNet
    from repro_torch.data.synthetic import (SyntheticConfig,
                                            make_client_datasets)
    from repro_torch.device import deterministic_cuda
    from repro_torch.kernels.ddpm_step import kernel as dkernel
    from repro_torch.launch import collab_train
    from repro_torch.train import (ParticipationConfig, PrivacyConfig,
                                   TrainConfig, TrainRuntime)
    from repro_torch.train.participation import sample_drops

    t_phase = time.perf_counter()
    card = card_line()
    t0 = time.perf_counter()
    collab_train.main(["--smoke", "--device", "cuda"])
    log(f"runtime/smoke_s: {time.perf_counter() - t0:.1f} (the CLI's "
        "contracts (a)-(f) with the toy denoiser on the card)")

    deterministic_cuda()
    cfg = TrainConfig(
        T=1000, t_cut=TRAIN_CUT, image_shape=IMG, n_classes=CONFIG.n_classes,
        batch_size=TRAIN_BATCH, batches_per_round=TRAIN_BATCHES, lr=1e-3,
        participation=ParticipationConfig(policy="bernoulli", p=RT_P,
                                          drop_p=RT_DROP),
        fedavg_every=RT_FEDAVG, ema_decay=RT_EMA)
    ccfg = CollabConfig(n_clients=TRAIN_CLIENTS, T=cfg.T, t_cut=cfg.t_cut,
                        image_size=IMG[0], channels=IMG[2],
                        n_classes=CONFIG.n_classes, batch_size=TRAIN_BATCH,
                        unet=CONFIG)
    init_one, apply_fn = build_denoiser(None, ccfg, "cuda")
    scfg = SyntheticConfig(image_size=IMG[0], channels=IMG[2],
                           n_attrs=CONFIG.n_classes)
    data = make_client_datasets(prng.PRNGKey(1), scfg, TRAIN_CLIENTS,
                                TRAIN_BATCH * TRAIN_BATCHES, non_iid=True,
                                device="cuda")
    key = prng.PRNGKey(RT_SEED)

    def fresh(config):
        rt = TrainRuntime(config, init_one, apply_fn, key, device="cuda")
        for x, y in data:
            rt.register_client(x, y)
        return rt

    def attach(rt, device):
        for uid, (x, y) in enumerate(data):
            rt.attach_data(uid, x.to(device), y.to(device))

    tmp = tempfile.TemporaryDirectory()
    p0, p2 = f"{tmp.name}/round0.msgpack", f"{tmp.name}/round2.msgpack"
    rt = fresh(cfg)
    t0 = time.perf_counter()
    rt.save(p0)
    save_s = time.perf_counter() - t0
    ckpt_mb = Path(p0).stat().st_size / 1e6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps, walls = [], []
    for r in range(RT_ROUNDS):
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        reps.append(rt.run_round())
        end.record()
        end.synchronize()
        walls.append(start.elapsed_time(end))
        if r == 0:
            after0 = {n: t.clone() for n, t in runtime_tensors(rt).items()}
        if r == 1:
            rt.save(p2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for rep, w in zip(reps, walls):
        log(f"runtime/round {rep['round']}: cohort {rep['cohort']} tier "
            f"{rep['tier']} drops {rep['mid_round_drops']} real_samples "
            f"{rep['real_samples']} client_loss {rep['client_loss']:.6g} "
            f"server_loss {rep['server_loss']:.6g} fedavg "
            f"{rep['fedavg_applied']} traces {rep['engine_traces']}; wall "
            f"{w:.3f} ms (events)")
    tiers = {rep["tier"] for rep in reps if rep["tier"]}
    if rt.traces != len(tiers) or reps[-1]["max_signatures_per_tier"] != 1:
        raise AssertionError(f"runtime: {rt.traces} signatures for tiers "
                             f"{sorted(tiers)}")
    if not any(rep["strict_subset"] for rep in reps):
        raise AssertionError("runtime: no round seated a strict subset")
    log(f"runtime/signatures: {rt.traces} for tiers {sorted(tiers)} (one "
        "per tier)")

    t0 = time.perf_counter()
    resumed = TrainRuntime.restore(cfg, init_one, apply_fn, p2,
                                   device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    attach(resumed, "cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        resumed.run_round()
        torch.cuda.synchronize()
    resumed.run_round()
    assert_runtime_bitwise("resume at round 2", resumed, rt)
    log(f"runtime/resume: restored at round 2 from {ckpt_mb:.1f} MB, two "
        "more rounds: bitwise equal to the uninterrupted run (params, "
        "moments, steps, EMA, registry counters)")
    rows = device_rows(prof.key_averages())
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
    dev_events = sum(e.count for e in rows)
    del resumed

    # round 1 on the CPU port from the same state (the round-0 file)
    cpu = TrainRuntime.restore(cfg, lambda k: UNet(CONFIG), apply_fn, p0,
                               device="cpu")
    attach(cpu, "cpu")
    t0 = time.perf_counter()
    rep_cpu = cpu.run_round()
    cpu_s = time.perf_counter() - t0
    same = ("cohort", "tier", "mid_round_drops", "real_samples",
            "padded_cells")
    if [rep_cpu[k] for k in same] != [reps[0][k] for k in same]:
        raise AssertionError(f"runtime: CPU round 1 {rep_cpu} vs card "
                             f"{reps[0]}")
    tcpu = runtime_tensors(cpu)
    diff = compare_tensors(after0, tcpu, TRAIN_TOL)
    gaps = tensor_moment_gaps(after0, tcpu)
    fails = [f"{k}: {n} beyond" for k, (_, n) in diff.items() if n] + [
        f"{k} scaled {g:.3g}" for k, g in gaps.items()
        if not g <= TRAIN_MOMENT_RTOL]
    log(f"runtime/card_vs_cpu ({cpu_s:.1f} s on the CPU): cohorts, tiers, "
        "drops bitwise; " + "; ".join(
            f"{k} max abs {e:.3g}, {n} beyond" for k, (e, n) in diff.items())
        + f" (tolerance {TRAIN_TOL}, steps exact); moments scaled "
        + ", ".join(f"{k} {g:.3g}" for k, g in gaps.items())
        + f" (tolerance {TRAIN_MOMENT_RTOL})")
    if fails:
        raise AssertionError(f"runtime: card vs CPU beyond tolerance: "
                             f"{fails}")
    del cpu

    base = TrainRuntime.restore(cfg, init_one, apply_fn, p0, device="cuda")
    attach(base, "cuda")
    gap = padding_gap(base, cfg, apply_fn, reps[0]["cohort"], sample_drops(
        cfg.participation, key, 0, reps[0]["cohort"], cfg.batches_per_round))
    del base
    tmp.cleanup()

    runs = {}
    for secagg in (False, True):
        dcfg = dataclasses.replace(cfg, privacy=PrivacyConfig(
            secagg=secagg, **RT_DP))
        t0 = time.perf_counter()
        runs[secagg] = fresh(dcfg)
        dreps = runs[secagg].run(2)
        torch.cuda.synchronize()
        log(f"runtime/dp secagg={secagg}: 2 rounds in "
            f"{time.perf_counter() - t0:.2f} s, dp_epoch "
            f"{dreps[-1]['dp_epoch']}, eps {dreps[-1]['dp_epsilon']:.6g} "
            f"(delta {dcfg.privacy.delta}), clip_frac "
            f"{dreps[-1]['dp_clip_frac']}")
    if runs[False].dp_epoch < 1:
        raise AssertionError("runtime: the DP run released nothing")
    assert_runtime_bitwise("DP secagg on vs off", runs[True], runs[False])
    log("runtime/dp: secagg on == off bitwise (params, moments, steps, EMA, "
        "DP reference, accountant)")
    del runs

    # Alg. 2 from the trained runtime: the EMA server and client 0
    eye = np.eye(cfg.n_classes, dtype=np.float32)
    y0 = torch.from_numpy(np.broadcast_to(eye[0], (B, cfg.n_classes))
                          .copy()).cuda()
    torch.cuda.synchronize()
    dkernel.reset_counts()                       # --- sample starts
    t0 = time.perf_counter()
    x0 = collaborative_sample(rt.sampling_server_params(),
                              rt.registry.get(0).params,
                              prng.fold_in(key, 7).cuda(), y0, (B,) + IMG,
                              rt.sched, rt.cut, apply_fn)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    launches = dict(dkernel.COUNTS)              # --- sample ends
    if tuple(x0.shape) != (B,) + IMG or not torch.isfinite(x0).all():
        raise AssertionError(f"runtime: sample {tuple(x0.shape)} not finite")
    check_ddpm_launches("runtime sample", launches, cfg.T, 0)
    log(f"runtime/sample: T={cfg.T} cut {cfg.t_cut} batch {B} from the EMA "
        f"server and client 0, wall_s {sample_s:.3f}; launches {launches}")
    trained = dict(server=rt.sampling_server_params(),
                   clients=[rt.registry.get(c).params for c in (0, 1)],
                   sched=rt.sched, cut=rt.cut, apply_fn=apply_fn,
                   n_classes=cfg.n_classes)

    steady = walls[1:]
    round_ms = sum(steady) / len(steady)
    log(f"runtime/round: wall {round_ms:.3f} ms (events, mean of rounds "
        f"2-{RT_ROUNDS}; round 1 {walls[0]:.3f} ms), "
        f"{1e3 / round_ms:.3f} rounds/s, "
        f"{rt.total_steps / (sum(walls) / 1e3):.3f} Alg.-1 steps/s "
        f"({rt.total_steps} real (client, batch) cells in {RT_ROUNDS} "
        f"rounds); device {dev_ms:.3f} ms over {dev_events} device events "
        f"(profiler, round 3 of the resumed run; the uninterrupted run's "
        f"round 3: {walls[2]:.3f} ms wall), idle "
        f"{100 * (1 - dev_ms / walls[2]):.1f}%; DDPM-step launches a round "
        f"0; peak memory {peak_gb:.3f} GB; checkpoint {ckpt_mb:.1f} MB, save "
        f"{save_s:.2f} s, restore {restore_s:.2f} s; tier padding gap "
        f"{gap:.3g}; card {card}")
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    log(f"runtime/phase_s: {time.perf_counter() - t_phase:.1f}")
    return launches, trained


# the clients mesh (phase_clients_mesh): the runtime's six CONFIG U-Nets
# for CM_ROUNDS rounds on a one-rank NCCL ("clients",) mesh and without
# one; an engine pass of CM_REQUESTS requests (one label: one server
# group) and the bf16 U-Net's per-request sample at T = CM_SAMPLE_T, cut
# CM_SAMPLE_CUT (the training cut's quarter of T; at T=1000 the phase
# took 220 s on a slow host, 1,500 eager U-Net calls a pass); the
# collective bytes reckoned per rank for the mesh sizes CM_WORLDS
CM_ROUNDS, CM_REQUESTS, CM_WORLDS = 2, 3, (2, 4, 8)
CM_SAMPLE_T, CM_SAMPLE_CUT = 100, 25


def collective_reckoning(nbytes: dict, worlds=CM_WORLDS) -> dict:
    """Per-rank link bytes and their NVLINK_BW time at each world size W
    for one round's collectives (``nbytes``: the bytes each kind was
    handed, sharding/specs.py ``COMM_BYTES``): a ring all-reduce sends and
    receives 2(W-1)/W of its buffer, a broadcast or all-gather brings a
    rank the (W-1)/W of the slots it does not own."""
    out = {}
    for w in worlds:
        per_rank = 2 * (w - 1) / w * nbytes.get("all_reduce", 0) + \
            (w - 1) / w * (nbytes.get("broadcast", 0) +
                           nbytes.get("all_gather", 0))
        out[w] = dict(bytes=per_rank, bound_ms=1e3 * per_rank /
                      card.NVLINK_BW)
    return out


def phase_clients_mesh():
    """The federated round, the train runtime and the sample engine on a
    one-rank NCCL ``("clients",)`` mesh (sharding/specs.py
    ``make_client_mesh``; the process group is this phase's and is torn
    down at its end), with the runtime phase's six CONFIG U-Nets (T=1000,
    cut 250): CM_ROUNDS sharded rounds bitwise equal to as many unsharded
    ones, a sharded ``make_sample_engine`` pass of CM_REQUESTS requests
    bitwise equal to the unsharded pass, and one keyed per-request sample
    from a bf16 CONFIG U-Net bitwise across two runs (both at
    CM_SAMPLE_T, cut CM_SAMPLE_CUT).  Returns the path's DDPM-step
    launches, counted from zero just before it."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.ddpm_unet import CONFIG
    from repro_torch.core import prng
    from repro_torch.core import sample_plan as tsp
    from repro_torch.core.collab import CollabConfig, build_denoiser
    from repro_torch.core.sampler import (collaborative_sample,
                                          make_sample_engine)
    from repro_torch.core.schedules import DiffusionSchedule
    from repro_torch.core.splitting import CutPoint
    from repro_torch.core.unet import init_unet, unet_apply
    from repro_torch.data.synthetic import (SyntheticConfig,
                                            make_client_datasets)
    from repro_torch.device import deterministic_cuda
    from repro_torch.kernels.ddpm_step import kernel as dkernel
    from repro_torch.sharding import specs
    from repro_torch.train import (ParticipationConfig, TrainConfig,
                                   TrainRuntime)

    t_phase = time.perf_counter()
    card = card_line()
    deterministic_cuda()
    if dist.is_initialized():
        raise AssertionError("clients_mesh: a process group is left over "
                             "from an earlier phase")
    mesh = specs.make_client_mesh(8, device="cuda")
    try:
        if (dist.get_backend(), mesh.mesh_dim_names, mesh.size()) != \
                ("nccl", ("clients",), 1):
            raise AssertionError(f"clients_mesh: mesh {mesh} on "
                                 f"{dist.get_backend()}")
        cfg = TrainConfig(
            T=1000, t_cut=TRAIN_CUT, image_shape=IMG,
            n_classes=CONFIG.n_classes, batch_size=TRAIN_BATCH,
            batches_per_round=TRAIN_BATCHES, lr=1e-3,
            participation=ParticipationConfig(policy="bernoulli", p=RT_P,
                                              drop_p=RT_DROP),
            fedavg_every=RT_FEDAVG, ema_decay=RT_EMA)
        ccfg = CollabConfig(n_clients=TRAIN_CLIENTS, T=cfg.T,
                            t_cut=cfg.t_cut, image_size=IMG[0],
                            channels=IMG[2], n_classes=CONFIG.n_classes,
                            batch_size=TRAIN_BATCH, unet=CONFIG)
        init_one, apply_fn = build_denoiser(None, ccfg, "cuda")
        data = make_client_datasets(
            prng.PRNGKey(1), SyntheticConfig(image_size=IMG[0],
                                             channels=IMG[2],
                                             n_attrs=CONFIG.n_classes),
            TRAIN_CLIENTS, TRAIN_BATCH * TRAIN_BATCHES, non_iid=True,
            device="cuda")
        runs, walls, dev_ms, nbytes = {}, {}, {}, []
        dkernel.reset_counts()                   # --- clients_mesh starts
        for tag, m in (("unsharded", None), ("sharded", mesh)):
            rt = TrainRuntime(cfg, init_one, apply_fn,
                              prng.PRNGKey(RT_SEED), mesh=m, device="cuda")
            for x, y in data:
                rt.register_client(x, y)
            walls[tag] = []
            for r in range(CM_ROUNDS):
                specs.COMM_BYTES.clear()
                start, end = torch.cuda.Event(True), torch.cuda.Event(True)
                if r == CM_ROUNDS - 1:
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        start.record()
                        rep = rt.run_round()
                        end.record()
                        torch.cuda.synchronize()
                    rows = device_rows(prof.key_averages())
                    dev_ms[tag] = sum(e.self_device_time_total
                                      for e in rows) / 1e3 or None
                else:
                    start.record()
                    rep = rt.run_round()
                    end.record()
                end.synchronize()
                walls[tag].append(start.elapsed_time(end))
                if m is not None:
                    nbytes.append(dict(specs.COMM_BYTES, tier=rep["tier"]))
            runs[tag] = rt
        assert_runtime_bitwise("sharded vs unsharded rounds",
                               runs["sharded"], runs["unsharded"])
        if not all(b.get("all_reduce") and b.get("broadcast")
                   for b in nbytes):
            raise AssertionError(f"clients_mesh: a sharded round issued no "
                                 f"all_reduce or broadcast: {nbytes}")
        log(f"clients_mesh/rounds: {CM_ROUNDS} rounds on the one-rank "
            "NCCL mesh bitwise equal to the unsharded runtime's (params, "
            "moments, steps, EMA, registry counters)")

        rt = runs["sharded"]
        sp = rt.sampling_server_params()
        cps = [rt.registry.get(u).params for u in rt.registry.uids()]
        eye = np.eye(cfg.n_classes, dtype=np.float32)
        y0 = np.broadcast_to(eye[0], (B, cfg.n_classes)).copy()
        sched = DiffusionSchedule.linear(CM_SAMPLE_T, device="cuda")
        cut = CutPoint(CM_SAMPLE_T, CM_SAMPLE_CUT)
        plan = tsp.plan_requests(
            [tsp.SampleRequest(c, cut.t_cut, y0)
             for c in range(CM_REQUESTS)], cut.T,
            n_clients=TRAIN_CLIENTS, request_seeds=[11, 12, 13])
        tables = tsp.tables_to_device(plan.tables, "cuda")
        engine = make_sample_engine(sched, apply_fn, IMG)
        key = prng.fold_in(prng.PRNGKey(RT_SEED), 9).cuda()
        t0 = time.perf_counter()
        plain = engine(sp, cps, key, tables)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        placed = engine(sp, cps, key, specs.shard_sample_plan(mesh, tables))
        torch.cuda.synchronize()
        placed_s = time.perf_counter() - t0
        for a, b in zip(plain, placed):
            if not torch.equal(a, b):
                raise AssertionError("clients_mesh: the sharded engine pass "
                                     "differs from the unsharded pass")
        if tuple(placed[0].shape) != (CM_REQUESTS, B) + IMG or \
                not torch.isfinite(placed[0]).all():
            raise AssertionError(f"clients_mesh: samples "
                                 f"{tuple(placed[0].shape)} not finite")
        log(f"clients_mesh/engine: {CM_REQUESTS} requests at cut "
            f"{cut.t_cut} of T={cut.T} ({len(plan.group_t_cut)} server "
            f"group), sharded pass bitwise the unsharded pass; wall_s "
            f"unsharded {plain_s:.3f}, sharded {placed_s:.3f}")

        bcfg = dataclasses.replace(CONFIG, dtype="bfloat16")
        bserver = init_unet(prng.PRNGKey(3), bcfg, "cuda")
        bclient = init_unet(prng.PRNGKey(4), bcfg, "cuda")
        if {p.dtype for p in bserver.parameters()} != {torch.bfloat16}:
            raise AssertionError("clients_mesh: the bf16 U-Net is not bf16")
        yb = torch.from_numpy(y0).cuda()
        bkey = prng.fold_in(prng.PRNGKey(RT_SEED), 10).cuda()
        t0 = time.perf_counter()
        bf = [collaborative_sample(bserver, bclient, bkey, yb, (B,) + IMG,
                                   sched, cut, unet_apply)
              for _ in range(2)]
        torch.cuda.synchronize()
        bf_s = (time.perf_counter() - t0) / 2
        if not torch.equal(bf[0], bf[1]) or bf[0].dtype != torch.float32 \
                or not torch.isfinite(bf[0]).all():
            raise AssertionError("clients_mesh: the bf16 U-Net's sample is "
                                 "not bitwise across two runs, or not "
                                 "finite float32")
        launches = dict(dkernel.COUNTS)          # --- clients_mesh ends
        # two engine passes of T - t_cut server and t_cut client steps,
        # two per-request samples of T steps
        check_ddpm_launches("clients_mesh", launches, 2 * cut.T, 2 * cut.T)
        log(f"clients_mesh/bf16_sample: T={cut.T} cut {cut.t_cut} batch {B} "
            f"from bf16 CONFIG U-Nets, bitwise across two runs, wall_s "
            f"{bf_s:.3f} a sample; launches {launches}")
        reck = collective_reckoning(nbytes[-1])
        log("clients_mesh/round: wall ms (events) unsharded "
            + ", ".join(f"{w:.3f}" for w in walls["unsharded"])
            + "; sharded " + ", ".join(f"{w:.3f}" for w in walls["sharded"])
            + f"; device ms (profiler, round {CM_ROUNDS}) unsharded "
            f"{fmt_ms(dev_ms['unsharded'])}, sharded "
            f"{fmt_ms(dev_ms['sharded'])}; bytes a round handed to the "
            "collectives on the one-rank mesh (nothing crosses a link): "
            + "; ".join(f"round {i + 1} (tier {b['tier']}): all_reduce "
                        f"{b.get('all_reduce', 0)}, broadcast "
                        f"{b.get('broadcast', 0)}, all_gather "
                        f"{b.get('all_gather', 0)}"
                        for i, b in enumerate(nbytes))
            + "; reckoned per rank for the last round at "
            + ", ".join(f"{w} ranks {v['bytes']:.0f} B, "
                        f"{v['bound_ms']:.4f} ms at NVLINK_BW"
                        for w, v in reck.items())
            + f"; card {card}")
    finally:
        dist.destroy_process_group()
    del runs, rt, bserver, bclient
    gc.collect()
    torch.cuda.empty_cache()
    log(f"clients_mesh/phase_s: {time.perf_counter() - t_phase:.1f}")
    return launches


def ssd_range_check(out, ref, what: str) -> float:
    """max |out - ref| over max(1, max |ref|), which must stay within
    SSD_BF16_RANGE (bf16 SSD outputs at p = 64, where |y| reaches ~100)."""
    err = (out.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    if not err <= SSD_BF16_RANGE * scale:
        raise AssertionError(f"{what}: max abs {err:.3g} > {SSD_BF16_RANGE}"
                             f" x {scale:.3g}")
    return err / scale


def phase_flash_ssd():
    """Flash attention and the SSD scan against their plain versions on
    the card at the JAX package's test shapes, float32 and bfloat16."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssd_scan import kernel as skernel
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    g = torch.Generator(device="cuda").manual_seed(1)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")

    def check(out, ref, tol, what):
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.allclose(out.float(), ref.float(), **tol):
            raise AssertionError(f"{what}: max abs {err:.3g} beyond {tol}")
        return err

    flash_cases = [(shape, c, 0) for shape in FLASH_SWEEP
                   for c in (True, False)] + \
        [((1, 4, 1, 96, 32), c, w) for w in FLASH_WINDOWS
         for c in (True, False)] + \
        [(shape, c, w) for shape, w in FLASH_WGMMA for c in (True, False)]
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        tol = TOL_FLASH if dtype == torch.float32 else TOL_BF16
        errs = []
        fkernel.reset_counts()
        for (Bq, H, Hkv, S, dh), causal, window in flash_cases:
            q = rn(Bq, H, S, dh).to(dtype)
            k, v = rn(Bq, Hkv, S, dh).to(dtype), rn(Bq, Hkv, S, dh).to(dtype)
            out = fops.flash_attention(q, k, v, causal=causal, window=window)
            ref = attention_ref(q, k, v, causal=causal, window=window)
            errs.append(check(out, ref, tol, f"flash_attention "
                              f"{(Bq, H, Hkv, S, dh)} causal {causal} "
                              f"window {window} {tag}"))
        variants = {v: fkernel.COUNTS[f"flash_attention/{v}"]
                    for v in fkernel.VARIANTS}
        log(f"kernel/flash_attention {tag}: {len(flash_cases)} cases "
            f"(sweep x causal, window 8/24/64 x causal, wgmma shapes) "
            f"max_abs_err {max(errs):.3g} within {tol}; launches per "
            f"variant {variants}")
        want = {"simt"} if dtype == torch.float32 else {"wgmma", "simt"}
        if {v for v, n in variants.items() if n} != want:
            raise AssertionError(f"flash {tag}: variants {variants}, "
                                 f"expected launches of {sorted(want)}")
        tol = TOL_SSD if dtype == torch.float32 else TOL_BF16
        errs, range_errs = [], []
        skernel.reset_counts()
        wgmma_shapes = SSD_WGMMA if dtype == torch.bfloat16 else []
        for shape in SSD_SWEEP + wgmma_shapes:
            b, s, h, p, n, chunk = shape
            x = rn(b, s, h, p).to(dtype)
            dt = F.softplus(rn(b, s, h) - 1)
            A = -torch.exp(rn(h))
            Bm, Cm = rn(b, s, n).to(dtype), rn(b, s, n).to(dtype)
            y, fs = sops.ssd_scan(x, dt, A, Bm, Cm, chunk)
            yr, fr = ssd_chunked(x, dt, A, Bm, Cm, chunk)
            what = f"ssd_scan {shape} {tag}"
            if shape in SSD_SWEEP:
                errs.append(max(check(y, yr, tol, what + " y"),
                                check(fs, fr, tol, what + " state")))
                continue
            range_errs.append(max(ssd_range_check(y, yr, what + " y"),
                                  ssd_range_check(fs, fr, what + " state")))
        variants = {v: skernel.COUNTS[f"ssd_scan/{v}"]
                    for v in skernel.VARIANTS}
        log(f"kernel/ssd_scan {tag}: {len(SSD_SWEEP)} sweep shapes "
            f"max_abs_err {max(errs):.3g} within {tol}" +
            (f"; {len(SSD_WGMMA)} wgmma shapes max_abs_err over max(1, "
             f"max |plain|) {max(range_errs):.3g} within {SSD_BF16_RANGE}"
             if range_errs else "") + f"; launches per variant {variants}")
        want = {"simt"} if dtype == torch.float32 else {"wgmma", "simt"}
        if {v for v, n in variants.items() if n} != want:
            raise AssertionError(f"ssd_scan {tag}: variants {variants}, "
                                 f"expected launches of {sorted(want)}")


def phase_mamba_mixer():
    """The Mamba2 mixer's glue kernels (kernels/mamba_mixer) against the
    eager route they take over (models/ssm.py ``_causal_conv`` and
    ``layers.rmsnorm`` with the mixer's D skip and gate around it), at
    LM_ARCH's widths in bf16 (d 2,048, d_inner 4,096, state 64, 64 heads
    of 64, conv width 4) and the main paths' shapes: the benchmark DiT's
    64 images x 64 tokens and the LM prefill's LM_BATCH x each of
    LM_PROMPTS.  Each output bitwise the eager one; planted faults of the
    eager version (the causal window shifted by one, the bias dropped, the
    gate skipped, inv left in float32) must differ.  Each kernel timed
    (events) beside its eager composition and its bound.  Returns the
    three kernels' records at the DiT's shape, each with its numbers at
    the first LM prefill (``lm_prefill``)."""
    import types
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.mamba_mixer import kernel as mkernel
    from repro_torch.models import ssm
    from repro_torch.models.layers import rmsnorm

    cfg = get_arch(LM_ARCH)
    d, di, n, h, p, k, eps = (cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state,
                              cfg.ssm_n_heads, cfg.ssm_head_dim,
                              cfg.ssm_conv_kernel, cfg.norm_eps)
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(3)
    rn = lambda *shape, s=1.0: (torch.randn(shape, generator=g,
                                            device="cuda") * s).to(bf16)
    wx, bx, wbc, bbc = rn(k, di, s=0.5), rn(di, s=0.5), rn(k, 2 * n, s=0.5), \
        rn(2 * n, s=0.5)
    sc_d, sc_di = 1 + rn(d, s=0.1), 1 + rn(di, s=0.1)
    D = torch.randn(h, generator=g, device="cuda")
    norm = lambda t, sc: rmsnorm(types.SimpleNamespace(scale=sc), t, eps)

    def gated(y, xc, z, gate=True):
        b, s = y.shape[:2]
        u = (y.reshape(b, s, h, p) + xc.reshape(b, s, h, p) *
             D[None, None, :, None].to(bf16)).reshape(b, s, di)
        return norm(u * F.silu(z) if gate else u, sc_di)

    def conv(xr, bcr, shift=False, bias=True):
        if shift:
            xr = torch.cat([torch.zeros_like(xr[:, :1]), xr[:, :-1]], dim=1)
        xc = ssm._causal_conv(xr, wx, bx if bias else torch.zeros_like(bx))
        bc = ssm._causal_conv(bcr, wbc, bbc)
        return xc, bc[..., :n].contiguous(), bc[..., n:].contiguous()

    def inv_float32(x):
        x32 = x.float()
        inv = torch.rsqrt((x32 * x32).sum(-1, keepdim=True) / d + eps)
        return (x * inv * sc_d).to(bf16)

    shapes = {"dit": (64, 64), **{f"lm_prefill S={S}": (LM_BATCH, S)
                                  for S in LM_PROMPTS}}
    records = {}
    for tag, (b, s) in shapes.items():
        x, xr, bcr = rn(b, s, d), rn(b, s, di), rn(b, s, 2 * n)
        y, z = rn(b, s, di), rn(b, s, di)
        mkernel.reset_counts()
        xc, Bm, Cm = mkernel.launch_conv_silu(xr, bcr, wx, bx, wbc, bbc)
        got = {"xc": xc, "B": Bm, "C": Cm,
               "xn": mkernel.launch_rmsnorm(x, sc_d, eps),
               "out": mkernel.launch_rmsnorm(y, sc_di, eps, xc, D, z)}
        ref_xc, ref_b, ref_c = conv(xr, bcr)
        want = {"xc": ref_xc, "B": ref_b, "C": ref_c, "xn": norm(x, sc_d),
                "out": gated(y, ref_xc, z)}
        torch.cuda.synchronize()
        if dict(mkernel.COUNTS) != dict.fromkeys(MIXER_KERNELS, 1):
            raise AssertionError(f"mamba_mixer {tag}: launches "
                                 f"{mkernel.COUNTS}")
        bad = {o: int((got[o] != want[o]).sum()) for o in got
               if not torch.equal(got[o], want[o])}
        if bad:
            raise AssertionError(f"mamba_mixer {tag}: values differing from "
                                 f"the eager route {bad}")
        faults = {"causal window shifted by one":
                  ("xc", conv(xr, bcr, shift=True)[0]),
                  "bias dropped": ("xc", conv(xr, bcr, bias=False)[0]),
                  "gate skipped": ("out", gated(y, ref_xc, z, gate=False)),
                  "inv left in float32": ("xn", inv_float32(x))}
        caught = {f: int((got[o] != v).sum()) for f, (o, v) in faults.items()}
        if not all(caught.values()):
            raise AssertionError(f"mamba_mixer {tag}: planted faults not "
                                 f"caught {caught}")
        log(f"kernel/mamba_mixer at the {tag} shape ({b} x {s} tokens, bf16):"
            f" conv_silu (x, B, C), the input norm and the gated output norm "
            f"bitwise the eager route; planted faults differ in {caught} "
            f"values")
        parts = {
            "mamba_conv_silu": (
                lambda: mkernel.launch_conv_silu(xr, bcr, wx, bx, wbc, bbc),
                lambda: conv(xr, bcr),
                mixer_cost.conv_silu_cost(b * s, di + 2 * n, k, 2)),
            "mamba_rmsnorm": (
                lambda: mkernel.launch_rmsnorm(x, sc_d, eps),
                lambda: norm(x, sc_d), mixer_cost.rmsnorm_cost(b * s, d, 2)),
            "mamba_rmsnorm_gated": (
                lambda: mkernel.launch_rmsnorm(y, sc_di, eps, xc, D, z),
                lambda: gated(y, ref_xc, z),
                mixer_cost.rmsnorm_cost(b * s, di, 2, h))}
        for name, (fused, eager, (nbytes, flops)) in parts.items():
            ms, plain = time_ms(fused), time_ms(eager)
            bnd, by = _bound(nbytes, flops, FP32_FLOPS_PER_S)
            rec = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bnd,
                       bound_by=by, library_ms=None)
            log(f"kernel/{name} at the {tag} shape: kernel {ms * 1e3:.2f} us "
                f"(eager composition {plain * 1e3:.2f} us) bound "
                f"{bnd * 1e3:.3f} us ({by}), {100 * bnd / ms:.1f}% of it")
            if tag == "dit":
                records[name] = rec
            elif "lm_prefill" not in records[name]:
                records[name]["lm_prefill"] = rec
    return records


@contextlib.contextmanager
def capture_calls(targets, limit: int = 1, clone: bool = True):
    """While active, each op of ``targets`` ({name: (module, attribute)})
    keeps the (args, kwargs, output) of its first ``limit`` calls in the
    yielded {name: [...]}; tensor arguments are cloned unless ``clone``
    is False (a model's weights are passed as they are)."""
    import torch
    captured = {name: [] for name in targets}
    orig = {name: getattr(mod, attr)
            for name, (mod, attr) in targets.items()}

    def wrap(name, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            if len(captured[name]) < limit:
                captured[name].append((
                    [a.clone() if clone and torch.is_tensor(a) else a
                     for a in args], dict(kw), out))
            return out
        return wrapped

    for name, (mod, attr) in targets.items():
        setattr(mod, attr, wrap(name, orig[name]))
    try:
        yield captured
    finally:
        for name, (mod, attr) in targets.items():
            setattr(mod, attr, orig[name])


def init_dits(tag, arch, dcfg, key, between=None):
    """Server and client DiTs drawn on the card from ``split(key, 4)``;
    ``between(server)``, if given, runs after the server is drawn and
    before the clients are (its time is not the init's)."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.dit import init_dit
    ks, *kc = prng.split(key, len(DIT_CUTS) + 1)
    t0 = time.perf_counter()
    sp = init_dit(ks, arch, dcfg, "cuda")
    if between is not None:
        torch.cuda.synchronize()
        t_between = time.perf_counter()
        between(sp)
        t0 += time.perf_counter() - t_between
    cp = [init_dit(k, arch, dcfg, "cuda") for k in kc]
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in sp.parameters())
    log(f"{tag}/init: {len(cp) + 1} {arch.name} DiTs of {n_params} "
        f"parameters ({arch.dtype}, {arch.n_layers} layers, "
        f"{dcfg.n_patches} tokens) in {time.perf_counter() - t0:.2f} s; "
        f"device memory {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    return sp, cp


def dit_inputs(n_classes: int):
    """One forward's (x, t, y) of batch B on the card, from numpy seed 0."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B,) + IMG).astype(
        np.float32)).cuda()
    t = torch.from_numpy(rng.uniform(1.0, DIT_T, B).astype(np.float32)).cuda()
    y = torch.from_numpy(np.eye(n_classes, dtype=np.float32)[
        rng.integers(0, n_classes, B)]).cuda()
    return x, t, y


def dit_forward_stats(tag, apply_fn, sp, xty, per_fwd, kmods, cards=()):
    """Check the launches of one forward, then log its wall time (CUDA
    events) and its device time with the top device kernels.  Returns the
    wall ms per forward and, for each (counter, kernel name) of ``cards``,
    the kernel's card ms per launch: its device time in the forward's
    profile over its launches per forward (None if not measured)."""
    import torch
    with torch.no_grad():
        for kmod in kmods:
            kmod.reset_counts()
        apply_fn(sp, *xty)
        one = {}
        for kmod in kmods:
            one.update(kmod.COUNTS)
        if one != per_fwd:
            raise AssertionError(f"{tag}: launches per forward {one} != "
                                 f"{per_fwd}")
        fwd_ms = time_ms(lambda: apply_fn(sp, *xty), iters=20, warmup=3)
    log(f"{tag}/forward_ms (B={B}, wall per call, eager): {fwd_ms:.3f}; "
        f"launches per forward {one}")
    parts = device_ms(tag, lambda: apply_fn(sp, *xty), top=10,
                      shares=[kname for _, kname in cards])
    card = {}
    for counter, kname in cards:
        ms = parts[kname]
        card[counter] = None if ms is None else ms / per_fwd[counter]
        log(f"{tag}/card_ms per launch of {kname} (profiler, in the "
            f"forward): {fmt_ms(card[counter])}")
    return fwd_ms, card


def dit_serve_path(tag, sp, cp, apply_fn, n_classes, key, fwd_ms, per_fwd,
                   kmods):
    """The DiT main path: one per-request sample (T=DIT_SAMPLE_T), then
    one serve pass (T=DIT_T, DIT_CUTS), with the launch counters of
    ``kmods`` and the DDPM step zeroed just before and read just after;
    then the pass against ``sample_plan_reference``, bitwise.  Returns
    the launches."""
    import numpy as np
    import torch
    from repro_torch.core import prng
    from repro_torch.core.sample_plan import (SampleRequest, plan_requests,
                                              stable_group_seed)
    from repro_torch.core.sampler import (make_per_request_sampler,
                                          sample_plan_reference)
    from repro_torch.core.schedules import DiffusionSchedule
    from repro_torch.kernels.ddpm_step import kernel as dkernel
    from repro_torch.serve import ServeConfig, ServeRuntime

    T = DIT_T
    sched = DiffusionSchedule.linear(T, device="cuda")
    sample_sched = DiffusionSchedule.linear(DIT_SAMPLE_T, device="cuda")
    eye = np.eye(n_classes, dtype=np.float32)
    queue = [SampleRequest(client=c, t_cut=cut,
                           y=np.broadcast_to(eye[c], (B, n_classes)).copy())
             for c, cut in enumerate(DIT_CUTS)]
    rt = ServeRuntime(ServeConfig(T=T, image_shape=IMG, max_wave=4,
                                  policy="depth", cache=True),
                      sp, cp, apply_fn, sched, key, device="cuda")
    sampler = make_per_request_sampler(sample_sched, apply_fn, (B,) + IMG)
    y1 = torch.from_numpy(queue[1].y).cuda()
    steps = rt.registry.counter("scan_steps")
    steps0 = steps.value
    kmods = (dkernel,) + tuple(kmods)
    torch.cuda.synchronize()
    for kmod in kmods:                           # --- main path starts
        kmod.reset_counts()
    t0 = time.perf_counter()
    single = sampler(DIT_SAMPLE_CUT)(sp, cp[1], prng.fold_in(key, 7), y1)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    outs, rep = rt.process(queue)
    torch.cuda.synchronize()
    launches = {}
    for kmod in kmods:
        launches.update(kmod.COUNTS)
    n_steps = steps.value - steps0               # --- main path ends

    if tuple(single.shape) != (B,) + IMG or not torch.isfinite(single).all():
        raise AssertionError(f"{tag}: per-request sample not finite")
    for o in outs:
        if tuple(o.shape) != (B,) + IMG or not torch.isfinite(o).all():
            raise AssertionError(f"{tag} pass: bad output {tuple(o.shape)}")
    calls = rep["server_calls_physical"] + rep["client_calls_physical"]
    forwards = DIT_SAMPLE_T + calls
    log(f"{tag}/per_request_sample: T={DIT_SAMPLE_T} cut {DIT_SAMPLE_CUT} "
        f"batch {B} wall_s {single_s:.3f} ({DIT_SAMPLE_T} forwards)")
    log(f"{tag}/pass: wall_s {rep['wall_s']:.3f} req_per_s "
        f"{rep['req_per_s']:.4f} samples_per_s {rep['samples_per_s']:.4f} "
        f"waves {rep['waves']} server_calls_physical "
        f"{rep['server_calls_physical']} client_calls_physical "
        f"{rep['client_calls_physical']} scan steps {n_steps}; model calls "
        f"x forward wall {calls * fwd_ms / 1e3:.2f} s")
    log(f"{tag}/launches: {launches} for {forwards} forwards, {n_steps} "
        f"batched and {DIT_SAMPLE_T} per-request steps")
    for name, n in per_fwd.items():
        if launches[name] != n * forwards:
            raise AssertionError(f"{tag}: {name} launches {launches[name]} "
                                 f"!= {n} x {forwards} forwards")
    check_ddpm_launches(tag, launches, DIT_SAMPLE_T, n_steps)

    t0 = time.perf_counter()
    for rid, req in enumerate(queue):       # a fresh runtime: rid = order
        plan = plan_requests([req], T, adjusted=rt.config.adjusted,
                             n_clients=len(cp),
                             server_stride=rt.config.server_stride,
                             group_seed_fn=stable_group_seed,
                             request_seeds=[rid], device="cuda")
        ref_out, _ = sample_plan_reference(sp, cp, key, plan, sched,
                                           apply_fn, IMG)
        if not torch.equal(ref_out[0], outs[rid]):
            diff = (ref_out[0] - outs[rid]).abs().max().item()
            raise AssertionError(f"{tag} pass request {rid} != "
                                 f"sample_plan_reference (max abs {diff})")
    log(f"{tag}/pass_vs_reference: bitwise equal, {len(queue)} requests "
        f"({time.perf_counter() - t0:.1f} s)")
    return launches


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def flash_rows_bitwise(tag, fkernel, q, k, v, out) -> None:
    """Flash's rows of batch 1 (a launch over q[:1], k[:1], v[:1]) must
    equal the first batch row of ``out``, computed at the full batch."""
    import torch
    one = fkernel.launch(q[:1], k[:1], v[:1], False, 0)
    if not torch.equal(one, out[:1]):
        raise AssertionError(f"{tag} flash_attention: rows of batch 1 != "
                             f"those of batch {q.shape[0]}")
    log(f"{tag}/flash_attention: rows of batch 1 equal those of batch "
        f"{q.shape[0]} bitwise")


def ssd_rows_bitwise(tag, skernel, cargs, chunk, y, fs) -> None:
    """The SSD scan's rows of batch 1 (a launch over the first batch row)
    must equal the first batch row of ``y`` and ``fs``, computed at the
    full batch."""
    import torch
    x, dt, A, Bm, Cm = cargs
    y1, fs1 = skernel.launch(x[:1], dt[:1], A, Bm[:1], Cm[:1], chunk)
    if not (torch.equal(y1, y[:1]) and torch.equal(fs1, fs[:1])):
        raise AssertionError(f"{tag} ssd_scan: rows of batch 1 != those of "
                             f"batch {x.shape[0]}")
    log(f"{tag}/ssd_scan: rows of batch 1 equal those of batch "
        f"{x.shape[0]} bitwise (y and final state)")


BWD_VARIANTS = {"flash_attention": ("wgmma", "simt"),
                "ssd_scan": ("wgmma", "simt"),
                "grouped_matmul": ("wgmma", "wmma", "simt")}


def no_bwd(*names) -> dict:
    """Zero backward launches of the kernels ``names`` (flash_attention,
    ssd_scan, grouped_matmul): the entries a forward-only path's launch
    counts hold."""
    return {k: 0 for name in names
            for k in (f"{name}_bwd", *(f"{name}_bwd/{v}"
                                       for v in BWD_VARIANTS[name]))}


def dit_grad_check(tag, apply_fn, sp, xty, per_fwd, kmods) -> dict:
    """One Alg.-1 loss (``mse_eps_loss``) and its backward through the
    full-width DiT on the card, counters zeroed just before: every
    parameter gets a finite gradient, nonzero somewhere, and the forward's
    flash and SSD launches come with as many backward launches.  Returns
    the launches."""
    import torch
    from repro_torch.core.protocol import mse_eps_loss
    x, t, y = xty
    eps = torch.randn(x.shape, generator=torch.Generator(
        device="cuda").manual_seed(4), device="cuda")
    names, params = zip(*sp.named_parameters())
    for kmod in kmods:
        kmod.reset_counts()
    t0 = time.perf_counter()
    with torch.enable_grad():
        loss = mse_eps_loss(apply_fn, sp, x, t, y, eps)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = lm_counts(*kmods)
    want = with_backward(per_fwd, "flash_attention", "ssd_scan")
    if got != want:
        raise AssertionError(f"{tag}: launches of a loss and its backward "
                             f"{got}, expected {want}")
    bad = [n for n, g in zip(names, grads)
           if g is None or not torch.isfinite(g).all()]
    zero = [n for n, g in zip(names, grads) if g is not None and
            not bool(g.abs().max() > 0)]
    if bad or not torch.isfinite(loss) or len(zero) == len(names):
        raise AssertionError(f"{tag}: gradients missing or not finite on "
                             f"{bad[:5]} ({len(bad)} of {len(names)})")
    gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads)).item()
    log(f"{tag}/grad: mse_eps_loss {loss.item():.5f} and its backward "
        f"through the full-width DiT in {wall:.3f} s (first call): finite "
        f"gradients on all {len(names)} parameters ({len(zero)} all-zero), "
        f"global norm {gnorm:.5g}; launches {got}")
    return got


@contextlib.contextmanager
def plain_expert_products():
    """While active, the MoE's expert products run through the grouped
    matmul's plain versions on the card, as one autograd Function:
    ``grouped_matmul_ref`` forward, ``grouped_matmul_bwd_ref`` backward
    (its algorithm, held against autograd of the forward and JAX's vjp in
    tests/test_torch_gmm_bwd.py).  It saves the bf16 operands as they
    are: autograd of the float32 einsum would keep float32 copies of the
    2.1 GB weights."""
    import torch
    from repro_torch.kernels.grouped_matmul.ref import (
        grouped_matmul_bwd_ref, grouped_matmul_ref)
    from repro_torch.models import moe

    class PlainFn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, tokens, weights):
            ctx.save_for_backward(tokens, weights)
            return grouped_matmul_ref(tokens, weights)

        @staticmethod
        def backward(ctx, dout):
            return grouped_matmul_bwd_ref(*ctx.saved_tensors, dout)

    orig = moe.gmm_ops.grouped_matmul
    moe.gmm_ops.grouped_matmul = PlainFn.apply
    try:
        yield
    finally:
        moe.gmm_ops.grouped_matmul = orig


def with_backward(per_fwd: dict, *names, variant=None) -> dict:
    """The launches of a forward and its backward: ``per_fwd`` with each
    kernel of ``names`` launched backward as often as forward, all on
    ``variant`` (default each kernel's first backward variant, the
    tensor-core one)."""
    want = dict(per_fwd)
    for name in names:
        ran = variant or BWD_VARIANTS[name][0]
        want[f"{name}_bwd"] = per_fwd[name]
        for v in BWD_VARIANTS[name]:
            want[f"{name}_bwd/{v}"] = per_fwd[name] if v == ran else 0
    return want


def moe_dit_grad_check(tag, apply_fn, sp, xty, per_fwd, kmods) -> dict:
    """(c) One Alg.-1 loss (``mse_eps_loss``) and its backward through the
    full-width MoE DiT, counters zeroed just before: as many grouped-matmul
    and flash backward launches as forward ones, on the tensor-core
    variants; every gradient leaf within LM_GRAD_RTOL (‖g − r‖ / ‖r‖)
    of the same loss's with the expert products through the plain versions
    (``plain_expert_products``), while the plain gradients of another
    noise put the median leaf beyond it.  Returns the launches."""
    import torch
    from repro_torch.core.protocol import mse_eps_loss
    x, t, y = xty
    gen = torch.Generator(device="cuda").manual_seed(4)
    eps, other = (torch.randn(x.shape, generator=gen, device="cuda")
                  for _ in range(2))
    names, params = zip(*sp.named_parameters())

    def grads_of(noise):
        with torch.enable_grad():
            loss = mse_eps_loss(apply_fn, sp, x, t, y, noise)
            return loss.detach(), dict(zip(names, torch.autograd.grad(
                loss, params)))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kmod in kmods:
        kmod.reset_counts()
    t0 = time.perf_counter()
    loss, grads = grads_of(eps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = lm_counts(*kmods)
    want = with_backward(per_fwd, "grouped_matmul", "flash_attention")
    if got != want:
        raise AssertionError(f"{tag}: launches of a loss and its backward "
                             f"{got}, expected {want}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    bad = [n for n, g in grads.items() if not torch.isfinite(g).all()]
    if bad or not torch.isfinite(loss):
        raise AssertionError(f"{tag}: gradients not finite on {bad[:5]}")
    with plain_expert_products():
        ref_loss, ref = grads_of(eps)
        gaps = grad_gaps(grads, ref)
        del ref
        _, ref_other = grads_of(other)
        control = grad_gaps(grads, ref_other)
        del ref_other
    worst = max(gaps, key=gaps.get)
    median = lambda d: sorted(d.values())[len(d) // 2]
    log(f"{tag}/grad: mse_eps_loss {loss.item():.6f} (plain expert "
        f"products {ref_loss.item():.6f}) and its backward through the "
        f"full-width MoE DiT in {wall:.3f} s (first call), peak memory "
        f"{peak:.2f} GB; {len(names)} gradient leaves against the plain "
        f"products' ‖k − r‖ / ‖r‖: median {median(gaps):.4g}, worst "
        f"{gaps[worst]:.4g} ({worst}), limit {LM_GRAD_RTOL}; control "
        f"(another noise): median {median(control):.4g}; launches {got}")
    if not gaps[worst] <= LM_GRAD_RTOL:
        raise AssertionError(f"{tag}: gradient leaf {worst} "
                             f"{gaps[worst]:.3g} beyond {LM_GRAD_RTOL}")
    if not median(control) > LM_GRAD_RTOL:
        raise AssertionError(f"{tag}: the gradient check passed another "
                             "noise's gradients")
    del grads
    torch.cuda.empty_cache()
    return got


def moe_runtime_round(dcfg) -> dict:
    """(c) A ``TrainRuntime`` round whose denoisers are MoE DiTs, at the
    reduced DBRX-132B widths in bf16 (two float32 AdamW states of a
    full-width one would not fit beside it: PERF.md section 4): one
    client with one batch of B images, cut 250 of T=1000.  The round must
    complete (``round == 1``), move the server's parameters and leave its
    moments finite, through the grouped matmul's backward kernel in the
    variant that ``choose_variant_backward`` picks at these widths
    (``wgmma``).  The leaves that keep their bits must be the RMSNorm
    scales (``*.scale``, all 1.0 at init), each with a nonzero first
    moment: AdamW's first step moves a leaf by about the learning rate,
    under half a bf16 ulp at 1.0 (2^-9 below it).  Returns the launches
    of the round."""
    import torch
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.core import prng
    from repro_torch.core.dit import init_dit, make_dit_apply
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.grouped_matmul import kernel as gkernel
    from repro_torch.train import ParticipationConfig, TrainConfig, \
        TrainRuntime
    small = dataclasses.replace(reduced(get_arch(MOE_ARCH)),
                                dtype="bfloat16")
    cfg = TrainConfig(T=1000, t_cut=250, image_shape=IMG,
                      n_classes=dcfg.n_classes, batch_size=B,
                      batches_per_round=1,
                      participation=ParticipationConfig(policy="full"))
    rt = TrainRuntime(cfg, lambda k: init_dit(k, small, dcfg, "cuda"),
                      make_dit_apply(small, dcfg), prng.PRNGKey(0),
                      device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    eye = torch.eye(dcfg.n_classes, device="cuda")
    rt.register_client(torch.randn((B,) + IMG, generator=gen, device="cuda"),
                       eye[torch.arange(B, device="cuda") % dcfg.n_classes])
    before = {n: p.detach().clone()
              for n, p in rt.server_params.named_parameters()}
    for kmod in (fkernel, gkernel):
        kmod.reset_counts()
    t0 = time.perf_counter()
    rt.run_round()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = lm_counts(fkernel, gkernel)
    moved = sum(not torch.equal(p, before[n])
                for n, p in rt.server_params.named_parameters())
    finite = all(torch.isfinite(v).all() for w in ("m", "v")
                 for v in rt.server_opt[w].values())
    still = sorted(n for n, p in rt.server_params.named_parameters()
                   if torch.equal(p, before[n]))
    scales = sorted(n for n in before if n.endswith(".scale"))
    first_m = {n: rt.server_opt["m"][n].float().abs().max().item()
               for n in still}
    E, D, F = small.n_experts, small.d_model, small.d_ff
    variant = gkernel.choose_variant_backward(      # at the round's widths
        *(torch.zeros(s, device="cuda", dtype=torch.bfloat16)
          for s in ((E, B, D), (E, D, F), (E, B, F))))
    log(f"moe/runtime_round: TrainRuntime.run_round with reduced "
        f"{MOE_ARCH} DiTs (bf16): round {rt.round}, {moved} of "
        f"{len(before)} server parameters moved, moments finite {finite}, "
        f"{wall:.2f} s (first call); the {len(still)} that kept their "
        f"bits (lr {cfg.lr}, half a bf16 ulp below 1.0 is {2 ** -9}): "
        f"{', '.join(f'{n} (max |m| {m:.3g})' for n, m in first_m.items())};"
        f" backward variant {variant}; launches {got}")
    if rt.round != 1 or not moved or not finite or variant != "wgmma" or \
            not got[f"grouped_matmul_bwd/{variant}"]:
        raise AssertionError("moe: the MoE TrainRuntime round did not "
                             "train through the grouped matmul's backward")
    if still != scales or not all(first_m.values()) or \
            not cfg.lr < 2 ** -9:
        raise AssertionError(f"moe: the round's unmoved leaves {first_m} "
                             f"are not the RMSNorm scales {scales} with "
                             "their gradients")
    del rt, before
    torch.cuda.empty_cache()
    return got


def phase_dit():
    """The DiT path at full width.  Returns (kernel records at the DiT's
    shapes, launches of the path's run)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_arch
    from repro_torch.core import prng
    from repro_torch.core.dit import DiTConfig, make_dit_apply
    from repro_torch.device import deterministic_cuda
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.mamba_mixer import kernel as mkernel
    from repro_torch.kernels.ssd_scan import kernel as skernel
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    from repro_torch.models.hybrid import _grouping

    deterministic_cuda()
    arch = get_arch(DIT_ARCH)
    dcfg = DiTConfig(image_size=IMG[0], channels=IMG[2], patch_size=4,
                     n_classes=8)
    apply_fn = make_dit_apply(arch, dcfg)
    n_attn = _grouping(arch)[1]
    per_fwd = {"flash_attention": n_attn, "flash_attention/wgmma": n_attn,
               "flash_attention/simt": 0, "ssd_scan": arch.n_layers,
               "ssd_scan/wgmma": arch.n_layers, "ssd_scan/simt": 0,
               **no_bwd("flash_attention", "ssd_scan"),
               **dict.fromkeys(MIXER_KERNELS, arch.n_layers)}
    kmods = (fkernel, skernel, mkernel)
    key = prng.PRNGKey(0, device="cuda")
    sp, cp = init_dits("dit", arch, dcfg, key)
    xty = dit_inputs(dcfg.n_classes)

    # the inputs the first forward feeds each kernel
    with capture_calls({"flash_attention": (fops, "flash_attention"),
                        "ssd_scan": (sops, "ssd_scan")}) as captured, \
            torch.no_grad():
        eps = apply_fn(sp, *xty)
        torch.cuda.synchronize()
    if eps.shape != xty[0].shape or not torch.isfinite(eps).all():
        raise AssertionError(f"dit: bad forward {tuple(eps.shape)}")
    # with autograd every mixer keeps the eager route: no glue kernel
    dit_grad_check("dit", apply_fn, sp, xty,
                   {**per_fwd, **dict.fromkeys(MIXER_KERNELS, 0)}, kmods)

    records = {}
    (q, k, v), kw, out = captured["flash_attention"][0]
    if kw != {"causal": False, "window": 0}:
        raise AssertionError(f"dit: shared block called attention with {kw}")
    ref = attention_ref(q, k, v, **kw)
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(), **TOL_BF16):
        raise AssertionError(f"dit flash_attention: max abs {err:.3g}")
    qc, kc_, vc = q.contiguous(), k.contiguous(), v.contiguous()
    flash_rows_bitwise("dit", fkernel, qc, kc_, vc, out)
    ms = time_ms(lambda: fkernel.launch(qc, kc_, vc, False, 0))
    plain = time_ms(lambda: attention_ref(q, k, v, **kw))
    lib = time_ms(lambda: F.scaled_dot_product_attention(qc, kc_, vc))
    bnd, by = flash_bound(q, k, False, 0)
    records["flash_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                      bound_ms=bnd, bound_by=by,
                                      library_ms=lib)
    log(f"kernel/flash_attention at the DiT's {tuple(q.shape)} {q.dtype} "
        f"({fkernel.choose_variant(qc, kc_, vc)}): max_abs_err {err:.3g} "
        f"kernel {ms * 1e3:.2f} us plain {plain * 1e3:.2f} us sdpa "
        f"{lib * 1e3:.2f} us bound {bnd * 1e3:.3f} us ({by})")

    (xs, dt, A, Bm, Cm, chunk), _, (yk, fk) = captured["ssd_scan"][0]
    yr, fr = ssd_chunked(xs, dt, A, Bm, Cm, chunk)
    errs = []
    for name, a, r in (("y", yk, yr), ("state", fk, fr)):
        e = (a.float() - r.float()).abs().max().item()
        lim = SSD_BF16_RANGE * max(1.0, r.float().abs().max().item())
        if not e <= lim:
            raise AssertionError(f"dit ssd_scan {name}: max abs {e:.3g} > "
                                 f"{lim:.3g}")
        errs.append(e)
        log(f"kernel/ssd_scan at the DiT's shape, {name}: max_abs_err "
            f"{e:.3g} (limit {lim:.3g}, max |plain| "
            f"{r.float().abs().max().item():.3g})")
    cargs = (xs.contiguous(), dt.float().contiguous(), A.float().contiguous(),
             Bm.to(xs.dtype).contiguous(), Cm.to(xs.dtype).contiguous())
    ssd_rows_bitwise("dit", skernel, cargs, chunk, yk, fk)
    ms = time_ms(lambda: skernel.launch(*cargs, chunk))
    simt = time_ms(lambda: skernel.launch(*cargs, chunk, variant="simt"))
    plain = time_ms(lambda: ssd_chunked(xs, dt, A, Bm, Cm, chunk))
    bnd, by = ssd_bound(xs, Bm, chunk)
    records["ssd_scan"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain,
                               bound_ms=bnd, bound_by=by, library_ms=None,
                               simt_ms=simt)
    variant = skernel.choose_variant(cargs[0], *cargs[3:])
    log(f"kernel/ssd_scan at the DiT's {tuple(xs.shape)} n {Bm.shape[-1]} "
        f"chunk {chunk} {xs.dtype} ({variant}): "
        f"kernel {ms * 1e3:.2f} us simt {simt * 1e3:.2f} us plain "
        f"{plain * 1e3:.2f} us bound {bnd * 1e3:.3f} us ({by}); "
        "library_ms: null (no PyTorch call computes the SSD scan)")

    fwd_ms, card = dit_forward_stats(
        "dit", apply_fn, sp, xty, per_fwd, kmods,
        cards=[("flash_attention", "flash_wgmma_kernel"),
               ("ssd_scan", "ssd_wgmma_kernel"),
               *((name, f"{name}_kernel") for name in MIXER_KERNELS)])
    records["flash_attention"]["card_ms"] = card["flash_attention"]
    records["ssd_scan"]["card_ms"] = card["ssd_scan"]
    for name in MIXER_KERNELS:      # joined to phase_mamba_mixer's records
        records[name] = {"card_ms": card[name]}
    if card["ssd_scan"] is not None:
        log(f"kernel/ssd_scan (wgmma) card {card['ssd_scan'] * 1e3:.2f} us a "
            f"launch in the forward against its bound {bnd * 1e3:.3f} us: "
            f"{100 * bnd / card['ssd_scan']:.1f}% of the bound's rate "
            f"(simt {simt * 1e3:.2f} us a launch, events)")
    launches = dit_serve_path("dit", sp, cp, apply_fn, dcfg.n_classes, key,
                              fwd_ms, per_fwd, kmods)
    return records, launches


def phase_grouped_matmul():
    """The grouped matmul against its plain version on the card at the
    JAX package's test shapes, float32 and bfloat16, with contiguous
    tokens and with tokens broadcast to every expert (stride 0)."""
    import torch
    from repro_torch.kernels.grouped_matmul import kernel as gkernel
    from repro_torch.kernels.grouped_matmul import ops as gops
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

    g = torch.Generator(device="cuda").manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        tol = TOL_GMM if dtype == torch.float32 else TOL_BF16
        errs = []
        gkernel.reset_counts()
        for E, C, D, F in GMM_SWEEP + GMM_WGMMA:
            tok = torch.randn(E, C, D, generator=g, device="cuda").to(dtype)
            w = torch.randn(E, D, F, generator=g, device="cuda").to(dtype)
            shared = tok[0].unsqueeze(0).expand(E, -1, -1)
            flat = torch.randn(E * C * D + 8, generator=g,
                               device="cuda").to(dtype)
            shifted = flat[1:1 + E * C * D].view(E, C, D)   # 2 or 4 bytes
            cases = (("contiguous", tok), ("broadcast", shared),
                     ("misaligned", shifted))
            for what, t in cases:
                out = gops.grouped_matmul(t, w)
                ref = grouped_matmul_ref(t, w)
                err = (out.float() - ref.float()).abs().max().item()
                if out.shape != (E, C, F) or not torch.allclose(
                        out.float(), ref.float(), **tol):
                    raise AssertionError(f"grouped_matmul {(E, C, D, F)} "
                                         f"{what} {tag}: max abs {err:.3g} "
                                         f"beyond {tol}")
                errs.append(err)
        variants = {v: gkernel.COUNTS[f"grouped_matmul/{v}"]
                    for v in gkernel.VARIANTS}
        log(f"kernel/grouped_matmul {tag}: {len(GMM_SWEEP)} sweep and "
            f"{len(GMM_WGMMA)} wgmma shapes x contiguous/broadcast/"
            f"misaligned tokens max_abs_err {max(errs):.3g} within {tol}; "
            f"launches per variant {variants}")
        want = {"simt"} if dtype == torch.float32 else {"wgmma", "wmma"}
        if {v for v, n in variants.items() if n} != want:
            raise AssertionError(f"grouped_matmul {tag}: variants "
                                 f"{variants}, expected launches of "
                                 f"{sorted(want)}")


def phase_moe():
    """The MoE path: four DBRX-132B DiTs at full width, cut to MOE_LAYERS
    blocks.  Returns (kernel records at the MoE path's shapes, launches
    of the path's run)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_arch
    from repro_torch.core import prng
    from repro_torch.core.dit import DiTConfig, make_dit_apply
    from repro_torch.device import deterministic_cuda
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.grouped_matmul import kernel as gkernel
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
    from repro_torch.models import moe

    gc.collect()                  # the Zamba2 models and their runtime
    torch.cuda.empty_cache()
    log(f"moe/free: device memory {torch.cuda.memory_allocated() / 1e9:.2f}"
        f" GB allocated, {torch.cuda.memory_reserved() / 1e9:.2f} GB "
        "reserved before the MoE models")
    deterministic_cuda()
    arch = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_LAYERS)
    dcfg = DiTConfig(image_size=IMG[0], channels=IMG[2], patch_size=4,
                     n_classes=8)
    apply_fn = make_dit_apply(arch, dcfg)
    n = arch.n_layers
    per_fwd = {"grouped_matmul": 3 * n, "grouped_matmul/wgmma": 3 * n,
               "grouped_matmul/wmma": 0, "grouped_matmul/simt": 0,
               "flash_attention": n, "flash_attention/wgmma": n,
               "flash_attention/simt": 0,
               **no_bwd("flash_attention", "grouped_matmul")}
    key = prng.PRNGKey(0, device="cuda")
    runtime_launches = moe_runtime_round(dcfg)
    xty = dit_inputs(dcfg.n_classes)
    grad_launches = {}
    sp, cp = init_dits("moe", arch, dcfg, key, between=lambda m:
                       grad_launches.update(moe_dit_grad_check(
                           "moe", apply_fn, m, xty, per_fwd,
                           (fkernel, gkernel))))

    with capture_calls({"flash_attention": (fops, "flash_attention"),
                        "grouped_matmul": (moe.gmm_ops, "grouped_matmul")},
                       limit=3, clone=False) as captured, torch.no_grad():
        eps = apply_fn(sp, *xty)
        torch.cuda.synchronize()
    if eps.shape != xty[0].shape or not torch.isfinite(eps).all():
        raise AssertionError(f"moe: bad forward {tuple(eps.shape)}")

    # flash attention at head dim 128, the kernel's limit
    (q, k, v), kw, out = captured["flash_attention"][0]
    if kw != {"causal": False, "window": 0} or q.shape[-1] != 128:
        raise AssertionError(f"moe: attention called at {tuple(q.shape)} "
                             f"with {kw}")
    ref = attention_ref(q, k, v, **kw)
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(), **TOL_BF16):
        raise AssertionError(f"moe flash_attention: max abs {err:.3g}")
    qc, kc_, vc = q.contiguous(), k.contiguous(), v.contiguous()
    flash_rows_bitwise("moe", fkernel, qc, kc_, vc, out)
    ms = time_ms(lambda: fkernel.launch(qc, kc_, vc, False, 0))
    plain = time_ms(lambda: attention_ref(q, k, v, **kw))
    g = q.shape[1] // k.shape[1]      # SDPA gets K/V repeated per group
    kr, vr = kc_.repeat_interleave(g, 1), vc.repeat_interleave(g, 1)
    lib = time_ms(lambda: F.scaled_dot_product_attention(qc, kr, vr))
    bnd, by = flash_bound(q, k, False, 0)
    flash128 = dict(shape=list(q.shape), kv_heads=k.shape[1],
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                    bound_by=by, library_ms=lib)
    log(f"kernel/flash_attention at the DBRX block's {tuple(q.shape)} Hkv "
        f"{k.shape[1]} {q.dtype} ({fkernel.choose_variant(qc, kc_, vc)}): "
        f"max_abs_err {err:.3g} within {TOL_BF16} kernel {ms * 1e3:.2f} us "
        f"plain {plain * 1e3:.2f} us sdpa {lib * 1e3:.2f} us bound "
        f"{bnd * 1e3:.3f} us ({by})")

    # the first block's three expert products (gate, up, down), one at a
    # time: the plain version upcasts a 2.1 GB weight to 4.2 GB of float32
    names = ("gate", "up", "down")
    shapes, work = [], []
    for name, ((tok, w), _, out) in zip(names, captured["grouped_matmul"]):
        ref = grouped_matmul_ref(tok, w)
        err = (out.float() - ref.float()).abs().max().item()
        ok = torch.allclose(out.float(), ref.float(), **TOL_BF16)
        scale = ref.float().abs().max().item()
        del ref
        if not ok:
            raise AssertionError(f"moe grouped_matmul {name}: max abs "
                                 f"{err:.3g} beyond {TOL_BF16}")
        E, C, D = tok.shape
        Fo = w.shape[-1]
        rows = gkernel.launch(tok[:, :64], w)       # C = 64 of C = 256
        if not torch.equal(rows, out[:, :64]):
            raise AssertionError(f"moe grouped_matmul {name}: rows at C = 64"
                                 " != the first 64 rows at C = 256")
        del rows
        dense_tok = tok.contiguous()
        ms = time_ms(lambda: gkernel.launch(tok, w), iters=20, warmup=3)
        plain = time_ms(lambda: grouped_matmul_ref(tok, w), iters=5,
                        warmup=1)
        lib = time_ms(lambda: torch.bmm(dense_tok, w), iters=20, warmup=3)
        work.append(gmm_cost.cost(E, C, D, Fo, w.element_size(),
                                  tok.stride(0) == 0))
        bnd, by = _bound(*work[-1], _rate(w.dtype))
        del dense_tok
        shapes.append(dict(name=name, shape=[E, C, D, Fo], max_abs_err=err,
                           ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=bnd))
        log(f"kernel/grouped_matmul {name} ({E}, {C}, {D}) @ ({E}, {D}, "
            f"{Fo}) {w.dtype}, token stride {tok.stride()} "
            f"({gkernel.choose_variant(tok, w)}): max_abs_err {err:.3g} (max "
            f"|plain| {scale:.3g}); rows at C = 64 bitwise equal; kernel "
            f"{ms:.4f} ms plain {plain:.4f} ms "
            f"torch.bmm {lib:.4f} ms ({ms / lib:.3f}x) bound {bnd:.4f} ms "
            f"({by}); {2 * E * C * D * Fo / ms / 1e9:.1f} TFLOP/s")
        torch.cuda.empty_cache()
    del captured, out, tok, w
    # per launch over a forward's mix (gate, up and down alike)
    record = {k: sum(r[k] for r in shapes) / len(shapes)
              for k in ("ms", "plain_ms", "library_ms")}
    bnd, by = _bound(sum(b for b, _ in work) / len(work),
                     sum(f for _, f in work) / len(work), BF16_FLOPS_PER_S)
    record.update(max_abs_err=max(r["max_abs_err"] for r in shapes),
                  bound_ms=bnd, bound_by=by, shapes=shapes)
    log(f"kernel/grouped_matmul per launch (mean of gate, up, down): "
        f"kernel {record['ms']:.4f} ms bound {record['bound_ms']:.4f} ms "
        f"torch.bmm "
        f"{record['library_ms']:.4f} ms "
        f"({record['ms'] / record['library_ms']:.3f}x) plain "
        f"{record['plain_ms']:.4f} ms")

    fwd_ms, card = dit_forward_stats(
        "moe", apply_fn, sp, xty, per_fwd, (fkernel, gkernel),
        cards=[("grouped_matmul", "gmm_wgmma_kernel"),
               ("flash_attention", "flash_wgmma_kernel")])
    record["card_ms"] = card["grouped_matmul"]
    flash128["card_ms"] = card["flash_attention"]
    launches = dit_serve_path("moe", sp, cp, apply_fn, dcfg.n_classes, key,
                              fwd_ms, per_fwd, (fkernel, gkernel))
    log(f"moe/peak device memory: {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        " GB")
    # the path's runs: the Alg.-1 gradient, the runtime round, the serve
    # pass and sample (each counted from zero just before)
    launches = {k: launches.get(k, 0) + grad_launches.get(k, 0) +
                runtime_launches.get(k, 0)
                for k in set(launches) | set(grad_launches) |
                set(runtime_launches)}
    return {"grouped_matmul": record, "flash_attention@128": flash128}, \
        launches


# the evaluation phase: the paper's Fig. 4 / 7 / 8 measurements on the
# models the training runtime trained; N_EVAL samples a client
# (benchmarks/privacy_frontier.py's N_EVAL), intermediates at EVAL_TS,
# the inversion attack at EVAL_INV_T; the trainers are held against the
# CPU port over EVAL_SHORT_STEPS steps (a full run there takes minutes)
EVAL_N = 96
EVAL_TS = (0, 250, 500)
EVAL_INV_T = 250
EVAL_SHORT_STEPS = 20
# card vs CPU port: features elementwise at TOL; the FD (the same
# statistics and eigenvalues of a full-rank 64x64 product, N = 96 > 64)
# at EVAL_FD_RTOL of itself; the trainers after EVAL_SHORT_STEPS: the
# classifier at TOL, the inverter's weights at EVAL_INV_ATOL.  Measured
# on an H100 80GB HBM3 at 700 W: 1.8e-5 at these 32x32 inputs, where no
# gradient element reaches AdamW's eps scale; at 8x8 on the CPU such
# elements take updates of up to lr = 3e-3 that summation order decides
# (tests/test_torch_eval.py, 1.2e-3), which this limit would catch.
EVAL_FD_RTOL = 1e-4
EVAL_INV_ATOL = 1e-4
# the LM serving path: Zamba2-1.2B at the published widths, bf16, threefry
# seed 0; prompts of LM_PROMPTS tokens (two SSD chunks of 256; a ragged
# tail), LM_NEW new tokens, batch LM_BATCH; the CPU port runs LM_CPU_LAYERS
# (one shared group of 6 and one tail layer) at batch 1
LM_ARCH = "zamba2-1.2b"
LM_BATCH, LM_PROMPTS, LM_NEW, LM_GREEDY_STEPS = 4, (512, 333), 32, 4
LM_CPU_LAYERS = 7
# bf16 logits: max |a - b| / max(1, max |b|).  Decode (the recurrent
# step, plain torch) against the full forward (the chunked scan kernel,
# flash) differ by bf16 roundings through 38 layers; the card against the
# CPU port by cuBLAS / the kernels against CPU GEMMs and plain versions.
# Measured on an H100 80GB HBM3 at 700 W: at most 0.042 (the fourth
# greedy step; one decode step 0.024, card vs CPU 0.020; logits reach
# ~6, where a bf16 ulp is 0.031).  A decode step from a zero state (the
# prompt forgotten) must fall outside the limit.
LM_BF16_RTOL = 0.1
# the LM training path: Zamba2-1.2B at the published widths and depth,
# bf16, LM_TRAIN_STEPS AdamW steps on lm_batch data of LM_TRAIN_BATCH x
# LM_TRAIN_SEQ tokens (train_4k's 4,096 cut to 1,024); the backward
# kernels at its shapes (FLASH_BWD_PATH, SSD_BWD_PATH) and in a sweep:
# float32, the DBRX block's GQA (48 / 8 heads of 128) at S 64,
# non-causal, a window below S, ragged S, the DiT's chunk 64, a state of
# 128, a chunk below the 8-step tile, and d(final state) given or not
LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ = 20, 4, 1024
FLASH_BWD_PATH = ((4, 32, 32, 1024, 64), True, 8192)
FLASH_BWD_SWEEP = [((2, 4, 2, 100, 32), True, 0, "float32"),
                   ((1, 2, 1, 150, 16), True, 40, "float32"),
                   ((4, 48, 8, 64, 128), False, 0, "bfloat16"),
                   ((2, 4, 4, 333, 64), True, 0, "bfloat16"),
                   ((1, 4, 2, 200, 64), False, 70, "bfloat16"),
                   ((4, 32, 32, 64, 64), False, 0, "bfloat16")]
SSD_BWD_PATH = (4, 1024, 64, 64, 64, 256)
SSD_BWD_SWEEP = [((2, 100, 3, 16, 8, 32), "float32", True),
                 ((1, 48, 2, 8, 4, 16), "float32", False),
                 ((1, 37, 2, 16, 16, 4), "float32", True),
                 ((4, 64, 64, 64, 64, 64), "bfloat16", False),
                 ((2, 333, 4, 64, 64, 256), "bfloat16", True),
                 ((1, 130, 3, 64, 128, 32), "bfloat16", False)]
# backward kernel vs its plain version (flash_attention_bwd_ref,
# ssd_chunked_bwd_ref: the same algorithm in float32 on the same inputs),
# per gradient, ``row_gap``: the largest over rows (the last axis; a
# vector's elements) of ‖kernel − plain‖ / ‖plain‖, a row's norm floored
# at ROW_FLOOR of the median row's: a row that is zero in exact
# arithmetic, as causal dq's first (O_0 = v_0, so dP − D cancels), reads
# its float32 rounding against that (the plain version itself reads
# 8.6e-5 against float64 there at a floor of 1%, 8.6e-6 at 10%).  A
# causal gradient falls off with position (dv of the first key ~10, of a
# mid-sequence key ~0.05), so each row is held to its own scale.  In bf16
# the simt variants round each value once to bf16 from float32 sums that
# differ in order only, so a value is at most one ulp (2^-7 of it) from
# the plain one and a row at most 7.8e-3 of its norm: BWD_BF16_ROW.  The
# wgmma variants (the choice in bf16 at the model's head dims) take the
# stored bf16 inputs to the tensor cores as they are and every float32
# intermediate (P, dS; W∘CB, W∘DD, the states, the scaled x and dy of the
# chunk sums) as a bf16 hi part plus a bf16 lo part, 16 of its 24 bits:
# each product term is then within 2^-17 of the plain one, far below that
# ulp, and the row stays under the limit (the CPU rounding model,
# tests/test_torch_bwd_variants.py: ≤ 2.7e-3 at the sweep's shapes; one
# bf16 part would read up to 9.0e-3, dB at the DiT's shape, and move dA
# a hundredfold).  In float32 only the order differs.  At the step's
# shapes the kernel's gradients
# with a planted fault (rows past the first K/V tile or chunk scaled by
# 1 + FAULT, a gradient taken from the next head) must read beyond the
# limit.  The forward's lse against the plain log-sum-exp: LSE_ATOL.
# (e): a 7-layer model (one shared group and a tail layer), batch 1, a
# ragged S, on the card against the CPU port (both bf16): the loss within
# LM_LOSS_RTOL of the CPU's; each gradient leaf within LM_GRAD_RTOL
# (‖g_card − g_cpu‖ / ‖g_cpu‖: bf16 roundings in other places through 7
# layers, cuBLAS against CPU GEMMs, the kernels against plain versions),
# while the CPU gradients of another batch must put the median leaf
# beyond it
LM_GRAD_SEQ = 333
LM_LOSS_RTOL = 1e-2
LM_GRAD_RTOL = 0.1
BWD_BF16_ROW = 1e-2
BWD_FP32_ROW = 1e-4
ROW_FLOOR = 0.1
FAULT = 0.02
LSE_ATOL = 1e-3
# the encoder-decoder: whisper-base at its published widths and depth,
# bf16, threefry seed 0.  Serving: batch WHISPER_BATCH, WHISPER_FRAMES
# frames (its 30-second encoder context), the decoder prompt's 8 tokens,
# WHISPER_NEW new; prefill + WHISPER_DECODE teacher-forced decode steps
# against decode_train at each of WHISPER_PROMPTS decoder prompts (the
# self cache of max_decoder_len 448 zero-padded, full, and cut to the
# last 448 positions).  Training: WHISPER_TRAIN_BATCH x 1,500 frames
# (train_4k's 4,096 cut to whisper's 1,500) and 448 tokens, the flash
# backward at its encoder (non-causal) and decoder (causal) shapes;
# 2 + 2 layers against the CPU port at WHISPER_GRAD_SEQ
WHISPER_ARCH = "whisper-base"
WHISPER_BATCH, WHISPER_FRAMES, WHISPER_NEW = 4, 1500, 32
WHISPER_PROMPTS, WHISPER_DECODE = (8, 448, 460), 4
WHISPER_TRAIN_STEPS, WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ = 20, 8, 1500
WHISPER_FLASH_BWD = (((8, 8, 8, 1500, 64), False),
                     ((8, 8, 8, 448, 64), True))
WHISPER_CPU_LAYERS, WHISPER_GRAD_SEQ = 2, 333
PATHS = ("serve", "train", "train_runtime", "eval", "dit", "moe",
         "moe_train", "lm_serve", "lm_train", "whisper_serve",
         "whisper_train", "examples", "clients_mesh", "dense_partition",
         "decode_partition", "moe_partition")


def eval_scores(trained, data, key, n: int = EVAL_N) -> dict:
    """The evaluation path on the data's device: one shared-handoff pass
    of ``n`` samples for clients 0 and 1 on client 1's labels, the FD
    proxy of each client's real data against its samples and the handoff,
    q_sample intermediates at EVAL_TS (``fold_in(fold_in(key, t), c)``
    noise; t = 0 is the data), attribute-inference F1 on client 1's at
    each t and the inversion attack at EVAL_INV_T (client 0 attacks
    client 1)."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.sampler import shared_handoff_sample
    from repro_torch.eval import attr_inference, fd_proxy, inversion
    (x0, _), (x1, y1) = data
    x0, x1, y1 = x0[:n], x1[:n], y1[:n]
    sched, cut = trained["sched"], trained["cut"]
    t0 = time.perf_counter()
    samples, handoff = shared_handoff_sample(
        trained["server"], trained["clients"], prng.fold_in(key, 0), y1,
        tuple(x1.shape), sched, cut, trained["apply_fn"])
    for name, t in (("samples", samples), ("handoff", handoff)):
        want = ((2,) if name == "samples" else ()) + tuple(x1.shape)
        if tuple(t.shape) != want or not torch.isfinite(t).all():
            raise AssertionError(f"eval: {name} {tuple(t.shape)} not finite")
    sample_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fds = {}
    for c, x in enumerate((x0, x1)):
        fds[f"client{c}/samples"] = fd_proxy.fd_proxy(x, samples[c])
        fds[f"client{c}/handoff"] = fd_proxy.fd_proxy(x, handoff)
    inter = {}
    for c, x in enumerate((x0, x1)):
        for t in EVAL_TS:
            eps = prng.normal(prng.fold_in(prng.fold_in(key, t), c),
                              tuple(x.shape))
            inter[c, t] = x if t == 0 else sched.q_sample(
                x, torch.full((n,), float(t), device=x.device), eps)
    f1 = {t: attr_inference.attribute_inference_f1(
        prng.fold_in(key, 77 + t), inter[1, t], y1) for t in EVAL_TS}
    inv = inversion.inversion_attack(prng.fold_in(key, 8),
                                     inter[0, EVAL_INV_T], x0,
                                     inter[1, EVAL_INV_T], x1)
    for k, v in list(fds.items()) + list(inv.items()):
        if not math.isfinite(v):
            raise AssertionError(f"eval: {k} = {v}")
    return dict(samples=samples, handoff=handoff, fd=fds, inter=inter,
                f1=f1, inversion=inv, sample_s=sample_s,
                score_s=time.perf_counter() - t0)


def phase_eval(trained):
    """The paper's evaluation (eval/) on the card, scoring the models
    that the training runtime trained (phase 8): one shared-handoff pass
    of EVAL_N samples for clients 0 and 1 conditioned on the victim's
    (client 1's) labels — 750 server + 2 x 250 client keyed DDPM-step
    launches — then the FD proxy of each client's real data against its
    samples and against the handoff, attribute-inference F1 at each of
    EVAL_TS on client 1's intermediates, and the inversion attack at
    EVAL_INV_T (client 0 attacks client 1).  ``features`` and
    ``frechet_distance`` are held against the CPU port in full, the two
    trainers over EVAL_SHORT_STEPS steps.  Returns the DDPM-step
    launches of the path."""
    import torch
    from repro_torch.configs.ddpm_unet import CONFIG
    from repro_torch.core import prng
    from repro_torch.data.synthetic import (SyntheticConfig,
                                            make_client_datasets)
    from repro_torch.device import deterministic_cuda
    from repro_torch.eval import attr_inference, fd_proxy, inversion
    from repro_torch.kernels.ddpm_step import kernel as dkernel
    from repro_torch.kernels.ddpm_step import ops as dops
    from repro_torch.kernels.ddpm_step.ref import ddpm_step_keyed_ref

    t_phase = time.perf_counter()
    deterministic_cuda()
    card = card_line()
    sched, cut = trained["sched"], trained["cut"]
    scfg = SyntheticConfig(image_size=IMG[0], channels=IMG[2],
                           n_attrs=CONFIG.n_classes)
    (x0, y0), (x1, y1) = make_client_datasets(
        prng.PRNGKey(1), scfg, TRAIN_CLIENTS, EVAL_N, non_iid=True,
        device="cuda")[:2]
    key = prng.PRNGKey(19, device="cuda")
    torch.cuda.synchronize()
    dkernel.reset_counts()                       # --- eval path starts
    out = eval_scores(trained, ((x0, y0), (x1, y1)), key)
    torch.cuda.synchronize()
    launches = dict(dkernel.COUNTS)              # --- eval path ends
    check_ddpm_launches("eval", launches,
                        sched.T - cut.t_cut + 2 * cut.t_cut, 0)
    samples, handoff, inter = out["samples"], out["handoff"], out["inter"]
    fds, f1, inv = out["fd"], out["f1"], out["inversion"]
    log(f"eval/sample: shared handoff, {EVAL_N} samples for clients 0 and "
        f"1 on client 1's labels, T={sched.T} cut {cut.t_cut}, wall_s "
        f"{out['sample_s']:.3f}; launches {launches}")
    log("eval/fd_proxy: " + ", ".join(f"{k} {v:.6g}" for k, v in
                                      fds.items()))
    for t in EVAL_TS:
        log(f"eval/attr_inference_f1 t={t}: mean {float(f1[t].mean()):.4f} "
            f"per attribute {[round(float(v), 4) for v in f1[t]]}")
    log(f"eval/inversion t={EVAL_INV_T}: " + ", ".join(
        f"{k} {v:.6g}" for k, v in inv.items()))
    log(f"eval/scoring_s: {out['score_s']:.2f}")

    # the keyed kernel on the path's own tensor (the handoff, the input of
    # the clients' first step) against its plain version: bitwise
    row = dops.step_coefficient_table(
        sched, torch.tensor([float(cut.t_cut)], device="cuda"))[0]
    kk = prng.fold_in(key, 3)
    buf = torch.empty_like(kk)
    got = dops.ddpm_step_keyed(handoff, samples[1], kk, row, buf)
    ref, k_ref = ddpm_step_keyed_ref(handoff, samples[1], kk, row)
    if not (torch.equal(got, ref) and torch.equal(buf, k_ref)):
        raise AssertionError(f"eval: keyed step on the handoff "
                             f"{tuple(handoff.shape)} != its plain version")
    log(f"eval/keyed_step: the handoff {tuple(handoff.shape)} "
        f"{handoff.dtype}: bitwise with its plain version, output key too")

    # card against the CPU port on the same inputs
    fails = []
    for name, x in (("real0", x0), ("samples0", samples[0]),
                    ("handoff", handoff)):
        a = fd_proxy.features(x)
        b = fd_proxy.features(x.cpu())
        err = (a.cpu() - b).abs().max().item()
        ok = torch.allclose(a.cpu(), b, **TRAIN_TOL)
        log(f"eval/card_vs_cpu features({name}): max abs {err:.3g} "
            f"(max |cpu| {b.abs().max().item():.3g})")
        fails += [] if ok else [f"features({name}) {err:.3g}"]
    for c, x in enumerate((x0, x1)):
        fa, fb = fd_proxy.features(x), fd_proxy.features(samples[c])
        card_fd = fd_proxy.frechet_distance(fa, fb)
        cpu_fd = fd_proxy.frechet_distance(fa.cpu(), fb.cpu())
        rel = abs(card_fd - cpu_fd) / max(abs(cpu_fd), 1e-12)
        log(f"eval/card_vs_cpu frechet_distance client {c}: card "
            f"{card_fd:.6g} cpu {cpu_fd:.6g} (same features), rel {rel:.3g}")
        fails += [] if rel <= EVAL_FD_RTOL else [f"frechet {c} {rel:.3g}"]
        full = fd_proxy.fd_proxy(x.cpu(), samples[c].cpu())
        rel = abs(fds[f"client{c}/samples"] - full) / max(abs(full), 1e-12)
        log(f"eval/card_vs_cpu fd_proxy client {c} samples: cpu {full:.6g}, "
            f"rel {rel:.3g}")
        fails += [] if rel <= EVAL_FD_RTOL else [f"fd_proxy {c} {rel:.3g}"]
    xc, x0c = inter[0, EVAL_INV_T], x0
    k_inv = prng.fold_in(key, 8)
    t0 = time.perf_counter()
    inv_card = inversion.train_inverter(k_inv, xc, x0c,
                                        steps=EVAL_SHORT_STEPS)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    inv_cpu = inversion.train_inverter(k_inv, xc.cpu(), x0c.cpu(),
                                       steps=EVAL_SHORT_STEPS)
    cpu_s = time.perf_counter() - t0
    err = max((a.detach().cpu() - b.detach()).abs().max().item() for a, b in
              zip(inv_card.parameters(), inv_cpu.parameters()))
    log(f"eval/card_vs_cpu train_inverter ({EVAL_SHORT_STEPS} steps, card "
        f"{card_s:.2f} s, cpu {cpu_s:.2f} s): weights max abs {err:.3g} "
        f"(limit {EVAL_INV_ATOL})")
    fails += [] if err <= EVAL_INV_ATOL else [f"inverter {err:.3g}"]
    k_clf = prng.fold_in(key, 77 + EVAL_INV_T)
    xt, yt = inter[1, EVAL_INV_T], y1
    clf_card = attr_inference.train_attr_classifier(
        k_clf, xt, yt, steps=EVAL_SHORT_STEPS)
    clf_cpu = attr_inference.train_attr_classifier(
        k_clf, xt.cpu(), yt.cpu(), steps=EVAL_SHORT_STEPS)
    bad, err = 0, 0.0
    for a, b in zip(clf_card.parameters(), clf_cpu.parameters()):
        a = a.detach().cpu()
        err = max(err, (a - b.detach()).abs().max().item())
        bad += int((~torch.isclose(a, b.detach(), **TRAIN_TOL)).sum())
    log(f"eval/card_vs_cpu train_attr_classifier ({EVAL_SHORT_STEPS} steps):"
        f" weights max abs {err:.3g}, {bad} beyond {TRAIN_TOL}")
    fails += [] if bad == 0 else [f"classifier {bad} beyond TOL"]
    if fails:
        raise AssertionError(f"eval: card vs CPU beyond tolerance: {fails}")
    log(f"eval/phase_s: {time.perf_counter() - t_phase:.1f}; card {card}")
    return launches


def lm_gap(a, b) -> float:
    """max |a − b| over max(1, max |b|), in float32."""
    a, b = a.float(), b.float().to(a.device)
    return (a - b).abs().max().item() / max(1.0, b.abs().max().item())


def lm_counts(*kmods) -> dict:
    out = {}
    for kmod in kmods:
        out.update(kmod.COUNTS)
    return out


def check_lm_launches(tag: str, got: dict, per_prefill: dict,
                      prefills: int) -> None:
    want = {k: n * prefills for k, n in per_prefill.items()}
    if got != want:
        raise AssertionError(f"{tag}: kernel launches {got}, expected {want}")


def phase_lm_serve():
    """The LM serving path at full width: Zamba2-1.2B (38 Mamba2 layers,
    d_model 2048, 64 SSD heads of 64, state 64, the shared attention+MLP
    block every 6 layers, vocab 32,000, bf16, threefry seed 0).
    (a) the CLI (``launch/serve.py``) twice, greedy, batch 4, 512 prompt
    tokens, 32 new: the tokens bitwise equal, 6 flash and 38 SSD launches
    (all wgmma) and 38 of each mixer glue kernel for its one prefill and
    none in its 31 decode steps;
    (b) prefill + one decode step against the full forward at position S,
    for S in LM_PROMPTS, the logits within LM_BF16_RTOL; (c) four greedy
    decode steps against repeated full forwards at S = 512; (d) flash and
    the SSD scan (y and the final state) against their plain versions on
    the prefill's own inputs at both lengths, rows bitwise across the
    batch, timed beside SDPA and the bound; (e) a 7-layer model of the
    same widths on the card against the CPU port with the same weights;
    (g) prefill wall and device ms, decode ms a token, tok/s and idle
    shares.  Then the DiT's kernel shapes again, after the LM's (the
    tensor-map cache keys on pointer and geometry).  Returns (kernel
    records at the prefill shapes, launches of the CLI's first run)."""
    import copy
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_arch
    from repro_torch.core import prng
    from repro_torch.device import deterministic_cuda
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.mamba_mixer import kernel as mkernel
    from repro_torch.kernels.ssd_scan import kernel as skernel
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.models.hybrid import _grouping, hybrid_forward
    from repro_torch.models.transformer import logits_of

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    deterministic_cuda()
    card = card_line()
    cfg = get_arch(LM_ARCH)
    n_attn = _grouping(cfg)[1]
    per_prefill = {"flash_attention": n_attn, "flash_attention/wgmma": n_attn,
                   "flash_attention/simt": 0, "ssd_scan": cfg.n_layers,
                   "ssd_scan/wgmma": cfg.n_layers, "ssd_scan/simt": 0,
                   **no_bwd("flash_attention", "ssd_scan"),
                   **dict.fromkeys(MIXER_KERNELS, cfg.n_layers)}
    kmods = (fkernel, skernel, mkernel)

    # (a) the CLI, twice
    argv = ["--arch", LM_ARCH, "--batch", str(LM_BATCH), "--prompt-len",
            str(LM_PROMPTS[0]), "--new-tokens", str(LM_NEW), "--device",
            "cuda"]
    runs = []
    for i in range(2):
        torch.cuda.synchronize()
        for kmod in kmods:                       # --- main path starts
            kmod.reset_counts()
        t0 = time.perf_counter()
        gen, rep = serve.run(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = lm_counts(*kmods)                  # --- main path ends
        check_lm_launches(f"lm_serve CLI run {i + 1}", got, per_prefill, 1)
        runs.append((gen, rep, got, wall))
        log(f"lm_serve/cli run {i + 1}: {wall:.2f} s (init included); "
            f"prefill {rep['prefill_ms']:.3f} ms, decode "
            f"{rep['decode_ms_per_token']:.3f} ms a step, "
            f"{rep['tok_per_s']:.1f} tok/s (synchronised host clock); "
            f"launches {got}")
    (gen, rep, launches, _), (gen2, _, _, _) = runs
    if tuple(gen.shape) != (LM_BATCH, LM_NEW) or not torch.equal(gen, gen2):
        raise AssertionError("lm_serve: the CLI's two runs differ")
    log(f"lm_serve/cli: the two runs' {tuple(gen.shape)} tokens are bitwise "
        f"equal; row 0 {gen[0, :8].tolist()}")

    params = api.init_params(prng.PRNGKey(0), cfg, "cuda")
    n_params = sum(p.numel() for p in params.parameters())
    log(f"lm_serve/model: {cfg.name} {n_params} parameters ({cfg.dtype}), "
        f"{cfg.n_layers} Mamba2 layers, {n_attn} shared-block applications")
    key = prng.PRNGKey(7, device="cuda")
    records, gaps = {}, {}

    def full_logits(tok):
        hid, _, _ = hybrid_forward(params, tok, cfg)
        return logits_of(params, hid)

    for S in LM_PROMPTS:
        tok = prng.randint(prng.fold_in(key, S), (LM_BATCH, S + 1), 0,
                           cfg.vocab_size).long()
        # (b) prefill + one decode step against the full forward at S
        for kmod in kmods:
            kmod.reset_counts()
        with capture_calls({"flash_attention": (fops, "flash_attention"),
                            "ssd_scan": (sops, "ssd_scan")}) as captured:
            lg, state = api.prefill_fn(params, {"tokens": tok[:, :S]}, cfg,
                                       cache_len=S + LM_NEW)
            torch.cuda.synchronize()
        check_lm_launches(f"lm_serve prefill S={S}", lm_counts(*kmods),
                          per_prefill, 1)
        for kmod in kmods:
            kmod.reset_counts()
        dec, _ = api.decode_fn(params, tok[:, S:S + 1], state, S, cfg)
        torch.cuda.synchronize()
        check_lm_launches(f"lm_serve decode S={S}", lm_counts(*kmods),
                          per_prefill, 0)
        full = full_logits(tok)
        if not (torch.isfinite(lg).all() and torch.isfinite(dec).all()):
            raise AssertionError(f"lm_serve S={S}: logits not finite")
        gaps[f"prefill S={S}"] = lm_gap(lg, full[:, S - 1:S])
        gaps[f"decode S={S}"] = lm_gap(dec, full[:, S:S + 1])
        zero = api.init_decode_state(cfg, LM_BATCH, S + LM_NEW,
                                     device="cuda")
        forgot = lm_gap(api.decode_fn(params, tok[:, S:S + 1], zero, S,
                                      cfg)[0], full[:, S:S + 1])
        log(f"lm_serve/control S={S}: a decode step from a zero state vs "
            f"the full forward {forgot:.4g} (must exceed {LM_BF16_RTOL})")
        if not forgot > LM_BF16_RTOL:
            raise AssertionError("lm_serve: the logit check passed a decode "
                                 "step that forgot the prompt")
        log(f"lm_serve/S={S}: prefill logits vs full forward "
            f"{gaps[f'prefill S={S}']:.4g}, decode at S vs full forward "
            f"{gaps[f'decode S={S}']:.4g} (max |a-b| / max(1, max |b|); "
            f"max |logit| {full.float().abs().max().item():.3g})")
        # (d) the kernels on the prefill's own inputs
        (q, k, v), kw, out = captured["flash_attention"][0]
        if kw != {"causal": True, "window": cfg.sliding_window}:
            raise AssertionError(f"lm_serve: attention called with {kw}")
        ref = attention_ref(q, k, v, **kw)
        ferr = (out.float() - ref.float()).abs().max().item()
        if not torch.allclose(out.float(), ref.float(), **TOL_BF16):
            raise AssertionError(f"lm_serve flash S={S}: max abs {ferr:.3g}")
        qc, kc_, vc = q.contiguous(), k.contiguous(), v.contiguous()
        one = fkernel.launch(qc[:1], kc_[:1], vc[:1], True,
                             cfg.sliding_window)
        if not torch.equal(one, out[:1]):
            raise AssertionError(f"lm_serve flash S={S}: rows of batch 1 "
                                 f"!= those of batch {q.shape[0]}")
        (xs, dt, A, Bm, Cm, chunk), _, (yk, fk) = captured["ssd_scan"][0]
        yr, fr = ssd_chunked(xs, dt, A, Bm, Cm, chunk)
        serr = [ssd_range_check(yk, yr, f"lm_serve ssd y S={S}"),
                ssd_range_check(fk, fr, f"lm_serve ssd state S={S}")]
        tail = S - S % 64 if S % 64 else S - 64
        serr.append(ssd_range_check(yk[:, tail:], yr[:, tail:],
                                    f"lm_serve ssd y tail S={S}"))
        cargs = (xs.contiguous(), dt.float().contiguous(),
                 A.float().contiguous(), Bm.to(xs.dtype).contiguous(),
                 Cm.to(xs.dtype).contiguous())
        ssd_rows_bitwise(f"lm_serve S={S}", skernel, cargs, chunk, yk, fk)
        log(f"lm_serve/kernels S={S}: flash {tuple(q.shape)} causal window "
            f"{cfg.sliding_window} max abs {ferr:.3g} (TOL_BF16), rows "
            f"bitwise; ssd {tuple(xs.shape)} chunk {chunk} y / state / tail "
            f"rows {serr[0]:.3g} / {serr[1]:.3g} / {serr[2]:.3g} of max(1, "
            f"max |plain|) (limit {SSD_BF16_RANGE}), rows bitwise")
        if S == LM_PROMPTS[0]:
            ms = time_ms(lambda: fkernel.launch(qc, kc_, vc, True,
                                                cfg.sliding_window))
            plain = time_ms(lambda: attention_ref(q, k, v, **kw), iters=20)
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qc, kc_, vc, is_causal=True))
            bnd, by = flash_bound(q, k, True, cfg.sliding_window)
            records["flash_attention"] = dict(
                shape=list(q.shape), max_abs_err=ferr, ms=ms, plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=lib)
            ms = time_ms(lambda: skernel.launch(*cargs, chunk))
            plain = time_ms(lambda: ssd_chunked(xs, dt, A, Bm, Cm, chunk),
                            iters=20)
            bnd, by = ssd_bound(xs, Bm, chunk)
            records["ssd_scan"] = dict(
                shape=list(xs.shape), chunk=chunk, max_abs_err=max(serr),
                ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=None)
            for name, r in records.items():
                log(f"kernel/{name} at the LM prefill's {r['shape']}: kernel "
                    f"{r['ms'] * 1e3:.2f} us plain {r['plain_ms'] * 1e3:.2f} "
                    f"us library {fmt_ms(r['library_ms'])} bound "
                    f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})")
            # (c) four greedy decode steps against repeated full forwards
            seq, lg_s, st = tok[:, :S], lg, state
            for i in range(LM_GREEDY_STEPS):
                nxt = torch.argmax(lg_s[:, -1:, :], dim=-1)
                seq = torch.cat([seq, nxt], dim=1)
                lg_s, st = api.decode_fn(params, nxt, st, S + i, cfg)
                gaps[f"greedy step {i + 1}"] = lm_gap(
                    lg_s, full_logits(seq)[:, -1:])
            log("lm_serve/greedy decode vs full forwards: " + ", ".join(
                f"{gaps[f'greedy step {i + 1}']:.4g}"
                for i in range(LM_GREEDY_STEPS)))
        del captured, state, full

    # (g) prefill and decode on the card: wall (events) and device time
    S = LM_PROMPTS[0]
    tok = prng.randint(prng.fold_in(key, S), (LM_BATCH, S + 1), 0,
                       cfg.vocab_size).long()
    prefill = lambda: api.prefill_fn(params, {"tokens": tok[:, :S]}, cfg,
                                     cache_len=S + LM_NEW)
    pre_ms = time_ms(prefill, iters=5, warmup=1)
    _, state = prefill()
    step = lambda: api.decode_fn(params, tok[:, S:S + 1], state, S, cfg)
    dec_ms = time_ms(step, iters=20, warmup=2)
    pre = device_ms("lm_serve/prefill", prefill, n=2, top=8,
                    shares=["flash_wgmma_kernel", "ssd_wgmma_kernel"],
                    per="prefill")
    dec = device_ms("lm_serve/decode", step, n=5, top=6, per="decode step")
    for name, kname, n in (("flash_attention", "flash_wgmma_kernel", n_attn),
                           ("ssd_scan", "ssd_wgmma_kernel", cfg.n_layers)):
        records[name]["card_ms"] = None if pre[kname] is None else \
            pre[kname] / n
    idle = lambda dev, wall: "not measured" if dev is None else \
        f"{100 * (1 - dev / wall):.1f}%"
    log(f"lm_serve/prefill: B={LM_BATCH} S={S} wall {pre_ms:.3f} ms "
        f"(events), device {fmt_ms(pre['_ms'])}, idle "
        f"{idle(pre['_ms'], pre_ms)}; card ms a launch: flash "
        f"{fmt_ms(records['flash_attention']['card_ms'])}, ssd "
        f"{fmt_ms(records['ssd_scan']['card_ms'])}")
    log(f"lm_serve/decode: B={LM_BATCH} a step {dec_ms:.3f} ms (events), "
        f"{LM_BATCH * 1e3 / dec_ms:.1f} tok/s, device {fmt_ms(dec['_ms'])} "
        f"over {dec['_events']} events, idle {idle(dec['_ms'], dec_ms)}; "
        f"card {card}")
    del state, params
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the same path on the CPU port: LM_CPU_LAYERS layers, the same
    # weights, batch 1, the longer prompt
    small = dataclasses.replace(cfg, n_layers=LM_CPU_LAYERS)
    m_card = api.init_params(prng.PRNGKey(0), small, "cuda")
    m_cpu = copy.deepcopy(m_card).to("cpu")
    tok1 = tok[:1]
    t0 = time.perf_counter()
    outs = {}
    for dev, m in (("cuda", m_card), ("cpu", m_cpu)):
        t = tok1.to(dev)
        lg, st = api.prefill_fn(m, {"tokens": t[:, :S]}, small,
                                cache_len=S + LM_NEW)
        dec, _ = api.decode_fn(m, t[:, S:S + 1], st, S, small)
        outs[dev] = (lg, dec, st["head"][0][-1]["ssm"])
    cpu_s = time.perf_counter() - t0
    for i, what in enumerate(("prefill logits", "decode logits",
                              "group 1's last SSM state")):
        gaps[f"card vs cpu {what}"] = lm_gap(outs["cuda"][i],
                                             outs["cpu"][i])
    log(f"lm_serve/card_vs_cpu ({LM_CPU_LAYERS} layers, B=1, S={S}, "
        f"{cpu_s:.1f} s): " + ", ".join(
            f"{w} {gaps[f'card vs cpu {w}']:.4g}" for w in
            ("prefill logits", "decode logits", "group 1's last SSM state")))
    del m_card, m_cpu, outs

    worst = max(gaps.values())
    log(f"lm_serve/bf16 gaps: worst {worst:.4g} (limit {LM_BF16_RTOL}): "
        f"{gaps}")
    if not worst <= LM_BF16_RTOL:
        raise AssertionError(f"lm_serve: a bf16 gap beyond {LM_BF16_RTOL}: "
                             f"{gaps}")

    # the DiT's shapes again, after the LM's tensor maps
    g = torch.Generator(device="cuda").manual_seed(3)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    q, k, v = (rn(B, 32, 64, 64).bfloat16() for _ in range(3))
    err = (fkernel.launch(q, k, v, False, 0).float() -
           attention_ref(q, k, v, False, 0).float()).abs().max().item()
    x = rn(B, 64, 64, 64).bfloat16()
    dt, A = F.softplus(rn(B, 64, 64) - 1), -torch.exp(rn(64))
    Bm, Cm = rn(B, 64, 64).bfloat16(), rn(B, 64, 64).bfloat16()
    y, fs = skernel.launch(x, dt, A, Bm, Cm, 64)
    yr, fr = ssd_chunked(x, dt, A, Bm, Cm, 64)
    if not torch.allclose(fkernel.launch(q, k, v, False, 0).float(),
                          attention_ref(q, k, v, False, 0).float(),
                          **TOL_BF16):
        raise AssertionError(f"lm_serve: flash at the DiT's shape after the "
                             f"LM's: max abs {err:.3g}")
    ssd_range_check(y, yr, "lm_serve: ssd y at the DiT's shape")
    ssd_range_check(fs, fr, "lm_serve: ssd state at the DiT's shape")
    log(f"lm_serve/dit_shapes_after: flash max abs {err:.3g}, ssd within "
        f"{SSD_BF16_RANGE}")
    log(f"lm_serve/phase_s: {time.perf_counter() - t_phase:.1f}; card {card}")
    return records, launches


def row_gap(a, b) -> float:
    """The largest over rows (the last axis; a vector's elements) of
    ‖a − b‖ / ‖b‖, each row's norm floored at ROW_FLOOR of the median
    row's; float32, on a's device."""
    a, b = a.float(), b.float().to(a.device)
    if b.ndim == 1:
        a, b = a[:, None], b[:, None]
    a, b = a.reshape(-1, b.shape[-1]), b.reshape(-1, b.shape[-1])
    nb = b.norm(dim=1)
    den = nb.clamp(min=ROW_FLOOR * nb.median().item()).clamp(min=1e-30)
    return ((a - b).norm(dim=1) / den).max().item()


def fault_gaps(grads, refs, faults) -> dict:
    """{what: row_gap of a gradient with a planted fault}, for faults
    ``{what: (index, fn)}``: gradient ``index`` of the kernel, in float32,
    through ``fn``.  Each must read beyond its limit, else the comparison
    could not have failed; raises then."""
    out = {}
    for what, (i, fn) in faults.items():
        out[what] = row_gap(fn(grads[i].float()), refs[i])
    return out


def check_faults(what: str, gaps: dict, tol: float) -> None:
    held = [f for f, g in gaps.items() if not g > tol]
    if held:
        raise AssertionError(f"{what}: planted faults {held} read within "
                             f"{tol}: the check cannot fail ({gaps})")


def scaled_past(axis: int, start: int):
    """fn: a copy with the rows from ``start`` on along ``axis`` scaled by
    1 + FAULT."""
    def fn(g):
        g = g.clone()
        g.narrow(axis, start, g.shape[axis] - start).mul_(1 + FAULT)
        return g
    return fn


def flash_faults() -> dict:
    """Planted faults of the flash backward's (dq, dk, dv), for
    ``fault_gaps``: dk and dv past the first 64-key tile scaled, dq from
    the next head."""
    return {"dk past the first K/V tile": (1, scaled_past(2, 64)),
            "dv past the first K/V tile": (2, scaled_past(2, 64)),
            "dq from the next head": (0, lambda g: g.roll(1, dims=1))}


def ssd_faults(chunk: int) -> dict:
    """Planted faults of the SSD backward's (dx, ddt, dA, dB, dC), for
    ``fault_gaps``: dx, dB and dC past the first chunk and dA past the
    first head scaled, ddt from the next head."""
    return {"dx past the first chunk": (0, scaled_past(1, chunk)),
            "ddt from the next head": (1, lambda g: g.roll(1, dims=2)),
            "dA past the first head": (2, scaled_past(0, 1)),
            "dB past the first chunk": (3, scaled_past(1, chunk)),
            "dC past the first chunk": (4, scaled_past(1, chunk))}


def launched_variant(kmod, name: str, before: dict) -> str:
    """The one variant of ``name`` whose counter moved since ``before``
    (a copy of ``kmod.COUNTS``), by exactly one launch; raises
    otherwise."""
    moved = {v: kmod.COUNTS[f"{name}/{v}"] - before[f"{name}/{v}"]
             for v in kmod.BWD_VARIANTS}
    ran = [v for v, n in moved.items() if n]
    if len(ran) != 1 or moved[ran[0]] != 1:
        raise AssertionError(f"{name}: one launch moved the counters by "
                             f"{moved}")
    return ran[0]


def bwd_path_checks(what, grads, refs, faults_of, tol, launch, launch_one,
                    one_rows):
    """At the path's shape: planted faults beyond ``tol``, a second launch
    bitwise equal to the first, and the rows of batch 1 (gradients
    ``one_rows``) equal to those of the full batch.  Returns the faults'
    gaps."""
    import torch
    faults = fault_gaps(grads, refs, faults_of)
    check_faults(what, faults, tol)
    again = launch()
    one = launch_one()
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"{what}: two launches differ")
    if not all(torch.equal(grads[i][:1], one[i]) for i in one_rows):
        raise AssertionError(f"{what}: rows of batch 1 != those of the "
                             "full batch")
    return faults


def flash_bwd_case(rn, shape, causal, window, dtype, path=False,
                   variant=None, inputs=None, tag="lm_train"):
    """One flash case: the forward with and without its log-sum-exp
    (the output's bits must not move; the lse within LSE_ATOL of the
    plain one), then the backward kernel (``variant``, default the
    wrapper's choice) against ``flash_attention_bwd_ref`` on the same
    inputs, each gradient within BWD_FP32_ROW or BWD_BF16_ROW
    (``row_gap``); at the path's shape also planted faults beyond it (dk
    and dv past the first K/V tile scaled, dq from the next head), two
    launches bitwise equal and the rows of batch 1 equal those of the
    full batch.  ``inputs`` (a case's returned inputs) skips the draw and
    the forward; ``tag`` heads the log line.  Returns (the row gaps, the
    max abs error, the faults' gaps, the inputs, the variant launched)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention.ref import (
        attention_lse, flash_attention_bwd_ref)
    Bq, H, Hkv, S, dh = shape
    what = (f"flash bwd {shape} causal {causal} window {window} {dtype} "
            f"({variant or 'chosen'})")
    lse_note = ""
    if inputs is None:
        q = rn(Bq, H, S, dh).to(dtype)
        k, v = rn(Bq, Hkv, S, dh).to(dtype), rn(Bq, Hkv, S, dh).to(dtype)
        dout = rn(Bq, H, S, dh).to(dtype)
        lse = torch.empty((Bq, H, S), dtype=torch.float32, device="cuda")
        out = fkernel.launch(q, k, v, causal, window, lse=lse)
        if not torch.equal(out, fkernel.launch(q, k, v, causal, window)):
            raise AssertionError(f"{what}: the forward's output moved with "
                                 "the lse output")
        lse_err = (lse - attention_lse(q, k, causal, window)).abs().max() \
            .item()
        if not lse_err <= LSE_ATOL:
            raise AssertionError(f"{what}: lse max abs {lse_err:.3g}")
        lse_note = (f"lse max abs {lse_err:.3g}, out bitwise with and "
                    "without it; ")
        inputs = (q, k, v, out, dout, lse)
    q, k, v, out, dout, lse = inputs
    before = dict(fkernel.COUNTS)
    launch = lambda: fkernel.launch_backward(q, k, v, out, dout, lse,
                                             causal, window, variant=variant)
    grads = launch()
    ran = launched_variant(fkernel, "flash_attention_bwd", before)
    refs = flash_attention_bwd_ref(q, k, v, out, dout, lse, causal, window)
    tol = BWD_FP32_ROW if dtype == torch.float32 else BWD_BF16_ROW
    gaps = [row_gap(g, r) for g, r in zip(grads, refs)]
    abs_err = max((g.float() - r.float()).abs().max().item()
                  for g, r in zip(grads, refs))
    if not max(gaps) <= tol:
        raise AssertionError(f"{what}: dq/dk/dv row gaps {gaps} > {tol}")
    faults, old = {}, None
    if path:
        faults = bwd_path_checks(
            what, grads, refs, flash_faults(), tol, launch,
            lambda: fkernel.launch_backward(
                q[:1], k[:1], v[:1], out[:1], dout[:1],
                lse[:1].contiguous(), causal, window, variant=variant),
            (0, 1, 2))
        old = lm_gap(scaled_past(2, 64)(grads[2].float()), refs[2])
    log(f"{tag}/flash_bwd {shape} causal {causal} window {window} "
        f"{str(dtype)[6:]} {ran}: {lse_note}dq/dk/dv row gaps "
        f"{', '.join(f'{e:.3g}' for e in gaps)} (limit {tol}), max abs "
        f"{abs_err:.3g}" +
        (f"; planted faults (x{1 + FAULT}) "
         f"{', '.join(f'{f}: {g:.3g}' for f, g in faults.items())}, all "
         f"beyond it (dv's fault by max |k − r| / max(1, max |r|): "
         f"{old:.3g}); two launches and batch rows bitwise" if path else ""))
    return gaps, abs_err, faults, inputs, ran


def ssd_bwd_case(rn, shape, dtype, dfinal: bool, path=False, variant=None,
                 inputs=None):
    """One SSD case: the backward kernel (``variant``, default the
    wrapper's choice) against ``ssd_chunked_bwd_ref`` on the same inputs
    (dy, and a d(final state) or none), each gradient within BWD_FP32_ROW
    or BWD_BF16_ROW (``row_gap``); at the path's shape also planted
    faults beyond it (dx, dB and dC past the first chunk and dA past the
    first head scaled, ddt from the next head), two launches bitwise
    equal and the rows of batch 1 (dx, ddt, dB, dC; dA sums over the
    batch) equal those of the full batch.  ``inputs`` (a case's returned
    inputs) skips the draw.  Returns (the row gaps, the max abs error,
    the faults' gaps, the inputs, the variant launched)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import kernel as skernel
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd_ref
    b, s, h, p, n, chunk = shape
    if inputs is None:
        x = rn(b, s, h, p).to(dtype)
        dt = F.softplus(rn(b, s, h) - 1)
        A = -torch.exp(rn(h))
        Bm, Cm = rn(b, s, n).to(dtype), rn(b, s, n).to(dtype)
        dy = rn(b, s, h, p).to(dtype)
        dfs = rn(b, h, p, n) if dfinal else None
        inputs = (x, dt, A, Bm, Cm, chunk, dy, dfs)
    x, dt, A, Bm, Cm, chunk, dy, dfs = inputs
    before = dict(skernel.COUNTS)
    launch = lambda: skernel.launch_backward(*inputs, variant=variant)
    grads = launch()
    ran = launched_variant(skernel, "ssd_scan_bwd", before)
    refs = ssd_chunked_bwd_ref(*inputs)
    tol = BWD_FP32_ROW if dtype == torch.float32 else BWD_BF16_ROW
    gaps = [row_gap(g, r) for g, r in zip(grads, refs)]
    abs_err = max((g.float() - r.float()).abs().max().item()
                  for g, r in zip(grads, refs))
    what = (f"ssd bwd {shape} {dtype} d(final) "
            f"{'random' if dfinal else 'none'} ({ran})")
    if not max(gaps) <= tol:
        raise AssertionError(f"{what}: dx/ddt/dA/dB/dC row gaps {gaps} > "
                             f"{tol}")
    faults, old = {}, None
    if path:
        faults = bwd_path_checks(
            what, grads, refs, ssd_faults(chunk), tol, launch,
            lambda: skernel.launch_backward(
                x[:1], dt[:1], A, Bm[:1], Cm[:1], chunk, dy[:1],
                None if dfs is None else dfs[:1], variant=variant),
            (0, 1, 3, 4))
        old = lm_gap(scaled_past(1, chunk)(grads[0].float()), refs[0])
    tile = "" if ran == "wgmma" else \
        f" (tile {skernel.bwd_tile(chunk, p, n)})"
    log(f"lm_train/ssd_bwd {shape} {str(dtype)[6:]} d(final) "
        f"{'random' if dfinal else 'none'} {ran}{tile}: dx/ddt/dA/dB/dC row "
        f"gaps {', '.join(f'{e:.3g}' for e in gaps)} (limit {tol}), max "
        f"abs {abs_err:.3g}" +
        (f"; planted faults (x{1 + FAULT}) "
         f"{', '.join(f'{f}: {g:.3g}' for f, g in faults.items())}, all "
         f"beyond it (dx's fault by max |k − r| / max(1, max |r|): "
         f"{old:.3g}); two launches and batch rows bitwise" if path else ""))
    return gaps, abs_err, faults, inputs, ran


def bwd_kernel_checks() -> dict:
    """(a) and (b) of the LM training phase: both backward kernels
    against their plain versions on the card in a sweep (which must
    launch both variants, wgmma and simt) and at the path's shapes (the
    wgmma variant, the wrappers' choice there, and simt on the same
    inputs through ``variant="simt"``, each with its planted faults,
    repeat and batch-row checks), and their times at the path's shapes
    (both variants) beside the plain versions', SDPA's backward and the
    bound.  Returns the kernel records of ``flash_attention_bwd`` and
    ``ssd_scan_bwd``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_ref
    from repro_torch.kernels.ssd_scan import kernel as skernel
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd_ref

    g = torch.Generator(device="cuda").manual_seed(20)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    bf16 = torch.bfloat16
    records, path_inputs = {}, {}
    for name, kmod, case, sweep_cases, path_args in (
            ("flash_attention_bwd", fkernel, flash_bwd_case,
             [(shape, c, w, getattr(torch, dt))
              for shape, c, w, dt in FLASH_BWD_SWEEP],
             FLASH_BWD_PATH + (bf16,)),
            ("ssd_scan_bwd", skernel, ssd_bwd_case,
             [(shape, getattr(torch, dt), fin)
              for shape, dt, fin in SSD_BWD_SWEEP],
             (SSD_BWD_PATH, bf16, False))):
        sweep = [case(rn, *c) for c in sweep_cases]
        ran = sorted({r[4] for r in sweep})
        if ran != sorted(kmod.BWD_VARIANTS):
            raise AssertionError(f"{name}: the sweep launched {ran}, not "
                                 f"every variant {kmod.BWD_VARIANTS}")
        gaps, err, faults, args, var = case(rn, *path_args, path=True)
        if var != "wgmma":
            raise AssertionError(f"{name}: the path's shape took {var}")
        sgaps, _, sfaults, _, _ = case(rn, *path_args, path=True,
                                       variant="simt", inputs=args)
        log(f"lm_train/{name}: {len(sweep)} sweep cases ("
            f"{', '.join(r[4] for r in sweep)}) worst row gap "
            f"{max(max(r[0]) for r in sweep):.3g}; the path's {max(gaps):.3g}"
            f" (simt {max(sgaps):.3g}); the least planted fault "
            f"{min(faults.values()):.3g} (simt "
            f"{min(sfaults.values()):.3g})")
        records[name] = dict(max_abs_err=err, row_gap=max(gaps),
                             row_limit=BWD_BF16_ROW, faults=faults,
                             simt_row_gap=max(sgaps), simt_faults=sfaults)
        path_inputs[name] = args

    shape, causal, window = FLASH_BWD_PATH
    q, k, v, out, dout, lse = fargs = path_inputs.pop("flash_attention_bwd")
    r = records["flash_attention_bwd"]
    r["shape"] = list(q.shape)
    r["ms"] = time_ms(lambda: fkernel.launch_backward(*fargs, causal,
                                                      window),
                      iters=20, warmup=2)
    r["simt_ms"] = time_ms(lambda: fkernel.launch_backward(
        *fargs, causal, window, variant="simt"), iters=20, warmup=2)
    r["plain_ms"] = time_ms(lambda: flash_attention_bwd_ref(
        *fargs, causal, window), iters=3, warmup=1)
    with torch.enable_grad():
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        r["library_ms"] = time_ms(lambda: torch.autograd.grad(
            o, (qg, kg, vg), dout, retain_graph=True), iters=20, warmup=2)
    r["bound_ms"], r["bound_by"] = flash_bwd_bound(q, k, causal, window)
    del fargs, q, k, v, out, dout, lse, o, qg, kg, vg

    sargs = path_inputs.pop("ssd_scan_bwd")
    r = records["ssd_scan_bwd"]
    r.update(shape=list(sargs[0].shape), chunk=sargs[5], library_ms=None)
    r["ms"] = time_ms(lambda: skernel.launch_backward(*sargs), iters=20,
                      warmup=2)
    r["simt_ms"] = time_ms(lambda: skernel.launch_backward(
        *sargs, variant="simt"), iters=20, warmup=2)
    r["plain_ms"] = time_ms(lambda: ssd_chunked_bwd_ref(*sargs), iters=3,
                            warmup=1)
    r["bound_ms"], r["bound_by"] = ssd_bwd_bound(sargs[0], sargs[3],
                                                 sargs[5])
    for name, r in records.items():
        log(f"kernel/{name} at the LM training step's {r['shape']}: wgmma "
            f"{r['ms']:.4f} ms, simt {r['simt_ms']:.4f} ms "
            f"({r['simt_ms'] / r['ms']:.1f}x), plain {r['plain_ms']:.4f} "
            f"ms, library {fmt_ms(r['library_ms'])}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}): "
            f"{100 * r['bound_ms'] / r['ms']:.2f}% of the bound's rate "
            f"(simt {100 * r['bound_ms'] / r['simt_ms']:.2f}%)")
    return records


def repeat_step_bitwise(tag: str, step, params, opt, batch):
    """One training step from the current parameters, AdamW state and
    batch, then the same step again from a copy of them: the loss, the
    grad norm, the parameters and both moments must be bitwise equal.
    Leaves the state after one step; returns (loss, grad norm)."""
    import torch
    from repro_torch.optim.adamw import named

    def snapshot():
        return ({n: p.detach().clone() for n, p in named(params).items()},
                {w: {n: t.clone() for n, t in opt[w].items()}
                 for w in ("m", "v")}, opt["step"].clone())

    def restore(snap):
        with torch.no_grad():
            for n, p in named(params).items():
                p.copy_(snap[0][n])
        for w in ("m", "v"):
            for n, t in opt[w].items():
                t.copy_(snap[1][w][n])
        opt["step"] = snap[2].clone()

    before = snapshot()
    _, _, m = step(params, opt, batch)
    la, ga, after = m["loss"].item(), m["grad_norm"].item(), snapshot()
    restore(before)
    del before
    _, _, m = step(params, opt, batch)
    lb, gb = m["loss"].item(), m["grad_norm"].item()
    same = la == lb and ga == gb and int(opt["step"]) == int(after[2]) and \
        all(torch.equal(p, after[0][n]) for n, p in named(params).items()) \
        and all(torch.equal(t, after[1][w][n]) for w in ("m", "v")
                for n, t in opt[w].items())
    if not same:
        raise AssertionError(f"{tag}: a repeated step differs (loss "
                             f"{la} vs {lb}, grad norm {ga} vs {gb})")
    log(f"{tag}/repeat: one step from the same parameters, AdamW state "
        f"and batch, twice: loss {la!r}, grad norm {ga!r}, parameters and "
        "both moments bitwise equal")
    return la, ga


def grad_gaps(a: dict, b: dict) -> dict:
    """{name: ‖a − b‖ / ‖b‖} per gradient leaf, in float32 on a's
    device."""
    out = {}
    for n, g in b.items():
        g = g.float().to(next(iter(a.values())).device)
        out[n] = ((a[n].float() - g).norm() /
                  g.norm().clamp(min=1e-30)).item()
    return out


def phase_lm_train():
    """The LM training path at full width: Zamba2-1.2B (38 Mamba2 layers,
    d_model 2048, 64 SSD heads of 64, state 64, the shared attention+MLP
    block every 6 layers, vocab 32,000, bf16, threefry seed 0).  (a) and
    (b) ``bwd_kernel_checks``; (c) ``launch/train.py``'s ``main`` for
    LM_TRAIN_STEPS steps of LM_TRAIN_BATCH x LM_TRAIN_SEQ tokens, the
    counters zeroed just before and read after every step: 6 flash and 6
    flash backward, 38 SSD and 38 SSD backward launches a step; finite
    losses, the first-10 mean above the last-10 mean; step wall (events),
    device time, events and idle share, and peak memory; (d) one step
    repeated from the same parameters, AdamW state and batch: bitwise
    equal; (e) a model cut to LM_CPU_LAYERS layers, batch 1, S =
    LM_GRAD_SEQ (ragged), on the card against the CPU port with the same
    weights: the loss within LM_LOSS_RTOL and every gradient leaf within
    LM_GRAD_RTOL (‖g_card − g_cpu‖ / ‖g_cpu‖), while another batch's CPU
    gradients must fall outside it.  Returns (the backward kernels'
    records, launches of (c))."""
    import copy
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.core import prng
    from repro_torch.device import deterministic_cuda
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.ssd_scan import kernel as skernel
    from repro_torch.launch import shapes, train
    from repro_torch.models import api
    from repro_torch.models.hybrid import _grouping
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.optim.schedules import cosine

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    deterministic_cuda()
    card = card_line()
    records = bwd_kernel_checks()                # (a), (b)
    cfg = get_arch(LM_ARCH)
    n_attn, L = _grouping(cfg)[1], cfg.n_layers
    per_step = {"flash_attention": n_attn, "flash_attention/wgmma": n_attn,
                "flash_attention/simt": 0, "flash_attention_bwd": n_attn,
                "flash_attention_bwd/wgmma": n_attn,
                "flash_attention_bwd/simt": 0, "ssd_scan": L,
                "ssd_scan/wgmma": L, "ssd_scan/simt": 0, "ssd_scan_bwd": L,
                "ssd_scan_bwd/wgmma": L, "ssd_scan_bwd/simt": 0}
    kmods = (fkernel, skernel)

    # (c) the CLI's main, counters read after every step
    launches = dict.fromkeys(per_step, 0)
    walls = []

    def on_step(i, params, opt, metrics):
        torch.cuda.synchronize()
        got = lm_counts(*kmods)
        check_lm_launches(f"lm_train step {i}", got, per_step, 1)
        for k, v in got.items():
            launches[k] += v
        for kmod in kmods:
            kmod.reset_counts()
        now = time.perf_counter()
        walls.append(now - clock[0])
        clock[0] = now

    argv = ["--arch", LM_ARCH, "--steps", str(LM_TRAIN_STEPS), "--batch",
            str(LM_TRAIN_BATCH), "--seq", str(LM_TRAIN_SEQ), "--device",
            "cuda"]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    for kmod in kmods:                           # --- main path starts
        kmod.reset_counts()
    clock = [time.perf_counter()]
    t0 = clock[0]
    losses = train.main(argv, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0              # --- main path ends
    peak = torch.cuda.max_memory_allocated() / 1e9
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    log(f"lm_train/cli: {' '.join(argv)}: {wall:.2f} s (init included); "
        f"losses {[round(x, 4) for x in losses]}; first-10 mean "
        f"{first:.4f}, last-10 mean {last:.4f}; step wall (host clock, "
        f"synchronised) first {walls[0]:.3f} s (init included), median of "
        f"the rest {sorted(walls[1:])[len(walls[1:]) // 2]:.4f} s; peak "
        f"memory {peak:.2f} GB; launches {launches}")
    if len(losses) != LM_TRAIN_STEPS or not all(
            math.isfinite(x) for x in losses) or not first > last:
        raise AssertionError(f"lm_train: losses not finite or not falling: "
                             f"{losses}")

    # one step on its own: events, the profile, then (d) the bitwise repeat
    key = prng.PRNGKey(0, device="cuda")
    params = api.init_params(key, cfg, "cuda")
    opt = init_opt_state(params)
    step = shapes.make_train_step(cfg, AdamWConfig(
        lr=3e-4, schedule=cosine(LM_TRAIN_STEPS, warmup=1)))
    batch = train.build_batch(prng.fold_in(key, 0), cfg, LM_TRAIN_BATCH,
                              LM_TRAIN_SEQ)
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: step(params, opt, batch), iters=3, warmup=1)
    step_peak = torch.cuda.max_memory_allocated() / 1e9
    prof = device_ms("lm_train/step", lambda: step(params, opt, batch), n=2,
                     top=10, shares=["flash_wgmma_kernel", "flash_bwd",
                                     "ssd_wgmma_kernel", "ssd_bwd"],
                     per="step")
    for name, kname, n in (("flash_attention_bwd", "flash_bwd", n_attn),
                           ("ssd_scan_bwd", "ssd_bwd", L)):
        records[name]["card_ms"] = None if prof[kname] is None else \
            prof[kname] / n
        records[name]["card_events"] = prof[f"{kname}/events"]
    idle = "not measured" if prof["_ms"] is None else \
        f"{100 * (1 - prof['_ms'] / step_ms):.1f}%"
    log(f"lm_train/step: B={LM_TRAIN_BATCH} S={LM_TRAIN_SEQ} wall "
        f"{step_ms:.3f} ms (events), device {fmt_ms(prof['_ms'])} over "
        f"{prof['_events']} events, idle {idle}; peak memory "
        f"{step_peak:.2f} GB; card ms a launch: flash bwd "
        f"{fmt_ms(records['flash_attention_bwd']['card_ms'])}, ssd bwd "
        f"{fmt_ms(records['ssd_scan_bwd']['card_ms'])}; card {card}")

    repeat_step_bitwise("lm_train", step, params, opt, batch)
    del params, opt, step
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the card against the CPU port: LM_CPU_LAYERS layers, batch 1
    small = dataclasses.replace(cfg, n_layers=LM_CPU_LAYERS)
    m_card = api.init_params(prng.PRNGKey(0), small, "cuda")
    m_cpu = copy.deepcopy(m_card).to("cpu")
    b1 = train.build_batch(prng.fold_in(key, 1), small, 1, LM_GRAD_SEQ)
    b2 = train.build_batch(prng.fold_in(key, 2), small, 1, LM_GRAD_SEQ)
    t0 = time.perf_counter()
    l_card, g_card = shapes.loss_and_grads(m_card, b1, small)
    on_cpu = lambda b: {k: v.cpu() for k, v in b.items()}
    l_cpu, g_cpu = shapes.loss_and_grads(m_cpu, on_cpu(b1), small)
    _, g_other = shapes.loss_and_grads(m_cpu, on_cpu(b2), small)
    cpu_s = time.perf_counter() - t0
    loss_gap = abs(l_card.item() - l_cpu.item()) / abs(l_cpu.item())
    gaps = grad_gaps(g_card, g_cpu)
    control = grad_gaps(g_card, g_other)
    worst = max(gaps, key=gaps.get)
    median = lambda d: sorted(d.values())[len(d) // 2]
    log(f"lm_train/card_vs_cpu ({LM_CPU_LAYERS} layers, B=1, "
        f"S={LM_GRAD_SEQ}, {cpu_s:.1f} s): loss card {l_card.item():.6f} "
        f"cpu {l_cpu.item():.6f} (rel {loss_gap:.3g}, limit "
        f"{LM_LOSS_RTOL}); gradient leaves ‖card − cpu‖ / ‖cpu‖: median "
        f"{median(gaps):.4g}, worst {gaps[worst]:.4g} ({worst}), limit "
        f"{LM_GRAD_RTOL}; control (another batch's cpu gradients): median "
        f"{median(control):.4g}, least {min(control.values()):.4g}")
    if not (loss_gap <= LM_LOSS_RTOL and gaps[worst] <= LM_GRAD_RTOL):
        raise AssertionError(f"lm_train: card vs cpu beyond the limits: "
                             f"loss {loss_gap:.3g}, {worst} "
                             f"{gaps[worst]:.3g}")
    if not median(control) > LM_GRAD_RTOL:
        raise AssertionError("lm_train: the gradient check passed another "
                             "batch's gradients")
    del m_card, m_cpu, g_card, g_cpu, g_other
    gc.collect()
    torch.cuda.empty_cache()
    log(f"lm_train/phase_s: {time.perf_counter() - t_phase:.1f}; card {card}")
    return records, launches


def gmm_faults() -> dict:
    """Planted faults of the grouped matmul's backward (dtokens,
    dweights), for ``fault_gaps``: dtokens past the first 64 token rows
    and dweights past the first 64 rows of D scaled, dtokens from the next
    expert."""
    return {"dX past the first 64 rows": (0, scaled_past(1, 64)),
            "dW past the first 64 rows": (1, scaled_past(1, 64)),
            "dX from the next expert": (0, lambda g: g.roll(1, dims=0))}


def gmm_bwd_case(rn, E, D, F, what, C, broadcast, dtype, misaligned=False):
    """(a) One case of the grouped matmul's backward at DBRX's expert
    shapes: the kernel against ``grouped_matmul_bwd_ref`` on the same
    inputs, each gradient within BWD_FP32_ROW or BWD_BF16_ROW
    (``row_gap``), planted faults beyond it, two launches bitwise and dX's
    first 64 rows equal to a launch over those rows alone; its time
    beside the plain version's, the ``torch.bmm`` pair's and the bound;
    where the ``wgmma`` variant ran, also the older ``wmma`` design's time
    (``wmma_ms``), of which it must take at most half from C =
    GMM_BWD_HALF_FROM_C on; in bf16 also the forward at this C against
    its plain version, timed beside ``torch.bmm``.  ``misaligned``: the
    tokens start one element past a 16-byte boundary.  Returns the case's
    record."""
    import torch
    from repro_torch.kernels.grouped_matmul import kernel as gkernel
    from repro_torch.kernels.grouped_matmul.ref import (
        grouped_matmul_bwd_ref, grouped_matmul_ref)
    tok = rn(C, D).to(dtype).unsqueeze(0).expand(E, -1, -1) if broadcast \
        else rn(E, C, D).to(dtype)
    if misaligned:
        tok = torch.cat([tok.new_zeros(1), tok.flatten()])[1:].view(E, C, D)
    w = (rn(E, D, F) * D ** -0.5).to(dtype)
    dy = rn(E, C, F).to(dtype)
    tag = f"grouped_matmul_bwd {what} {(E, C, D, F)} {str(dtype)[6:]}"
    before = dict(gkernel.COUNTS)
    launch = lambda: gkernel.launch_backward(tok, w, dy)
    grads = launch()
    ran = launched_variant(gkernel, "grouped_matmul_bwd", before)
    refs = grouped_matmul_bwd_ref(tok, w, dy)
    tol = BWD_FP32_ROW if dtype == torch.float32 else BWD_BF16_ROW
    gaps = [row_gap(g, r) for g, r in zip(grads, refs)]
    err = max((g.float() - r.float()).abs().max().item()
              for g, r in zip(grads, refs))
    if not max(gaps) <= tol:
        raise AssertionError(f"{tag}: dX/dW row gaps {gaps} > {tol}")
    faults = fault_gaps(grads, refs, gmm_faults())
    check_faults(tag, faults, tol)
    del refs
    again = launch()
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"{tag}: two launches differ")
    del again
    part, _ = gkernel.launch_backward(tok[:, :64], w,
                                      dy[:, :64].contiguous())
    if not torch.equal(part, grads[0][:, :64]):
        raise AssertionError(f"{tag}: dX rows at C = 64 != the first 64 "
                             f"rows at C = {C}")
    del grads, part
    iters = 5 if dtype == torch.bfloat16 else 2
    ms = time_ms(launch, iters=iters, warmup=1)
    plain = time_ms(lambda: grouped_matmul_bwd_ref(tok, w, dy), iters=2,
                    warmup=1)
    xs, wt = tok.contiguous(), w.transpose(1, 2)
    lib = time_ms(lambda: (torch.bmm(dy, wt), torch.bmm(xs.transpose(1, 2),
                                                        dy)),
                  iters=iters, warmup=1)
    wmma = None
    if ran == "wgmma":
        wmma = time_ms(lambda: gkernel.launch_backward(tok, w, dy,
                                                       variant="wmma"),
                       iters=iters, warmup=1)
    bnd, by = gmm_bwd_bound(E, C, D, F, w.element_size(), broadcast)
    rec = dict(what=what, shape=[E, C, D, F], broadcast=broadcast,
               dtype=str(dtype)[6:], variant=ran, max_abs_err=err,
               row_gap=max(gaps), row_limit=tol, faults=faults, ms=ms,
               plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by)
    older = ""
    if wmma is not None:
        rec["wmma_ms"] = wmma
        older = f" wmma {wmma:.4f} ms ({ms / wmma:.3f}x)"
    log(f"moe_train/{tag} ({ran}): dX/dW row gaps "
        f"{', '.join(f'{e:.3g}' for e in gaps)} (limit {tol}), max abs "
        f"{err:.3g}; planted faults (x{1 + FAULT}) "
        f"{', '.join(f'{f}: {g:.3g}' for f, g in faults.items())}; two "
        f"launches and rows across C bitwise; kernel {ms:.4f} ms{older} "
        f"plain {plain:.4f} ms torch.bmm pair {lib:.4f} ms "
        f"({ms / lib:.2f}x) bound {bnd:.4f} ms ({by}): "
        f"{100 * bnd / ms:.2f}% of the bound's rate, "
        f"{4 * E * C * D * F / ms / 1e9:.1f} TFLOP/s")
    if wmma is not None and C >= GMM_BWD_HALF_FROM_C and \
            not ms <= 0.5 * wmma:
        raise AssertionError(f"{tag}: wgmma {ms:.4f} ms is over half of "
                             f"wmma's {wmma:.4f} ms")
    if dtype == torch.bfloat16:
        out = gkernel.launch(tok, w)
        ref = grouped_matmul_ref(tok, w)
        ferr = (out.float() - ref.float()).abs().max().item()
        if not torch.allclose(out.float(), ref.float(), **TOL_BF16):
            raise AssertionError(f"grouped_matmul {what} C {C}: max abs "
                                 f"{ferr:.3g} beyond {TOL_BF16}")
        del out, ref
        fms = time_ms(lambda: gkernel.launch(tok, w), iters=iters, warmup=1)
        flib = time_ms(lambda: torch.bmm(xs, w), iters=iters, warmup=1)
        fbnd, fby = gmm_bound(E, C, D, F, 2, broadcast)
        rec["forward"] = dict(shape=[E, C, D, F], broadcast=broadcast,
                              variant=gkernel.choose_variant(tok, w),
                              max_abs_err=ferr, ms=fms, library_ms=flib,
                              bound_ms=fbnd, bound_by=fby)
        log(f"moe_train/grouped_matmul {what} {(E, C, D, F)} bf16 "
            f"({rec['forward']['variant']}): max_abs_err {ferr:.3g}; kernel "
            f"{fms:.4f} ms torch.bmm {flib:.4f} ms ({fms / flib:.3f}x) "
            f"bound {fbnd:.4f} ms ({fby})")
    del tok, w, dy, xs, wt
    torch.cuda.empty_cache()
    return rec


def gmm_bwd_checks(arch) -> dict:
    """(a) The grouped matmul's backward at every case of GMM_BWD_CASES,
    bf16 (``wgmma``) and float32 (``simt``), and at GMM_BWD_MISALIGNED
    with a misaligned token pointer (bf16, ``wmma``): all three variants
    must be launched.  Returns the ``grouped_matmul_bwd`` record (its main
    numbers the dense LM's bf16 case; ``shapes`` every case) and the
    forward's numbers at the capacity-packed and dense LM's C."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(23)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    E, D, F = arch.n_experts, arch.d_model, arch.d_ff
    cases = [gmm_bwd_case(rn, E, D, F, what, C, bc, dtype)
             for dtype in (torch.bfloat16, torch.float32)
             for what, C, bc in GMM_BWD_CASES]
    mE, mC, mD, mF = GMM_BWD_MISALIGNED
    odd = gmm_bwd_case(rn, mE, mD, mF, "misaligned", mC, False,
                       torch.bfloat16, misaligned=True)
    ran = {c["variant"]: c["what"] for c in cases + [odd]}
    if sorted(ran) != ["simt", "wgmma", "wmma"] or ran["wmma"] != \
            "misaligned" or any(c["variant"] != "wgmma" for c in cases
                                if c["dtype"] == "bfloat16"):
        raise AssertionError(f"grouped_matmul_bwd: the cases launched "
                             f"{[(c['what'], c['variant']) for c in cases]}"
                             f" and {odd['variant']} misaligned")
    head = next(c for c in cases if c["what"] == "dense LM" and
                c["dtype"] == "bfloat16")
    record = {k: head[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "library_ms", "bound_ms", "bound_by",
                                   "faults")}
    record.update(shape=head["shape"], row_limit=BWD_BF16_ROW,
                  row_gap=max(c["row_gap"] for c in cases + [odd]
                              if c["dtype"] == "bfloat16"),
                  shapes=[{k: v for k, v in c.items() if k != "forward"}
                          for c in cases + [odd]])
    forward = [c["forward"] for c in cases
               if "forward" in c and c["shape"][1] != 256]
    return record, forward


def moe_ep_checks(layer, arch, mesh) -> None:
    """(b) One full-width MoE layer, MOE_EP_TOKENS tokens (4 x 64), through
    ``moe_ep`` and ``moe_ep2d`` on the one-card NCCL mesh: at capacity
    factor MOE_EP_ROOMY (nothing dropped) within MOE_EP_RTOL of
    ``moe_dense`` (max |ep − dense| / max(1, max |dense|)); at the
    configured factor with its drops counted and the output finite; two
    calls bitwise."""
    import torch
    from repro_torch.models import moe
    g = torch.Generator(device="cuda").manual_seed(24)
    x = torch.randn((4, MOE_EP_TOKENS // 4, arch.d_model), generator=g,
                    device="cuda").to(arch.torch_dtype)
    for cf in (MOE_EP_ROOMY, arch.capacity_factor):
        cfg = dataclasses.replace(arch, capacity_factor=cf)
        xt = x.reshape(-1, arch.d_model)
        _, w, idx = moe._router(layer, xt, arch.top_k)
        cap = moe._capacity(cfg, xt.shape[0])
        _, meta = moe._dispatch_local(xt, w, idx, arch.n_experts, cap)
        drops = int((~meta["keep"]).sum())
        dense, _ = moe.moe_dense(layer, x, cfg)
        scale = max(1.0, dense.float().abs().max().item())
        for mode in ("ep", "ep2d"):
            fn = getattr(moe, f"moe_{mode}")
            y, aux = fn(layer, x, cfg, mesh)
            again, _ = fn(layer, x, cfg, mesh)
            gap = (y.float() - dense.float()).abs().max().item() / scale
            log(f"moe_train/{mode} capacity factor {cf} (C {cap} of "
                f"{xt.shape[0]} tokens x top-{arch.top_k}, {drops} "
                f"assignments dropped): max |{mode} - dense| / max(1, max "
                f"|dense|) {gap:.4g} (limit {MOE_EP_RTOL} without drops), "
                f"aux {aux.item():.5f}; two calls bitwise")
            if not torch.equal(y, again):
                raise AssertionError(f"moe {mode}: two calls differ")
            if not torch.isfinite(y).all() or y.shape != x.shape:
                raise AssertionError(f"moe {mode}: bad output")
            if cf == MOE_EP_ROOMY and (drops or not gap <= MOE_EP_RTOL):
                raise AssertionError(f"moe {mode}: {gap:.4g} from dense "
                                     f"with {drops} drops")
        del dense, y, again
    torch.cuda.empty_cache()


def moe_flash_bwd(rn) -> dict:
    """The flash backward at DBRX's attention (FLASH_BWD_DBRX: 48 query /
    8 KV heads of 128, causal) against its plain version with planted
    faults, timed beside SDPA's backward (K/V repeated per group) and the
    bound.  Returns its record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_ref
    shape, causal = FLASH_BWD_DBRX
    gaps, err, faults, args, ran = flash_bwd_case(
        rn, shape, causal, 0, torch.bfloat16, path=True, tag="moe_train")
    if ran != "wgmma":
        raise AssertionError(f"moe_train flash bwd: took {ran}")
    q, k, v, out, dout, lse = args
    r = dict(shape=list(q.shape), kv_heads=k.shape[1], causal=causal,
             max_abs_err=err, row_gap=max(gaps), row_limit=BWD_BF16_ROW,
             faults=faults)
    r["ms"] = time_ms(lambda: fkernel.launch_backward(*args, causal, 0),
                      iters=10, warmup=2)
    r["plain_ms"] = time_ms(lambda: flash_attention_bwd_ref(
        *args, causal, 0), iters=2, warmup=1)
    grp = q.shape[1] // k.shape[1]
    with torch.enable_grad():
        qg, kg, vg = (t.detach().requires_grad_() for t in (
            q, k.repeat_interleave(grp, 1), v.repeat_interleave(grp, 1)))
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        r["library_ms"] = time_ms(lambda: torch.autograd.grad(
            o, (qg, kg, vg), dout, retain_graph=True), iters=10, warmup=2)
    r["bound_ms"], r["bound_by"] = flash_bwd_bound(q, k, causal, 0)
    log(f"kernel/flash_attention_bwd at DBRX's {r['shape']} Hkv "
        f"{r['kv_heads']} causal: wgmma {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, SDPA backward {r['library_ms']:.4f} ms "
        f"({r['ms'] / r['library_ms']:.2f}x), bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}): {100 * r['bound_ms'] / r['ms']:.2f}% of the "
        f"bound's rate; row gap {r['row_gap']:.3g}, least fault "
        f"{min(faults.values()):.3g}")
    del args, q, k, v, out, dout, lse, o, qg, kg, vg
    torch.cuda.empty_cache()
    return r


def phase_moe_train():
    """The MoE training path (DBRX-132B, MOE_LAYERS blocks at the
    published widths, bf16): (a) ``gmm_bwd_checks``; the flash backward
    at DBRX's attention (``moe_flash_bwd``); (b) ``moe_ep_checks`` on a
    one-card NCCL mesh (``make_debug_mesh``, torn down at the end); (d)
    the ``train`` CLI on the reduced config (float32: the ``simt``
    variants) for LM_TRAIN_STEPS steps, counters read after every step,
    its losses within LM_LOSS_RTOL of the same CLI's on the CPU; at full
    width, B x S = MOE_TRAIN_BATCH x MOE_TRAIN_SEQ, ``loss_and_grads``
    dense and expert-parallel (``make_runtime``), each counted from zero
    just before: per layer 3 grouped matmuls and 1 flash forward with as
    many backward launches; loss, wall, device ms, events, idle and peak
    memory; the reduced config's gradients on the card against the CPU
    port, dense and expert-parallel, within LM_GRAD_RTOL, another batch's
    outside.  Returns (records, launches of the path's runs)."""
    import copy
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.core import prng
    from repro_torch.device import deterministic_cuda
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.grouped_matmul import kernel as gkernel
    from repro_torch.launch import shapes, train
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import api
    from repro_torch.models.transformer import CPU

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    deterministic_cuda()
    card = card_line()
    kmods = (fkernel, gkernel)
    arch = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_LAYERS)
    record, forward = gmm_bwd_checks(arch)                     # (a)
    g = torch.Generator(device="cuda").manual_seed(25)
    flash = moe_flash_bwd(lambda *s: torch.randn(s, generator=g,
                                                 device="cuda"))
    mesh = make_debug_mesh()
    log(f"moe_train/mesh: {mesh} over {dist.get_backend()}, world size "
        f"{dist.get_world_size()}")
    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    # (d) the CLI on the reduced config, card and CPU
    small = reduced(get_arch(MOE_ARCH))
    L = small.n_layers
    per_cli = {"grouped_matmul": 3 * L, "grouped_matmul/simt": 3 * L,
               "grouped_matmul/wgmma": 0, "grouped_matmul/wmma": 0,
               "flash_attention": L, "flash_attention/simt": L,
               "flash_attention/wgmma": 0}
    per_cli = with_backward(per_cli, "grouped_matmul", "flash_attention",
                            variant="simt")             # float32

    def on_step(i, params, opt, metrics):
        torch.cuda.synchronize()
        got = lm_counts(*kmods)
        check_lm_launches(f"moe_train cli step {i}", got, per_cli, 1)
        add(got)
        for kmod in kmods:
            kmod.reset_counts()

    argv = ["--arch", MOE_ARCH, "--reduced", "--steps", str(LM_TRAIN_STEPS)]
    for kmod in kmods:                           # --- main path starts
        kmod.reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        losses = train.main(argv + ["--device", "cuda"], on_step=on_step)
        card_s = time.perf_counter() - t0
        cpu_losses = train.main(argv + ["--device", "cpu"])
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses)]
    log(f"moe_train/cli: {' '.join(argv)} --device cuda: {card_s:.2f} s; "
        f"losses {[round(x, 4) for x in losses]}; against the CPU CLI's "
        f"largest relative gap {max(gaps):.3g} (limit {LM_LOSS_RTOL})")
    if len(losses) != LM_TRAIN_STEPS or not max(gaps) <= LM_LOSS_RTOL:
        raise AssertionError(f"moe_train cli: losses {losses} against the "
                             f"CPU's {cpu_losses}")

    # (d) full width: loss and gradients, dense and expert-parallel
    key = prng.PRNGKey(0, device="cuda")
    t0 = time.perf_counter()
    lm = api.init_params(key, arch, "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    log(f"moe_train/init: {MOE_ARCH} LM of {n_params} parameters "
        f"({arch.n_layers} layers, bf16) in {time.perf_counter() - t0:.2f} "
        f"s; device memory {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    moe_ep_checks(lm.layers[0].moe, arch, mesh)                # (b)
    batch = train.build_batch(prng.fold_in(key, 0), arch, MOE_TRAIN_BATCH,
                              MOE_TRAIN_SEQ)
    n = arch.n_layers
    per_step = with_backward(
        {"grouped_matmul": 3 * n, "grouped_matmul/wgmma": 3 * n,
         "grouped_matmul/wmma": 0, "grouped_matmul/simt": 0,
         "flash_attention": n, "flash_attention/wgmma": n,
         "flash_attention/simt": 0}, "grouped_matmul", "flash_attention")
    steps = {}
    for mode, rt in (("dense", CPU), ("ep", shapes.make_runtime(mesh))):
        run = lambda: shapes.loss_and_grads(lm, batch, arch, rt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kmod in kmods:
            kmod.reset_counts()
        t0 = time.perf_counter()
        loss, grads = run()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        got = lm_counts(*kmods)
        check_lm_launches(f"moe_train {mode}", got, per_step, 1)
        add(got)
        peak = torch.cuda.max_memory_allocated() / 1e9
        bad = [k for k, v in grads.items() if not torch.isfinite(v).all()]
        if bad or not torch.isfinite(loss):
            raise AssertionError(f"moe_train {mode}: not finite: {bad[:5]}")
        del grads
        step_ms = time_ms(run, iters=2, warmup=0)
        prof = device_ms(f"moe_train/{mode}", run, n=1, top=8,
                         shares=["gmm_bwd", "gmm_wgmma", "flash_bwd"],
                         per="step")
        idle = "not measured" if prof["_ms"] is None else \
            f"{100 * (1 - prof['_ms'] / step_ms):.1f}%"
        steps[mode] = dict(loss=loss.item(), wall_ms=step_ms,
                           device_ms=prof["_ms"], events=prof["_events"],
                           peak_gb=peak, gmm_bwd_ms=prof["gmm_bwd"])
        log(f"moe_train/{mode}: loss_and_grads B={MOE_TRAIN_BATCH} "
            f"S={MOE_TRAIN_SEQ}: loss {loss.item():.5f}; first call "
            f"{first:.3f} s; wall {step_ms:.3f} ms (events), device "
            f"{fmt_ms(prof['_ms'])} over {prof['_events']} events, idle "
            f"{idle}; peak memory {peak:.2f} GB; the backward kernel "
            f"{fmt_ms(prof['gmm_bwd'])} a step over {prof['gmm_bwd/events']}"
            f" events; launches {got}; card {card}")
        if mode == "dense" and prof["gmm_bwd"] is not None:
            record["card_ms"] = prof["gmm_bwd"] / (3 * n)
            record["card_events"] = prof["gmm_bwd/events"] / (3 * n)
    record["steps"] = steps
    del lm, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the reduced config's gradients, card against the CPU port
    m_card = api.init_params(prng.PRNGKey(0), small, "cuda")
    m_cpu = copy.deepcopy(m_card).to("cpu")
    b1, b2 = (train.build_batch(prng.fold_in(key, i), small, 2,
                                MOE_GRAD_SEQ) for i in (1, 2))
    on_cpu = lambda b: {k: v.cpu() for k, v in b.items()}
    card_grads = {"dense": shapes.loss_and_grads(m_card, b1, small),
                  "ep": shapes.loss_and_grads(m_card, b1, small,
                                              shapes.make_runtime(mesh))}
    dist.destroy_process_group()                 # the card's NCCL mesh
    cpu_mesh = make_debug_mesh(device="cpu")
    try:
        for mode, rt in (("dense", CPU),
                         ("ep", shapes.make_runtime(cpu_mesh))):
            l_card, g_card = card_grads[mode]
            l_cpu, g_cpu = shapes.loss_and_grads(m_cpu, on_cpu(b1), small, rt)
            _, g_other = shapes.loss_and_grads(m_cpu, on_cpu(b2), small, rt)
            loss_gap = abs(l_card.item() - l_cpu.item()) / abs(l_cpu.item())
            gaps = grad_gaps(g_card, g_cpu)
            control = grad_gaps(g_card, g_other)
            worst = max(gaps, key=gaps.get)
            median = lambda d: sorted(d.values())[len(d) // 2]
            log(f"moe_train/card_vs_cpu {mode} (reduced, B=2, "
                f"S={MOE_GRAD_SEQ}): loss card {l_card.item():.6f} cpu "
                f"{l_cpu.item():.6f} (rel {loss_gap:.3g}); gradient leaves "
                f"median {median(gaps):.4g}, worst {gaps[worst]:.4g} "
                f"({worst}), limit {LM_GRAD_RTOL}; control median "
                f"{median(control):.4g}")
            if not (loss_gap <= LM_LOSS_RTOL and
                    gaps[worst] <= LM_GRAD_RTOL):
                raise AssertionError(f"moe_train {mode}: card vs cpu beyond "
                                     f"the limits: loss {loss_gap:.3g}, "
                                     f"{worst} {gaps[worst]:.3g}")
            if not median(control) > LM_GRAD_RTOL:
                raise AssertionError(f"moe_train {mode}: the gradient check "
                                     "passed another batch's gradients")
    finally:
        dist.destroy_process_group()
    del m_card, m_cpu, card_grads
    gc.collect()
    torch.cuda.empty_cache()
    log(f"moe_train/phase_s: {time.perf_counter() - t_phase:.1f}; card "
        f"{card}")
    return dict(grouped_matmul_bwd=record, capacity_shapes=forward,
                flash_bwd=flash), launches


@contextlib.contextmanager
def flash_tally(fkernel):
    """While active, counts the flash forward and backward launches by
    their causal flag in the yielded {"fwd": {causal: n}, "bwd": {...}}
    (a tally beside the wrappers' own ``COUNTS``, which do not split by
    mask)."""
    tally = {"fwd": {True: 0, False: 0}, "bwd": {True: 0, False: 0}}
    orig = fkernel.launch, fkernel.launch_backward

    def fwd(q, k, v, causal, *a, **kw):
        tally["fwd"][bool(causal)] += 1
        return orig[0](q, k, v, causal, *a, **kw)

    def bwd(q, k, v, out, dout, lse, causal, *a, **kw):
        tally["bwd"][bool(causal)] += 1
        return orig[1](q, k, v, out, dout, lse, causal, *a, **kw)

    fkernel.launch, fkernel.launch_backward = fwd, bwd
    try:
        yield tally
    finally:
        fkernel.launch, fkernel.launch_backward = orig


def check_tally(tag: str, tally: dict, fwd: int, bwd: int) -> None:
    """``fwd`` non-causal and ``fwd`` causal forward launches, ``bwd`` of
    each backward."""
    want = {"fwd": {True: fwd, False: fwd}, "bwd": {True: bwd, False: bwd}}
    if tally != want:
        raise AssertionError(f"{tag}: flash launches by causal flag "
                             f"{tally}, expected {want}")


def phase_whisper():
    """The encoder-decoder at full width: whisper-base (6 encoder and 6
    decoder layers, d_model 512, 8 heads of 64, d_ff 2,048, vocab
    51,865, max_decoder_len 448, bf16, threefry seed 0).  (a) the
    ``serve`` CLI twice (batch 4, 1,500 frames, the decoder prompt's 8
    tokens, 32 new, greedy), counters zeroed just before each: tokens
    bitwise equal, 6 non-causal and 6 causal flash launches (all wgmma)
    for the prefill and none in the 31 decode steps; (b) prefill and
    WHISPER_DECODE teacher-forced decode steps against ``decode_train``
    over the extended tokens, for S_dec in WHISPER_PROMPTS (8; 448 and
    460, where the self cache holds the last 448 positions), every logit
    gap within LM_BF16_RTOL, and a decode step from a zero cache outside
    it; (c) flash on the first prefill's own encoder (non-causal, S
    1,500: 23 K/V tiles and a 28-row tail) and decoder (causal, S 448)
    inputs against the plain version, rows of batch 1 bitwise those of
    batch 4, timed beside SDPA and the bound; (d) the flash backward at
    the training step's encoder shape (8, 8, 1,500, 64) non-causal and
    decoder shape (8, 8, 448, 64) causal, both variants, with planted
    faults, two launches and batch rows bitwise, timed beside SDPA's
    backward and the bound; (e) ``launch/train.py``'s ``main`` for
    WHISPER_TRAIN_STEPS steps of WHISPER_TRAIN_BATCH x 1,500 frames and
    448 tokens, the counters read after every step (12 + 12 flash
    launches, 6 + 6 of each by causal flag, every backward wgmma), losses
    finite and falling, the parameter count n_params() plus the 32,768
    LayerNorm values, step wall, device time, events, idle share and
    peak memory, a repeated step bitwise; (f) 2 + 2 layers on the card
    against the CPU port (batch 1, WHISPER_GRAD_SEQ frames and tokens):
    the loss within LM_LOSS_RTOL and every gradient leaf within
    LM_GRAD_RTOL, another batch's gradients outside.  Returns (records at
    the encoder's shape for flash and its backward, launches of (a)'s
    first run, launches of (e))."""
    import copy
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_arch
    from repro_torch.core import prng
    from repro_torch.device import deterministic_cuda
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (
        attention_ref, flash_attention_bwd_ref)
    from repro_torch.launch import serve, shapes, train
    from repro_torch.models import api, encdec
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.optim.schedules import cosine

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    deterministic_cuda()
    card = card_line()
    cfg = get_arch(WHISPER_ARCH)
    L = cfg.n_layers + cfg.n_encoder_layers
    per_prefill = {"flash_attention": L, "flash_attention/wgmma": L,
                   "flash_attention/simt": 0, **no_bwd("flash_attention")}

    # (a) the CLI, twice
    argv = ["--arch", WHISPER_ARCH, "--batch", str(WHISPER_BATCH),
            "--prompt-len", str(WHISPER_FRAMES), "--new-tokens",
            str(WHISPER_NEW), "--device", "cuda"]
    runs = []
    for i in range(2):
        torch.cuda.synchronize()
        fkernel.reset_counts()                   # --- main path starts
        t0 = time.perf_counter()
        with flash_tally(fkernel) as tally:
            gen, rep = serve.run(argv)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(fkernel.COUNTS)               # --- main path ends
        check_lm_launches(f"whisper_serve CLI run {i + 1}", got,
                          per_prefill, 1)
        check_tally(f"whisper_serve CLI run {i + 1}", tally, L // 2, 0)
        runs.append((gen, rep, got))
        log(f"whisper_serve/cli run {i + 1}: {wall:.2f} s (init "
            f"included); prefill {rep['prefill_ms']:.3f} ms, decode "
            f"{rep['decode_ms_per_token']:.3f} ms a step, "
            f"{rep['tok_per_s']:.1f} tok/s (synchronised host clock); "
            f"launches {got}, by causal flag {tally['fwd']}")
    (gen, _, launches), (gen2, _, _) = runs
    if tuple(gen.shape) != (WHISPER_BATCH, WHISPER_NEW) or \
            not torch.equal(gen, gen2):
        raise AssertionError("whisper_serve: the CLI's two runs differ")
    log(f"whisper_serve/cli: the two runs' {tuple(gen.shape)} tokens are "
        f"bitwise equal; row 0 {gen[0, :8].tolist()}")

    params = api.init_params(prng.PRNGKey(0), cfg, "cuda")
    n_params = sum(p.numel() for p in params.parameters())
    norms = 2 * cfg.d_model * (2 * cfg.n_encoder_layers + 3 * cfg.n_layers
                               + 2)
    if n_params != cfg.n_params() + norms:
        raise AssertionError(f"whisper: {n_params} parameters, "
                             f"n_params() {cfg.n_params()} + {norms}")
    log(f"whisper/model: {cfg.name} {n_params} parameters ({cfg.dtype}) = "
        f"n_params() {cfg.n_params()} + {norms} LayerNorm values")

    # (b) prefill + decode against decode_train; (c) the kernels
    key = prng.PRNGKey(9, device="cuda")
    frames = prng.normal(key, (WHISPER_BATCH, WHISPER_FRAMES,
                               cfg.d_model)).to(cfg.torch_dtype)
    gaps, records = {}, {}
    enc = encdec.encode(params, frames, cfg)
    for S in WHISPER_PROMPTS:
        tok = prng.randint(prng.fold_in(key, S),
                           (WHISPER_BATCH, S + WHISPER_DECODE), 0,
                           cfg.vocab_size).long()
        batch = {"frames": frames, "tokens": tok[:, :S]}
        fkernel.reset_counts()
        with capture_calls({"flash": (fops, "flash_attention")},
                           limit=L) as captured:
            lg, cache = api.prefill_fn(params, batch, cfg)
            torch.cuda.synchronize()
        check_lm_launches(f"whisper prefill S_dec={S}", dict(fkernel.COUNTS),
                          per_prefill, 1)
        hid, _ = encdec.decode_train(params, tok, enc, cfg)
        full = params.unembed(hid)
        gaps[f"prefill S_dec={S}"] = lm_gap(lg, full[:, S - 1:S])
        fkernel.reset_counts()
        st = cache
        for i in range(WHISPER_DECODE):
            dec, st = api.decode_fn(params, tok[:, S + i:S + i + 1], st,
                                    S + i, cfg)
            gaps[f"decode S_dec={S} step {i + 1}"] = lm_gap(
                dec, full[:, S + i:S + i + 1])
        torch.cuda.synchronize()
        check_lm_launches(f"whisper decode S_dec={S}", dict(fkernel.COUNTS),
                          per_prefill, 0)
        if not (torch.isfinite(lg).all() and torch.isfinite(dec).all()):
            raise AssertionError(f"whisper S_dec={S}: logits not finite")
        log(f"whisper/S_dec={S}: prefill logits vs decode_train "
            f"{gaps[f'prefill S_dec={S}']:.4g}, decode steps " + ", ".join(
                f"{gaps[f'decode S_dec={S} step {i + 1}']:.4g}"
                for i in range(WHISPER_DECODE)) +
            f" (max |a-b| / max(1, max |b|); max |logit| "
            f"{full.float().abs().max().item():.3g})")
        if S == WHISPER_PROMPTS[0]:
            zero = api.init_decode_state(cfg, WHISPER_BATCH, WHISPER_FRAMES,
                                         device="cuda")
            forgot = lm_gap(api.decode_fn(params, tok[:, S:S + 1], zero, S,
                                          cfg)[0], full[:, S:S + 1])
            log(f"whisper/control: a decode step from a zero cache vs "
                f"decode_train {forgot:.4g} (must exceed {LM_BF16_RTOL})")
            if not forgot > LM_BF16_RTOL:
                raise AssertionError("whisper: the logit check passed a "
                                     "decode step that forgot the prompt")
        if S == WHISPER_PROMPTS[1]:
            calls = captured["flash"]
            for part, (qkv, kw, out) in (("encoder", calls[0]),
                                         ("decoder", calls[-1])):
                q, k, v = qkv
                causal = part == "decoder"
                if kw != {"causal": causal, "window": 0}:
                    raise AssertionError(f"whisper {part}: attention "
                                         f"called with {kw}")
                ref = attention_ref(q, k, v, causal, 0)
                err = (out.float() - ref.float()).abs().max().item()
                if not torch.allclose(out.float(), ref.float(), **TOL_BF16):
                    raise AssertionError(f"whisper flash {part}: max abs "
                                         f"{err:.3g}")
                qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
                one = fkernel.launch(qc[:1], kc[:1], vc[:1], causal, 0)
                if not torch.equal(one, out[:1]):
                    raise AssertionError(f"whisper flash {part}: rows of "
                                         f"batch 1 != those of batch "
                                         f"{q.shape[0]}")
                ms = time_ms(lambda: fkernel.launch(qc, kc, vc, causal, 0))
                plain = time_ms(lambda: attention_ref(q, k, v, causal, 0),
                                iters=20)
                lib = time_ms(lambda: F.scaled_dot_product_attention(
                    qc, kc, vc, is_causal=causal))
                bnd, by = flash_bound(q, k, causal, 0)
                records[part] = dict(
                    shape=list(q.shape), causal=causal, max_abs_err=err,
                    ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                    library_ms=lib)
                log(f"kernel/flash_attention at whisper's {part} "
                    f"{list(q.shape)} causal {causal}: max abs {err:.3g} "
                    f"(TOL_BF16), rows bitwise; kernel {ms * 1e3:.2f} us "
                    f"plain {plain * 1e3:.2f} us SDPA {lib * 1e3:.2f} us "
                    f"bound {bnd * 1e3:.3f} us ({by})")
        del captured, cache, st, full, hid
    worst = max(gaps.values())
    log(f"whisper/bf16 gaps: worst {worst:.4g} (limit {LM_BF16_RTOL})")
    if not worst <= LM_BF16_RTOL:
        raise AssertionError(f"whisper: a bf16 gap beyond {LM_BF16_RTOL}: "
                             f"{gaps}")

    # prefill and a decode step: wall (events) and device time
    tok = prng.randint(key, (WHISPER_BATCH, 9), 0, cfg.vocab_size).long()
    batch = {"frames": frames, "tokens": tok[:, :8]}
    prefill = lambda: api.prefill_fn(params, batch, cfg)
    pre_ms = time_ms(prefill, iters=5, warmup=1)
    _, cache = prefill()
    step = lambda: api.decode_fn(params, tok[:, 8:9], cache, 8, cfg)
    dec_ms = time_ms(step, iters=20, warmup=2)
    pre = device_ms("whisper_serve/prefill", prefill, n=2, top=8,
                    shares=["flash_wgmma_kernel"], per="prefill")
    dec = device_ms("whisper_serve/decode", step, n=5, top=6,
                    per="decode step")
    idle = lambda dev, wall: "not measured" if dev is None else \
        f"{100 * (1 - dev / wall):.1f}%"
    log(f"whisper_serve/prefill: B={WHISPER_BATCH} frames {WHISPER_FRAMES} "
        f"S_dec 8 wall {pre_ms:.3f} ms (events), device "
        f"{fmt_ms(pre['_ms'])} over {pre['_events']} events, idle "
        f"{idle(pre['_ms'], pre_ms)}; flash "
        f"{fmt_ms(pre['flash_wgmma_kernel'])} over "
        f"{pre['flash_wgmma_kernel/events']} launches")
    log(f"whisper_serve/decode: B={WHISPER_BATCH} a step {dec_ms:.3f} ms "
        f"(events), {WHISPER_BATCH * 1e3 / dec_ms:.1f} tok/s, device "
        f"{fmt_ms(dec['_ms'])} over {dec['_events']} events, idle "
        f"{idle(dec['_ms'], dec_ms)}; card {card}")
    del params, cache, enc, frames
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the backward kernel at the training step's shapes
    g = torch.Generator(device="cuda").manual_seed(22)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    bf16 = torch.bfloat16
    for part, (shape, causal) in (("encoder", WHISPER_FLASH_BWD[0]),
                                  ("decoder", WHISPER_FLASH_BWD[1])):
        gaps_w, err, faults, args, ran = flash_bwd_case(
            rn, shape, causal, 0, bf16, path=True, tag="whisper_train")
        if ran != "wgmma":
            raise AssertionError(f"whisper flash bwd {part}: took {ran}")
        sgaps, _, sfaults, _, _ = flash_bwd_case(
            rn, shape, causal, 0, bf16, path=True, variant="simt",
            inputs=args, tag="whisper_train")
        q, k, v, out, dout, lse = args
        r = dict(shape=list(q.shape), causal=causal, max_abs_err=err,
                 row_gap=max(gaps_w), row_limit=BWD_BF16_ROW, faults=faults,
                 simt_row_gap=max(sgaps), simt_faults=sfaults)
        r["ms"] = time_ms(lambda: fkernel.launch_backward(*args, causal, 0),
                          iters=20, warmup=2)
        r["simt_ms"] = time_ms(lambda: fkernel.launch_backward(
            *args, causal, 0, variant="simt"), iters=5, warmup=1)
        r["plain_ms"] = time_ms(lambda: flash_attention_bwd_ref(
            *args, causal, 0), iters=3, warmup=1)
        with torch.enable_grad():
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
            r["library_ms"] = time_ms(lambda: torch.autograd.grad(
                o, (qg, kg, vg), dout, retain_graph=True), iters=20,
                warmup=2)
        r["bound_ms"], r["bound_by"] = flash_bwd_bound(q, k, causal, 0)
        records[f"bwd_{part}"] = r
        log(f"kernel/flash_attention_bwd at whisper's {part} {r['shape']} "
            f"causal {causal}: wgmma {r['ms']:.4f} ms, simt "
            f"{r['simt_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA "
            f"backward {r['library_ms']:.4f} ms "
            f"({r['ms'] / r['library_ms']:.2f}x), bound {r['bound_ms']:.4f} "
            f"ms ({r['bound_by']}): {100 * r['bound_ms'] / r['ms']:.2f}% of "
            f"the bound's rate; row gap {r['row_gap']:.3g} (simt "
            f"{r['simt_row_gap']:.3g}), least fault "
            f"{min(faults.values()):.3g}")
        del args, q, k, v, out, dout, lse, o, qg, kg, vg
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the train CLI's main, counters read after every step
    per_step = {"flash_attention": L, "flash_attention/wgmma": L,
                "flash_attention/simt": 0, "flash_attention_bwd": L,
                "flash_attention_bwd/wgmma": L,
                "flash_attention_bwd/simt": 0}
    train_launches = dict.fromkeys(per_step, 0)
    walls = []
    tally = {}

    def on_step(i, params, opt, metrics):
        torch.cuda.synchronize()
        got = dict(fkernel.COUNTS)
        check_lm_launches(f"whisper_train step {i}", got, per_step, 1)
        check_tally(f"whisper_train step {i}", tally["now"], L // 2, L // 2)
        for k, v in got.items():
            train_launches[k] += v
        fkernel.reset_counts()
        for d in tally["now"].values():
            d.update({True: 0, False: 0})
        now = time.perf_counter()
        walls.append(now - clock[0])
        clock[0] = now

    argv = ["--arch", WHISPER_ARCH, "--steps", str(WHISPER_TRAIN_STEPS),
            "--batch", str(WHISPER_TRAIN_BATCH), "--seq",
            str(WHISPER_TRAIN_SEQ), "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fkernel.reset_counts()                       # --- main path starts
    clock = [time.perf_counter()]
    t0 = clock[0]
    with flash_tally(fkernel) as tally["now"]:
        losses = train.main(argv, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0              # --- main path ends
    peak = torch.cuda.max_memory_allocated() / 1e9
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    log(f"whisper_train/cli: {' '.join(argv)}: {wall:.2f} s (init "
        f"included); losses {[round(x, 4) for x in losses]}; first-10 mean "
        f"{first:.4f}, last-10 mean {last:.4f}; step wall (host clock, "
        f"synchronised) first {walls[0]:.3f} s (init included), median of "
        f"the rest {sorted(walls[1:])[len(walls[1:]) // 2]:.4f} s; peak "
        f"memory {peak:.2f} GB; launches {train_launches}")
    if len(losses) != WHISPER_TRAIN_STEPS or not all(
            math.isfinite(x) for x in losses) or not first > last:
        raise AssertionError(f"whisper_train: losses not finite or not "
                             f"falling: {losses}")

    key0 = prng.PRNGKey(0, device="cuda")
    params = api.init_params(key0, cfg, "cuda")
    opt = init_opt_state(params)
    step = shapes.make_train_step(cfg, AdamWConfig(
        lr=3e-4, schedule=cosine(WHISPER_TRAIN_STEPS, warmup=1)))
    batch = train.build_batch(prng.fold_in(key0, 0), cfg,
                              WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ)
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: step(params, opt, batch), iters=3, warmup=1)
    step_peak = torch.cuda.max_memory_allocated() / 1e9
    prof = device_ms("whisper_train/step", lambda: step(params, opt, batch),
                     n=2, top=10, shares=["flash_wgmma_kernel", "flash_bwd"],
                     per="step")
    # the card time of a step's 12 launches (6 encoder, 6 decoder)
    records["encoder"]["step_card_ms"] = prof["flash_wgmma_kernel"]
    records["bwd_encoder"]["step_card_ms"] = prof["flash_bwd"]
    records["bwd_encoder"]["step_card_events"] = prof["flash_bwd/events"]
    idle_s = "not measured" if prof["_ms"] is None else \
        f"{100 * (1 - prof['_ms'] / step_ms):.1f}%"
    log(f"whisper_train/step: B={WHISPER_TRAIN_BATCH} frames "
        f"{WHISPER_TRAIN_SEQ} S_dec {cfg.max_decoder_len} wall "
        f"{step_ms:.3f} ms (events), device {fmt_ms(prof['_ms'])} over "
        f"{prof['_events']} events, idle {idle_s}; peak memory "
        f"{step_peak:.2f} GB; flash forward "
        f"{fmt_ms(prof['flash_wgmma_kernel'])} and backward "
        f"{fmt_ms(prof['flash_bwd'])} a step (12 launches each, the "
        f"backward's {prof['flash_bwd/events']} events); card {card}")
    repeat_step_bitwise("whisper_train", step, params, opt, batch)
    del params, opt, step, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (f) the card against the CPU port: 2 + 2 layers, batch 1
    small = dataclasses.replace(cfg, n_layers=WHISPER_CPU_LAYERS,
                                n_encoder_layers=WHISPER_CPU_LAYERS)
    m_card = api.init_params(prng.PRNGKey(0), small, "cuda")
    m_cpu = copy.deepcopy(m_card).to("cpu")
    b1 = train.build_batch(prng.fold_in(key0, 1), small, 1, WHISPER_GRAD_SEQ)
    b2 = train.build_batch(prng.fold_in(key0, 2), small, 1, WHISPER_GRAD_SEQ)
    t0 = time.perf_counter()
    l_card, g_card = shapes.loss_and_grads(m_card, b1, small)
    on_cpu = lambda b: {k: v.cpu() for k, v in b.items()}
    l_cpu, g_cpu = shapes.loss_and_grads(m_cpu, on_cpu(b1), small)
    _, g_other = shapes.loss_and_grads(m_cpu, on_cpu(b2), small)
    cpu_s = time.perf_counter() - t0
    loss_gap = abs(l_card.item() - l_cpu.item()) / abs(l_cpu.item())
    ggaps = grad_gaps(g_card, g_cpu)
    control = grad_gaps(g_card, g_other)
    worst = max(ggaps, key=ggaps.get)
    median = lambda d: sorted(d.values())[len(d) // 2]
    log(f"whisper_train/card_vs_cpu ({WHISPER_CPU_LAYERS} + "
        f"{WHISPER_CPU_LAYERS} layers, B=1, frames and S_dec "
        f"{WHISPER_GRAD_SEQ}, {cpu_s:.1f} s): loss card {l_card.item():.6f} "
        f"cpu {l_cpu.item():.6f} (rel {loss_gap:.3g}, limit "
        f"{LM_LOSS_RTOL}); gradient leaves ‖card − cpu‖ / ‖cpu‖: median "
        f"{median(ggaps):.4g}, worst {ggaps[worst]:.4g} ({worst}), limit "
        f"{LM_GRAD_RTOL}; control (another batch's cpu gradients): median "
        f"{median(control):.4g}, least {min(control.values()):.4g}")
    if not (loss_gap <= LM_LOSS_RTOL and ggaps[worst] <= LM_GRAD_RTOL):
        raise AssertionError(f"whisper_train: card vs cpu beyond the "
                             f"limits: loss {loss_gap:.3g}, {worst} "
                             f"{ggaps[worst]:.3g}")
    if not median(control) > LM_GRAD_RTOL:
        raise AssertionError("whisper_train: the gradient check passed "
                             "another batch's gradients")
    del m_card, m_cpu, g_card, g_cpu, g_other
    gc.collect()
    torch.cuda.empty_cache()
    log(f"whisper/phase_s: {time.perf_counter() - t_phase:.1f}; card {card}")
    return records, launches, train_launches


def partition_tensors(model, opt) -> dict:
    """{name: tensor} of a model's parameters and AdamW moments, each
    ``DTensor`` as its local part."""
    from torch.distributed.tensor import DTensor
    local = lambda t: t.to_local() if isinstance(t, DTensor) else t
    out = {f"p/{n}": local(p) for n, p in model.named_parameters()}
    for w in ("m", "v"):
        out.update({f"{w}/{n}": local(t) for n, t in opt[w].items()})
    return out


def phase_dense_partition():
    """The partitioned dense path (sharding/specs.py ``shard_params`` /
    ``shard_batch``, models/transformer.py ``constrain``): Zamba2-1.2B
    (LM_ARCH) at full width in bf16, LM_TRAIN_BATCH x LM_TRAIN_SEQ
    tokens, on a one-rank NCCL ("data", "model") (1, 1) mesh
    (``make_debug_mesh``), against the unpartitioned path from the same
    weights (a copy of the model): (a) ``loss_and_grads``: the loss and
    every gradient bitwise, each gradient placed as its parameter; (b)
    the prefill logits bitwise; (c) one AdamW step (``make_train_step``):
    the loss, the grad norm, every parameter and both moments bitwise;
    the flash and SSD launches of (a)-(c), forward and backward and by
    variant, counted from zero just before each way and equal; (d) the
    training step's wall (events), device time (profiler), idle share and
    peak memory, each way.  Returns the partitioned path's launches."""
    import copy
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_arch
    from repro_torch.core import prng
    from repro_torch.device import deterministic_cuda
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.ssd_scan import kernel as skernel
    from repro_torch.launch import shapes, train
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import api
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.sharding import specs

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    deterministic_cuda()
    card = card_line()
    if dist.is_initialized():
        raise AssertionError("dense_partition: a process group is left "
                             "over from an earlier phase")
    kmods = (fkernel, skernel)
    cfg = get_arch(LM_ARCH)
    key = prng.PRNGKey(0, device="cuda")
    model = api.init_params(key, cfg, "cuda")
    placed = copy.deepcopy(model)
    batch = train.build_batch(prng.fold_in(key, 0), cfg, LM_TRAIN_BATCH,
                              LM_TRAIN_SEQ)
    mesh = make_debug_mesh(device="cuda")
    try:
        if (dist.get_backend(), mesh.mesh_dim_names, mesh.size()) != \
                ("nccl", ("data", "model"), 1):
            raise AssertionError(f"dense_partition: mesh {mesh}")
        specs.shard_params(placed, mesh)
        pbatch = specs.shard_batch(mesh, batch)
        rt = shapes.make_runtime(mesh)
        step = shapes.make_train_step(cfg)
        step_rt = shapes.make_train_step(cfg, runtime=rt)
        ways = {"plain": (model, batch, shapes.CPU, step),
                "partitioned": (placed, pbatch, rt, step_rt)}
        out, launches, walls = {}, {}, {}
        for way, (m, b, r, st) in ways.items():
            for kmod in kmods:                   # --- main path starts
                kmod.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = shapes.loss_and_grads(m, b, cfg, r)
            logits, _ = api.prefill_fn(m, b, cfg, r)
            opt = init_opt_state(m)
            _, _, metrics = st(m, opt, b)
            torch.cuda.synchronize()
            walls[way] = time.perf_counter() - t0
            launches[way] = lm_counts(*kmods)    # --- main path ends
            out[way] = (loss, grads, logits, metrics, opt)
        (l0, g0, p0, m0, o0), (l1, g1, p1, m1, o1) = out.values()
        params = dict(placed.named_parameters())
        bad = [n for n, g in g1.items()
               if g.placements != params[n].placements or
               not torch.equal(g.to_local(), g0[n])]
        if not torch.equal(l0, l1) or bad:
            raise AssertionError(f"dense_partition: loss {l0.item()!r} vs "
                                 f"{l1.item()!r}; gradients differ: "
                                 f"{bad[:5]} ({len(bad)})")
        if not torch.equal(p1.to_local(), p0):
            raise AssertionError("dense_partition: prefill logits differ")
        ta, tb = partition_tensors(model, o0), partition_tensors(placed, o1)
        bad = [n for n in ta if not torch.equal(ta[n], tb[n])]
        if bad or not (torch.equal(m0["loss"], m1["loss"]) and
                       torch.equal(m0["grad_norm"], m1["grad_norm"])):
            raise AssertionError(f"dense_partition: the AdamW step differs: "
                                 f"{bad[:5]} ({len(bad)})")
        if launches["plain"] != launches["partitioned"] or \
                launches["plain"]["ssd_scan_bwd"] == 0 or \
                launches["plain"]["flash_attention_bwd"] == 0:
            raise AssertionError(f"dense_partition: launches {launches}")
        log(f"dense_partition/bitwise: {LM_ARCH} B={LM_TRAIN_BATCH} "
            f"S={LM_TRAIN_SEQ} on a (1, 1) NCCL mesh: loss {l1.item()!r}, "
            f"{len(g1)} gradients, prefill logits {tuple(p1.shape)}, one "
            f"AdamW step (grad norm {m1['grad_norm'].item()!r}, "
            f"{len(ta)} parameters and moments) bitwise the unpartitioned "
            f"path; launches each way {launches['partitioned']}; wall of "
            f"(a)-(c) plain {walls['plain']:.2f} s, partitioned "
            f"{walls['partitioned']:.2f} s (first calls included)")
        del out, g0, g1, grads, logits, ta, tb
        for way, (m, b, r, st) in ways.items():
            opt = o0 if way == "plain" else o1
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: st(m, opt, b), iters=2, warmup=1)
            peak = torch.cuda.max_memory_allocated() / 1e9
            prof = device_ms(f"dense_partition/{way}", lambda: st(m, opt, b),
                             n=1, per="step")
            idle = "not measured" if prof["_ms"] is None else \
                f"{100 * (1 - prof['_ms'] / ms):.1f}%"
            log(f"dense_partition/step_{way}: wall {ms:.3f} ms (events), "
                f"device {fmt_ms(prof['_ms'])} over {prof['_events']} "
                f"events, idle {idle}; peak memory {peak:.2f} GB; card "
                f"{card}")
    finally:
        dist.destroy_process_group()
    del model, placed, ways, o0, o1
    gc.collect()
    torch.cuda.empty_cache()
    log(f"dense_partition/phase_s: {time.perf_counter() - t_phase:.1f}; "
        f"card {card}")
    return launches["partitioned"]


# the partitioned decode path: LM_ARCH at full width in bf16, a prefill of
# DECODE_PART_BATCH x DECODE_PART_PROMPT tokens, then DECODE_PART_STEPS
# greedy steps, in the inference layout on a one-rank (1, 1) mesh
DECODE_PART_BATCH, DECODE_PART_PROMPT, DECODE_PART_STEPS = 4, 1024, 32
# the partitioned MoE path: MOE_ARCH at MOE_LAYERS blocks, the
# expert-parallel step at MOE_TRAIN_BATCH x MOE_TRAIN_SEQ, then a prefill
# of MOE_PART_PROMPT tokens and MOE_PART_STEPS greedy moe_ep2d steps; the
# AdamW step on the reduced config (the full width's float32 moments,
# 62 GB, do not fit beside its weights and gradients: PERF.md section 4)
MOE_PART_PROMPT, MOE_PART_STEPS = 128, 8


def placed_whole(t):
    """A tensor whole: a ``DTensor`` gathered, anything else itself."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def greedy_decode(model, cfg, tokens, steps: int, prefill_rt, decode_rt,
                  mesh=None):
    """``api.prefill_fn`` on ``tokens`` (B, S) with a cache of S + steps
    slots, then ``steps`` greedy ``api.decode_fn`` steps; with ``mesh``
    the tokens placed by the batch (the model placed by the caller).
    Returns (every step's logits, whole; the final state; the last step's
    (token, state, position))."""
    from repro_torch.models import api
    from repro_torch.sharding import specs
    B, S = tokens.shape
    place = (lambda t: t) if mesh is None else \
        (lambda t: specs.place(mesh, t, specs.batch_spec_for(mesh, B, 1)))
    logits, state = api.prefill_fn(model, {"tokens": place(tokens)}, cfg,
                                   prefill_rt, cache_len=S + steps)
    out = [placed_whole(logits)]
    for i in range(steps):
        token = place(out[-1].argmax(-1))
        last = (token, state, S + i)
        logits, state = api.decode_fn(model, token, state, S + i, cfg,
                                      decode_rt)
        out.append(placed_whole(logits))
    return out, state, last


def decode_bitwise(tag: str, a, b) -> None:
    """Two ``greedy_decode`` results: every step's logits and every leaf
    of the final state bitwise, the second's state placed."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch import bridge
    (la, sa, _), (lb, sb, _) = a, b
    steps = [i for i, (x, y) in enumerate(zip(la, lb, strict=True))
             if not torch.equal(x, y)]
    ta, tb = bridge.leaves(sa), bridge.leaves(sb)
    if len(ta) != len(tb) or not all(isinstance(t, DTensor) for t in tb):
        raise AssertionError(f"{tag}: the state is not placed")
    bad = [i for i, (x, y) in enumerate(zip(ta, tb))
           if not torch.equal(x, placed_whole(y))]
    if steps or bad:
        raise AssertionError(f"{tag}: logits differ at steps {steps}; "
                             f"state leaves differ: {bad[:5]} ({len(bad)})")


def step_timing(tag: str, fn, per: str, card: str, iters: int) -> dict:
    """One call's wall (CUDA events over ``iters`` calls after one),
    device time (profiler) and idle share, logged."""
    ms = time_ms(fn, iters=iters, warmup=1)
    prof = device_ms(tag, fn, n=1, per=per)
    idle = "not measured" if prof["_ms"] is None else \
        f"{100 * (1 - prof['_ms'] / ms):.1f}%"
    log(f"{tag}: wall {ms:.3f} ms (events) a {per}, device "
        f"{fmt_ms(prof['_ms'])} over {prof['_events']} events, idle {idle}; "
        f"card {card}")
    return {"wall_ms": ms, "device_ms": prof["_ms"]}


def phase_decode_partition():
    """Decode under the inference layout (sharding/specs.py
    ``shard_params(inference=True)``, the prefill's state laid out by
    ``shard_decode_state``): Zamba2-1.2B (LM_ARCH) at full width in bf16
    on a one-rank NCCL ("data", "model") (1, 1) mesh, against the
    unpartitioned path from the same weights (a copy of the model): a
    prefill of DECODE_PART_BATCH x DECODE_PART_PROMPT tokens and
    DECODE_PART_STEPS greedy steps, every step's logits and the final
    state bitwise; the flash and SSD launches (the prefill's; decode runs
    none) counted from zero just before each way and equal; each way's
    decode-step wall (events), device time, idle share and the peak
    memory of its run.  Returns the partitioned path's launches."""
    import copy
    import torch
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.configs.base import get_arch
    from repro_torch.core import prng
    from repro_torch.device import deterministic_cuda
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.ssd_scan import kernel as skernel
    from repro_torch.launch import shapes, train
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import api
    from repro_torch.sharding import specs

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    deterministic_cuda()
    card = card_line()
    if dist.is_initialized():
        raise AssertionError("decode_partition: a process group is left "
                             "over from an earlier phase")
    kmods = (fkernel, skernel)
    cfg = get_arch(LM_ARCH)
    key = prng.PRNGKey(0, device="cuda")
    model = api.init_params(key, cfg, "cuda")
    placed = copy.deepcopy(model)
    tokens = train.build_batch(prng.fold_in(key, 1), cfg, DECODE_PART_BATCH,
                               DECODE_PART_PROMPT)["tokens"]
    mesh = make_debug_mesh(device="cuda")
    try:
        if (dist.get_backend(), mesh.mesh_dim_names, mesh.size()) != \
                ("nccl", ("data", "model"), 1):
            raise AssertionError(f"decode_partition: mesh {mesh}")
        specs.shard_params(placed, mesh, inference=True)
        ways = {"plain": (model, shapes.CPU, shapes.CPU, None),
                "partitioned": (placed,
                                shapes.runtime_for(cfg, "prefill_32k", mesh),
                                shapes.runtime_for(cfg, "decode_32k", mesh),
                                mesh)}
        out, launches, walls, peaks = {}, {}, {}, {}
        for way, (m, rp, rd, on) in ways.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for kmod in kmods:                   # --- main path starts
                kmod.reset_counts()
            t0 = time.perf_counter()
            out[way] = greedy_decode(m, cfg, tokens, DECODE_PART_STEPS, rp,
                                     rd, on)
            torch.cuda.synchronize()
            walls[way] = time.perf_counter() - t0
            launches[way] = lm_counts(*kmods)    # --- main path ends
            peaks[way] = torch.cuda.max_memory_allocated() / 1e9
        decode_bitwise("decode_partition", out["plain"], out["partitioned"])
        if launches["plain"] != launches["partitioned"] or \
                launches["plain"]["flash_attention"] == 0 or \
                launches["plain"]["ssd_scan"] == 0:
            raise AssertionError(f"decode_partition: launches {launches}")
        log(f"decode_partition/bitwise: {LM_ARCH} B={DECODE_PART_BATCH} "
            f"prompt {DECODE_PART_PROMPT} + {DECODE_PART_STEPS} greedy steps "
            f"on a (1, 1) NCCL mesh in the inference layout: every step's "
            f"logits and {len(bridge.leaves(out['plain'][1]))} state "
            f"tensors bitwise the unpartitioned path; launches each way "
            f"{launches['partitioned']}; wall of the run plain "
            f"{walls['plain']:.2f} s, partitioned {walls['partitioned']:.2f}"
            f" s; peak memory {peaks['plain']:.2f} / "
            f"{peaks['partitioned']:.2f} GB")
        for way, (m, _, rd, _) in ways.items():
            token, state, pos = out[way][2]
            step_timing(f"decode_partition/step_{way}",
                        lambda: api.decode_fn(m, token, state, pos, cfg, rd),
                        "decode step", card, iters=3)
    finally:
        dist.destroy_process_group()
    del model, placed, ways, out
    gc.collect()
    torch.cuda.empty_cache()
    log(f"decode_partition/phase_s: {time.perf_counter() - t_phase:.1f}; "
        f"card {card}")
    return launches["partitioned"]


def unplace(model) -> None:
    """A module laid out on a one-rank mesh back to plain parameters, in
    place: each ``DTensor``'s local part is its whole tensor there."""
    import torch.nn as nn
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        model.get_submodule(owner)._parameters[leaf] = nn.Parameter(
            p.to_local().detach(), requires_grad=p.requires_grad)


def phase_moe_partition():
    """The MoE architecture partitioned (models/moe.py ``moe_ep`` /
    ``moe_ep2d`` on experts placed by ``shard_params``, the rest by the
    dense rules): DBRX-132B (MOE_ARCH) at its published widths and
    MOE_LAYERS blocks, bf16, on a one-rank NCCL (1, 1) mesh, against
    today's expert-parallel path on whole parameters (the same module,
    placed in place: on one rank a local part is the whole tensor, so no
    weight is copied).  Each way, counted from zero just before it: a
    prefill of MOE_PART_PROMPT tokens and MOE_PART_STEPS greedy
    ``moe_ep2d`` steps (the inference layout), then the expert-parallel
    ``loss_and_grads`` at MOE_TRAIN_BATCH x MOE_TRAIN_SEQ (the training
    layout); every logit, the final state, the loss and every gradient
    bitwise, the grouped matmul's and flash's launches (forward and
    backward) equal.  Each way's step and decode-step wall, device time
    and idle share.  Then the AdamW step (``make_train_step``) on the
    reduced config, placed against whole, bitwise.  Returns the
    partitioned path's launches."""
    import copy
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.core import prng
    from repro_torch.device import deterministic_cuda
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.grouped_matmul import kernel as gkernel
    from repro_torch.launch import shapes, train
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import api
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.sharding import specs

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    deterministic_cuda()
    card = card_line()
    if dist.is_initialized():
        raise AssertionError("moe_partition: a process group is left over "
                             "from an earlier phase")
    kmods = (gkernel, fkernel)
    arch = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_LAYERS)
    key = prng.PRNGKey(0, device="cuda")
    mesh = make_debug_mesh(device="cuda")
    try:
        lm = api.init_params(key, arch, "cuda")
        batch = train.build_batch(prng.fold_in(key, 0), arch,
                                  MOE_TRAIN_BATCH, MOE_TRAIN_SEQ)
        prompt = batch["tokens"][:, :MOE_PART_PROMPT]
        rt_ep = shapes.make_runtime(mesh)
        rt_p = shapes.runtime_for(arch, "prefill_32k", mesh)
        rt_d = shapes.runtime_for(arch, "decode_32k", mesh)
        dec, launches, times, grads = {}, {}, {}, {}
        for way in ("plain", "partitioned"):
            placed = way == "partitioned"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for kmod in kmods:                   # --- main path starts
                kmod.reset_counts()
            if placed:
                specs.shard_params(lm, mesh, inference=True)
            dec[way] = greedy_decode(lm, arch, prompt, MOE_PART_STEPS, rt_p,
                                     rt_d, mesh if placed else None)
            if placed:
                unplace(lm)
                specs.shard_params(lm, mesh)
            b = specs.shard_batch(mesh, batch) if placed else batch
            grads[way] = shapes.loss_and_grads(lm, b, arch, rt_ep)
            torch.cuda.synchronize()
            launches[way] = lm_counts(*kmods)    # --- main path ends
            peak = torch.cuda.max_memory_allocated() / 1e9
            if placed:
                (l0, g0), (l1, g1) = grads.pop("plain"), grads.pop(way)
                params = dict(lm.named_parameters())
                bad = [n for n, g in g1.items()
                       if g.placements != params[n].placements or
                       not torch.equal(g.to_local(), g0[n])]
                if not torch.equal(l0, l1) or bad:
                    raise AssertionError(
                        f"moe_partition: loss {l0.item()!r} vs "
                        f"{l1.item()!r}; gradients differ: {bad[:5]} "
                        f"({len(bad)})")
                n_grads, loss = len(g1), l1.item()
                del g0, g1
            token, state, pos = dec[way][2]
            times[way] = (
                step_timing(f"moe_partition/step_{way}",
                            lambda: shapes.loss_and_grads(lm, b, arch,
                                                          rt_ep),
                            "step", card, iters=2),
                peak)
            if placed:
                unplace(lm)
                specs.shard_params(lm, mesh, inference=True)
            step_timing(f"moe_partition/decode_{way}",
                        lambda: api.decode_fn(lm, token, state, pos, arch,
                                              rt_d), "decode step", card,
                        iters=3)
        decode_bitwise("moe_partition", dec["plain"], dec["partitioned"])
        want = {"grouped_matmul_bwd": 3 * MOE_LAYERS,
                "flash_attention_bwd": MOE_LAYERS}
        if launches["plain"] != launches["partitioned"] or any(
                launches["plain"][k] != n for k, n in want.items()):
            raise AssertionError(f"moe_partition: launches {launches}")
        log(f"moe_partition/bitwise: {MOE_ARCH} ({MOE_LAYERS} blocks, bf16) "
            f"on a (1, 1) NCCL mesh: prompt {MOE_PART_PROMPT} + "
            f"{MOE_PART_STEPS} moe_ep2d steps (inference layout), every "
            f"logit and the final state; the moe_ep loss_and_grads at "
            f"B={MOE_TRAIN_BATCH} S={MOE_TRAIN_SEQ} (training layout), the "
            f"loss {loss!r} and {n_grads} gradients, each placed "
            f"as its parameter, bitwise today's expert-parallel path; "
            f"launches each way {launches['partitioned']}; peak memory "
            f"{times['plain'][1]:.2f} / {times['partitioned'][1]:.2f} GB")
        del lm, batch, dec
        gc.collect()
        torch.cuda.empty_cache()
        # the AdamW step, on the reduced config
        small = reduced(get_arch(MOE_ARCH))
        whole_m = api.init_params(prng.PRNGKey(0), small, "cuda")
        placed_m = specs.shard_params(copy.deepcopy(whole_m), mesh)
        b = train.build_batch(prng.fold_in(key, 2), small, 2, MOE_GRAD_SEQ)
        step = shapes.make_train_step(small, runtime=rt_ep)
        o0, o1 = init_opt_state(whole_m), init_opt_state(placed_m)
        _, _, m0 = step(whole_m, o0, b)
        _, _, m1 = step(placed_m, o1, specs.shard_batch(mesh, b))
        ta, tb = partition_tensors(whole_m, o0), partition_tensors(placed_m,
                                                                   o1)
        bad = [n for n in ta if not torch.equal(ta[n], tb[n])]
        if bad or not (torch.equal(m0["loss"], m1["loss"]) and
                       torch.equal(m0["grad_norm"], m1["grad_norm"])):
            raise AssertionError(f"moe_partition: the reduced AdamW step "
                                 f"differs: {bad[:5]} ({len(bad)})")
        log(f"moe_partition/adamw: reduced {MOE_ARCH} (float32), B=2 "
            f"S={MOE_GRAD_SEQ}, one make_train_step placed against whole: "
            f"loss {m1['loss'].item()!r}, grad norm "
            f"{m1['grad_norm'].item()!r}, {len(ta)} parameters and moments "
            f"bitwise")
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"moe_partition/phase_s: {time.perf_counter() - t_phase:.1f}; "
        f"card {card}")
    return launches["partitioned"]


EXAMPLES = ("torch_quickstart", "torch_cutpoint_sweep", "torch_dit_backbone",
            "torch_train_lm")
# what each example's run() returns that must be finite
EXAMPLE_OUTPUTS = {
    "torch_quickstart": lambda o: [o["samples"], o["handoff"]],
    "torch_cutpoint_sweep": lambda o: [
        __import__("torch").tensor([r["fd_sample"] for r in o])],
    "torch_dit_backbone": lambda o: [o["samples"]],
    "torch_train_lm": lambda o: [__import__("torch").tensor(o["losses"])]}
# the dry run's card check: zamba2-1.2b at full width, one sequence of
# 1,024 tokens, on a one-device mesh (no process group: sizes alone)
META_CHECK_ARCH = "zamba2-1.2b"
META_CHECK_SHAPE = ("meta_check", 1024, 1, "train")
META_BYTES_RTOL = 0.01
# and the same step partitioned (``partition_meta_check``) on a one-rank
# (1, 1) mesh, at two sequences: DTensor cannot view a batch dim of one
# cut over the size-one "data" axis away
META_PARTITION_SHAPE = ("meta_check", 1024, 2, "train")
# and one Alg.-1 step of the collab dry run's U-Net (image size, batch, T,
# cut): the paper's 32 x 32 images, the cut of phase 7
META_CHECK_UNET = (32, 16, 1000, 250)
COLLAB_DRYRUN_ARGS = ["--image-size", "16", "--batch", "16", "--T", "10",
                      "--t-cut", "2"]


def start_dryrun(timeout: float = 600.0) -> dict:
    """Start the dry runs, both at once, each in a process of its own on
    the CPU with no card visible: launch/dryrun.py ``--all`` on the
    single-pod fake mesh and launch/collab_dryrun.py at
    COLLAB_DRYRUN_ARGS.  They run beside the card check of the meta route
    (``main``), which times nothing the records read; ``phase_dryrun``
    waits for them and checks them.  Returns the runs' state: each
    process, the thread that waits for it, and each finished run's
    (output, exit code, wall)."""
    import os
    import threading
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    state = {"procs": {}, "threads": [], "outs": {}}

    def wait(name, proc, t0):
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        state["outs"][name] = (out, proc.returncode,
                               time.perf_counter() - t0)

    for name, argv in (("dryrun", ["--all"]),
                       ("collab_dryrun", COLLAB_DRYRUN_ARGS)):
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", f"repro_torch.launch.{name}", *argv],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        state["procs"][name] = proc
        state["threads"].append(threading.Thread(
            target=wait, args=(name, proc, t0), daemon=True))
        state["threads"][-1].start()
    return state


def stop_dryrun(state: dict) -> None:
    """Kill the dry runs still running (the phase beside them failed)."""
    for proc in state["procs"].values():
        if proc.poll() is None:
            proc.kill()
    for thread in state["threads"]:
        thread.join()


def phase_dryrun(state: dict) -> dict:
    """The dry runs ``start_dryrun`` started, waited for (their output in
    experiments/dryrun_torch/<name>.log, beside the records): under
    ``--all`` every pair that ``skip_reason`` runs must come out OK,
    partitioned by ``DTensor``, and every other SKIP with that reason;
    collab_dryrun must write its six programs.  Returns their walls and
    counts."""
    import torch  # noqa: F401  (the package's configs need it)
    from repro_torch.configs.base import ARCH_IDS, SHAPES, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import skip_reason
    for thread in state["threads"]:
        thread.join()
    out_dir = ROOT / dryrun.OUT_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    outs = {}
    for name in ("dryrun", "collab_dryrun"):
        if name not in state["outs"]:
            raise AssertionError(f"dryrun/{name}: did not run")
        out, rc, wall = state["outs"][name]
        outs[name] = (out, wall)
        (out_dir / f"{name}.log").write_text(out)
        log(f"dryrun/{name}: rc {rc}, wall {wall:.1f} s (the two dry runs "
            "at once, beside the meta check)")
        if rc != 0:
            log(out[-4000:])
            raise AssertionError(f"dryrun/{name}: exit {rc}")
    lines = outs["dryrun"][0].splitlines()
    n_ok = n_skip = 0
    for a in ARCH_IDS:
        cfg = get_arch(a)
        for sname, shape in SHAPES.items():
            tag = f"{cfg.name}__{sname}__{dryrun.mesh_tag(False)}"
            reason = skip_reason(cfg, shape)
            want = f"OK   {tag}:" if reason is None else \
                f"SKIP {tag}: {reason}"
            if not any(line.startswith(want) for line in lines):
                raise AssertionError(f"dryrun: no line {want!r}")
            n_ok, n_skip = n_ok + (reason is None), n_skip + (
                reason is not None)
            if reason is None:
                part = json.loads((out_dir / f"{tag}.json").read_text())[
                    "partitioner"]
                if part != "dtensor":
                    raise AssertionError(f"dryrun: {tag} partitioner {part}")
    rec = json.loads(Path(ROOT / dryrun.OUT_DIR /
                          "granite-8b__train_4k__pod16x16.json").read_text())
    log(f"dryrun/pairs: {n_ok} ok, {n_skip} skipped with the reference's "
        f"reasons; granite-8b train_4k: flops {rec['flops']:.6g}, "
        f"bytes/device {rec['bytes_per_device']['total']}, saved/device "
        f"{rec['saved_activation_bytes']['per_device']}, trace "
        f"{rec['trace_s']} s")
    for line in lines:
        if line.startswith("OK"):
            log(f"  {line}")
    collab = json.loads(Path(ROOT / dryrun.OUT_DIR /
                             "collafuse_unet__pod16x16.json").read_text())
    progs = collab["results"]
    if set(progs) != {"collab_train_step", "server_denoise",
                      "vectorized_round", "ragged_round", "train_runtime",
                      "vectorized_sample"}:
        raise AssertionError(f"collab_dryrun: programs {sorted(progs)}")
    for name, r in progs.items():
        log(f"collab_dryrun/{name}: flops {r['flops']:.6g} bytes/device "
            f"{r['bytes_per_device']['total']} saved "
            f"{r['saved_activation_bytes']} trace {r['trace_s']} s")
    return {"pairs_ok": n_ok, "pairs_skip": n_skip,
            "dryrun_wall_s": outs["dryrun"][1],
            "collab_dryrun_wall_s": outs["collab_dryrun"][1]}


def phase_meta_check() -> dict:
    """The dry run's reckoning (``dryrun.reckon``) held against the card
    for META_CHECK_ARCH at full width and META_CHECK_SHAPE on a one-device
    mesh: (1) the parameter and AdamW bytes the card allocates within
    META_BYTES_RTOL of the reckoned bytes; (2) the saved-tensor bytes of
    one training step (activations and parameters) equal to the meta
    count; (3) ``FlopCounterMode``'s total plus the kernels' counts
    (``kernels.FLOPS``) equal to the meta FLOPs; then (2) and (3) for one
    Alg.-1 step of the collab dry run's U-Net at META_CHECK_UNET
    (``unet_meta_check``)."""
    import types
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import kernels
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core import prng
    from repro_torch.data.tokens import lm_batch
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import make_train_step
    from repro_torch.models import api
    from repro_torch.optim.adamw import init_opt_state
    t0 = time.perf_counter()
    cfg = get_arch(META_CHECK_ARCH)
    shape = ShapeConfig(*META_CHECK_SHAPE)
    one = types.SimpleNamespace(shape={"data": 1, "model": 1})
    meta = dryrun.reckon(cfg, shape, one)
    meta_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    key = prng.PRNGKey(0, device="cuda")
    params = api.init_params(key, cfg, "cuda")
    opt = init_opt_state(params)
    card_bytes = torch.cuda.memory_allocated() - before
    b = lm_batch(prng.fold_in(key, 0), shape.global_batch, shape.seq_len,
                 cfg.vocab_size)
    batch = {k: v.int() for k, v in b.items()}       # the meta's int32
    step = make_train_step(cfg)
    step(params, opt, batch)                          # warm: builds, maps
    torch.cuda.synchronize()
    kernels.reset_flops()
    with FlopCounterMode(display=False) as fc, \
            dryrun.SavedBytes() as saved, torch.no_grad():
        step(params, opt, batch)
    torch.cuda.synchronize()
    card_flops = fc.get_total_flops() + kernels.total_flops()
    reckoned = meta["bytes_per_device"]["params"] + \
        meta["bytes_per_device"]["opt_state"]
    gap = abs(card_bytes - reckoned) / reckoned
    rec = dict(arch=cfg.name, shape=list(META_CHECK_SHAPE[1:3]),
               card_param_opt_bytes=card_bytes,
               meta_param_opt_bytes=reckoned, bytes_gap=gap,
               card_saved=[saved.activation_bytes, saved.param_bytes],
               meta_saved=[meta["saved_activation_bytes"]["per_device"],
                           meta["saved_param_bytes"]],
               card_flops=card_flops, card_aten_flops=fc.get_total_flops(),
               card_kernel_flops=dict(kernels.FLOPS), meta_flops=meta["flops"],
               meta_kernel_flops=meta["kernel_flops"],
               meta_trace_s=meta["trace_s"], meta_s=meta_s,
               phase_s=time.perf_counter() - t0)
    log(f"meta_check/{cfg.name} B{shape.global_batch} x S{shape.seq_len}: "
        f"params + AdamW card {card_bytes} B vs reckoned {reckoned} B (gap "
        f"{gap:.3g}, limit {META_BYTES_RTOL}); saved activations card "
        f"{saved.activation_bytes} meta {rec['meta_saved'][0]}, saved "
        f"parameters card {saved.param_bytes} meta {rec['meta_saved'][1]}; "
        f"flops card {card_flops} (aten {fc.get_total_flops()}) meta "
        f"{meta['flops']} (aten {meta['aten_flops']}); reckoning "
        f"{meta_s:.1f} s")
    log(f"meta_check/kernel_flops: card {dict(kernels.FLOPS)} meta "
        f"{meta['kernel_flops']}")
    if gap > META_BYTES_RTOL:
        raise AssertionError(f"meta_check: parameter and AdamW bytes off by "
                             f"{gap:.3g}")
    if rec["card_saved"] != rec["meta_saved"]:
        raise AssertionError(f"meta_check: saved bytes card "
                             f"{rec['card_saved']} != meta "
                             f"{rec['meta_saved']}")
    if card_flops != meta["flops"]:
        raise AssertionError(f"meta_check: flops card {card_flops} != meta "
                             f"{meta['flops']}")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    rec["partitioned"] = partition_meta_check()
    rec["unet"] = unet_meta_check()
    rec["phase_s"] = time.perf_counter() - t0
    return rec


def partition_meta_check() -> dict:
    """The partitioned training step of META_CHECK_ARCH at
    META_PARTITION_SHAPE: ``dryrun.reckon`` over a fake (1, 1) mesh
    (``make_fake_mesh``; meta ``DTensor`` operands, ``"partitioner":
    "dtensor"``), then the same step on the card on a one-rank NCCL (1,
    1) mesh (``shard_params`` / ``shard_batch``): saved-tensor bytes
    (activations and parameters) and FLOPs (``FlopCounterMode`` plus
    ``kernels.FLOPS``) equal."""
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import kernels
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core import prng
    from repro_torch.data.tokens import lm_batch
    from repro_torch.launch import dryrun, shapes
    from repro_torch.launch.mesh import make_debug_mesh, make_fake_mesh
    from repro_torch.models import api
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.sharding import specs
    t0 = time.perf_counter()
    cfg = get_arch(META_CHECK_ARCH)
    shape = ShapeConfig(*META_PARTITION_SHAPE)
    fake = make_fake_mesh((1, 1))
    try:
        meta = dryrun.reckon(cfg, shape, fake)
    finally:
        dist.destroy_process_group()
    meta_s = time.perf_counter() - t0
    if meta["partitioner"] != "dtensor":
        raise AssertionError(f"meta_check/partitioned: {meta['partitioner']}")
    key = prng.PRNGKey(0, device="cuda")
    b = lm_batch(prng.fold_in(key, 0), shape.global_batch, shape.seq_len,
                 cfg.vocab_size)
    mesh = make_debug_mesh(device="cuda")
    try:
        params = specs.shard_params(api.init_params(key, cfg, "cuda"), mesh)
        opt = init_opt_state(params)
        batch = specs.shard_batch(mesh, {k: v.int() for k, v in b.items()})
        step = shapes.make_train_step(cfg, runtime=shapes.make_runtime(mesh))
        step(params, opt, batch)                      # warm
        torch.cuda.synchronize()
        kernels.reset_flops()
        with FlopCounterMode(display=False) as fc, \
                dryrun.SavedBytes() as saved, torch.no_grad():
            step(params, opt, batch)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    rec = dict(shape=list(META_PARTITION_SHAPE[1:3]),
               card_saved=[saved.activation_bytes, saved.param_bytes],
               meta_saved=[meta["saved_activation_bytes"]["per_device"],
                           meta["saved_param_bytes"]],
               card_flops=fc.get_total_flops() + kernels.total_flops(),
               meta_flops=meta["flops"], meta_trace_s=meta["trace_s"],
               meta_s=meta_s, check_s=time.perf_counter() - t0)
    log(f"meta_check/partitioned {cfg.name} B{shape.global_batch} x "
        f"S{shape.seq_len} on (1, 1): saved activations card "
        f"{rec['card_saved'][0]} meta {rec['meta_saved'][0]}, saved "
        f"parameters card {rec['card_saved'][1]} meta "
        f"{rec['meta_saved'][1]}; flops card {rec['card_flops']} meta "
        f"{rec['meta_flops']}; census {meta['collectives']}; reckoning "
        f"{meta_s:.1f} s, check {rec['check_s']:.1f} s")
    if rec["card_saved"] != rec["meta_saved"]:
        raise AssertionError(f"meta_check/partitioned: saved bytes card "
                             f"{rec['card_saved']} != meta "
                             f"{rec['meta_saved']}")
    if rec["card_flops"] != rec["meta_flops"]:
        raise AssertionError(f"meta_check/partitioned: flops card "
                             f"{rec['card_flops']} != meta "
                             f"{rec['meta_flops']}")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def unet_meta_check() -> dict:
    """One Alg.-1 step of the collab dry run's U-Net at META_CHECK_UNET
    (``collab_dryrun.collab_step_program``): its saved-tensor bytes and
    FLOPs on the card equal to the meta run's under ``dryrun.measure``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import kernels
    from repro_torch.launch import collab_dryrun, dryrun
    fn, args = collab_dryrun.collab_step_program(*META_CHECK_UNET, "meta")
    meta = dryrun.measure(fn, args)
    fn, args = collab_dryrun.collab_step_program(*META_CHECK_UNET, "cuda")
    fn(*args)                                         # warm
    torch.cuda.synchronize()
    kernels.reset_flops()
    with FlopCounterMode(display=False) as fc, \
            dryrun.SavedBytes() as saved, torch.no_grad():
        fn(*args)
    torch.cuda.synchronize()
    rec = dict(config=list(META_CHECK_UNET),
               card_saved=[saved.activation_bytes, saved.param_bytes],
               meta_saved=[meta["saved_activation_bytes"],
                           meta["saved_param_bytes"]],
               card_flops=fc.get_total_flops() + kernels.total_flops(),
               meta_flops=meta["flops"], meta_trace_s=meta["trace_s"])
    log(f"meta_check/unet {META_CHECK_UNET}: saved activations card "
        f"{rec['card_saved'][0]} meta {rec['meta_saved'][0]}, saved "
        f"parameters card {rec['card_saved'][1]} meta {rec['meta_saved'][1]}"
        f"; flops card {rec['card_flops']} meta {rec['meta_flops']}; meta "
        f"step {meta['trace_s']} s")
    if rec["card_saved"] != rec["meta_saved"]:
        raise AssertionError(f"meta_check/unet: saved bytes card "
                             f"{rec['card_saved']} != meta "
                             f"{rec['meta_saved']}")
    if rec["card_flops"] != rec["meta_flops"]:
        raise AssertionError(f"meta_check/unet: flops card "
                             f"{rec['card_flops']} != meta {rec['meta_flops']}")
    del fn, args
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_examples():
    """The four port examples (examples/torch_*.py) on the card at the
    reference's numbers, every launch counter zeroed just before and read
    just after: the keyed DDPM step (three diffusion examples' samples),
    the SSD scan's forward and backward (the reduced mamba2-2.7b DiT) and
    flash attention's forward and backward (the reduced granite-8b LM)
    must each be launched; outputs finite.  Returns the path's launches
    and per-example walls."""
    import importlib.util
    import torch
    from repro_torch.kernels.ddpm_step import kernel as dkernel
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.grouped_matmul import kernel as gkernel
    from repro_torch.kernels.ssd_scan import kernel as skernel
    kmods = (dkernel, fkernel, skernel, gkernel)
    mods = {}
    for name in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    walls = {}
    for kmod in kmods:                          # --- examples path starts
        kmod.reset_counts()
    for name, mod in mods.items():
        t0 = time.perf_counter()
        out = mod.run(device="cuda")
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        if not all(torch.isfinite(t).all().item()
                   for t in EXAMPLE_OUTPUTS[name](out)):
            raise AssertionError(f"examples/{name}: non-finite output")
        log(f"examples/{name}: wall {walls[name]:.1f} s")
    launches = lm_counts(*kmods)                # --- examples path ends
    log(f"examples/launches: {launches}")
    for name in ("ddpm_step/keyed", "ssd_scan", "ssd_scan_bwd",
                 "flash_attention", "flash_attention_bwd"):
        if launches[name] <= 0:
            raise AssertionError(f"examples: {name} never launched")
    return launches, walls


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # inference throughout: the raw kernel launches refuse inputs that need
    # a gradient; the training paths, the DiT's gradient check and the
    # refusal checks enable grad where they need it
    torch.set_grad_enabled(False)
    t_start = time.perf_counter()
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    phase_build()
    records = phase_keyed(phase_kernels())
    phase_flash_ssd()
    mixer_records = phase_mamba_mixer()
    fwd_ms = phase_unet()
    launches, batched_card_ms = phase_main_path(fwd_ms)
    phase_contracts()
    train_launches, ddpm_card_ms = phase_train()
    runtime_launches, trained = phase_train_runtime()
    mesh_launches = phase_clients_mesh()
    eval_launches = phase_eval(trained)
    del trained
    dit_records, dit_launches = phase_dit()
    phase_grouped_matmul()
    moe_records, moe_launches = phase_moe()
    moe_train_records, moe_train_launches = phase_moe_train()
    lm_records, lm_launches = phase_lm_serve()
    train_records, lm_train_launches = phase_lm_train()
    partition_launches = phase_dense_partition()
    decode_partition_launches = phase_decode_partition()
    moe_partition_launches = phase_moe_partition()
    whisper_records, whisper_launches, whisper_train_launches = \
        phase_whisper()
    examples_launches, _ = phase_examples()
    # the dry runs (CPU only) beside the card check of the meta route,
    # which times nothing the records read
    t_new = time.perf_counter()
    dryruns = start_dryrun()
    try:
        phase_meta_check()
    except BaseException:
        stop_dryrun(dryruns)
        raise
    phase_dryrun(dryruns)
    log(f"meta_check_and_dryrun/phase_s: "
        f"{time.perf_counter() - t_new:.1f}")

    records["ddpm_step"]["card_ms"] = ddpm_card_ms
    records["ddpm_step_batched"]["card_ms"] = batched_card_ms
    for name in MIXER_KERNELS:
        mixer_records[name].update(dit_records.pop(name))
    records.update(mixer_records)
    records.update(dit_records)
    records["flash_attention"]["head_dim_128"] = \
        moe_records.pop("flash_attention@128")
    records.update(moe_records)
    for name, rec in lm_records.items():
        records[name]["lm_prefill"] = rec
    records.update(train_records)
    records["flash_attention"]["whisper_encoder"] = \
        whisper_records["encoder"]
    records["flash_attention"]["whisper_decoder"] = \
        whisper_records["decoder"]
    records["flash_attention_bwd"]["whisper_encoder"] = \
        whisper_records["bwd_encoder"]
    records["flash_attention_bwd"]["whisper_decoder"] = \
        whisper_records["bwd_decoder"]
    records["flash_attention_bwd"]["dbrx_train"] = \
        moe_train_records["flash_bwd"]
    records["grouped_matmul"]["capacity_shapes"] = \
        moe_train_records["capacity_shapes"]
    records["grouped_matmul_bwd"] = moe_train_records["grouped_matmul_bwd"]
    # launches of the sixteen main paths (each counted from zero just
    # before it)
    by_path = dict(zip(PATHS, (launches, train_launches, runtime_launches,
                               eval_launches, dit_launches, moe_launches,
                               moe_train_launches, lm_launches,
                               lm_train_launches, whisper_launches,
                               whisper_train_launches, examples_launches,
                               mesh_launches, partition_launches,
                               decode_partition_launches,
                               moe_partition_launches),
                       strict=True))
    launches = {name: sum(path.get(name, 0) for path in by_path.values())
                for name in set().union(*by_path.values())}
    log(f"total_s: {time.perf_counter() - t_start:.1f}")
    log(json.dumps(kernels_line(records, launches, by_path)))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
