#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``neuronx_distributed_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. build   every CUDA source under ``csrc/`` (one ``nvcc`` per source, all
           started together);
2. kernels each kernel at the shapes of its path, in bf16, against its plain
           PyTorch twin on the same inputs (the limit beside each
           reading), timed beside the twin, one PyTorch library call
           (timed only, never used by the port) and the card's bound:
           flash forward and paged decode at the serving shapes (paged
           decode also at GQA groups 1 and 8, an fp32 pool and cache
           lengths 0 to 4095), flash forward again, timed, and flash
           backward (dK/dV, dQ) at one training layer's attention, AdamW at
           the embedding leaf; flash forward, flash backward and paged
           decode again at head_dim 96 and 80 (the widths the kernels are
           not built for) and at 160 and 256 (the 256-wide builds, timed
           at 256), paged decode also over an fp32 pool at 256; flash
           forward and backward at phase 4o's layers, timed: BERT-large
           (16 x 16 heads of 64 over 512 tokens, bidirectional under the
           pad keys of ``synthetic_mlm_batches``) and GPT-NeoX-20B (8 x 64
           heads of 96 over 2048 tokens, causal, at the 128-wide build); flash
           forward again at a chunk extend of the trace phase (queries at
           positions 2560..3071 over a 4096-key view); the W8A16 GEMM (B5)
           at the shapes of phase 4h (dense decode both ways, all_experts
           decode, selective pairs, a per-tensor scale, fp32; the inserts'
           prefill products: 512 rows to 14336, 1024 and from 14336, 4096
           rows, 8 experts x 512 shared rows, a ragged 300; the 128-token
           bucket's inserts at 128 rows, 8 experts x 128 shared rows), each on the
           route its shapes pick, timed beside three yardsticks (the
           dequantized weights and ``torch.matmul``, ``torch.matmul`` on
           bf16 weights, ``torch._weight_int8pack_mm`` where this PyTorch
           has a CUDA kernel for it) and, where the bytes bound it, a plain
           read of the weights. Flash
           forward at the serve shape and AdamW are held absolutely; at the
           training shape, for paged decode and for B5 each output element
           is held against its own size, against the
           twin or an fp64 evaluation of the same function (``fwd_exact``,
           ``bwd_exact``, ``decode_exact``), the median |ref| printed
           beside each limit; every attention kernel must give the same
           bits when launched twice; the tensor-core kernels must not
           spill and must hold HMMA or HGMMA instructions (B5's prefill
           kernels HGMMA); B5's launches by route on the main path go on
           the kernels line;
3. check   a small fp32 model served through ``CausalLM`` on the GPU
           (kernels) and on the CPU (twins): logits must agree; the same
           model trained two steps on each, five ways (full remat,
           ``"attention"`` remat, plain AdamW, LoRA, LoRA with dropout fed the
           same CPU-drawn masks): losses and trained weights must agree;
           the same model (head_dim 128, then 96) behind a ``ServeEngine``
           whose decode blocks are captured CUDA graphs and one that steps
           token by token, greedy and sampled requests: bit-identical
           streams on the card, greedy streams equal to the CPU's, and a
           steady-state block one replay and one fetch;
4. serve   Llama-3-8B at full width (random bf16 weights from a seeded
           generator) behind ``ServeEngine``, each decode block one replay
           of a captured CUDA graph: the launch counters are set to 0 just
           before and read just after, and every serving kernel must have
           run; every logit (read from the graph's flags) must be finite
           and every request complete; then the same requests again with
           int8 KV pages (the same weights), whose tokens are matched
           against the first pass;
4b. trace  the same weights behind a ``CausalLM`` with a 4096-token bucket:
           a synthetic arrival trace of 32 greedy requests (every 4th a
           3072-token prompt) served three times, with one-shot inserts,
           with 512-token prefill chunks, and with chunks in the pipelined
           loop (``async_loop``), the counters zeroed before each pass:
           tokens/s, TTFT of short and long requests, the largest gap
           between a short request's tokens, host ops a decode block; every
           request must complete, the two chunked passes must give
           bit-identical streams, and a chunked pass's steady decode block
           must be one replay and one fetch, any block at most one copy
           more;
4c. overload the same ``CausalLM``: 48 greedy requests arriving 4 a block
           (every 4th a 3072-token prompt, two tenants) with TTFT and
           completion deadlines on a virtual block clock of fixed length
           (``OVERLOAD_BLOCK_MS``; a short prompt's TTFT budget a quarter of
           a long one's), behind an engine with EDF admission, a queue
           bound of 8 and the ``deadline`` shed policy, served three times:
           (d) the synchronous and (e) the pipelined loop through
           ``run_trace`` (tracer on), (f) the pipelined loop untraced. The
           three must make the same decisions (streams, schedules,
           rejections, expiries, finish reasons); every request completes or
           is rejected; (d) sheds to a full queue, evicts by deadline,
           expires in the queue and mid-decode and completes on time; each
           pass launches B1 and B2; the traced passes keep the host ops of
           a decode block (a steady one 2, any at most 3), drop no trace
           event, record each delivered token once and export a trace the
           validator accepts. Printed: ``run_trace``'s report of (d) and
           (e), and (e) against (f) tokens/s (the tracer's cost);
4d. recovery the same weights behind a ``CausalLM`` with a 300-page pool and
           a 256-page host tier: 32 greedy requests over four shared
           512-token prefixes served seven times: (g) the reference, (h)
           dispatch faults in the pipelined loop, (i) and (j) a chaos plan
           (pool storms, dispatch faults, corrupted pages, tier read
           failures and corruptions) in both loops, (k) a crash at a
           snapshot and ``from_snapshot``, (l) every live page with a tier
           copy corrupted and repaired, (m) the streaming report. (h) and
           (l) must give (g)'s streams bit for bit, (i) and (j) the same
           decisions and streams, each stream (g)'s tokens up to its first
           replay, (k) every request resumed with (g)'s tokens up to the
           snapshot and the captured graph reused, (m) (g)'s totals, and
           every count (faults, replays, spills, restores, repairs, blocks)
           the one the CPU rehearsal predicted;
4e. tenants the same weights behind a ``CausalLM`` with a rank-16 adapter
           pool (five usable slots) and a pool of four grammar slots:
           (n) the trace phase's trace with no labels, which must give
           trace pass (a)'s tokens bit for bit; (o) 32 requests under
           eight adapters over two shared prefixes, whose counts (loads,
           hits, evictions, a full pool, prefix hits, blocks) must be the
           CPU rehearsal's; (p) (o) in the pipelined loop, (o)'s
           decisions and streams; (q) half of them under four grammars,
           (r) pipelined, (s) under adapter and grammar load faults and
           corruptions: every constrained stream must parse, every
           garbled slot be repaired and every load fault retried; (t) one
           full-width fp32 layer with an adapter held against merged
           weights; one capture for the phase;
4f. park   the trace phase's ``CausalLM`` again: eight chat sessions (six
           512-token prompts, two 3072-token ones, 96 new tokens each)
           served five times: (u) the reference; (v) each session parked
           once it delivered 32 tokens and resumed (``submit(resume=)``)
           two blocks later, then each session's cold twin (its prompt and
           32 tokens as a fresh request); (w) the pipelined loop parking
           after 4 idle blocks through ``run_trace``; (x) (v) under park
           faults (state-only parks, torn manifests, read faults, corrupt
           bytes); (y) every session parked, a snapshot, and a fresh engine
           from it resuming them all. (v), (w), (y) and (x)'s exact resumes
           must give (u)'s tokens bit for bit, each park leave no page
           behind, (x)'s counts be the CPU rehearsal's; every request of
           every traced pass of 4c-4f is attributed with its phases summing
           to its span, (v)'s parked sessions paying a ``park_resume``
           phase; (x)'s incident bundles pass the validator. Printed: park
           and resume ms, resume against cold TTFT, durable bytes and the
           host split of parks and resumes, by session length;
4h. quant  int8 weights and the Mixtral family: (q3) a 2-layer fp32 Mixtral
           (4 experts) with int8 weights on the GPU and the CPU, logits
           within the small model's tolerance, greedy streams equal on both
           devices in selective and all_experts decode; (q1) the serve
           phase's Llama-3-8B weights quantized on the card and the serve
           workload behind ``ServeEngine``, beside the same workload on the
           bf16 weights; (q2) Mixtral-8x7B at full width and depth with int8
           weights (each weight drawn in bf16 from a seed and quantized at
           once), the serve workload (8 rows: all_experts decode) and a
           batch-1 ``generate(fused_chunk=8)`` of a 512-token prompt
           (selective decode). Gates: every request completes, a steady
           decode block one replay and one fetch, captured = stepwise
           streams, B1/B2/B5 launched, B5's wgmma route by the int8
           inserts and its decode route by the decode steps of (q1) and
           both (q2) runs (its f32 route by (q3)), Mixtral's peak below the
           card's memory. Printed: weight bytes, tok/s, decode block and
           step ms, B5's launches by route, the share of int8 tokens equal
           to the bf16 pass's;
4j. tp     tensor-parallel serving: (t1) the serve workload on the serve
           weights without a group and through ``initialize_model_parallel(1)``
           over a real NCCL group of one rank, its collectives inside the
           captured decode blocks: bit-identical streams, a steady block 2
           host ops, and one profiled replay holding at least a copy a step
           beyond the plain block's (at one rank NCCL launches no kernel of
           its own: its all-gather is a device copy, its in-place
           all-reduce nothing); (t2) two
           processes on the one card, each a rank of a gloo group
           (``capture_programs=False``, ``fused=False``): a small fp32 model
           whose greedy streams must equal TP=1's and logits agree within
           ``TP_SMALL_TOL``, then Llama-3-8B at full width sharded over the
           two ranks serving the workload: every request completes, the
           ranks' digests of streams and decisions agree, each rank holds
           at most 0.55 of TP=1's KV and weight bytes, B1 and B2 launch on
           each rank at its 16/4 heads and are held against their twins
           there. Printed: both decode block times of (t1), (t2)'s token
           match against (t1) (not gated: a bf16 all-reduce sums in another
           order), the gathered page read, the card's peak;
4k. train loop Llama-3-8B at full width and depth (bf16 frozen base from a
           seed) fine-tuned with LoRA (r 16, alpha 32, dropout 0.05, the
           five default targets) through the loop a user runs: token shards
           written from a seeded stream, the native ``TokenShardDataset``,
           ``train_loop`` (6 steps of 2 x 4096 tokens, B4 on the adapters,
           async saves after steps 3 and 6), a crash that leaves the last
           save without its ``done`` marker, then a model, optimizer, loader
           and generator built from nothing resuming through
           ``maybe_resume`` (verified) from step 3 and running steps 4-6.
           Gates: the resumed losses, grad norms and adapters bit-identical
           to the uninterrupted run's, the base unchanged bit for bit, the
           last epoch's mean loss below the first's, B1, B3a, B3b and B4
           launched, B4 on an adapter leaf equal to its twin, the peak below
           the card's memory, a flipped payload byte caught by
           ``verify=True``. Printed: step ms, the save's synchronous and
           background ms, load ms, bytes on disk, B4's launches and ms a
           step, peak bytes, tokens/s;
5. train   Llama-3-8B widths cut to 4 layers (bf16 weights, fp32 master
           AdamW, clipping, activation checkpointing, every update through
           ``update_and_params_local``: the optimizer kernel) on a repeated
           2 x 4096-token batch: 2 warm-up steps, then 5 timed steps between
           zeroing and reading the counters; every training kernel must have
           run, every loss and grad norm be finite, the loss fall, and the
           peak memory stay below the card's. Then (k2) the same cell under
           ``remat_policy="attention"`` and with plain AdamW on the bf16
           params: step ms, peak bytes, launches (B1's a layer), the loss
           falling.
4l. dist   distributed training: (d0) Llama-2-7B widths at 1 layer, 4 x
           4096 tokens a step of a seeded stream, bf16 with fp32 masters,
           remat ``"attention"``, clipping 1.0, 2 steps on one rank; (d1)
           the same run through the Llama-2 TP+ZeRO-1+SP example's entry
           point as four processes on the card over gloo (TP 2 x DP 2, SP
           and ZeRO-1 on): each step's loss within 1 % of (d0)'s, the DP
           replicas' params and the TP-replicated leaves bit-identical
           after every step, the ZeRO state a quarter of (d0)'s, B1, B3a,
           B3b and B4 (9 a step) launched in every rank; (d2) the small
           fp32 model on the same layout against one CPU rank (losses and
           grad norms within 1e-5), a multi-rank async save after step 2
           and a fresh group resuming step 3 bit for bit, the tag loaded at
           TP=1 equal to the gathered params, a flipped byte caught.
4m. cp/pp  context and pipeline parallelism: (c0) Llama-2-7B widths at 1
           layer, one 32768-token sequence a step, bf16 with fp32 masters,
           remat ``"full"``, 2 steps on one rank; (c1) the same through the
           trainer at CP 2 x TP 2 (ring attention, zigzag) as four
           processes on the card over gloo: each step's loss within 1 % of
           (c0)'s, B1, B3a, B3b and B4 launched in every rank, the ring's
           sends counted; (c2) the small fp32 model on that layout against
           one CPU rank (1e-5), and the ring op alone at ``RING_CHECK``
           against the CPU ranks' ring by the element rule; (p0)
           Llama-2-70B widths at 4 layers, the forward loss of one 4 x 4096
           batch from the seeded init on one rank; (p1) the Llama-2-70B TP
           x PP example's entry point at TP 2 x PP 2 (4 microbatches, 1F1B,
           2 steps): step 1 within 1 % of (p0), every rank's stash within
           pp - stage, the kernels launched in every rank; (p2) the same
           with two VPP chunks a stage, each step within 1 % of (p1)'s; (p3)
           the small fp32 model at TP 2 x PP 2, 1F1B and interleaved,
           against one CPU rank (1e-5), a save after step 2 and a fresh
           group resuming step 3 bit for bit, the tag at TP1 x PP1 equal to
           the gathered params, a flipped byte caught; then
           ``measure_cp_ratio`` at 32768 tokens, cp 2.
4n. moe    Mixtral training with expert parallelism: (m0) Mixtral-8x7B
           widths at 1 layer (8 experts, top 2, capacity factor 1.25, aux
           coefficient 0.01), 2 x 4096 tokens a step of a seeded stream,
           bf16 with fp32 masters, remat ``"full"``, 2 steps of
           ``mixtral_loss`` on one rank, each layer's dropped assignments
           printed; (m1) the same run through the ``mixtral_moe`` example's
           entry point as four processes on the card over gloo (TP 2 x EP
           2): each step's loss within 1 % of (m0)'s, B1, B3a, B3b and B4
           launched and the expert all-to-all issued in every rank, the
           collectives a step by kind; (m2) the small fp32 Mixtral at a
           capacity factor that drops tokens, at TP 2 x EP 2 and EP 2 x edp
           2, against one CPU rank (1e-5, dropped assignments equal), a
           save after step 2 and a fresh group resuming step 3 bit for bit,
           the tag at TP1 x EP1 equal to the gathered params, a flipped byte
           caught, and the small DBRX model's step (1e-5).
4o. families the GPT-NeoX and BERT families: (b0) ``bert_large`` at full
           width and depth through the BERT example's entry point on one
           rank (16 x 512 tokens a step of ``synthetic_mlm_batches``, fp32
           weights and masters, bf16 compute, dropout 0.1, 4 steps; every
           loss finite, B1, B3a, B3b and B4 launched, the peak below the
           card's), then the same model on one repeated batch and dropout
           seed, whose loss after 5 steps must be below the first; (n0)
           ``gpt_neox_20b`` widths at 1 layer, 8 x 2048 tokens a step of a
           seeded stream, bf16 with fp32 masters, remat ``"attention"``,
           clipping 1.0, 2 steps on one rank: the kernels launched, every B1
           at head_dim 96 (the 128-wide build), the peak below the card's;
           (n1) the same run through the NeoX example's entry point as four
           processes on the card over gloo (TP 2 x DP 2, SP and ZeRO-1 on):
           each step's loss within 1 % of (n0)'s, the DP replicas and the
           TP-replicated leaves bit-identical after every step, the kernels
           launched in every rank; (n2) the small fp32 NeoX (SP) and BERT on
           that layout against one CPU rank (1e-5).
4p. entry  the user's entry points (``scripts/entry_points_phase.py`` runs it
           alone): B5 (5120 -> 5120, 5120 -> 13824, 13824 -> 5120 at 1 to
           2048 rows, bf16 and fp32) and B1 (the 2048 bucket's insert) held
           by the element rule at the shapes the runner's 13B paths give
           them; the serving runner ``examples/runner.py`` through its
           ``main`` at Llama-2-13B full width and depth (40 layers, bf16
           seeded weights, TP 1): (r0) ``benchmark`` at batch 1 and 2048
           prompt tokens, 10 trials, 50 decode steps and the fused block of
           8 (B1 launched), and greedy ``generate``; (r0 shell) that
           ``generate`` as a process of its own, the runner's module run as
           ``python -m`` runs it, alone on the card (exit 0, this process's
           tokens, B1 launched in it); (r1) ``serve --paged --paged-kernel --async`` of
           16 requests at max_batch 8 (every request completes, prefix hits,
           B1 and B2 launched, the peak below the card's); (r2)
           ``speculate`` with its 10-layer self-draft, host loop and 2 rounds
           a block (the two give the same tokens, the draft over the
           target's own tensors, no draft copy in the peak; the share of
           tokens equal greedy ``generate``'s printed: bf16 rounds the
           verify chunk and the decode step apart); (r3) ``check-accuracy``
           at 13B widths in fp32 cut to 10 layers (greedy match, logit max
           |diff| below 1e-3), and greedy ``speculate`` on that model
           token-identical to greedy ``generate``; (r4) ``generate --quantize``
           (B5 launched, int8 weights about half the bf16 bytes), and (r4
           check) ``check-accuracy --quantize`` on (r3)'s weights (greedy
           match, logit max |diff| below 1e-3, B5 launched); (r5) the
           ``--tiny`` cases on the card (medusa, replicas with a crash,
           disagg, adapters, grammars, snapshot recovery), each held as its
           JAX test holds it; (l0) the lightning fit loop over
           llama2_7b widths at 1 layer (as (d0)), 2 x 4096 tokens a step, bf16 + fp32
           masters: a straight 4-step fit, a fit SIGTERM stops at step 2 and a
           fresh trainer resumes to step 4 (params equal bit for bit), and
           ``grad_accum_steps=2`` (the params move on even steps only); B1,
           B3a, B3b and B4 launched.
4r. lora/moe the last runtime gaps (``scripts/lora_moe_phase.py`` runs it
           with 4l and 4n alone): (v0) in phase 4l's rank processes, LoRA
           (rank 16 on the five default targets and the embedding, dropout
           0.05) at TP 2 x DP 2 with ZeRO-1 over Llama-2-7B widths at 1
           layer, 4 x 4096 tokens, 2 steps, against the one-rank run on the
           same seeds: losses within 1 %, the frozen base unchanged, the DP
           replicas' adapters and the TP-replicated ones bit-identical,
           optimizer state for the adapters only, B1/B3a/B3b/B4 launched on
           every rank; (v1) in phase 4n's, Mixtral-8x7B widths at 1 layer
           at CP 2 x EP 2 (zigzag, capacity factor 1.0), 2 x 4096 tokens, 2
           steps, against the one-rank run whose MoE blocks take the zigzag
           order: losses within 1 %, the same on every rank, the kernels
           and the expert all-to-all on every rank; the small fp32 Mixtral
           on that layout against one CPU rank (1e-5, dropped counts equal);
           (v2) ``runner.py serve --model mixtral --adapters 3 --paged
           --paged-kernel`` (rank 16, a pool of 4 slots) at Mixtral-8x7B
           widths cut to 8 layers, beside the same serve without the pool:
           every request completes, B1 and B2 launched, adapter loads and
           hits, slot-0 streams of both runners' models bit-identical, and a
           small fp32 Mixtral layer pooled against merged within 1e-4.
4s. nxdcheck the port's static contract checker: ``scripts/nxdcheck_torch.py``
           in a subprocess over the port tree (exit 0, verdict clean, the
           six rule ids, the sweep within ``NXDCHECK_MAX_S`` seconds) and
           over ``tests/fixtures/nxdcheck_torch/bad`` (exit 1, every rule
           firing); both summaries printed with the card's name and power
           limit.

``--profile PATH`` repeats each trace and overload pass under
``torch.profiler`` (device activity only) for the device's busy share of
its wall time, then serves the workload once more, timed and under the
profiler (its busy share, and its kernel table written to PATH), after
every timed serving run; it also profiles one more training step (table
at ``PATH`` with ``_train`` added to its name).

Before its last line it prints one JSON object with every kernel's numbers
and the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (dense): the bound of each kernel
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12      # outside the tensor cores
PEAK_BYTES = 3.35e12

# kernel vs twin at the seeded serving shapes, bf16 operands with fp32
# accumulation on both sides, outputs rounded to bf16. B1's limit is set
# from the readings on an H100: its outputs differ by at most one bf16 last
# place below |x| = 1 (0.00195 for the fp32-FMA kernel, 0.0039 on the
# tensor cores), so 4e-3 admits one last place below |x| = 1 and no more;
# the LSE reads 1e-6.
TOL_FLASH_BF16 = 4e-3
TOL_LSE = 1e-3
# At the training shape (one layer's causal attention over 4096 tokens) the
# outputs span orders of magnitude: a row that sees n keys has |dQ|, |dK|
# and |out| of about 1/sqrt(n), while |dV| reaches 10. So B1's output there
# and each gradient of B3a/B3b are held element by element against their
# own size: |got - want| <= REL_BF16 * |want| + floor. Both sides round an
# fp32 sum to bf16, and two sums a few fp32 places apart round one bf16
# last place apart where they straddle a rounding point: at most 2**-7 of
# the value. The floor admits what the rest leaves where a sum cancels to
# near zero: p and ds are rounded to bf16 before the products, and where the
# two sides' fp32 values straddle a rounding point one term moves by a last
# place, most where a row sees few keys. The kernels sum on the tensor
# cores, in another order and rounding than the twin's fp32 sums, so such
# straddles are more frequent than they were for the fp32-FMA kernels the
# first floors were read from (B1 5.6e-8, dQ 2.4e-4, dK 3.0e-4, dV 1.9e-4;
# floors 2e-7, 5e-4, 6e-4, 4e-4). Each output is therefore also held
# against an fp64 evaluation of the same function with the twin's roundings
# (``fwd_exact``, ``bwd_exact``): an element passes within the limit of the
# twin or of the fp64 value. The floors were raised by this rule, each to
# about twice the least that passed where 5 % of the median allows it (the
# script checks that it stays under 5 % of the median):
# - B1 (median |want| 0.026): against the twin the kernel needs 4.4e-4;
#   against fp64 its max |error| equals the twin's (0.0078) and it needs
#   4.25e-4, the twin 3.4e-4; least that passes 4.25e-4, floor 8.5e-4;
# - dQ, dK, dV (medians 0.026, 0.030, 0.031): against fp64 the kernels' max
#   |error| equals the twin's (dQ 0.0076, dK 0.0152, dV 0.0312 and 0.0308)
#   and the floor each needs is dQ 6.3e-4 (the twin's 1.4e-3), dK
#   8.5e-4-9.1e-4 (the twin's 9.7e-4-1.1e-3), dV 4.1e-4-4.2e-4 (the twin's
#   2.3e-4-2.4e-4); floors 1.25e-3, 1.5e-3, 8e-4.
REL_BF16 = 2.0 ** -7
TOL_FLASH_TRAIN_FLOOR = 8.5e-4
TOL_DQ_FLOOR = 1.25e-3
TOL_DK_FLOOR = 1.5e-3
TOL_DV_FLOOR = 8e-4
FLOOR_SHARE_OF_MEDIAN = 0.05
# B2 against its twin, each element as above (REL_BF16 * |want| + floor, of
# the twin or of the fp64 value ``decode_exact``). Its split merge sums in
# another order than the twin's page loop, so a bf16 output moves by one
# last place where the two fp32 sums straddle a rounding point: 0.00049 at
# the serve shape, 0.00195 at |x| in [0.25, 0.5) with an fp32 pool, where
# the earlier absolute limit of 1e-3 (read 0 for the one-CTA kernel) no
# longer holds. Beyond one last place the element rule needs a floor of
# 2.9e-9 at most (0 against fp64 but for the GQA-group-8 case); 6e-9 is
# about twice that.
TOL_PAGED_FLOOR = 6e-9
# Head dims above 128 run the 256-wide builds (160 zero-padded to 256). On
# the random cases of ``run_head_dims`` an H100 read at head_dim 160 and 256
# the floors that the 128-wide constants above were read from elsewhere:
# out 4.2e-4 and 5.8e-4 (kernel vs fp64; floor 8.5e-4), dV 6.8e-4 and 6.0e-4
# (8e-4), dQ 1.60e-3 and 8.1e-4 against 1.25e-3, dK 1.86e-3 and 6.6e-4
# against 1.5e-3, and B2 over int8 pools at 256 9.6e-9 against 6e-9: the
# same one-term straddles, over sums of up to twice as many products. These
# widths take their own floors for dQ, dK and B2, about 1.5 times (dQ, dK)
# and twice (B2) the most read, each under 5 % of its median |ref|; out and
# dV keep theirs.
TOL_DQ_FLOOR_WIDE = 2.3e-3
TOL_DK_FLOOR_WIDE = 2.8e-3
TOL_PAGED_FLOOR_WIDE = 2e-8
# B4 rounds where its twin rounds (IEEE intrinsics, no FMA contraction):
# bit for bit on an H100 (reads 0)
TOL_ADAMW = 0.0
# the small fp32 model: kernels vs twins on the CPU, summation order only
TOL_LOGITS_FP32 = 2e-3
# the small fp32 model trained two steps on the GPU and on the CPU. The
# losses read equal (0) on an H100: 1e-5 is 20 fp32 last places at a loss
# of 6. The weights read 6.9e-5 apart; a weight moves by about lr (1e-3)
# per Adam step, and a gradient whose sign differed between the devices
# would put a weight 2e-3 off: 2.5e-4 admits the reading and catches that
TOL_TRAIN_LOSS = 1e-5
TRAIN_CHECK_LR = 1e-3
TOL_TRAIN_PARAMS = 2.5e-4

SERVE_PROMPT_LENS = (100, 180, 316, 376, 300, 420, 500, 150)
SHARED_PREFIX = 256       # requests 2 and 3 share their first 256 tokens
MAX_NEW_TOKENS = 32

TRAIN_BATCH, TRAIN_SEQ, TRAIN_LAYERS = 2, 4096, 4
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
TRAIN_LR = 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int, flush) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls, each after the 50 MB
    L2 is flushed, each timed by its own pair of CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def collective_snapshot() -> dict:
    """A copy of this thread's collective table (``mappings.collective_stats``
    keeps counting into the table it returns)."""
    from neuronx_distributed_tpu_torch.parallel import mappings

    return {kind: list(v) for kind, v in mappings.collective_stats().items()}


def zero_launches(counters) -> None:
    """Set each wrapper's launch count (and its counts by route, where it
    keeps them: B5) to 0."""
    for c in counters:
        c.launches = 0
        if hasattr(c, "launches_by_route"):
            c.launches_by_route = dict.fromkeys(c.launches_by_route, 0)


def routes_of(counters) -> dict:
    """The counts by route of the wrappers that keep them, by name."""
    return {c.__name__: dict(c.launches_by_route) for c in counters
            if hasattr(c, "launches_by_route")}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _excess(got, ref, rel: float, size=None):
    """|got - ref| - rel * |ref| (``size`` in place of |ref| when given),
    element by element, in fp64 when ``ref`` is fp64 and in fp32 otherwise."""
    import torch

    wide = torch.float64 if ref.dtype == torch.float64 else torch.float32
    g, r = got.to(wide), ref.to(wide)
    return (g - r).abs() - rel * (r.abs() if size is None else size.to(wide))


def held(got, want, floor: float, rel: float = REL_BF16, exact=None, size=None) -> dict:
    """The readings of ``got`` held element by element against ``want``:
    max |error|, the least floor with which ``|got - want| <= rel * |want| +
    floor`` holds everywhere, the median and rms of |want|, and the limit.

    With ``exact``, an fp64 evaluation of the same function (the twin's bf16
    roundings of p and dS included), an element may instead lie within
    ``rel * |exact| + floor`` of it: the twin's fp32 sums are not exact
    either, and where they put a p or a dS on the other side of a bf16
    rounding point than the exact sums do, the twin is the one off. Both the
    kernel's and the twin's readings against ``exact`` are returned.

    With ``size`` (a tensor shaped like ``want``) the relative allowance is
    ``rel * size``: for a value made of terms each rounded to bf16 on its
    own and then summed (the ring's blocks), the sum of the terms'
    magnitudes and of the result's, one last place a rounding."""
    err = (got.float() - want.float()).abs()
    over = _excess(got, want, rel, size)
    mag = want.float().abs()
    r = dict(max_abs_err=float(err.max()), floor_needed_vs_twin=max(0.0, float(over.max())))
    if exact is not None:
        over_exact = _excess(got, exact, rel, size).float()
        r["vs_exact"] = {
            who: dict(max_abs_err=float((t.double() - exact).abs().max()),
                      floor_needed=max(0.0, float(_excess(t, exact, rel, size).max())))
            for who, t in (("kernel", got), ("twin", want))}
        over = over.minimum(over_exact)
        del over_exact
    need = float(over.max())
    r.update(floor_needed=max(0.0, need), floor=floor, rel=rel,
             median_abs_ref=float(mag.flatten().median()),
             rms_ref=float(mag.square().mean().sqrt()), ok=need <= floor)
    return r


def held_problems(name: str, r: dict) -> list:
    """What fails in ``held``'s reading ``r`` of ``name``: an element beyond
    the rule, or a floor not under ``FLOOR_SHARE_OF_MEDIAN`` of the median
    |ref| (a floor that large would pass a wrong kernel)."""
    out = []
    if not r["ok"]:
        out.append(f"{name} differs from its twin beyond {r['rel']:.3g} * |ref| + "
                   f"{r['floor']:.3g} (needs {r['floor_needed']:.3g})")
    if r["floor"] > FLOOR_SHARE_OF_MEDIAN * r["median_abs_ref"]:
        out.append(f"{name}: floor {r['floor']:.3g} exceeds {FLOOR_SHARE_OF_MEDIAN:.0%} of the "
                   f"median |ref| {r['median_abs_ref']:.3g}")
    return out


def check_held(name: str, r: dict) -> None:
    problems = held_problems(name, r)
    check(not problems, "; ".join(problems) + f" (max |err| {r['max_abs_err']:.3g})")


def compile_report(source: str) -> dict:
    """Each kernel's registers, shared memory and spill bytes from the build
    log of ``source`` (``nvcc -Xptxas -v``; empty when this process found
    the library built) and its counts of HMMA (``mma.sync``) and HGMMA
    (``wgmma``) tensor-core instructions in the library's SASS
    (``cuobjdump -sass``; None without the tool), keyed
    ``tc::dkdv_kernel<128>`` (bf16) or ``flash_bwd_dkdv_kernel<float, 128>``
    (``flash_bwd``), ``tc::fwd_kernel<128>`` or ``flash_fwd_kernel<float,
    128>`` (``flash_fwd``), ``tc::wgmma_kernel<MW>`` (B5's prefill route, tiles
    of 128 MW rows), ``tc::decode_kernel`` and ``tc::dense_decode_kernel`` (its
    decode route, batched and one entry), ``gemm_f32_kernel`` and
    ``reduce_kernel<bf16>``
    (``w8a16_gemm``)."""
    import os
    import re
    import shutil

    from neuronx_distributed_tpu_torch.kernels import _build

    name = re.compile(r"\d+((?:flash_(?:bwd_)?)?(?:dkdv|dq|fwd)_kernel)I(f?)Li(\d+)E")
    gemm = re.compile(r"2tc\d+(?:(wgmma_kernel)ILi(\d)E|(dense_decode_kernel|decode_kernel))"
                      r"|(gemm_f32_kernel)|reduce_kernelI(\w+?)E")

    def short(mangled):
        m = name.search(mangled)
        if m is None:
            g = gemm.search(mangled)
            if g is None:
                return None
            if g.group(1):
                return f"tc::wgmma_kernel<{g.group(2)}>"
            if g.group(3):
                return f"tc::{g.group(3)}"
            return g.group(4) or ("reduce_kernel<float>" if g.group(5) == "f"
                                  else "reduce_kernel<bf16>")
        kernel, fp32, d = m.groups()
        return f"{kernel}<float, {d}>" if fp32 else f"tc::{kernel}<{d}>"

    report, current = {}, None
    for line in _build.build_log.get(source, "").splitlines():
        if "Compiling entry function" in line:
            current = short(line)
            if current:
                report[current] = {}
        elif current and "spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            report[current]["spill_bytes"] = int(stores) + int(loads)
        elif current and "Used" in line and "registers" in line:
            report[current]["registers"] = int(re.search(r"Used (\d+) registers", line)[1])
            smem = re.search(r"(\d+) bytes smem", line)
            report[current]["static_smem_bytes"] = int(smem[1]) if smem else 0
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    sass = None
    if Path(tool).exists():
        sass = subprocess.run([tool, "-sass", str(_build.library_path(source))],
                              capture_output=True, text=True, timeout=300).stdout
    current = None
    for line in (sass or "").splitlines():
        if "Function :" in line:
            current = short(line)
            if current:
                report.setdefault(current, {}).update(hmma=0, hgmma=0)
        elif current and "HGMMA" in line:
            report[current]["hgmma"] += 1
        elif current and "HMMA" in line:
            report[current]["hmma"] += 1
    for entry in report.values():
        entry.setdefault("hmma", None)
        entry.setdefault("hgmma", None)
    if source == "w8a16_gemm" and _build.library_path(source).exists():
        # route codes: 1 decode, 2 / 3 wgmma at 128 / 256 rows
        for k, code in (("tc::wgmma_kernel<1>", 2), ("tc::wgmma_kernel<2>", 3),
                        ("tc::decode_kernel", 1)):
            if k in report:
                report[k]["dynamic_smem_bytes"] = _build.load("w8a16_smem")(code)
    return report


def compile_gates(report: dict) -> None:
    """Every bf16 tensor-core kernel (``tc::``) spills nothing and holds
    HMMA or HGMMA instructions; B5's prefill kernels hold HGMMA."""
    for k, v in report.items():
        if k.startswith("tc::"):
            check(v.get("spill_bytes") in (0, None), f"{k} spills {v.get('spill_bytes')} bytes")
            check(v["hmma"] != 0 or v["hgmma"] not in (0, None),
                  f"{k} has no HMMA or HGMMA (tensor-core) instruction in its SASS")
    for k in ("tc::wgmma_kernel<1>", "tc::wgmma_kernel<2>"):
        if k in report:
            check(report[k]["hgmma"] != 0, f"{k} has no HGMMA (wgmma) instruction in its SASS")


# --- phase 2: kernels vs twins -------------------------------------------------


def flash_case(dev, b=6, h=32, hk=8, sq=512, sk=4096, d=128, pad_rows=12, pad_keys=5):
    """B1 at the largest prefill of the serve phase: 6 rows of the 512-token
    bucket attending over the 4096-token logical view; pad query rows (-1)
    and INVALID_POS keys added."""
    import torch

    from neuronx_distributed_tpu_torch.kernels.flash_attn import INVALID_POS

    g = torch.Generator(device=dev).manual_seed(11)
    bf = torch.bfloat16
    q = torch.randn((b * h, sq, d), generator=g, device=dev).to(bf)
    k = torch.randn((b * hk, sk, d), generator=g, device=dev).to(bf)
    v = torch.randn((b * hk, sk, d), generator=g, device=dev).to(bf)
    qpos = torch.arange(sq, dtype=torch.int32, device=dev).repeat(b, 1)
    qpos[:, sq - pad_rows:] = -1
    kpos = torch.arange(sk, dtype=torch.int32, device=dev).repeat(b, 1)
    kpos[:, 200:200 + pad_keys] = INVALID_POS
    return q, k, v, qpos.reshape(b, 1, sq), kpos.reshape(b, 1, sk), h, hk


# B1 at a chunk extend of the trace phase: the last 512-token chunk of a
# 3072-token prompt, queries at positions 2560..3071 over the 4096-position
# logical view, whose keys past 3071 are unwritten (zeros here)
CHUNK_QPOS0, CHUNK_LEN, CHUNK_SK = 2560, 512, 4096


def chunk_flash_case(dev, h=32, hk=8, d=128, q0=CHUNK_QPOS0, sq=CHUNK_LEN, sk=CHUNK_SK,
                     seed=16):
    """B1's arguments at the shape of one chunk extend of the trace phase
    (one row: q ``(h, sq, d)`` at positions ``q0 .. q0 + sq - 1`` over k/v
    ``(hk, sk, d)`` at positions ``0 .. sk - 1``, the keys past the chunk's
    last position zero: not yet written), bf16, the block sizes of
    ``LlamaConfig.blocks_for`` for that extend (512, 512)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    q = torch.randn((h, sq, d), generator=g, device=dev).to(bf)
    k = torch.randn((hk, sk, d), generator=g, device=dev).to(bf)
    v = torch.randn((hk, sk, d), generator=g, device=dev).to(bf)
    k[:, q0 + sq:] = 0
    v[:, q0 + sq:] = 0
    qpos = (torch.arange(sq, dtype=torch.int32, device=dev) + q0).reshape(1, 1, sq)
    kpos = torch.arange(sk, dtype=torch.int32, device=dev).reshape(1, 1, sk)
    return q, k, v, qpos, kpos, d ** -0.5, 512, 512, h // hk, h


def run_flash_chunk(dev, flush, reps=10) -> dict:
    """B1 at the chunk-extend shape (``chunk_flash_case``) against its twin
    by the element rule with the training-shape floor (or its fp64
    evaluation), the LSE absolutely; timed beside the twin, SDPA with the
    same boolean mask, and the bound."""
    import torch
    import torch.nn.functional as F

    from neuronx_distributed_tpu_torch.kernels.flash_attn import (
        flash_block_forward,
        flash_block_forward_plain,
    )

    args = chunk_flash_case(dev)
    q, k, v, qpos, kpos = args[:5]
    out, lse = flash_block_forward(*args)
    torch.cuda.synchronize()
    ref, ref_lse = flash_block_forward_plain(*args)
    r = held(out, ref, TOL_FLASH_TRAIN_FLOOR, exact=fwd_exact(*args)[0])
    check_held("flash_fwd at the chunk shape", r)
    lse_err = float((lse - ref_lse).abs().max())
    check(lse_err <= TOL_LSE, f"flash_fwd lse at the chunk shape differs from its twin by {lse_err}")
    h, hk, sq, d = q.shape[0], k.shape[0], q.shape[1], q.shape[2]
    mask = kpos.reshape(1, 1, 1, -1) <= qpos.reshape(1, 1, sq, 1)
    q4, k4, v4 = q[None], k[None], v[None]
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, attn_mask=mask, enable_gqa=True)
    visible = int(mask.sum())                           # visible (query, key) pairs a head
    seen = int(mask.any(dim=2).sum())                   # keys some query sees
    return dict(shape=f"q ({h}, {sq}, {d}) bf16 at positions {CHUNK_QPOS0}..{CHUNK_QPOS0 + sq - 1}"
                      f", k/v ({hk}, {k.shape[1]}, {d}), keys past {CHUNK_QPOS0 + sq - 1} "
                      f"unwritten",
                max_abs_err=r["max_abs_err"], lse_max_abs_err=lse_err, held={"out": r},
                tolerance=f"{REL_BF16:.4g} * |ref| + floor {TOL_FLASH_TRAIN_FLOOR:.3g}",
                ms=time_ms(lambda: flash_block_forward(*args), reps, flush),
                plain_ms=time_ms(lambda: flash_block_forward_plain(*args), 2, flush),
                library_ms=time_ms(library, reps, flush), library="SDPA, bool mask",
                # q, positions, out and LSE once; only the K/V rows some query sees
                **bound(4 * visible * h * d,
                        nbytes(q, qpos, kpos, out, lse) + 2 * hk * seen * d * k.element_size()))


def run_flash(dev, flush, reps=10):
    import torch
    import torch.nn.functional as F

    from neuronx_distributed_tpu_torch.kernels.flash_attn import (
        flash_block_forward,
        flash_block_forward_plain,
    )

    q, k, v, qp, kp, h, hk = flash_case(dev)
    bh, sq, d = q.shape
    b, sk = bh // h, k.shape[1]
    args = (q, k, v, qp, kp, d ** -0.5, 64, 64, h // hk, h)
    out, lse = flash_block_forward(*args)
    torch.cuda.synchronize()
    ref, ref_lse = flash_block_forward_plain(*args)
    err = float((out.float() - ref.float()).abs().max())
    lse_err = float((lse - ref_lse).abs().max())   # pad rows: -1e30 on both sides
    check(err <= TOL_FLASH_BF16, f"flash_fwd out differs from its twin by {err}")
    check(lse_err <= TOL_LSE, f"flash_fwd lse differs from its twin by {lse_err}")
    check(bool(torch.isfinite(out).all()), "flash_fwd produced non-finite values")
    again = flash_block_forward(*args)
    torch.cuda.synchronize()
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
          "a second launch of flash_fwd on the same inputs gave other bits")

    mask = kp.reshape(b, 1, 1, sk) <= qp.reshape(b, 1, sq, 1)    # (b, 1, sq, sk)
    q4, k4, v4 = q.reshape(b, h, sq, d), k.reshape(b, hk, sk, d), v.reshape(b, hk, sk, d)
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, attn_mask=mask, enable_gqa=True)
    pairs = int(mask.sum()) * h                         # visible (query, key) pairs
    flops = 4 * pairs * d
    # the bytes the function needs: q, positions, out and LSE once each, and
    # only the K/V rows that some query of their batch row can see (the
    # block skip reads no other tile)
    seen_keys = int(mask.any(dim=2).sum())              # over (b, key)
    moved = nbytes(q, qp, kp, out, lse) + 2 * hk * seen_keys * d * k.element_size()
    return dict(
        name="flash_fwd", route="cuda",
        source="neuronx_distributed_tpu_torch/csrc/flash_fwd.cu",
        replaces="neuronx_distributed_tpu/kernels/flash_attn.py:67",
        shape=f"q ({bh}, {sq}, {d}) bf16, k/v ({k.shape[0]}, {sk}, {d}), group {h // hk}",
        max_abs_err=err, lse_max_abs_err=lse_err, tolerance=TOL_FLASH_BF16,
        lse_tolerance=TOL_LSE, ref_max_abs=float(ref.float().abs().max()),
        rerun_bit_identical=True, visible_keys=seen_keys,
        ms=time_ms(lambda: flash_block_forward(*args), reps, flush),
        plain_ms=time_ms(lambda: flash_block_forward_plain(*args), max(2, reps // 5), flush),
        library_ms=time_ms(library, reps, flush),
        **bound(flops, moved))


SERVE_CACHE_LENS = (0, 100, 131, 255, 256, 357, 420, 531)
# beyond the serve shape: an empty and a full table (0, 4095); a row whose
# last page ends a 128-key split (127) and rows whose last page begins one
# and is partly visible (128, 133); the kernel splits at page boundaries
EDGE_CACHE_LENS = (0, 4095, 127, 128, 133, 1000, 2047, 2048)
# (case, pool, n_q, n_kv, cache lengths): the serve shape's two pools, then
# GQA groups 1 and 8 and an fp32 pool
PAGED_CASES = (("serve", "int8", 32, 8, SERVE_CACHE_LENS),
               ("group 1", "bf16", 8, 8, EDGE_CACHE_LENS),
               ("group 8", "int8", 32, 4, EDGE_CACHE_LENS),
               ("group 4", "fp32", 32, 8, EDGE_CACHE_LENS),
               ("serve", "bf16", 32, 8, SERVE_CACHE_LENS))


def paged_case(dev, pool, b=8, n_q=32, n_kv=8, hd=128, ps=16, max_seq_len=4096,
               cache_lens=SERVE_CACHE_LENS):
    """B2 at the serving decode shape (by default): 8 bf16 query rows,
    ragged cache lengths over a 4096-token table, stale bytes in every page;
    ``pool`` is "bf16", "int8" or "fp32"."""
    import torch

    from neuronx_distributed_tpu_torch.inference.paged_kernel import quantize_kv_pages

    g = torch.Generator(device=dev).manual_seed(12)
    ppseq = max_seq_len // ps
    pages = b * ppseq + b
    pool_dtype = torch.float32 if pool == "fp32" else torch.bfloat16
    q = torch.randn((b, 1, n_q, hd), generator=g, device=dev).to(torch.bfloat16)
    kf = torch.randn((pages, ps, n_kv, hd), generator=g, device=dev).to(pool_dtype)
    vf = torch.randn((pages, ps, n_kv, hd), generator=g, device=dev).to(pool_dtype)
    table = torch.randperm(pages, generator=g, device=dev)[: b * ppseq].reshape(b, ppseq)
    cache_len = torch.tensor(cache_lens[:b], dtype=torch.int32, device=dev)
    kw = {}
    if pool == "int8":
        kf, ks = quantize_kv_pages(kf)
        vf, vs = quantize_kv_pages(vf)
        kw = dict(k_scale=ks, v_scale=vs)
    return (q, kf, vf, table.int().contiguous(), cache_len), kw


def run_paged(dev, flush, reps=20):
    """B2 against its twin on every case of ``PAGED_CASES``, each element
    within its limit of the twin or of the fp64 evaluation (``held`` with
    ``decode_exact``); a second launch at the serve shape must give the
    same bits; timed at the serve shape with the bf16 pool."""
    import torch
    import torch.nn.functional as F

    from neuronx_distributed_tpu_torch.inference.paged_kernel import (
        paged_decode_attention,
        paged_decode_attention_plain,
    )

    cases, shapes = {}, {}
    for case, pool, n_q, n_kv, lens in PAGED_CASES:   # the serve bf16 case last: it is timed
        args, kw = paged_case(dev, pool, n_q=n_q, n_kv=n_kv, cache_lens=lens)
        out = paged_decode_attention(*args, **kw)
        torch.cuda.synchronize()
        ref = paged_decode_attention_plain(*args, **kw)
        name = f"{case}, {pool} pool"
        r = held(out, ref, TOL_PAGED_FLOOR, exact=decode_exact(*args, **kw))
        cases[name] = {"out": r}
        shapes[name] = (f"q {tuple(args[0].shape)} bf16, {pool} pools {tuple(args[1].shape)}, "
                        f"cache_len {list(lens)}")
        check_held(f"paged_decode ({name})", r)
        check(bool(torch.isfinite(out).all()), f"paged_decode ({name}) produced non-finite values")
        del out, ref
    again = [paged_decode_attention(*args) for _ in range(2)]
    torch.cuda.synchronize()
    check(torch.equal(*again), "a second launch of paged_decode on the same inputs gave other bits")
    q, kp, vp, table, cache_len = args
    b, _, n_q, hd = q.shape
    _, ps, n_kv, _ = kp.shape
    s_max = table.shape[1] * ps

    def library():
        k_all = kp[table.long()].reshape(b, s_max, n_kv, hd).transpose(1, 2)
        v_all = vp[table.long()].reshape(b, s_max, n_kv, hd).transpose(1, 2)
        mask = (torch.arange(s_max, device=dev)[None, :] <= cache_len[:, None].long())
        return F.scaled_dot_product_attention(q.transpose(1, 2), k_all, v_all,
                                              attn_mask=mask[:, None, None, :],
                                              enable_gqa=True)

    # the work this run's data needs: the pages up to each row's cache_len
    lens = cache_len.long().cpu()
    pages_read = int(((lens // ps) + 1).sum())
    page_bytes = ps * n_kv * hd * kp.element_size()
    # K and V pages and their block-table entries read, q read, out written
    moved = 2 * pages_read * page_bytes + pages_read * 4 + 2 * nbytes(q) + nbytes(cache_len)
    flops = 4 * n_q * hd * int((lens + 1).sum())
    return dict(
        name="paged_decode", route="cuda",
        source="neuronx_distributed_tpu_torch/csrc/paged_decode.cu",
        replaces="neuronx_distributed_tpu/inference/paged_kernel.py:102",
        shape=shapes["serve, bf16 pool"], case_shapes=shapes,
        max_abs_err=max(r["out"]["max_abs_err"] for r in cases.values()),
        tolerance=f"{REL_BF16:.4g} * |ref| + floor {TOL_PAGED_FLOOR:.3g}", held=cases,
        rerun_bit_identical=True,
        ms=time_ms(lambda: paged_decode_attention(*args), reps, flush),
        plain_ms=time_ms(lambda: paged_decode_attention_plain(*args), max(2, reps // 5), flush),
        library_ms=time_ms(library, reps, flush),
        **bound(flops, moved))


def bound(flops: float, moved: float, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    t_ops, t_bytes = flops / peak_flops * 1e3, moved / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=moved)


def flash_bwd_case(dev, pads: bool, b=2, h=32, hk=8, s=4096, d=128, pad_rows=100, pad_keys=7):
    """B1 and B3a/B3b at the training shape: the attention of one Llama-3-8B
    layer over 2 x 4096 tokens, causal, bf16. ``pads`` adds pad query rows
    (-1) at the end of batch row 0 and INVALID_POS keys in batch row 1 (the
    edge rules). Returns the forward's arguments and dO."""
    import torch

    from neuronx_distributed_tpu_torch.kernels.flash_attn import INVALID_POS

    g = torch.Generator(device=dev).manual_seed(13)
    bf = torch.bfloat16
    q = torch.randn((b * h, s, d), generator=g, device=dev).to(bf)
    k = torch.randn((b * hk, s, d), generator=g, device=dev).to(bf)
    v = torch.randn((b * hk, s, d), generator=g, device=dev).to(bf)
    do = torch.randn((b * h, s, d), generator=g, device=dev).to(bf)
    qpos = torch.arange(s, dtype=torch.int32, device=dev).repeat(b, 1)
    kpos = qpos.clone()
    if pads:
        qpos[0, s - pad_rows:] = -1
        kpos[1, 1000:1000 + pad_keys] = INVALID_POS
    qpos, kpos = qpos.reshape(b, 1, s), kpos.reshape(b, 1, s)
    return (q, k, v, qpos, kpos, d ** -0.5, 64, 64, h // hk, h), do


def bwd_exact(q, k, v, do, lse, delta, qpos, kpos, sm_scale, block_q, block_k, group, h,
              chunk=256):
    """The backward in fp64 from the same bf16 operands, LSE and delta, with
    the twin's roundings (p to dO's dtype before dV, dS to q's dtype before
    dK and dQ) and no other: ``(dq, dk, dv)`` in fp64, unrounded."""
    import torch

    bh, sq, d = q.shape
    sk, b = k.shape[1], bh // h
    kvrow = torch.arange(bh, device=q.device) // group
    qp = qpos.reshape(b, sq).repeat_interleave(h, dim=0)
    kp = kpos.reshape(b, sk).repeat_interleave(h, dim=0)
    f64 = torch.float64
    qd, dod = q.to(f64), do.to(f64)
    lse_, delta_ = lse.to(f64)[..., None], delta.to(f64)[..., None]
    dq = torch.zeros(q.shape, dtype=f64, device=q.device)
    dk = torch.zeros((bh, sk, d), dtype=f64, device=q.device)
    dv = torch.zeros_like(dk)
    for k0 in range(0, sk, chunk):
        kj, vj = k[kvrow, k0:k0 + chunk].to(f64), v[kvrow, k0:k0 + chunk].to(f64)
        valid = kp[:, None, k0:k0 + chunk] <= qp[:, :, None]
        p = torch.where(valid, torch.exp(torch.einsum("bqd,bkd->bqk", qd, kj) * sm_scale - lse_),
                        0.0)
        ds = p * (torch.einsum("bqd,bkd->bqk", dod, vj) - delta_) * sm_scale
        p, ds = p.to(do.dtype).to(f64), ds.to(q.dtype).to(f64)
        dv[:, k0:k0 + chunk] = torch.einsum("bqk,bqd->bkd", p, dod)
        dk[:, k0:k0 + chunk] = torch.einsum("bqk,bqd->bkd", ds, qd)
        dq += torch.einsum("bqk,bkd->bqd", ds, kj)
        del valid, p, ds
    fold = lambda t: t.reshape(-1, group, sk, d).sum(1)  # noqa: E731
    return dq, fold(dk), fold(dv)


def fwd_exact(q, k, v, qpos, kpos, sm_scale, block_q, block_k, group, h):
    """The forward in fp64 from the same operands, with the twin's rounding
    of p (to v's dtype, against the running max of each ``block_k`` key
    block, before the PV product) and no other: ``(out, lse)`` in fp64,
    unrounded. A fully masked row gives out 0 and LSE -1e30, as the twin."""
    import torch

    bh, sq, d = q.shape
    sk, b = k.shape[1], bh // h
    block_k = min(block_k, sk)
    kvrow = torch.arange(bh, device=q.device) // group
    qp = qpos.reshape(b, sq).repeat_interleave(h, dim=0)
    kp = kpos.reshape(b, sk).repeat_interleave(h, dim=0)
    f64 = torch.float64
    qd = q.to(f64)
    m = torch.full((bh, sq), -1e30, dtype=f64, device=q.device)
    l = torch.zeros((bh, sq), dtype=f64, device=q.device)
    acc = torch.zeros((bh, sq, d), dtype=f64, device=q.device)
    for k0 in range(0, sk, block_k):
        kj, vj = k[kvrow, k0:k0 + block_k].to(f64), v[kvrow, k0:k0 + block_k].to(f64)
        valid = kp[:, None, k0:k0 + block_k] <= qp[:, :, None]
        s = torch.where(valid, torch.einsum("bqd,bkd->bqk", qd, kj) * sm_scale, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bqk,bkd->bqd", p.to(v.dtype).to(f64), vj)
        m = m_new
        del valid, s, p
    l_safe = torch.where(l == 0.0, 1.0, l)
    return acc / l_safe[..., None], m + torch.log(l_safe)


def decode_exact(q, k_pages, v_pages, block_table, cache_len, *, k_scale=None, v_scale=None,
                 sm_scale=None):
    """Paged decode in fp64 from the same operands (int8 pages dequantized
    in fp32 as the twin does: the scale multiply rounded to fp32, nothing
    else): the rows' logical views gathered, one softmax over positions
    0..cache_len. The twin rounds no intermediate to a narrower type, so
    this is the exact function. Returns (b, 1, n_heads, hd) in fp64."""
    import torch

    b, _, n_q, hd = q.shape
    num_pages, ps, n_kv, _ = k_pages.shape
    group = n_q // n_kv
    if sm_scale is None:
        sm_scale = 1.0 / (hd ** 0.5)
    s_max = block_table.shape[1] * ps
    lpos = torch.arange(s_max, device=q.device)
    page = block_table[:, lpos // ps].long()                    # (b, S)
    flat = page * ps + (lpos % ps)[None, :]
    kv = []
    for pool, scale in ((k_pages, k_scale), (v_pages, v_scale)):
        x = pool.reshape(num_pages * ps, n_kv, hd)[flat].float()   # (b, S, n_kv, hd)
        if scale is not None:
            x = x * scale.reshape(num_pages, n_kv)[page][..., None]
        kv.append(x.to(torch.float64))
    q4 = q[:, 0].reshape(b, n_kv, group, hd).to(torch.float64)
    s = torch.einsum("bngd,bsnd->bngs", q4, kv[0]) * sm_scale
    valid = (lpos[None, :] <= cache_len[:, None].long())[:, None, None, :]
    p = torch.softmax(torch.where(valid, s, -torch.inf), dim=-1)
    return torch.einsum("bngs,bsnd->bngd", p, kv[1]).reshape(b, 1, n_q, hd)


def ragged_bwd_case(dev, b=2, h=4, sq=200, sk=328, d=64, pad_rows=5, pad_keys=3):
    """B3a/B3b at a small ragged shape: head_dim 64, group 1, sequence
    lengths that are not multiples of the kernels' 64-row tiles (zero-filled
    tile rows), pad query rows (-1) in batch row 0 and INVALID_POS keys in
    batch row 1; causal, queries bottom-aligned. The block sizes are the
    whole lengths (the twins' one shape contract). Returns the backward's
    arguments under the twin's own LSE and delta."""
    import torch

    from neuronx_distributed_tpu_torch.kernels.flash_attn import (
        INVALID_POS,
        flash_block_forward_plain,
    )

    g = torch.Generator(device=dev).manual_seed(15)
    bf = torch.bfloat16
    q, do = (torch.randn((b * h, sq, d), generator=g, device=dev).to(bf) for _ in range(2))
    k, v = (torch.randn((b * h, sk, d), generator=g, device=dev).to(bf) for _ in range(2))
    qpos = (torch.arange(sq, dtype=torch.int32, device=dev) + (sk - sq)).repeat(b, 1)
    kpos = torch.arange(sk, dtype=torch.int32, device=dev).repeat(b, 1)
    qpos[0, sq - pad_rows:] = -1
    kpos[1, 100:100 + pad_keys] = INVALID_POS
    qpos, kpos = qpos.reshape(b, 1, sq), kpos.reshape(b, 1, sk)
    out, lse = flash_block_forward_plain(q, k, v, qpos, kpos, d ** -0.5, sq, sk, 1, h)
    delta = (do.float() * out.float()).sum(-1)
    return (q, k, v, do, lse, delta, qpos, kpos, d ** -0.5, sq, sk, 1, h)


def run_flash_bwd(dev, flush, reps=5):
    """At the training shape, on the pad case and the causal case: B1 (out
    and LSE) against its twin, then B3a (dK/dV) and B3b (dQ) against theirs
    under the forward kernel's own LSE and delta = rowsum(dO * O), each
    gradient also against its fp64 evaluation (``held``); a second launch
    of both kernels must give the same bits; timed on the causal case. Then
    B3a/B3b at a small ragged shape (``ragged_bwd_case``) under the same
    rule. One library yardstick for B3a and B3b: SDPA forward plus backward
    on the same q/k/v/dO (timed only). Returns B3a's and B3b's kernel
    entries and B1's readings at this shape."""
    import torch
    import torch.nn.functional as F

    from neuronx_distributed_tpu_torch.kernels.flash_attn import (
        flash_block_forward,
        flash_block_forward_plain,
        flash_bwd_dkdv,
        flash_bwd_dkdv_plain,
        flash_bwd_dq,
        flash_bwd_dq_plain,
    )

    floors = {"out": TOL_FLASH_TRAIN_FLOOR, "dq": TOL_DQ_FLOOR, "dk": TOL_DK_FLOOR,
              "dv": TOL_DV_FLOOR}

    def grads(args):
        return (flash_bwd_dq(*args), *flash_bwd_dkdv(*args))

    def held_grads(args, got, r):
        want = (flash_bwd_dq_plain(*args), *flash_bwd_dkdv_plain(*args))
        exact = bwd_exact(*args)
        for name, a, w, x in zip(("dq", "dk", "dv"), got, want, exact):
            r[name] = held(a, w, floors[name], exact=x)
        del want, exact

    readings, bit_identical = {}, None
    for case in ("pads", "causal"):   # causal last: its inputs are the ones timed
        fwd, do = flash_bwd_case(dev, case == "pads")
        out, lse = flash_block_forward(*fwd)
        torch.cuda.synchronize()
        ref, ref_lse = flash_block_forward_plain(*fwd)
        r = {"out": held(out, ref, floors["out"], exact=fwd_exact(*fwd)[0])}
        r["lse"] = dict(max_abs_err=float((lse - ref_lse).abs().max()), tolerance=TOL_LSE)
        del ref, ref_lse
        q, k, v, qpos, kpos = fwd[:5]
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, do, lse, delta, qpos, kpos, *fwd[5:])
        got = grads(args)
        torch.cuda.synchronize()
        for name, a in zip(("dq", "dk", "dv"), got):
            check(bool(torch.isfinite(a).all()), f"flash backward {name} ({case}) is not finite")
        held_grads(args, got, r)
        if case == "pads":   # pad keys of batch row 1 (kv rows hk..2hk) get exactly zero dK, dV
            hk = k.shape[0] // 2
            check(float(got[1][hk:, 1000:1007].abs().max()) == 0.0 and
                  float(got[2][hk:, 1000:1007].abs().max()) == 0.0,
                  "pad keys got a nonzero dK or dV")
        else:   # no atomics, a fixed order of sums: a rerun gives the same bits
            again = grads(args)
            torch.cuda.synchronize()
            bit_identical = all(torch.equal(a, b_) for a, b_ in zip(got, again))
            check(bit_identical, "a second launch of flash_bwd_dq/flash_bwd_dkdv on the same "
                                 "inputs gave other bits")
            del again
        check(bool(torch.isfinite(out).all()), f"flash_fwd ({case}) produced non-finite values")
        if case == "causal":   # B1 as well: a rerun gives the same bits
            again = flash_block_forward(*fwd)
            torch.cuda.synchronize()
            check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
                  "a second launch of flash_fwd at the training shape gave other bits")
            del again
        readings[case] = r
        del got, out
    ragged = ragged_bwd_case(dev)
    ragged_shape = (f"q {tuple(ragged[0].shape)} bf16, k/v {tuple(ragged[1].shape)}, group "
                    f"{ragged[-2]}, causal, pad rows and keys")
    got = grads(ragged)
    torch.cuda.synchronize()
    readings["ragged"] = r = {}
    held_grads(ragged, got, r)
    h = ragged[-1]   # kv rows h..2h are batch row 1, whose keys 100..102 are pads
    check(float(got[1][h:, 100:103].abs().max()) == 0.0 and
          float(got[2][h:, 100:103].abs().max()) == 0.0,
          "pad keys got a nonzero dK or dV (ragged case)")
    del got
    for case, r in readings.items():
        if "out" in r:
            check_held(f"flash_fwd out at the training shape ({case})", r["out"])
            check(r["lse"]["max_abs_err"] <= TOL_LSE,
                  f"flash_fwd lse at the training shape ({case}) differs from its twin by "
                  f"{r['lse']['max_abs_err']}")
        for name, kernel in (("dq", "flash_bwd_dq"), ("dk", "flash_bwd_dkdv"),
                             ("dv", "flash_bwd_dkdv")):
            check_held(f"{kernel} {name} ({case})", r[name])
    worst = {name: max(r[name]["max_abs_err"] for r in readings.values() if name in r)
             for name in ("out", "lse", "dq", "dk", "dv")}
    by_case = lambda *names: {c: {n: r[n] for n in names if n in r}  # noqa: E731
                              for c, r in readings.items() if names[0] in r}

    q, k, v, do, lse, delta, qpos, kpos, _, _, _, group, h = args
    bh, s, d = q.shape
    b, hk = bh // h, k.shape[0] // (bh // h)
    mask = kpos.reshape(b, 1, s) <= qpos.reshape(b, s, 1)          # (b, sq, sk)
    pairs = int(mask.sum()) * h                                      # visible (query, key) pairs
    common = nbytes(q, k, v, do, lse, delta, qpos, kpos)
    q4, k4, v4 = (t.reshape(b, -1, s, d).detach().requires_grad_(True) for t in (q, k, v))
    do4 = do.reshape(b, h, s, d)

    def library():
        o = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True, enable_gqa=True)
        return torch.autograd.grad(o, (q4, k4, v4), do4)

    library_ms = time_ms(library, reps, flush)
    shape = f"q ({bh}, {s}, {d}) bf16, k/v ({k.shape[0]}, {s}, {d}), group {group}, causal"
    note = "SDPA forward + backward (both kernels' work and the forward's)"
    limit = lambda *names: f"{REL_BF16:.4g} * |ref| + floor (" + ", ".join(  # noqa: E731
        f"{n} {floors[n]:.3g}" for n in names) + ")"

    def entry(name, line, names, ms, plain_ms, flops, moved):
        e = dict(
            name=name, route="cuda", source="neuronx_distributed_tpu_torch/csrc/flash_bwd.cu",
            replaces=f"neuronx_distributed_tpu/kernels/flash_attn.py:{line}", shape=shape,
            max_abs_err=max(worst[n] for n in names),
            **{f"{n}_max_abs_err": worst[n] for n in names if len(names) > 1},
            tolerance=limit(*names), held=by_case(*names), ragged_shape=ragged_shape,
            rerun_bit_identical=bit_identical,
            ms=ms, plain_ms=plain_ms, library_ms=library_ms, library=note,
            **bound(flops, moved))
        e.update(tflops=flops / (ms * 1e-3) / 1e12, bound_share=e["bound_ms"] / ms)
        return e

    dkdv = entry("flash_bwd_dkdv", 122, ("dk", "dv"),
                 time_ms(lambda: flash_bwd_dkdv(*args), reps, flush),
                 time_ms(lambda: flash_bwd_dkdv_plain(*args), 1, flush),
                 # S, dP, dV and dK products: 8 * d operations per visible pair
                 8 * d * pairs, common + 2 * nbytes(k))
    dq = entry("flash_bwd_dq", 175, ("dq",),
               time_ms(lambda: flash_bwd_dq(*args), reps, flush),
               time_ms(lambda: flash_bwd_dq_plain(*args), 1, flush),
               # S, dP and dQ products: 6 * d operations per visible pair
               6 * d * pairs, common + nbytes(q))
    # B1 alone at this shape (forward only): its own time, TFLOP/s and bound
    # share, and SDPA's forward as its library yardstick
    qf4, kf4, vf4 = (t.reshape(b, -1, s, d) for t in (q, k, v))
    fwd_ms = time_ms(lambda: flash_block_forward(*fwd), reps, flush)
    fwd_flops = 4 * d * pairs
    fwd_train = dict(shape=shape, max_abs_err=worst["out"], lse_max_abs_err=worst["lse"],
                     tolerance=limit("out"), lse_tolerance=TOL_LSE, held=by_case("out", "lse"),
                     ms=fwd_ms, plain_ms=time_ms(lambda: flash_block_forward_plain(*fwd), 1, flush),
                     library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                         qf4, kf4, vf4, is_causal=True, enable_gqa=True), reps, flush),
                     library="SDPA forward, is_causal, enable_gqa",
                     # q, k, v and the positions read; out and LSE written
                     **bound(fwd_flops, nbytes(q, k, v, qpos, kpos, q, lse)))
    fwd_train.update(tflops=fwd_flops / (fwd_ms * 1e-3) / 1e12,
                     bound_share=fwd_train["bound_ms"] / fwd_ms)
    return [dkdv, dq], fwd_train


# gpt_neox_20b's head_dim, one more below 128 and one above that the kernels
# are not built for (each zero-padded), and the widest built one
HEAD_DIM_CASES = (96, 80, 160, 256)


def head_dim_floors(d: int) -> dict:
    """The element rule's floor per output at head dim ``d``: the 128-wide
    constants up to 128, the wide ones for dQ, dK and B2 above."""
    wide = d > 128
    return dict(out=TOL_FLASH_TRAIN_FLOOR, dv=TOL_DV_FLOOR,
                dq=TOL_DQ_FLOOR_WIDE if wide else TOL_DQ_FLOOR,
                dk=TOL_DK_FLOOR_WIDE if wide else TOL_DK_FLOOR,
                paged=TOL_PAGED_FLOOR_WIDE if wide else TOL_PAGED_FLOOR)


def run_head_dims(dev, flush=None, reps=5) -> dict:
    """B1, B3a/B3b and B2 at head dims other than 128: B1 and B3 run the
    64-, 128- or 256-wide builds, zero-padded by their wrappers below a
    built width (the softmax scale from the unpadded d); B2 reads a pool row
    with a part of a 16- or 32-lane group (hd 96 bf16: 12 of 16), or, fp32
    at 256, with all 32 lanes twice. One layer's causal attention over
    2 x 1024 tokens with pad rows and pad keys, and the serve-shape decode
    over bf16 and int8 pools (and fp32 at 256); every output held by the
    element rule against its twin or its fp64 evaluation, with the floors of
    ``head_dim_floors``. Given ``flush``, the 256-wide builds are timed at
    these shapes beside their twins, a library call and their bounds."""
    import torch

    from neuronx_distributed_tpu_torch.inference.paged_kernel import (
        paged_decode_attention,
        paged_decode_attention_plain,
    )
    from neuronx_distributed_tpu_torch.kernels.flash_attn import (
        flash_block_forward,
        flash_block_forward_plain,
        flash_bwd_dkdv,
        flash_bwd_dkdv_plain,
        flash_bwd_dq,
        flash_bwd_dq_plain,
    )

    readings = {}
    for d in HEAD_DIM_CASES:
        floors = head_dim_floors(d)
        fwd, do = flash_bwd_case(dev, True, s=1024, d=d)
        out, lse = flash_block_forward(*fwd)
        torch.cuda.synchronize()
        ref, ref_lse = flash_block_forward_plain(*fwd)
        r = {"out": held(out, ref, floors["out"], exact=fwd_exact(*fwd)[0]),
             "lse": dict(max_abs_err=float((lse - ref_lse).abs().max()), tolerance=TOL_LSE)}
        check(r["lse"]["max_abs_err"] <= TOL_LSE, f"flash_fwd lse at head_dim {d} differs from "
                                                  f"its twin by {r['lse']['max_abs_err']}")
        q, k, v, qpos, kpos = fwd[:5]
        args = (q, k, v, do, lse, (do.float() * out.float()).sum(-1), qpos, kpos, *fwd[5:])
        got = (flash_bwd_dq(*args), *flash_bwd_dkdv(*args))
        torch.cuda.synchronize()
        want = (flash_bwd_dq_plain(*args), *flash_bwd_dkdv_plain(*args))
        for name, a, w, x in zip(("dq", "dk", "dv"), got, want, bwd_exact(*args)):
            check(bool(torch.isfinite(a).all()), f"flash backward {name} at head_dim {d} is not "
                                                 "finite")
            r[name] = held(a, w, floors[name], exact=x)
        del got, want, ref
        pools = ("bf16", "int8", "fp32") if d == 256 else ("bf16", "int8")
        for pool in pools:
            pargs, kw = paged_case(dev, pool, hd=d)
            o = paged_decode_attention(*pargs, **kw)
            torch.cuda.synchronize()
            r[f"paged {pool}"] = held(o, paged_decode_attention_plain(*pargs, **kw),
                                      floors["paged"], exact=decode_exact(*pargs, **kw))
        for name, x in r.items():
            if "floor" in x:
                check_held(f"{name} at head_dim {d}", x)
        readings[d] = dict(
            flash_shape=f"q {tuple(q.shape)} bf16, k/v {tuple(k.shape)}, causal, pad rows and keys",
            paged_shape=f"q {tuple(pargs[0].shape)} bf16, pools {tuple(pargs[1].shape)}",
            held=r)
        if flush is not None and d == 256:
            readings[d]["timed"] = _time_wide(fwd, do, out, lse, args, flush, reps)
        del out, lse
    return readings


def _time_wide(fwd, do, out, lse, args, flush, reps) -> dict:
    """The 256-wide builds at the head-dim shapes: ms beside the twin, a
    library call and the bound (operations of the causal attention; B2 at the
    serve decode shape over a bf16 pool, bytes)."""
    import torch
    import torch.nn.functional as F

    from neuronx_distributed_tpu_torch.inference.paged_kernel import (
        paged_decode_attention,
        paged_decode_attention_plain,
    )
    from neuronx_distributed_tpu_torch.kernels.flash_attn import (
        flash_block_forward,
        flash_block_forward_plain,
        flash_bwd_dkdv,
        flash_bwd_dkdv_plain,
        flash_bwd_dq,
        flash_bwd_dq_plain,
    )

    q, k, v, qpos, kpos = fwd[:5]
    bh, s, d = q.shape
    b = qpos.shape[0]
    mask = kpos.reshape(b, 1, 1, s) <= qpos.reshape(b, 1, s, 1)
    pairs = int(mask.sum()) * (bh // b)
    q4, k4, v4 = (t.reshape(b, -1, s, d) for t in (q, k, v))
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q4, k4, v4))
    do4 = do.reshape(b, -1, s, d)

    def sdpa_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, enable_gqa=True)
        return torch.autograd.grad(o, (qg, kg, vg), do4)

    bwd_ms = time_ms(sdpa_bwd, reps, flush)
    common = nbytes(q, k, v, do, lse, args[5], qpos, kpos)
    shape = f"q {tuple(q.shape)} bf16, k/v {tuple(k.shape)}, causal, pad rows and keys"
    timed = {
        "flash_fwd": dict(
            shape=shape, ms=time_ms(lambda: flash_block_forward(*fwd), reps, flush),
            plain_ms=time_ms(lambda: flash_block_forward_plain(*fwd), 1, flush),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, enable_gqa=True), reps, flush),
            library="SDPA forward, bool mask",
            **bound(4 * d * pairs, nbytes(q, k, v, qpos, kpos, out, lse))),
        "flash_bwd_dkdv": dict(
            shape=shape, ms=time_ms(lambda: flash_bwd_dkdv(*args), reps, flush),
            plain_ms=time_ms(lambda: flash_bwd_dkdv_plain(*args), 1, flush),
            library_ms=bwd_ms, library="SDPA forward + backward, bool mask",
            **bound(8 * d * pairs, common + 2 * nbytes(k))),
        "flash_bwd_dq": dict(
            shape=shape, ms=time_ms(lambda: flash_bwd_dq(*args), reps, flush),
            plain_ms=time_ms(lambda: flash_bwd_dq_plain(*args), 1, flush),
            library_ms=bwd_ms, library="SDPA forward + backward, bool mask",
            **bound(6 * d * pairs, common + nbytes(q))),
    }
    pargs, _ = paged_case(q.device, "bf16", hd=d)
    pq, kp, vp, table, cache_len = pargs
    pb, _, n_q, hd = pq.shape
    _, ps, n_kv, _ = kp.shape
    s_max = table.shape[1] * ps

    def library():
        k_all = kp[table.long()].reshape(pb, s_max, n_kv, hd).transpose(1, 2)
        v_all = vp[table.long()].reshape(pb, s_max, n_kv, hd).transpose(1, 2)
        m = torch.arange(s_max, device=pq.device)[None, :] <= cache_len[:, None].long()
        return F.scaled_dot_product_attention(pq.transpose(1, 2), k_all, v_all,
                                              attn_mask=m[:, None, None, :], enable_gqa=True)

    lens = cache_len.long().cpu()
    pages_read = int(((lens // ps) + 1).sum())
    timed["paged_decode"] = dict(
        shape=f"q {tuple(pq.shape)} bf16, bf16 pools {tuple(kp.shape)}",
        ms=time_ms(lambda: paged_decode_attention(*pargs), reps, flush),
        plain_ms=time_ms(lambda: paged_decode_attention_plain(*pargs), 2, flush),
        library_ms=time_ms(library, reps, flush), library="gather + SDPA",
        **bound(4 * n_q * hd * int((lens + 1).sum()),
                2 * pages_read * ps * n_kv * hd * kp.element_size() + pages_read * 4
                + 2 * nbytes(pq) + nbytes(cache_len)))
    return timed


def run_adamw(dev, flush, reps=10):
    """B4 at the largest leaf of the training phase, the embedding (128256 x
    4096): bf16 grad and param, fp32 mu, nu and master. Kernel and twin run
    on copies of the same state; the library yardstick is
    ``torch._fused_adamw_`` on the fp32 master, mu and nu with an fp32 grad
    (timed only; it has no clip scale and writes no bf16 param)."""
    import torch

    from neuronx_distributed_tpu_torch.optimizer.fused_kernel import (
        fused_adamw_leaf,
        fused_adamw_leaf_plain,
    )

    g_ = torch.Generator(device=dev).manual_seed(14)
    shape = (128256, 4096)
    g = torch.randn(shape, generator=g_, device=dev).to(torch.bfloat16)
    state = [torch.randn(shape, generator=g_, device=dev) * 0.1,
             torch.rand(shape, generator=g_, device=dev) * 0.01,
             torch.randn(shape, generator=g_, device=dev)]
    twin_state = [t.clone() for t in state]
    # [clip_scale, lr, 1 - 0.9**3, 1 - 0.999**3]: the third step
    scalars = torch.tensor([[0.7, 1e-4, 1 - 0.9 ** 3, 1 - 0.999 ** 3]], device=dev)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01, p_dtype=torch.bfloat16)
    *_, p = fused_adamw_leaf(g, *state, scalars, **kw)
    torch.cuda.synchronize()
    *_, p_ref = fused_adamw_leaf_plain(g, *twin_state, scalars, **kw)
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(state + [p], twin_state + [p_ref]))
    check(err <= TOL_ADAMW, f"fused_adamw differs from its twin by {err}")
    check(bool(torch.isfinite(state[2]).all()), "fused_adamw produced a non-finite master")
    del twin_state, p_ref
    g32 = g.float()
    steps = [torch.tensor(3.0, device=dev)]

    def library():
        torch._fused_adamw_([state[2]], [g32], [state[0]], [state[1]], [], steps, lr=1e-4,
                            beta1=0.9, beta2=0.999, weight_decay=0.01, eps=1e-8,
                            amsgrad=False, maximize=False)

    n = g.numel()
    return dict(
        name="fused_adamw", route="cuda", source="neuronx_distributed_tpu_torch/csrc/adamw.cu",
        replaces="neuronx_distributed_tpu/optimizer/fused_kernel.py:34",
        shape=f"{shape[0]} x {shape[1]} = {n} elements, bf16 grad and param, fp32 mu/nu/master",
        max_abs_err=err, tolerance=TOL_ADAMW,
        ms=time_ms(lambda: fused_adamw_leaf(g, *state, scalars, **kw), reps, flush),
        plain_ms=time_ms(lambda: fused_adamw_leaf_plain(g, *state, scalars, **kw), 2, flush),
        library_ms=time_ms(library, reps, flush),
        library="torch._fused_adamw_ on the fp32 master/mu/nu with an fp32 grad: no clip "
                "scale, no bf16 param write",
        # read g, mu, nu, master; write mu, nu, master, p (28 bytes an element);
        # 17 fp32 operations an element on the CUDA cores
        **bound(17 * n, nbytes(g, p) + 2 * nbytes(*state), PEAK_FP32_FLOPS))


# B5 at the shapes of phase 4h's paths: (case, dtype, batch entries, rows, K, N,
# experts, x shared by the batch (all_experts), routed idx (selective), per tensor)
W8A16_CASES = (
    ("dense decode, 4096 -> 14336", "bf16", 1, 8, 4096, 14336, 1, False, False, False),
    ("dense decode, 14336 -> 4096", "bf16", 1, 8, 14336, 4096, 1, False, False, False),
    ("dense prefill, 4096 -> 14336", "bf16", 1, 512, 4096, 14336, 1, False, False, False),
    ("all_experts decode, 8 x 8 rows", "bf16", 8, 8, 4096, 14336, 8, True, False, False),
    ("selective, 16 pairs x 1 row", "bf16", 16, 1, 4096, 14336, 8, False, True, False),
    ("per tensor, dense decode", "bf16", 1, 8, 4096, 14336, 1, False, False, True),
    ("fp32, 64 rows, 4096 -> 4096", "fp32", 1, 64, 4096, 4096, 1, False, False, False),
    # the products of the inserts: k and v, the down projection, 8 rows x
    # the 512 bucket, Mixtral's all_experts prefill, a ragged prompt
    ("dense prefill, 4096 -> 1024", "bf16", 1, 512, 4096, 1024, 1, False, False, False),
    ("dense prefill, 14336 -> 4096", "bf16", 1, 512, 14336, 4096, 1, False, False, False),
    ("dense prefill, 4096 rows, 4096 -> 14336", "bf16", 1, 4096, 4096, 14336, 1, False, False,
     False),
    ("all_experts prefill, 8 x 512 rows", "bf16", 8, 512, 4096, 14336, 8, True, False, False),
    ("ragged prefill, 300 rows, 4096 -> 14336", "bf16", 1, 300, 4096, 14336, 1, False, False,
     False),
    # the 128-token bucket's inserts (a prompt of at most 128 tokens goes in
    # alone as paged_insert_r1_b128): every layer's products at 128 rows
    ("insert prefill, 128 rows, 4096 -> 14336", "bf16", 1, 128, 4096, 14336, 1, False, False,
     False),
    ("insert prefill, 128 rows, 4096 -> 1024", "bf16", 1, 128, 4096, 1024, 1, False, False,
     False),
    ("insert prefill, 128 rows, 14336 -> 4096", "bf16", 1, 128, 14336, 4096, 1, False, False,
     False),
    ("all_experts prefill, 8 x 128 rows", "bf16", 8, 128, 4096, 14336, 8, True, False, False),
)
W8A16_TIMED = "dense decode, 4096 -> 14336"
# bf16: one last place at the value (the twin's and the kernel's fp32 sums
# round to bf16 on either side of a rounding point) plus a floor far below
# the outputs' median |ref| (about 0.6); fp32: summation order over K = 4096
TOL_W8A16_FLOOR = 2e-3
REL_FP32 = 1e-5
TOL_W8A16_FP32_FLOOR = 1e-5


def w8a16_case(dev, dtype, B, M, K, N, E, shared, routed, per_tensor, seed=21):
    """Seeded operands of one B5 case: x ~ N(0, 1), weights ~ N(0, 1/K)
    quantized per output channel (or per tensor) with the port's rule."""
    import torch

    from neuronx_distributed_tpu_torch.quantization.core import quantize_tensor

    g = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    xs = torch.randn((1 if shared else B, M, K), generator=g, device=dev).to(dt)
    x = xs.expand(B, M, K) if shared else xs
    w = torch.randn((E, K, N), generator=g, device=dev) / math.sqrt(K)
    q, scale = quantize_tensor(w, axis=None if per_tensor else 1)
    del w
    if routed:
        idx = torch.randint(0, E, (B,), generator=g, device=dev, dtype=torch.int32)
    else:
        idx = torch.arange(B, dtype=torch.int32, device=dev)
    return x, q, scale, idx


def w8a16_exact(x, q, scale, idx):
    """fp64 evaluation with the twin's rounding of the weights to x's dtype."""
    import torch

    from neuronx_distributed_tpu_torch.kernels.w8a16 import dequantize

    i = idx.long()
    w = dequantize(q.index_select(0, i), scale.index_select(0, i) if scale.dim() else scale,
                   x.dtype)
    return torch.matmul(x.double(), w.double())


def w8a16_line(t: dict) -> str:
    """One B5 case's readings on a line."""
    int8pack = (f"{t['int8pack_ms']:.4f} ms" if t["int8pack_ms"] is not None
                else t["int8pack"])
    read = f", a read of the weights {t['read_ms']:.4f} ms" if "read_ms" in t else ""
    return (f"{t['shape']}; route {t['route']}, tile {t['tile']}, {t['splits']} split(s); "
            f"{t['ms']:.4f} ms, twin "
            f"{t['plain_ms']:.4f} ms, bf16 matmul {t['library_ms']:.4f} ms (ratio "
            f"{t['ms'] / t['library_ms']:.2f}), dequant and matmul "
            f"{t['library_dequant_ms']:.4f} ms, int8pack_mm {int8pack}{read}, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), {t['bound_ms'] / t['ms']:.1%} of bound")


def int8pack_yardstick(x, q, scale, reps, flush):
    """ms of one ``torch._weight_int8pack_mm`` call (x (M, K) against int8
    (N, K) weights with per-channel scales) on a one-entry case, its
    operands built outside the timed window; None with the reason where
    this PyTorch has no CUDA kernel for it or the case is batched or
    fp32. Timed only: the port never calls it."""
    import torch

    if not torch._C._dispatch_has_kernel_for_dispatch_key("aten::_weight_int8pack_mm", "CUDA"):
        return None, "none in this PyTorch (no CUDA kernel for aten::_weight_int8pack_mm)"
    if x.shape[0] != 1 or x.dtype != torch.bfloat16:
        return None, "batched or fp32 case: no single call"
    N = q.shape[2]
    xs, qt = x[0].contiguous(), q[0].t().contiguous()
    sc = (scale.reshape(N) if scale.dim() else scale.expand(N)).to(x.dtype).contiguous()
    return time_ms(lambda: torch._weight_int8pack_mm(xs, qt, sc), reps, flush), \
        "torch._weight_int8pack_mm"


def run_w8a16(dev, flush, reps=10):
    """B5 against its twin on every case of ``W8A16_CASES``, each element
    within its limit of the twin or of the fp64 evaluation; each case
    launched twice must give the same bits. Timed per case beside the twin,
    three yardsticks (the dequantized weights and ``torch.matmul``;
    ``torch.matmul`` on bf16 weights of the same shape, gathered beforehand
    for the routed case; ``torch._weight_int8pack_mm`` where this PyTorch
    has a CUDA kernel for it) and the bound from this run's data (the
    distinct experts' weights read once), with the route, tile and splits the
    shapes pick; where the bytes bound a case, also the time of one plain
    read of those weights (``read_ms``). The twins run with cuBLAS's
    reduced-precision bf16 reductions off."""
    import torch

    from neuronx_distributed_tpu_torch.kernels.w8a16 import (
        _route,
        _splits,
        _tile,
        dequantize,
        w8a16_gemm,
        w8a16_gemm_plain,
    )

    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cases, shapes, timed = {}, {}, {}
    try:
        for case, dtype, B, M, K, N, E, shared, routed, per_tensor in W8A16_CASES:
            x, q, scale, idx = w8a16_case(dev, dtype, B, M, K, N, E, shared, routed, per_tensor)
            out = w8a16_gemm(x, q, scale, idx)
            again = w8a16_gemm(x, q, scale, idx)
            torch.cuda.synchronize()
            check(torch.equal(out, again), f"a second launch of w8a16_gemm ({case}) gave other bits")
            ref = w8a16_gemm_plain(x, q, scale, idx)
            bf16 = dtype == "bf16"
            r = held(out, ref, TOL_W8A16_FLOOR if bf16 else TOL_W8A16_FP32_FLOOR,
                     rel=REL_BF16 if bf16 else REL_FP32, exact=w8a16_exact(x, q, scale, idx))
            cases[case] = {"out": r}
            shapes[case] = (f"x ({B}, {M}, {K}) {dtype}{' shared by the batch' if shared else ''}"
                            f", int8 weights ({E}, {K}, {N}), "
                            f"{'per-tensor' if per_tensor else 'per-channel'} scale, idx "
                            f"{'routed' if routed else 'identity'}")
            check_held(f"w8a16_gemm ({case})", r)
            check(bool(torch.isfinite(out).all()), f"w8a16_gemm ({case}) produced non-finite values")
            del out, again, ref
            used = torch.unique(idx).long()
            i = idx.long()
            wdt = x.dtype

            def dequant_matmul():
                w = dequantize(q.index_select(0, i),
                               scale.index_select(0, i) if scale.dim() else scale, wdt)
                return torch.matmul(x, w)

            wf = dequantize(q.index_select(0, i) if routed else q,
                            (scale.index_select(0, i) if routed else scale)
                            if scale.dim() else scale, wdt)
            # x read once, the distinct experts' weights and scales read once,
            # idx read, out written
            moved = (nbytes(x[:1] if shared else x) + used.numel() * K * N
                     + (used.numel() * N * 4 if scale.dim() else 4) + nbytes(idx)
                     + B * M * N * x.element_size())
            route = _route(B, M, K, N, x.dtype)
            timed[case] = dict(
                shape=shapes[case], route=route, splits=_splits(route, B, M, K, N)[0],
                tile="{1} x {2} x {0}".format(*_tile(route, M)),
                ms=time_ms(lambda: w8a16_gemm(x, q, scale, idx), reps, flush),
                plain_ms=time_ms(lambda: w8a16_gemm_plain(x, q, scale, idx), max(2, reps // 5),
                                 flush),
                library_ms=time_ms(lambda: torch.matmul(x, wf), reps, flush),
                library_dequant_ms=time_ms(dequant_matmul, max(2, reps // 5), flush),
                **bound(2.0 * B * M * K * N, moved, PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS))
            if timed[case]["bound_by"] == "bytes":
                # the floor this timing method leaves a kernel bound by its
                # weight bytes: one read of the distinct experts' weights
                # (their max, as int32 words) after the same L2 flush
                words = q.index_select(0, used).view(torch.int32) if routed else q.view(torch.int32)
                timed[case]["read_ms"] = time_ms(lambda: words.amax(), reps, flush)
                del words
            del x, q, scale, idx, wf
            torch.cuda.empty_cache()
        # after every kernel timing: the library's int8 call is a slow SIMT
        # kernel (up to half a second a call) that would heat the card
        # before the cases timed after it
        for case, dtype, B, M, K, N, E, shared, routed, per_tensor in W8A16_CASES:
            x, q, scale, idx = w8a16_case(dev, dtype, B, M, K, N, E, shared, routed, per_tensor)
            timed[case]["int8pack_ms"], timed[case]["int8pack"] = int8pack_yardstick(
                x, q, scale, 2, flush)
            del x, q, scale, idx
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    head = timed[W8A16_TIMED]
    return dict(
        name="w8a16_gemm", route="cuda", source="neuronx_distributed_tpu_torch/csrc/w8a16_gemm.cu",
        replaces="no Pallas call: XLA's fusion of "
                 "neuronx_distributed_tpu/quantization/core.py:112 (dequantize_leaf) into the "
                 "consuming einsum",
        shape=shapes[W8A16_TIMED], case_shapes=shapes,
        max_abs_err=max(r["out"]["max_abs_err"] for r in cases.values()),
        tolerance=f"bf16 {REL_BF16:.4g} * |ref| + floor {TOL_W8A16_FLOOR:.3g}; fp32 "
                  f"{REL_FP32:.3g} * |ref| + floor {TOL_W8A16_FP32_FLOOR:.3g}",
        held=cases, rerun_bit_identical=True, cases=timed,
        library="torch.matmul on the dequantized bf16 weights (library_dequant_ms: the "
                "dequant and torch.matmul)",
        int8pack="torch._weight_int8pack_mm, timed alone where this PyTorch has a CUDA "
                 "kernel for it (int8pack_ms; None on batched cases)",
        **{k: head[k] for k in ("ms", "plain_ms", "library_ms", "library_dequant_ms",
                                "int8pack_ms", "bound_ms", "bound_by", "flops", "bytes")})


# --- phase 3: small model, GPU kernels vs CPU twins ---------------------------------


def small_config():
    import torch

    from neuronx_distributed_tpu_torch.models.llama import LlamaConfig

    # head_dim 128 (a kernel width), GQA group 2, fp32 end to end
    return LlamaConfig(vocab_size=512, hidden_size=512, intermediate_size=1024, num_layers=2,
                       num_heads=4, num_kv_heads=2, max_seq_len=256, rope_theta=500000.0,
                       dtype=torch.float32, param_dtype=torch.float32)


def reference_check(dev) -> float:
    """Insert logits (bucket 128: the flash gate) and four paged decode
    steps of one fp32 model, on ``dev`` and on the CPU. Returns the max abs
    logit difference."""
    import numpy as np
    import torch

    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params

    cfg = small_config()
    params = init_params(cfg, torch.Generator().manual_seed(3))
    kw = dict(buckets=(128,), max_batch=3, page_size=16, paged_attn_kernel=True)
    lms = [CausalLM(cfg, params, LlamaForCausalLM, device=d, **kw) for d in (dev, "cpu")]
    sessions = [lm.start_session() for lm in lms]
    rng = np.random.default_rng(4)
    prompts = rng.integers(1, cfg.vocab_size, (2, 120)).astype(np.int32)
    lengths = np.array([120, 101], np.int32)
    slots = np.array([0, 2])
    outs = [lm.insert(s, slots, prompts, lengths=lengths).float().cpu()
            for lm, s in zip(lms, sessions)]
    worst = float((outs[0] - outs[1]).abs().max())
    tok = np.zeros(3, np.int32)
    tok[slots] = outs[1].argmax(-1).numpy()
    for _ in range(4):
        outs = [lm.step(s, tok).float().cpu() for lm, s in zip(lms, sessions)]
        worst = max(worst, float((outs[0] - outs[1]).abs().max()))
        tok = outs[1].argmax(-1).numpy().astype(np.int32)
    check(worst <= TOL_LOGITS_FP32,
          f"small-model logits on the GPU differ from the CPU twins by {worst}")
    return worst


def program_check(dev) -> dict:
    """The small fp32 model behind paged engines on ``dev``, its inserts and
    chunk extends (64-token chunks, prompts up to 200 tokens) run as
    captured programs, then eagerly (``capture_programs=False``), and on the
    CPU: the card's two routes must give bit-identical streams and equal the
    CPU's (greedy); on the slab path ``generate`` the same. Returns the
    programs captured and their capture ms."""
    import numpy as np
    import torch

    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params

    cfg = small_config()
    params = init_params(cfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(8)
    work = [(int(n), a) for n, a in zip(rng.integers(20, 200, 8), (0, 0, 1, 1, 2, 3, 3, 5))]
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n, _ in work]
    runs, capture_ms = {}, {}
    for d, captured, chunk in ((dev, True, 64), (dev, False, 64), ("cpu", False, 64),
                               (dev, True, 0), (dev, False, 0)):
        lm = CausalLM(cfg, params, LlamaForCausalLM, buckets=(64, 128, 256), max_batch=4,
                      page_size=16, paged_attn_kernel=True, capture_programs=captured, device=d)
        engine = ServeEngine(lm, block_steps=4, prefill_chunk_tokens=chunk)
        for p, (_, arrival) in zip(prompts, work):
            engine.submit(p, 12, arrival_block=arrival)
        runs[(d, captured, chunk)] = {c.request_id: c.tokens.tolist() for c in engine.run()}
        if captured:
            capture_ms.update(lm.capture_ms)
        del lm, engine
    for chunk in (64, 0):
        check(runs[(dev, True, chunk)] == runs[(dev, False, chunk)],
              f"captured and eager programs gave different streams on the card (chunk {chunk})")
    check(runs[(dev, True, 64)] == runs[("cpu", False, 64)],
          "captured programs' greedy streams on the card differ from the CPU's")
    slab = {}
    for captured in (True, False):
        lm = CausalLM(cfg, params, LlamaForCausalLM, buckets=(128, 256), max_batch=2,
                      capture_programs=captured, device=dev)
        batch = np.random.default_rng(9).integers(1, cfg.vocab_size, (2, 200)).astype(np.int32)
        batch[1, 150:] = 0   # a shorter second prompt
        slab[captured] = (lm.generate(batch, 16).tokens, lm.generate(batch, 16,
                                                                       fused_chunk=4).tokens)
        del lm
    check(all(np.array_equal(a, b) for a, b in zip(slab[True], slab[False])),
          "captured and eager slab generate differ on the card")
    return dict(programs=sorted(capture_ms), capture_ms=capture_ms)


# --- phase 4: serve Llama-3-8B -------------------------------------------------------


def serve_config():
    import torch

    from neuronx_distributed_tpu_torch.models.llama import llama3_8b

    return llama3_8b(max_seq_len=4096, dtype=torch.bfloat16, param_dtype=torch.bfloat16)


# phases 4b (trace, and its eager passes), 4c (overload), 4d (recovery),
# 4e (tenants), 4f (park), 4g's speculation and Medusa, and 4i (fleet):
# llama3_8b depth, of 32 (their gates count decisions and compare passes
# on one model, which the depth does not change; cut for the run time when
# phase 4q came, 8 to 4 when phase 4r came). Phase 4's serve cells, (t1)
# and 4h's (q1) keep all 32.
SERVING_CUT_LAYERS = 4


def serving_cut(cfg, params):
    """``cfg`` and ``params`` cut to ``SERVING_CUT_LAYERS`` layers (the
    first ones; the tensors shared, not copied)."""
    return (dataclasses.replace(cfg, num_layers=SERVING_CUT_LAYERS),
            first_layers(params, SERVING_CUT_LAYERS))


def serve_prompts(vocab: int, seed: int = 5):
    import numpy as np

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, vocab, n).astype(np.int32) for n in SERVE_PROMPT_LENS]
    prompts[3][:SHARED_PREFIX] = prompts[2][:SHARED_PREFIX]
    return prompts


def _sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def run_workload(lm, dev, block_steps, before_run=None):
    """One engine serving the smoke workload to the end; returns the engine,
    its completions and the wall seconds of ``run()``."""
    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine

    engine = ServeEngine(lm, block_steps=block_steps)
    for i, p in enumerate(serve_prompts(lm.config.vocab_size)):
        # the second prefix sharer arrives one block later, after the first
        # has registered its pages
        engine.submit(p, MAX_NEW_TOKENS, arrival_block=1 if i == 3 else 0)
    if before_run is not None:
        before_run()
    _sync(dev)
    t0 = time.perf_counter()
    done = engine.run()
    _sync(dev)
    return engine, done, time.perf_counter() - t0


# B2's two device kernels: each launch of its wrapper runs both once
B2_DEVICE_KERNELS = ("split_kernel", "merge_kernel")


def device_kernel_calls(prof, names) -> dict:
    """Calls of the device kernels whose names contain each of ``names`` in
    a ``torch.profiler`` trace of device activity."""
    import torch

    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {n: sum(e.count for e in kernels if n in e.key) for n in names}


def replay_b2_calls(lm, engine) -> dict:
    """One more replay of ``engine``'s captured block (every slot idle by
    now: the writes land in scratch pages and the sink) under
    ``torch.profiler``: B2's kernels as the device ran them, to hold the
    launch count derived from replays against."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    runner = lm.compile_session_decode_fused(engine.block_steps, engine.slot_sampler,
                                             engine.pad_token_id)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        runner(engine.session)
        torch.cuda.synchronize()
    calls = device_kernel_calls(prof, B2_DEVICE_KERNELS)
    calls["derived"] = runner.launches_per_replay["paged_decode_attention"]
    return calls


def profile_workload(lm, dev, block_steps, path: str) -> dict:
    """The workload once more under ``torch.profiler``, tracing device
    activity only (no per-operator host records, which slow the host the
    device waits on): the device's busy share of this same run's wall time
    and the kernels by device time (table at ``path``). B2's kernel calls in
    the trace must equal the run's B2 launch count (replays times the
    launches recorded at capture)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from neuronx_distributed_tpu_torch.inference.paged_kernel import paged_decode_attention

    paged_decode_attention.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, done, wall = run_workload(lm, dev, block_steps)
    derived = paged_decode_attention.launches
    summary = device_profile_summary(prof, wall, path)
    traced = device_kernel_calls(prof, B2_DEVICE_KERNELS)
    check(all(v == derived for v in traced.values()),
          f"the profiled serve ran B2's kernels {traced} times, its launch count says {derived}")
    return dict(summary, tokens=sum(len(c.tokens) for c in done), b2_launches=derived,
                b2_traced=traced)


def device_profile_summary(prof, wall: float, path: str, shares=(), top=12) -> dict:
    """The device kernels of a ``torch.profiler`` trace by device time: the
    busy time and its share of ``wall``, the first ``top`` and the table
    written to ``path``; ``shares`` names groups of kernels (name substrings) whose
    device ms and share of the busy time are added as ``<group>_ms`` and
    ``<group>_share``."""
    import torch

    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(kernels), "the profiler recorded no device activity")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in kernels)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(prof.key_averages().table(sort_by="self_device_time_total",
                                                    row_limit=60))
    out = dict(wall_s=wall, device_busy_s=busy_us / 1e6, device_busy_share=busy_us / 1e6 / wall,
               top=[dict(name=e.key[:90], calls=e.count, ms=e.self_device_time_total / 1e3,
                         share=e.self_device_time_total / busy_us) for e in kernels[:top]])
    for group, names in shares:
        us = sum(e.self_device_time_total for e in kernels if any(n in e.key for n in names))
        out.update({f"{group}_ms": us / 1e3, f"{group}_share": us / busy_us})
    return out


def serve(cfg, dev, counters, block_steps=8, max_batch=8, profile_path=None, params=None,
          page_dtype=None, reference=None):
    """Serve the workload once with the launch counters zeroed just before
    ``run()``; returns the printed metrics (and a profile of a second run
    when ``profile_path`` is given). The engine is built, and its decode
    block captured, before the timed run (a throwaway engine serves one
    short request first). ``params`` (random weights from a seed when
    None) may be shared with another pass; ``reference`` is another pass's
    completions, whose tokens this pass's are matched against."""
    import torch

    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params

    t0 = time.perf_counter()
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    lm = CausalLM(cfg, params, LlamaForCausalLM, buckets=(128, 512), max_batch=max_batch,
                  page_size=16, paged_attn_kernel=True, page_dtype=page_dtype, device=dev)
    del params
    _sync(dev)
    setup_s = time.perf_counter() - t0

    # warm-up on a throwaway engine (captures the decode block; library
    # handles, allocator)
    warm = ServeEngine(lm, block_steps=block_steps)
    capture_s = warm.capture_s
    warm.submit(serve_prompts(cfg.vocab_size, seed=6)[0][:130], 4)
    warm.run()
    del warm

    def zero_counters():
        for c in counters:
            c.launches = 0

    engine, done, wall = run_workload(lm, dev, block_steps, before_run=zero_counters)
    launches = {c.__name__: c.launches for c in counters}

    # the captured block reports non-finite logits through its flags (a
    # forward hook does not run on a replay)
    check(engine.nonfinite_logits == 0,
          f"non-finite logits while serving ({engine.nonfinite_logits} slots)")
    check(engine.replays == engine.decode_blocks > 0,
          f"{engine.replays} replays for {engine.decode_blocks} decode blocks")
    # the replays' B2 launches are counted as replays times the launches
    # recorded at capture; the device's own count for one replay backs that
    b2_replay = replay_b2_calls(lm, engine)
    check(b2_replay["derived"] > 0 and all(b2_replay[n] == b2_replay["derived"]
                                           for n in B2_DEVICE_KERNELS),
          f"one replay ran B2's kernels {b2_replay} times")
    check(len(done) == len(SERVE_PROMPT_LENS),
          f"{len(done)} of {len(SERVE_PROMPT_LENS)} requests completed")
    for c in done:
        check(len(c.tokens) == MAX_NEW_TOKENS, f"request {c.request_id} gave {len(c.tokens)}")
        check(bool(((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all()),
              f"request {c.request_id} gave a token outside the vocabulary")
    ttft = sorted(c.token_ts[0] - c.submit_ts for c in done)
    tokens = sum(len(c.tokens) for c in done)
    pkv = engine.session.paged
    host_ops = engine.replays + engine.host_fetches + engine.h2d_copies
    stats = dict(
        layers=cfg.num_layers, hidden=cfg.hidden_size, vocab=cfg.vocab_size,
        page_dtype=page_dtype or str(cfg.dtype).replace("torch.", ""),
        requests=len(done), generated_tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
        ttft_s_p50=ttft[len(ttft) // 2], ttft_s_max=ttft[-1], setup_s=setup_s,
        capture_s=capture_s, kv_pool_bytes=lm.kv_cache_bytes()["kv_bytes"],
        decode_blocks=engine.decode_blocks, replays=engine.replays,
        host_fetches=engine.host_fetches, h2d_copies=engine.h2d_copies,
        host_ops_per_block=host_ops / engine.decode_blocks,
        inserts=engine.inserts, prefix_hit_tokens=pkv.prefix_hit_tokens,
        launches=launches,
        launches_per_token={k: v / tokens for k, v in launches.items()},
        b2_per_replay=b2_replay,
        streams={c.request_id: c.tokens.tolist() for c in done})
    if reference is not None:
        same = sum(int(a == b) for rid, ts in stats["streams"].items()
                   for a, b in zip(ts, reference[rid]))
        stats["token_match_share"] = same / tokens
    if profile_path is not None:
        del engine
        stats["profile"] = profile_workload(lm, dev, block_steps, profile_path)
    return stats


def graph_check(dev, head_dim=None) -> dict:
    """The small fp32 model (``head_dim`` 96 when given) behind a captured
    engine and a stepwise engine on ``dev`` and a stepwise engine on the
    CPU, greedy and sampled requests mixed: the card's two routes must give
    bit-identical streams, the greedy streams must equal the CPU's, and a
    steady-state block (no admission or retirement before it) must make
    exactly one replay and one fetch, any other block at most one copy
    more."""
    import dataclasses

    import numpy as np
    import torch

    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
    from neuronx_distributed_tpu_torch.inference.sampling import Sampler
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params

    cfg = small_config()
    if head_dim is not None:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    params = init_params(cfg, torch.Generator().manual_seed(3))
    # (prompt length, budget, sampled, arrival block): two long streams
    # leave steady blocks between the admissions and retirements
    work = ((100, 40, False, 0), (70, 33, True, 0), (120, 9, False, 1), (33, 12, True, 2),
            (50, 6, False, 2), (90, 10, True, 5))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n, *_ in work]
    runs, ops = {}, []
    for d, fused in ((dev, True), (dev, False), ("cpu", False)):
        lm = CausalLM(cfg, params, LlamaForCausalLM, buckets=(128,), max_batch=4,
                      page_size=16, paged_attn_kernel=True, device=d)
        engine = ServeEngine(lm, block_steps=4, fused=fused, seed=5)
        for p, (_, budget, sampled, arrival) in zip(prompts, work):
            engine.submit(p, budget, sampler=Sampler(temperature=0.8) if sampled else None,
                          arrival_block=arrival)
        while True:
            before = (engine.replays, engine.host_fetches, engine.h2d_copies,
                      engine.decode_blocks)
            if not engine.step_block():
                break
            if fused and engine.decode_blocks > before[3]:
                ops.append(tuple(a - b for a, b in zip(
                    (engine.replays, engine.host_fetches, engine.h2d_copies), before)))
        check(engine.nonfinite_logits == 0, "non-finite logits in the small serve check")
        runs[(d, fused)] = {c.request_id: c.tokens.tolist() for c in engine.completed}
        del lm, engine
    check(runs[(dev, True)] == runs[(dev, False)],
          "the captured block and the stepwise route gave different streams on the card")
    greedy = [i for i, w in enumerate(work) if not w[2]]
    check(all(runs[(dev, True)][i] == runs[("cpu", False)][i] for i in greedy),
          "greedy streams on the card differ from the CPU's")
    steady = [o for o in ops if o[2] == 0]
    check(bool(steady) and all(o == (1, 1, 0) for o in steady),
          f"steady-state blocks made other host ops than one replay and one fetch: {ops}")
    check(all(o[:2] == (1, 1) and o[2] <= 1 for o in ops), f"block host ops {ops}")
    return dict(head_dim=cfg.head_dim_, blocks=len(ops), steady_blocks=len(steady),
                host_ops=[sum(o) for o in ops],
                sampled_equal_cpu=all(runs[(dev, True)][i] == runs[("cpu", False)][i]
                                      for i, w in enumerate(work) if w[2]))


# --- phase 4b: the synthetic arrival trace -------------------------------------------

# the trace of the trace phase: 32 greedy requests of 64 new tokens, every
# 4th a 3072-token prompt arriving while decode traffic is live
TRACE_REQUESTS = 32
TRACE_KNOBS = dict(prompt_lens=(64, 128, 256, 384), max_new_tokens=64,
                   mean_interarrival_blocks=0.5, long_prompt_frac=0.25, long_prompt_len=3072,
                   seed=0)
TRACE_BUCKETS = (128, 512, 4096)   # 4096: the one-shot pass inserts the long prompts whole
TRACE_CHUNK = 512
# (label, prefill_chunk_tokens, async_loop)
TRACE_PASSES = (("a", 0, False), ("b", TRACE_CHUNK, False), ("c", TRACE_CHUNK, True))


def device_busy_s(prof) -> float:
    """Seconds of device activity (kernels, copies, memsets) in a
    ``torch.profiler`` run, summed off its raw records: building its event
    list (``key_averages``) takes minutes for the 1.7 million records of a
    trace pass."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda) / 1e9


def trace_latency(done, arrival_ts, long_len: int) -> dict:
    """Per kind of request (``short``: prompt shorter than ``long_len``,
    ``long``), TTFT in wall ms from the request's arrival (``arrival_ts``:
    request id -> the wall time the engine's clock reached its arrival
    block) to its first token, p50 (the upper middle) and max; and the
    largest gap in wall ms between two tokens of any short request (the
    stall a long prefill puts on live streams)."""
    out = {}
    for kind, pick in (("short", lambda c: c.prompt_len < long_len),
                       ("long", lambda c: c.prompt_len >= long_len)):
        t = sorted((c.token_ts[0] - arrival_ts[c.request_id]) * 1e3 for c in done if pick(c))
        out[f"ttft_ms_p50_{kind}"] = t[len(t) // 2] if t else None
        out[f"ttft_ms_max_{kind}"] = t[-1] if t else None
    gaps = [max(b - a for a, b in zip(c.token_ts[:-1], c.token_ts[1:])) * 1e3
            for c in done if c.prompt_len < long_len and len(c.token_ts) > 1]
    out["max_gap_ms_short"] = max(gaps) if gaps else None
    return out


def count_host_ops(engine) -> list:
    """Wrap ``engine.step_block`` so that each round that decodes a block
    appends its host ops (replays, fetches, slot-state copies) to the
    returned list."""
    step, ops = engine.step_block, []

    def counted_step():
        before = (engine.replays, engine.host_fetches, engine.h2d_copies, engine.decode_blocks)
        more = step()
        if engine.decode_blocks > before[3]:
            ops.append(tuple(a - b for a, b in zip(
                (engine.replays, engine.host_fetches, engine.h2d_copies), before)))
        return more

    engine.step_block = counted_step
    return ops


def host_op_stats(ops) -> dict:
    """The host-op gate's reading of :func:`count_host_ops`: a steady block
    (no copy) one replay and one fetch, any block at most one copy more."""
    steady = [o for o in ops if o[2] == 0]
    return dict(host_ops=[sum(o) for o in ops],
                host_ops_per_block=sum(map(sum, ops)) / max(len(ops), 1),
                steady_blocks=len(steady), steady_ok=all(o == (1, 1, 0) for o in steady),
                blocks_ok=all(o[:2] == (1, 1) and o[2] <= 1 for o in ops))


def trace_pass(lm, dev, trace, chunk: int, async_loop: bool, counters, profile=False) -> dict:
    """One pass of ``trace`` through a ``ServeEngine`` on ``lm``: every
    request submitted up front with its arrival block, its arrival stamped
    in wall time when the engine's clock reaches that block; the launch
    counters zeroed just before and read just after. Per decode round the
    host ops (replays, fetches, copies); B1's launches inside chunk extends
    counted apart. With ``profile``, the pass runs under ``torch.profiler``
    (device activity only) and returns the device's busy share instead."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
    from neuronx_distributed_tpu_torch.kernels.flash_attn import flash_block_forward

    engine = ServeEngine(lm, block_steps=8, prefill_chunk_tokens=chunk, async_loop=async_loop)
    for it in trace:
        engine.submit(it["prompt"], it["max_new_tokens"], eos_token_id=it["eos_token_id"],
                      arrival_block=it["arrival_block"])
    extend = lm.extend
    extend_b1 = [0]

    def counted_extend(*a, **kw):
        before = flash_block_forward.launches
        logits = extend(*a, **kw)
        extend_b1[0] += flash_block_forward.launches - before
        return logits

    lm.extend = counted_extend
    arrival_ts, ops, block_events = {}, count_host_ops(engine), time_blocks(engine)
    for c in counters:
        c.launches = 0
    prof = torch_profile(activities=[ProfilerActivity.CUDA]) if profile else None
    _sync(dev)
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    try:
        while True:
            now = time.perf_counter()
            for r in engine.queue:
                if r.arrival_block <= engine.blocks:
                    arrival_ts.setdefault(r.request_id, now)
            if not engine.step_block():
                break
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        del lm.extend
        if prof is not None:
            prof.__exit__(None, None, None)
    launches = {c.__name__: c.launches for c in counters}
    if prof is not None:
        busy = device_busy_s(prof)
        return dict(wall_s=wall, device_busy_s=busy, device_busy_share=busy / wall)
    done = engine.completed
    tokens = sum(len(c.tokens) for c in done)
    block_ms = [a.elapsed_time(b) for a, b in block_events]
    dispatch = engine.metrics.snapshot()["serve_dispatch_ms"]["samples"]
    return dict(
        dispatch_ms={d["labels"]["kind"]: d["sum"] for d in dispatch},
        dispatches={d["labels"]["kind"]: d["count"] for d in dispatch},
        decode_block_ms_p50=_pct(block_ms, 50),
        prefill_chunk_tokens=chunk, async_loop=async_loop, requests=len(done),
        generated_tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
        **trace_latency(done, arrival_ts, TRACE_KNOBS["long_prompt_len"]),
        decode_blocks=engine.decode_blocks, blocks=engine.blocks, **host_op_stats(ops),
        inserts=engine.inserts, chunk_program_calls=engine.chunk_program_calls,
        prefill_chunk_tokens_done=engine.prefill_chunk_tokens_done,
        b1_launches_in_extends=extend_b1[0], nonfinite_logits=engine.nonfinite_logits,
        launches=launches,
        streams={c.request_id: c.tokens.tolist() for c in done},
        schedule={c.request_id: (c.queue_blocks, c.ttft_blocks, c.decode_blocks) for c in done})


def trace_lm(cfg, dev, params):
    """The ``CausalLM`` of the trace and overload phases: the serve phase's
    widths and weights with a 4096-token bucket."""
    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM

    return CausalLM(cfg, params, LlamaForCausalLM, buckets=TRACE_BUCKETS, max_batch=8,
                    page_size=16, paged_attn_kernel=True, device=dev)


def run_trace_phase(lm, dev, counters, profile=False) -> dict:
    """The synthetic trace (``TRACE_KNOBS``) served three times on ``lm``
    (:func:`trace_lm`): (a) one-shot
    inserts, (b) chunked prefill, (c) chunked prefill in the pipelined loop.
    Hard gates: every request completes with its 64 tokens in every pass,
    every logit is finite, each pass launched B1 and B2; (b) and (c) give
    bit-identical streams; in (b) and (c) every decode block makes at most
    3 host ops and a steady one exactly 2. Reported: the share of tokens
    equal between (a) and (b) (cuBLAS may pick another GEMM for a 4096-row
    insert than for 512-row chunks)."""
    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
    from neuronx_distributed_tpu_torch.inference.trace import synthetic_trace

    trace = synthetic_trace(TRACE_REQUESTS, lm.config.vocab_size, **TRACE_KNOBS)
    # warm-up: the decode block's capture, the one-shot and chunk shapes
    warm = ServeEngine(lm, block_steps=8, prefill_chunk_tokens=TRACE_CHUNK)
    capture_s = warm.capture_s
    warm.submit(trace[3]["prompt"][:1100], 2)
    warm.run()
    warm.close()   # the next warm-up takes over this session's state and programs
    warm = ServeEngine(lm, block_steps=8)
    warm.submit(trace[0]["prompt"], 2)
    warm.submit(trace[3]["prompt"], 2)
    warm.run()
    del warm
    passes = {}
    for label, chunk, async_loop in TRACE_PASSES:
        st = trace_pass(lm, dev, trace, chunk, async_loop, counters)
        name = f"pass ({label})"
        check(st["requests"] == TRACE_REQUESTS, f"trace {name}: {st['requests']} of "
                                                 f"{TRACE_REQUESTS} requests completed")
        check(all(len(t) == TRACE_KNOBS["max_new_tokens"] for t in st["streams"].values()),
              f"trace {name}: a request gave fewer than its 64 tokens")
        check(st["nonfinite_logits"] == 0, f"trace {name}: non-finite logits")
        for fn, n in st["launches"].items():
            check(n > 0, f"trace {name} never launched {fn}")
        if chunk:
            check(st["steady_ok"] and st["blocks_ok"],
                  f"trace {name}: host ops a decode block {st['host_ops']}")
            check(st["chunk_program_calls"] > 0 and st["b1_launches_in_extends"] > 0,
                  f"trace {name}: no chunk extend ran B1")
        passes[label] = st
    if profile:   # after the timed passes: a profiled run slows the ones after it
        for label, chunk, async_loop in TRACE_PASSES:
            passes[label]["profile"] = trace_pass(lm, dev, trace, chunk, async_loop, counters,
                                                  profile=True)
    check(passes["b"]["streams"] == passes["c"]["streams"],
          "trace passes (b) sync and (c) async gave different streams")
    same = sum(int(x == y) for rid, ts in passes["a"]["streams"].items()
               for x, y in zip(ts, passes["b"]["streams"][rid]))
    schedule_equal = passes["b"]["schedule"] == passes["c"]["schedule"]
    streams = {label: st.pop("streams") for label, st in passes.items()}
    for st in passes.values():   # 6144 tokens: kept off the printed summary
        del st["schedule"]
    return dict(passes=passes, capture_s=capture_s, streams=streams, trace=trace,
                token_match_a_b=same / passes["a"]["generated_tokens"],
                schedule_equal_b_c=schedule_equal,
                requests=TRACE_REQUESTS, knobs={k: v for k, v in TRACE_KNOBS.items()},
                buckets=TRACE_BUCKETS)


# --- phase 4c: serving under overload -----------------------------------------------

# 48 greedy requests of 64 new tokens arriving 4 a block (8 slots retire about
# 1 a block), every 4th a 3072-token prompt, two tenants
OVERLOAD_REQUESTS = 48
OVERLOAD_KNOBS = dict(prompt_lens=(64, 128, 256, 384), max_new_tokens=64,
                      mean_interarrival_blocks=0.25, long_prompt_frac=0.25, long_prompt_len=3072,
                      tenants=2, seed=1)
# the virtual clock's block in wall ms: a constant, never measured in the
# run, so the schedule is a function of the trace alone. 150 ms is about one
# round of the chunked pipelined trace pass on an H100 80GB HBM3 at 700 W
# (8.37 s over 57 decode blocks, PERF.md section 5)
OVERLOAD_BLOCK_MS = 150.0
OVERLOAD_TTFT_BLOCKS = 20       # a long prompt's TTFT budget; a short one's is a quarter
OVERLOAD_DEADLINE_BLOCKS = 16   # every stream's completion budget, from arrival
OVERLOAD_ENGINE = dict(block_steps=8, prefill_chunk_tokens=512, max_queue=8,
                       shed_policy="deadline", block_time_ms=OVERLOAD_BLOCK_MS)
# (label, async_loop, through run_trace with the tracer on)
OVERLOAD_PASSES = (("d", False, True), ("e", True, True), ("f", True, False))


def overload_trace(vocab: int) -> list:
    """The overload phase's trace: ``OVERLOAD_KNOBS`` with budgets in blocks
    times ``OVERLOAD_BLOCK_MS``; a short prompt (chat) gets a quarter of a
    long one's (document) TTFT budget."""
    from neuronx_distributed_tpu_torch.inference.trace import synthetic_trace

    trace = synthetic_trace(OVERLOAD_REQUESTS, vocab,
                            ttft_deadline_ms=OVERLOAD_TTFT_BLOCKS * OVERLOAD_BLOCK_MS,
                            deadline_ms=OVERLOAD_DEADLINE_BLOCKS * OVERLOAD_BLOCK_MS,
                            **OVERLOAD_KNOBS)
    for it in trace:
        if it["prompt"].size < OVERLOAD_KNOBS["long_prompt_len"]:
            it["ttft_deadline_ms"] /= 4
    return trace


def overload_pass(lm, dev, trace, async_loop: bool, traced: bool, counters,
                  profile=False) -> dict:
    """One pass of ``trace`` through ``ServeEngine(**OVERLOAD_ENGINE)`` on
    ``lm``: through ``run_trace`` (the tracer on), or submitted and run
    with the tracer off. The launch counters are zeroed just before and
    read just after; the host ops of each decode round are counted around
    ``step_block``. Returns the decisions (streams, schedule, rejected,
    expired, finish reasons), the counts the gates read, the host ms spent
    launching each kind of program (``serve_dispatch_ms``) and, traced, the
    report and the tracer's checks. With ``profile``, the pass runs under
    ``torch.profiler`` (device activity only) and returns the device's
    busy share instead."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine, run_trace
    from neuronx_distributed_tpu_torch.observability import validate_chrome_trace

    engine = ServeEngine(lm, async_loop=async_loop, **OVERLOAD_ENGINE)
    ops = count_host_ops(engine)
    for c in counters:
        c.launches = 0
    prof = torch_profile(activities=[ProfilerActivity.CUDA]) if profile else None
    _sync(dev)
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    report = None
    try:
        if traced:
            report = run_trace(engine, trace)
        else:
            for it in trace:
                engine.submit(it["prompt"], it["max_new_tokens"],
                              eos_token_id=it["eos_token_id"], arrival_block=it["arrival_block"],
                              ttft_deadline_ms=it["ttft_deadline_ms"],
                              deadline_ms=it["deadline_ms"], tenant=it.get("tenant", "default"))
            engine.run()
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    if prof is not None:
        busy = device_busy_s(prof)
        return dict(wall_s=wall, device_busy_s=busy, device_busy_share=busy / wall)
    done = engine.completed
    dispatch = engine.metrics.snapshot()["serve_dispatch_ms"]["samples"]
    tokens = sum(len(c.tokens) for c in done)
    st = dict(
        async_loop=async_loop, traced=traced, submitted=len(trace), completed=len(done),
        rejected_n=len(engine.rejected), generated_tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall, decode_blocks=engine.decode_blocks, blocks=engine.blocks,
        **host_op_stats(ops), nonfinite_logits=engine.nonfinite_logits,
        shed_evictions=engine.shed_evictions,
        queue_full=sum(r.reason == "queue_full" for r in engine.rejected),
        expired_n=sum(1 for c in done if c.expired),
        partial_expiries=sum(1 for c in done if c.expired and len(c.tokens)),
        ontime=sum(1 for c in done if not (c.deadline_missed or c.expired)),
        launches={c.__name__: c.launches for c in counters},
        # host wall ms launching each kind of program, and the launches
        dispatch_ms={d["labels"]["kind"]: d["sum"] for d in dispatch},
        dispatches={d["labels"]["kind"]: d["count"] for d in dispatch},
        streams={c.request_id: c.tokens.tolist() for c in done},
        schedule={c.request_id: (c.queue_blocks, c.ttft_blocks, c.decode_blocks) for c in done},
        finish={c.request_id: c.finish_reason for c in done},
        expired={c.request_id: len(c.tokens) for c in done if c.expired},
        rejected=[(r.request_id, r.reason, r.retry_after_blocks, r.queue_depth)
                  for r in engine.rejected])
    if traced:
        lanes = engine.tracer.by_request()
        names = {rid: [ev["name"] for ev in evs] for rid, evs in lanes.items()}
        toks = {rid: [ev["args"]["t"] for ev in evs if ev["name"] == "tok"]
                for rid, evs in lanes.items()}
        try:
            validate_chrome_trace(engine.tracer.export_chrome())
            chrome = "ok"
        except ValueError as e:
            chrome = str(e)
        sheds = [ev["args"] for ev in engine.tracer.events("shed")]
        st.update(report=report, dropped=engine.tracer.dropped, chrome=chrome,
                  attribution=attribution_check(engine.tracer)[0],
                  # sheds whose victim was a queued request, not the newest
                  # arrival: the deadline policy's evictions (at submit and
                  # at block boundaries)
                  deadline_evictions=sum(1 for a in sheds if a.get("evicted")),
                  tok_events_match=all(toks.get(rid, []) == t for rid, t in st["streams"].items()),
                  # expired before any admission: no slot ever took it
                  queued_expiries=sum(1 for rid in st["expired"]
                                      if not {"admit", "chunk_begin"} & set(names[rid])))
    return st


def overload_gates(passes: dict) -> list:
    """The overload phase's hard gates on its passes (label -> the dict of
    :func:`overload_pass`); returns what failed, empty when every gate held:
    every pass makes pass (d)'s decisions with pass (d)'s streams; every
    submission completes or is rejected; (d) sheds a newcomer to a full
    queue, evicts a queued request by deadline, expires a request in the
    queue and cuts a decoding one short, and completes one on time; each
    pass launched B1 and B2; the traced passes keep a steady decode block at
    one replay and one fetch (any block at most one copy more), drop no
    trace event, record each delivered token once, and export a trace the
    validator accepts."""
    problems = []
    ref = passes["d"]
    for label, st in passes.items():
        for key in ("streams", "schedule", "rejected", "expired", "finish"):
            if st[key] != ref[key]:
                problems.append(f"pass ({label}) {key} differ from pass (d)'s")
        if st["completed"] + st["rejected_n"] != st["submitted"]:
            problems.append(f"pass ({label}): {st['completed']} completed + {st['rejected_n']} "
                            f"rejected != {st['submitted']} submitted")
        for fn, n in st["launches"].items():
            if n <= 0:
                problems.append(f"pass ({label}) never launched {fn}")
        if st["traced"]:
            if not (st["steady_ok"] and st["blocks_ok"]):
                problems.append(f"pass ({label}): host ops a decode block {st['host_ops']}")
            if st["dropped"]:
                problems.append(f"pass ({label}): the tracer dropped {st['dropped']} events")
            if not st["tok_events_match"]:
                problems.append(f"pass ({label}): tok events differ from the delivered tokens")
            if st["chrome"] != "ok":
                problems.append(f"pass ({label}): exported trace refused: {st['chrome']}")
            problems += [f"pass ({label}) attribution: {p}" for p in st.get("attribution", ())]
    for key, what in (("queue_full", "shed to a full queue"),
                      ("deadline_evictions", "eviction by deadline"),
                      ("queued_expiries", "expiry in the queue"),
                      ("partial_expiries", "decoding expiry with a partial stream"),
                      ("ontime", "on-time completion")):
        if not ref.get(key):
            problems.append(f"pass (d) has no {what}")
    return problems


def run_overload_phase(lm, dev, counters, profile=False) -> dict:
    """The overload trace (:func:`overload_trace`) served three times on
    ``lm``: (d) the synchronous loop and (e) the pipelined loop through
    ``run_trace``, (f) the pipelined loop untraced through ``run()``; hard
    gates :func:`overload_gates` and finite logits, after one untimed
    warm-up pass. Reported: each traced pass's report, and (e) against (f)
    tokens/s (the tracer's cost); with
    ``profile``, each pass repeated under the profiler after the timed ones
    for the device's busy share."""
    trace = overload_trace(lm.config.vocab_size)
    # warm-up, neither timed nor gated: the first pass meets insert shapes
    # (group sizes) no earlier phase ran, and pays their first-use costs
    overload_pass(lm, dev, trace, False, False, counters)
    passes = {label: overload_pass(lm, dev, trace, async_loop, traced, counters)
              for label, async_loop, traced in OVERLOAD_PASSES}
    if profile:
        for label, async_loop, traced in OVERLOAD_PASSES:
            passes[label]["profile"] = overload_pass(lm, dev, trace, async_loop, traced,
                                                     counters, profile=True)
    problems = overload_gates(passes)
    check(not problems, "overload: " + "; ".join(problems))
    for label, st in passes.items():
        check(st["nonfinite_logits"] == 0, f"overload pass ({label}): non-finite logits")
    for st in passes.values():   # kept off the printed summary
        for key in ("streams", "schedule", "finish", "rejected", "expired"):
            del st[key]
        if st.get("report"):
            del st["report"]["per_request"]
    return dict(passes=passes, requests=OVERLOAD_REQUESTS, knobs=dict(OVERLOAD_KNOBS),
                block_time_ms=OVERLOAD_BLOCK_MS, ttft_blocks=OVERLOAD_TTFT_BLOCKS,
                deadline_blocks=OVERLOAD_DEADLINE_BLOCKS,
                engine={k: v for k, v in OVERLOAD_ENGINE.items()},
                tracing_cost=1 - passes["e"]["tokens_per_s"] / passes["f"]["tokens_per_s"])


# --- phase 4d: serving that survives faults ----------------------------------------

# 32 greedy requests of 64 new tokens arriving 2 a block over four shared
# 512-token prefixes (runs of four requests): each prefix comes back 16
# requests later, after its first users retired, so a pool of 300 pages
# spills it to the host tier and the second run restores it (with eight
# prefixes over 32 requests none would come back)
RECOVERY_REQUESTS = 32
RECOVERY_KNOBS = dict(prompt_lens=(64, 128, 256, 384), max_new_tokens=64,
                      mean_interarrival_blocks=0.5, shared_prefix_len=512, prefix_families=4,
                      seed=3)
RECOVERY_POOL_PAGES = 300
RECOVERY_TIER_PAGES = 256
RECOVERY_ENGINE = dict(block_steps=8, host_tier_pages=RECOVERY_TIER_PAGES)
# the plans, chosen on the CPU so that every seam fires in pass (i)
RECOVERY_DISPATCH_PLAN = dict(seed=0, dispatch_fail_prob=0.1, dispatch_max_failures=2)
RECOVERY_CHAOS_PLAN = dict(seed=2, pool_exhaust_prob=0.05, pool_storm_len=2,
                           dispatch_fail_prob=0.05, dispatch_max_failures=2,
                           corrupt_page_prob=0.15, tier_restore_fail_prob=0.1,
                           tier_corrupt_prob=0.1)
RECOVERY_CHAOS_RETRIES = 8
# pass (k) snapshots every 4 rounds and stops ("crashes") at a snapshot
RECOVERY_SNAPSHOT_EVERY = 4
RECOVERY_CRASH_BLOCKS = 16
# (label, plan, async_loop): the passes that run the trace through run_trace
RECOVERY_PASSES = (("g", None, False), ("h", "dispatch", True), ("i", "chaos", False),
                   ("j", "chaos", True))
# the counts the schedule gives, a function of the trace and the plan
# alone (greedy, no EOS): read from the CPU rehearsal at one layer
# (tests/test_torch_chip_smoke_checks.py), held exactly on the card
RECOVERY_COUNT_KEYS = ("decode_blocks", "blocks", "inserts", "deferred_admissions",
                       "tier_spilled_pages", "tier_restored_pages", "tier_hits",
                       "tier_restore_failures", "tier_repaired_pages", "corrupt_page_replays",
                       "tier_page_repairs", "dispatch_retries", "injected_corruptions",
                       "restored_requests", "fault_stats")
_CHAOS_FAULTS = dict(alloc_faults=4, dispatch_faults=10, pages_corrupted=5, tier_restore_faults=3,
                     tier_corruptions=1)
RECOVERY_PREDICTED = {
    "g": dict(decode_blocks=36, blocks=36, inserts=20, deferred_admissions=0,
             tier_spilled_pages=420, tier_restored_pages=128, tier_hits=4,
             tier_restore_failures=0, tier_repaired_pages=0, corrupt_page_replays=0,
             tier_page_repairs=0, dispatch_retries=0, injected_corruptions=0,
             restored_requests=0, fault_stats=None),
    "h": dict(decode_blocks=36, blocks=36, inserts=20, deferred_admissions=0,
             tier_spilled_pages=420, tier_restored_pages=128, tier_hits=4,
             tier_restore_failures=0, tier_repaired_pages=0, corrupt_page_replays=0,
             tier_page_repairs=0, dispatch_retries=12, injected_corruptions=0,
             restored_requests=0, fault_stats={'dispatch_faults': 12}),
    "i": dict(decode_blocks=36, blocks=36, inserts=32, deferred_admissions=2,
             tier_spilled_pages=390, tier_restored_pages=6, tier_hits=3,
             tier_restore_failures=4, tier_repaired_pages=0, corrupt_page_replays=11,
             tier_page_repairs=0, dispatch_retries=10, injected_corruptions=0,
             restored_requests=0, fault_stats=_CHAOS_FAULTS),
    "j": dict(decode_blocks=36, blocks=36, inserts=32, deferred_admissions=2,
             tier_spilled_pages=390, tier_restored_pages=6, tier_hits=3,
             tier_restore_failures=4, tier_repaired_pages=0, corrupt_page_replays=11,
             tier_page_repairs=0, dispatch_retries=10, injected_corruptions=0,
             restored_requests=0, fault_stats=_CHAOS_FAULTS),
    "k": dict(decode_blocks=20, blocks=36, inserts=17, deferred_admissions=0,
             tier_spilled_pages=266, tier_restored_pages=64, tier_hits=2,
             tier_restore_failures=0, tier_repaired_pages=0, corrupt_page_replays=0,
             tier_page_repairs=0, dispatch_retries=0, injected_corruptions=0,
             restored_requests=23, fault_stats=None),
    "l": dict(decode_blocks=36, blocks=36, inserts=20, deferred_admissions=0,
             tier_spilled_pages=420, tier_restored_pages=128, tier_hits=4,
             tier_restore_failures=0, tier_repaired_pages=128, corrupt_page_replays=0,
             tier_page_repairs=128, dispatch_retries=0, injected_corruptions=128,
             restored_requests=0, fault_stats=None),
    "m": dict(decode_blocks=36, blocks=36, inserts=20, deferred_admissions=0,
             tier_spilled_pages=420, tier_restored_pages=128, tier_hits=4,
             tier_restore_failures=0, tier_repaired_pages=0, corrupt_page_replays=0,
             tier_page_repairs=0, dispatch_retries=0, injected_corruptions=0,
             restored_requests=0, fault_stats=None),
}


def recovery_lm(cfg, dev, params):
    """The ``CausalLM`` of the recovery phase: the serve phase's widths and
    weights (shared, not copied), the trace phase's buckets, and a pool of
    ``RECOVERY_POOL_PAGES`` pages."""
    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM

    return CausalLM(cfg, params, LlamaForCausalLM, buckets=TRACE_BUCKETS, max_batch=8,
                    page_size=16, paged_attn_kernel=True, page_pool_pages=RECOVERY_POOL_PAGES,
                    device=dev)


def recovery_trace(vocab: int) -> list:
    from neuronx_distributed_tpu_torch.inference.trace import synthetic_trace

    return synthetic_trace(RECOVERY_REQUESTS, vocab, **RECOVERY_KNOBS)


def _recovery_engine(lm, plan=None, **kw):
    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
    from neuronx_distributed_tpu_torch.inference.faults import FaultPlan

    plans = {"dispatch": (RECOVERY_DISPATCH_PLAN, 3),
             "chaos": (RECOVERY_CHAOS_PLAN, RECOVERY_CHAOS_RETRIES)}
    if plan is not None:
        kw.update(faults=FaultPlan(**plans[plan][0]), dispatch_retries=plans[plan][1])
    return ServeEngine(lm, **RECOVERY_ENGINE, **kw)


def _timed_method(obj, name: str, spent: dict, key: str) -> None:
    """Add the wall seconds of each call of ``obj.<name>`` to
    ``spent[key]``."""
    method = getattr(obj, name)
    spent[key] = 0.0

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return method(*a, **kw)
        finally:
            spent[key] += time.perf_counter() - t0

    setattr(obj, name, timed)


def _recovery_counts(engine) -> dict:
    pkv = engine.session.paged
    out = {k: getattr(engine, k) for k in ("decode_blocks", "blocks", "inserts",
                                           "deferred_admissions", "corrupt_page_replays",
                                           "tier_page_repairs", "injected_corruptions",
                                           "restored_requests")}
    out.update({k: getattr(pkv, k) for k in ("tier_spilled_pages", "tier_restored_pages",
                                             "tier_hits", "tier_restore_failures",
                                             "tier_repaired_pages")})
    out["dispatch_retries"] = engine.dispatch_retry_count
    out["fault_stats"] = (None if engine._injector is None
                          else {k: v for k, v in engine._injector.stats.items() if v})
    return out


def _first_replays(engine) -> dict:
    """Request id -> tokens it had delivered when it first replayed."""
    out = {}
    for ev in engine.tracer.events():
        if ev["name"] == "corrupt_replay":
            out.setdefault(ev["lane"][1], ev["args"]["delivered"])
    return out


def recovery_pass(lm, dev, trace, plan, async_loop: bool, counters, corrupt_tiered=False,
                  keep_completions=True) -> dict:
    """One pass of ``trace`` through ``run_trace`` on a tiered engine of
    ``lm`` under ``plan`` (None, ``"dispatch"`` or ``"chaos"``). The launch
    counters are zeroed just before and read just after; the host ops of
    each decode round, and the wall seconds spent in spill reads and in
    replay admissions, are counted around the engine's methods. With
    ``corrupt_tiered``, after each round every live page whose prefix
    entry holds a tier copy (and was not hit before) is declared corrupted
    (``inject_page_corruption``)."""
    from neuronx_distributed_tpu_torch.inference.engine import run_trace

    engine = _recovery_engine(lm, plan, async_loop=async_loop, keep_completions=keep_completions)
    ops = count_host_ops(engine)
    spent: dict = {}
    # the tier reads a spilled page through the callback the index holds
    _timed_method(engine.session.paged.prefix, "_read_page", spent, "spill")
    _timed_method(engine, "_replay_admission", spent, "replay")
    # each request's first insert: its block and the ids inserted with it
    admitted, insert_group = {}, engine._insert_group

    def recorded_insert(group, slot_ids):
        insert_group(group, slot_ids)
        for r in group:
            admitted.setdefault(r.request_id, (engine.blocks, sorted(x.request_id for x in group)))

    engine._insert_group = recorded_insert
    if corrupt_tiered:
        step, hit = engine.step_block, set()

        def step_and_corrupt():
            more = step()
            pkv = engine.session.paged
            victims = [p for p in pkv.live_pages()
                       if p not in hit and (pkv.prefix.node_for_page(p) is not None
                                            and pkv.prefix.node_for_page(p).tier_id is not None)]
            if victims:
                hit.update(victims)
                engine.inject_page_corruption(victims)
            return more

        engine.step_block = step_and_corrupt
    for c in counters:
        c.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    report = run_trace(engine, trace)
    _sync(dev)
    wall = time.perf_counter() - t0
    done = engine.completed
    tokens = report["total_generated_tokens"]
    st = dict(plan=plan, async_loop=async_loop, wall_s=wall, tokens_per_s=tokens / wall,
              requests=report["requests_completed"], generated_tokens=tokens,
              **host_op_stats(ops), nonfinite_logits=engine.nonfinite_logits,
              launches={c.__name__: c.launches for c in counters},
              counts=_recovery_counts(engine), capture_s=engine.capture_s,
              spill_read_s=spent["spill"], replay_s=spent["replay"],
              tier_restore_ms_p99=report.get("tier_restore_ms_p99"),
              tier_d2h_copies=engine.tier_d2h_copies, tier_h2d_copies=engine.tier_h2d_copies,
              tier_blocking_spills=engine.tier_blocking_spills,
              recovery_fetches=engine.recovery_fetches, streaming=not keep_completions,
              streams={c.request_id: c.tokens.tolist() for c in done},
              schedule={c.request_id: (c.queue_blocks, c.ttft_blocks, c.decode_blocks)
                        for c in done},
              first_replays=_first_replays(engine) if keep_completions else {},
              admitted=admitted,
              attribution=attribution_check(engine.tracer)[0] if keep_completions else [])
    return st


def recovery_crash_pass(lm, dev, trace, counters, path: Path) -> dict:
    """Pass (k): the reference setup runs with ``run(snapshot_path=...,
    snapshot_every_blocks=RECOVERY_SNAPSHOT_EVERY,
    max_blocks=RECOVERY_CRASH_BLOCKS)`` and stops at a snapshot (the
    crash); ``ServeEngine.from_snapshot(lm, path)`` runs the rest with the
    same ``snapshot_path``, whose clean drain removes the file."""
    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine

    engine = _recovery_engine(lm)
    for it in trace:
        engine.submit(it["prompt"], it["max_new_tokens"], arrival_block=it["arrival_block"])
    if path.exists():
        path.unlink()
    for c in counters:
        c.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    engine.run(max_blocks=RECOVERY_CRASH_BLOCKS, snapshot_path=str(path),
               snapshot_every_blocks=RECOVERY_SNAPSHOT_EVERY)
    _sync(dev)
    crash_s = time.perf_counter() - t0
    saved = path.exists()
    snap = json.loads(path.read_text()) if saved else {"requests": []}
    before = {c.request_id: c.tokens.tolist() for c in engine.completed}
    engine.close()   # the crashed engine is gone: the restore takes over its state
    t1 = time.perf_counter()
    restored = ServeEngine.from_snapshot(lm, str(path))
    restored.run(snapshot_path=str(path))
    _sync(dev)
    wall = crash_s + time.perf_counter() - t1
    after = {c.request_id: c.tokens.tolist() for c in restored.completed}
    tokens = sum(map(len, before.values())) + sum(map(len, after.values()))
    return dict(wall_s=wall, tokens_per_s=tokens / wall, generated_tokens=tokens,
                snapshot_saved=saved, file_removed=not path.exists(),
                capture_s=restored.capture_s, restored_requests=restored.restored_requests,
                launches={c.__name__: c.launches for c in counters},
                nonfinite_logits=engine.nonfinite_logits + restored.nonfinite_logits,
                counts=_recovery_counts(restored), before=before, after=after,
                at_snapshot={int(r["request_id"]): r["generated"] for r in snap["requests"]})


def before_replay(chaos: dict, ref: dict) -> dict:
    """Tokens a chaos pass's streams delivered before their first replay,
    against the reference pass's: how many, how many equal, and the
    requests that differ with their first insert in each pass (block, the
    ids inserted together). Exact in fp32 on the CPU; in bf16 on the card
    a request inserted in another group (a pool storm split it, a failed
    tier read re-prefilled its prefix) reads other GEMM roundings."""
    total = same = 0
    differ = {}
    for rid, n in chaos["first_replays"].items():
        got, want = chaos["streams"].get(rid, [])[:n], ref["streams"].get(rid, [])[:n]
        total += n
        same += sum(int(x == y) for x, y in zip(got, want))
        if got != want:
            differ[rid] = (chaos["admitted"].get(rid), ref["admitted"].get(rid))
    return dict(tokens=total, equal=same, differ=differ)


def recovery_coverage(st: dict) -> list:
    """The seams the chaos pass must fire: what it did not."""
    c, fs = st["counts"], st["counts"].get("fault_stats") or {}
    return [f"pass (i) has no {what}" for what, n in (
        ("alloc fault", fs.get("alloc_faults")), ("dispatch retry", c["dispatch_retries"]),
        ("corrupted page", fs.get("pages_corrupted")),
        ("corrupt-page replay", c["corrupt_page_replays"]),
        ("tier restore", c["tier_restored_pages"]),
        ("tier failure or checksum failure", c["tier_restore_failures"])) if not n]


def recovery_gates(passes: dict, predicted: dict) -> list:
    """The recovery phase's gates on its passes (label -> dict); returns
    what failed, empty when every gate held. (h), (l) and (m) match (g):
    (h) and (l) bit for bit and schedule for schedule, (m) in its totals;
    (i) and (j) make the same decisions with the same streams and every
    request completes with its full length (their tokens before a replay
    against (g)'s: :func:`before_replay`, exact on the CPU, reported on
    the card); (i) fires every seam; (k)
    resumes every request from a snapshot that holds (g)'s tokens, removes
    the file on its clean drain and reuses the captured graph; (l) repairs
    each page in place with no replay. Every pass launches B1 and B2 and
    keeps the decode block's host ops (a steady block 2, any at most 3),
    and every count the CPU predicted (``predicted``: label -> counts)
    comes out exactly."""
    problems = []
    g = passes["g"]
    full = RECOVERY_KNOBS["max_new_tokens"]
    for label, st in passes.items():
        for fn, n in st["launches"].items():
            if n <= 0:
                problems.append(f"pass ({label}) never launched {fn}")
        if "steady_ok" in st and not (st["steady_ok"] and st["blocks_ok"]):
            problems.append(f"pass ({label}): host ops a decode block {st['host_ops']}")
        if st.get("nonfinite_logits"):
            problems.append(f"pass ({label}): {st['nonfinite_logits']} non-finite logit rows")
        want = predicted.get(label)
        if want is not None and {k: st["counts"].get(k) for k in want} != want:
            problems.append(f"pass ({label}) counts {st['counts']} differ from the CPU's {want}")
        problems += [f"pass ({label}) attribution: {p}" for p in st.get("attribution", ())]
    for label in ("g", "h", "i", "j", "l"):
        st = passes[label]
        if len(st["streams"]) != RECOVERY_REQUESTS or any(
                len(t) != full for t in st["streams"].values()):
            problems.append(f"pass ({label}): not every request completed with {full} tokens")
    for label in ("h", "l"):
        if passes[label]["streams"] != g["streams"]:
            problems.append(f"pass ({label}) streams differ from pass (g)'s")
        if passes[label]["schedule"] != g["schedule"]:
            problems.append(f"pass ({label}) schedule differ from pass (g)'s")
    i, j = passes["i"], passes["j"]
    for key in ("streams", "schedule", "counts", "first_replays"):
        if i[key] != j[key]:
            problems.append(f"passes (i) and (j) {key} differ")
    problems += recovery_coverage(i)
    if not passes["h"]["counts"]["dispatch_retries"]:
        problems.append("pass (h) retried no dispatch")
    k = passes["k"]
    if set(k["before"]) & set(k["after"]) or len(set(k["before"]) | set(k["after"])) != \
            RECOVERY_REQUESTS:
        problems.append("pass (k): the completions before and after the crash do not cover "
                        "every request once")
    if any(len(t) != full for t in list(k["before"].values()) + list(k["after"].values())):
        problems.append(f"pass (k): a request completed with fewer than {full} tokens")
    if any(k["before"][rid] != g["streams"].get(rid) for rid in k["before"]) or any(
            toks != g["streams"].get(rid, [])[:len(toks)] for rid, toks in
            k["at_snapshot"].items()):
        problems.append("pass (k): tokens delivered before the snapshot differ from (g)'s")
    if not k["snapshot_saved"] or not k["restored_requests"]:
        problems.append("pass (k): no snapshot to restore from")
    if not k["file_removed"]:
        problems.append("pass (k): the snapshot file survived the clean drain")
    if k["capture_s"] > 0.05:
        problems.append(f"pass (k): the restored engine captured again ({k['capture_s']:.3f} s)")
    lc = passes["l"]["counts"]
    if not lc["injected_corruptions"] or lc["corrupt_page_replays"] or \
            lc["tier_page_repairs"] != lc["injected_corruptions"]:
        problems.append(f"pass (l): {lc['injected_corruptions']} pages corrupted, "
                        f"{lc['tier_page_repairs']} repaired, {lc['corrupt_page_replays']} "
                        f"replays")
    m = passes["m"]
    if (m["requests"], m["generated_tokens"]) != (g["requests"], g["generated_tokens"]):
        problems.append("pass (m) totals differ from pass (g)'s")
    return problems


def recovery_passes(lm, dev, counters, snapshot_path: Path, trace=None, labels=None) -> dict:
    """Passes (g)-(m) of the recovery phase (or those in ``labels``) on
    ``lm``, over ``trace`` (by default :func:`recovery_trace` at the
    model's vocabulary)."""
    trace = recovery_trace(lm.config.vocab_size) if trace is None else trace
    passes = {}
    for label, plan, async_loop in RECOVERY_PASSES:
        if labels is None or label in labels:
            passes[label] = recovery_pass(lm, dev, trace, plan, async_loop, counters)
    if labels is None or "k" in labels:
        passes["k"] = recovery_crash_pass(lm, dev, trace, counters, snapshot_path)
    if labels is None or "l" in labels:
        passes["l"] = recovery_pass(lm, dev, trace, None, False, counters, corrupt_tiered=True)
    if labels is None or "m" in labels:
        passes["m"] = recovery_pass(lm, dev, trace, None, False, counters,
                                    keep_completions=False)
    return passes


def run_recovery_phase(lm, dev, counters) -> dict:
    """The recovery trace served seven times on ``lm`` (:func:`recovery_lm`)
    after one untimed warm-up: (g) the reference, (h) dispatch faults in the
    pipelined loop, (i) and (j) the chaos plan in both loops, (k) crash and
    restore, (l) tier repair, (m) the streaming report; hard gates
    :func:`recovery_gates` with the CPU's predicted counts. Reported: each
    pass's tokens/s, ``tier_restore_ms_p99``, the wall of spill reads and
    of replays, and the share of (i)'s tokens equal to (g)'s."""
    trace = recovery_trace(lm.config.vocab_size)
    recovery_pass(lm, dev, trace, None, False, counters)   # warm-up: shapes, the capture
    path = ROOT / "build" / "recovery.snap"
    path.parent.mkdir(parents=True, exist_ok=True)
    passes = recovery_passes(lm, dev, counters, path)
    problems = recovery_gates(passes, RECOVERY_PREDICTED)
    check(not problems, "recovery: " + "; ".join(problems))
    g, i = passes["g"]["streams"], passes["i"]["streams"]
    same = sum(int(x == y) for rid, ts in i.items() for x, y in zip(ts, g.get(rid, [])))
    pre = before_replay(passes["i"], passes["g"])
    for st in passes.values():   # kept off the printed summary
        for key in ("streams", "schedule", "first_replays", "before", "after", "at_snapshot",
                    "admitted"):
            st.pop(key, None)
    return dict(passes=passes, requests=RECOVERY_REQUESTS, knobs=dict(RECOVERY_KNOBS),
                pool_pages=RECOVERY_POOL_PAGES, tier_pages=RECOVERY_TIER_PAGES,
                dispatch_plan=dict(RECOVERY_DISPATCH_PLAN), chaos_plan=dict(RECOVERY_CHAOS_PLAN),
                token_match_i_g=same / max(passes["i"]["generated_tokens"], 1),
                before_replay_i_g=pre)


# --- phase 4e: tenants on one pool ------------------------------------------------

# the serve phase's weights behind an adapter pool of rank 16 (slot 0 the
# identity, five usable slots for eight adapters: loads, hits, LRU
# evictions and a full pool) and a pool of four grammar slots of 64 states
TENANT_LM = dict(buckets=TRACE_BUCKETS, max_batch=8, page_size=16, paged_attn_kernel=True,
                 lora_rank=16, lora_slots=6, grammar_slots=4, grammar_states=64)
TENANT_ADAPTERS = 8        # a0..a7, ranks 8 and 16 alternately
TENANT_REQUESTS = 32
# seed 2, not 5: at seed 5 no more than five adapters are ever pinned at
# once (the CPU rehearsal: 0 rejects), at seed 2 the pool fills three times
TENANT_KNOBS = dict(prompt_lens=(64, 128, 256, 384), max_new_tokens=64,
                    mean_interarrival_blocks=0.5, shared_prefix_len=256, prefix_families=2,
                    adapters=TENANT_ADAPTERS, adapter_skew=1.0, tenants=2, seed=2)
TENANT_JSON = {"type": "object", "properties": {"a": {"type": "integer"},
                                                "ok": {"type": "boolean"}}}
TENANT_GRAMMARS = {"gnum": {"regex": "-?[0-9]{1,3}"}, "gab": {"regex": "a[ab]*b"},
                   "gjson": {"json_schema": TENANT_JSON},
                   "gmail": {"regex": "[a-z]{1,8}@[a-z]{1,8}\\.com"}}
TENANT_GRAMMAR_KNOBS = dict(grammar_frac=0.5, grammars=tuple(TENANT_GRAMMARS))
# chosen on the CPU so that every verdict of both seams fires in pass (s)
TENANT_CHAOS_PLAN = dict(seed=3, adapter_load_fail_prob=0.1, adapter_corrupt_prob=0.1,
                         grammar_load_fail_prob=0.1, grammar_corrupt_prob=0.1)
# (label, grammars, async_loop, chaos): the passes through run_trace
TENANT_PASSES = (("o", False, False, False), ("p", False, True, False),
                 ("q", True, False, False), ("r", True, True, False), ("s", True, False, True))
# the counts of passes (o) and (p), a function of the trace alone (greedy,
# no EOS, no grammar): read from the CPU rehearsal at one layer
# (scripts/tenants_rehearsal.py), held exactly on the card
TENANT_COUNT_KEYS = ("adapter_loads", "adapter_hits", "adapter_evictions", "adapter_rejects",
                     "decode_blocks", "blocks", "inserts", "prefix_hits", "completed",
                     "rejected")
_TENANT_O = dict(adapter_loads=8, adapter_hits=21, adapter_evictions=3, adapter_rejects=3,
                 decode_blocks=33, blocks=33, inserts=22, prefix_hits=18, completed=29,
                 rejected=3)
TENANT_PREDICTED = {"o": _TENANT_O, "p": _TENANT_O}
# (t): one full-width decoder layer in fp32, an adapter in a pool slot
# against the same layer with the adapter merged into its weights: the
# largest |difference| of the outputs (of size about 1) allowed
TOL_LORA_LAYER = 1e-4


def tenant_lm(cfg, dev, params):
    """The ``CausalLM`` of the tenants phase: the serve phase's widths and
    weights (shared, not copied), the trace phase's buckets, both pools."""
    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM

    return CausalLM(cfg, params, LlamaForCausalLM, device=dev, **TENANT_LM)


def tenant_adapters(cfg, n: int = TENANT_ADAPTERS) -> dict:
    """``a0``.. ``a{n-1}``: the port's ``init_lora`` over ``cfg``'s weights
    (their shapes), ranks 8 and 16 alternately (alpha twice the rank), each
    from its own generator, with B 0.05 * normal (B = 0 would be the base
    model). Name -> (tree, LoraConfig), on the host."""
    import torch

    from neuronx_distributed_tpu_torch.lora import LoraConfig, init_lora
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM

    with torch.device("meta"):
        shapes = LlamaForCausalLM(cfg).state_dict()
    out = {}
    for i in range(n):
        r = 8 if i % 2 == 0 else 16
        lcfg = LoraConfig(r=r, lora_alpha=2.0 * r)
        gen = torch.Generator().manual_seed(100 + i)
        tree = init_lora(shapes, lcfg, gen)
        for ad in tree.values():
            ad["lora_b"] = 0.05 * torch.randn(ad["lora_b"].shape, generator=gen)
        out[f"a{i}"] = (tree, lcfg)
    return out


def tenant_trace(vocab: int, grammars: bool) -> list:
    from neuronx_distributed_tpu_torch.inference.trace import synthetic_trace

    return synthetic_trace(TENANT_REQUESTS, vocab, **TENANT_KNOBS,
                           **(TENANT_GRAMMAR_KNOBS if grammars else {}))


def tenant_regex() -> dict:
    """Each grammar's regex, for the parse oracle (Python ``re``)."""
    from neuronx_distributed_tpu_torch.inference.grammar import json_schema_to_regex

    return {n: s["regex"] if "regex" in s else json_schema_to_regex(s["json_schema"])
            for n, s in TENANT_GRAMMARS.items()}


def time_blocks(engine) -> list:
    """CUDA events around each decode-block replay of ``engine`` (one
    pair a block, read after the pass); empty off CUDA."""
    import torch

    runner, events = engine._fused, []
    if engine.lm.device.type != "cuda":
        return events

    def timed(session):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = runner(session)
        b.record()
        events.append((a, b))
        return out

    engine._fused = timed
    return events


def _pct(xs, q):
    import numpy as np

    return float(np.percentile(xs, q)) if len(xs) else None


def _tenant_counts(engine) -> dict:
    pool, gpool = engine.session.adapters, engine.session.grammars
    return dict(adapter_loads=pool.loads, adapter_hits=pool.hits,
                adapter_evictions=pool.evictions, adapter_rejects=engine.adapter_rejects,
                adapter_repairs=pool.repairs, adapter_garbled=pool.garbled,
                adapter_load_retries=engine.adapter_load_retries,
                grammar_loads=gpool.loads, grammar_hits=gpool.hits,
                grammar_evictions=gpool.evictions, grammar_rejects=engine.grammar_rejects,
                grammar_repairs=gpool.repairs, grammar_garbled=gpool.garbled,
                grammar_load_retries=engine.grammar_load_retries,
                decode_blocks=engine.decode_blocks, blocks=engine.blocks, inserts=engine.inserts,
                prefix_hits=engine.session.paged.prefix_hits, completed=len(engine.completed),
                rejected=len(engine.rejected))


def tenant_pass(lm, dev, trace, adapters, async_loop: bool, plan, counters) -> dict:
    """One pass of ``trace`` through ``run_trace`` on a ``ServeEngine`` of
    ``lm`` (``block_steps=8``) with the adapters and grammars registered
    (timed apart) and ``plan`` (a ``FaultPlan``'s knobs, or None). The
    launch counters are zeroed just before and read just after; counted
    around the engine: the host ops of each decode round, each block's
    device ms (CUDA events around the replay) and each request's first
    insert (block, the ids inserted with it, the prefix tokens it reused)."""
    import re

    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine, run_trace
    from neuronx_distributed_tpu_torch.inference.faults import FaultPlan
    from neuronx_distributed_tpu_torch.inference.grammar import default_token_table, detokenize

    engine = ServeEngine(lm, block_steps=8, async_loop=async_loop,
                         faults=None if plan is None else FaultPlan(**plan))
    t0 = time.perf_counter()
    for name, (tree, lcfg) in adapters.items():
        engine.register_adapter(name, tree, lcfg)
    for name, spec in TENANT_GRAMMARS.items():
        engine.register_grammar(name, **spec)
    register_s = time.perf_counter() - t0
    ops, block_events = count_host_ops(engine), time_blocks(engine)
    admitted, insert_group = {}, engine._insert_group

    def recorded_insert(group, slot_ids):
        pkv = engine.session.paged
        hits = [pkv.prefix_peek(r.prompt.tolist(), ns=r.adapter) for r in group]
        insert_group(group, slot_ids)
        ids = sorted(r.request_id for r in group)
        for r, h in zip(group, hits):
            admitted.setdefault(r.request_id, (engine.blocks, ids, h))

    engine._insert_group = recorded_insert
    for c in counters:
        c.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    report = run_trace(engine, trace)
    _sync(dev)
    wall = time.perf_counter() - t0
    done = engine.completed
    tokens = report["total_generated_tokens"]
    table = default_token_table(lm.config.vocab_size)
    regex = tenant_regex()
    constrained = [c for c in done if c.grammar is not None]
    parsed = sum(1 for c in constrained
                 if re.fullmatch(regex[c.grammar], detokenize(c.tokens, table)))
    block_ms = [a.elapsed_time(b) for a, b in block_events]
    pool, gpool = engine.session.adapters, engine.session.grammars
    return dict(
        async_loop=async_loop, plan=plan, submitted=len(trace), wall_s=wall,
        tokens_per_s=tokens / wall, generated_tokens=tokens, register_s=register_s,
        **host_op_stats(ops), nonfinite_logits=engine.nonfinite_logits,
        capture_s=engine.capture_s, launches={c.__name__: c.launches for c in counters},
        counts=_tenant_counts(engine),
        fault_stats=(None if engine._injector is None
                     else {k: v for k, v in engine._injector.stats.items() if v}),
        decode_block_ms_p50=_pct(block_ms, 50),
        decode_block_ms_mean=sum(block_ms) / len(block_ms) if block_ms else None,
        acquire_ms_p50=_pct(pool.acquire_ms, 50), acquire_ms_p99=_pct(pool.acquire_ms, 99),
        adapter_load_ms_p50=_pct(pool.load_ms, 50),
        grammar_acquire_ms_p50=_pct(gpool.acquire_ms, 50),
        grammar_acquire_ms_p99=_pct(gpool.acquire_ms, 99),
        interblock_gap_ms_p50=report.get("interblock_gap_ms_p50"),
        interblock_gap_ms_p99=report.get("interblock_gap_ms_p99"),
        fetch_blocked_ms_p50=report.get("fetch_blocked_ms_p50"),
        constrained=len(constrained), parsed=parsed,
        finish_reasons=dict(sorted(collections.Counter(c.finish_reason for c in done).items())),
        streams={c.request_id: c.tokens.tolist() for c in done},
        schedule={c.request_id: (c.queue_blocks, c.ttft_blocks, c.decode_blocks) for c in done},
        rejected=sorted((r.request_id, r.reason) for r in engine.rejected),
        admitted=admitted, attribution=attribution_check(engine.tracer)[0],
        compile_ms={n: gpool.compile_ms_of(n) for n in TENANT_GRAMMARS})


def same_adapter_hits(st: dict, trace: list) -> bool:
    """Every prefix hit of a pass reused pages an earlier admission of the
    same adapter and the same shared prefix wrote (the index is namespaced
    by adapter)."""
    plen = TENANT_KNOBS["shared_prefix_len"]
    order = sorted(st["admitted"].items(), key=lambda kv: (kv[1][0], kv[0]))
    seen = set()
    for rid, (_block, group, hit) in order:
        key = (trace[rid].get("adapter"), tuple(trace[rid]["prompt"][:plen].tolist()))
        if hit and key not in seen:
            return False
        seen.add(key)
    return True


def tenant_gates(passes: dict, predicted: dict, streams_a: dict, traces: dict) -> list:
    """The tenants phase's gates on its passes (label -> dict); returns
    what failed, empty when every gate held. (n) gives trace pass (a)'s
    tokens bit for bit (slot 0 and the identity grammar touch nothing);
    (o)'s counts are the CPU's and its prefix hits same-adapter; (p) makes
    (o)'s decisions with (o)'s streams; in (q), (r), (s) every constrained
    stream parses, and (q) ends streams both on a grammar's accept state and
    on the budget; (r) gives (q)'s stream to every request admitted as in
    (q) (the same block, the same insert group, the same reused prefix: a
    grammar that ends a stream retires it a block later in the pipelined
    loop, which can move later admissions, and bf16 prefill is not
    batch-invariant); in (s) each pool repaired every slot it garbled before
    the pin and each load fault was retried. Every pass launches B1 and B2,
    keeps a decode block at one replay and one fetch (one copy more when a
    slot changed), completes or rejects every request, and reuses the one
    captured block."""
    problems = []
    n = passes["n"]
    if n["streams"] != streams_a:
        same = sum(int(x == y) for rid, ts in n["streams"].items()
                   for x, y in zip(ts, streams_a.get(rid, [])))
        problems.append(f"pass (n) tokens differ from trace pass (a)'s ({same} equal)")
    for label, st in passes.items():
        for fn, k in st["launches"].items():
            if k <= 0:
                problems.append(f"pass ({label}) never launched {fn}")
        if st.get("nonfinite_logits"):
            problems.append(f"pass ({label}): {st['nonfinite_logits']} non-finite logit rows")
        if not (st["steady_ok"] and st["blocks_ok"]):
            problems.append(f"pass ({label}): host ops a decode block {st['host_ops']}")
        if label != "n":
            c = st["counts"]
            if c["completed"] + c["rejected"] != st["submitted"]:
                problems.append(f"pass ({label}): {c['completed']} completed + {c['rejected']} "
                                f"rejected != {st['submitted']} submitted")
            if st["parsed"] != st["constrained"]:
                problems.append(f"pass ({label}): {st['parsed']} of {st['constrained']} "
                                f"constrained streams parse")
            if st["capture_s"] > 0.05:
                problems.append(f"pass ({label}) captured again ({st['capture_s']:.3f} s)")
        want = predicted.get(label)
        if want is not None and {k: st["counts"].get(k) for k in want} != want:
            problems.append(f"pass ({label}) counts {st['counts']} differ from the CPU's {want}")
        problems += [f"pass ({label}) attribution: {p}" for p in st.get("attribution", ())]
    o, p = passes["o"], passes["p"]
    for key in ("streams", "schedule", "rejected"):
        if o[key] != p[key]:
            problems.append(f"passes (o) and (p) {key} differ")
    if {k: o["counts"][k] for k in TENANT_COUNT_KEYS} != \
            {k: p["counts"][k] for k in TENANT_COUNT_KEYS}:
        problems.append("passes (o) and (p) counts differ")
    if not same_adapter_hits(o, traces["o"]):
        problems.append("pass (o) reused a prefix across adapters")
    for what, key in (("no adapter load", "adapter_loads"), ("no adapter hit", "adapter_hits"),
                      ("no adapter eviction", "adapter_evictions"),
                      ("no full adapter pool", "adapter_rejects"), ("no prefix hit", "prefix_hits")):
        if not o["counts"][key]:
            problems.append(f"pass (o) has {what}")
    q, r = passes["q"], passes["r"]
    if not {"grammar_accept", "budget"} <= set(q["finish_reasons"]):
        problems.append(f"pass (q) finish reasons {q['finish_reasons']}")
    alike = [rid for rid, a in q["admitted"].items() if r["admitted"].get(rid) == a]
    if any(q["streams"].get(rid) != r["streams"].get(rid) for rid in alike):
        problems.append("pass (r) streams differ from (q)'s for requests admitted alike")
    s = passes["s"]
    for kind in ("adapter", "grammar"):
        c, fs = s["counts"], s["fault_stats"] or {}
        if c[f"{kind}_repairs"] != c[f"{kind}_garbled"]:
            problems.append(f"pass (s): {c[f'{kind}_garbled']} {kind} slots garbled, "
                            f"{c[f'{kind}_repairs']} repaired")
        if c[f"{kind}_load_retries"] != fs.get(f"{kind}_load_faults", 0):
            problems.append(f"pass (s): {fs.get(f'{kind}_load_faults', 0)} {kind} load faults, "
                            f"{c[f'{kind}_load_retries']} retries")
    return problems


def pooled_layer_readings(c, layer_cls, dev) -> dict:
    """One decoder layer of ``layer_cls`` at config ``c`` (fp32, one layer,
    ``lora_rank`` 16 and 2 slots; seeded weights), an adapter of rank 16 in
    slot 1 of a pool: its output on two rows of 64 tokens against the same
    layer with the adapter merged into its weights (``merge_lora``), and
    slot-0 rows against the layer without LoRA."""
    import math

    import torch

    from neuronx_distributed_tpu_torch.inference.adapters import AdapterPool
    from neuronx_distributed_tpu_torch.lora import LoraConfig, init_lora, merge_lora
    from neuronx_distributed_tpu_torch.models.llama import lora_layout, rotary_embedding

    gen = torch.Generator(device=dev).manual_seed(11)
    layer = layer_cls(c, device=dev)
    sd = {}
    for name, w in layer.state_dict().items():
        t = torch.randn(w.shape, generator=gen, device=dev)
        fan_in = w.shape[1] if ".experts." in name else w.shape[0]   # experts (E, in, out)
        sd[name] = (torch.ones_like(w) if name.endswith(".scale")
                    else t * (1.0 / math.sqrt(fan_in)))
    layer.load_state_dict(sd)
    lcfg = LoraConfig(r=16, lora_alpha=32.0)
    prefix = "model.layers.0."
    full = {prefix + k: v for k, v in sd.items()}
    tree = init_lora(full, lcfg, torch.Generator().manual_seed(12))
    for ad in tree.values():
        ad["lora_b"] = 0.05 * torch.randn(ad["lora_b"].shape,
                                          generator=torch.Generator().manual_seed(13))
    layout = lora_layout(c)
    pool_buf = torch.zeros((2, 1, layout.per_layer), device=dev)
    pool = AdapterPool(pool_buf, layout)
    pool.register("a", tree, lcfg)
    slot = pool.acquire("a")
    merged = layer_cls(c, device=dev)
    merged.load_state_dict({k[len(prefix):]: v.to(dev) for k, v in
                            merge_lora(full, {k: {n: t.to(dev) for n, t in v.items()}
                                              for k, v in tree.items()}, lcfg).items()})
    x = torch.randn((2, 64, c.hidden_size), generator=gen, device=dev)
    rope = rotary_embedding(torch.arange(64, device=dev), c.head_dim_, c.rope_theta,
                            scaling=c.rope_scaling)

    def run(mod, idx):
        lora = None if idx is None else (
            pool_buf[:, 0].index_select(0, torch.as_tensor(idx, device=dev)), layout)
        with torch.no_grad():
            return mod(x, rope, None, 0, lora)

    got, want = run(layer, [slot, slot]), run(merged, None)
    return dict(max_abs_err=float((got - want).abs().max()), max_abs_ref=float(want.abs().max()),
                delta_max_abs=float((want - run(layer, None)).abs().max()),
                base_bit_identical=bool(torch.equal(run(layer, [0, 0]), run(layer, None))),
                targets=sorted(layout.groups), adapted=len(tree),
                shape=[2, 64, c.hidden_size])


def lora_layer_check(cfg, dev) -> dict:
    """Pass (t): :func:`pooled_layer_readings` for one Llama decoder layer
    at ``cfg``'s widths, held to ``TOL_LORA_LAYER`` and slot-0 rows bit for
    bit."""
    import dataclasses

    import torch

    from neuronx_distributed_tpu_torch.models.llama import LlamaDecoderLayer

    c = dataclasses.replace(cfg, num_layers=1, dtype=torch.float32, param_dtype=torch.float32,
                            use_flash_attention=False, lora_rank=16, lora_slots=2, decode=False)
    r = pooled_layer_readings(c, LlamaDecoderLayer, dev)
    check(r["max_abs_err"] <= TOL_LORA_LAYER, f"tenants (t): pooled adapter vs merged weights "
                                              f"max |err| {r['max_abs_err']:.3g} > "
                                              f"{TOL_LORA_LAYER}")
    check(r["base_bit_identical"], "tenants (t): slot-0 rows differ from the layer without LoRA")
    return dict(r, tolerance=TOL_LORA_LAYER)


def tenant_passes(lm, dev, counters, adapters, trace_n=None, labels=None):
    """Passes (o)-(s) of the tenants phase (or those in ``labels``) on
    ``lm``, and (n) when ``trace_n`` (the trace phase's trace) is given;
    returns the passes and the traces, by label."""
    passes = {}
    if trace_n is not None:
        passes["n"] = trace_pass(lm, dev, trace_n, 0, False, counters)
        del passes["n"]["schedule"]
    traces = {}
    for label, grammars, async_loop, chaos in TENANT_PASSES:
        if labels is None or label in labels:
            traces[label] = tenant_trace(lm.config.vocab_size, grammars)
            passes[label] = tenant_pass(lm, dev, traces[label], adapters, async_loop,
                                        TENANT_CHAOS_PLAN if chaos else None, counters)
    return passes, traces


def run_tenant_phase(lm, dev, counters, streams_a: dict, trace_n: list) -> dict:
    """The tenants phase on ``lm`` (:func:`tenant_lm`) after one untimed
    warm-up: (n) the trace phase's trace with no labels, (o)-(s) the
    adapter trace, then with grammars, in both loops and under faults;
    hard gates :func:`tenant_gates` with the CPU's predicted counts, one
    capture for ``lm``, and (t) :func:`lora_layer_check`. Reported: each
    pass's tokens/s, decode-block ms, acquire ms, the grammars' compile ms,
    the interblock gaps, and (s)'s share of tokens equal to (q)'s."""
    t0 = time.perf_counter()
    adapters = tenant_adapters(lm.config)
    build_s = time.perf_counter() - t0
    tenant_pass(lm, dev, tenant_trace(lm.config.vocab_size, True)[:12], adapters, False,
                None, counters)   # warm-up: the capture, the shapes
    capture_s = lm.capture_ms.get("session_fused_k8")
    passes, traces = tenant_passes(lm, dev, counters, adapters, trace_n=trace_n)
    problems = tenant_gates(passes, TENANT_PREDICTED, streams_a, traces)
    if len(lm._fused) != 1:
        problems.append(f"the tenants CausalLM captured {len(lm._fused)} blocks")
    check(not problems, "tenants: " + "; ".join(problems))
    q, r, s = passes["q"], passes["r"], passes["s"]
    alike = [rid for rid, a in q["admitted"].items() if r["admitted"].get(rid) == a]
    admitted_q = len(q["admitted"])
    same_s = sum(int(x == y) for rid, ts in s["streams"].items()
                 for x, y in zip(ts, q["streams"].get(rid, [])))
    same_r = sum(int(x == y) for rid, ts in r["streams"].items()
                 for x, y in zip(ts, q["streams"].get(rid, [])))
    layer = lora_layer_check(lm.config, dev)
    for st in passes.values():   # kept off the printed summary
        for key in ("streams", "schedule", "admitted"):
            st.pop(key, None)
    return dict(passes=passes, layer=layer, adapters_build_s=build_s,
                capture_ms=capture_s, requests=TENANT_REQUESTS, knobs=dict(TENANT_KNOBS),
                chaos_plan=dict(TENANT_CHAOS_PLAN), lm={k: v for k, v in TENANT_LM.items()},
                r_admitted_alike=len(alike), r_requests=admitted_q,
                r_token_share_equal_q=same_r / max(r["generated_tokens"], 1),
                s_token_share_equal_q=same_s / max(s["generated_tokens"], 1),
                adapter_bytes_per_slot=lm.model.model.lora_layout.per_layer
                * lm.config.num_layers * 4)


# --- phase 4f: conversations that outlive their slot --------------------------------

# eight chat sessions on the trace phase's CausalLM at SERVING_CUT_LAYERS
# layers: six with 512-token prompts and two long-context ones with 3072,
# arriving one a block; each generates 96 tokens (greedy, no EOS). A
# Llama-3-8B bf16 page of 16 tokens is 64 KiB a layer (K and V), so a
# session parked at 512 + 32 tokens holds 34 pages and one at 3072 + 32
# holds 194 (at 8 layers 17 and 97 MiB)
PARK_LENS = (512, 512, 3072, 512, 512, 3072, 512, 512)
PARK_NEW_TOKENS = 96
PARK_AT = 32            # (v), (x), (y) park a session once it delivered this many
PARK_RESUME_AFTER = 2   # (v), (x) resume it this many blocks later
PARK_IDLE_BLOCKS = 4    # (w): the engine parks a stream after 4 blocks of decoding
PARK_SEED = 11
# the degradation ladder's rungs, chosen on the CPU (scripts/park_rehearsal.py
# --seeds) so that each fires at least once in pass (x): a state-only park, a
# torn manifest, a read fault and corrupt bytes
PARK_FAULT_PLAN = dict(seed=4, park_write_fail_prob=0.5, park_read_fail_prob=0.3,
                       park_corrupt_prob=0.3)
# (v) and (x) run with SLOs and a flight recorder
PARK_SLO_MS = dict(ttft_ms=2000.0, itl_ms=500.0)
PARK_PASSES = ("u", "v", "w", "x", "y")
# pass (x)'s counts, a function of the trace and the plan alone (greedy, no
# EOS): read from the CPU rehearsal at one layer, held exactly on the card
PARK_COUNT_KEYS = ("parked", "resumed", "park_replays", "park_rejects", "fault_stats", "store")
_PARK_CLEAN = dict(park_replays=0, park_rejects=0, fault_stats=None)
PARK_PREDICTED = {
    "u": dict(parked=0, resumed=0, **_PARK_CLEAN, store=None),
    "v": dict(parked=8, resumed=8, **_PARK_CLEAN, store={"parks": 8, "loads": 8, "removed": 8}),
    "w": dict(parked=16, resumed=16, **_PARK_CLEAN,
              store={"parks": 16, "loads": 16, "removed": 16}),
    "x": dict(parked=8, resumed=1, park_replays=7, park_rejects=0,
              fault_stats={"park_write_faults": 2, "park_torn_manifests": 2,
                           "park_read_faults": 3, "park_corruptions": 1},
              store={"parks": 6, "state_only_parks": 2, "torn_parks": 2, "loads": 8,
                     "load_faults": 3, "quarantined": 3, "removed": 5}),
    "y": dict(parked=8, resumed=8, **_PARK_CLEAN, store={"loads": 8, "removed": 8}),
}


def park_trace(vocab: int) -> list:
    """The park phase's sessions: seeded prompts of ``PARK_LENS`` tokens,
    arriving one a block."""
    import numpy as np

    rng = np.random.default_rng(PARK_SEED)
    return [dict(prompt=rng.integers(1, vocab, (n,)).astype(np.int32),
                 max_new_tokens=PARK_NEW_TOKENS, arrival_block=i, eos_token_id=None)
            for i, n in enumerate(PARK_LENS)]


def attribution_problems(atts: dict) -> list:
    """The attribution invariant on request id -> attribution: the phase
    widths sum to ``end_block - origin_block`` and the segments tile the
    span, contiguous and non-empty; a problem for each request that
    breaks it."""
    problems = []
    for rid, a in sorted(atts.items()):
        cur = a["origin_block"]
        for seg in a["segments"]:
            if seg["start_block"] != cur or seg["end_block"] <= seg["start_block"]:
                problems.append(f"request {rid}: segments {a['segments']} do not tile")
                break
            cur = seg["end_block"]
        width = a["end_block"] - a["origin_block"]
        if sum(a["phases_blocks"].values()) != width or cur != a["end_block"]:
            problems.append(f"request {rid}: phases {a['phases_blocks']} do not sum to its "
                            f"{width} blocks")
    return problems


def attribution_check(tracer) -> tuple:
    """Every request ``tracer`` knows, attributed (host side, after the
    pass): ``(problems, atts)`` by :func:`attribution_problems`."""
    from neuronx_distributed_tpu_torch.observability import attribution as att

    grouped = att._events_by_request(tracer)
    problems, atts = [], {}
    for rid in att.known_request_ids(tracer):
        try:
            a = att.request_attribution(tracer, rid, grouped.get(rid, []))
        except AssertionError as e:
            problems.append(f"request {rid}: phases do not sum to its span ({e})")
            continue
        if a is not None:
            atts[rid] = a
    return problems + attribution_problems(atts), atts


def _host_ms(engine) -> dict:
    st = engine.park_store
    return {"copy_d2h": engine.park_copy_ms, "copy_h2d": engine.resume_copy_ms,
            **(st.host_ms if st is not None else {})}


def _park_one(engine, rid: int, records: list) -> None:
    """Park ``rid`` and record its wall ms, host split, durable bytes and
    whether it left no page behind (its slot's pages all freed, none in
    the prefix index, no host-tier page)."""
    pkv = engine.session.paged
    slot = next(i for i, r in enumerate(engine.slots) if r is not None and r.request_id == rid)
    req = engine.slots[slot]
    held, in_use = len(pkv.slot_pages(slot)), pkv.allocator.in_use()
    covered = req.prompt.tolist() + engine._out[rid][:-1]
    before, t0 = _host_ms(engine), time.perf_counter()
    out = engine.park(rid)
    ms = (time.perf_counter() - t0) * 1e3
    after = _host_ms(engine)
    store = engine.park_store
    records.append(dict(
        rid=rid, op="park", verdict=out, prompt_len=int(req.prompt.size),
        generated=len(covered) - int(req.prompt.size) + 1, ms=ms,
        split={k: after[k] - before[k] for k in after if after[k] != before[k]},
        bytes=store.parked_bytes(rid) if store.storage.file_exists(
            f"{store._conv_dir(rid)}/manifest.json") else None,
        pages_held=held,
        freed=in_use - pkv.allocator.in_use() == held and pkv.prefix_peek(covered) == 0
        and pkv.tier_pages() == 0))


def _resume_one(engine, rid: int, records: list) -> None:
    before, t0 = _host_ms(engine), time.perf_counter()
    out = engine.submit(resume=rid)
    after = _host_ms(engine)
    records.append(dict(rid=rid, op="resume", t0=t0, ms=(time.perf_counter() - t0) * 1e3,
                        verdict=getattr(out, "reason", "resumed"),
                        split={k: after[k] - before[k] for k in after if after[k] != before[k]}))


def _park_drive(engine, trace, records: list, resume_after) -> None:
    """Submit ``trace`` and step ``engine``: after each round, park every
    stream that has delivered ``PARK_AT`` tokens (once), and resume each
    ``resume_after`` rounds later (at once when nothing else is left to
    run; never with None)."""
    for it in trace:
        engine.submit(it["prompt"], it["max_new_tokens"], arrival_block=it["arrival_block"])
    parked_at, seen = {}, set()
    while True:
        more = engine.step_block()
        for slot, r in enumerate(engine.slots):
            if (r is not None and r.request_id not in seen and slot not in engine._prefilling
                    and len(engine._out.get(r.request_id, ())) >= PARK_AT):
                seen.add(r.request_id)
                _park_one(engine, r.request_id, records)
                parked_at[r.request_id] = engine.blocks
        resumed = False
        if resume_after is not None:
            for rid in sorted(parked_at):
                if engine.blocks >= parked_at[rid] + resume_after or not more:
                    _resume_one(engine, rid, records)
                    del parked_at[rid]
                    resumed = True
        if not more and not resumed:
            return


def _cold_ttft(engine, trace, streams: dict, records: list) -> None:
    """Per session, a fresh request whose prompt is the session's prompt and
    its first ``PARK_AT`` tokens (what a degraded resume re-prefills), alone
    in ``engine`` with its prefix cache emptied first (a resumed session's
    pages stay cached when it retires, and a hit would prefill only the
    tail): its wall TTFT from submit to first token."""
    pkv = engine.session.paged
    for rid, it in enumerate(trace):
        prompt = list(it["prompt"]) + streams[rid][:PARK_AT]
        pkv.prefix.evict(pkv.prefix.evictable_pages())
        check(pkv.prefix_peek(prompt) == 0, f"park (v): session {rid}'s cold twin hits the cache")
        t0 = time.perf_counter()
        new = engine.submit(prompt, 1)
        while engine.step_block():
            pass
        comp = next(c for c in engine.completed if c.request_id == new)
        records.append(dict(rid=rid, op="cold", prompt_len=len(it["prompt"]),
                            context=len(prompt), ttft_ms=(comp.token_ts[0] - t0) * 1e3))


def park_pass(lm, dev, trace, label: str, counters, root: Path, plan=None) -> dict:
    """One pass of the park phase (``label`` in ``PARK_PASSES``) on ``lm``,
    traced, the launch counters zeroed just before and read just after:
    (u) the reference through ``run_trace``; (v) each session parked at
    ``PARK_AT`` tokens and resumed ``PARK_RESUME_AFTER`` blocks later, then
    each session's cold twin; (w) ``async_loop`` with ``park_idle_blocks``
    through ``run_trace`` (its drain resumes what is parked); (x) (v) under
    ``plan``'s park faults; (y) every session parked, a snapshot, and a
    fresh engine from it resuming them all. (v) and (x) run with SLOs and a
    flight recorder under ``root``."""
    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine, run_trace
    from neuronx_distributed_tpu_torch.inference.faults import FaultPlan
    from neuronx_distributed_tpu_torch.observability import (
        default_slos,
        validate_incident_bundle,
    )

    kw = dict(block_steps=8, trace=True)
    if label != "u":
        kw["park_dir"] = str(root / label / "park")
    if label in ("v", "x"):
        kw.update(slos=default_slos(**PARK_SLO_MS), incident_dir=str(root / label / "incidents"))
    if label == "w":
        kw.update(async_loop=True, park_idle_blocks=PARK_IDLE_BLOCKS)
    if label == "x":
        kw["faults"] = FaultPlan(**(plan or PARK_FAULT_PLAN))
    engine = ServeEngine(lm, **kw)
    ops, records, engines = [count_host_ops(engine)], [], [engine]
    for c in counters:
        c.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    if label in ("u", "w"):
        run_trace(engine, trace)
    elif label in ("v", "x"):
        _park_drive(engine, trace, records, PARK_RESUME_AFTER)
    else:
        _park_drive(engine, trace, records, None)
        snap = engine.snapshot()
        engine.close()
        engine = ServeEngine.from_snapshot(lm, snap, trace=True)
        engines.append(engine)
        ops.append(count_host_ops(engine))
        for rid in engine.parked_ids():
            _resume_one(engine, rid, records)
        engine.run()
    _sync(dev)
    wall = time.perf_counter() - t0
    done = [c for c in engine.completed if c.request_id < len(trace)]
    streams = {c.request_id: c.tokens.tolist() for c in done}
    launches = {c.__name__: c.launches for c in counters}
    tokens = sum(len(t) for t in streams.values())
    store = engine.park_store
    degraded = sorted({ev["args"]["rid"] for e in engines
                       for ev in e.tracer.events("tier:park_degraded")})
    problems, atts = [], {}
    for e in engines:
        p, a = attribution_check(e.tracer)
        problems += p
        atts.update(a)
    kinds, bad_bundles = [], []
    for path in [] if engine.incident is None else engine.incident.bundles:
        try:
            kinds.append(validate_incident_bundle(path)["kind"])
        except (ValueError, OSError) as e:
            bad_bundles.append(f"{Path(path).name}: {e}")
    st = dict(
        label=label, wall_s=wall, generated_tokens=tokens, tokens_per_s=tokens / wall,
        requests=len(done), decode_blocks=sum(e.decode_blocks for e in engines),
        **host_op_stats([o for part in ops for o in part]), nonfinite_logits=sum(e.nonfinite_logits for e in engines),
        launches=launches, streams=streams, records=records, degraded=degraded,
        token_ts={c.request_id: c.token_ts.tolist() for c in done},
        attribution=problems,
        park_resume_blocks={rid: a["phases_blocks"].get("park_resume", 0)
                            for rid, a in atts.items()},
        counts=dict(parked=sum(e.parked for e in engines),
                    resumed=sum(e.resumed for e in engines),
                    park_replays=sum(e.park_replays for e in engines),
                    park_rejects=sum(e.park_rejects for e in engines),
                    fault_stats=(None if engine._injector is None else
                                 {k: v for k, v in engine._injector.stats.items() if v}),
                    store=(None if store is None else
                           {k: v for k, v in store.stats.items() if v})),
        slo=engine.slo_status(), incidents=kinds, incident_problems=bad_bundles,
        host_ms=_host_ms(engine) if store is not None else {})
    if label == "v":
        t1 = time.perf_counter()
        _cold_ttft(engine, trace, streams, records)
        st["cold_s"] = time.perf_counter() - t1
    return st


def park_gates(passes: dict, predicted: dict, exact_degraded: bool = False) -> list:
    """The park phase's gates on its passes (label -> the dict of
    :func:`park_pass`); returns what failed, empty when every gate held.
    Every pass completes every session with its ``PARK_NEW_TOKENS``
    tokens; (v), (w) and (y) resume every park exactly (no replay) and give
    (u)'s streams bit for bit, as do (x)'s sessions that resumed exactly
    (with ``exact_degraded``, as on the CPU in fp32, its degraded sessions
    too: in bf16 on the card a re-prefill is not batch-invariant); each
    park leaves no page behind;
    (x)'s counts are the CPU's and each rung of the ladder fires; every
    request of every pass is attributed with its phases summing to its
    span, and every session parked in (v) pays a ``park_resume`` phase;
    (v) and (x) report SLO status and (x) dumps incident bundles, each
    passing the validator; a decode block keeps its host ops (a steady one 2, any at
    most 3); each pass launches B1 and B2."""
    problems = []
    u = passes["u"]
    n = len(PARK_LENS)
    for label, st in passes.items():
        if st["requests"] != n or any(len(t) != PARK_NEW_TOKENS for t in st["streams"].values()):
            problems.append(f"pass ({label}): not every session completed with "
                            f"{PARK_NEW_TOKENS} tokens")
        for fn, k in st["launches"].items():
            if k <= 0:
                problems.append(f"pass ({label}) never launched {fn}")
        if not (st["steady_ok"] and st["blocks_ok"]):
            problems.append(f"pass ({label}): host ops a decode block {st['host_ops']}")
        if st.get("nonfinite_logits"):
            problems.append(f"pass ({label}): {st['nonfinite_logits']} non-finite logit rows")
        problems += [f"pass ({label}) attribution: {p}" for p in st["attribution"]]
        if any(not r["freed"] for r in st["records"] if r["op"] == "park"):
            problems.append(f"pass ({label}): a parked session kept device or host pages")
        if label in ("v", "w", "y") and st["degraded"]:
            problems.append(f"pass ({label}) degraded {st['degraded']}")
        if (label in ("v", "w", "y") or (label == "x" and exact_degraded)) and \
                st["streams"] != u["streams"]:
            problems.append(f"pass ({label}) streams differ from pass (u)'s")
        if label == "x" and any(st["streams"].get(rid) != u["streams"].get(rid)
                                for rid in st["streams"] if rid not in st["degraded"]):
            problems.append("pass (x): a session that resumed exactly differs from pass (u)'s")
        if label != "u" and not st["counts"]["parked"]:
            problems.append(f"pass ({label}) parked nothing")
        want = predicted.get(label)
        if want is not None and {k: st["counts"].get(k) for k in want} != want:
            problems.append(f"pass ({label}) counts {st['counts']} differ from the CPU's {want}")
    if any(b <= 0 for rid, b in passes["v"]["park_resume_blocks"].items() if rid < n):
        problems.append(f"pass (v): a parked session has no park_resume phase "
                        f"{passes['v']['park_resume_blocks']}")
    x = passes["x"]
    store, fs = x["counts"]["store"] or {}, x["counts"]["fault_stats"] or {}
    for what, k in (("state-only park", store.get("state_only_parks")),
                    ("torn manifest", store.get("torn_parks")),
                    ("read fault", fs.get("park_read_faults")),
                    ("corrupt bytes", fs.get("park_corruptions"))):
        if not k:
            problems.append(f"pass (x) has no {what}")
    for label in ("v", "x"):
        if passes[label]["slo"] is None:
            problems.append(f"pass ({label}) has no SLO status")
    if not x["incidents"]:
        problems.append("pass (x) dumped no incident bundle")
    problems += [f"pass (x) incident bundle {p}" for p in x["incident_problems"]]
    return problems


def park_passes(lm, dev, counters, root: Path, trace=None, labels=None, plan=None) -> dict:
    """The park phase's passes (or those in ``labels``) on ``lm`` over
    ``trace`` (by default :func:`park_trace` at the model's vocabulary)."""
    trace = park_trace(lm.config.vocab_size) if trace is None else trace
    return {label: park_pass(lm, dev, trace, label, counters, root, plan=plan)
            for label in PARK_PASSES if labels is None or label in labels}


def _split_by_len(records: list, op: str, key: str) -> dict:
    out = {}
    for length in sorted(set(PARK_LENS)):
        xs = sorted(r[key] for r in records if r["op"] == op and r.get("prompt_len") == length
                    and r.get(key) is not None)
        out[length] = dict(p50=xs[len(xs) // 2], max=xs[-1], n=len(xs)) if xs else None
    return out


def park_report(passes: dict) -> dict:
    """What the phase measured, by session length: park and resume ms
    (p50, max), resume TTFT (from ``submit(resume=)`` to the next token)
    against the cold twin's TTFT, durable bytes a session, pages a parked
    session still holds, and the host split (device copies, framing,
    crc32, sha256, file I/O) of (v)'s parks and resumes."""
    v = passes["v"]
    lens = dict(enumerate(PARK_LENS))
    resumes = [r for r in v["records"] if r["op"] == "resume"]
    for r in resumes:
        r["prompt_len"] = lens[r["rid"]]
        park = next(p for p in v["records"] if p["op"] == "park" and p["rid"] == r["rid"])
        ts = v["token_ts"][r["rid"]]
        r["ttft_ms"] = (ts[park["generated"]] - r["t0"]) * 1e3
    split = {}
    for op in ("park", "resume"):
        for length in sorted(set(PARK_LENS)):
            recs = [r for r in v["records"] if r["op"] == op and r.get("prompt_len") == length]
            keys = sorted({k for r in recs for k in r["split"]})
            split[f"{op}_{length}"] = {k: sum(r["split"].get(k, 0.0) for r in recs) / len(recs)
                                       for k in keys} if recs else None
    return dict(
        park_ms=_split_by_len(v["records"], "park", "ms"),
        resume_ms=_split_by_len(v["records"], "resume", "ms"),
        resume_ttft_ms=_split_by_len(v["records"], "resume", "ttft_ms"),
        cold_ttft_ms=_split_by_len(v["records"], "cold", "ttft_ms"),
        durable_bytes=_split_by_len(v["records"], "park", "bytes"),
        pages_held_after_park=0 if all(r["freed"] for r in v["records"] if r["op"] == "park")
        else None,
        host_split_ms=split)


def run_park_phase(lm, dev, counters) -> dict:
    """The park phase on ``lm`` (:func:`trace_lm`) after one untimed warm-up
    (the 544- and 3104-token cold shapes included), its park directories
    in a temporary directory removed at the end: passes (u)-(y), hard gates
    :func:`park_gates` with the CPU's predicted counts. Reported:
    :func:`park_report`, each pass's tokens/s, the share of (x)'s tokens
    equal to (u)'s (degraded sessions re-prefill in bf16, which is not
    batch-invariant), and the phase's command time."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    trace = park_trace(lm.config.vocab_size)
    root = Path(tempfile.mkdtemp(prefix="park-"))
    try:
        warm = park_trace(lm.config.vocab_size)[:3]
        park_pass(lm, dev, [dict(it, max_new_tokens=PARK_AT + 16) for it in warm], "v", counters,
                  root / "warm")
        passes = park_passes(lm, dev, counters, root, trace=trace)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    problems = park_gates(passes, PARK_PREDICTED)
    check(not problems, "park: " + "; ".join(problems))
    u, x = passes["u"]["streams"], passes["x"]["streams"]
    degraded = passes["x"]["degraded"]
    same = sum(int(a == b) for rid in degraded for a, b in zip(x[rid], u[rid]))
    report = park_report(passes)
    for st in passes.values():   # kept off the printed summary
        for key in ("streams", "records", "token_ts"):
            st.pop(key, None)
    return dict(passes=passes, report=report, lens=PARK_LENS, new_tokens=PARK_NEW_TOKENS,
                park_at=PARK_AT, idle_blocks=PARK_IDLE_BLOCKS, plan=dict(PARK_FAULT_PLAN),
                x_degraded=degraded,
                x_degraded_token_share_equal_u=same / max(
                    sum(len(x[r]) for r in degraded), 1),
                phase_s=time.perf_counter() - t0)



# --- phases 3b and 5: training ----------------------------------------------------


# --- phase 4g: captured programs and speculation ------------------------------------

# speculation and Medusa: one 512-token prompt (the flash kernel's prefill),
# 128 new tokens, γ = 4 proposals a round, 4 rounds a fused block
SPEC_BUCKETS = (128, 512)
SPEC_PROMPT = 512
SPEC_NEW = 128
SPEC_DRAFT = 4
SPEC_ROUNDS = 4
SPEC_TEMPERATURE = 0.8
SPEC_DRAFT_LAYERS = 2     # the different draft: Llama-3-8B widths, 2 layers, its own seed
EXACT_LAYERS = 2          # the fp32 exactness checks: the serve weights' first 2 layers
MEDUSA_HEADS = 2


def pool_bytes(pool):
    """Bytes the caching allocator holds in graph pool ``pool`` (None when
    the snapshot does not name pools)."""
    import torch

    segs = torch.cuda.memory_snapshot()
    if not any("segment_pool_id" in s for s in segs):
        return None
    return sum(s["total_size"] for s in segs if tuple(s.get("segment_pool_id") or ()) == tuple(pool))


def program_route_gates(captured: dict, eager: dict) -> list:
    """(z1): the eager route's passes against the captured ones (the trace
    phase's): streams bit-identical, every request complete; a chunked
    eager pass keeps the host-op gate."""
    problems = []
    for label, st in eager.items():
        if st["streams"] != captured[label]:
            problems.append(f"pass ({label}): captured and eager streams differ")
        if st["requests"] != TRACE_REQUESTS:
            problems.append(f"pass ({label}): {st['requests']} of {TRACE_REQUESTS} completed")
        if st["prefill_chunk_tokens"] and not (st["steady_ok"] and st["blocks_ok"]):
            problems.append(f"pass ({label}): host ops a decode block {st['host_ops']}")
    return problems


def per_call_ms(st: dict, kind: str):
    n = st["dispatches"].get(kind, 0)
    return st["dispatch_ms"][kind] / n if n else None


def run_eager_trace(lm, dev, counters, captured: dict) -> dict:
    """(z1) The trace phase's three passes again on ``lm`` with the insert,
    extend and decode forwards run eagerly (``capture_programs=False``; the
    decode block stays captured), held against the trace phase's captured
    streams."""
    import torch

    from neuronx_distributed_tpu_torch.inference.trace import synthetic_trace

    trace = synthetic_trace(TRACE_REQUESTS, lm.config.vocab_size, **TRACE_KNOBS)
    lm.capture_programs = False
    try:
        eager = {label: trace_pass(lm, dev, trace, chunk, async_loop, counters)
                 for label, chunk, async_loop in TRACE_PASSES}
    finally:
        lm.capture_programs = True
    problems = program_route_gates(captured, eager)
    check(not problems, "captured programs: " + "; ".join(problems))
    for st in eager.values():
        del st["streams"], st["schedule"]
    return dict(passes=eager, pool_bytes=pool_bytes(lm._graph_pool()),
                peak_bytes=torch.cuda.max_memory_allocated(),
                capture_ms={k: v for k, v in lm.capture_ms.items()})


def spec_prompt(vocab: int):
    import numpy as np

    return np.random.default_rng(21).integers(1, vocab, (1, SPEC_PROMPT)).astype(np.int32)


def spec_lm(cfg, params, dev):
    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM

    return CausalLM(cfg, params, LlamaForCausalLM, buckets=SPEC_BUCKETS, max_batch=1,
                    device=dev)


def first_layers(params, n: int, dtype=None) -> dict:
    """The embedding, final norm, head and the first ``n`` layers of
    ``params`` (in ``dtype`` when given: a copy)."""
    keep = {k: v for k, v in params.items()
            if not k.startswith("model.layers.") or int(k.split(".")[2]) < n}
    return keep if dtype is None else {k: v.to(dtype) for k, v in keep.items()}


def timed(fn, dev):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def spec_gates(runs: dict, gen, exact: bool) -> list:
    """Speculation's gates on one set of runs (``runs[draft][mode]``:
    ``host``/``fused`` results, greedy and sampled): fused equals the host
    loop bit for bit; two host operations a fused block; the self-draft
    accepts every proposal (``exact``: the fp32 checks, where the target's
    verify and the draft's step round alike); ``exact``: greedy tokens equal
    ``generate``'s."""
    import numpy as np

    problems = []
    for draft, by_mode in runs.items():
        for mode, r in by_mode.items():
            if not np.array_equal(r["host"].tokens, r["fused"].tokens):
                problems.append(f"{draft} {mode}: fused and host-loop tokens differ")
            if r["fused"].stats["host_dispatches_per_block"] != 2:
                problems.append(f"{draft} {mode}: host dispatches a block "
                                f"{r['fused'].stats['host_dispatches_per_block']}")
            if exact and draft == "self" and r["host"].stats["acceptance_rate"] != 1.0:
                problems.append(f"self-draft {mode}: acceptance "
                                f"{r['host'].stats['acceptance_rate']}")
            if exact and mode == "greedy" and not np.array_equal(r["host"].tokens, gen.tokens):
                problems.append(f"{draft}: fp32 greedy tokens differ from generate's")
    return problems


def _spec_runs(target, drafts: dict, prompt, collect_stats=False) -> dict:
    from neuronx_distributed_tpu_torch.inference.speculative import (
        speculative_decode_fused,
        speculative_generate,
    )

    runs = {}
    for name, draft in drafts.items():
        runs[name] = {}
        for mode, kw in (("greedy", {}), ("sampled", dict(greedy=False,
                                                          temperature=SPEC_TEMPERATURE,
                                                          seed=3))):
            common = dict(max_new_tokens=SPEC_NEW, num_draft=SPEC_DRAFT, **kw)
            runs[name][mode] = dict(
                host=speculative_generate(target, draft, prompt, collect_stats=collect_stats,
                                          **common),
                fused=speculative_decode_fused(target, draft, prompt,
                                               rounds_per_block=SPEC_ROUNDS, **common))
    return runs


def run_speculation(cfg, dev, params, counters) -> dict:
    """(z2) Draft-model speculation of one 512-token prompt on the serve
    weights (bf16, at the depth given), the target on the slab path: a self-draft
    (a second ``CausalLM`` on the same tensors) and a 2-layer draft at full
    width on its own seed, host loop and fused block, greedy and sampled;
    tokens/s of the fused block against ``generate(fused_chunk=8)`` in the
    same call. Then the fp32 checks on the serve weights' first 2 layers
    (and the draft in fp32). Gates: :func:`spec_gates` (exactness in fp32
    only)."""
    import dataclasses

    import numpy as np
    import torch

    from neuronx_distributed_tpu_torch.inference.speculative import speculative_decode_fused
    from neuronx_distributed_tpu_torch.models.llama import init_params

    prompt = spec_prompt(cfg.vocab_size)
    dcfg = dataclasses.replace(cfg, num_layers=SPEC_DRAFT_LAYERS)
    dparams = init_params(dcfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    target = spec_lm(cfg, params, dev)
    drafts = {"self": spec_lm(cfg, params, dev), "2-layer": spec_lm(dcfg, dparams, dev)}
    target.generate(prompt, SPEC_NEW, fused_chunk=8)             # warm: captures
    for c in counters:
        c.launches = 0
    gen, gen_s = timed(lambda: target.generate(prompt, SPEC_NEW, fused_chunk=8), dev)
    runs = _spec_runs(target, drafts, prompt, collect_stats=True)
    launches = {c.__name__: c.launches for c in counters}
    problems = spec_gates(runs, gen, exact=False)
    report = {}
    for name, draft in drafts.items():
        fused, wall = timed(lambda: speculative_decode_fused(
            target, draft, prompt, SPEC_NEW, num_draft=SPEC_DRAFT,
            rounds_per_block=SPEC_ROUNDS), dev)
        host = runs[name]["greedy"]["host"]
        report[name] = dict(
            host_stats=host.stats, fused_stats=fused.stats,
            sampled_acceptance=runs[name]["sampled"]["host"].stats["acceptance_rate"],
            fused_tokens_per_s=SPEC_NEW / wall,
            bf16_share_equal_generate=float(np.mean(fused.tokens == gen.tokens)))
    del target, drafts
    gc.collect()
    torch.cuda.empty_cache()
    # fp32 exactness at 2 layers
    cfg32 = dataclasses.replace(cfg, num_layers=EXACT_LAYERS, dtype=torch.float32,
                                param_dtype=torch.float32)
    p32 = first_layers(params, EXACT_LAYERS, torch.float32)
    d32 = {k: v.float() for k, v in dparams.items()}
    del dparams
    target = spec_lm(cfg32, p32, dev)
    drafts = {"self": spec_lm(cfg32, p32, dev),
              "2-layer": spec_lm(dataclasses.replace(cfg32, num_layers=SPEC_DRAFT_LAYERS), d32,
                                 dev)}
    gen32 = target.generate(prompt, SPEC_NEW)
    runs32 = _spec_runs(target, drafts, prompt)
    problems += [f"fp32 {p}" for p in spec_gates(runs32, gen32, exact=True)]
    check(not problems, "speculation: " + "; ".join(problems))
    del target, drafts, p32, d32
    gc.collect()
    torch.cuda.empty_cache()
    return dict(prompt_len=SPEC_PROMPT, new_tokens=SPEC_NEW, num_draft=SPEC_DRAFT,
                rounds_per_block=SPEC_ROUNDS, generate_tokens_per_s=SPEC_NEW / gen_s,
                drafts=report, launches=launches,
                fp32_acceptance={n: {m: r["host"].stats["acceptance_rate"]
                                     for m, r in by.items()} for n, by in runs32.items()})


def medusa_heads(cfg, dev, dtype, seed: int = 2) -> dict:
    """Seeded Medusa heads: ResBlocks zero (the JAX package's init), each
    head's vocabulary projection normal with std 1/sqrt(hidden)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for i in range(MEDUSA_HEADS):
        out[f"medusa_res_{i}.kernel"] = torch.zeros((cfg.hidden_size, cfg.hidden_size),
                                                    dtype=dtype, device=dev)
        out[f"medusa_res_{i}.bias"] = torch.zeros((cfg.hidden_size,), dtype=dtype, device=dev)
        out[f"medusa_head_{i}.kernel"] = (torch.randn(
            (cfg.hidden_size, cfg.vocab_size), generator=g, device=dev, dtype=torch.float32)
            / math.sqrt(cfg.hidden_size)).to(dtype)
    return out


def run_medusa(cfg, dev, params, counters, gen_tokens=None) -> dict:
    """(z3) Medusa tree decoding (``DEFAULT_CHOICES``) of the speculation
    prompt on the serve weights with two seeded heads, bf16 at the depth given,
    timed on its second run (the programs captured on the first); then the
    fp32 check on the first 2 layers: the tokens must equal greedy
    ``generate``'s."""
    import dataclasses

    import numpy as np
    import torch

    from neuronx_distributed_tpu_torch.inference.medusa import medusa_generate, medusa_model

    prompt = spec_prompt(cfg.vocab_size)
    heads = medusa_heads(cfg, dev, cfg.param_dtype)
    model = medusa_model(cfg, {**params, **heads}, MEDUSA_HEADS, device=dev)
    medusa_generate(cfg, model, prompt, SPEC_NEW, MEDUSA_HEADS)
    for c in counters:
        c.launches = 0
    res, wall = timed(lambda: medusa_generate(cfg, model, prompt, SPEC_NEW, MEDUSA_HEADS), dev)
    launches = {c.__name__: c.launches for c in counters}
    del model, heads
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, num_layers=EXACT_LAYERS, dtype=torch.float32,
                                param_dtype=torch.float32)
    p32 = first_layers(params, EXACT_LAYERS, torch.float32)
    gen32 = spec_lm(cfg32, p32, dev).generate(prompt, SPEC_NEW)
    res32 = medusa_generate(cfg32, {**p32, **medusa_heads(cfg32, dev, torch.float32)}, prompt,
                            SPEC_NEW, MEDUSA_HEADS, device=dev)
    check(np.array_equal(res32.tokens, gen32.tokens),
          "medusa: fp32 tokens differ from greedy generate's")
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(stats=res.stats, tokens_per_s=SPEC_NEW / wall, launches=launches,
               fp32_stats=res32.stats)
    if gen_tokens is not None:
        out["bf16_share_equal_generate"] = float(np.mean(res.tokens == gen_tokens))
    return out


def run_bundle(cfg, dev, params, counters, root: Path) -> dict:
    """(z4) A program bundle: the insert forward of one 512-token row (the
    serve shape of B1: the flash kernel over the 4096-slot cache) of the
    serve weights' first 2 layers, the weights passed as arguments, traced
    (captured), saved with ``save_model`` and loaded with ``load_model``.
    Gates: the loaded program gives the live one's bits, its file holds no
    tensor data, and its call launches B1."""
    import dataclasses
    import zipfile

    import numpy as np
    import torch

    from neuronx_distributed_tpu_torch.inference.model_builder import (
        ModelBuilder,
        load_model,
        save_model,
    )
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM

    bcfg = dataclasses.replace(cfg, num_layers=EXACT_LAYERS, decode=True)
    weights = first_layers(params, EXACT_LAYERS)
    names = sorted(weights)
    with torch.device("meta"):
        model = LlamaForCausalLM(bcfg)

    def prefill(ids, last, *w):
        cache = model.new_cache(ids.shape[0], ids.device)
        logits = torch.func.functional_call(model, dict(zip(names, w)), (ids, cache))
        return logits[torch.arange(ids.shape[0], device=ids.device), last]

    ids = torch.from_numpy(spec_prompt(cfg.vocab_size)).to(dev)
    last = torch.tensor([SPEC_PROMPT - 1], device=dev)
    args = (ids, last, *(weights[n] for n in names))
    t0 = time.perf_counter()
    live = ModelBuilder().add("prefill", prefill, args).trace(device=dev)
    trace_s = time.perf_counter() - t0
    want = live.run("prefill", *args)
    path = root / "bundle"
    t0 = time.perf_counter()
    save_model(live, str(path))
    save_s = time.perf_counter() - t0
    with zipfile.ZipFile(path / "prefill_0.pt2") as z:
        data_bytes = sum(i.file_size for i in z.infolist() if "/data/" in i.filename)
    t0 = time.perf_counter()
    loaded = load_model(str(path))
    load_s = time.perf_counter() - t0
    for c in counters:
        c.launches = 0
    got = loaded.run("prefill", *args)
    _sync(dev)
    launches = {c.__name__: c.launches for c in counters}
    check(torch.equal(got, want), "bundle: the loaded program's output differs from the live "
                                  f"one's (max |diff| {float((got - want).abs().max())})")
    check(launches.get("flash_block_forward", 0) > 0,
          "bundle: the loaded program launched no flash kernel")
    check(data_bytes < 4096, f"bundle: the saved program holds {data_bytes} bytes of tensors")
    return dict(trace_s=trace_s, save_s=save_s, load_s=load_s, file_bytes=sum(
        f.stat().st_size for f in path.iterdir()), tensor_bytes_in_file=data_bytes,
        launches=launches, logits_finite=bool(torch.isfinite(got).all()),
        top_token=int(np.argmax(got.float().cpu().numpy()[0])))


# --- phase 4h: int8 weights and the Mixtral family -----------------------------------

QUANT_BLOCK_STEPS = 8
MIXTRAL_PROMPT = 512       # (q2) the batch-1 selective generate: one prompt, 64 new tokens
MIXTRAL_GEN_NEW = 64
MIXTRAL_FUSED = 8
REPLAY_REPS = 5


def mixtral_config():
    import torch

    from neuronx_distributed_tpu_torch.models.mixtral import mixtral_8x7b

    # the published widths and depth; the only cut: max_seq_len 32768 -> 4096
    return mixtral_8x7b(max_seq_len=4096, dtype=torch.bfloat16, param_dtype=torch.bfloat16)


def small_mixtral_config(threshold: float = 0.5):
    import torch

    from neuronx_distributed_tpu_torch.models.mixtral import MixtralConfig

    # the small fp32 model's widths (head_dim 128, GQA group 2), 4 experts
    return MixtralConfig(vocab_size=512, hidden_size=512, intermediate_size=1024, num_layers=2,
                         num_heads=4, num_kv_heads=2, max_seq_len=256, rope_theta=1e6,
                         num_experts=4, top_k=2, selective_loading_threshold=threshold,
                         dtype=torch.float32, param_dtype=torch.float32)


def weight_bytes(params) -> dict:
    """Bytes of a state dict by kind: int8 weights, their scales, float."""
    from neuronx_distributed_tpu_torch.quantization.core import quantized_names

    pairs = quantized_names(params)
    out = dict(int8=0, scales=0, float=0)
    for k, t in params.items():
        base = k.rpartition(".")[0]
        kind = ("int8" if k == base + ".qweight" else "scales") if base in pairs else "float"
        out[kind] += nbytes(t)
    out["total"] = sum(out.values())
    return out


def replay_ms(runner, reps: int = REPLAY_REPS) -> float:
    """Median device ms of a captured decode block's replay (``reps``
    replays after the pass: they decode on into the finished session's
    pages, which nothing reads); None off CUDA, where nothing is captured."""
    import torch

    if runner.program is None:
        return None
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        runner.program.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def quant_pass(lm, dev, counters, prompts, max_new=MAX_NEW_TOKENS, reference=None) -> dict:
    """The serve workload (``prompts``, the second prefix sharer a block
    late) behind a captured engine on ``lm``, the counters zeroed just
    before ``run()``; then the same requests behind a stepwise engine. Gates:
    every request completes in the vocabulary, finite logits, a steady
    block one replay and one fetch (any block at most one copy more), and
    the stepwise streams equal the captured ones bit for bit."""
    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine

    vocab = lm.config.vocab_size
    warm = ServeEngine(lm, block_steps=QUANT_BLOCK_STEPS)
    warm.submit(prompts[0][:130], 4)
    warm.run()
    del warm

    def serve_once(fused: bool):
        engine = ServeEngine(lm, block_steps=QUANT_BLOCK_STEPS, fused=fused)
        ops = count_host_ops(engine) if fused else None
        for i, p in enumerate(prompts):
            engine.submit(p, max_new, arrival_block=1 if i == 3 else 0)
        if fused:
            zero_launches(counters)
        _sync(dev)
        t0 = time.perf_counter()
        done = engine.run()
        _sync(dev)
        return engine, done, time.perf_counter() - t0, ops

    engine, done, wall, ops = serve_once(True)
    launches = {c.__name__: c.launches for c in counters}
    routes = routes_of(counters)
    check(engine.nonfinite_logits == 0, f"non-finite logits ({engine.nonfinite_logits} slots)")
    check(len(done) == len(prompts), f"{len(done)} of {len(prompts)} requests completed")
    for c in done:
        check(len(c.tokens) == max_new and bool(((c.tokens >= 0) & (c.tokens < vocab)).all()),
              f"request {c.request_id}: {len(c.tokens)} tokens, or one outside the vocabulary")
    hs = host_op_stats(ops)
    check(hs["steady_blocks"] > 0 and hs["steady_ok"] and hs["blocks_ok"],
          f"host ops a decode block {ops}: a steady block must be one replay and one fetch")
    streams = {c.request_id: c.tokens.tolist() for c in done}
    block_ms = replay_ms(engine._fused)
    tokens = sum(len(c.tokens) for c in done)
    del engine
    step_engine, step_done, step_wall, _ = serve_once(False)
    stepwise = {c.request_id: c.tokens.tolist() for c in step_done}
    check(stepwise == streams, "the captured block and the stepwise route gave other streams")
    del step_engine
    ttft = sorted(c.token_ts[0] - c.submit_ts for c in done)
    st = dict(requests=len(done), generated_tokens=tokens, wall_s=wall,
              tokens_per_s=tokens / wall, ttft_s_p50=ttft[len(ttft) // 2],
              decode_block_ms=block_ms,
              decode_step_ms=block_ms and block_ms / QUANT_BLOCK_STEPS,
              stepwise_wall_s=step_wall, kv_pool_bytes=lm.kv_cache_bytes()["kv_bytes"],
              launches=launches, launches_by_route=routes, streams=streams, **{k: hs[k] for k in (
                  "host_ops_per_block", "steady_blocks")})
    if reference is not None:
        same = sum(int(a == b) for rid, ts in streams.items() for a, b in zip(ts, reference[rid]))
        st["token_match_share"] = same / tokens
    return st


def quant_small_check(dev) -> dict:
    """(q3) A 2-layer fp32 Mixtral with int8 weights (the small model's
    widths, 4 experts) on ``dev`` and on the CPU: insert logits and four
    paged decode steps (3 rows: all_experts) within the small model's
    tolerance; batch-1 greedy ``generate`` streams (selective under
    threshold 1.5, all_experts under 0) equal on both devices and between
    the two modes."""
    import dataclasses

    import numpy as np
    import torch

    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.kernels.w8a16 import w8a16_gemm
    from neuronx_distributed_tpu_torch.models.llama import init_params
    from neuronx_distributed_tpu_torch.models.mixtral import MixtralForCausalLM
    from neuronx_distributed_tpu_torch.quantization.core import QuantizationConfig

    cfg = small_mixtral_config()
    params = init_params(cfg, torch.Generator().manual_seed(3), model_cls=MixtralForCausalLM,
                         quantize=QuantizationConfig())
    kw = dict(buckets=(128,), max_batch=3, page_size=16, paged_attn_kernel=True)
    zero_launches((w8a16_gemm,))
    lms = [CausalLM(cfg, params, MixtralForCausalLM, device=d, **kw) for d in (dev, "cpu")]
    sessions = [lm.start_session() for lm in lms]
    rng = np.random.default_rng(4)
    prompts = rng.integers(1, cfg.vocab_size, (2, 120)).astype(np.int32)
    lengths = np.array([120, 101], np.int32)
    slots = np.array([0, 2])
    outs = [lm.insert(s, slots, prompts, lengths=lengths).float().cpu()
            for lm, s in zip(lms, sessions)]
    worst = float((outs[0] - outs[1]).abs().max())
    tok = np.zeros(3, np.int32)
    tok[slots] = outs[1].argmax(-1).numpy()
    for _ in range(4):
        outs = [lm.step(s, tok).float().cpu() for lm, s in zip(lms, sessions)]
        worst = max(worst, float((outs[0] - outs[1]).abs().max()))
        tok = outs[1].argmax(-1).numpy().astype(np.int32)
    check(worst <= TOL_LOGITS_FP32,
          f"small int8 Mixtral logits on the GPU differ from the CPU twins by {worst}")
    launches = w8a16_gemm.launches
    by_route = dict(w8a16_gemm.launches_by_route)
    check(launches > 0, "the small int8 Mixtral on the GPU launched no w8a16_gemm")
    del lms, sessions
    streams = {}
    prompt = rng.integers(1, cfg.vocab_size, (1, 100)).astype(np.int32)
    for mode, thr in (("selective", 1.5), ("all_experts", 0.0)):
        c = dataclasses.replace(cfg, selective_loading_threshold=thr)
        for d in (dev, "cpu"):
            lm = CausalLM(c, params, MixtralForCausalLM, buckets=(128,), max_batch=1, device=d)
            out = lm.generate(prompt, max_new_tokens=24, fused_chunk=8 if d == dev else 0)
            streams[(mode, str(d))] = out.tokens[0].tolist()
            del lm
    first = streams[("selective", "cpu")]
    check(all(s == first for s in streams.values()),
          f"small int8 Mixtral streams differ between devices or modes: {streams}")
    return dict(logits_max_abs_err=worst, tolerance=TOL_LOGITS_FP32, launches=launches,
                launches_by_route=by_route, streams_equal=True, tokens=len(first))


def run_quant_llama(cfg, dev, params, counters) -> dict:
    """(q1) The serve phase's Llama-3-8B weights quantized on the card
    (int8 per output channel; embedding and head stay bf16) and the serve
    workload behind ``ServeEngine``, beside the same workload on the bf16
    weights (its decode block timed in the same call)."""
    import torch

    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM
    from neuronx_distributed_tpu_torch.quantization.core import quantize_params

    kw = dict(buckets=(128, 512), max_batch=8, page_size=16, paged_attn_kernel=True, device=dev)
    prompts = serve_prompts(cfg.vocab_size)
    lm = CausalLM(cfg, params, LlamaForCausalLM, **kw)
    bf16 = quant_pass(lm, dev, [c for c in counters if c.__name__ != "w8a16_gemm"], prompts)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    qparams = quantize_params(params)
    _sync(dev)
    quantize_s = time.perf_counter() - t0
    lm = CausalLM(cfg, qparams, LlamaForCausalLM, **kw)
    int8 = quant_pass(lm, dev, counters, prompts, reference=bf16["streams"])
    int8.update(quantize_s=quantize_s, weight_bytes=weight_bytes(qparams),
                bf16_weight_bytes=weight_bytes(params))
    del lm, qparams
    gc.collect()
    torch.cuda.empty_cache()
    return dict(bf16=bf16, int8=int8)


# B5's kernels in a profiler's device table (demangled names), by route; its
# split-K reduction is launched beside a route's kernel, not counted apart
B5_ROUTE_KERNELS = {"wgmma": ("tc::wgmma_kernel",),
                    "decode": ("tc::decode_kernel", "tc::dense_decode_kernel"),
                    "f32": ("gemm_f32_kernel",)}
B5_DEVICE_KERNELS = sum(B5_ROUTE_KERNELS.values(), ()) + ("reduce_kernel<",)


def b5_traced_by_route(prof) -> dict:
    """B5's kernel calls in a ``torch.profiler`` trace, by route (its
    reductions left out)."""
    calls = device_kernel_calls(prof, B5_DEVICE_KERNELS)
    return {r: sum(calls[n] for n in names) for r, names in B5_ROUTE_KERNELS.items()}


def profile_generate(lm, prompt, path: str) -> dict:
    """One more ``generate(fused_chunk=MIXTRAL_FUSED)`` of ``prompt`` under
    ``torch.profiler``, device activity only: the wall, the device's busy
    time, B5's share of it, and the kernels by device time (table at
    ``path``). B5's kernel calls in the trace, by route, must equal the
    run's launches by route."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from neuronx_distributed_tpu_torch.kernels.w8a16 import w8a16_gemm

    zero_launches([w8a16_gemm])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lm.generate(prompt, max_new_tokens=MIXTRAL_GEN_NEW, fused_chunk=MIXTRAL_FUSED)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = dict(w8a16_gemm.launches_by_route)
    traced = b5_traced_by_route(prof)
    check(traced == counted,
          f"the profiled generate ran B5's kernels {traced} times by route, its launch counts "
          f"say {counted}")
    return dict(device_profile_summary(prof, wall, path, shares=(("b5", B5_DEVICE_KERNELS),)),
                b5_launches_by_route=counted, b5_traced_by_route=traced)


def run_quant_mixtral(dev, counters, profile_path=None) -> dict:
    """(q2) Mixtral-8x7B at full width and depth with int8 weights: each
    weight drawn in bf16 on the card from a seed and quantized at once (the
    93 GB bf16 model never exists); the serve workload (vocab 32000) behind
    ``ServeEngine`` (8 rows: every decode step all_experts), then one
    512-token prompt through ``generate(fused_chunk=8)`` at batch 1
    (selective: 1 * 2 / 8 < 0.5) against the stepwise ``generate``. Gates:
    as :func:`quant_pass`, the peak below the card's memory, equal streams."""
    import numpy as np
    import torch

    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.models.llama import init_params
    from neuronx_distributed_tpu_torch.models.mixtral import MixtralForCausalLM
    from neuronx_distributed_tpu_torch.quantization.core import QuantizationConfig

    cfg = mixtral_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                         model_cls=MixtralForCausalLM, quantize=QuantizationConfig())
    _sync(dev)
    build_s = time.perf_counter() - t0
    wb = weight_bytes(params)
    lm = CausalLM(cfg, params, MixtralForCausalLM, buckets=(128, 512), max_batch=8,
                  page_size=16, paged_attn_kernel=True, device=dev)
    moe = lm.model.model.layers[0].moe
    check(moe.mode_for(8, 1) == "all_experts" and moe.mode_for(1, 1) == "selective",
          "Mixtral's decode dispatch: 8 rows must run all_experts, 1 row selective")
    serve_st = quant_pass(lm, dev, counters, serve_prompts(cfg.vocab_size))
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(9)
    prompt = rng.integers(1, cfg.vocab_size, (1, MIXTRAL_PROMPT)).astype(np.int32)
    lm1 = CausalLM(cfg, params, MixtralForCausalLM, buckets=(MIXTRAL_PROMPT,), max_batch=1,
                   device=dev)
    lm1.generate(prompt[:, :130], max_new_tokens=MIXTRAL_FUSED, fused_chunk=MIXTRAL_FUSED)
    # B1 (the prefill) and B5: the slab decode takes no B2
    gen_counters = [c for c in counters if c.__name__ != "paged_decode_attention"]
    zero_launches(gen_counters)
    _sync(dev)
    t1 = time.perf_counter()
    fused = lm1.generate(prompt, max_new_tokens=MIXTRAL_GEN_NEW, fused_chunk=MIXTRAL_FUSED)
    _sync(dev)
    gen_wall = time.perf_counter() - t1
    gen_launches = {c.__name__: c.launches for c in gen_counters}
    gen_routes = routes_of(gen_counters)
    runner = next(r for k, r in lm1._fused.items() if k[0] == MIXTRAL_FUSED)
    sel_block_ms = replay_ms(runner)
    stepwise = lm1.generate(prompt, max_new_tokens=MIXTRAL_GEN_NEW)
    check(fused.tokens.tolist() == stepwise.tokens.tolist(),
          "Mixtral's fused generate and its stepwise generate gave other streams")
    check(int(fused.lengths[0]) == MIXTRAL_GEN_NEW, f"generate gave {fused.lengths[0]} tokens")
    gen_profile = profile_generate(lm1, prompt, profile_path) if profile_path else None
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    check(peak < total, f"Mixtral's peak {peak} bytes is not below the card's {total}")
    del lm1, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=cfg.num_layers, hidden=cfg.hidden_size, experts=cfg.num_experts,
                top_k=cfg.top_k, weight_bytes=wb, build_s=build_s, peak_bytes=peak,
                device_bytes=total, serve=serve_st,
                generate=dict(prompt_tokens=MIXTRAL_PROMPT, new_tokens=MIXTRAL_GEN_NEW,
                              fused_chunk=MIXTRAL_FUSED, wall_s=gen_wall,
                              tokens_per_s=MIXTRAL_GEN_NEW / gen_wall,
                              decode_block_ms=sel_block_ms,
                              decode_step_ms=sel_block_ms and sel_block_ms / MIXTRAL_FUSED,
                              launches=gen_launches, launches_by_route=gen_routes,
                              stepwise_equal=True,
                              **({"profile": gen_profile} if gen_profile else {})))


def run_quant_phase(dev, parts=("q3", "q1", "q2"), params=None, profile_path=None) -> dict:
    """Phase 4h's model parts on ``dev``: (q3) always cheap, (q1) on
    ``params`` (the serve phase's weights; made from the seed when None),
    (q2) after (q1)'s weights are gone (with ``profile_path``, its batch-1
    generate once more under the profiler)."""
    import torch

    from neuronx_distributed_tpu_torch.inference.paged_kernel import paged_decode_attention
    from neuronx_distributed_tpu_torch.kernels.flash_attn import flash_block_forward
    from neuronx_distributed_tpu_torch.kernels.w8a16 import w8a16_gemm
    from neuronx_distributed_tpu_torch.models.llama import init_params

    counters = (flash_block_forward, paged_decode_attention, w8a16_gemm)
    out = {}
    if "q3" in parts:
        out["q3"] = quant_small_check(dev)
    if "q1" in parts:
        cfg = serve_config()
        if params is None:
            params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        out["q1"] = run_quant_llama(cfg, dev, params, counters)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    if "q2" in parts:
        out["q2"] = run_quant_mixtral(dev, counters, profile_path)
    return out


def quant_route_gates(out: dict) -> None:
    """B5's routes on phase 4h's paths: the int8 inserts (prefill) launch
    the wgmma route and the decode steps the decode route, in (q1) and in
    both (q2) runs; (q3)'s fp32 model the f32 route."""
    runs = {}
    if "q1" in out:
        runs["(q1) int8"] = (out["q1"]["int8"]["launches_by_route"]["w8a16_gemm"],
                             ("wgmma", "decode"))
    if "q2" in out:
        runs["(q2) serve"] = (out["q2"]["serve"]["launches_by_route"]["w8a16_gemm"],
                              ("wgmma", "decode"))
        runs["(q2) generate"] = (out["q2"]["generate"]["launches_by_route"]["w8a16_gemm"],
                                 ("wgmma", "decode"))
    if "q3" in out:
        runs["(q3)"] = (out["q3"]["launches_by_route"], ("f32",))
    for name, (counts, routes) in runs.items():
        for route in routes:
            check(counts.get(route, 0) > 0,
                  f"{name} launched no w8a16_gemm on its {route} route: {counts}")


# --- phase 4i: the replica fleet ------------------------------------------------------

# Every pass runs on the trace cell's CausalLM (trace_lm: Llama-3-8B full width
# at SERVING_CUT_LAYERS layers, bf16 seeded weights held once, max_seq_len
# 4096, pages of 16, 8 rows a replica), each replica a session of its own,
# block_steps 8 and 512-token prefill chunks. Every count these gates compare was first predicted on the
# CPU over SimCausalLM by scripts/fleet_rehearsal.py (greedy, no EOS: the
# schedules do not depend on token values); after changing a pass, its
# traffic, its fleet or anything its schedule reads, rerun the script and
# copy its counts here.
FLEET_ENGINE = dict(block_steps=8, prefill_chunk_tokens=TRACE_CHUNK)
FLEET_SEED = 3
FLEET_SPARE_STATES = 3       # the states passes hand on, programs and all
# (z2): 32 requests from tenants a and b (weights 1:1); even ids carry a
# 1024-token system prompt; a steady start, then b bursts 10:1 at block 10
FLEET_SYSTEM_PROMPT = 1024
FLEET_NEW_TOKENS = 64
FLEET_BURST_BLOCK = 10
FLEET_CRASH = (11, 0)        # (router block, replica): replica 0 goes dark mid-decode
FLEET_DRAIN = (12, 2)        # drain replica 2 while its streams decode
FLEET_QUEUE_DEPTH = 2        # each replica may queue 2 placements (a drain migrates them)
FLEET_SNAPSHOT_EVERY = 4
FLEET_MIGRATE_PLAN = dict(seed=7, migrate_fail_prob=0.1, migrate_corrupt_prob=0.1)
# (z4): a burst of 40 short requests at blocks 0-3 on 1 prefill + 2 decode
# workers, and two late ones at blocks 32 and 36; the decode pool may grow to
# 3 and shrinks back in the idle valley
FLEET_SCALE_REQUESTS = 40
FLEET_SCALE_LATE = (32, 36)
FLEET_SCALE_POLICY = dict(min_replicas=2, max_replicas=3, backlog_high_blocks=1.0,
                          up_patience_blocks=1, down_utilization=0.5, down_patience_blocks=3,
                          cooldown_blocks=4)
# the router decisions a pass is gated on
FLEET_STAT_KEYS = ("placements", "affinity_placements", "requeues", "rejected", "crashes",
                   "heartbeat_misses", "failovers", "failed_over_requests", "drains",
                   "drain_migrated_requests", "snapshots_taken", "scale_ups", "scale_downs",
                   "warm_spawns", "cold_spawns", "replica_blocks", "handoffs_sent",
                   "handoffs_adopted", "handoffs_degraded", "handoffs_deferred",
                   "handoff_pages")
FLEET_PREDICTED = {   # python3 scripts/fleet_rehearsal.py (SimCausalLM at the trace cell's shape)
    "z2": dict(placements=42, affinity_placements=11, requeues=0, rejected=0, crashes=1,
        heartbeat_misses=1, failovers=1, failed_over_requests=8, drains=1,
        drain_migrated_requests=2, snapshots_taken=13, scale_ups=0, scale_downs=0, warm_spawns=0,
        cold_spawns=0, replica_blocks=63, handoffs_sent=0, handoffs_adopted=0, handoffs_degraded=0,
        handoffs_deferred=0, handoff_pages=0, completed=32, blocks=34),
    "z3_disagg": dict(placements=32, affinity_placements=0, requeues=0, rejected=0, crashes=0,
        heartbeat_misses=0, failovers=0, failed_over_requests=0, drains=0,
        drain_migrated_requests=0, snapshots_taken=0, scale_ups=0, scale_downs=0, warm_spawns=0,
        cold_spawns=0, replica_blocks=177, handoffs_sent=32, handoffs_adopted=32,
        handoffs_degraded=0, handoffs_deferred=0, handoff_pages=1760, completed=32, blocks=59),
    "z3_colocated": dict(placements=32, affinity_placements=0, requeues=0, rejected=0, crashes=0,
        heartbeat_misses=0, failovers=0, failed_over_requests=0, drains=0,
        drain_migrated_requests=0, snapshots_taken=0, scale_ups=0, scale_downs=0, warm_spawns=0,
        cold_spawns=0, replica_blocks=92, handoffs_sent=0, handoffs_adopted=0, handoffs_degraded=0,
        handoffs_deferred=0, handoff_pages=0, completed=32, blocks=46),
    "z3_disagg_faults": dict(placements=32, affinity_placements=0, requeues=0, rejected=0,
        crashes=0, heartbeat_misses=0, failovers=0, failed_over_requests=0, drains=0,
        drain_migrated_requests=0, snapshots_taken=0, scale_ups=0, scale_downs=0, warm_spawns=0,
        cold_spawns=0, replica_blocks=177, handoffs_sent=32, handoffs_adopted=26,
        handoffs_degraded=6, handoffs_deferred=0, handoff_pages=1760, completed=32, blocks=59),
    "z4": dict(placements=42, affinity_placements=0, requeues=0, rejected=0, crashes=0,
        heartbeat_misses=0, failovers=0, failed_over_requests=0, drains=1,
        drain_migrated_requests=0, snapshots_taken=0, scale_ups=1, scale_downs=1, warm_spawns=0,
        cold_spawns=1, replica_blocks=155, handoffs_sent=42, handoffs_adopted=42,
        handoffs_degraded=0, handoffs_deferred=88, handoff_pages=412, completed=42, blocks=46),
    "z4_events": [{"block": 3, "action": "up", "role": "decode", "replica": 3, "reason":
        "queue_depth", "warm": False}, {"block": 19, "action": "down", "role": "decode", "replica":
        3, "reason": "idle", "warm": None}, {"block": 20, "action": "parked", "role": "decode",
        "replica": 3, "reason": "drain_complete", "warm": None}],
    "z4_time_to_ready": [],
}


def fleet_tenant_trace(vocab: int) -> list:
    """(z2)'s traffic: 10 requests one a block alternating tenants a and b,
    then at ``FLEET_BURST_BLOCK`` b's burst of 20 beside a's 2; every even
    id a ``FLEET_SYSTEM_PROMPT``-token system prompt and a 64-256-token
    turn, every odd one a 128-384-token prompt of its own; 64 new tokens,
    greedy, no EOS."""
    import numpy as np

    rng = np.random.default_rng(21)
    system = rng.integers(1, vocab, FLEET_SYSTEM_PROMPT).astype(np.int32)
    plan = [("a" if i % 2 == 0 else "b", i) for i in range(10)]
    plan += [("b", FLEET_BURST_BLOCK)] * 10 + [("a", FLEET_BURST_BLOCK)] \
        + [("b", FLEET_BURST_BLOCK)] * 10 + [("a", FLEET_BURST_BLOCK)]
    items = []
    for rid, (tenant, arrival) in enumerate(plan):
        if rid % 2 == 0:
            prompt = np.concatenate([system, rng.integers(1, vocab, 64 * (1 + rid % 4))])
        else:
            prompt = rng.integers(1, vocab, 128 * (1 + rid % 3))
        items.append(dict(prompt=prompt.astype(np.int32), max_new_tokens=FLEET_NEW_TOKENS,
                          arrival_block=arrival, tenant=tenant))
    return items


def fleet_burst_trace(vocab: int) -> list:
    """(z4)'s traffic: ``FLEET_SCALE_REQUESTS`` short requests (64-256 prompt
    tokens, 64 new) arriving over blocks 0-3, then two at
    ``FLEET_SCALE_LATE`` (the clock runs through the idle valley)."""
    import numpy as np

    rng = np.random.default_rng(23)
    arrivals = [i % 4 for i in range(FLEET_SCALE_REQUESTS)] + list(FLEET_SCALE_LATE)
    return [dict(prompt=rng.integers(1, vocab, 64 * (1 + i % 4)).astype(np.int32),
                 max_new_tokens=FLEET_NEW_TOKENS, arrival_block=a, tenant="default")
            for i, a in enumerate(arrivals)]


def fleet_trace_cell(vocab: int) -> list:
    """(z3)'s traffic: the trace cell's (``TRACE_KNOBS``), tenant-less."""
    from neuronx_distributed_tpu_torch.inference.trace import synthetic_trace

    return [dict(it, tenant="default") for it in synthetic_trace(TRACE_REQUESTS, vocab,
                                                                 **TRACE_KNOBS)]


def _fleet_engines(router, ops: dict, engines: dict) -> None:
    """Count the host ops of every engine the router holds (each new one,
    a spawned or restored replica included, wrapped on first sight)."""
    for i, eng in enumerate(router.engines):
        if engines.get(i) is not eng:
            engines[i] = eng
            if not getattr(eng, "_sim", False):
                ops[(i, id(eng))] = count_host_ops(eng)


def fleet_drive(router, items, actions=(), before_block=None) -> dict:
    """Submit ``items`` to ``router`` (ids in item order), then step it to
    the end: ``actions`` ((router block, callable) pairs) run before that
    block's step; each request's arrival is stamped in wall time when the
    router's clock reaches its block; every block's wall time is kept;
    each engine's host ops are counted. Returns the wall seconds, the
    stamps, the block walls and the host-op lists."""
    for it in items:
        router.submit(it["prompt"], it["max_new_tokens"], arrival_block=it["arrival_block"],
                      tenant=it.get("tenant", "default"))
    arrival_ts, block_s, ops, engines = {}, [], {}, {}
    pending = sorted(actions, key=lambda a: a[0])
    t0 = time.perf_counter()
    while True:
        while pending and pending[0][0] <= router.blocks:
            pending.pop(0)[1](router)
        _fleet_engines(router, ops, engines)
        now = time.perf_counter()
        for rid, it in enumerate(items):
            if it["arrival_block"] <= router.blocks:
                arrival_ts.setdefault(rid, now)
        if before_block is not None:
            before_block(router)
        t1 = time.perf_counter()
        more = router.step_block()
        block_s.append(time.perf_counter() - t1)
        if not more:
            break
    return dict(wall_s=time.perf_counter() - t0, arrival_ts=arrival_ts, block_s=block_s,
                ops=ops)


def _fleet_tokens(router) -> dict:
    return {c.request_id: c.tokens.tolist() for c in router.completed}


def _token_match(got: dict, want: dict) -> float:
    total = sum(len(t) for t in want.values())
    same = sum(sum(1 for a, b in zip(got.get(r, []), t) if a == b) for r, t in want.items())
    return same / max(total, 1)


def _fleet_summary(router, drive: dict, items, counters) -> dict:
    """What every fleet pass reports and gates: the router's decisions,
    completion counts, host ops per engine, launches, the tracer's drops
    and router lanes, attribution, and survivors' allocators (prefix cache
    evicted) after the pass."""
    launches = {c.__name__: c.launches for c in counters}
    ops = [o for lst in drive["ops"].values() for o in lst]
    lanes = sorted({ev["lane"][1] for ev in router.tracer.events() if ev["lane"][0] == "router"})
    problems, atts = attribution_check(router.tracer) if router.tracer.enabled else ([], {})
    pages = {}
    for i, eng in enumerate(router.engines):
        if router._alive[i] and i not in router._drained and eng.session.paged is not None:
            pkv = eng.session.paged
            if pkv.prefix is not None:
                pkv.prefix.evict(10 ** 6)
            pages[i] = pkv.allocator.in_use()
    done = router.completed
    return dict(
        stats={k: int(router.stats.get(k, 0)) for k in FLEET_STAT_KEYS},
        submitted=len(items), completed=len(done), rejected=len(router.rejected),
        generated_tokens=sum(len(c.tokens) for c in done), wall_s=drive["wall_s"],
        tokens_per_s=sum(len(c.tokens) for c in done) / max(drive["wall_s"], 1e-9),
        blocks=router.blocks, host_ops=host_op_stats(ops), launches=launches,
        dropped=router.tracer.dropped, router_lanes=lanes, attribution_problems=problems,
        attributed=len(atts), survivor_pages_in_use=pages,
        replica_states=[s["state"] for s in router.replica_states()],
        nonfinite_logits=sum(getattr(e, "nonfinite_logits", 0) for e in router.engines),
        captures=[len(e.session.capture_ms) for e in router.engines
                  if getattr(e.session, "state", None) is not None])


def fleet_z1(lm, dev, counters) -> dict:
    """(z1) identity: a Router over one replica against a bare engine on
    the serve workload, in the synchronous and the pipelined loop; the
    streams must be bit-identical, and the router's replica takes over the
    bare engine's closed session (no capture)."""
    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
    from neuronx_distributed_tpu_torch.inference.router import Router

    items = [dict(prompt=p, max_new_tokens=MAX_NEW_TOKENS, arrival_block=0)
             for p in serve_prompts(lm.config.vocab_size)]
    out = {}
    for async_loop in (False, True):
        kw = dict(FLEET_ENGINE, async_loop=async_loop, seed=FLEET_SEED)
        eng = ServeEngine(lm, **kw)
        for it in items:
            eng.submit(it["prompt"], it["max_new_tokens"])
        _sync(dev)
        t0 = time.perf_counter()
        eng.run()
        _sync(dev)
        bare_s = time.perf_counter() - t0
        bare = {c.request_id: c.tokens.tolist() for c in eng.completed}
        eng.close()
        for c in counters:
            c.launches = 0
        router = Router(lm, 1, **kw)
        drive = fleet_drive(router, items)
        _sync(dev)
        st = _fleet_summary(router, drive, items, counters)
        st.update(identical=_fleet_tokens(router) == bare, bare_wall_s=bare_s,
                  capture_s=router.engines[0].capture_s, async_loop=async_loop)
        router.close()
        out["async" if async_loop else "sync"] = st
    return out


def fleet_z2(lm, dev, counters, faults: bool = True) -> dict:
    """(z2) three replicas under faults: affinity placement, tenants a and b
    at 1:1 with b's 10:1 burst, replica 0 crashing mid-decode
    (``FLEET_CRASH``), replica 2 drained while its streams decode
    (``FLEET_DRAIN``); with ``faults`` False the same fleet and traffic
    undisturbed (the token-match reference)."""
    from neuronx_distributed_tpu_torch.inference.router import Router

    items = fleet_tenant_trace(lm.config.vocab_size)
    router = Router(lm, 3, placement="affinity", snapshot_every_blocks=FLEET_SNAPSHOT_EVERY,
                    tenant_weights={"a": 1.0, "b": 1.0}, trace=True,
                    replica_queue_depth=FLEET_QUEUE_DEPTH,
                    crash_at=[FLEET_CRASH] if faults else (), seed=FLEET_SEED, **FLEET_ENGINE)
    detect = {}

    def note_failover(r):
        detect.setdefault("failovers_before", {})[r.blocks] = r.stats["failovers"]

    actions = [(FLEET_DRAIN[0], lambda r: r.drain(FLEET_DRAIN[1]))] if faults else []
    for c in counters:
        c.launches = 0
    drive = fleet_drive(router, items, actions, before_block=note_failover)
    _sync(dev)
    st = _fleet_summary(router, drive, items, counters)
    # the wall of the block whose heartbeat check failed replica 0 over
    seen = detect.get("failovers_before", {})
    fo_blocks = [b for b in sorted(seen) if b + 1 in seen and seen[b + 1] > seen[b]]
    if faults and fo_blocks:
        st["failover_block"] = fo_blocks[0]
        st["failover_replay_ms"] = drive["block_s"][fo_blocks[0]] * 1e3
    st["failover_ms"] = router.last_failover_ms
    st["drain_ms"] = router.last_drain_ms
    # each tenant's tokens while both are backlogged (before a's last
    # retirement) against its weight's share
    comps = {c.request_id: c for c in router.completed}
    cut = max((c.ttft_blocks + c.decode_blocks + items[c.request_id]["arrival_block"]
               for c in comps.values() if c.tenant == "a"), default=0)
    served = {"a": 0, "b": 0}
    for rid, evs in router.tracer.by_request().items():
        if rid in comps:
            served[comps[rid].tenant] += sum(1 for e in evs if e["name"] == "tok"
                                             and e["block"] < cut)
    total = max(sum(served.values()), 1)
    st["tenant_share"] = {t: n / total for t, n in served.items()}
    st["streams"] = _fleet_tokens(router)
    router.close()
    return st


def _adopt_checker(router, record: list) -> None:
    """Wrap every decode worker's ``adopt_handoff``: an adopted handoff's
    pages are read back from the decode worker's pool and their crc32s held
    against the handoff's seal (the bytes the prefill worker read); a
    handoff whose bytes no longer verify must not be adopted. The check's
    own time is recorded apart so that the decode clock can leave it out."""
    from neuronx_distributed_tpu_torch.inference.conversation_tier import to_store_page
    from neuronx_distributed_tpu_torch.inference.paged_cache import HostPageTier

    for j, eng in enumerate(router.engines):
        if router.role_of(j) != "decode" or getattr(eng, "_checked", False):
            continue
        orig = eng.adopt_handoff

        def checked(h, eng=eng, orig=orig, j=j):
            t_pre = time.perf_counter()
            intact = h.verify()
            t_adopt = time.perf_counter()
            out = orig(h)
            t0 = time.perf_counter()
            ok = None
            if out == "adopted" and not getattr(eng, "_sim", False):
                slot = next(s for s, r in enumerate(eng.slots) if r is h.req)
                pages = [int(p) for p in eng.session.paged.tables[slot][:h.pages]]
                got = [HostPageTier._crc(to_store_page(p)) for p in eng._read_pages_bytes(pages)]
                ok = got == list(h.crcs)
            record.append(dict(worker=j, out=out, intact=intact, bytes_equal=ok,
                               block=router.blocks, adopt_s=t0 - t_adopt,
                               check_s=time.perf_counter() - t0 + t_adopt - t_pre))
            return out

        eng.adopt_handoff = checked
        eng._checked = True


def fleet_z3(lm, dev, counters) -> dict:
    """(z3) disaggregation: the trace cell's traffic on
    ``DisaggRouter(lm, 3, prefill_replicas=1)`` (every adopted handoff's
    pages read back and checked), on a colocated ``Router(lm, 2)``, and on
    the disaggregated fleet again under ``FLEET_MIGRATE_PLAN``'s failed and
    corrupted handoffs. Reports the decode clock (each stream's decode
    worker's own block walls) beside the wall clock for both fleets, TTFT
    by prompt kind, and the handoffs' pages, bytes, seal and adopt ms."""
    import numpy as np

    from neuronx_distributed_tpu_torch.inference.disagg import DisaggRouter, decode_clock_itl
    from neuronx_distributed_tpu_torch.inference.faults import FaultPlan
    from neuronx_distributed_tpu_torch.inference.router import Router

    items = fleet_trace_cell(lm.config.vocab_size)
    long_len = TRACE_KNOBS["long_prompt_len"]
    out = {}
    for label, make in (
            ("disagg", lambda: DisaggRouter(lm, 3, prefill_replicas=1, trace=True,
                                            seed=FLEET_SEED, **FLEET_ENGINE)),
            ("colocated", lambda: Router(lm, 2, placement="least_loaded", trace=True,
                                         seed=FLEET_SEED, **FLEET_ENGINE)),
            ("disagg_faults", lambda: DisaggRouter(
                lm, 3, prefill_replicas=1, trace=True, seed=FLEET_SEED,
                faults=FaultPlan(**FLEET_MIGRATE_PLAN), **FLEET_ENGINE))):
        router = make()
        checks: list = []
        for c in counters:
            c.launches = 0
        drive = fleet_drive(router, items,
                            before_block=lambda r: _adopt_checker(r, checks)
                            if isinstance(r, DisaggRouter) else None)
        _sync(dev)
        st = _fleet_summary(router, drive, items, counters)
        # the adoption check's own time leaves the decode worker's clock
        for c in checks:
            wall = router._eng_block_wall[c["worker"]]
            if c["block"] < len(wall):
                wall[c["block"]] -= c["check_s"]
        if not isinstance(router, DisaggRouter):
            router._decode_home = {c.request_id: i for i, e in enumerate(router.engines)
                                   for c in e.completed}
        st.update(decode_clock_itl(router, long_prompt_cutoff=long_len))
        if checks:   # what the decode clock would read with adoption off it
            walls = [list(w) for w in router._eng_block_wall]
            for c in checks:
                wall = router._eng_block_wall[c["worker"]]
                if c["block"] < len(wall):
                    wall[c["block"]] -= c["adopt_s"]
            bare = decode_clock_itl(router, long_prompt_cutoff=long_len)
            router._eng_block_wall = walls
            st.update({f"{k}_without_adoption": v for k, v in bare.items()
                       if k in ("itl_p99_ms_decode_clock", "decode_stall_excess_ms")})
        st.update(trace_latency(router.completed, drive["arrival_ts"], long_len))
        if isinstance(router, DisaggRouter):
            adopt = []
            for e in router.engines:
                h = e.metrics.histogram("serve_handoff_adopt_ms")
                adopt.append(h)
            merged = adopt[0].merged(*adopt[1:])
            seal = list(router.handoff_seal_ms)
            st.update(
                handoff_bytes=int(router.stats["handoff_bytes"]),
                adopted_pages=sum(e.session.paged.adopted_pages for e in router.engines),
                adopt_ms_p50=merged.percentile(50) if merged.count else None,
                adopt_ms_p99=merged.percentile(99) if merged.count else None,
                seal_ms_p50=_pct(seal, 50), seal_ms_max=max(seal) if seal else None,
                adopt_call_ms_p50=_pct([c["adopt_s"] * 1e3 for c in checks
                                        if c["out"] == "adopted"], 50),
                adopt_call_ms_p99=_pct([c["adopt_s"] * 1e3 for c in checks
                                        if c["out"] == "adopted"], 99),
                adopt_checks=len(checks),
                adopted_bytes_equal=all(c["bytes_equal"] is not False for c in checks),
                corrupt_adopted=sum(1 for c in checks
                                    if c["out"] == "adopted" and not c["intact"]),
                decode_inserts=sum(int(router.engines[j].inserts)
                                   for j in range(len(router.engines))
                                   if router.role_of(j) == "decode"),
                fault_stats=dict(router._injector.stats) if router._injector else None)
        st["streams"] = _fleet_tokens(router)
        router.close()
        out[label] = st
    return out


def fleet_z4(lm, dev, counters) -> dict:
    """(z4) autoscaling: ``Autoscaler`` over ``DisaggRouter(lm, 3,
    prefill_replicas=1)``, the prefill pool fixed at one, the decode pool
    between 2 and 3 (``FLEET_SCALE_POLICY``), on a burst
    (:func:`fleet_burst_trace`) that adds a decode worker and later
    retires it. The spawn is timed (session, captures) and must capture its
    programs while other sessions hold live slots."""
    from neuronx_distributed_tpu_torch.inference.autoscale import AutoscalePolicy, Autoscaler
    from neuronx_distributed_tpu_torch.inference.disagg import DisaggRouter

    items = fleet_burst_trace(lm.config.vocab_size)
    scaler = Autoscaler(per_role={
        "prefill": AutoscalePolicy(min_replicas=1, max_replicas=1),
        "decode": AutoscalePolicy(**FLEET_SCALE_POLICY)})
    router = DisaggRouter(lm, 3, prefill_replicas=1, trace=True, autoscaler=scaler,
                          seed=FLEET_SEED, **FLEET_ENGINE)
    spawns = []
    add = router.add_replica

    def timed_add(role="decode", warm=True):
        live_busy = any(e.session.active.any() for i, e in enumerate(router.engines)
                        if i in router._live_replicas())
        states = {id(getattr(e.session, "state", None)) for e in router.engines}
        before = len(getattr(lm, "captures", ()))
        t0 = time.perf_counter()
        i = add(role=role, warm=warm)
        _sync(dev)
        eng = router.engines[i]
        state = getattr(eng.session, "state", None)
        index = getattr(state, "index", None)
        spawns.append(dict(replica=i, warm=router.last_spawn["warm"],
                           spawn_ms=(time.perf_counter() - t0) * 1e3, others_busy=live_busy,
                           new_state=id(state) not in states,
                           captured={sig: ms for idx, sig, ms in
                                     getattr(lm, "captures", ())[before:] if idx == index},
                           capture_s=eng.capture_s))
        return i

    router.add_replica = timed_add
    for c in counters:
        c.launches = 0
    drive = fleet_drive(router, items)
    _sync(dev)
    st = _fleet_summary(router, drive, items, counters)
    st.update(device_states=hasattr(lm, "captures"),
              scale_events=[dict(e) for e in scaler.scale_events],
              time_to_ready_blocks=scaler.time_to_ready_blocks(router), spawns=spawns,
              streams=_fleet_tokens(router))
    router.close()
    return st


def fleet_z5(dev, counters) -> dict:
    """(z5) fp32 exactness: the 2-layer ``small_config()`` model, on ``dev``
    and on the CPU, through (z2)'s crash and drain on ``Router(3)`` and
    through ``FLEET_MIGRATE_PLAN``'s faulted handoffs on
    ``DisaggRouter(3)``: both fleets' streams bit-identical to one engine
    serving the same submissions on the same device (greedy and sampled),
    and the greedy streams equal on the card and the CPU."""
    import numpy as np
    import torch

    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.inference.disagg import DisaggRouter
    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
    from neuronx_distributed_tpu_torch.inference.faults import FaultPlan
    from neuronx_distributed_tpu_torch.inference.router import Router
    from neuronx_distributed_tpu_torch.inference.sampling import Sampler
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params

    cfg = small_config()
    params = init_params(cfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(31)
    shared = rng.integers(1, cfg.vocab_size, 48)
    work = []
    for i in range(12):
        p = (np.concatenate([shared, rng.integers(1, cfg.vocab_size, 8 + 5 * i)]) if i % 2 == 0
             else rng.integers(1, cfg.vocab_size, 20 + 7 * i))
        work.append(dict(prompt=p.astype(np.int32), max_new_tokens=16 + i,
                         arrival_block=i // 3, sampler=Sampler(temperature=0.8)
                         if i % 3 == 1 else None))
    kw = dict(block_steps=4, prefill_chunk_tokens=64, seed=5)
    runs, launches = {}, {}
    for d in (dev, "cpu"):
        lm = CausalLM(cfg, params, LlamaForCausalLM, buckets=(64, 128), max_batch=4,
                      page_size=16, paged_attn_kernel=True, device=d)
        eng = ServeEngine(lm, **kw)
        for w in work:
            eng.submit(**w)
        eng.run()
        runs[(d, "engine")] = {c.request_id: c.tokens.tolist() for c in eng.completed}
        eng.close()
        for c in counters:
            c.launches = 0
        r = Router(lm, 3, crash_at=[(3, 0)], **kw)
        for w in work:
            r.submit(**w)
        while r.step_block():
            if r.blocks == 4:
                r.drain(2)
        runs[(d, "router")] = _fleet_tokens(r)
        stats_r = {k: r.stats[k] for k in ("crashes", "failovers", "drains")}
        r.close()
        r = DisaggRouter(lm, 3, prefill_replicas=1, faults=FaultPlan(**FLEET_MIGRATE_PLAN),
                         **kw)
        for w in work:
            r.submit(**w)
        r.run()
        runs[(d, "disagg")] = _fleet_tokens(r)
        stats_d = {k: r.stats[k] for k in ("handoffs_adopted", "handoffs_degraded")}
        r.close()
        if d != "cpu":
            launches = {c.__name__: c.launches for c in counters}
        del lm
    greedy = [i for i, w in enumerate(work) if w["sampler"] is None]
    return dict(
        requests=len(work), router_stats=stats_r, disagg_stats=stats_d, launches=launches,
        identical={f"{'cpu' if d == 'cpu' else 'card'}_{kind}": runs[(d, kind)] == runs[(d, "engine")]
                   for d in (dev, "cpu") for kind in ("router", "disagg")},
        greedy_card_equals_cpu=all(runs[(dev, "engine")][i] == runs[("cpu", "engine")][i]
                                   for i in greedy))


def fleet_gates(passes: dict, predicted: dict) -> list:
    """Phase 4i's gates on its passes (``predicted``: the CPU rehearsal's
    counts by pass); a message for each that fails."""
    problems = []

    def need(cond, msg):
        if not cond:
            problems.append(msg)

    for label, st in passes.get("z1", {}).items():
        need(st["identical"], f"(z1 {label}) the router's streams differ from the bare engine's")
    runs = {f"z2": passes.get("z2")} if "z2" in passes else {}
    runs.update({f"z3_{k}": v for k, v in passes.get("z3", {}).items()})
    if "z4" in passes:
        runs["z4"] = passes["z4"]
    for label, st in passes.get("z1", {}).items():
        runs[f"z1_{label}"] = st
    for label, st in runs.items():
        if st is None:
            continue
        need(st["completed"] + st["rejected"] == st["submitted"],
             f"({label}) completed {st['completed']} + rejected {st['rejected']} != submitted "
             f"{st['submitted']}")
        want = predicted.get(label)
        if want is not None:
            for k, v in want.items():
                got = st["stats"].get(k) if k in st["stats"] else st.get(k)
                need(got == v, f"({label}) {k} {got}, the CPU predicted {v}")
        need(st["host_ops"]["steady_ok"] and st["host_ops"]["blocks_ok"],
             f"({label}) a decode block broke the host-op contract: {st['host_ops']['host_ops']}")
        need(all(n == 0 for n in st["survivor_pages_in_use"].values()),
             f"({label}) survivors hold pages after the pass: {st['survivor_pages_in_use']}")
        need(st["dropped"] == 0, f"({label}) the tracer dropped {st['dropped']} events")
        need(not st["attribution_problems"],
             f"({label}) attribution: " + "; ".join(st["attribution_problems"][:3]))
        need(st["nonfinite_logits"] == 0, f"({label}) non-finite logits")
        for kernel, n in st["launches"].items():
            need(n > 0, f"({label}) never launched {kernel}")
    z2 = passes.get("z2")
    if z2 is not None:
        need(z2["completed"] == z2["submitted"], "(z2) not every request completed")
        need({"place", "clock", "faults", "drain"} <= set(z2["router_lanes"]),
             f"(z2) router lanes {z2['router_lanes']}")
        need(z2["attributed"] == z2["submitted"],
             f"(z2) {z2['attributed']} of {z2['submitted']} requests attributed")
    z3 = passes.get("z3", {})
    if "disagg" in z3:
        st = z3["disagg"]
        need(st["stats"]["handoffs_adopted"] == st["stats"]["handoffs_sent"] > 0
             and st["stats"]["handoffs_degraded"] == 0,
             f"(z3) handoffs sent {st['stats']['handoffs_sent']}, adopted "
             f"{st['stats']['handoffs_adopted']}, degraded {st['stats']['handoffs_degraded']}")
        need(st["adopted_bytes_equal"] and st["adopt_checks"] == st["stats"]["handoffs_adopted"],
             "(z3) adopted page bytes differ from the prefill worker's")
        need(st["decode_inserts"] == 0, "(z3) a decode worker re-prefilled")
    if "disagg_faults" in z3:
        st = z3["disagg_faults"]
        need(st["completed"] == st["submitted"], "(z3 faults) not every request completed")
        need(st["corrupt_adopted"] == 0, "(z3 faults) a corrupted handoff was adopted")
        need(st["stats"]["handoffs_degraded"] > 0, "(z3 faults) the migrate seam never fired")
    z4 = passes.get("z4")
    if z4 is not None:
        want = predicted.get("z4_events")
        need(want is None or z4["scale_events"] == want,
             f"(z4) scale events {z4['scale_events']}, the CPU predicted {want}")
        want = predicted.get("z4_time_to_ready")
        need(want is None or z4["time_to_ready_blocks"] == want,
             f"(z4) time to ready {z4['time_to_ready_blocks']}, predicted {want}")
        cold = [s for s in z4["spawns"] if not s["warm"]]
        need(not z4["device_states"] or bool(cold) and all(s["new_state"] and s["others_busy"] and s["captured"]
                                for s in cold),
             f"(z4) no spawned replica captured its programs beside live sessions: "
             f"{z4['spawns']}")
    z5 = passes.get("z5")
    if z5 is not None:
        need(all(z5["identical"].values()),
             f"(z5) fp32 fleet streams differ from one engine's: {z5['identical']}")
        need(z5["greedy_card_equals_cpu"], "(z5) fp32 greedy streams differ card vs CPU")
        for kernel, n in z5["launches"].items():
            need(n > 0, f"(z5) never launched {kernel}")
    memory = passes.get("memory")
    if memory is not None:
        need(memory["peak_bytes"] < memory["card_bytes"],
             f"peak {memory['peak_bytes']} bytes above the card's {memory['card_bytes']}")
    return problems


def _ms(x) -> str:
    return "n/a" if x is None else f"{x:.1f}"


def print_fleet(fleet: dict, card: str) -> None:
    """Phase 4i's report lines."""
    for label, st in fleet["z1"].items():
        print(f"fleet (z1 {label}): llama3_8b full width at {SERVING_CUT_LAYERS} layers, "
              f"Router(lm, 1) against a bare engine on "
              f"the serve workload: streams bit-identical {st['identical']}; wall "
              f"{st['wall_s']:.3f} s against {st['bare_wall_s']:.3f} s; capture "
              f"{st['capture_s']:.3f} s (the bare engine's closed session taken over); host ops "
              f"a block {st['host_ops']['host_ops_per_block']:.3f} [{card}]", flush=True)
    z2 = fleet["z2"]
    print(f"fleet (z2): 3 replicas, affinity, tenants a:b 1:1 with b's 10:1 burst, replica 0 "
          f"crashed at block {FLEET_CRASH[0]}, replica 2 drained at block {FLEET_DRAIN[0]}: "
          f"{z2['completed']} of {z2['submitted']} completed, decisions {json.dumps(z2['stats'])}"
          f" (the CPU's); serve_failover_replay_ms {_ms(z2.get('failover_replay_ms'))} (wall of "
          f"detection block {z2.get('failover_block')}; failover bookkeeping "
          f"{z2['failover_ms']} ms), drain {z2['drain_ms']} ms; tenant shares while both "
          f"backlogged {json.dumps({t: round(v, 4) for t, v in z2['tenant_share'].items()})} "
          f"(weights 1:1); tokens equal to the fault-free fleet "
          f"{z2['token_match_fault_free']:.4f}; {z2['tokens_per_s']:.1f} tok/s (fault-free "
          f"{z2['fault_free_wall_s']:.3f} s against {z2['wall_s']:.3f} s); host ops a block "
          f"{z2['host_ops']['host_ops_per_block']:.3f}; {z2['attributed']} requests attributed "
          f"[{card}]", flush=True)
    for label, st in fleet["z3"].items():
        extra = ""
        if "handoff_bytes" in st:
            extra = (f"; handoffs {st['stats']['handoffs_adopted']} adopted, "
                     f"{st['stats']['handoffs_degraded']} degraded, "
                     f"{st['stats']['handoff_pages']} pages, {st['handoff_bytes']} bytes, "
                     f"serve_handoff_adopt_ms p50 {_ms(st['adopt_ms_p50'])} p99 "
                     f"{_ms(st['adopt_ms_p99'])} (the whole adopt_handoff call, crc32 "
                     f"verify included, p50 {_ms(st['adopt_call_ms_p50'])} p99 "
                     f"{_ms(st['adopt_call_ms_p99'])}), seal ms p50 {_ms(st['seal_ms_p50'])} max "
                     f"{_ms(st['seal_ms_max'])}, adopted bytes equal the prefill worker's "
                     f"{st['adopted_bytes_equal']}")
        if "itl_p99_ms_decode_clock_without_adoption" in st:
            extra += (f"; with adoption off the decode clock ITL p99 "
                      f"{_ms(st['itl_p99_ms_decode_clock_without_adoption'])} ms, stall excess "
                      f"{_ms(st['decode_stall_excess_ms_without_adoption'])} ms")
        if "token_match_clean" in st:
            extra += f"; tokens equal to the clean disaggregated pass {st['token_match_clean']:.4f}"
        print(f"fleet (z3 {label}): trace cell traffic, decode clock ITL p50 "
              f"{_ms(st['itl_p50_ms_decode_clock'])} p99 {_ms(st['itl_p99_ms_decode_clock'])} "
              f"ms, stall excess {_ms(st['decode_stall_excess_ms'])} ms, largest wall gap of a "
              f"short request {_ms(st['max_gap_ms_short'])} ms; TTFT short p50 "
              f"{_ms(st['ttft_ms_p50_short'])} max {_ms(st['ttft_ms_max_short'])} ms, long p50 "
              f"{_ms(st['ttft_ms_p50_long'])} max {_ms(st['ttft_ms_max_long'])} ms; "
              f"{st['tokens_per_s']:.1f} tok/s over {st['wall_s']:.3f} s{extra} [{card}]",
              flush=True)
    z4 = fleet["z4"]
    print(f"fleet (z4): Autoscaler over 1 prefill + 2 decode workers: events "
          f"{json.dumps(z4['scale_events'])}, time to ready {z4['time_to_ready_blocks']} (the "
          f"CPU's); spawns " + "; ".join(
              f"replica {sp['replica']} {'warm' if sp['warm'] else 'cold'} {sp['spawn_ms']:.1f} "
              f"ms (capture {sp['capture_s'] * 1e3:.1f} ms, signatures captured "
              f"{json.dumps(sp['captured'])}) beside live sessions {sp['others_busy']}"
              for sp in z4["spawns"]) + f" [{card}]", flush=True)
    z5 = fleet["z5"]
    print(f"fleet (z5): small fp32 model, Router(3) crash + drain and DisaggRouter(3) faulted "
          f"handoffs ({json.dumps(z5['disagg_stats'])}): bit-identical to one engine "
          f"{json.dumps(z5['identical'])}, greedy card = CPU {z5['greedy_card_equals_cpu']} "
          f"[{card}]", flush=True)
    mem = fleet["memory"]
    per_state = {}
    for c in fleet["captures"]:
        per_state[c["state"]] = per_state.get(c["state"], 0) + 1
    print(f"fleet: phase {fleet['wall_s']:.1f} s; peak {mem['peak_bytes']} bytes of the card's "
          f"{mem['card_bytes']} (a session's KV pools {mem['session_kv_bytes']}); captures by "
          f"session state {json.dumps(per_state)} [{card}]", flush=True)


def run_fleet_phase(lm, dev, counters) -> dict:
    """Phase 4i on ``lm`` (:func:`trace_lm`): (z1)-(z5), then
    :func:`fleet_gates` against ``FLEET_PREDICTED``. ``lm`` keeps
    ``FLEET_SPARE_STATES`` ended sessions' states, so a pass takes over the
    last one's programs and only fleets larger than that capture anew."""
    import torch

    lm.spare_states = FLEET_SPARE_STATES
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    passes = {"z1": fleet_z1(lm, dev, counters)}
    passes["z2"] = fleet_z2(lm, dev, counters)
    clean = fleet_z2(lm, dev, counters, faults=False)
    passes["z2"]["token_match_fault_free"] = _token_match(passes["z2"]["streams"],
                                                          clean.pop("streams"))
    passes["z2"]["fault_free_wall_s"] = clean["wall_s"]
    passes["z3"] = fleet_z3(lm, dev, counters)
    passes["z3"]["disagg_faults"]["token_match_clean"] = _token_match(
        passes["z3"]["disagg_faults"]["streams"], passes["z3"]["disagg"]["streams"])
    passes["z4"] = fleet_z4(lm, dev, counters)
    passes["z5"] = fleet_z5(dev, counters)
    passes["memory"] = dict(peak_bytes=torch.cuda.max_memory_allocated(),
                            card_bytes=torch.cuda.get_device_properties(0).total_memory,
                            session_kv_bytes=lm.kv_cache_bytes()["kv_bytes"])
    passes["captures"] = [dict(state=s, signature=sig, ms=ms) for s, sig, ms in lm.captures]
    passes["wall_s"] = time.perf_counter() - t0
    problems = fleet_gates(passes, FLEET_PREDICTED)
    if problems:   # the readings first: they say what went wrong
        print_fleet(passes, card_line())
    check(not problems, "fleet phase: " + "; ".join(problems))
    for st in (passes["z2"], *passes["z3"].values(), passes["z4"]):
        st.pop("streams", None)
    return passes


# --- phase 4j: tensor-parallel serving ----------------------------------------------------

TP_WORLD = 2                  # (t2): two ranks, one process each, on the one card
TP_TIMEOUT_S = 300            # every group's timeout: a dead rank fails its peer's collective
TP_CHILD_TIMEOUT_S = 900      # the parent's wait for the (t2) processes
TP_SMALL_TOL = 1e-4           # (t2) small fp32 model: |logit| vs TP=1
TP_SHARE_MAX = 0.55           # (t2) per-rank KV and weight bytes against TP=1's
TP_LAYERS = 8                 # (t2) llama3_8b depth, of 32 (cut for phase 4q's time)
TP_SMALL_LENS = (40, 150, 200, 7)
TP_SMALL_NEW = 16
TP_SMALL_LM = dict(buckets=(128, 256), max_batch=4, page_size=16, paged_attn_kernel=True)
TP_SERVE_LM = dict(buckets=(128, 512), max_batch=8, page_size=16, paged_attn_kernel=True)
TP_LOCAL_HEADS = (16, 4)      # llama3_8b's query and KV heads on each of two ranks


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def tp_digest(streams: dict, decisions: dict) -> str:
    """A rank's streams and decisions as one digest (equal on every rank
    that ran the same schedule)."""
    import hashlib

    blob = json.dumps({"streams": {str(k): v for k, v in sorted(streams.items())},
                       "decisions": {str(k): v for k, v in sorted(decisions.items())}},
                      sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def tp_small_prompts(vocab: int):
    import numpy as np

    rng = np.random.default_rng(17)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in TP_SMALL_LENS]


def tp_small_pass(lm) -> dict:
    """The small fp32 model's check: the logits of one insert of two
    prompts, and greedy streams of ``TP_SMALL_LENS`` prompts served step by
    step (``fused=False``)."""
    import numpy as np

    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine

    prompts = tp_small_prompts(lm.config.vocab_size)
    sess = lm.start_session()
    two = np.zeros((2, TP_SMALL_LENS[1]), np.int32)
    for i, p in enumerate(prompts[:2]):
        two[i, :p.size] = p
    logits = lm.insert(sess, np.arange(2), two, lengths=[p.size for p in prompts[:2]])
    logits = logits.float().cpu().numpy()
    sess.close()
    engine = ServeEngine(lm, block_steps=4, fused=False)
    for p in prompts:
        engine.submit(p, TP_SMALL_NEW)
    done = engine.run()
    engine.close()
    return dict(logits=logits.tolist(), streams={c.request_id: c.tokens.tolist() for c in done})


def tp_serve_pass(lm, dev, counters, fused: bool) -> dict:
    """The serve workload (``SERVE_PROMPT_LENS``, ``MAX_NEW_TOKENS`` each)
    on ``lm`` behind one engine, the counters zeroed just before ``run()``
    and read just after; a throwaway engine warms up (captures) first."""
    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine

    warm = ServeEngine(lm, block_steps=8, fused=fused)
    warm.submit(serve_prompts(lm.config.vocab_size, seed=6)[0][:130], 4)
    warm.run()
    warm.close()
    engine = ServeEngine(lm, block_steps=8, fused=fused)
    for i, p in enumerate(serve_prompts(lm.config.vocab_size)):
        engine.submit(p, MAX_NEW_TOKENS, arrival_block=1 if i == 3 else 0)
    ops = count_host_ops(engine) if fused else []
    zero_launches(counters)
    _sync(dev)
    t0 = time.perf_counter()
    done = engine.run()
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    streams = {c.request_id: c.tokens.tolist() for c in done}
    decisions = {c.request_id: [c.finish_reason, int(c.queue_blocks), int(c.decode_blocks)]
                 for c in done}
    out = dict(requests=len(done), generated_tokens=sum(len(t) for t in streams.values()),
               wall_s=wall, decode_blocks=engine.decode_blocks, launches=launches,
               streams=streams, digest=tp_digest(streams, decisions),
               kv_bytes=lm.kv_cache_bytes(), nonfinite=engine.nonfinite_logits,
               weight_bytes=sum(nbytes(t) for t in lm.model.state_dict().values()))
    out["tokens_per_s"] = out["generated_tokens"] / wall
    if fused:
        out.update(host_op_stats(ops))
        out["decode_block_ms"] = replay_ms(engine._fused)
        out["engine"] = engine   # the caller profiles one more replay, then drops it
    else:
        engine.close()
    return out


def replay_activities(engine) -> dict:
    """Device activities (name -> count) of one more replay of ``engine``'s
    captured decode block under ``torch.profiler`` (every slot idle by now:
    the writes land in scratch pages)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine._fused.program.replay()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def tp_t1(cfg, dev, params, counters) -> dict:
    """(t1): the serve workload on ``cfg`` without a group, then through
    ``initialize_model_parallel(1)`` over a real NCCL group of one rank, each
    decode block one replay of the captured fused block (the group's
    collectives inside it). One more replay of each engine's block runs
    under ``torch.profiler``: the NCCL block's device work beyond the plain
    block's is the collectives' (at one rank NCCL launches no kernel of its
    own: an in-place all-reduce is a no-op, an all-gather one device copy)."""
    import datetime

    import torch
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM
    from neuronx_distributed_tpu_torch.parallel import mappings, mesh

    out = {}
    lm = CausalLM(cfg, params, LlamaForCausalLM, device=dev, **TP_SERVE_LM)
    out["plain"] = tp_serve_pass(lm, dev, counters, fused=True)
    engine = out["plain"].pop("engine")
    plain = replay_activities(engine)
    engine.close()
    del engine, lm
    gc.collect()
    timeout = datetime.timedelta(seconds=TP_TIMEOUT_S)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1, timeout=timeout)
    try:
        group = mesh.initialize_model_parallel(1, timeout=timeout).groups["tp"]
        # the communicator forms at its first collective: an eager one, before any capture
        mappings.all_reduce(torch.ones(1, device=dev), group)
        _sync(dev)
        lm = CausalLM(cfg, params, LlamaForCausalLM, device=dev, tp_group=group, **TP_SERVE_LM)
        st = out["nccl"] = tp_serve_pass(lm, dev, counters, fused=True)
        engine = st.pop("engine")
        acts = replay_activities(engine)
        st["collective_work"] = {k[:60]: n - plain.get(k, 0) for k, n in acts.items()
                                 if n > plain.get(k, 0)}
        st["nccl_kernels"] = {k[:60]: n for k, n in acts.items()
                              if "nccl" in k.lower() or "onerank" in k.lower()}
        st["block_steps"] = engine.block_steps
        st["group_backend"] = mesh.group_backend(group)
        engine.close()
        del engine, lm
    finally:
        mesh.destroy_model_parallel()
        dist.destroy_process_group()
        gc.collect()
    return out


def tp_child(rank: int, world: int, port: int, out_path: str, layers=None,
             parts=("t2", "rest")) -> int:
    """One rank of (t2), a process of its own on ``cuda:0`` over gloo:
    the small fp32 model's check, then ``llama3_8b`` (full width, ``layers``
    deep) on its shard, the serve workload step by step; its digest is
    all-gathered. Then phase 4q's cells on the same group (``parts``:
    which of the two run). Every rank's readings go to ``out_path``."""
    import datetime

    import torch
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch.inference.paged_kernel import paged_decode_attention
    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.kernels.flash_attn import flash_block_forward
    from neuronx_distributed_tpu_torch.kernels.w8a16 import w8a16_gemm
    from neuronx_distributed_tpu_torch.parallel import mesh

    dev = "cuda:0"
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    timeout = datetime.timedelta(seconds=TP_TIMEOUT_S)
    t0 = time.perf_counter()
    mesh.init_distributed("gloo", rank=rank, world_size=world, local_rank=0,
                          init_method=f"tcp://localhost:{port}", timeout=timeout)
    group = mesh.initialize_model_parallel(world, timeout=timeout).groups["tp"]
    _build.build()
    res = dict(rank=rank, backend=mesh.group_backend(group), startup_s=time.perf_counter() - t0)
    if "t2" in parts:
        tp_t2_cells(res, rank, world, group, dev, layers)
    if "rest" in parts:
        res["rest"] = tpr_rank_cells(dev, (flash_block_forward, paged_decode_attention,
                                           w8a16_gemm), rank, world)
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["wall_s"] = time.perf_counter() - t0
    Path(out_path).write_text(json.dumps(res))
    mesh.destroy_model_parallel()
    dist.destroy_process_group()
    return 0


def tp_t2_cells(res: dict, rank: int, world: int, group, dev, layers=None) -> None:
    """(t2)'s cells on one rank, their readings into ``res``."""
    import torch

    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
    from neuronx_distributed_tpu_torch.inference.paged_kernel import (
        paged_decode_attention,
        paged_decode_attention_plain,
    )
    from neuronx_distributed_tpu_torch.kernels.flash_attn import (
        flash_block_forward,
        flash_block_forward_plain,
    )
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params
    from neuronx_distributed_tpu_torch.parallel import mappings

    lm_kw = dict(device=dev, tp_group=group, capture_programs=False)
    small = small_config()
    sd = init_params(small, torch.Generator(device=dev).manual_seed(0), device=dev,
                     tp_rank=rank, tp_size=world)
    res["small"] = tp_small_pass(CausalLM(small, sd, LlamaForCausalLM, **lm_kw, **TP_SMALL_LM))
    cfg = serve_config()
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    t1 = time.perf_counter()
    sd = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                     tp_rank=rank, tp_size=world)
    lm = CausalLM(cfg, sd, LlamaForCausalLM, **lm_kw, **TP_SERVE_LM)
    del sd
    res["setup_s"] = time.perf_counter() - t1
    with torch.device("meta"):   # the same model at TP=1: its bytes
        res["weight_bytes_tp1"] = sum(nbytes(t) for t in LlamaForCausalLM(cfg).state_dict().values())
    res["layers"] = cfg.num_layers
    qkv = lm.model.model.layers[0].attention.qkv
    res["local_heads"] = [qkv.num_heads, qkv.num_kv_heads]
    counters = (flash_block_forward, paged_decode_attention)
    st = tp_serve_pass(lm, dev, counters, fused=False)
    # every rank's digest, gathered over the group
    mine = torch.tensor([int(st["digest"], 16)], dtype=torch.int64)
    st["digests"] = [format(int(v), "016x")
                     for v in mappings._all_gather(mine, 0, group).tolist()]
    # the page I/O's gather: a read of 4 pages at full width, median of 3
    eng = ServeEngine(lm, block_steps=8, fused=False)
    times = []
    for _ in range(3):
        _sync(dev)
        ta = time.perf_counter()
        pages = eng._read_pages_bytes([1, 2, 3, 4])
        times.append((time.perf_counter() - ta) * 1e3)
    st["page_read_ms"] = sorted(times)[1]
    st["page_shape"] = list(pages[0]["keys"].shape)
    eng.close()
    res["serve"] = st
    # B1 and B2 at this rank's heads, each against its twin (not counted)
    h, hk = res["local_heads"]
    q, k, v, qp, kp, _, _ = flash_case(dev, h=h, hk=hk)
    args = (q, k, v, qp, kp, q.shape[-1] ** -0.5, 64, 64, h // hk, h)
    got, _ = flash_block_forward(*args)
    ref, _ = flash_block_forward_plain(*args)
    b1 = float((got.float() - ref.float()).abs().max())
    pargs, kw = paged_case(dev, "bf16", n_q=h, n_kv=hk)
    r = held(paged_decode_attention(*pargs, **kw), paged_decode_attention_plain(*pargs, **kw),
             TOL_PAGED_FLOOR, exact=decode_exact(*pargs, **kw))
    res["held"] = dict(flash_fwd=dict(shape=f"q {tuple(q.shape)}, k/v {tuple(k.shape)}",
                                      max_abs_err=b1, tolerance=TOL_FLASH_BF16),
                       paged_decode=dict(shape=f"q {tuple(pargs[0].shape)}, pools "
                                         f"{tuple(pargs[1].shape)}", **r))
    del lm, eng, q, k, v, qp, kp, pargs
    _free(dev)


def tp_t2(dev, layers=None, parts=("t2", "rest")) -> dict:
    """(t2) and phase 4q: :func:`tp_child` as ``TP_WORLD`` processes on the
    one card, each a rank of a gloo group; the card's used memory polled
    while they run. A rank that fails or outlives ``TP_CHILD_TIMEOUT_S``
    fails the phase (every process is stopped)."""
    import torch

    port = _free_port()
    free0, total = torch.cuda.mem_get_info()
    peak_used = total - free0
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(Path(tmp) / f"rank{r}.log", "w") for r in range(TP_WORLD)]
        cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--tp-world", str(TP_WORLD),
               "--tp-port", str(port), "--tp-parts", ",".join(parts)] + (
                   ["--tp-layers", str(layers)] if layers else [])
        procs = [subprocess.Popen(cmd + ["--tp-rank", str(r), "--tp-out",
                                         str(Path(tmp) / f"rank{r}.json")],
                                  cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(TP_WORLD)]
        t0 = time.perf_counter()
        try:
            while any(p.poll() is None for p in procs):
                if time.perf_counter() - t0 > TP_CHILD_TIMEOUT_S:
                    raise SmokeFailure(f"tp phase: the ranks ran past {TP_CHILD_TIMEOUT_S} s")
                if any(p.poll() not in (None, 0) for p in procs):
                    break   # one rank failed: its peer fails at the group's timeout
                free, _ = torch.cuda.mem_get_info()
                peak_used = max(peak_used, total - free)
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in logs:
                f.close()
        wall = time.perf_counter() - t0
        for r, p in enumerate(procs):
            if p.returncode != 0:
                tail = (Path(tmp) / f"rank{r}.log").read_text()[-3000:]
                raise SmokeFailure(f"tp phase: rank {r} exited {p.returncode}:\n{tail}")
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(TP_WORLD)]
    return dict(ranks=ranks, wall_s=wall, card_peak_used_bytes=peak_used, card_bytes=total,
                layers=layers)


def tp_gates(t1: dict, t2: dict, small_ref: dict) -> list:
    """Phase 4j's hard gates, as a list of problems (empty: pass)."""
    import numpy as np

    bad = []
    nc, pl = t1["nccl"], t1["plain"]
    if nc["streams"] != pl["streams"]:
        bad.append("(t1) streams through the NCCL group differ from the plain ones")
    if nc.get("group_backend") != "nccl":
        bad.append(f"(t1) the group's backend is {nc.get('group_backend')}")
    for name, st in (("nccl", nc), ("plain", pl)):
        if not (st["steady_blocks"] and st["steady_ok"]):
            bad.append(f"(t1 {name}) steady decode blocks are not 2 host ops: {st['host_ops']}")
        if st["requests"] != len(SERVE_PROMPT_LENS) or st["nonfinite"]:
            bad.append(f"(t1 {name}) {st['requests']} requests, {st['nonfinite']} non-finite")
    # the logits' all-gather alone is one device copy a step
    if sum(nc.get("collective_work", {}).values()) < nc.get("block_steps", 1):
        bad.append(f"(t1) the replay through the NCCL group holds no more device work than "
                   f"the plain block's: {nc.get('collective_work')}")
    for rk in t2["ranks"]:
        r, sm, st = rk["rank"], rk["small"], rk["serve"]
        if rk.get("backend") != "gloo":
            bad.append(f"(t2 rank {r}) group backend {rk.get('backend')}")
        if {int(k): v for k, v in sm["streams"].items()} != {
                int(k): v for k, v in small_ref["streams"].items()}:
            bad.append(f"(t2 rank {r}) small-model greedy streams differ from TP=1's")
        err = float(np.abs(np.asarray(sm["logits"]) - np.asarray(small_ref["logits"])).max())
        rk["small_logits_max_abs_err"] = err
        if not err <= TP_SMALL_TOL:
            bad.append(f"(t2 rank {r}) small-model logits differ from TP=1's by {err}")
        if st["requests"] != len(SERVE_PROMPT_LENS) or st["generated_tokens"] != (
                len(SERVE_PROMPT_LENS) * MAX_NEW_TOKENS) or st["nonfinite"]:
            bad.append(f"(t2 rank {r}) {st['requests']} requests, {st['generated_tokens']} "
                       f"tokens, {st['nonfinite']} non-finite")
        if len(set(st["digests"])) != 1 or st["digests"][r] != st["digest"]:
            bad.append(f"(t2 rank {r}) digests differ across ranks: {st['digests']}")
        # TP=1's footprint of the same model: kv_bytes_global, the TP=1 model's bytes
        kv, kv1 = st["kv_bytes"]["kv_bytes"], st["kv_bytes"]["kv_bytes_global"]
        if not kv <= TP_SHARE_MAX * kv1:
            bad.append(f"(t2 rank {r}) kv_bytes {kv} against TP=1's {kv1}")
        if not st["weight_bytes"] <= TP_SHARE_MAX * rk["weight_bytes_tp1"]:
            bad.append(f"(t2 rank {r}) weight bytes {st['weight_bytes']} against TP=1's "
                       f"{rk['weight_bytes_tp1']}")
        if tuple(rk["local_heads"]) != TP_LOCAL_HEADS:
            bad.append(f"(t2 rank {r}) local heads {rk['local_heads']}")
        for name in ("flash_block_forward", "paged_decode_attention"):
            if not st["launches"].get(name):
                bad.append(f"(t2 rank {r}) {name} never launched")
        hb = rk["held"]
        if not hb["flash_fwd"]["max_abs_err"] <= TOL_FLASH_BF16:
            bad.append(f"(t2 rank {r}) B1 at local heads differs from its twin by "
                       f"{hb['flash_fwd']['max_abs_err']}")
        if not hb["paged_decode"]["ok"]:
            bad.append(f"(t2 rank {r}) B2 at local heads is not held: {hb['paged_decode']}")
    if len({rk["serve"]["digest"] for rk in t2["ranks"]}) != 1:
        bad.append("(t2) the ranks' digests differ")
    return bad


def run_tp_phase(cfg, dev, params, counters, layers=TP_LAYERS) -> dict:
    """Phase 4j: (t1) on the serve weights, the small model's TP=1
    reference on the card, then (t2) with this process holding no model
    or session, and :func:`tp_gates`; phase 4q runs in (t2)'s processes
    after its cells (``rest``: :func:`tpr_finish`'s readings, its gates
    held here too)."""
    import torch

    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.kernels.w8a16 import w8a16_gemm
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params

    t0 = time.perf_counter()
    out = {"t1": tp_t1(cfg, dev, params, counters)}
    small = small_config()
    sd = init_params(small, torch.Generator(device=dev).manual_seed(0), device=dev)
    small_ref = tp_small_pass(CausalLM(small, sd, LlamaForCausalLM, device=dev,
                                       capture_programs=False, **TP_SMALL_LM))
    del sd
    gc.collect()
    torch.cuda.empty_cache()
    out["t2"] = tp_t2(dev, layers)
    out["rest"] = tpr_finish(out["t2"], dev, tuple(counters) + (w8a16_gemm,))
    problems = tp_gates(out["t1"], out["t2"], small_ref)
    ref = out["t1"]["plain"]["streams"]
    for rk in out["t2"]["ranks"]:
        got = {int(k): v for k, v in rk["serve"].pop("streams").items()}
        # against (t1) when both ran the same depth
        if rk["layers"] == cfg.num_layers:
            rk["serve"]["token_match_tp1"] = _token_match(got, ref)
        rk["small"].pop("logits")
    out["phase_s"] = time.perf_counter() - t0
    if problems:
        print_tp(out, card_line())
    check(not problems, "tp phase: " + "; ".join(problems))
    rest = out["rest"].pop("problems")
    if rest:
        print_tp_rest(out["rest"], card_line())
    check(not rest, "tp rest phase: " + "; ".join(rest))
    for st in out["t1"].values():
        st.pop("streams")
    return out


def print_tp(tp: dict, card: str) -> None:
    nc, pl = tp["t1"]["nccl"], tp["t1"]["plain"]
    print(f"tp (t1): llama3_8b full width, serve workload, captured fused blocks: decode block "
          f"ms {nc['decode_block_ms']} through initialize_model_parallel(1) over NCCL against "
          f"{pl['decode_block_ms']} without a group; {nc['tokens_per_s']:.1f} against "
          f"{pl['tokens_per_s']:.1f} tok/s; streams bit-identical "
          f"{nc['streams'] == pl['streams'] if 'streams' in nc else True}; host ops a block "
          f"{nc['host_ops']}; one replay's device work beyond the plain block's "
          f"{json.dumps(nc['collective_work'])} (NCCL's own kernels "
          f"{json.dumps(nc['nccl_kernels'])}); "
          f"launches {nc['launches']} and {pl['launches']} [{card}]", flush=True)
    t2 = tp["t2"]
    for rk in t2["ranks"]:
        st = rk["serve"]
        print(f"tp (t2) rank {rk['rank']}: gloo, capture_programs=False, fused=False; small fp32 "
              f"model greedy streams equal TP=1's, logits max |diff| "
              f"{rk.get('small_logits_max_abs_err', 'n/a')} (tol {TP_SMALL_TOL}); llama3_8b full "
              f"width, {rk['layers']} layers, heads {rk['local_heads']}: "
              f"{st['requests']} requests, {st['generated_tokens']} tokens in "
              f"{st['wall_s']:.3f} s = {st['tokens_per_s']:.1f} tok/s, kv bytes "
              f"{json.dumps(st['kv_bytes'])}, weight bytes {st['weight_bytes']} (TP=1 "
              f"{rk['weight_bytes_tp1']}), digest "
              f"{st['digest']} (all {st['digests']}), tokens equal to (t1)'s "
              f"{st.get('token_match_tp1', 'n/a')}, page read (4 pages, gathered) "
              f"{st['page_read_ms']:.2f} ms {st['page_shape']}, launches {st['launches']}, B1 "
              f"held max |err| {rk['held']['flash_fwd']['max_abs_err']:.3g} at "
              f"{rk['held']['flash_fwd']['shape']}, B2 max |err| "
              f"{rk['held']['paged_decode']['max_abs_err']:.3g} at "
              f"{rk['held']['paged_decode']['shape']}, peak {rk['peak_bytes']} bytes, set-up "
              f"{rk['setup_s']:.1f} s, process {rk['wall_s']:.1f} s [{card}]", flush=True)
    print(f"tp (t2): {len(t2['ranks'])} processes on one card in {t2['wall_s']:.1f} s, card peak "
          f"used {t2['card_peak_used_bytes']} of {t2['card_bytes']} bytes; phase "
          f"{tp['phase_s']:.1f} s [{card}]", flush=True)


# --- phase 4q: tensor-parallel serving, the rest ------------------------------------------

TPR_MIXTRAL_LAYERS = 8        # (u1)/(u2) mixtral_8x7b depth, of 32
TPR_LLAMA_LAYERS = 4          # (u3) llama2_13b depth, of 40
TPR_GENERATE = ["generate", "--model", "mixtral", "--quantize", "--max_new_tokens", "32"]
TPR_SERVE = ["serve", "--model", "mixtral", "--quantize", "--paged", "--paged-kernel",
             "--num_requests", "8", "--prompt_len", "256", "--max_new_tokens", "16",
             "--max_batch", "8"]
TPR_SPEC = ["speculate", "--draft_layers", "2", "--max_new_tokens", "32"]
TPR_MEDUSA = ["medusa", "--max_new_tokens", "32"]
# (u0): B5 at the shard shapes a rank's products take at TP 2, (K, N, experts):
# the attention's Q and K/V products run apart (GQAQKVColumnParallelLinear)
TPR_B5_SHAPES = {"mixtral q": (4096, 2048, 1), "mixtral k/v": (4096, 512, 1),
                 "mixtral o_proj": (2048, 4096, 1), "mixtral gate/up": (4096, 7168, 8),
                 "mixtral down": (7168, 4096, 8), "13b q/k/v": (5120, 2560, 1),
                 "13b o_proj": (2560, 5120, 1), "13b gate/up": (5120, 6912, 1),
                 "13b down": (6912, 5120, 1)}
TPR_B5_ROWS = (1, 8, 512)
TPR_B5_SELECTIVE = 2          # (token, expert) pairs of one decode token at top 2
# (u0): B1 at a rank's heads: Mixtral-8x7B's 16 q / 4 kv over (u2)'s 256-token
# bucket, Llama-2-13B's 20 over (u3)'s 128-token prompt
TPR_B1 = {"mixtral": dict(h=16, hk=4, sq=256, d=128), "13b": dict(h=20, hk=20, sq=128, d=128)}
TPR_SMALL_NEW = 12            # (u4) tokens a greedy stream
TPR_SMALL_LORA = dict(r=8, lora_alpha=16.0)


def tpr_b5_cases() -> list:
    """(u0)'s B5 cases: (name, dtype, B, M, K, N, E, shared, routed)."""
    out = []
    for dtype in ("bf16", "fp32"):
        for name, (K, N, E) in TPR_B5_SHAPES.items():
            for M in TPR_B5_ROWS:
                # an expert weight: all_experts, every expert on one shared x
                out.append((f"{name}, {dtype}, {M} rows", dtype, E, M, K, N, E, E > 1, False))
            if E > 1:   # selective: one row a (token, expert) pair, through idx
                out.append((f"{name}, {dtype}, selective", dtype, TPR_B5_SELECTIVE, 1, K, N, E,
                            False, True))
    return out


def tpr_route(case) -> str:
    """The B5 route of one ``tpr_b5_cases`` case (shapes alone decide)."""
    import torch

    from neuronx_distributed_tpu_torch.kernels.w8a16 import _route

    _name, dtype, B, M, K, N, _E, _shared, _routed = case
    return _route(B, M, K, N, torch.bfloat16 if dtype == "bf16" else torch.float32)


def b5_case_held(dev, case) -> dict:
    """One B5 case (``tpr_b5_cases``' tuple) launched twice (the same bits)
    and held element by element against its twin and its fp64 evaluation
    (``held``; the fp32 floor grows with sqrt(K / 4096)); ``problems``
    lists what fails (``held_problems``)."""
    import torch

    from neuronx_distributed_tpu_torch.kernels.w8a16 import w8a16_gemm, w8a16_gemm_plain

    name, dtype, B, M, K, N, E, shared, routed = case
    x, q, scale, idx = w8a16_case(dev, dtype, B, M, K, N, E, shared, routed, False)
    out = w8a16_gemm(x, q, scale, idx)
    problems = [] if torch.equal(out, w8a16_gemm(x, q, scale, idx)) else [
        f"w8a16_gemm ({name}): a second launch gave other bits"]
    bf16 = dtype == "bf16"
    floor = TOL_W8A16_FLOOR if bf16 else TOL_W8A16_FP32_FLOOR * math.sqrt(max(1.0, K / 4096))
    r = held(out, w8a16_gemm_plain(x, q, scale, idx), floor, rel=REL_BF16 if bf16 else REL_FP32,
             exact=w8a16_exact(x, q, scale, idx))
    r["route"] = tpr_route(case)
    r["problems"] = problems + held_problems(f"w8a16_gemm ({name})", r)
    return r


def b5_cases_held(dev, cases) -> dict:
    """``b5_case_held`` on each of ``cases``, by name, with cuBLAS's
    reduced-precision bf16 reductions off (the twin's products sum in
    fp32)."""
    import torch

    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = {}
    try:
        for case in cases:
            out[case[0]] = b5_case_held(dev, case)
            _free(dev)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    return out


def b1_heads_held(dev, h: int, hk: int, sq: int, d: int, preset, sk: int = 0,
                  seed: int = 41) -> dict:
    """B1 in bf16 over ``h`` query heads on ``hk`` KV heads: ``sq`` queries
    at positions 0.. against ``sk`` keys at 0.. (``sk`` 0: ``sq``, a causal
    prompt), the blocks ``preset``'s cached path picks; held element by
    element against its twin and its fp64 evaluation with the floor
    ``EP_B1_FLOOR`` (``held_problems``) and the LSE within ``TOL_LSE``."""
    import torch

    from neuronx_distributed_tpu_torch.kernels.flash_attn import (
        flash_block_forward,
        flash_block_forward_plain,
    )

    sk = sk or sq
    blk_q, blk_k = preset(max_seq_len=max(sk, 4096)).blocks_for(sq, sk)
    blk_q, blk_k = min(blk_q, sq), min(blk_k, sk)
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((n, s, d), generator=g, device=dev).to(torch.bfloat16)
               for n, s in ((h, sq), (hk, sk), (hk, sk)))
    qpos, kpos = (torch.arange(s, dtype=torch.int32, device=dev).reshape(1, 1, s)
                  for s in (sq, sk))
    args = (q, k, v, qpos, kpos, d ** -0.5, blk_q, blk_k, h // hk, h)
    o, lse = flash_block_forward(*args)
    ref, ref_lse = flash_block_forward_plain(*args)
    r = held(o, ref, EP_B1_FLOOR, exact=fwd_exact(*args)[0])
    r["lse_max_abs_err"] = float((lse - ref_lse).abs().max())
    r["shape"] = (f"q ({h}, {sq}, {d}) bf16 at positions 0..{sq - 1}, k/v ({hk}, {sk}, {d}), "
                  f"group {h // hk}, blocks {blk_q} x {blk_k}")
    r["problems"] = held_problems(f"flash_fwd at {r['shape']}", r)
    if r["lse_max_abs_err"] > TOL_LSE:
        r["problems"].append(f"flash_fwd lse at {r['shape']} differs from the twin's by "
                             f"{r['lse_max_abs_err']:.3g}")
    return r


def tpr_kernel_check(dev, rank: int = 0, world: int = 1) -> dict:
    """(u0): this rank's share of the B5 cases (every ``world``-th from
    ``rank``) and of the two B1 cases, not timed and not counted."""
    from neuronx_distributed_tpu_torch.models.llama import llama2_13b
    from neuronx_distributed_tpu_torch.models.mixtral import mixtral_8x7b

    out = {"w8a16_gemm": b5_cases_held(dev, tpr_b5_cases()[rank::world]),
           "flash_block_forward": {}}
    presets = {"mixtral": mixtral_8x7b, "13b": llama2_13b}
    for name in sorted(TPR_B1)[rank::world]:
        out["flash_block_forward"][name] = b1_heads_held(dev, **TPR_B1[name],
                                                         preset=presets[name])
    _free(dev)
    return out


def tpr_mixtral_config(layers: int = TPR_MIXTRAL_LAYERS):
    """(u1)/(u2)'s model: the runner's Mixtral-8x7B config, cut in depth."""
    runner = ep_runner()
    return dataclasses.replace(runner.build_config(runner.parse_args(TPR_GENERATE)),
                               num_layers=layers)


def tpr_llama_config(layers: int = TPR_LLAMA_LAYERS):
    """(u3)'s model: the runner's Llama-2-13B config, cut in depth."""
    runner = ep_runner()
    return dataclasses.replace(runner.build_config(runner.parse_args(TPR_SPEC)),
                               num_layers=layers)


def tpr_int8_bytes(cfg, model_cls, tp: int = 1) -> int:
    """A rank's int8 weight bytes at degree ``tp``, reckoned from the
    shapes on the meta device (nothing is built): every weight's pair (or
    float leaf) cut by its spec."""
    import torch

    from neuronx_distributed_tpu_torch.inference.partition import (
        local_shape,
        param_partition_specs,
        scale_spec,
    )
    from neuronx_distributed_tpu_torch.quantization.core import quantize_leaf

    with torch.device("meta"):
        model = model_cls(cfg)
        specs = param_partition_specs(model)
        total = 0
        for name, t in model.state_dict().items():
            for k, v in quantize_leaf(name, t).items():
                sp = scale_spec(specs[name], tuple(v.shape)) if k.endswith(".scale") and \
                    k != name else specs[name]
                total += math.prod(local_shape(tuple(v.shape), sp, tp)) * v.element_size()
    return total


class _Spied:
    """While active, ``module.attr`` is wrapped so that each of this
    thread's calls lands in ``calls`` as ``(args, kwargs, result)`` (thread
    ranks share the module: one wrapper, a list per thread)."""

    _lock = threading.Lock()

    def __init__(self, module, attr: str):
        self.module, self.attr, self.calls = module, attr, []

    def __enter__(self):
        with self._lock:
            spy = getattr(self.module, self.attr)
            if not hasattr(spy, "spied_calls"):
                base = spy

                def spy(*a, **kw):
                    out = base(*a, **kw)
                    calls = spy.spied_calls.get(threading.get_ident())
                    if calls is not None:
                        calls.append((a, kw, out))
                    return out

                spy.spied_calls, spy.spied_base = {}, base
                setattr(self.module, self.attr, spy)
            spy.spied_calls[threading.get_ident()] = self.calls
        return self

    def __exit__(self, *exc):
        with self._lock:
            spy = getattr(self.module, self.attr)
            spy.spied_calls.pop(threading.get_ident(), None)
            if not spy.spied_calls:
                setattr(self.module, self.attr, spy.spied_base)
        return False


def tpr_mixtral_cells(dev, counters, rank: int, world: int, cfg=None) -> dict:
    """(u1) and (u2) on this rank: the Mixtral int8 shard drawn once (each
    weight whole, quantized, then cut: ``init_params``' rule, the runner's
    seed), then ``generate`` and ``serve --paged --paged-kernel`` through
    the runner at ``--tp world``."""
    import torch

    from neuronx_distributed_tpu_torch.inference import engine as engine_mod
    from neuronx_distributed_tpu_torch.models.llama import init_params
    from neuronx_distributed_tpu_torch.models.mixtral import MixtralForCausalLM
    from neuronx_distributed_tpu_torch.moe.expert_mlps import ExpertMLPs
    from neuronx_distributed_tpu_torch.quantization.core import QuantizationConfig

    cfg = cfg or tpr_mixtral_config()
    tp = ["--tp", str(world)] if world > 1 else []
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                         model_cls=MixtralForCausalLM, quantize=QuantizationConfig(),
                         tp_rank=rank, tp_size=world)
    _sync(dev)
    out = {"setup_s": time.perf_counter() - t0, "layers": cfg.num_layers,
           "weight_bytes": sum(nbytes(t) for t in params.values()),
           "weight_bytes_tp1": tpr_int8_bytes(cfg, MixtralForCausalLM)}
    # the decode steps at batch 1 run the selective experts (B5's decode
    # route through the (token, expert) index): their calls counted
    with _Spied(ExpertMLPs, "forward_selective") as spied:
        u1 = out["u1"] = ep_run(TPR_GENERATE + tp, dev, counters, params=params, config=cfg)
        u1["selective_calls"] = len(spied.calls)
        spied.calls.clear()
    u1["tokens"] = [r["generated"] for r in u1.pop("report")]
    u1["tokens_per_s"] = sum(len(t) for t in u1["tokens"]) / u1["wall_s"]
    with _Spied(engine_mod, "run_trace") as spied:
        u2 = out["u2"] = ep_run(TPR_SERVE + tp, dev, counters, params=params, config=cfg)
        engine = spied.calls[-1][0][0]
        streams = {c.request_id: c.tokens.tolist() for c in engine.completed}
        spied.calls.clear()
        del engine
    u2["digest"] = tp_digest(streams, {})
    u2["tokens"] = sum(len(t) for t in streams.values())
    del params
    _free(dev)
    return out


def tpr_llama_cells(dev, counters, world: int, cfg=None) -> dict:
    """(u3) on this rank: ``speculate --draft_layers 2`` and ``medusa``
    through the runner at ``--tp world`` on its seeded Llama-2-13B shards;
    whether each speculative run's draft holds the target's own tensors."""
    from neuronx_distributed_tpu_torch.inference import speculative

    cfg = cfg or tpr_llama_config()
    tp = ["--tp", str(world)] if world > 1 else []
    out = {"layers": cfg.num_layers}
    with _Spied(speculative, "speculative_generate") as spied:
        spec = out["speculate"] = ep_run(TPR_SPEC + tp, dev, counters, config=cfg)
        shared = []
        for (target, draft, *_), _kw, _res in spied.calls:
            mine = {t.data_ptr() for t in target.model.state_dict().values()}
            shared.append(all(t.data_ptr() in mine for t in draft.model.state_dict().values()))
        spied.calls.clear()
    spec["draft_shared"] = bool(shared) and all(shared)
    _free(dev)
    out["medusa"] = ep_run(TPR_MEDUSA + tp, dev, counters, config=cfg)
    _free(dev)
    return out


def tpr_small_configs():
    """(u4)'s small fp32 models: ``small_config``'s Llama, a Mixtral of its
    widths (4 experts, top 2: selective at 1 row, all_experts at 3), and
    the Llama at ``kv_size_multiplier=2``."""
    from neuronx_distributed_tpu_torch.models.mixtral import MixtralConfig

    llama = small_config()
    fields = {f.name: getattr(llama, f.name) for f in dataclasses.fields(llama)}
    mixtral = MixtralConfig(**fields, num_experts=4, top_k=2, selective_loading_threshold=1.5)
    return llama, mixtral, dataclasses.replace(llama, kv_size_multiplier=2)


def tpr_small(dev, rank: int = 0, world: int = 1, counters=()) -> dict:
    """(u4) at degree ``world`` (this rank's shards; 1: the reference):
    int8 Llama (greedy streams and one insert's logits), int8 Mixtral in
    both MoE modes, greedy speculation over a one-layer self-draft, Medusa
    (the runner's head init) and multi-LoRA at ``kv_size_multiplier=2``,
    each eager (``capture_programs=False``) and each stream greedy."""
    import numpy as np
    import torch

    from neuronx_distributed_tpu_torch.inference.causal_lm import CausalLM
    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
    from neuronx_distributed_tpu_torch.inference.medusa import (
        DEFAULT_CHOICES,
        medusa_generate,
        medusa_model,
    )
    from neuronx_distributed_tpu_torch.inference.speculative import speculative_generate
    from neuronx_distributed_tpu_torch.lora.core import LoraConfig, init_lora
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params
    from neuronx_distributed_tpu_torch.models.mixtral import MixtralForCausalLM
    from neuronx_distributed_tpu_torch.quantization.core import QuantizationConfig

    runner = ep_runner()
    llama, mixtral, kvm = tpr_small_configs()
    kw = dict(device=dev, capture_programs=False)
    shard = dict(tp_rank=rank, tp_size=world)
    prompts = np.stack([p[:40] for p in tp_small_prompts(llama.vocab_size)[:3]])
    zero_launches(counters)
    out = {}

    def draw(cfg, cls=LlamaForCausalLM, quantize=None):
        return init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                           model_cls=cls, quantize=quantize, **shard)

    q = QuantizationConfig()
    lm = CausalLM(llama, draw(llama, quantize=q), LlamaForCausalLM, buckets=(64,), max_batch=3,
                  **kw)
    out["int8_llama"] = dict(
        streams=lm.generate(prompts, max_new_tokens=TPR_SMALL_NEW).tokens.tolist(),
        logits=lm.insert(lm.start_session(), np.arange(3), prompts).float().cpu().tolist())
    del lm
    mq = draw(mixtral, MixtralForCausalLM, q)
    for rows in (3, 1):   # all_experts (3 * 2 / 4 >= 1.5), selective
        lm = CausalLM(mixtral, mq, MixtralForCausalLM, buckets=(64,), max_batch=rows, **kw)
        out[f"int8_mixtral_{rows}"] = dict(
            mode=lm.model.model.layers[0].moe.mode_for(rows, 1),
            streams=lm.generate(prompts[:rows], max_new_tokens=TPR_SMALL_NEW).tokens.tolist())
        del lm
    del mq
    target = CausalLM(llama, draw(llama), LlamaForCausalLM, buckets=(64,), max_batch=1, **kw)
    draft = CausalLM(dataclasses.replace(llama, num_layers=1),
                     runner._draft_params(target, 1), LlamaForCausalLM, buckets=(64,),
                     max_batch=1, **kw)
    res = speculative_generate(target, draft, prompts[:1], max_new_tokens=TPR_SMALL_NEW,
                               num_draft=3)
    out["speculation"] = dict(streams=res.tokens.tolist(), accepted=res.stats["accepted"])
    del target, draft
    mp = runner.medusa_init(llama, 0, dev, **shard)
    res = medusa_generate(llama, medusa_model(llama, mp, 2, dev, capture_programs=False),
                          prompts[:1], max_new_tokens=TPR_SMALL_NEW,
                          medusa_choices=DEFAULT_CHOICES, device=dev)
    out["medusa"] = dict(streams=res.tokens.tolist(), accepted=res.stats["accepted"])
    del mp
    acfg = LoraConfig(**TPR_SMALL_LORA)
    base = init_params(kvm, torch.Generator(device=dev).manual_seed(0), device=dev)
    ads = {}
    for i in range(2):   # full-width adapters: the pool keeps the rank's slices
        ad = init_lora(base, acfg, torch.Generator().manual_seed(50 + i))
        g = torch.Generator().manual_seed(60 + i)
        ads[f"a{i}"] = {k: {"lora_a": v["lora_a"], "lora_b": 0.05 * torch.randn(
            v["lora_b"].shape, generator=g)} for k, v in sorted(ad.items())}
    del base
    lm = CausalLM(kvm, draw(kvm), LlamaForCausalLM, buckets=(64,), max_batch=3, lora_rank=8,
                  lora_slots=3, **kw)
    eng = ServeEngine(lm, block_steps=4, fused=False, seed=0)
    for name, ad in ads.items():
        eng.register_adapter(name, ad, acfg)
    for i, p in enumerate(prompts):
        eng.submit(p, TPR_SMALL_NEW, adapter=None if i == 0 else f"a{i % 2}")
    done = eng.run()
    eng.close()
    # a list by request id: the readings cross a JSON file from the ranks
    out["lora_kvm2"] = dict(streams=[c.tokens.tolist()
                                     for c in sorted(done, key=lambda c: c.request_id)])
    del lm, eng
    out["launches"] = {c.__name__: c.launches for c in counters}
    out["launches_by_route"] = routes_of(counters)
    _free(dev)
    return out


def tpr_rank_cells(dev, counters, rank: int, world: int) -> dict:
    """Phase 4q on one rank of (t2)'s processes: (u0)-(u4), in order."""
    t0 = time.perf_counter()
    out = {"u0": tpr_kernel_check(dev, rank, world)}
    out.update(tpr_mixtral_cells(dev, counters, rank, world))
    out["u3"] = tpr_llama_cells(dev, counters, world)
    out["u4"] = tpr_small(dev, rank, world, counters)
    out["wall_s"] = time.perf_counter() - t0
    return out


def tpr_reference(dev, counters) -> dict:
    """What phase 4q's TP=2 cells are held against, made in the parent
    after the ranks: (u1) at TP=1 on the same seeded int8 weights (printed,
    not gated), and (u4) at TP=1."""
    t0 = time.perf_counter()
    u1 = ep_run(TPR_GENERATE, dev, counters, config=tpr_mixtral_config())
    out = {"u1_tokens": [r["generated"] for r in u1["report"]],
           "u1_tokens_per_s": sum(len(r["generated"]) for r in u1["report"]) / u1["wall_s"],
           "u1_peak_bytes": u1["peak_bytes"]}
    _free(dev)
    out["u4"] = tpr_small(dev)
    out["wall_s"] = time.perf_counter() - t0
    return out


def tpr_gates(ranks: list, ref: dict, card_peak_used: int, card_bytes: int,
              on_card: bool = True) -> list:
    """Phase 4q's hard gates over the ranks' ``rest`` readings and the
    parent's TP=1 references, as a list of problems (empty: pass);
    ``on_card=False`` leaves out the launch gates and the eager route's
    (a CPU rehearsal runs the twins, captured)."""
    import numpy as np

    bad = []
    rests = [rk["rest"] for rk in ranks]
    for rk, st in zip(ranks, rests):
        r = rk["rank"]
        for kind in ("w8a16_gemm", "flash_block_forward"):
            for case, reading in st["u0"][kind].items():
                bad += [f"(u0 rank {r}) {p}" for p in reading["problems"]]
        u1 = st["u1"]
        if not st["weight_bytes"] <= TP_SHARE_MAX * st["weight_bytes_tp1"]:
            bad.append(f"(u1 rank {r}) int8 weight bytes {st['weight_bytes']} against TP=1's "
                       f"{st['weight_bytes_tp1']}")
        routes = u1["launches_by_route"].get("w8a16_gemm", {})
        want = [("(u1)", u1, "flash_block_forward"), ("(u2)", st["u2"], "paged_decode_attention"),
                ("(u3) speculate", st["u3"]["speculate"], "flash_block_forward"),
                ("(u3) medusa", st["u3"]["medusa"], "flash_block_forward")]
        for cell, reading, name in want if on_card else ():
            if reading["launches"].get(name, 0) <= 0:
                bad.append(f"{cell} rank {r}: {name} never launched")
        for route in ("wgmma", "decode") if on_card else ():
            if routes.get(route, 0) <= 0:
                bad.append(f"(u1 rank {r}) w8a16_gemm never launched on its {route} route")
        f32 = st["u4"]["launches_by_route"].get("w8a16_gemm", {}).get("f32", 0)
        if on_card and f32 <= 0:
            bad.append(f"(u4 rank {r}) w8a16_gemm never launched on its f32 route")
        if u1["selective_calls"] <= 0:
            bad.append(f"(u1 rank {r}) no decode step ran the selective experts")
        if not u1["tokens"] or any(len(t) != 32 for t in u1["tokens"]):
            bad.append(f"(u1 rank {r}) streams of lengths {[len(t) for t in u1['tokens']]}")
        u2 = st["u2"]
        rep = u2["report"]
        if rep.get("requests_completed") != 8 or u2["tokens"] != 8 * 16:
            bad.append(f"(u2 rank {r}) {rep.get('requests_completed')} requests, "
                       f"{u2['tokens']} tokens")
        if (on_card and rep.get("fused") is not False) or rep.get("tp_degree") != 2:
            bad.append(f"(u2 rank {r}) fused {rep.get('fused')}, tp {rep.get('tp_degree')}")
        u3 = st["u3"]
        if not u3["speculate"]["draft_shared"]:
            bad.append(f"(u3 rank {r}) the draft does not hold the target's tensors")
        if u3["medusa"]["report"].get("matches_base_greedy") is not True:
            bad.append(f"(u3 rank {r}) Medusa's output is not the base greedy stream")
        u4, want = st["u4"], ref["u4"]
        for case in ("int8_llama", "int8_mixtral_3", "int8_mixtral_1", "speculation", "medusa",
                     "lora_kvm2"):
            if u4[case]["streams"] != want[case]["streams"]:
                bad.append(f"(u4 rank {r}) {case} greedy streams differ from TP=1's")
        for rows, mode in ((3, "all_experts"), (1, "selective")):
            if u4[f"int8_mixtral_{rows}"]["mode"] != mode:
                bad.append(f"(u4 rank {r}) {rows} rows ran {u4[f'int8_mixtral_{rows}']['mode']}")
        err = float(np.abs(np.asarray(u4["int8_llama"]["logits"])
                           - np.asarray(want["int8_llama"]["logits"])).max())
        u4["int8_logits_max_abs_err"] = err
        if not err <= TP_SMALL_TOL:
            bad.append(f"(u4 rank {r}) int8 logits differ from TP=1's by {err}")
    if len(rests) > 1:
        a, b = rests[0], rests[1]
        if a["u1"]["tokens"] != b["u1"]["tokens"]:
            bad.append("(u1) the ranks' tokens differ")
        if a["u2"]["digest"] != b["u2"]["digest"]:
            bad.append("(u2) the ranks' stream digests differ")
        for name in ("speculate", "medusa"):
            if a["u3"][name]["report"]["generated"] != b["u3"][name]["report"]["generated"]:
                bad.append(f"(u3) the ranks' {name} tokens differ")
    if not card_peak_used < card_bytes:
        bad.append(f"the card's used memory reached {card_peak_used} of {card_bytes} bytes")
    return bad


def tpr_finish(t2: dict, dev, counters, on_card: bool = True) -> dict:
    """Phase 4q's parent half, after (t2)'s processes: the TP=1 references
    and :func:`tpr_gates` (``problems``); the readings without the
    streams."""
    ref = tpr_reference(dev, counters)
    problems = tpr_gates(t2["ranks"], ref, t2["card_peak_used_bytes"], t2["card_bytes"],
                         on_card)
    out = {"ranks": [], "reference_s": ref["wall_s"], "u1_tokens_per_s_tp1":
           ref["u1_tokens_per_s"], "u1_peak_bytes_tp1": ref["u1_peak_bytes"]}
    for rk in t2["ranks"]:
        st = rk.pop("rest")
        got = {i: t for i, t in enumerate(st["u1"]["tokens"])}
        st["u1"]["token_match_tp1"] = _token_match(got, dict(enumerate(ref["u1_tokens"])))
        st["u4"]["int8_llama"].pop("logits")
        out["ranks"].append({"rank": rk["rank"], **st})
    out["phase_s"] = max(st["wall_s"] for st in out["ranks"]) + ref["wall_s"]
    out["problems"] = problems
    return out


def tpr_launches_by_path(st: dict) -> dict:
    """Phase 4q's launches by path for the kernels line (each path with the
    kernels it launched; the gates hold which it must)."""
    out = {}
    for rk in st["ranks"]:
        r = rk["rank"]
        out[f"tp_rest_u1_rank{r}"] = rk["u1"]["launches"]
        out[f"tp_rest_u2_rank{r}"] = rk["u2"]["launches"]
        out[f"tp_rest_u3_speculate_rank{r}"] = rk["u3"]["speculate"]["launches"]
        out[f"tp_rest_u3_medusa_rank{r}"] = rk["u3"]["medusa"]["launches"]
        out[f"tp_rest_u4_rank{r}"] = rk["u4"]["launches"]
    out = {path: {k: v for k, v in counts.items() if v} for path, counts in out.items()}
    return {path: counts for path, counts in out.items() if counts}


def tpr_b5_routes_by_path(st: dict) -> dict:
    """B5's launches by route on each phase 4q path that ran it."""
    out = {}
    for rk in st["ranks"]:
        r = rk["rank"]
        for path, cell in ((f"tp_rest_u1_rank{r}", rk["u1"]), (f"tp_rest_u2_rank{r}", rk["u2"]),
                           (f"tp_rest_u4_rank{r}", rk["u4"])):
            routes = cell["launches_by_route"].get("w8a16_gemm", {})
            if sum(routes.values()):
                out[path] = routes
    return out


def print_tp_rest(st: dict, card: str) -> None:
    for rk in st["ranks"]:
        r, u0, u1, u2, u3, u4 = (rk[k] for k in ("rank", "u0", "u1", "u2", "u3", "u4"))
        b5 = u0["w8a16_gemm"]
        worst = max(b5, key=lambda c: b5[c]["floor_needed"] / b5[c]["floor"])
        b1 = u0["flash_block_forward"]
        print(f"tp rest (u0) rank {r}: w8a16_gemm held at {len(b5)} shard cases (routes "
              f"{sorted({c['route'] for c in b5.values()})}), the nearest {worst} needs "
              f"{b5[worst]['floor_needed']:.3g} of {b5[worst]['floor']:.3g}; flash_fwd "
              + "; ".join(f"{n} {c['shape']} needs {c['floor_needed']:.3g} of {c['floor']:.3g}, "
                          f"lse {c['lse_max_abs_err']:.3g}" for n, c in b1.items())
              + f" [{card}]", flush=True)
        rep2 = u2["report"]
        print(f"tp rest (u1) rank {r}: generate --model mixtral --quantize --tp 2, "
              f"{rk['layers']} of 32 layers: {sum(len(t) for t in u1['tokens'])} tokens in "
              f"{u1['wall_s']:.3f} s = {u1['tokens_per_s']:.1f} tok/s (prefill included), int8 "
              f"weight bytes {rk['weight_bytes']} against TP=1's {rk['weight_bytes_tp1']} "
              f"({rk['weight_bytes'] / rk['weight_bytes_tp1']:.4f}), tokens equal to TP=1's "
              f"{u1['token_match_tp1']:.4f} (TP=1 {st['u1_tokens_per_s_tp1']:.1f} tok/s), "
              f"selective expert calls {u1['selective_calls']}, "
              f"launches {u1['launches']} by route {u1['launches_by_route']}, set-up "
              f"{rk['setup_s']:.1f} s, peak {u1['peak_bytes']} bytes [{card}]", flush=True)
        print(f"tp rest (u2) rank {r}: serve --model mixtral --quantize --paged --paged-kernel "
              f"--tp 2 (eager, fused {rep2.get('fused')}): {rep2.get('requests_completed')} "
              f"requests, {u2['tokens']} tokens, {rep2.get('tokens_per_sec')} tok/s, ITL p50 "
              f"{rep2.get('itl_p50_ms')} ms p99 {rep2.get('itl_p99_ms')} ms, digest "
              f"{u2['digest']}, launches {u2['launches']}, peak {u2['peak_bytes']} bytes "
              f"[{card}]", flush=True)
        sp, md = u3["speculate"]["report"], u3["medusa"]["report"]
        print(f"tp rest (u3) rank {r}: llama2_13b widths, {u3['layers']} of 40 layers, bf16: "
              f"speculate --draft_layers 2 {sp['tokens_per_sec']} tok/s, acceptance "
              f"{sp['acceptance_rate']} ({sp['accepted']} of {sp['proposed']}), draft shares "
              f"the target's tensors {u3['speculate']['draft_shared']}; medusa accepted "
              f"{md['accepted']} of {md['proposed']}, matches the base greedy stream "
              f"{md['matches_base_greedy']}; launches {u3['speculate']['launches']} and "
              f"{u3['medusa']['launches']} [{card}]", flush=True)
        print(f"tp rest (u4) rank {r}: small fp32 models at TP=2 against TP=1: greedy streams "
              f"equal (int8 llama, int8 mixtral all_experts and selective, speculation, medusa, "
              f"multi-LoRA at kv_size_multiplier 2), int8 logits max |diff| "
              f"{u4.get('int8_logits_max_abs_err', 'n/a')} (tol {TP_SMALL_TOL}), B5 by route "
              f"{u4['launches_by_route'].get('w8a16_gemm')}; the rank's phase "
              f"{rk['wall_s']:.1f} s [{card}]", flush=True)
    print(f"tp rest: TP=1 references {st['reference_s']:.1f} s; phase {st['phase_s']:.1f} s "
          f"[{card}]", flush=True)


def train_batch(vocab: int, batch: int, seq: int, dev, seed: int = 7) -> dict:
    """Next-token batch from a seeded numpy RNG (the JAX examples'
    ``synthetic_lm_batches``), on ``dev``."""
    import numpy as np
    import torch

    ids = np.random.RandomState(seed).randint(0, vocab, (batch, seq + 1), dtype=np.int64)
    return {"ids": torch.as_tensor(ids[:, :-1].astype(np.int32), device=dev),
            "labels": torch.as_tensor(ids[:, 1:].astype(np.int32), device=dev)}


def build_trainer(cfg, dev, lr: float, params=None, lora=None, master=True, adapters=None):
    """The training entry points a user calls: config -> model -> optimizer
    -> state -> step (AdamW with fp32 master weights, or plain AdamW on the
    params when ``master`` is False; clipping at norm 1.0). ``lora``: a
    ``LoraConfig``'s fields (the base frozen, the adapters trained);
    ``adapters``: a flat adapter tree to start from instead of the seeded
    one. Returns ``(model, optimizer, state, step)``."""
    from neuronx_distributed_tpu_torch.lora import LoraConfig
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM
    from neuronx_distributed_tpu_torch.trainer import (
        create_train_state,
        initialize_parallel_model,
        initialize_parallel_optimizer,
        make_train_step,
        neuronx_distributed_config,
    )

    nxd = neuronx_distributed_config(
        optimizer_config={"zero_one_enabled": True, "grad_clipping": True, "max_grad_norm": 1.0},
        mixed_precision_config={"use_master_weights": master}, model_init_config={"seed": 0},
        lora_config=None if lora is None else LoraConfig(**lora))
    model = initialize_parallel_model(nxd, lambda: LlamaForCausalLM(cfg), device=dev,
                                      params=params)
    if adapters is not None:
        model.bind_trainable({n: t.to(model.device) for n, t in adapters.items()})
    opt = initialize_parallel_optimizer(nxd, model, learning_rate=lr, weight_decay=0.01)

    def loss_fn(p, batch, rng):
        return model.apply(p, batch["ids"], batch["labels"], method="loss")

    return model, opt, create_train_state(model, opt), make_train_step(model, opt, loss_fn)


# the small model trained GPU vs CPU: each case's config and optimizer
# (phase 3); the LoRA cases start from the same adapters on both devices
# (drawn on the CPU, B nonzero) and the dropout case feeds both the same
# keep-masks, drawn on the CPU
TRAIN_CHECK_LORA = dict(r=16, lora_alpha=32.0)
TRAIN_CHECK_CASES = (
    ("full", dict(remat="full")),
    ("attention", dict(remat="attention")),
    ("plain_adamw", dict(remat="full", master=False)),
    ("lora", dict(remat="full", lora=TRAIN_CHECK_LORA)),
    ("lora_dropout", dict(remat="full", lora=dict(TRAIN_CHECK_LORA, lora_dropout=0.05))),
)


def check_adapters(params, lora: dict, seed: int = 5) -> dict:
    """A flat adapter tree for the state dict ``params``, drawn on the CPU:
    ``init_lora``'s A, and B ~ N(0, 0.01^2) (nonzero, so A trains from the
    first step)."""
    import torch

    from neuronx_distributed_tpu_torch.lora import LoraConfig, init_lora
    from neuronx_distributed_tpu_torch.lora.core import flat_lora

    g = torch.Generator().manual_seed(seed)
    flat = flat_lora(init_lora(params, LoraConfig(**lora), g))
    return {n: t if n.endswith(".lora_a") else torch.randn(tuple(t.shape), generator=g) * 0.01
            for n, t in flat.items()}


def check_masks(adapters: dict, batch, keep: float, steps: int, seed: int = 6) -> list:
    """Per step, a keep-mask per adapted weight (bool, the shape of the
    layer's input), drawn on the CPU."""
    import torch

    g = torch.Generator().manual_seed(seed)
    b, s = batch["ids"].shape
    fan_in = {n[: -len(".lora_a")]: t.shape[0] for n, t in adapters.items()
              if n.endswith(".lora_a")}
    return [{w: torch.rand((b, s, f), generator=g) < keep for w, f in sorted(fan_in.items())}
            for _ in range(steps)]


def train_check(dev, counters) -> dict:
    """Two training steps of the small fp32 model (sequence 256: the flash
    gate) on ``dev`` and on the CPU from the same weights, in each of
    ``TRAIN_CHECK_CASES``: losses and every trained weight after step 2
    must agree, the loss fall, ``dev`` launch B1, B3a and B3b (and B4 but
    under plain AdamW) and the CPU launch nothing."""
    import dataclasses

    import torch

    from neuronx_distributed_tpu_torch.models.llama import init_params

    base = small_config()
    params = init_params(base, torch.Generator().manual_seed(3))
    out = {}
    for name, case in TRAIN_CHECK_CASES:
        cfg = dataclasses.replace(base, remat_policy=case["remat"])
        lora, runs = case.get("lora"), {}
        adapters = None if lora is None else check_adapters(params, lora)
        for d in (dev, "cpu"):
            before = {c.__name__: c.launches for c in counters}
            model, _opt, state, step = build_trainer(cfg, d, TRAIN_CHECK_LR, params=params,
                                                     lora=lora, master=case.get("master", True),
                                                     adapters=adapters)
            batch = train_batch(cfg.vocab_size, 2, cfg.max_seq_len, d, seed=8)
            masks = [None, None]
            if lora is not None and lora.get("lora_dropout"):
                masks = check_masks(adapters, batch, 1.0 - lora["lora_dropout"], 2)
            losses = []
            for i in range(2):
                state, m = step(state, batch, lora_masks=masks[i])
                losses.append(float(m["loss"]))
            runs[d] = (losses, {n: p.float().cpu() for n, p in state.params.items()},
                       {c.__name__: c.launches - before[c.__name__] for c in counters})
            del model, state, step
        (gl, gp, launched), (cl, cp, cpu_launched) = runs[dev], runs["cpu"]
        for kname, n in launched.items():
            if not (kname == "fused_adamw_leaf" and name == "plain_adamw"):
                check(n > 0, f"the small training check ({name}) never launched {kname}")
        check(not any(cpu_launched.values()),
              f"the CPU run ({name}) launched kernels: {cpu_launched}")
        loss_err = max(abs(a - b) for a, b in zip(gl, cl))
        param_err = max(float((gp[n] - cp[n]).abs().max()) for n in gp)
        check(loss_err <= TOL_TRAIN_LOSS,
              f"small-model training losses ({name}) differ GPU vs CPU by {loss_err}")
        check(param_err <= TOL_TRAIN_PARAMS,
              f"small-model weights after two steps ({name}) differ GPU vs CPU by {param_err}")
        check(gl[1] < gl[0], f"small-model loss ({name}) did not fall: {gl}")
        out[name] = dict(losses_gpu=gl, losses_cpu=cl, loss_max_abs_err=loss_err,
                         param_max_abs_err=param_err, trained_tensors=len(gp), launches=launched)
    return out


# --- phase 4k: the training loop a user runs -------------------------------------

# Llama-3-8B at full width and depth, LoRA on the five default targets, fp32
# master AdamW on the adapters (B4), clipping 1.0, remat "full"; the corpus
# 4 sequences of 4096 tokens in 2 shards (2 batches an epoch, reshuffled
# each epoch), so the first and the last epoch's mean losses are over the
# same tokens
TRAIN_LOOP_BATCH, TRAIN_LOOP_SEQ = 2, 4096
TRAIN_LOOP_ROWS, TRAIN_LOOP_SHARDS = 4, 2
TRAIN_LOOP_STEPS, TRAIN_LOOP_SAVE_AT = 6, 3
TRAIN_LOOP_LORA = dict(r=16, lora_alpha=32.0, lora_dropout=0.05)
TRAIN_LOOP_LR = 1e-3
TRAIN_LOOP_SEED = 17
TRAIN_LOOP_COUNTERS = ("flash_block_forward", "flash_bwd_dkdv", "flash_bwd_dq",
                       "fused_adamw_leaf")


def train_loop_config():
    import torch

    from neuronx_distributed_tpu_torch.models.llama import llama3_8b

    return llama3_8b(max_seq_len=TRAIN_LOOP_SEQ, dtype=torch.bfloat16,
                     param_dtype=torch.bfloat16, remat_policy="full")


def train_loop_shards(root: Path, vocab: int, seq: int, rows: int = TRAIN_LOOP_ROWS,
                      shards: int = TRAIN_LOOP_SHARDS, seed: int = TRAIN_LOOP_SEED) -> list:
    """The corpus as token shards, written from a seeded numpy stream."""
    import numpy as np

    from neuronx_distributed_tpu_torch.data import write_token_shard

    rs = np.random.RandomState(seed)
    paths = []
    for i in range(shards):
        p = root / f"corpus_{i}.tokens"
        write_token_shard(str(p), rs.randint(0, vocab, (rows // shards, seq)).astype(np.int32))
        paths.append(str(p))
    return paths


def _timed_step(step, dev, seconds: list):
    """``step`` with its synced wall seconds appended to ``seconds``."""
    def run(state, batch, **kw):
        t = time.perf_counter()
        out = step(state, batch, **kw)
        _sync(dev)
        seconds.append(time.perf_counter() - t)
        return out
    return run


def _records(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


def _tag_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def run_train_loop(cfg, dev, counters, root: Path, lora=TRAIN_LOOP_LORA, lr=TRAIN_LOOP_LR,
                   batch=TRAIN_LOOP_BATCH, steps=TRAIN_LOOP_STEPS, save_at=TRAIN_LOOP_SAVE_AT,
                   flush=None) -> dict:
    """Phase 4k: token shards -> ``TokenShardDataset`` (native) ->
    ``train_loop`` (``steps`` LoRA steps, an async save after step
    ``save_at`` and one after the last) -> a crash in the last save (its
    ``done`` marker gone) -> a model, optimizer, loader and generator built
    from nothing, resumed through ``maybe_resume`` (verified) from the
    newest done tag -> the remaining steps. The counters are zeroed just
    before the first step and read after the resumed run. Returns the
    readings; :func:`train_loop_gates` judges them."""
    import shutil

    import torch

    from neuronx_distributed_tpu_torch.checkpoint import core as ckpt
    from neuronx_distributed_tpu_torch.data import TokenShardDataset
    from neuronx_distributed_tpu_torch.examples.common import maybe_resume, train_loop
    from neuronx_distributed_tpu_torch.optimizer.fused_kernel import (
        fused_adamw_leaf,
        fused_adamw_leaf_plain,
        leaf_supported,
    )

    on_card = torch.device(dev).type == "cuda"
    paths = train_loop_shards(root, cfg.vocab_size, cfg.max_seq_len)
    ck = root / "ckpt"
    t0 = time.perf_counter()
    ds = TokenShardDataset(paths, batch_size=batch, shuffle_seed=TRAIN_LOOP_SEED, native=True)
    model, opt, state, step = build_trainer(cfg, dev, lr, lora=lora)
    _sync(dev)
    build_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    zero_launches(counters)
    times_a: list = []
    state, _ = train_loop(_timed_step(step, dev, times_a), state, iter(ds), steps,
                          batch_size=batch, device=model.device, log_every=1,
                          checkpoint_dir=str(ck), checkpoint_every=save_at,
                          metrics_file=str(root / "run_a.jsonl"),
                          metrics_out=str(root / "run_a_registry.json"), dataset=ds)
    peak_run = torch.cuda.max_memory_allocated() if on_card else None
    background = dict(ckpt.last_save_seconds)
    run_a = _records(root / "run_a.jsonl")
    save_ms = json.loads((root / "run_a_registry.json").read_text())["train_checkpoint_ms"]
    adapters_a = {n: t.clone() for n, t in state.params.items()}
    tags_after_run = sorted(p.name for p in ck.iterdir())
    # the crash: the last save lost its completion marker
    (ck / f"step_{steps}" / "done").unlink()
    resume_tag = ckpt.latest_tag(str(ck))
    tag_bytes = _tag_bytes(ck / resume_tag)
    # a byte flipped in a copy of the payload must fail verification
    flipped = root / "flipped"
    shutil.copytree(ck / resume_tag, flipped / resume_tag)
    payload = flipped / resume_tag / "state" / "tensors.safetensors"
    data = bytearray(payload.read_bytes())
    data[len(data) // 3] ^= 0x10
    payload.write_bytes(bytes(data))
    try:
        ckpt.load_checkpoint(str(flipped), verify=True)
        flip_caught = False
    except ckpt.CheckpointIntegrityError:
        flip_caught = True
    shutil.rmtree(flipped)

    # a fresh process state: model, optimizer, loader and generator from nothing
    ds_b = TokenShardDataset(paths, batch_size=batch, shuffle_seed=TRAIN_LOOP_SEED, native=True)
    model_b, opt_b, state_b, step_b = build_trainer(cfg, dev, lr, lora=lora)
    base_unchanged = all(torch.equal(model.params[n], p) for n, p in model_b.params.items())
    t = time.perf_counter()
    state_b = maybe_resume(str(ck), state_b, dataset=ds_b, verify=True)
    _sync(dev)
    load_s = time.perf_counter() - t
    resumed_at = int(state_b.step)
    times_b: list = []
    state_b, _ = train_loop(_timed_step(step_b, dev, times_b), state_b, iter(ds_b), steps,
                            batch_size=batch, device=model_b.device, log_every=1,
                            checkpoint_dir=str(ck), checkpoint_every=save_at,
                            metrics_file=str(root / "run_b.jsonl"), dataset=ds_b)
    launches = {c.__name__: c.launches for c in counters}
    run_b = _records(root / "run_b.jsonl")
    adapters_equal = all(torch.equal(state_b.params[n], t) for n, t in adapters_a.items())
    base_still = all(torch.equal(model.params[n], p) for n, p in model_b.params.items())
    peak_phase = torch.cuda.max_memory_allocated() if on_card else None

    # B4 on the adapters, off the main path: one update of every leaf on
    # copies (kernel route and the plain route), and one leaf against its twin
    tx = opt.tx
    g = torch.Generator(device=model.device).manual_seed(3)
    grads = {n: torch.randn(p.shape, generator=g, device=p.device) * 1e-3
             for n, p in adapters_a.items()}
    st = opt.init(adapters_a)
    scale = torch.tensor(0.5, device=model.device)
    b4_leaves = sum(1 for t in adapters_a.values() if leaf_supported(t.numel()))
    opt_ms = plain_opt_ms = None
    if on_card:
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev) if flush is None else flush
        opt_ms = time_ms(lambda: tx.update_and_params_local(grads, st, adapters_a, scale=scale,
                                                            out=adapters_a), 5, flush)
        plain_opt_ms = time_ms(lambda: tx.update_and_params(grads, st, adapters_a, scale=scale,
                                                            out=adapters_a), 3, flush)
    supported = [n for n in adapters_a if leaf_supported(adapters_a[n].numel())]
    name = max(supported, key=lambda n: adapters_a[n].numel()) if supported else None
    leaf_err = None
    if name is not None:
        leaf = [st.mu[name].clone(), st.nu[name].clone(), st.master[name].clone()]
        twin = [x.clone() for x in leaf]
        scalars = torch.tensor([[0.5, lr, 1 - 0.9 ** 2, 1 - 0.999 ** 2]], device=model.device)
        kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01, p_dtype=torch.float32)
        *_, p = fused_adamw_leaf(grads[name], *leaf, scalars, **kw)
        _sync(dev)
        *_, p_ref = fused_adamw_leaf_plain(grads[name], *twin, scalars, **kw)
        leaf_err = max(float((a - b).abs().max()) for a, b in zip(leaf + [p], twin + [p_ref]))

    losses_a = [r["loss"] for r in run_a]
    n_total = steps + (steps - resumed_at)
    warm = times_a[1:] or times_a
    out = dict(
        layers=cfg.num_layers, hidden=cfg.hidden_size, vocab=cfg.vocab_size, batch=batch,
        seq=cfg.max_seq_len, lora=dict(lora), lr=lr, save_at=save_at, base_params=model.num_params(),
        adapter_params=sum(t.numel() for t in adapters_a.values()),
        adapter_tensors=len(adapters_a), b4_leaves=b4_leaves, build_s=build_s,
        using_native=ds.using_native and ds_b.using_native, shards=len(paths),
        step_ms=[x * 1e3 for x in times_a], step_ms_resumed=[x * 1e3 for x in times_b],
        step_ms_mean=sum(warm) / len(warm) * 1e3,
        tokens_per_s=batch * cfg.max_seq_len / (sum(warm) / len(warm)),
        losses=losses_a, grad_norms=[r["grad_norm"] for r in run_a],
        losses_resumed=[r["loss"] for r in run_b],
        grad_norms_resumed=[r["grad_norm"] for r in run_b],
        steps_resumed=[r["step"] for r in run_b], resumed_at=resumed_at,
        resume_tag=resume_tag, tags_after_run=tags_after_run,
        tags_at_end=sorted(p.name for p in ck.iterdir() if p.is_dir()),
        save_sync_ms=save_ms["samples"][0]["sum"] / max(save_ms["samples"][0]["count"], 1),
        saves=save_ms["samples"][0]["count"],
        save_background_ms={k: v * 1e3 for k, v in background.items()},
        load_ms=load_s * 1e3, tag_bytes=tag_bytes, flip_caught=flip_caught,
        base_unchanged=base_unchanged and base_still, adapters_equal=adapters_equal,
        epoch_loss_first=sum(losses_a[:2]) / 2, epoch_loss_last=sum(losses_a[-2:]) / 2,
        launches=launches, launches_per_step={k: v / n_total for k, v in launches.items()},
        b4_update_ms=opt_ms, b4_plain_update_ms=plain_opt_ms, b4_leaf=name,
        b4_leaf_max_abs_err=leaf_err, peak_bytes_run=peak_run, peak_bytes_phase=peak_phase,
        device_bytes=(torch.cuda.get_device_properties(0).total_memory if on_card else None))
    del model, model_b, state, state_b, step, step_b, adapters_a, grads, st
    return out


def train_loop_gates(st: dict, kernels: bool = True) -> list:
    """The phase's failures (empty: every gate held). ``kernels=False``
    leaves out the launch and memory gates (a CPU rehearsal)."""
    bad = []
    want = lambda cond, msg: None if cond else bad.append(msg)  # noqa: E731
    n = len(st["losses"])
    want(st["using_native"], "the native token-shard reader was not used")
    want(st["resume_tag"] == f"step_{st['save_at']}" and st["resumed_at"] == st["save_at"],
         f"resumed from {st['resume_tag']} at step {st['resumed_at']}")
    want(st["tags_at_end"] == [f"step_{st['save_at']}", f"step_{n}"],
         f"tags at the end {st['tags_at_end']}")
    want(st["steps_resumed"] == list(range(st["resumed_at"] + 1, n + 1)),
         f"the resumed run logged steps {st['steps_resumed']}")
    k = st["resumed_at"]
    want(st["losses_resumed"] == st["losses"][k:],
         f"resumed losses {st['losses_resumed']} differ from {st['losses'][k:]}")
    want(st["grad_norms_resumed"] == st["grad_norms"][k:],
         f"resumed grad norms {st['grad_norms_resumed']} differ from {st['grad_norms'][k:]}")
    want(st["adapters_equal"], "the resumed adapters differ from the uninterrupted run's")
    want(st["base_unchanged"], "the frozen base weights changed")
    want(all(math.isfinite(x) for x in st["losses"] + st["grad_norms"]),
         "a loss or grad norm is not finite")
    want(st["epoch_loss_last"] < st["epoch_loss_first"],
         f"the loss did not fall: epoch means {st['epoch_loss_first']} -> "
         f"{st['epoch_loss_last']}")
    want(st["flip_caught"], "a flipped payload byte passed verify=True")
    if kernels:
        err = st["b4_leaf_max_abs_err"]
        want(err is not None and err <= TOL_ADAMW,
             f"B4 on the adapter leaf {st['b4_leaf']} differs from its twin by {err}")
        for name in TRAIN_LOOP_COUNTERS:
            want(st["launches"].get(name, 0) > 0, f"the train loop never launched {name}")
        want(st["peak_bytes_phase"] < st["device_bytes"],
             f"peak {st['peak_bytes_phase']} exceeds the card's {st['device_bytes']}")
    return bad


def print_train_loop(st: dict, card: str) -> None:
    print(f"train loop (k1): llama3_8b full width and depth ({st['layers']} layers), LoRA "
          f"{json.dumps(st['lora'])} on {st['adapter_tensors']} tensors ({st['adapter_params']} "
          f"adapter params, {st['base_params']} frozen), batch {st['batch']} x {st['seq']}, native "
          f"reader over {st['shards']} shards: step ms {[round(x, 1) for x in st['step_ms']]} "
          f"(mean after the first {st['step_ms_mean']:.1f}, {st['tokens_per_s']:.0f} tok/s), "
          f"resumed {[round(x, 1) for x in st['step_ms_resumed']]}; losses "
          f"{[round(x, 4) for x in st['losses']]}; save sync ms {st['save_sync_ms']:.1f} "
          f"({st['saves']} saves), background ms "
          f"{json.dumps({k: round(v, 1) for k, v in st['save_background_ms'].items()})}, load ms "
          f"(verified) {st['load_ms']:.1f}, {st['tag_bytes']} bytes on disk a tag; resumed from "
          f"{st['resume_tag']}: losses, grad norms and adapters bit-identical, base unchanged; B4 "
          f"launches a step {st['launches_per_step'].get('fused_adamw_leaf')} ({st['b4_leaves']} "
          f"of {st['adapter_tensors']} leaves), one update of every adapter "
          f"{st['b4_update_ms']:.3f} ms (plain route {st['b4_plain_update_ms']:.3f} ms); "
          f"launches a step {json.dumps(st['launches_per_step'])}; peak {st['peak_bytes_run']} "
          f"(run) / {st['peak_bytes_phase']} (two models) of {st['device_bytes']} bytes; build "
          f"{st['build_s']:.1f} s [{card}]", flush=True)


def train_config():
    import torch

    from neuronx_distributed_tpu_torch.models.llama import llama3_8b

    return llama3_8b(num_layers=TRAIN_LAYERS, max_seq_len=TRAIN_SEQ, dtype=torch.bfloat16,
                     param_dtype=torch.bfloat16, remat_policy="full")


def profile_step(step, state, batch, path: str):
    """One more training step under ``torch.profiler`` (device activity
    only): the device's busy share of that step's wall time and the kernels
    by device time (table at ``path``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return state, device_profile_summary(prof, wall, path, top=15)


def train(cfg, dev, counters, profile_path=None) -> dict:
    """Train Llama-3-8B widths at cut depth: ``TRAIN_WARMUP`` steps, then
    ``TRAIN_STEPS`` timed steps with the launch counters zeroed just before
    and read just after; one batch repeated, so the loss must fall."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, _opt, state, step = build_trainer(cfg, dev, TRAIN_LR)
    batch = train_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    metrics = []
    for _ in range(TRAIN_WARMUP):
        state, m = step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    step_s = []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        metrics.append(m)
    launches = {c.__name__: c.launches for c in counters}
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    check(all(math.isfinite(x) for x in losses + norms),
          f"non-finite loss or grad norm: {losses} {norms}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(peak < total, f"peak memory {peak} exceeds the card's {total}")
    for name, n in launches.items():
        check(n > 0, f"the training path never launched {name}")
    mean_s = sum(step_s) / len(step_s)
    stats = dict(
        layers=cfg.num_layers, hidden=cfg.hidden_size, vocab=cfg.vocab_size,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, params=model.num_params(), setup_s=setup_s,
        step_ms=[s * 1e3 for s in step_s], step_ms_mean=mean_s * 1e3,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / mean_s, losses=losses, grad_norms=norms,
        peak_bytes=peak, device_bytes=total, launches=launches,
        launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()})
    if profile_path is not None:
        p = Path(profile_path)
        state, stats["profile"] = profile_step(step, state, batch,
                                               str(p.with_name(f"{p.stem}_train{p.suffix}")))
    del model, state, step
    return stats


# (k2) the train cell's variants: "attention" remat, plain AdamW on the bf16
# params (each warmed up one step, then TRAIN_VARIANT_STEPS timed)
TRAIN_VARIANT_STEPS = 3
TRAIN_VARIANTS = (("attention", dict(remat_policy="attention"), True),
                  ("plain_adamw", dict(), False))


def train_variants(cfg, dev, counters) -> dict:
    """The train cell (phase 5's config and batch) under each of
    ``TRAIN_VARIANTS``: step ms, peak bytes, launches a step and B1's a
    layer; every loss finite and falling. Plain AdamW has no kernel of its
    own, so B4 is not among its counters."""
    import dataclasses

    import torch

    out = {}
    for name, over, master in TRAIN_VARIANTS:
        c = dataclasses.replace(cfg, **over)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model, _opt, state, step = build_trainer(c, dev, TRAIN_LR, master=master)
        batch = train_batch(c.vocab_size, TRAIN_BATCH, TRAIN_SEQ, dev)
        state, m = step(state, batch)
        metrics = [m]
        torch.cuda.synchronize()
        counted = [k for k in counters if master or k.__name__ != "fused_adamw_leaf"]
        zero_launches(counted)
        step_s = []
        for _ in range(TRAIN_VARIANT_STEPS):
            t = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            metrics.append(m)
        launches = {k.__name__: k.launches for k in counted}
        losses = [float(m["loss"]) for m in metrics]
        check(all(math.isfinite(x) for x in losses), f"train ({name}): non-finite loss {losses}")
        check(losses[-1] < losses[0], f"train ({name}): the loss did not fall: {losses}")
        for k, n in launches.items():
            check(n > 0, f"train ({name}) never launched {k}")
        mean_s = sum(step_s) / len(step_s)
        out[name] = dict(step_ms=[x * 1e3 for x in step_s], step_ms_mean=mean_s * 1e3,
                         tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / mean_s, losses=losses,
                         peak_bytes=torch.cuda.max_memory_allocated(), launches=launches,
                         launches_per_step={k: v / TRAIN_VARIANT_STEPS
                                            for k, v in launches.items()},
                         b1_per_layer=launches["flash_block_forward"]
                         / (TRAIN_VARIANT_STEPS * c.num_layers))
        del model, state, step
    return out


# --- phase 4l: distributed training (TP + SP + DP with ZeRO-1) ----------------------

DIST_WORLD, DIST_TP = 4, 2        # TP 2 x DP 2, four processes on the one card
DIST_LAYERS = 1                   # llama2_7b depth 32 -> 1 (fp32 masters of 32 do not fit;
                                  # 2 cut to 1: the run time)
DIST_SEQ, DIST_BATCH, DIST_STEPS = 4096, 4, 2   # 3 steps cut to 2: the run time
DIST_LR = 1e-4                    # the example's default
DIST_LOSS_RTOL = 1e-2             # (d1) vs (d0), bf16
DIST_STATE_RTOL = 0.01            # ZeRO state bytes against a quarter of (d0)'s
DIST_SMALL_TOL = 1e-5             # (d2) GPU ranks vs one CPU rank, fp32
DIST_SMALL_BATCH, DIST_SMALL_LR = 4, 1e-3
DIST_B4_PER_STEP = 7 * DIST_LAYERS + 2   # 7 matrices a layer + embedding + head
DIST_TIMEOUT_S = 300              # every group's timeout
DIST_CHILD_TIMEOUT_S = 900        # the parent's wait for the ranks
DIST_COUNTERS = ("flash_block_forward", "flash_bwd_dkdv", "flash_bwd_dq", "fused_adamw_leaf")


def _digest(tensors: dict) -> str:
    """sha256 of the tensors' bytes, in name order."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for n in sorted(tensors):
        h.update(tensors[n].detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def dist_args(layers: int, extra=()) -> list:
    """The example's arguments for the (d0)/(d1) run."""
    return ["--layers", str(layers), "--seq_len", str(DIST_SEQ), "--batch_size",
            str(DIST_BATCH), "--steps", str(DIST_STEPS), "--lr", str(DIST_LR),
            "--log_every", "0", *extra]


def dist_d0(dev, counters, layers=DIST_LAYERS) -> dict:
    """(d0): the example's model, batches and optimizer on one rank, through
    the entry points (ZeRO off: one rank); counters zeroed just before the
    steps and read just after."""
    import torch

    from neuronx_distributed_tpu_torch.examples import llama2_tp_zero1 as example
    from neuronx_distributed_tpu_torch.examples.common import synthetic_lm_batches, to_device
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM
    from neuronx_distributed_tpu_torch.trainer import (
        create_train_state,
        initialize_parallel_model,
        initialize_parallel_optimizer,
        make_train_step,
        neuronx_distributed_config,
    )

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    args = example.parse_args(dist_args(layers))
    cfg = example.build_config(args, DIST_SEQ)
    nxd = neuronx_distributed_config(
        optimizer_config={"zero_one_enabled": False, "grad_clipping": True, "max_grad_norm": 1.0},
        mixed_precision_config={"use_master_weights": True})
    model = initialize_parallel_model(nxd, lambda: LlamaForCausalLM(cfg), device=dev)
    opt = initialize_parallel_optimizer(nxd, model, learning_rate=DIST_LR,
                                        weight_decay=args.weight_decay)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, lambda p, b, rng: model.apply(
        p, b["ids"], b["labels"], method="loss"))
    batches = synthetic_lm_batches(cfg.vocab_size, DIST_BATCH, DIST_SEQ, seed=args.seed)
    next(batches)   # the example's init sample
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    zero_launches(counters)
    steps = []
    for _ in range(DIST_STEPS):
        batch = to_device(next(batches), dev)
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        steps.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                          ms=(time.perf_counter() - t) * 1e3))
    launches = {c.__name__: c.launches for c in counters}
    st = state.opt_state
    out = dict(layers=cfg.num_layers, steps=steps, launches=launches, setup_s=setup_s,
               peak_bytes=torch.cuda.max_memory_allocated(),
               param_bytes=sum(nbytes(t) for t in state.params.values()),
               state_bytes_by_leaf={n: nbytes(st.mu[n], st.nu[n], st.master[n])
                                    for n in st.mu})
    check(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]) for s in steps),
          f"dist (d0): non-finite loss or grad norm {steps}")
    del model, opt, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dist_small_batches(vocab: int, seq: int) -> list:
    """(d2)'s global batches, numpy (the same on every rank and the CPU)."""
    import numpy as np

    out = []
    for i in range(DIST_STEPS):
        ids = np.random.RandomState(30 + i).randint(0, vocab, (DIST_SMALL_BATCH, seq + 1))
        out.append({"ids": ids[:, :-1].astype(np.int32), "labels": ids[:, 1:].astype(np.int32)})
    return out


def dist_small_trainer(dev, params, tp: int):
    """(d2)'s trainer: the small fp32 model from ``params`` (global, CPU),
    TP ``tp`` with SP, ZeRO-1, fp32 masters, clipping 1.0."""
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM
    from neuronx_distributed_tpu_torch.trainer import (
        create_train_state,
        initialize_parallel_model,
        initialize_parallel_optimizer,
        make_train_step,
        neuronx_distributed_config,
    )

    nxd = neuronx_distributed_config(
        tensor_parallel_size=tp, sequence_parallel=tp > 1,
        optimizer_config={"zero_one_enabled": True, "grad_clipping": True, "max_grad_norm": 1.0},
        mixed_precision_config={"use_master_weights": True})
    model = initialize_parallel_model(nxd, lambda: LlamaForCausalLM(small_config()), device=dev,
                                      params=params)
    opt = initialize_parallel_optimizer(nxd, model, learning_rate=DIST_SMALL_LR,
                                        weight_decay=0.01)
    step = make_train_step(model, opt, lambda p, b, rng: model.apply(
        p, b["ids"], b["labels"], method="loss"))
    return create_train_state(model, opt), step


def dist_small_steps(state, step, batches, dev):
    import torch

    from neuronx_distributed_tpu_torch.parallel import mesh

    out = []
    for b in batches:
        rows = mesh.data_batch_slice(DIST_SMALL_BATCH)
        state, m = step(state, {k: torch.as_tensor(v[rows]).to(dev) for k, v in b.items()})
        out.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"])))
    return state, out


def dist_child(rank: int, world: int, port: int, out_path: str, layers: int,
               ckpt_dir: str, dev: str = "cuda:0") -> int:
    """One rank of (d1) and (d2), a process of its own on ``cuda:0`` over
    gloo. (d1): the Llama-2 example's ``main`` at TP 2 x DP 2, with a step
    hook that reads the loss, grad norm, step time and param digests; the
    launch counters and the collective table zeroed just before ``main``
    and read just after. (d2): the small fp32 model, 3 steps straight; a
    fresh state, 2 steps and an async save; a fresh group resuming step 3
    from the tag. Writes every reading to ``out_path``."""
    import datetime

    import torch
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch.checkpoint import (
        finalize_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )
    from neuronx_distributed_tpu_torch.examples import llama2_tp_zero1 as example
    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.kernels.flash_attn import (
        flash_block_forward,
        flash_bwd_dkdv,
        flash_bwd_dq,
    )
    from neuronx_distributed_tpu_torch.models.llama import init_params
    from neuronx_distributed_tpu_torch.optimizer import zero1
    from neuronx_distributed_tpu_torch.optimizer.fused_kernel import fused_adamw_leaf
    from neuronx_distributed_tpu_torch.parallel import mappings, mesh

    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    res = dict(rank=rank)
    counters = (flash_block_forward, flash_bwd_dkdv, flash_bwd_dq, fused_adamw_leaf)
    steps, mark = [], {}

    def on_step(i, state, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rec = dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                   ms=(now - mark["t"]) * 1e3 if "t" in mark else None)
        pieces = state.layout
        tp_leaves = {n for n, t in state.params.items()
                     if tuple(pieces[f".params['{n}']"].global_shape) != tuple(t.shape)}
        rec["digest"] = _digest(state.params)
        rec["replicated_digest"] = _digest({n: t for n, t in state.params.items()
                                            if n not in tp_leaves})
        if i == 0:
            st = state.opt_state
            res["param_bytes"] = sum(nbytes(t) for t in state.params.values())
            res["state_bytes_tp_sharded"] = sum(nbytes(st.mu[n], st.nu[n], st.master[n])
                                                for n in st.mu if n in tp_leaves)
            res["state_bytes_replicated"] = sum(nbytes(st.mu[n], st.nu[n], st.master[n])
                                                for n in st.mu if n not in tp_leaves)
            res["tp_sharded_leaves"] = sorted(tp_leaves)
            res["coords"] = mesh.local_mesh_coords()
        steps.append(rec)
        mark["t"] = time.perf_counter()

    argv = dist_args(layers, ["--tp", str(DIST_TP), "--backend", "gloo", "--device", dev,
                              "--coordinator_address", f"localhost:{port}",
                              "--num_processes", str(world), "--process_id", str(rank)])
    torch.cuda.reset_peak_memory_stats()
    zero_launches(counters)
    mappings.reset_collective_stats()
    zero1.staging_copies = 0
    t1 = time.perf_counter()
    example.main(argv, on_step=on_step)
    res["d1"] = dict(steps=steps, launches={c.__name__: c.launches for c in counters},
                     collectives=collective_snapshot(), staging_copies=zero1.staging_copies,
                     peak_bytes=torch.cuda.max_memory_allocated(),
                     main_s=time.perf_counter() - t1, backend=mesh.group_backend(
                         mesh.get_tensor_model_parallel_group()))
    mesh.destroy_model_parallel()
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()

    # (d2): the small fp32 model on the same layout
    timeout = datetime.timedelta(seconds=DIST_TIMEOUT_S)
    cfg = small_config()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    batches = dist_small_batches(cfg.vocab_size, cfg.max_seq_len)

    def join(p):
        mesh.init_distributed("gloo", rank=rank, world_size=world, local_rank=0,
                              init_method=f"tcp://localhost:{p}", timeout=timeout)
        mesh.initialize_model_parallel(DIST_TP, timeout=timeout)

    join(port + 1)
    state, step = dist_small_trainer(dev, params, DIST_TP)
    state, straight = dist_small_steps(state, step, batches, dev)
    want = _digest(state.params)
    state, step = dist_small_trainer(dev, params, DIST_TP)
    state, head = dist_small_steps(state, step, batches[:2], dev)
    save_checkpoint(ckpt_dir, "step_2", state, user_content={"step": 2}, async_save=True)
    torch.save({"params": {n: t.cpu() for n, t in state.params.items()},
                "layout": {k: (v.global_shape, v.offset) for k, v in state.layout.items()}},
               str(Path(out_path).with_suffix(".params.pt")))
    finalize_checkpoint()
    mesh.destroy_model_parallel()
    dist.destroy_process_group()
    join(port + 2)   # a fresh group resumes
    state, step = dist_small_trainer(dev, params, DIST_TP)
    state, content = load_checkpoint(ckpt_dir, target=state, verify=True)
    state, tail = dist_small_steps(state, step, batches[2:], dev)
    res["d2"] = dict(straight=straight, resumed=head + tail, resumed_step=content["step"],
                     bit_identical=_digest(state.params) == want
                     and [s["loss"] for s in head + tail] == [s["loss"] for s in straight])
    del state, step
    mesh.destroy_model_parallel()
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    # phase 4r's (v0): LoRA at TP 2 x DP 2 on a group of its own
    res["v0"] = ltp_rank_cell(rank, world, port + 3, dev, counters, timeout)
    res["wall_s"] = time.perf_counter() - t0
    Path(out_path).write_text(json.dumps(res))
    return 0


def dist_ranks(layers: int, ckpt_dir: str, tmp: Path) -> dict:
    """(d1) and (d2): :func:`dist_child` as ``DIST_WORLD`` processes on the
    one card; the card's used memory polled while they run. A rank that
    fails or outlives ``DIST_CHILD_TIMEOUT_S`` fails the phase (every
    process is stopped)."""
    import torch

    port = _free_port()
    free0, total = torch.cuda.mem_get_info()
    peak_used = total - free0
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(DIST_WORLD)]
    cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-world", str(DIST_WORLD),
           "--dist-port", str(port), "--dist-layers", str(layers), "--dist-dir", ckpt_dir]
    procs = [subprocess.Popen(cmd + ["--dist-rank", str(r), "--dist-out",
                                     str(tmp / f"rank{r}.json")],
                              cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(DIST_WORLD)]
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            if time.perf_counter() - t0 > DIST_CHILD_TIMEOUT_S:
                raise SmokeFailure(f"dist phase: the ranks ran past {DIST_CHILD_TIMEOUT_S} s")
            if any(p.poll() not in (None, 0) for p in procs):
                break   # one rank failed: its peers fail at the group's timeout
            free, _ = torch.cuda.mem_get_info()
            peak_used = max(peak_used, total - free)
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            tail = (tmp / f"rank{r}.log").read_text()[-3000:]
            raise SmokeFailure(f"dist phase: rank {r} exited {p.returncode}:\n{tail}")
    ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(DIST_WORLD)]
    return dict(ranks=ranks, wall_s=wall, card_peak_used_bytes=peak_used, card_bytes=total)


def dist_gates(d0: dict, d1: dict) -> list:
    """(d1)'s hard gates against (d0), as a list of problems."""
    bad = []
    ranks = d1["ranks"]
    want = [s["loss"] for s in d0["steps"]]
    worst = 0.0
    for rk in ranks:
        got = [s["loss"] for s in rk["d1"]["steps"]]
        if len(got) != DIST_STEPS:
            bad.append(f"rank {rk['rank']} ran {len(got)} steps")
            continue
        for a, b in zip(got, want):
            worst = max(worst, abs(a - b) / abs(b))
    d1["loss_max_rel_diff"] = worst
    if worst > DIST_LOSS_RTOL:
        bad.append(f"losses differ from (d0)'s by {worst:.3g} relative (limit {DIST_LOSS_RTOL})")
    for i in range(DIST_STEPS):
        by_tp = {}
        for rk in ranks:
            by_tp.setdefault(rk["coords"]["tp"], set()).add(rk["d1"]["steps"][i]["digest"])
        if any(len(v) != 1 for v in by_tp.values()):
            bad.append(f"step {i + 1}: data-parallel replicas' params differ {by_tp}")
        rep = {rk["d1"]["steps"][i]["replicated_digest"] for rk in ranks}
        if len(rep) != 1:
            bad.append(f"step {i + 1}: TP-replicated leaves differ across ranks {rep}")
    names = set(ranks[0]["tp_sharded_leaves"])
    d0_sharded = sum(v for n, v in d0["state_bytes_by_leaf"].items() if n in names)
    for rk in ranks:
        share = rk["state_bytes_tp_sharded"] / (d0_sharded / DIST_WORLD)
        rk["state_share_of_quarter"] = share
        if abs(share - 1.0) > DIST_STATE_RTOL:
            bad.append(f"rank {rk['rank']}: ZeRO state bytes {rk['state_bytes_tp_sharded']} are "
                       f"{share:.4f} of a quarter of (d0)'s {d0_sharded}")
        ln = rk["d1"]["launches"]
        for name in DIST_COUNTERS:
            if ln.get(name, 0) <= 0:
                bad.append(f"rank {rk['rank']} never launched {name}")
        if ln.get("fused_adamw_leaf") != DIST_B4_PER_STEP * DIST_STEPS:
            bad.append(f"rank {rk['rank']}: B4 launched {ln.get('fused_adamw_leaf')} times, not "
                       f"{DIST_B4_PER_STEP} a step")
    return bad


def dist_small_reference(ckpt_dir: str, tmp: Path, ranks: list) -> dict:
    """(d2)'s CPU side: the one-rank run the ranks are held against, the
    tag loaded at TP=1 on one rank against the ranks' gathered step-2
    params, and a flipped byte in one rank's piece."""
    import shutil

    import torch

    from neuronx_distributed_tpu_torch.checkpoint import CheckpointIntegrityError, load_checkpoint
    from neuronx_distributed_tpu_torch.models.llama import init_params

    cfg = small_config()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    batches = dist_small_batches(cfg.vocab_size, cfg.max_seq_len)
    state, step = dist_small_trainer("cpu", params, 1)
    _, cpu = dist_small_steps(state, step, batches, "cpu")
    errs = [max(abs(a["loss"] - c["loss"]), abs(a["grad_norm"] - c["grad_norm"]))
            for rk in ranks for a, c in zip(rk["d2"]["straight"], cpu)]
    # the tag at TP=1, one rank: every leaf whole
    target, _ = dist_small_trainer("cpu", params, 1)
    whole, content = load_checkpoint(ckpt_dir, target=target, verify=True)
    gathered = {n: torch.empty_like(t) for n, t in whole.params.items()}
    for r in range(DIST_WORLD):
        part = torch.load(str(tmp / f"rank{r}.params.pt"))
        for n, t in part["params"].items():
            _, off = part["layout"][f".params['{n}']"]
            gathered[n][tuple(slice(o, o + s) for o, s in zip(off, t.shape))] = t
    equal = all(torch.equal(gathered[n], whole.params[n]) for n in gathered)
    bad = tmp / "flipped"
    shutil.copytree(ckpt_dir, bad)
    piece = bad / "step_2" / "state" / "tensors.rank00003.safetensors"
    blob = bytearray(piece.read_bytes())
    blob[-7] ^= 0x20
    piece.write_bytes(bytes(blob))
    try:
        load_checkpoint(str(bad), verify=True)
        caught = False
    except CheckpointIntegrityError:
        caught = True
    return dict(cpu=cpu, max_abs_err=max(errs), tp1_equals_gathered=equal,
                flipped_byte_caught=caught, resumed_from=content["step"])


def run_dist_phase(dev, counters, layers=DIST_LAYERS) -> dict:
    """Phase 4l: (d0) in this process, then (d1) and (d2) as four rank
    processes, then (d2)'s CPU side; every gate."""
    t0 = time.perf_counter()
    d0 = dist_d0(dev, counters, layers)
    v0_ref = ltp_reference(dev, counters)   # phase 4r's (v0), gated there
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        ckpt = str(tmp / "ckpt")
        d1 = dist_ranks(layers, ckpt, tmp)
        d2 = dist_small_reference(ckpt, tmp, d1["ranks"])
    problems = dist_gates(d0, d1)
    if d2["max_abs_err"] > DIST_SMALL_TOL:
        problems.append(f"(d2): the ranks' losses or grad norms differ from the CPU rank's by "
                        f"{d2['max_abs_err']:.3g} (limit {DIST_SMALL_TOL})")
    for rk in d1["ranks"]:
        if not rk["d2"]["bit_identical"]:
            problems.append(f"(d2) rank {rk['rank']}: the resumed step 3 is not bit-identical")
    for key in ("tp1_equals_gathered", "flipped_byte_caught"):
        if not d2[key]:
            problems.append(f"(d2): {key} failed")
    check(not problems, "dist phase: " + "; ".join(problems))
    return dict(d0=d0, d1=d1, d2=d2, v0_ref=v0_ref, phase_s=time.perf_counter() - t0)


def print_dist(dist: dict, card: str) -> None:
    d0, d1, d2 = dist["d0"], dist["d1"], dist["d2"]

    def steps_text(steps):
        return ", ".join(f"{s['loss']:.5f}/{s['grad_norm']:.4f}"
                         + (f" {s['ms']:.0f} ms" if s.get("ms") else "") for s in steps)

    print(f"dist (d0): llama2_7b widths, {d0['layers']} of 32 layers, one rank, {DIST_BATCH} x "
          f"{DIST_SEQ} tokens a step, bf16 + fp32 masters, remat attention; loss/grad norm/step "
          f"{steps_text(d0['steps'])}; param bytes {d0['param_bytes']}, state bytes "
          f"{sum(d0['state_bytes_by_leaf'].values())}, peak {d0['peak_bytes']} bytes, set-up "
          f"{d0['setup_s']:.1f} s, launches {json.dumps(d0['launches'])} [{card}]", flush=True)
    for rk in d1["ranks"]:
        r1 = rk["d1"]
        coll = {k: f"{v[0]} calls {v[1]} bytes" for k, v in sorted(r1["collectives"].items())}
        print(f"dist (d1) rank {rk['rank']} (tp {rk['coords']['tp']}, dp {rk['coords']['dp']}): "
              f"the example over {r1['backend']}, TP {DIST_TP} x DP {DIST_WORLD // DIST_TP}, SP "
              f"and ZeRO-1 on; loss/grad norm/step {steps_text(r1['steps'])}; param bytes "
              f"{rk['param_bytes']}, ZeRO state bytes {rk['state_bytes_tp_sharded']} + "
              f"{rk['state_bytes_replicated']} on TP-replicated leaves "
              f"({rk['state_share_of_quarter']:.4f} of a quarter of (d0)'s), peak "
              f"{r1['peak_bytes']} bytes, launches {json.dumps(r1['launches'])}, collectives "
              f"{json.dumps(coll)}, ZeRO staging copies {r1['staging_copies']}, main "
              f"{r1['main_s']:.1f} s [{card}]", flush=True)
    print(f"dist (d1): every step's loss within {d1['loss_max_rel_diff']:.3g} of (d0)'s "
          f"(limit {DIST_LOSS_RTOL}); DP replicas and TP-replicated leaves bit-identical after "
          f"every step; {len(d1['ranks'])} processes in {d1['wall_s']:.1f} s with (d2), card peak "
          f"used {d1['card_peak_used_bytes']} of {d1['card_bytes']} bytes [{card}]", flush=True)
    print(f"dist (d2): small fp32 model, TP {DIST_TP} x DP {DIST_WORLD // DIST_TP} on the card vs "
          f"one CPU rank: max |loss or grad norm diff| {d2['max_abs_err']:.3g} (tol "
          f"{DIST_SMALL_TOL}); async save after step 2, a fresh group resumed step 3 bit for bit; "
          f"the tag at TP=1 equals the gathered params {d2['tp1_equals_gathered']}; flipped "
          f"byte caught {d2['flipped_byte_caught']}; phase {dist['phase_s']:.1f} s [{card}]",
          flush=True)


# --- phase 4m: context and pipeline parallelism ---------------------------------------

CPPP_WORLD = 4                    # four processes on the one card, over gloo
CP_TP, CP_CP = 2, 2               # (c1): TP 2 x CP 2, zigzag
CP_LAYERS = 1                     # llama2_7b depth 32 -> 1 (2 cut to 1: the run time)
CP_SEQ, CP_STEPS, CP_LR = 32768, 2, 1e-4   # 3 steps cut to 2: the run time
CP_SEED = 11
PP_TP, PP_PP = 2, 2               # (p1)/(p2): TP 2 x PP 2
PP_LAYERS = 4                     # llama2_70b depth 80 -> 4
PP_SEQ, PP_BATCH, PP_MB, PP_STEPS, PP_LR = 4096, 4, 4, 2, 1e-4   # 3 steps cut to 2: the run time
CPPP_LOSS_RTOL = 1e-2             # (c1) vs (c0), (p1) vs (p0), (p2) vs (p1): bf16
CPPP_SMALL_TOL = 1e-5             # (c2), (p3): card ranks vs one CPU rank, fp32
CPPP_SMALL_BATCH, CPPP_SMALL_STEPS, CPPP_SMALL_LR = 4, 3, 1e-3
# (c2)'s ring check: global q (b, h, s, d) over compact k/v (b, hk, s, d), bf16, zigzag,
# the card's ranks against CPU ranks; s = 3968 puts each zigzag chunk at 992 positions,
# not a multiple of the kernels' 64-row tiles (their block skip reads per-tile position
# bounds: a tile holds both of a rank's chunks); the twins tile at 64 as the kernels do
RING_CHECK = dict(b=1, h=8, hk=2, s=3968, d=128, block=64)
# the ring's floors, set from the readings on an H100 80GB HBM3 (700 W) at this shape
# (needed against the twins' ring or the fp64 one: out 1.1e-4, dq 3.2e-4, dk 6.6e-5,
# dv 1.7e-5; a later run read the same, as seeded inputs and deterministic kernels
# must), about twice each and under 5 % of every median |ref| (0.025-0.034). The
# planted faults of ``ring_faults`` need floors four orders of magnitude above them:
# out 1.5 (blocks merged with equal weights), 3.5 (keys a position late), 3.8 (every
# block under the rank's own positions); dk 5.0 and dv 8.2 (dK/dV a hop short of home)
RING_FLOORS = dict(out=2.5e-4, dq=6.5e-4, dk=1.5e-4, dv=5e-5)
CPPP_TIMEOUT_S = 300              # every group's timeout
CPPP_CHILD_TIMEOUT_S = 900        # the parent's wait for the ranks
CPPP_COUNTERS = DIST_COUNTERS


def cp_config(layers: int = CP_LAYERS):
    """(c0)/(c1)'s model: Llama-2-7B widths, bf16 storage (fp32 masters in
    the optimizer), remat ``"full"``, zigzag under CP."""
    import torch

    from neuronx_distributed_tpu_torch.models.llama import llama2_7b

    return llama2_7b(max_seq_len=CP_SEQ, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                     remat_policy="full", num_layers=layers, cp_layout="zigzag")


def cp_batches(vocab: int, seq: int, steps: int, batch: int = 1, seed: int = CP_SEED) -> list:
    """Seeded numpy batches, the same in every process."""
    from neuronx_distributed_tpu_torch.examples.common import synthetic_lm_batches

    stream = synthetic_lm_batches(vocab, batch, seq, seed=seed)
    return [next(stream) for _ in range(steps)]


def cp_trainer(dev, cfg, lr: float, cp: int = 1, tp: int = 1, params=None):
    """The trainer through its entry points: ZeRO-1, fp32-master AdamW,
    clipping 1.0; on a mesh with ``cp > 1`` the model runs ring attention."""
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM
    from neuronx_distributed_tpu_torch.trainer import (
        create_train_state,
        initialize_parallel_model,
        initialize_parallel_optimizer,
        make_train_step,
        neuronx_distributed_config,
    )

    nxd = neuronx_distributed_config(
        tensor_parallel_size=tp, context_parallel_size=cp,
        optimizer_config={"zero_one_enabled": True, "grad_clipping": True, "max_grad_norm": 1.0},
        mixed_precision_config={"use_master_weights": True})
    model = initialize_parallel_model(nxd, lambda: LlamaForCausalLM(cfg), device=dev,
                                      params=params)
    opt = initialize_parallel_optimizer(nxd, model, learning_rate=lr, weight_decay=0.01)
    step = make_train_step(model, opt, lambda p, b, rng: model.apply(
        p, b["ids"], b["labels"], method="loss"))
    return model, create_train_state(model, opt), step


def cp_rank_batch(b: dict, dev, cp_layout: str = "zigzag") -> dict:
    """This rank's rows and block of the sequence: the sequence permuted by
    ``zigzag_indices`` first under the zigzag layout (one rank: the whole)."""
    import torch

    from neuronx_distributed_tpu_torch.ops.ring_attention import zigzag_indices
    from neuronx_distributed_tpu_torch.parallel import mesh

    rows, seq = slice(None), b["ids"].shape[1]
    cols = slice(None)
    idx = None
    if mesh.model_parallel_is_initialized():
        rows, cols = mesh.data_batch_slice(b["ids"].shape[0]), mesh.context_seq_slice(seq)
        if cp_layout == "zigzag" and mesh.get_context_parallel_size() > 1:
            idx = zigzag_indices(seq, mesh.get_context_parallel_size()).numpy()
    out = {}
    for k, v in b.items():
        v = v[rows]
        if idx is not None:
            v = v[:, idx]
        out[k] = torch.as_tensor(v[:, cols]).to(dev)
    return out


def cp_steps(state, step, batches, dev, timed: bool = False):
    import torch

    out = []
    for b in batches:
        t = time.perf_counter()
        state, m = step(state, cp_rank_batch(b, dev))
        if timed:
            torch.cuda.synchronize()
        rec = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
        if timed:
            rec["ms"] = (time.perf_counter() - t) * 1e3
        out.append(rec)
    return state, out


def reckoning(params: int, act_bytes: int, total: int) -> dict:
    """A rank's memory plan: bf16 params and grads, fp32 masters and both
    Adam moments (16 bytes a param), the activations named, against the
    card."""
    state = 16 * params
    return dict(params=params, state_bytes=state, activation_bytes=act_bytes,
                planned_bytes=state + act_bytes, card_bytes=total)


def cp_c0(dev, counters, layers=CP_LAYERS) -> dict:
    """(c0): one rank, ``CP_STEPS`` steps of one 32768-token sequence through the
    trainer; counters zeroed just before the steps, read just after."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = cp_config(layers)
    model, state, step = cp_trainer(dev, cfg, CP_LR)
    batches = cp_batches(cfg.vocab_size, CP_SEQ, CP_STEPS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    zero_launches(counters)
    state, steps = cp_steps(state, step, batches, dev, timed=True)
    out = dict(layers=layers, steps=steps, setup_s=setup_s,
               launches={c.__name__: c.launches for c in counters},
               params=sum(p.numel() for p in state.params.values()),
               peak_bytes=torch.cuda.max_memory_allocated())
    check(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]) for s in steps),
          f"cp (c0): non-finite loss or grad norm {steps}")
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ring_check_inputs():
    """(c2)'s ring inputs, global and in natural order (bf16 on the CPU)."""
    import torch

    c = RING_CHECK
    g = torch.Generator().manual_seed(23)
    q = torch.randn((c["b"], c["h"], c["s"], c["d"]), generator=g)
    k = torch.randn((c["b"], c["hk"], c["s"], c["d"]), generator=g)
    v = torch.randn((c["b"], c["hk"], c["s"], c["d"]), generator=g)
    w = torch.randn((c["b"], c["h"], c["s"], c["d"]), generator=g)
    return tuple(t.to(torch.bfloat16) for t in (q, k, v, w))


def ring_check_rank(dev) -> dict:
    """This rank's ring attention forward and gradients at (c2)'s shape,
    zigzag over the mesh's cp group: out, dq, dk, dv (CPU copies)."""
    import torch

    from neuronx_distributed_tpu_torch.ops.ring_attention import ring_attention, zigzag_indices
    from neuronx_distributed_tpu_torch.parallel import mesh

    q, k, v, w = ring_check_inputs()
    s = q.shape[2]
    idx = zigzag_indices(s, mesh.get_context_parallel_size())
    sl = mesh.context_seq_slice(s)
    qi, ki, vi = (t[:, :, idx][:, :, sl].to(dev).requires_grad_(True) for t in (q, k, v))
    blk = RING_CHECK["block"]
    out = ring_attention(qi, ki, vi, group=mesh.get_context_parallel_group(), layout="zigzag",
                         impl="flash", block_q=blk, block_k=blk)
    grads = torch.autograd.grad(out, (qi, ki, vi), w[:, :, idx][:, :, sl].to(dev))
    return {n: t.detach().cpu() for n, t in zip(("out", "dq", "dk", "dv"), (out, *grads))}


def ring_references(want: list):
    """The CPU side of (c2)'s element rule, per cp rank (``want``: the CPU
    ring's outputs by cp rank, whose out defines delta). ``sizes``: the
    ring rounds each block's result to bf16 before it sums the blocks in
    fp32 and rounds the sum, so each term and the result may sit one last
    place off: the sum over blocks of |term| plus |result|. ``exact``: the
    ring in fp64 from the same bf16 operands, each block by
    ``fwd_exact``/``bwd_exact`` (the twin's roundings inside a block, none
    between blocks), merged and summed unrounded."""
    import math as _math

    import torch

    from neuronx_distributed_tpu_torch.ops.ring_attention import _rank_positions, zigzag_indices

    c = RING_CHECK
    cp, s, blk = CP_CP, c["s"], c["block"]
    s_loc, b, h, hk, d = s // cp, c["b"], c["h"], c["hk"], c["d"]
    sm = 1.0 / _math.sqrt(d)
    q, k, v, w = (t[:, :, zigzag_indices(s, cp)] for t in ring_check_inputs())

    def block(t, r, heads):
        return t[:, :, r * s_loc:(r + 1) * s_loc].reshape(b * heads, s_loc, d).contiguous()

    pos = [_rank_positions(r, cp, s_loc, "zigzag").reshape(1, 1, s_loc) for r in range(cp)]
    args = lambda r, j: (block(q, r, h), block(k, j, hk), block(v, j, hk))  # noqa: E731
    sizes = [dict(out=0.0, dq=0.0, dk=0.0, dv=0.0) for _ in range(cp)]
    exact = [dict(out=0.0, dq=0.0, dk=0.0, dv=0.0) for _ in range(cp)]
    for r in range(cp):
        fwd = [fwd_exact(*args(r, j), pos[r], pos[j], sm, blk, blk, h // hk, h)
               for j in range(cp)]
        lse = torch.logsumexp(torch.stack([lse_j for _, lse_j in fwd]), 0)
        for o_j, lse_j in fwd:
            wgt = torch.exp(lse_j - lse)[..., None]
            sizes[r]["out"] = sizes[r]["out"] + wgt * o_j.abs()
            exact[r]["out"] = exact[r]["out"] + wgt * o_j
        # the backward under the CPU ring's statistics, as the twins run it
        out = want[r]["out"].reshape(b * h, s_loc, d)
        delta = (block(w, r, h).float() * out.float()).sum(-1)
        for j in range(cp):
            grads = bwd_exact(*args(r, j), block(w, r, h), lse.float(), delta, pos[r], pos[j],
                              sm, blk, blk, h // hk, h)
            for n, i, g in (("dq", r, grads[0]), ("dk", j, grads[1]), ("dv", j, grads[2])):
                sizes[i][n] = sizes[i][n] + g.abs()
                exact[i][n] = exact[i][n] + g
    shapes = dict(out=(b, h), dq=(b, h), dk=(b, hk), dv=(b, hk))
    sizes = [{n: (t.reshape(*shapes[n], s_loc, d) + want[r][n].double().abs()).float()
              for n, t in sz.items()} for r, sz in enumerate(sizes)]
    exact = [{n: t.reshape(*shapes[n], s_loc, d) for n, t in ex.items()} for ex in exact]
    return sizes, exact


def ring_check(got: dict, side=None) -> dict:
    """(c2)'s ring op on the card (``got``: a card rank's outputs by its cp
    rank; the ranks are processes: a thread rank's backward would run on
    the one CUDA autograd thread that all threads share) against the same
    op on CPU thread ranks (the kernels' twins), each output element held
    by the kernels phase's rule, against the twin's ring or an fp64
    evaluation, with one last place allowed a rounding
    (:func:`ring_references`)."""
    want, sizes, exact = side or ring_cpu_side()
    return {r: {n: held(got[r][n], want[r][n], RING_FLOORS[n], exact=exact[r][n],
                        size=sizes[r][n]) for n in RING_FLOORS} for r in got}


def ring_cpu_side():
    """The CPU ring's outputs by cp rank and their ``ring_references``: the
    side the ring check and the planted faults are held against."""
    from neuronx_distributed_tpu_torch.parallel import mesh

    want = mesh.run_in_threads(CP_CP, lambda r: ring_check_rank("cpu"),
                               tensor_model_parallel_size=1, context_parallel_size=CP_CP)
    return (want, *ring_references(want))


def ring_faults(want: list) -> dict:
    """Four wrong rings at (c2)'s shape, each by what it would output (the
    twins on the CPU, from the same inputs), to show that the ring check's
    rule fails them: ``dkdv_not_home``, dK/dV left one hop short of home
    (at cp 2 a rank then holds the other rank's); ``wrong_positions``,
    every block folded under the rank's own positions;
    ``positions_off_by_one``, every key a position late (a query loses the
    key at its own position); ``no_lse_weights``, the blocks' outputs
    merged with equal weights instead of their LSEs. Returns ``{fault:
    [{output: tensor} by cp rank]}``."""
    import math as _math

    import torch

    from neuronx_distributed_tpu_torch.kernels.flash_attn import NEG_INF, flash_block_forward
    from neuronx_distributed_tpu_torch.ops.ring_attention import (
        _rank_positions,
        merge_block,
        zigzag_indices,
    )

    c = RING_CHECK
    cp, s, blk = CP_CP, c["s"], c["block"]
    s_loc, b, h, hk, d = s // cp, c["b"], c["h"], c["hk"], c["d"]
    q, k, v, _ = (t[:, :, zigzag_indices(s, cp)] for t in ring_check_inputs())

    def block(t, r, heads):
        return t[:, :, r * s_loc:(r + 1) * s_loc].reshape(b * heads, s_loc, d).contiguous()

    pos = [_rank_positions(r, cp, s_loc, "zigzag").reshape(1, 1, s_loc) for r in range(cp)]

    def out(r, kpos, weigh):
        m = torch.full((b * h, s_loc), NEG_INF)
        se, acc = torch.zeros((b * h, s_loc)), torch.zeros((b * h, s_loc, d))
        for j in ((r - i) % cp for i in range(cp)):
            o_j, lse_j = flash_block_forward(block(q, r, h), block(k, j, hk), block(v, j, hk),
                                             pos[r], kpos(j), 1.0 / _math.sqrt(d), blk, blk,
                                             h // hk, h)
            m, se, acc = merge_block(m, se, acc, o_j, weigh(lse_j))
        return (acc / torch.clamp(se, min=1e-20)[..., None]).to(q.dtype).reshape(b, h, s_loc, d)

    return {
        "dkdv_not_home": [{n: want[(r + 1) % cp][n] for n in ("dk", "dv")} for r in range(cp)],
        "wrong_positions": [{"out": out(r, lambda j, r=r: pos[r], lambda x: x)}
                            for r in range(cp)],
        "positions_off_by_one": [{"out": out(r, lambda j: pos[j] + 1, lambda x: x)}
                                 for r in range(cp)],
        "no_lse_weights": [{"out": out(r, lambda j: pos[j], lambda x: torch.where(
            x > NEG_INF / 2, torch.zeros_like(x), x))} for r in range(cp)]}


def ring_fault_check(side=None) -> dict:
    """Each planted fault (:func:`ring_faults`) held by the ring check's rule
    against the CPU ring (``side``: :func:`ring_cpu_side`): the least floor
    it needs, by output, over the ranks, and whether the rule fails it
    (``caught``)."""
    want, sizes, exact = side or ring_cpu_side()
    out = {}
    for fault, by_rank in ring_faults(want).items():
        need, caught = {}, False
        for r, outs in enumerate(by_rank):
            for n, t in outs.items():
                h = held(t, want[r][n], RING_FLOORS[n], exact=exact[r][n], size=sizes[r][n])
                need[n] = max(need.get(n, 0.0), h["floor_needed"])
                caught = caught or not h["ok"]
        out[fault] = dict(floor_needed=need, caught=caught)
    return out


# B1, B3a and B3b held element by element at the shapes phase 4m's paths give
# them, with fewer rows (rows are independent): (c1)'s ring step, 16 q heads over
# 16 kv heads a rank (group 1) over 16384 local tokens at zigzag positions, taken
# at 2 heads; (p1)'s stage attention, 32 q heads over 4 kv heads a rank (group 8)
# over 4096 tokens, taken at 8 over 1. The kernels phase's rule. The stage keeps
# the kernels phase's floors: on an H100 80GB HBM3 (700 W) it needed out 4.2e-4,
# dq 8.7e-5, dk 7.5e-5, dv 9.1e-5, under every floor and 5 % of every median
# (0.026-0.044). At the ring's shape a row sees up to 16384 keys, so the values
# are about half the training shape's (medians out 0.0085-0.0137, dq
# 0.0049-0.0077, dk 0.0035-0.0098, dv 0.0035-0.0096) and the kernels phase's
# floors exceed 5 % of them; the kernels there needed out 8.1e-5, dq 2.0e-5,
# dk 3.2e-5, dv 2.6e-5 (the seeded inputs and the kernels are deterministic:
# every run reads the same). The ring's floors are about twice that, under 2 %
# of every median; ``PATH_TILE`` plants a fault they must fail: one tile of 64
# keys dropped from the block (the twins' output with those keys invalid).
PATH_RING = dict(h=2, s=CP_SEQ // CP_CP, d=128)
PATH_STAGE = dict(h=8, hk=1, s=PP_SEQ, d=128)
PATH_RING_FLOORS = dict(out=1.6e-4, dq=4e-5, dk=6.5e-5, dv=5.5e-5)
PATH_TILE = 64
# the dispatcher on the card at a per-rank length no default block divides
# (above 1024, not a multiple of 128): causal attention must still launch B1
PATH_ODD_S = 1984


def path_kernel_check(dev, counters) -> dict:
    """B1 and B3a/B3b on the card at the ring's and the stage's shapes
    (``PATH_RING``, ``PATH_STAGE``) against their twins and their fp64
    evaluations, by the kernels phase's element rule and floors. The ring:
    each cp rank's queries against each block, B1 with the block's own
    statistics, then B3a/B3b under the global LSE and delta of the merged
    output, as the ring calls them; rows that see no key of a block and
    keys no query of it sees are held to exact zeros (LSE to the twin's).
    The stage: group 8 under the call's own statistics. Then the ring
    dispatcher at ``PATH_ODD_S`` (one rank): it must launch B1, held
    against the twin tiled at 64. Each case also holds a planted fault,
    the twins with the last ``PATH_TILE`` keys of the block's first half
    made invalid (out and dq), which the rule must fail. Returns the
    readings and a list of problems."""
    import torch

    from neuronx_distributed_tpu_torch.kernels.flash_attn import (
        INVALID_POS,
        flash_block_forward,
        flash_block_forward_plain,
        flash_bwd_dkdv,
        flash_bwd_dkdv_plain,
        flash_bwd_dq,
        flash_bwd_dq_plain,
    )
    from neuronx_distributed_tpu_torch.ops.ring_attention import (
        _rank_positions,
        merge_block,
        ring_attention,
    )

    kernel_floors = dict(out=TOL_FLASH_TRAIN_FLOOR, dq=TOL_DQ_FLOOR, dk=TOL_DK_FLOOR,
                         dv=TOL_DV_FLOOR)
    g = torch.Generator(device=dev).manual_seed(29)
    readings, problems = {}, []

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def floor(case, name):
        return kernel_floors[name] if case == "stage" else PATH_RING_FLOORS[name]

    def hold(case, name, got, want, exact, live):
        """``live``: the rows (positions) that count; the others must be 0."""
        sel = live.reshape(1, -1, 1).expand_as(got)
        r = held(got[sel], want[sel], floor(case, name), exact=exact[sel])
        r["dead_rows"] = int((~live).sum())
        r["dead_rows_zero"] = bool((got[~sel] == 0).all())
        readings.setdefault(case, {})[name] = r
        if not r["ok"] or r["floor"] > FLOOR_SHARE_OF_MEDIAN * r["median_abs_ref"]:
            problems.append(f"{case} {name}: beyond {r['rel']:.3g} * |ref| + {r['floor']:.3g} "
                            f"(needs {r['floor_needed']:.3g}, median |ref| "
                            f"{r['median_abs_ref']:.3g})")
        if not r["dead_rows_zero"]:
            problems.append(f"{case} {name}: a row outside the block's mask is not zero")

    def planted(case, name, wrong, want, live):
        sel = live.reshape(1, -1, 1).expand_as(want)
        r = held(wrong[sel], want[sel], floor(case, name))
        readings[case].setdefault("tile_dropped", {})[name] = r["floor_needed"]
        if r["ok"]:
            problems.append(f"{case} {name}: the rule passes a dropped key tile")

    def dropped(kpos):
        """``kpos`` with the last ``PATH_TILE`` keys of its first half invalid."""
        s_ = kpos.shape[-1]
        kpos = kpos.clone()
        kpos[..., s_ // 2 - PATH_TILE:s_ // 2] = INVALID_POS
        return kpos

    def fwd(case, args, q_live):
        o, lse = flash_block_forward(*args)
        want, want_lse = flash_block_forward_plain(*args)
        hold(case, "out", o, want, fwd_exact(*args)[0], q_live)
        err = float((lse - want_lse).abs().max())
        readings[case]["lse_max_abs_err"] = err
        if err > TOL_LSE:
            problems.append(f"{case} lse: differs from the twin's by {err:.3g}")
        planted(case, "out", flash_block_forward_plain(*args[:4], dropped(args[4]),
                                                       *args[5:])[0], want, q_live)
        return o, lse

    def bwd(case, args, q_live, k_live):
        got = (flash_bwd_dq(*args), *flash_bwd_dkdv(*args))
        want = (flash_bwd_dq_plain(*args), *flash_bwd_dkdv_plain(*args))
        exact = bwd_exact(*args)
        for name, a, w, x, live in zip(("dq", "dk", "dv"), got, want, exact,
                                       (q_live, k_live, k_live)):
            hold(case, name, a, w, x, live)
        planted(case, "dq", flash_bwd_dq_plain(*args[:7], dropped(args[7]), *args[8:]),
                want[0], q_live)

    t0 = time.perf_counter()
    h, s, d = PATH_RING["h"], PATH_RING["s"], PATH_RING["d"]
    sm = d ** -0.5
    pos = [_rank_positions(r, CP_CP, s, "zigzag", dev).reshape(1, 1, s) for r in range(CP_CP)]
    k, v = [rand(h, s, d) for _ in range(CP_CP)], [rand(h, s, d) for _ in range(CP_CP)]
    for r in range(CP_CP):
        q, do = rand(h, s, d), rand(h, s, d)
        m = torch.full((h, s), -1e30, dtype=torch.float32, device=dev)
        se = torch.zeros((h, s), dtype=torch.float32, device=dev)
        acc = torch.zeros((h, s, d), dtype=torch.float32, device=dev)
        order = [(r - i) % CP_CP for i in range(CP_CP)]
        lives = {}
        for j in order:
            mask = pos[j].reshape(1, s) <= pos[r].reshape(s, 1)
            lives[j] = mask.any(1), mask.any(0)
            del mask
            o, lse_j = fwd(f"ring rank {r} block {j}", (q, k[j], v[j], pos[r], pos[j], sm, 64,
                                                         64, 1, h), lives[j][0])
            m, se, acc = merge_block(m, se, acc, o, lse_j)
        out = (acc / se[..., None]).to(q.dtype)
        lse = m + torch.log(se)
        delta = (do.float() * out.float()).sum(-1)
        for j in order:
            bwd(f"ring rank {r} block {j}", (q, k[j], v[j], do, lse, delta, pos[r], pos[j], sm,
                                             64, 64, 1, h), *lives[j])
        del q, do, acc, out
    del k, v
    h, hk, s, d = PATH_STAGE["h"], PATH_STAGE["hk"], PATH_STAGE["s"], PATH_STAGE["d"]
    q, k, v, do = rand(h, s, d), rand(hk, s, d), rand(hk, s, d), rand(h, s, d)
    iota = torch.arange(s, dtype=torch.int32, device=dev).reshape(1, 1, s)
    every = torch.ones(s, dtype=torch.bool, device=dev)
    o, lse = fwd("stage", (q, k, v, iota, iota, d ** -0.5, 64, 64, h // hk, h), every)
    delta = (do.float() * o.float()).sum(-1)
    bwd("stage", (q, k, v, do, lse, delta, iota, iota, d ** -0.5, 64, 64, h // hk, h), every,
        every)
    del q, k, v, do, o
    # the dispatcher: impl=None on CUDA tensors at a length no default block divides
    q, k, v = (rand(1, 2, PATH_ODD_S, 128) for _ in range(3))
    zero_launches(counters)
    got = ring_attention(q, k, v)
    launches = {c.__name__: c.launches for c in counters}
    iota = torch.arange(PATH_ODD_S, dtype=torch.int32, device=dev).reshape(1, 1, PATH_ODD_S)
    args = (q[0], k[0], v[0], iota, iota, 128 ** -0.5, 64, 64, 1, 2)
    r = held(got[0], flash_block_forward_plain(*args)[0], TOL_FLASH_TRAIN_FLOOR,
             exact=fwd_exact(*args)[0])
    readings["dispatch"] = dict(s_loc=PATH_ODD_S, launches=launches, out=r)
    if launches.get("flash_block_forward", 0) != 1:
        problems.append(f"ring_attention at a per-rank length of {PATH_ODD_S} on the card "
                        f"launched B1 {launches.get('flash_block_forward', 0)} times, not once")
    if not r["ok"]:
        problems.append(f"ring_attention at {PATH_ODD_S} differs from the twin beyond "
                        f"{r['rel']:.3g} * |ref| + {r['floor']:.3g} (needs {r['floor_needed']:.3g})")
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    return dict(readings=readings, problems=problems, seconds=time.perf_counter() - t0,
                ring_shape=f"q ({PATH_RING['h']}, {PATH_RING['s']}, {PATH_RING['d']}) over "
                           f"({PATH_RING['h']}, {PATH_RING['s']}, {PATH_RING['d']}) bf16, group "
                           f"1, zigzag at cp {CP_CP}",
                stage_shape=f"q ({PATH_STAGE['h']}, {PATH_STAGE['s']}, {PATH_STAGE['d']}) over "
                            f"({PATH_STAGE['hk']}, {PATH_STAGE['s']}, {PATH_STAGE['d']}) bf16, "
                            f"group {PATH_STAGE['h'] // PATH_STAGE['hk']}, causal")


def pp_args(extra=()) -> list:
    """The TP x PP example's arguments for (p1)/(p2)."""
    return ["--layers", str(PP_LAYERS), "--seq_len", str(PP_SEQ), "--batch_size",
            str(PP_BATCH), "--num_microbatches", str(PP_MB), "--steps", str(PP_STEPS),
            "--lr", str(PP_LR), "--log_every", "0", *extra]


def pp_p0(dev, counters) -> dict:
    """(p0): the example's model on one rank, the forward loss of its first
    training batch (the stream's second: the first is its init sample) from
    its seeded init: the value (p1)'s first step must reach."""
    import torch

    from neuronx_distributed_tpu_torch.examples import llama2_tp_pp as example
    from neuronx_distributed_tpu_torch.examples.common import synthetic_lm_batches
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    args = example.parse_args(pp_args())
    cfg = example.build_config(args, PP_SEQ)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    model.load_state_dict(params, assign=True)
    stream = synthetic_lm_batches(cfg.vocab_size, PP_BATCH, PP_SEQ, seed=args.seed)
    next(stream)
    b = next(stream)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    zero_launches(counters)
    t1 = time.perf_counter()
    with torch.no_grad():
        loss = float(model.loss(torch.as_tensor(b["ids"]).to(dev),
                                torch.as_tensor(b["labels"]).to(dev)))
    torch.cuda.synchronize()
    out = dict(loss=loss, ms=(time.perf_counter() - t1) * 1e3, setup_s=setup_s,
               launches={c.__name__: c.launches for c in counters if c.launches},
               weight_bytes=sum(nbytes(t) for t in params.values()),
               params=sum(t.numel() for t in params.values()),
               peak_bytes=torch.cuda.max_memory_allocated())
    check(math.isfinite(loss), f"pp (p0): non-finite loss {loss}")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pp_small_config():
    """(p3)'s model: the small fp32 model at 4 layers (2 stages x 2 chunks)."""
    return dataclasses.replace(small_config(), num_layers=4)


def pp_small_batches() -> list:
    import numpy as np

    cfg = pp_small_config()
    out = []
    for i in range(CPPP_SMALL_STEPS):
        ids = np.random.RandomState(40 + i).randint(0, cfg.vocab_size,
                                                   (CPPP_SMALL_BATCH, cfg.max_seq_len + 1))
        out.append({"ids": ids[:, :-1].astype(np.int32), "labels": ids[:, 1:].astype(np.int32)})
    return out


def pp_small_trainer(dev, params, chunks: int, stages: int = PP_PP, tp: int = PP_TP):
    """(p3)'s trainer: a ``PipelinedLlama`` stage of the small model (one
    rank: the whole model), 2 microbatches, ZeRO-1, fp32 masters, clip 1.0."""
    from neuronx_distributed_tpu_torch.models.llama_pipeline import PipelinedLlama
    from neuronx_distributed_tpu_torch.trainer import (
        create_train_state,
        initialize_parallel_optimizer,
        make_train_step,
        neuronx_distributed_config,
    )

    nxd = neuronx_distributed_config(
        tensor_parallel_size=tp, pipeline_parallel_size=stages,
        optimizer_config={"zero_one_enabled": True, "grad_clipping": True, "max_grad_norm": 1.0},
        mixed_precision_config={"use_master_weights": True})
    pm = PipelinedLlama(pp_small_config(), num_stages=stages, num_microbatches=2,
                        num_chunks=chunks)
    model = pm.as_parallel_model(device=dev, params=params)
    opt = initialize_parallel_optimizer(nxd, model, learning_rate=CPPP_SMALL_LR,
                                        weight_decay=0.01)
    step = make_train_step(model, opt, lambda p, b, rng: pm.loss(p, b["ids"], b["labels"]))
    return create_train_state(model, opt), step


def pp_small_steps(state, step, batches, dev):
    import torch

    from neuronx_distributed_tpu_torch.parallel import mesh

    out = []
    for b in batches:
        rows = (mesh.data_batch_slice(CPPP_SMALL_BATCH) if mesh.model_parallel_is_initialized()
                else slice(None))
        state, m = step(state, {k: torch.as_tensor(v[rows]).to(dev) for k, v in b.items()})
        out.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"])))
    return state, out


def cppp_child(rank: int, world: int, port: int, out_path: str, ckpt_dir: str,
               dev: str = "cuda:0", cp_layers: int = CP_LAYERS) -> int:
    """One rank of (c1), (c2), (p1), (p2) and (p3), a process of its own on
    ``cuda:0`` over gloo, each part in a process group of its own. (c1):
    the (c0) run through the trainer at CP 2 x TP 2, zigzag; (c2): the
    small fp32 model on that layout, then the ring op alone at
    ``RING_CHECK``; (p1)/(p2): the TP x PP example's ``main`` at TP 2 x PP
    2, 1F1B and then two VPP chunks a stage; (p3): the small fp32 model at
    TP 2 x PP 2, 1F1B and interleaved, a save after step 2 and a fresh
    group resuming step 3. Launch counters and the collective table are
    zeroed just before each run and read just after. Writes every reading
    to ``out_path`` (the ring check's tensors beside it)."""
    import datetime

    import torch
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch.checkpoint import (
        finalize_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )
    from neuronx_distributed_tpu_torch.examples import llama2_tp_pp as example
    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.kernels.flash_attn import (
        flash_block_forward,
        flash_bwd_dkdv,
        flash_bwd_dq,
    )
    from neuronx_distributed_tpu_torch.models.llama import init_params
    from neuronx_distributed_tpu_torch.optimizer.fused_kernel import fused_adamw_leaf
    from neuronx_distributed_tpu_torch.parallel import mappings, mesh

    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    counters = (flash_block_forward, flash_bwd_dkdv, flash_bwd_dq, fused_adamw_leaf)
    timeout = datetime.timedelta(seconds=CPPP_TIMEOUT_S)
    _, total = torch.cuda.mem_get_info()
    res = dict(rank=rank)

    def join(p, **degrees):
        mesh.init_distributed("gloo", rank=rank, world_size=world, local_rank=0,
                              init_method=f"tcp://localhost:{p}", timeout=timeout)
        mesh.initialize_model_parallel(timeout=timeout, **degrees)

    def leave():
        mesh.destroy_model_parallel()
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()

    def readings():
        return dict(launches={c.__name__: c.launches for c in counters},
                    collectives=collective_snapshot(),
                    peak_bytes=torch.cuda.max_memory_allocated())

    def start():
        torch.cuda.reset_peak_memory_stats()
        zero_launches(counters)
        mappings.reset_collective_stats()

    # (c1): Llama-2-7B widths, one 32768-token sequence a step, CP 2 x TP 2
    join(port, tensor_model_parallel_size=CP_TP, context_parallel_size=CP_CP)
    cfg = cp_config(cp_layers)
    model, state, step = cp_trainer(dev, cfg, CP_LR, cp=CP_CP, tp=CP_TP)
    n = sum(p.numel() for p in state.params.values())
    s_loc = CP_SEQ // CP_CP
    # layer inputs kept by remat, one layer's recompute, a loss chunk's logits
    act = (cfg.num_layers * s_loc * cfg.hidden_size * 2 + 3 * s_loc * cfg.intermediate_size
           // CP_TP * 2 + 4096 * cfg.vocab_size // CP_TP * 10)
    res["c1_reckoning"] = reckoning(n, act, total)
    print(f"rank {rank} (c1) reckoning {json.dumps(res['c1_reckoning'])}", flush=True)
    batches = cp_batches(cfg.vocab_size, CP_SEQ, CP_STEPS)
    res["coords_c"] = mesh.local_mesh_coords()
    start()
    t1 = time.perf_counter()
    state, steps = cp_steps(state, step, batches, dev, timed=True)
    res["c1"] = dict(steps=steps, main_s=time.perf_counter() - t1, **readings())
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    # (c2): the small fp32 model on the same layout; then the ring alone
    small = dataclasses.replace(small_config(), cp_layout="zigzag")
    params = init_params(small, torch.Generator().manual_seed(0))
    _, state, step = cp_trainer(dev, small, CPPP_SMALL_LR, cp=CP_CP, tp=CP_TP, params=params)
    state, res["c2"] = cp_steps(state, step, cp_batches(small.vocab_size, small.max_seq_len,
                                                        CPPP_SMALL_STEPS, CPPP_SMALL_BATCH,
                                                        seed=31), dev)
    del state, step
    ring = ring_check_rank(dev)
    if mesh.tensor_model_parallel_rank() == 0:   # the TP ranks of a cp rank run one ring
        torch.save(ring, str(Path(out_path).with_suffix(".ring.pt")))
    res["ring_cp_rank"] = mesh.context_parallel_rank()
    leave()

    # (p1)/(p2): the TP x PP example at Llama-2-70B widths, 1F1B then VPP 2
    for part, extra, p in (("p1", [], port + 1), ("p2", ["--num_chunks", "2"], port + 2)):
        steps, mark, stash = [], {}, {}

        def on_model(pmodel, model, state):
            act = (PP_MB * PP_LAYERS // PP_PP * (PP_BATCH // PP_MB) * PP_SEQ
                   * pmodel.config.hidden_size * 2 + PP_SEQ * pmodel.config.vocab_size // PP_TP
                   * 10)
            res[f"{part}_reckoning"] = reckoning(model.num_params(), act, total)
            res[f"{part}_stage"] = pmodel.stage
            stash["engine"] = pmodel.engine
            print(f"rank {rank} ({part}) reckoning {json.dumps(res[f'{part}_reckoning'])}",
                  flush=True)

        def on_step(i, state, metrics):
            torch.cuda.synchronize()
            now = time.perf_counter()
            steps.append(dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                              ms=(now - mark["t"]) * 1e3, stash_peak=stash["engine"].stash_peak,
                              sends_peak=stash["engine"].sends_peak))
            mark["t"] = time.perf_counter()

        argv = pp_args([*extra, "--tp", str(PP_TP), "--pp", str(PP_PP), "--backend", "gloo",
                        "--device", dev, "--coordinator_address", f"localhost:{p}",
                        "--num_processes", str(world), "--process_id", str(rank)])
        start()
        t1 = mark["t"] = time.perf_counter()
        example.main(argv, on_step=on_step, on_model=on_model)
        res[part] = dict(steps=steps, main_s=time.perf_counter() - t1,
                         coords=mesh.local_mesh_coords(), **readings())
        leave()

    # (p3): the small fp32 model at TP 2 x PP 2, 1F1B and interleaved
    small = pp_small_config()
    params = init_params(small, torch.Generator().manual_seed(0))
    batches = pp_small_batches()
    join(port + 3, tensor_model_parallel_size=PP_TP, pipeline_model_parallel_size=PP_PP)
    state, step = pp_small_trainer(dev, params, 1)
    state, straight = pp_small_steps(state, step, batches, dev)
    want = _digest(state.params)
    state, step = pp_small_trainer(dev, params, 2)
    _, interleaved = pp_small_steps(state, step, batches, dev)
    state, step = pp_small_trainer(dev, params, 1)
    state, head = pp_small_steps(state, step, batches[:2], dev)
    save_checkpoint(ckpt_dir, "step_2", state, user_content={"step": 2}, async_save=True)
    torch.save({"params": {n: t.cpu() for n, t in state.params.items()},
                "layout": {k: (v.global_shape, v.offset) for k, v in state.layout.items()}},
               str(Path(out_path).with_suffix(".params.pt")))
    finalize_checkpoint()
    leave()
    join(port + 4, tensor_model_parallel_size=PP_TP, pipeline_model_parallel_size=PP_PP)
    state, step = pp_small_trainer(dev, params, 1)
    state, content = load_checkpoint(ckpt_dir, target=state, verify=True)
    state, tail = pp_small_steps(state, step, batches[2:], dev)
    res["p3"] = dict(straight=straight, interleaved=interleaved, resumed=head + tail,
                     resumed_step=content["step"],
                     bit_identical=_digest(state.params) == want
                     and [s["loss"] for s in head + tail] == [s["loss"] for s in straight])
    res["wall_s"] = time.perf_counter() - t0
    Path(out_path).write_text(json.dumps(res))
    leave()
    return 0


def cppp_ranks(ckpt_dir: str, tmp: Path, cp_layers: int = CP_LAYERS) -> dict:
    """:func:`cppp_child` as ``CPPP_WORLD`` processes on the one card; the
    card's used memory polled while they run. A rank that fails or
    outlives ``CPPP_CHILD_TIMEOUT_S`` fails the phase (every process is
    stopped)."""
    import torch

    port = _free_port()
    free0, total = torch.cuda.mem_get_info()
    peak_used = total - free0
    logs = [open(tmp / f"cppp{r}.log", "w") for r in range(CPPP_WORLD)]
    cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--cppp-world", str(CPPP_WORLD),
           "--cppp-port", str(port), "--cppp-dir", ckpt_dir, "--cppp-layers", str(cp_layers)]
    # four ranks' caches share the card: segments that grow in place keep
    # each rank's reserve near what it allocates
    env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    procs = [subprocess.Popen(cmd + ["--cppp-rank", str(r), "--cppp-out",
                                     str(tmp / f"cppp{r}.json")],
                              cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT, env=env)
             for r in range(CPPP_WORLD)]
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            if time.perf_counter() - t0 > CPPP_CHILD_TIMEOUT_S:
                raise SmokeFailure(f"cp/pp phase: the ranks ran past {CPPP_CHILD_TIMEOUT_S} s")
            if any(p.poll() not in (None, 0) for p in procs):
                break   # one rank failed: its peers fail at the group's timeout
            free, _ = torch.cuda.mem_get_info()
            peak_used = max(peak_used, total - free)
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            tail = (tmp / f"cppp{r}.log").read_text()[-3000:]
            raise SmokeFailure(f"cp/pp phase: rank {r} exited {p.returncode}:\n{tail}")
    ranks = [json.loads((tmp / f"cppp{r}.json").read_text()) for r in range(CPPP_WORLD)]
    return dict(ranks=ranks, wall_s=wall, card_peak_used_bytes=peak_used, card_bytes=total)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def cppp_gates(c0: dict, p0: dict, ranks: list) -> list:
    """(c1), (p1) and (p2)'s hard gates, as a list of problems; records the
    largest relative loss differences in ``c0``/``p0``."""
    bad = []
    c_worst = p_worst = v_worst = 0.0
    want_c = [s["loss"] for s in c0["steps"]]
    for rk in ranks:
        r = rk["rank"]
        for part, n in (("c1", CP_STEPS), ("p1", PP_STEPS), ("p2", PP_STEPS)):
            got = [s["loss"] for s in rk[part]["steps"]]
            if len(got) != n:
                bad.append(f"rank {r} ran {len(got)} {part} steps")
            elif got != [s["loss"] for s in ranks[0][part]["steps"]]:
                bad.append(f"rank {r}: {part} losses differ from rank 0's")
            for name in CPPP_COUNTERS:
                if rk[part]["launches"].get(name, 0) <= 0:
                    bad.append(f"rank {r} never launched {name} in ({part})")
        for a, b in zip((s["loss"] for s in rk["c1"]["steps"]), want_c):
            c_worst = max(c_worst, _rel(a, b))
        if rk["p1"]["steps"]:
            p_worst = max(p_worst, _rel(rk["p1"]["steps"][0]["loss"], p0["loss"]))
        for a, b in zip(rk["p2"]["steps"], rk["p1"]["steps"]):
            v_worst = max(v_worst, _rel(a["loss"], b["loss"]))
        if rk["c1"]["collectives"].get("send", [0, 0])[0] <= 0:
            bad.append(f"rank {r}: (c1) sent nothing round the ring")
        # 1F1B's bound (with VPP chunks the stash counts chunk units: not gated)
        stage = rk["p1_stage"]
        if any(s["stash_peak"] > PP_PP - stage for s in rk["p1"]["steps"]):
            bad.append(f"rank {r} (p1): stashed more than pp - stage microbatches")
        if any(s["sends_peak"] > PP_PP - stage for s in rk["p1"]["steps"]):
            bad.append(f"rank {r} (p1): held more than pp - stage sends")
    c0["c1_loss_max_rel_diff"], p0["p1_loss_rel_diff"] = c_worst, p_worst
    p0["p2_vs_p1_loss_max_rel_diff"] = v_worst
    for what, worst in (("(c1) losses differ from (c0)'s", c_worst),
                        ("(p1)'s step-1 loss differs from (p0)'s", p_worst),
                        ("(p2) losses differ from (p1)'s", v_worst)):
        if worst > CPPP_LOSS_RTOL:
            bad.append(f"{what} by {worst:.3g} relative (limit {CPPP_LOSS_RTOL})")
    return bad


def cppp_small_reference(ckpt_dir: str, tmp: Path, ranks: list) -> dict:
    """(c2) and (p3)'s CPU side: one CPU rank trained on the same weights
    and batches, the (p3) tag loaded at TP1 x PP1 on one rank against the
    ranks' step-2 params, and a flipped byte in one rank's piece."""
    import shutil

    import torch

    from neuronx_distributed_tpu_torch.checkpoint import CheckpointIntegrityError, load_checkpoint
    from neuronx_distributed_tpu_torch.models.llama import init_params

    small = dataclasses.replace(small_config(), cp_layout="zigzag")
    _, state, step = cp_trainer("cpu", small, CPPP_SMALL_LR,
                                params=init_params(small, torch.Generator().manual_seed(0)))
    _, c2_cpu = cp_steps(state, step, cp_batches(small.vocab_size, small.max_seq_len,
                                                 CPPP_SMALL_STEPS, CPPP_SMALL_BATCH, seed=31),
                         "cpu")
    params = init_params(pp_small_config(), torch.Generator().manual_seed(0))
    state, step = pp_small_trainer("cpu", params, 1, stages=1, tp=1)
    _, p3_cpu = pp_small_steps(state, step, pp_small_batches(), "cpu")

    def err(key, cpu):
        return max(max(abs(a["loss"] - c["loss"]), abs(a["grad_norm"] - c["grad_norm"]))
                   for rk in ranks for a, c in zip(key(rk), cpu))

    target, _ = pp_small_trainer("cpu", params, 1, stages=1, tp=1)
    whole, content = load_checkpoint(ckpt_dir, target=target, verify=True)
    gathered = {n: torch.empty_like(t) for n, t in whole.params.items()}
    covered = set()
    for r in range(CPPP_WORLD):
        part = torch.load(str(tmp / f"cppp{r}.params.pt"))
        for n, t in part["params"].items():
            _, off = part["layout"][f".params['{n}']"]
            gathered[n][tuple(slice(o, o + s) for o, s in zip(off, t.shape))] = t
            covered.add(n)
    equal = covered == set(gathered) and all(torch.equal(gathered[n], whole.params[n])
                                             for n in gathered)
    bad = tmp / "flipped"
    shutil.copytree(ckpt_dir, bad)
    piece = bad / "step_2" / "state" / "tensors.rank00003.safetensors"
    blob = bytearray(piece.read_bytes())
    blob[-7] ^= 0x20
    piece.write_bytes(bytes(blob))
    try:
        load_checkpoint(str(bad), verify=True)
        caught = False
    except CheckpointIntegrityError:
        caught = True
    return dict(c2_cpu=c2_cpu, p3_cpu=p3_cpu,
                c2_max_abs_err=err(lambda rk: rk["c2"], c2_cpu),
                p3_max_abs_err=err(lambda rk: rk["p3"]["straight"], p3_cpu),
                p3_interleaved_max_abs_err=err(lambda rk: rk["p3"]["interleaved"], p3_cpu),
                tp1_pp1_equals_gathered=equal, flipped_byte_caught=caught,
                resumed_from=content["step"])


def run_cp_pp_phase(dev, counters, cp_layers: int = CP_LAYERS, dump=None) -> dict:
    """Phase 4m: (c0) and (p0) in this process, the four rank processes,
    then their CPU sides and ``measure_cp_ratio``; every gate. ``dump``: a
    path the readings are written to before the gates are held."""
    import torch

    from neuronx_distributed_tpu_torch.utils.cp_microbench import measure_cp_ratio

    t0 = time.perf_counter()
    c0 = cp_c0(dev, counters, cp_layers)
    p0 = pp_p0(dev, counters)
    paths = path_kernel_check(dev, counters)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        ckpt = str(tmp / "ckpt")
        kids = cppp_ranks(ckpt, tmp, cp_layers)
        small = cppp_small_reference(ckpt, tmp, kids["ranks"])
        side = ring_cpu_side()
        ring = ring_check({rk["ring_cp_rank"]: torch.load(str(tmp / f"cppp{rk['rank']}.ring.pt"))
                           for rk in kids["ranks"]
                           if (tmp / f"cppp{rk['rank']}.ring.pt").exists()}, side)
        faults = ring_fault_check(side)
        del side
    ratio = measure_cp_ratio(CP_SEQ, cp=CP_CP, heads=32, head_dim=128, tp=CP_TP, device=dev)
    problems = cppp_gates(c0, p0, kids["ranks"]) + paths["problems"]
    out = dict(c0=c0, p0=p0, ranks=kids["ranks"], ring=ring, ring_faults=faults,
               paths=paths, small=small, cp_ratio=ratio,
               ranks_wall_s=kids["wall_s"], card_peak_used_bytes=kids["card_peak_used_bytes"],
               card_bytes=kids["card_bytes"])
    if dump is not None:
        Path(dump).parent.mkdir(parents=True, exist_ok=True)
        Path(dump).write_text(json.dumps({**out, "problems": problems}, default=str))
    for r, names in ring.items():
        for n, h in names.items():
            if not h["ok"] or h["floor"] > FLOOR_SHARE_OF_MEDIAN * h["median_abs_ref"]:
                problems.append(f"(c2) rank {r}: the ring's {n} differs from the CPU ring's "
                                f"beyond {h['rel']:.3g} * |ref| + {h['floor']:.3g} (needs "
                                f"{h['floor_needed']:.3g}, median |ref| {h['median_abs_ref']:.3g})")
    for fault, f in faults.items():
        if not f["caught"]:
            problems.append(f"(c2): the ring check's rule passes a planted fault, {fault} "
                            f"(needs {json.dumps(f['floor_needed'])})")
    for key in ("c2_max_abs_err", "p3_max_abs_err", "p3_interleaved_max_abs_err"):
        if small[key] > CPPP_SMALL_TOL:
            problems.append(f"{key} {small[key]:.3g} above {CPPP_SMALL_TOL}")
    for rk in kids["ranks"]:
        if not rk["p3"]["bit_identical"]:
            problems.append(f"(p3) rank {rk['rank']}: the resumed step 3 is not bit-identical")
    for key in ("tp1_pp1_equals_gathered", "flipped_byte_caught"):
        if not small[key]:
            problems.append(f"(p3): {key} failed")
    check(not problems, "cp/pp phase: " + "; ".join(problems))
    gc.collect()
    torch.cuda.empty_cache()
    return dict(out, phase_s=time.perf_counter() - t0)


def print_cp_pp(st: dict, card: str) -> None:
    c0, p0 = st["c0"], st["p0"]

    def steps_text(steps):
        return ", ".join(f"{s['loss']:.5f}/{s['grad_norm']:.4f}"
                         + (f" {s['ms']:.0f} ms" if s.get("ms") else "") for s in steps)

    print(f"cp (c0): llama2_7b widths, {c0['layers']} of 32 layers, one rank, 1 x {CP_SEQ} "
          f"tokens a step, bf16 + fp32 masters, remat full; loss/grad norm/step "
          f"{steps_text(c0['steps'])}; {c0['params']} params, peak {c0['peak_bytes']} bytes, "
          f"set-up {c0['setup_s']:.1f} s, launches {json.dumps(c0['launches'])} [{card}]",
          flush=True)
    print(f"pp (p0): llama2_70b widths, {PP_LAYERS} of 80 layers, one rank, forward loss of "
          f"{PP_BATCH} x {PP_SEQ} tokens {p0['loss']:.5f} in {p0['ms']:.0f} ms; weight bytes "
          f"{p0['weight_bytes']}, peak {p0['peak_bytes']} bytes, launches "
          f"{json.dumps(p0['launches'])} [{card}]", flush=True)
    for rk in st["ranks"]:
        c = rk["c1"]
        coll = {k: f"{v[0]} calls {v[1]} bytes" for k, v in sorted(c["collectives"].items())}
        print(f"cp (c1) rank {rk['rank']} ({json.dumps(rk['coords_c'])}): CP {CP_CP} x TP "
              f"{CP_TP} zigzag over gloo; loss/grad norm/step {steps_text(c['steps'])}; peak "
              f"{c['peak_bytes']} bytes (reckoned {rk['c1_reckoning']['planned_bytes']}), "
              f"launches {json.dumps(c['launches'])}, collectives {json.dumps(coll)} [{card}]",
              flush=True)
    for part in ("p1", "p2"):
        for rk in st["ranks"]:
            p = rk[part]
            coll = {k: f"{v[0]} calls {v[1]} bytes" for k, v in sorted(p["collectives"].items())}
            print(f"pp ({part}) rank {rk['rank']} (stage {rk[f'{part}_stage']}, tp "
                  f"{p['coords']['tp']}): the TP x PP example, TP {PP_TP} x PP {PP_PP}"
                  f"{', 2 VPP chunks' if part == 'p2' else ', 1F1B'}, {PP_MB} microbatches; "
                  f"loss/grad norm/step {steps_text(p['steps'])}; stash peak "
                  f"{[s['stash_peak'] for s in p['steps']]}, sends held peak "
                  f"{[s['sends_peak'] for s in p['steps']]}; {rk[f'{part}_reckoning']['params']} "
                  f"params, peak {p['peak_bytes']} bytes (reckoned "
                  f"{rk[f'{part}_reckoning']['planned_bytes']}), launches "
                  f"{json.dumps(p['launches'])}, collectives {json.dumps(coll)} [{card}]",
                  flush=True)
    print(f"cp/pp: (c1) losses within {c0['c1_loss_max_rel_diff']:.3g} of (c0)'s, (p1)'s step 1 "
          f"within {p0['p1_loss_rel_diff']:.3g} of (p0), (p2) within "
          f"{p0['p2_vs_p1_loss_max_rel_diff']:.3g} of (p1) (limit {CPPP_LOSS_RTOL}); "
          f"{CPPP_WORLD} processes in {st['ranks_wall_s']:.1f} s, card peak used "
          f"{st['card_peak_used_bytes']} of {st['card_bytes']} bytes [{card}]", flush=True)
    sm = st["small"]
    worst = {r: {n: f"{h['max_abs_err']:.3g} (floor needed {h['floor_needed']:.3g} of "
                    f"{h['floor']:.3g})" for n, h in names.items()}
             for r, names in st["ring"].items()}
    print(f"cp (c2): small fp32 model CP {CP_CP} x TP {CP_TP} on the card vs one CPU rank: max "
          f"|loss or grad norm diff| {sm['c2_max_abs_err']:.3g} (tol {CPPP_SMALL_TOL}); the ring "
          f"at {json.dumps(RING_CHECK)} bf16 zigzag vs the CPU ring {json.dumps(worst)} "
          f"[{card}]", flush=True)
    print(f"cp (c2): planted ring faults under the same rule, floor needed and caught "
          f"{json.dumps(st['ring_faults'])} [{card}]", flush=True)
    pk = st["paths"]
    need = {case: {**{n: f"{r[n]['floor_needed']:.3g} of {r[n]['floor']:.3g} (median |ref| "
                         f"{r[n]['median_abs_ref']:.3g})" for n in ("out", "dq", "dk", "dv")},
                   "tile dropped": {n: f"{x:.3g}" for n, x in r["tile_dropped"].items()}}
            for case, r in pk["readings"].items() if case != "dispatch"}
    dp = pk["readings"]["dispatch"]
    print(f"cp/pp kernels at the paths' shapes, kernel vs twin or fp64 (ring {pk['ring_shape']}; "
          f"stage {pk['stage_shape']}): floor needed {json.dumps(need)}; dispatcher at a "
          f"per-rank {PATH_ODD_S}: launches {json.dumps(dp['launches'])}, out vs the twin needs "
          f"{dp['out']['floor_needed']:.3g} of {dp['out']['floor']:.3g}; {pk['seconds']:.1f} s "
          f"[{card}]", flush=True)
    print(f"pp (p3): small fp32 model TP {PP_TP} x PP {PP_PP} vs one CPU rank: 1F1B "
          f"{sm['p3_max_abs_err']:.3g}, interleaved {sm['p3_interleaved_max_abs_err']:.3g} (tol "
          f"{CPPP_SMALL_TOL}); async save after step 2, a fresh group resumed step 3 bit for bit; "
          f"the tag at TP1 x PP1 equals the gathered params {sm['tp1_pp1_equals_gathered']}; "
          f"flipped byte caught {sm['flipped_byte_caught']}; phase {st['phase_s']:.1f} s "
          f"[{card}]", flush=True)
    r = st["cp_ratio"]
    print(f"cp ratio: measure_cp_ratio at seq {r['seq']}, cp {r['cp']}: SP rank (32/{r['tp']} "
          f"heads over {r['seq']}) {r['sp_rank_ms']:.3f} ms, CP rank (32 heads over "
          f"{r['seq'] // r['cp']}, zigzag ring steps) {r['cp_rank_ms']:.3f} ms, "
          f"cp_vs_sp_throughput {r['cp_vs_sp_throughput']:.4f} ({r['note']}) [{card}]",
          flush=True)


# --- phase 4n: Mixtral training with expert parallelism ----------------------------------

MOE_WORLD, MOE_TP, MOE_EP = 4, 2, 2   # (m1): TP 2 x EP 2 (dp 2, edp 1), four processes
MOE_LAYERS = 1                        # mixtral_8x7b depth 32 -> 1 (2 cut to 1: the run time)
MOE_SEQ, MOE_BATCH, MOE_STEPS, MOE_LR = 4096, 2, 2, 1e-4   # 3 steps cut to 2: the run time
MOE_LOSS_RTOL = 1e-2                  # (m1) vs (m0), bf16
MOE_SMALL_TOL = 1e-5                  # (m2): card ranks vs one CPU rank, fp32
MOE_SMALL_BATCH, MOE_SMALL_SEQ, MOE_SMALL_STEPS, MOE_SMALL_LR = 4, 128, 3, 1e-3
MOE_SMALL_CF = 1.0                    # (m2)'s capacity factor: tokens drop
# (m2)'s layouts: name -> (tp, ep); the first saves and resumes, the second
# also takes the small DBRX model's step
MOE_SMALL_LAYOUTS = {"tp2_ep2": (2, 2), "ep2_edp2": (1, 2)}
MOE_TIMEOUT_S = 300                   # every group's timeout
MOE_CHILD_TIMEOUT_S = 900             # the parent's wait for the ranks
MOE_COUNTERS = DIST_COUNTERS


def moe_args(layers: int, extra=()) -> list:
    """The ``mixtral_moe`` example's arguments for (m0) and (m1)."""
    return ["--layers", str(layers), "--seq_len", str(MOE_SEQ), "--batch_size",
            str(MOE_BATCH), "--steps", str(MOE_STEPS), "--lr", str(MOE_LR), "--log_every", "0",
            *extra]


def moe_dropped(module) -> list:
    """Each MoE block's dropped assignments an expert (global counts) in
    its last capacity-factor forward."""
    return [layer.moe.experts.last_dropped.tolist() for layer in module.model.layers]


def moe_activation_bytes(cfg, tokens: int, tp: int = 1, ep: int = 1, dp: int = 1) -> int:
    """A rank's activations under remat: each layer's bf16 input, one
    layer's MoE recompute (the gate, up and product of its slots, a slot
    buffer each way, the chosen rows and their outputs) and a loss chunk's
    fp32 logits with their gradient."""
    h, e, k = cfg.hidden_size, cfg.num_experts, cfg.top_k
    cap = min(int(cfg.capacity_factor * tokens * dp / e), tokens)
    slots = e // ep * cap * ep
    return (cfg.num_layers * tokens * h * 2 + 3 * slots * cfg.intermediate_size // tp * 2
            + 2 * e * cap * h * 2 + 2 * tokens * k * h * 2
            + min(tokens, 4096) * cfg.vocab_size // tp * 10)


def moe_m0(dev, counters, layers=MOE_LAYERS) -> dict:
    """(m0): the example's model and batches on one rank through the
    trainer, remat ``"full"`` (ZeRO off: one rank); counters zeroed just
    before the steps, read just after; each step's dropped assignments."""
    import torch

    from neuronx_distributed_tpu_torch.examples import mixtral_moe as example
    from neuronx_distributed_tpu_torch.examples.common import synthetic_lm_batches, to_device
    from neuronx_distributed_tpu_torch.models.mixtral import MixtralForCausalLM, mixtral_loss
    from neuronx_distributed_tpu_torch.trainer import (
        create_train_state,
        initialize_parallel_model,
        initialize_parallel_optimizer,
        make_train_step,
        neuronx_distributed_config,
    )

    torch.cuda.reset_peak_memory_stats()
    _, total = torch.cuda.mem_get_info()
    t0 = time.perf_counter()
    args = example.parse_args(moe_args(layers))
    cfg = dataclasses.replace(example.build_config(args, MOE_SEQ), remat_policy="full")
    nxd = neuronx_distributed_config(
        optimizer_config={"zero_one_enabled": False, "grad_clipping": True, "max_grad_norm": 1.0},
        mixed_precision_config={"use_master_weights": True})
    model = initialize_parallel_model(nxd, lambda: MixtralForCausalLM(cfg), device=dev)
    opt = initialize_parallel_optimizer(nxd, model, learning_rate=MOE_LR,
                                        weight_decay=args.weight_decay)
    state = create_train_state(model, opt)
    plan = reckoning(model.num_params(), moe_activation_bytes(cfg, MOE_BATCH * MOE_SEQ), total)
    print(f"moe (m0) reckoning {json.dumps(plan)}", flush=True)

    def loss_fn(p, b, rng):
        model.bind(p)
        return mixtral_loss(model.module, b["ids"], b["labels"])

    step = make_train_step(model, opt, loss_fn)
    batches = synthetic_lm_batches(cfg.vocab_size, MOE_BATCH, MOE_SEQ, seed=args.seed)
    next(batches)   # the example's init sample
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    zero_launches(counters)
    steps = []
    for _ in range(MOE_STEPS):
        batch = to_device(next(batches), dev)
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        steps.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                          ms=(time.perf_counter() - t) * 1e3,
                          dropped=moe_dropped(model.module)))
    experts = model.module.model.layers[0].moe.experts
    out = dict(layers=cfg.num_layers, steps=steps, setup_s=setup_s, reckoning=plan,
               launches={c.__name__: c.launches for c in counters},
               capacity=experts.capacity(MOE_BATCH * MOE_SEQ),
               peak_bytes=torch.cuda.max_memory_allocated())
    check(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]) for s in steps),
          f"moe (m0): non-finite loss or grad norm {steps}")
    del model, opt, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_small_config():
    """(m2)'s small fp32 Mixtral: the small model's widths, 4 experts, top
    2, a capacity that drops tokens."""
    from neuronx_distributed_tpu_torch.models.mixtral import MixtralConfig

    base = {f.name: getattr(small_config(), f.name)
            for f in dataclasses.fields(small_config()) if f.init}
    return MixtralConfig(**{**base, "num_experts": 4, "top_k": 2,
                            "capacity_factor": MOE_SMALL_CF})


def moe_dbrx_config():
    """The small DBRX model: bias-free LayerNorms, ``qkv_clip`` 8, top-4 of
    8 experts, at the small model's widths."""
    import torch

    from neuronx_distributed_tpu_torch.models.mixtral import dbrx

    s = small_config()
    return dbrx(vocab_size=s.vocab_size, hidden_size=s.hidden_size,
                intermediate_size=s.intermediate_size, num_layers=s.num_layers,
                num_heads=s.num_heads, num_kv_heads=s.num_kv_heads, max_seq_len=s.max_seq_len,
                num_experts=8, top_k=4, capacity_factor=MOE_SMALL_CF, dtype=torch.float32,
                param_dtype=torch.float32)


def moe_small_batches(vocab: int) -> list:
    """(m2)'s global batches, numpy (the same on every rank and the CPU)."""
    import numpy as np

    out = []
    for i in range(MOE_SMALL_STEPS):
        ids = np.random.RandomState(50 + i).randint(0, vocab, (MOE_SMALL_BATCH, MOE_SMALL_SEQ + 1))
        out.append({"ids": ids[:, :-1].astype(np.int32), "labels": ids[:, 1:].astype(np.int32)})
    return out


def moe_small_trainer(dev, cfg, params=None, lr: float = MOE_SMALL_LR):
    """(m2)'s trainer (and (v1)'s) at this rank's layout (one rank
    off-mesh) from the global ``params`` (None: drawn from the seed): the
    mesh's TP, EP and CP degrees, ZeRO-1, fp32 masters, clipping 1.0,
    ``mixtral_loss``."""
    from neuronx_distributed_tpu_torch.models.mixtral import MixtralForCausalLM, mixtral_loss
    from neuronx_distributed_tpu_torch.parallel import mesh
    from neuronx_distributed_tpu_torch.trainer import (
        create_train_state,
        initialize_parallel_model,
        initialize_parallel_optimizer,
        make_train_step,
        neuronx_distributed_config,
    )

    on = mesh.model_parallel_is_initialized()
    nxd = neuronx_distributed_config(
        tensor_parallel_size=mesh.get_tensor_model_parallel_size() if on else 1,
        expert_parallel_size=mesh.get_expert_model_parallel_size() if on else 1,
        context_parallel_size=mesh.get_context_parallel_size() if on else 1,
        optimizer_config={"zero_one_enabled": True, "grad_clipping": True, "max_grad_norm": 1.0},
        mixed_precision_config={"use_master_weights": True})
    model = initialize_parallel_model(nxd, lambda: MixtralForCausalLM(cfg), device=dev,
                                      params=params)
    opt = initialize_parallel_optimizer(nxd, model, learning_rate=lr, weight_decay=0.01)

    def loss_fn(p, b, rng):
        model.bind(p)
        return mixtral_loss(model.module, b["ids"], b["labels"])

    return create_train_state(model, opt), make_train_step(model, opt, loss_fn), model


def moe_small_steps(state, step, model, batches, dev, counters=(), timed=False):
    """Each step on this rank's rows and block of the sequence
    (``cp_rank_batch``: zigzag under CP; one rank: the whole batch in the
    natural order): loss, grad norm, dropped assignments, and with
    ``timed`` the ms (the counters zeroed first)."""
    import torch

    zero_launches(counters)
    out = []
    for b in batches:
        t = time.perf_counter()
        state, m = step(state, cp_rank_batch(b, dev))
        if timed:
            torch.cuda.synchronize()
        out.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                        dropped=moe_dropped(model.module)))
        if timed:
            out[-1]["ms"] = (time.perf_counter() - t) * 1e3
    return state, out


def moe_child(rank: int, world: int, port: int, out_path: str, ckpt_dir: str,
              layers: int = MOE_LAYERS, dev: str = "cuda:0") -> int:
    """One rank of (m1) and (m2), a process of its own on ``cuda:0`` over
    gloo, each part in a process group of its own. (m1): the ``mixtral_moe``
    example's ``main`` at TP 2 x EP 2 with hooks that print the rank's
    memory reckoning before the first step and read each step's loss, grad
    norm, time and dropped assignments; launch counters and the collective
    table zeroed just before ``main`` and read just after. (m2): the small
    fp32 Mixtral at each of ``MOE_SMALL_LAYOUTS``, 3 steps; at TP 2 x EP 2 a
    fresh state trains 2 steps and saves, and a fresh group resumes step
    3; at EP 2 x edp 2 the small DBRX model's step. Writes every reading to
    ``out_path``."""
    import datetime

    import torch
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch.checkpoint import (
        finalize_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )
    from neuronx_distributed_tpu_torch.examples import mixtral_moe as example
    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.kernels.flash_attn import (
        flash_block_forward,
        flash_bwd_dkdv,
        flash_bwd_dq,
    )
    from neuronx_distributed_tpu_torch.models.llama import init_params
    from neuronx_distributed_tpu_torch.models.mixtral import MixtralForCausalLM
    from neuronx_distributed_tpu_torch.optimizer.fused_kernel import fused_adamw_leaf
    from neuronx_distributed_tpu_torch.parallel import mappings, mesh

    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    counters = (flash_block_forward, flash_bwd_dkdv, flash_bwd_dq, fused_adamw_leaf)
    timeout = datetime.timedelta(seconds=MOE_TIMEOUT_S)
    _, total = torch.cuda.mem_get_info()
    res = dict(rank=rank)

    def join(p, tp, ep):
        mesh.init_distributed("gloo", rank=rank, world_size=world, local_rank=0,
                              init_method=f"tcp://localhost:{p}", timeout=timeout)
        mesh.initialize_model_parallel(tp, expert_model_parallel_size=ep, timeout=timeout)

    def leave():
        mesh.destroy_model_parallel()
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()

    # (m1): the example at mixtral_8x7b widths, TP 2 x EP 2
    steps, mark, stash = [], {}, {}

    def on_model(model, state):
        cfg = model.module.config
        tp, ep = mesh.get_tensor_model_parallel_size(), mesh.get_expert_model_parallel_size()
        dp = mesh.get_data_parallel_size()
        act = moe_activation_bytes(cfg, MOE_BATCH * MOE_SEQ // dp, tp, ep, dp)
        res["m1_reckoning"] = reckoning(model.num_params(), act, total)
        res["coords"] = mesh.local_mesh_coords()
        stash["module"] = model.module
        print(f"rank {rank} (m1) reckoning {json.dumps(res['m1_reckoning'])}", flush=True)
        torch.cuda.synchronize()
        mark["t"] = time.perf_counter()

    def on_step(i, state, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        steps.append(dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                          ms=(now - mark["t"]) * 1e3, dropped=moe_dropped(stash["module"])))
        mark["t"] = time.perf_counter()

    argv = moe_args(layers, ["--tp", str(MOE_TP), "--ep", str(MOE_EP), "--backend", "gloo",
                             "--device", dev, "--coordinator_address", f"localhost:{port}",
                             "--num_processes", str(world), "--process_id", str(rank)])
    torch.cuda.reset_peak_memory_stats()
    zero_launches(counters)
    mappings.reset_collective_stats()
    t1 = time.perf_counter()
    example.main(argv, on_step=on_step, on_model=on_model)
    res["m1"] = dict(steps=steps, launches={c.__name__: c.launches for c in counters},
                     collectives=collective_snapshot(),
                     peak_bytes=torch.cuda.max_memory_allocated(),
                     main_s=time.perf_counter() - t1)
    stash.clear()
    leave()

    # (m2): the small fp32 Mixtral, tokens dropping, at each layout
    small = moe_small_config()
    params = init_params(small, torch.Generator().manual_seed(0), model_cls=MixtralForCausalLM)
    batches = moe_small_batches(small.vocab_size)
    res["m2"] = {}
    p = port + 1
    for name, (tp, ep) in MOE_SMALL_LAYOUTS.items():
        join(p, tp, ep)
        p += 1
        state, step, model = moe_small_trainer(dev, small, params)
        state, straight = moe_small_steps(state, step, model, batches, dev)
        entry = dict(straight=straight, coords=mesh.local_mesh_coords())
        if name == "tp2_ep2":
            want = _digest(state.params)
            state, step, model = moe_small_trainer(dev, small, params)
            state, head = moe_small_steps(state, step, model, batches[:2], dev)
            save_checkpoint(ckpt_dir, "step_2", state, user_content={"step": 2},
                            async_save=True)
            torch.save({"params": {n: t.cpu() for n, t in state.params.items()},
                        "layout": {k: (v.global_shape, v.offset)
                                   for k, v in state.layout.items()}},
                       str(Path(out_path).with_suffix(".params.pt")))
            finalize_checkpoint()
            leave()
            join(p, tp, ep)   # a fresh group resumes
            p += 1
            state, step, model = moe_small_trainer(dev, small, params)
            state, content = load_checkpoint(ckpt_dir, target=state, verify=True)
            state, tail = moe_small_steps(state, step, model, batches[2:], dev)
            entry.update(resumed=head + tail, resumed_step=content["step"],
                         bit_identical=_digest(state.params) == want
                         and [s["loss"] for s in head + tail] == [s["loss"] for s in straight])
        else:
            cfg = moe_dbrx_config()
            state, step, model = moe_small_trainer(dev, cfg, init_params(
                cfg, torch.Generator().manual_seed(1), model_cls=MixtralForCausalLM))
            _, entry["dbrx"] = moe_small_steps(state, step, model, batches[:1], dev)
        del state, step, model
        res["m2"][name] = entry
        leave()
    # phase 4r's (v1): Mixtral at CP 2 x EP 2 on a group of its own
    res["v1"] = mcp_rank_cell(rank, world, p, dev, counters, timeout)
    res["wall_s"] = time.perf_counter() - t0
    Path(out_path).write_text(json.dumps(res))
    return 0


def moe_ranks(ckpt_dir: str, tmp: Path, layers: int = MOE_LAYERS) -> dict:
    """:func:`moe_child` as ``MOE_WORLD`` processes on the one card; the
    card's used memory polled while they run. A rank that fails or
    outlives ``MOE_CHILD_TIMEOUT_S`` fails the phase (every process is
    stopped)."""
    import torch

    port = _free_port()
    free0, total = torch.cuda.mem_get_info()
    peak_used = total - free0
    logs = [open(tmp / f"moe{r}.log", "w") for r in range(MOE_WORLD)]
    cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--moe-world", str(MOE_WORLD),
           "--moe-port", str(port), "--moe-dir", ckpt_dir, "--moe-layers", str(layers)]
    # four ranks' caches share the card: segments that grow in place keep
    # each rank's reserve near what it allocates
    env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    procs = [subprocess.Popen(cmd + ["--moe-rank", str(r), "--moe-out",
                                     str(tmp / f"moe{r}.json")],
                              cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT, env=env)
             for r in range(MOE_WORLD)]
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            if time.perf_counter() - t0 > MOE_CHILD_TIMEOUT_S:
                raise SmokeFailure(f"moe phase: the ranks ran past {MOE_CHILD_TIMEOUT_S} s")
            if any(p.poll() not in (None, 0) for p in procs):
                break   # one rank failed: its peers fail at the group's timeout
            free, _ = torch.cuda.mem_get_info()
            peak_used = max(peak_used, total - free)
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            tail = (tmp / f"moe{r}.log").read_text()[-3000:]
            raise SmokeFailure(f"moe phase: rank {r} exited {p.returncode}:\n{tail}")
    ranks = [json.loads((tmp / f"moe{r}.json").read_text()) for r in range(MOE_WORLD)]
    return dict(ranks=ranks, wall_s=wall, card_peak_used_bytes=peak_used, card_bytes=total)


def moe_gates(m0: dict, ranks: list) -> list:
    """(m1)'s hard gates against (m0), as a list of problems; records the
    largest relative loss difference in ``m0``."""
    bad = []
    worst = 0.0
    want = [s["loss"] for s in m0["steps"]]
    for rk in ranks:
        r, m1 = rk["rank"], rk["m1"]
        got = [s["loss"] for s in m1["steps"]]
        if len(got) != MOE_STEPS:
            bad.append(f"rank {r} ran {len(got)} (m1) steps")
        elif got != [s["loss"] for s in ranks[0]["m1"]["steps"]]:
            bad.append(f"rank {r}: (m1) losses differ from rank 0's")
        for a, b in zip(got, want):
            worst = max(worst, _rel(a, b))
        for name in MOE_COUNTERS:
            if m1["launches"].get(name, 0) <= 0:
                bad.append(f"rank {r} never launched {name} in (m1)")
        if m1["collectives"].get("all_to_all", [0, 0])[0] <= 0:
            bad.append(f"rank {r}: (m1) sent no token through the expert all-to-all")
    m0["m1_loss_max_rel_diff"] = worst
    if worst > MOE_LOSS_RTOL:
        bad.append(f"(m1) losses differ from (m0)'s by {worst:.3g} relative (limit "
                   f"{MOE_LOSS_RTOL})")
    return bad


def moe_small_reference(ckpt_dir: str, tmp: Path, ranks: list) -> dict:
    """(m2)'s CPU side: one CPU rank trained on the same weights and
    batches (and the DBRX model's step), the tag loaded at TP1 x EP1 on one
    rank against the ranks' gathered step-2 params, and a flipped byte in
    one rank's piece."""
    import shutil

    import torch

    from neuronx_distributed_tpu_torch.checkpoint import CheckpointIntegrityError, load_checkpoint
    from neuronx_distributed_tpu_torch.models.llama import init_params
    from neuronx_distributed_tpu_torch.models.mixtral import MixtralForCausalLM

    small = moe_small_config()
    params = init_params(small, torch.Generator().manual_seed(0), model_cls=MixtralForCausalLM)
    batches = moe_small_batches(small.vocab_size)
    state, step, model = moe_small_trainer("cpu", small, params)
    _, cpu = moe_small_steps(state, step, model, batches, "cpu")
    cfg = moe_dbrx_config()
    state, step, model = moe_small_trainer("cpu", cfg, init_params(
        cfg, torch.Generator().manual_seed(1), model_cls=MixtralForCausalLM))
    _, dbrx_cpu = moe_small_steps(state, step, model, batches[:1], "cpu")

    def err(got, want):
        return max(max(abs(a["loss"] - c["loss"]), abs(a["grad_norm"] - c["grad_norm"]))
                   for a, c in zip(got, want))

    out = dict(cpu=cpu, dbrx_cpu=dbrx_cpu, max_abs_err={}, dropped_equal={})
    for name in MOE_SMALL_LAYOUTS:
        out["max_abs_err"][name] = max(err(rk["m2"][name]["straight"], cpu) for rk in ranks)
        out["dropped_equal"][name] = all(
            [s["dropped"] for s in rk["m2"][name]["straight"]] == [s["dropped"] for s in cpu]
            for rk in ranks)
    with_dbrx = [rk["m2"][n]["dbrx"] for rk in ranks for n in MOE_SMALL_LAYOUTS
                 if "dbrx" in rk["m2"][n]]
    out["dbrx_max_abs_err"] = max(err(d, dbrx_cpu) for d in with_dbrx)
    out["dbrx_dropped_equal"] = all([s["dropped"] for s in d] == [s["dropped"] for s in dbrx_cpu]
                                    for d in with_dbrx)
    target, _, _ = moe_small_trainer("cpu", small, params)
    whole, content = load_checkpoint(ckpt_dir, target=target, verify=True)
    gathered = {n: torch.empty_like(t) for n, t in whole.params.items()}
    covered = set()
    for r in range(MOE_WORLD):
        part = torch.load(str(tmp / f"moe{r}.params.pt"))
        for n, t in part["params"].items():
            _, off = part["layout"][f".params['{n}']"]
            gathered[n][tuple(slice(o, o + s) for o, s in zip(off, t.shape))] = t
            covered.add(n)
    out["tp1_ep1_equals_gathered"] = covered == set(gathered) and all(
        torch.equal(gathered[n], whole.params[n]) for n in gathered)
    out["resumed_from"] = content["step"]
    bad = tmp / "moe_flipped"
    shutil.copytree(ckpt_dir, bad)
    piece = bad / "step_2" / "state" / "tensors.rank00003.safetensors"
    blob = bytearray(piece.read_bytes())
    blob[-7] ^= 0x20
    piece.write_bytes(bytes(blob))
    try:
        load_checkpoint(str(bad), verify=True)
        out["flipped_byte_caught"] = False
    except CheckpointIntegrityError:
        out["flipped_byte_caught"] = True
    return out


def moe_small_problems(small: dict, ranks: list) -> list:
    """(m2)'s hard gates, as a list of problems."""
    bad = []
    for name in MOE_SMALL_LAYOUTS:
        if small["max_abs_err"][name] > MOE_SMALL_TOL:
            bad.append(f"(m2) {name}: losses or grad norms differ from the CPU rank's by "
                       f"{small['max_abs_err'][name]:.3g} (limit {MOE_SMALL_TOL})")
        if not small["dropped_equal"][name]:
            bad.append(f"(m2) {name}: dropped assignments differ from the CPU rank's")
    if small["dbrx_max_abs_err"] > MOE_SMALL_TOL:
        bad.append(f"(m2) DBRX: the step differs from the CPU rank's by "
                   f"{small['dbrx_max_abs_err']:.3g} (limit {MOE_SMALL_TOL})")
    if not small["dbrx_dropped_equal"]:
        bad.append("(m2) DBRX: dropped assignments differ from the CPU rank's")
    for rk in ranks:
        if not rk["m2"]["tp2_ep2"]["bit_identical"]:
            bad.append(f"(m2) rank {rk['rank']}: the resumed step 3 is not bit-identical")
    for key in ("tp1_ep1_equals_gathered", "flipped_byte_caught"):
        if not small[key]:
            bad.append(f"(m2): {key} failed")
    return bad


def run_moe_phase(dev, counters, layers: int = MOE_LAYERS, dump=None) -> dict:
    """Phase 4n: (m0) in this process, the four rank processes ((m1),
    (m2)), then (m2)'s CPU side; every gate. ``dump``: a path the readings
    are written to before the gates are held."""
    import torch

    t0 = time.perf_counter()
    m0 = moe_m0(dev, counters, layers)
    v1_ref = mcp_reference(dev, counters)   # phase 4r's (v1), gated there
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        ckpt = str(tmp / "ckpt")
        kids = moe_ranks(ckpt, tmp, layers)
        small = moe_small_reference(ckpt, tmp, kids["ranks"])
    t1 = time.perf_counter()
    v1_small_cpu = mcp_small_run("cpu")
    problems = moe_gates(m0, kids["ranks"]) + moe_small_problems(small, kids["ranks"])
    out = dict(m0=m0, ranks=kids["ranks"], small=small, ranks_wall_s=kids["wall_s"],
               card_peak_used_bytes=kids["card_peak_used_bytes"], card_bytes=kids["card_bytes"],
               v1_ref=v1_ref, v1_small_cpu=v1_small_cpu,
               v1_small_cpu_s=time.perf_counter() - t1)
    if dump is not None:
        Path(dump).parent.mkdir(parents=True, exist_ok=True)
        Path(dump).write_text(json.dumps({**out, "problems": problems}, default=str))
    check(not problems, "moe phase: " + "; ".join(problems))
    gc.collect()
    torch.cuda.empty_cache()
    return dict(out, phase_s=time.perf_counter() - t0)


def print_moe(st: dict, card: str) -> None:
    m0 = st["m0"]

    def steps_text(steps):
        return ", ".join(f"{s['loss']:.5f}/{s['grad_norm']:.4f}"
                         + (f" {s['ms']:.0f} ms" if s.get("ms") else "") for s in steps)

    print(f"moe (m0): mixtral_8x7b widths, {m0['layers']} of 32 layers, one rank, {MOE_BATCH} x "
          f"{MOE_SEQ} tokens a step, bf16 + fp32 masters, remat full, capacity "
          f"{m0['capacity']} slots an expert; loss/grad norm/step {steps_text(m0['steps'])}; "
          f"dropped a layer and expert {[s['dropped'] for s in m0['steps']]}; "
          f"{m0['reckoning']['params']} params, peak {m0['peak_bytes']} bytes (reckoned "
          f"{m0['reckoning']['planned_bytes']}), set-up {m0['setup_s']:.1f} s, launches "
          f"{json.dumps(m0['launches'])} [{card}]", flush=True)
    for rk in st["ranks"]:
        m1 = rk["m1"]
        per_step = {k: f"{v[0] / MOE_STEPS:g} calls {v[1] / MOE_STEPS:.0f} bytes"
                    for k, v in sorted(m1["collectives"].items())}
        print(f"moe (m1) rank {rk['rank']} ({json.dumps(rk['coords'])}): the mixtral_moe "
              f"example, TP {MOE_TP} x EP {MOE_EP} over gloo, ZeRO-1, remat attention; "
              f"loss/grad norm/step {steps_text(m1['steps'])}; dropped "
              f"{[s['dropped'] for s in m1['steps']]}; {rk['m1_reckoning']['params']} params, "
              f"peak {m1['peak_bytes']} bytes (reckoned {rk['m1_reckoning']['planned_bytes']}), "
              f"launches {json.dumps(m1['launches'])}, collectives a step {json.dumps(per_step)}, "
              f"main {m1['main_s']:.1f} s [{card}]", flush=True)
    print(f"moe (m1): losses within {m0['m1_loss_max_rel_diff']:.3g} of (m0)'s (limit "
          f"{MOE_LOSS_RTOL}); {MOE_WORLD} processes in {st['ranks_wall_s']:.1f} s with (m2), "
          f"card peak used {st['card_peak_used_bytes']} of {st['card_bytes']} bytes [{card}]",
          flush=True)
    sm = st["small"]
    print(f"moe (m2): small fp32 Mixtral (capacity factor {MOE_SMALL_CF}, tokens dropping) on "
          f"the card vs one CPU rank: max |loss or grad norm diff| "
          f"{json.dumps({n: f'{v:.3g}' for n, v in sm['max_abs_err'].items()})} (tol "
          f"{MOE_SMALL_TOL}), dropped equal {json.dumps(sm['dropped_equal'])} (CPU "
          f"{[s['dropped'] for s in sm['cpu']]}); DBRX step {sm['dbrx_max_abs_err']:.3g}, "
          f"dropped equal {sm['dbrx_dropped_equal']}; async save after step 2 at TP 2 x EP 2, a "
          f"fresh group resumed step 3 bit for bit; the tag at TP1 x EP1 equals the gathered "
          f"params {sm['tp1_ep1_equals_gathered']}; flipped byte caught "
          f"{sm['flipped_byte_caught']}; phase {st['phase_s']:.1f} s [{card}]", flush=True)


# --- phase 4r: LoRA under TP, the MoE block under CP, multi-LoRA on Mixtral --------------
#
# (v0) rides phase 4l's rank processes and (v1) phase 4n's: each joins a
# group of its own after the phase's cells. (v2) runs in this process.

LTP_LORA = dict(r=16, lora_alpha=32.0, lora_dropout=0.05,
                target_modules=("qkv", "o_proj", "gate_proj", "up_proj", "down_proj", "embed"))
LTP_RTOL = 1e-3                 # (v0) losses and grad norms, ranks vs one rank, bf16 (on the
                                # card 9.6e-7 and 1.2e-5; a skipped update or a gradient summed
                                # twice moves a grad norm far more)
MCP_CP, MCP_EP = 2, 2           # (v1): CP 2 x EP 2 (dp 2, edp 1), four processes
MCP_SEQ, MCP_BATCH = 8192, 2    # each rank 4096 tokens: the longest measured to fit four
                                # ranks (16384 asked); a rank's peak is mostly its 1.0 B params
                                # with fp32 masters
MCP_STEPS, MCP_LR, MCP_CF = 2, 1e-4, 1.0
MCP_RTOL = 1e-3                 # (v1) losses and grad norms, ranks vs one rank, bf16 (on the
                                # card 1.2e-5 and 1.2e-5)
MCP_SMALL_TOL = 1e-5            # (v1 small) card ranks vs one CPU rank, fp32
MCP_SMALL_STEPS = 2             # (v1 small): (m2)'s model and first batches
MLORA_LAYERS = 8                # (v2) mixtral_8x7b depth 32 -> 8 (bf16 weights 23.8 GB)
MLORA_ADAPTERS, MLORA_RANK, MLORA_SLOTS = 3, 16, 4
MLORA_SERVE = ["serve", "--model", "mixtral", "--paged", "--paged-kernel", "--max_batch", "8",
               "--num_requests", "16", "--prompt_len", "256", "--max_new_tokens", "32",
               "--shared_prefix_len", "64"]
MLORA_POOL = ["--adapters", str(MLORA_ADAPTERS), "--adapter_rank", str(MLORA_RANK),
              "--adapter_pool_slots", str(MLORA_SLOTS)]
MLORA_SLOT0 = dict(requests=4, prompt=96, new=16)   # the slot-0 streams' workload
MLORA_LAYER_TOL = 1e-4          # (v2) a small fp32 Mixtral layer, pooled vs merged


def ltp_trainer(dev, tp: int):
    """(v0)'s trainer through its entry points: Llama-2-7B widths at
    ``DIST_LAYERS`` (the Llama-2 example's config), the seeded base frozen,
    ``LTP_LORA`` adapters, ZeRO-1, fp32 masters, clipping 1.0."""
    from neuronx_distributed_tpu_torch.examples import llama2_tp_zero1 as example
    from neuronx_distributed_tpu_torch.lora import LoraConfig
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM
    from neuronx_distributed_tpu_torch.trainer import (
        create_train_state,
        initialize_parallel_model,
        initialize_parallel_optimizer,
        make_train_step,
        neuronx_distributed_config,
    )

    cfg = example.build_config(example.parse_args(dist_args(DIST_LAYERS)), DIST_SEQ)
    cfg = dataclasses.replace(cfg, sequence_parallel=tp > 1)
    nxd = neuronx_distributed_config(
        tensor_parallel_size=tp, lora_config=LoraConfig(**LTP_LORA),
        optimizer_config={"zero_one_enabled": True, "grad_clipping": True, "max_grad_norm": 1.0},
        mixed_precision_config={"use_master_weights": True})
    model = initialize_parallel_model(nxd, lambda: LlamaForCausalLM(cfg), device=dev)
    opt = initialize_parallel_optimizer(nxd, model, learning_rate=DIST_LR, weight_decay=0.0)
    step = make_train_step(model, opt, lambda p, b, rng: model.apply(
        p, b["ids"], b["labels"], method="loss"))
    return model, create_train_state(model, opt), step


def ltp_steps(model, state, step, dev, counters) -> dict:
    """(v0)'s 2 steps on the seeded stream, each rank on its rows: the
    counters zeroed just before and read just after; each step's loss,
    grad norm, ms and the adapters' digests (all of them, and the
    TP-replicated ones); the base's digest before and after."""
    import torch

    from neuronx_distributed_tpu_torch.examples.common import synthetic_lm_batches
    from neuronx_distributed_tpu_torch.parallel import mesh

    on = mesh.model_parallel_is_initialized()
    stream = synthetic_lm_batches(model.module.config.vocab_size, DIST_BATCH, DIST_SEQ, seed=0)
    rows = mesh.data_batch_slice(DIST_BATCH) if on else slice(None)
    batches = [{k: torch.as_tensor(v[rows]).to(dev) for k, v in next(stream).items()}
               for _ in range(DIST_STEPS)]
    whole = [n for n, s in model.trainable_specs.items() if "tp" not in s]
    base, digest0 = _digest(model.params), _digest(state.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(counters)
    steps = []
    for b in batches:
        t = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        steps.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                          ms=(time.perf_counter() - t) * 1e3, digest=_digest(state.params),
                          whole_digest=_digest({n: state.params[n] for n in whole})))
    return dict(steps=steps, launches={c.__name__: c.launches for c in counters},
                digest0=digest0, base_unchanged=_digest(model.params) == base,
                whole_leaves=len(whole),
                adapter_leaves=len(state.params), state_leaves=len(state.opt_state.mu),
                peak_bytes=torch.cuda.max_memory_allocated())


def ltp_reference(dev, counters) -> dict:
    """(v0)'s one-rank run, the seeds of the ranks' (the same global base,
    adapters and dropout masks)."""
    import torch

    t0 = time.perf_counter()
    model, state, step = ltp_trainer(dev, 1)
    out = ltp_steps(model, state, step, dev, counters)
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(out, wall_s=time.perf_counter() - t0)


def ltp_rank_cell(rank: int, world: int, port: int, dev, counters, timeout) -> dict:
    """(v0) in a rank process of phase 4l: a group of its own at TP 2 x DP
    2, the trainer, 2 steps."""
    import torch
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    mesh.init_distributed("gloo", rank=rank, world_size=world, local_rank=0,
                          init_method=f"tcp://localhost:{port}", timeout=timeout)
    mesh.initialize_model_parallel(DIST_TP, timeout=timeout)
    model, state, step = ltp_trainer(dev, DIST_TP)
    out = ltp_steps(model, state, step, dev, counters)
    out.update(coords=mesh.local_mesh_coords(), wall_s=time.perf_counter() - t0)
    del model, state, step
    mesh.destroy_model_parallel()
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def trajectory_rel(ref: dict, ranks: list, cell: str) -> tuple:
    """The largest relative differences of any rank's losses and grad norms
    from the one-rank run's, step by step; recorded on ``ref``."""
    loss = norm = 0.0
    for rk in ranks:
        for a, b in zip(rk[cell]["steps"], ref["steps"]):
            loss = max(loss, _rel(a["loss"], b["loss"]))
            norm = max(norm, _rel(a["grad_norm"], b["grad_norm"]))
    ref["ranks_loss_max_rel_diff"], ref["ranks_grad_norm_max_rel_diff"] = loss, norm
    return loss, norm


def ltp_gates(ref: dict, ranks: list) -> list:
    """(v0)'s gates: each step's loss and grad norm within ``LTP_RTOL`` of
    the one-rank run's, every step moving the adapters, the base unchanged,
    the adapters equal across the DP replicas and the TP-replicated ones
    across every rank, the optimizer state the adapters' only,
    B1/B3a/B3b/B4 launched on every rank."""
    bad = []
    for rk in ranks:
        v0 = rk["v0"]
        if len(v0["steps"]) != DIST_STEPS:
            bad.append(f"(v0) rank {rk['rank']} ran {len(v0['steps'])} steps")
        digests = [v0["digest0"]] + [s["digest"] for s in v0["steps"]]
        for i in range(1, len(digests)):
            if digests[i] == digests[i - 1]:
                bad.append(f"(v0) rank {rk['rank']}: step {i} left the adapters unchanged")
        if not v0["base_unchanged"]:
            bad.append(f"(v0) rank {rk['rank']}: the frozen base changed")
        if v0["state_leaves"] != v0["adapter_leaves"]:
            bad.append(f"(v0) rank {rk['rank']}: optimizer state for {v0['state_leaves']} "
                       f"leaves, {v0['adapter_leaves']} adapters")
        for name in DIST_COUNTERS:
            if v0["launches"].get(name, 0) <= 0:
                bad.append(f"(v0) rank {rk['rank']} never launched {name}")
    loss, norm = trajectory_rel(ref, ranks, "v0")
    if max(loss, norm) > LTP_RTOL:
        bad.append(f"(v0) losses and grad norms differ from the one-rank run's by {loss:.3g} "
                   f"and {norm:.3g} relative (limit {LTP_RTOL})")
    for i in range(DIST_STEPS):
        by_tp = {}
        for rk in ranks:
            by_tp.setdefault(rk["v0"]["coords"]["tp"], set()).add(rk["v0"]["steps"][i]["digest"])
        if any(len(v) != 1 for v in by_tp.values()):
            bad.append(f"(v0) step {i + 1}: the DP replicas' adapters differ {by_tp}")
        whole = {rk["v0"]["steps"][i]["whole_digest"] for rk in ranks}
        if len(whole) != 1:
            bad.append(f"(v0) step {i + 1}: the TP-replicated adapters differ {whole}")
    return bad


def mcp_config(layers: int = MOE_LAYERS, seq: int = MCP_SEQ):
    """(v1)'s model: the ``mixtral_moe`` example's Mixtral-8x7B widths at
    ``layers``, capacity factor ``MCP_CF``, remat ``"full"``, zigzag."""
    from neuronx_distributed_tpu_torch.examples import mixtral_moe as example

    cfg = example.build_config(example.parse_args(moe_args(layers)), seq)
    return dataclasses.replace(cfg, capacity_factor=MCP_CF, remat_policy="full",
                               cp_layout="zigzag")


def mcp_small_config():
    """(v1 small): (m2)'s small fp32 Mixtral, zigzag under CP."""
    return dataclasses.replace(moe_small_config(), cp_layout="zigzag")


def zigzag_moe_hooks(module, seq: int, cp: int) -> list:
    """On one rank, feed each MoE block its tokens in the zigzag order of
    ``cp`` ranks (and take its output back): the global program the
    permuted ids give, whose drop order is the permuted one (attention and
    the loss do not depend on the order). Returns the hook handles."""
    from neuronx_distributed_tpu_torch.moe import MoE
    from neuronx_distributed_tpu_torch.ops.ring_attention import zigzag_indices

    perm = zigzag_indices(seq, cp)
    inv = perm.argsort()
    handles = []
    for m in module.modules():
        if isinstance(m, MoE):
            handles.append(m.register_forward_pre_hook(
                lambda mod, args: (args[0][:, perm.to(args[0].device)],) + tuple(args[1:])))
            handles.append(m.register_forward_hook(
                lambda mod, args, out: out[:, inv.to(out.device)]))
    return handles


def mcp_reference(dev, counters) -> dict:
    """(v1)'s one-rank run: the same seeded weights and batches, the MoE
    blocks fed the zigzag order."""
    import torch

    t0 = time.perf_counter()
    cfg = mcp_config()
    state, step, model = moe_small_trainer(dev, cfg, lr=MCP_LR)
    zigzag_moe_hooks(model.module, MCP_SEQ, MCP_CP)
    batches = cp_batches(cfg.vocab_size, MCP_SEQ, MCP_STEPS, batch=MCP_BATCH)
    torch.cuda.reset_peak_memory_stats()
    state, steps = moe_small_steps(state, step, model, batches, dev, counters, timed=True)
    out = dict(steps=steps, launches={c.__name__: c.launches for c in counters},
               capacity=model.module.model.layers[0].moe.experts.capacity(MCP_BATCH * MCP_SEQ),
               peak_bytes=torch.cuda.max_memory_allocated(), wall_s=time.perf_counter() - t0)
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mcp_small_run(dev) -> list:
    """(v1 small) at this rank's layout (one rank: hooked, natural order)."""
    import torch

    from neuronx_distributed_tpu_torch.models.llama import init_params
    from neuronx_distributed_tpu_torch.models.mixtral import MixtralForCausalLM
    from neuronx_distributed_tpu_torch.parallel import mesh

    small = mcp_small_config()
    params = init_params(small, torch.Generator().manual_seed(0), model_cls=MixtralForCausalLM)
    state, step, model = moe_small_trainer(dev, small, params)
    if not mesh.model_parallel_is_initialized():
        zigzag_moe_hooks(model.module, MOE_SMALL_SEQ, MCP_CP)
    batches = moe_small_batches(small.vocab_size)[:MCP_SMALL_STEPS]
    return moe_small_steps(state, step, model, batches, dev)[1]


def mcp_rank_cell(rank: int, world: int, port: int, dev, counters, timeout) -> dict:
    """(v1) in a rank process of phase 4n: a group of its own at CP 2 x EP
    2, the Mixtral-8x7B cell, then (v1 small) on the same group."""
    import torch
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch.parallel import mappings, mesh

    t0 = time.perf_counter()
    mesh.init_distributed("gloo", rank=rank, world_size=world, local_rank=0,
                          init_method=f"tcp://localhost:{port}", timeout=timeout)
    mesh.initialize_model_parallel(1, expert_model_parallel_size=MCP_EP,
                                   context_parallel_size=MCP_CP, timeout=timeout)
    cfg = mcp_config()
    state, step, model = moe_small_trainer(dev, cfg, lr=MCP_LR)
    batches = cp_batches(cfg.vocab_size, MCP_SEQ, MCP_STEPS, batch=MCP_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mappings.reset_collective_stats()
    state, steps = moe_small_steps(state, step, model, batches, dev, counters, timed=True)
    out = dict(steps=steps, launches={c.__name__: c.launches for c in counters},
               collectives=collective_snapshot(), peak_bytes=torch.cuda.max_memory_allocated(),
               coords=mesh.local_mesh_coords())
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    out["small"] = mcp_small_run(dev)
    out["wall_s"] = time.perf_counter() - t0
    mesh.destroy_model_parallel()
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mcp_gates(ref: dict, small_cpu: list, ranks: list) -> list:
    """(v1)'s gates: each step's loss and grad norm within ``MCP_RTOL`` of
    the one-rank run's and the same on every rank; B1, B3a, B3b and B4
    launched and the expert all-to-all issued on every rank; (v1 small):
    losses and grad norms within ``MCP_SMALL_TOL`` of the CPU rank's, the
    dropped assignments a layer and expert equal."""
    bad = []
    small_err = 0.0
    for rk in ranks:
        v1 = rk["v1"]
        if len(v1["steps"]) != MCP_STEPS:
            bad.append(f"(v1) rank {rk['rank']} ran {len(v1['steps'])} steps")
        elif [s["loss"] for s in v1["steps"]] != [s["loss"] for s in ranks[0]["v1"]["steps"]]:
            bad.append(f"(v1) rank {rk['rank']}: losses differ from rank 0's")
        for name in DIST_COUNTERS:
            if v1["launches"].get(name, 0) <= 0:
                bad.append(f"(v1) rank {rk['rank']} never launched {name}")
        if v1["collectives"].get("all_to_all", [0, 0])[0] <= 0:
            bad.append(f"(v1) rank {rk['rank']} sent no token through the expert all-to-all")
        for a, c in zip(v1["small"], small_cpu):
            small_err = max(small_err, abs(a["loss"] - c["loss"]),
                            abs(a["grad_norm"] - c["grad_norm"]))
        if [s["dropped"] for s in v1["small"]] != [s["dropped"] for s in small_cpu]:
            bad.append(f"(v1 small) rank {rk['rank']}: dropped assignments differ from the CPU "
                       f"rank's")
    ref["small_max_abs_err"] = small_err
    loss, norm = trajectory_rel(ref, ranks, "v1")
    if max(loss, norm) > MCP_RTOL:
        bad.append(f"(v1) losses and grad norms differ from the one-rank run's by {loss:.3g} "
                   f"and {norm:.3g} relative (limit {MCP_RTOL})")
    if small_err > MCP_SMALL_TOL:
        bad.append(f"(v1 small) losses or grad norms differ from the CPU rank's by "
                   f"{small_err:.3g} (limit {MCP_SMALL_TOL})")
    if not any(sum(map(sum, s["dropped"])) for s in small_cpu):
        bad.append("(v1 small) no token dropped: the case tests no drop order")
    return bad


def mlora_config(layers: int = MLORA_LAYERS):
    """(v2)'s model: the runner's Mixtral-8x7B preset in bf16, cut in depth."""
    runner = ep_runner()
    return dataclasses.replace(runner.build_config(runner.parse_args(
        ["serve", "--model", "mixtral"])), num_layers=layers)


def mlora_slot0_streams(lm, dev) -> dict:
    """Greedy streams of ``MLORA_SLOT0`` requests with no adapter (slot 0),
    served by a ``ServeEngine`` over ``lm``."""
    import numpy as np

    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine

    rs = np.random.RandomState(17)
    engine = ServeEngine(lm, block_steps=8, seed=0)
    for _ in range(MLORA_SLOT0["requests"]):
        engine.submit(rs.randint(1, lm.config.vocab_size, (MLORA_SLOT0["prompt"],)),
                      MLORA_SLOT0["new"])
    done = {c.request_id: c.tokens.tolist() for c in engine.run()}
    engine.close()
    return done


def mlora_layer_check(dev) -> dict:
    """(v2 layer): :func:`pooled_layer_readings` for one small fp32 Mixtral
    decoder layer (capacity 8: nothing drops)."""
    from neuronx_distributed_tpu_torch.models.mixtral import MixtralDecoderLayer

    c = dataclasses.replace(moe_small_config(), num_layers=1, use_flash_attention=False,
                            capacity_factor=8.0, lora_rank=16, lora_slots=2, decode=False)
    return dict(pooled_layer_readings(c, MixtralDecoderLayer, dev), tolerance=MLORA_LAYER_TOL)


def mlora_cell(dev, counters) -> dict:
    """(v2): ``runner.py serve --model mixtral --adapters 3 --paged`` at
    Mixtral-8x7B widths cut to ``MLORA_LAYERS`` layers (seeded bf16 weights
    through ``main``'s ``params=``/``config=`` seam), and the same serve
    without the pool; each ``CausalLM`` the runner built then serves
    ``MLORA_SLOT0`` requests on slot 0; the small fp32 layer check."""
    import torch

    from neuronx_distributed_tpu_torch.models.llama import init_params
    from neuronx_distributed_tpu_torch.models.mixtral import MixtralForCausalLM

    t0 = time.perf_counter()
    cfg = mlora_config()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                         model_cls=MixtralForCausalLM)
    out = dict(layers=cfg.num_layers, weight_bytes=ep_weight_bytes(params)["total"])
    streams = {}
    for name, extra in (("pool", MLORA_POOL), ("plain", [])):
        with _Recorded() as rec:
            out[name] = ep_run(MLORA_SERVE + extra, dev, counters, params=params, config=cfg)
            zero_launches(counters)
            streams[name] = mlora_slot0_streams(rec.built[0], dev)
            out[name]["pool_slots"] = (rec.built[0].model.model.lora_pool.shape[0]
                                       if rec.built[0].lora else 0)
            rec.built.clear()
        _free(dev)
    out["slot0_bit_identical"] = streams["pool"] == streams["plain"]
    out["slot0_tokens"] = sum(len(v) for v in streams["pool"].values())
    del params
    _free(dev)
    out["layer"] = mlora_layer_check(dev)
    out["wall_s"] = time.perf_counter() - t0
    return out


def mlora_gates(v2: dict) -> list:
    bad = []
    rep = v2["pool"]["report"]
    n = int(MLORA_SERVE[MLORA_SERVE.index("--num_requests") + 1])
    for name in ("pool", "plain"):
        if v2[name]["report"].get("requests_completed") != n:
            bad.append(f"(v2 {name}): {v2[name]['report'].get('requests_completed')} of {n} "
                       f"requests completed")
        for c in ("flash_block_forward", "paged_decode_attention"):
            if v2[name]["launches"].get(c, 0) <= 0:
                bad.append(f"(v2 {name}) never launched {c}")
    if rep.get("adapter_loads", 0) <= 0 or rep.get("adapter_hits", 0) <= 0:
        bad.append(f"(v2): adapter loads {rep.get('adapter_loads')}, hits "
                   f"{rep.get('adapter_hits')}")
    if v2["pool"]["pool_slots"] != MLORA_SLOTS:
        bad.append(f"(v2): the pool holds {v2['pool']['pool_slots']} slots")
    if not v2["slot0_bit_identical"]:
        bad.append("(v2): slot-0 streams differ from the engine without a pool")
    lay = v2["layer"]
    if lay["max_abs_err"] > MLORA_LAYER_TOL:
        bad.append(f"(v2 layer): pooled vs merged max |err| {lay['max_abs_err']:.3g} "
                   f"(limit {MLORA_LAYER_TOL})")
    if not lay["base_bit_identical"]:
        bad.append("(v2 layer): slot-0 rows differ from the layer without LoRA")
    if lay["targets"] != ["o_proj", "qkv"]:
        bad.append(f"(v2 layer): the pool holds {lay['targets']}")
    return bad


def run_lora_moe_phase(dev, counters, dist=None, moe=None, dump=None) -> dict:
    """Phase 4r: (v0)'s and (v1)'s gates on what phases 4l and 4n's ranks
    read (``dist``/``moe``: those phases' results, their references made
    there; None: that cell is not run), then (v2) here; every gate."""
    import torch

    t0 = time.perf_counter()
    v2 = mlora_cell(dev, counters)
    out, problems = dict(v2=v2), mlora_gates(v2)
    wall = {}
    if dist is not None:
        problems += ltp_gates(dist["v0_ref"], dist["d1"]["ranks"])
        out.update(v0_ref=dist["v0_ref"], v0=[rk["v0"] for rk in dist["d1"]["ranks"]])
        # the reference in this process, the ranks' cells in theirs
        wall.update(v0_reference=dist["v0_ref"]["wall_s"],
                    v0_ranks=max(rk["v0"]["wall_s"] for rk in dist["d1"]["ranks"]))
    if moe is not None:
        problems += mcp_gates(moe["v1_ref"], moe["v1_small_cpu"], moe["ranks"])
        out.update(v1_ref=moe["v1_ref"], v1=[rk["v1"] for rk in moe["ranks"]],
                   v1_small_cpu=moe["v1_small_cpu"])
        wall.update(v1_reference=moe["v1_ref"]["wall_s"] + moe["v1_small_cpu_s"],
                    v1_ranks=max(rk["v1"]["wall_s"] for rk in moe["ranks"]))
    if dump is not None:
        Path(dump).parent.mkdir(parents=True, exist_ok=True)
        Path(dump).write_text(json.dumps({**out, "problems": problems}, default=str))
    check(not problems, "lora/moe phase: " + "; ".join(problems))
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = dict(wall, v2=time.perf_counter() - t0)
    return out


def lora_moe_launches_by_path(st: dict) -> dict:
    """Phase 4r's launch counts by path, for the kernel table."""
    out = {"mixtral_lora_v2_pool": st["v2"]["pool"]["launches"],
           "mixtral_lora_v2_plain": st["v2"]["plain"]["launches"]}
    for cell, ref, ranks in (("lora_v0", "v0_ref", "v0"), ("moe_v1", "v1_ref", "v1")):
        if ref in st:
            out[f"{cell}_reference"] = st[ref]["launches"]
            out.update({f"{cell}_rank{r}": v["launches"] for r, v in enumerate(st[ranks])})
    return out


def print_lora_moe(st: dict, card: str) -> None:
    def steps_text(steps):
        return ", ".join(f"{s['loss']:.5f}/{s['grad_norm']:.4f} {s['ms']:.0f} ms"
                         for s in steps)

    if "v0_ref" in st:
        print_lora_tp(st, card, steps_text)
    if "v1_ref" in st:
        print_moe_cp(st, card, steps_text)
    print_mixtral_lora(st["v2"], card)
    print(f"lora/moe phases: wall s {json.dumps({k: round(v, 1) for k, v in st['wall_s'].items()})}"
          f" [{card}]", flush=True)


def print_lora_tp(st: dict, card: str, steps_text) -> None:
    ref = st["v0_ref"]
    print(f"lora (v0) reference: llama2_7b widths, {DIST_LAYERS} of 32 layers, one rank, "
          f"{DIST_BATCH} x {DIST_SEQ} tokens a step, rank-{LTP_LORA['r']} adapters on "
          f"{'/'.join(LTP_LORA['target_modules'])}, dropout {LTP_LORA['lora_dropout']}, bf16 "
          f"base + fp32 masters; loss/grad norm/step {steps_text(ref['steps'])}; peak "
          f"{ref['peak_bytes']} bytes, launches {json.dumps(ref['launches'])} [{card}]",
          flush=True)
    for r, v0 in enumerate(st["v0"]):
        print(f"lora (v0) rank {r} ({json.dumps(v0['coords'])}): TP {DIST_TP} x DP "
              f"{DIST_WORLD // DIST_TP} over gloo, SP and ZeRO-1; loss/grad norm/step "
              f"{steps_text(v0['steps'])}; {v0['adapter_leaves']} adapter leaves "
              f"({v0['whole_leaves']} whole on every rank), base unchanged "
              f"{v0['base_unchanged']}, peak {v0['peak_bytes']} bytes, launches "
              f"{json.dumps(v0['launches'])}, cell {v0['wall_s']:.1f} s [{card}]", flush=True)
    print(f"lora (v0): losses and grad norms within {ref['ranks_loss_max_rel_diff']:.3g} and "
          f"{ref['ranks_grad_norm_max_rel_diff']:.3g} of the one-rank run's (limit {LTP_RTOL}); "
          f"every step moved the adapters; DP replicas and TP-replicated adapters bit-identical after "
          f"every step [{card}]", flush=True)


def print_moe_cp(st: dict, card: str, steps_text) -> None:
    ref = st["v1_ref"]
    print(f"moe (v1) reference: mixtral_8x7b widths, {MOE_LAYERS} of 32 layers, one rank, "
          f"{MCP_BATCH} x {MCP_SEQ} tokens a step (the MoE blocks fed the zigzag order of cp "
          f"{MCP_CP}), capacity factor {MCP_CF} ({ref['capacity']} slots an expert), bf16 + fp32 "
          f"masters, remat full; loss/grad norm/step {steps_text(ref['steps'])}; dropped "
          f"{[s['dropped'] for s in ref['steps']]}; peak {ref['peak_bytes']} bytes, launches "
          f"{json.dumps(ref['launches'])} [{card}]", flush=True)
    for r, v1 in enumerate(st["v1"]):
        per_step = {k: f"{v[0] / MCP_STEPS:g} calls {v[1] / MCP_STEPS:.0f} bytes"
                    for k, v in sorted(v1["collectives"].items())}
        print(f"moe (v1) rank {r} ({json.dumps(v1['coords'])}): CP {MCP_CP} x EP {MCP_EP} over "
              f"gloo, zigzag, ZeRO-1; loss/grad norm/step {steps_text(v1['steps'])}; dropped "
              f"{[s['dropped'] for s in v1['steps']]}; peak {v1['peak_bytes']} bytes, launches "
              f"{json.dumps(v1['launches'])}, collectives a step {json.dumps(per_step)}, cell "
              f"{v1['wall_s']:.1f} s [{card}]", flush=True)
    print(f"moe (v1): losses and grad norms within {ref['ranks_loss_max_rel_diff']:.3g} and "
          f"{ref['ranks_grad_norm_max_rel_diff']:.3g} of the one-rank run's (limit {MCP_RTOL}); "
          f"(v1 small) small fp32 Mixtral at CP {MCP_CP} x EP {MCP_EP} "
          f"zigzag, capacity factor {MOE_SMALL_CF}, on the card vs one CPU rank: max |loss or "
          f"grad norm diff| {ref['small_max_abs_err']:.3g} (tol {MCP_SMALL_TOL}), dropped "
          f"equal, CPU dropped {[s['dropped'] for s in st['v1_small_cpu']]} [{card}]",
          flush=True)


def print_mixtral_lora(v2: dict, card: str) -> None:
    for name in ("pool", "plain"):
        rep = v2[name]["report"]
        print(f"mixtral lora (v2 {name}): runner serve --model mixtral"
              + (f" --adapters {MLORA_ADAPTERS} (rank {MLORA_RANK}, {MLORA_SLOTS} slots)"
                 if name == "pool" else "")
              + f" --paged --paged-kernel, mixtral_8x7b full width at {v2['layers']} of 32 "
              f"layers, bf16 weights {v2['weight_bytes']} bytes; {rep.get('requests_completed')} "
              f"requests, {rep.get('total_generated_tokens')} tokens, {rep.get('tokens_per_sec')} "
              f"tok/s, adapter loads {rep.get('adapter_loads', 0)} hits "
              f"{rep.get('adapter_hits', 0)}, peak {v2[name]['peak_bytes']} bytes, launches "
              f"{json.dumps(v2[name]['launches'])} [{card}]", flush=True)
    lay = v2["layer"]
    print(f"mixtral lora (v2): slot-0 streams ({v2['slot0_tokens']} tokens) bit-identical to "
          f"the engine without a pool {v2['slot0_bit_identical']}; small fp32 Mixtral layer, "
          f"pool targets {lay['targets']}, pooled vs merged max |err| {lay['max_abs_err']:.3g} "
          f"(tol {MLORA_LAYER_TOL}, the delta {lay['delta_max_abs']:.3g}), slot-0 rows "
          f"bit-identical {lay['base_bit_identical']} [{card}]", flush=True)


# --- kernel cases at the families' shapes (phase 2) -------------------------------------

FAM_KERNEL_BERT = dict(b=16, h=16, s=512, d=64)    # bert_large, 16 x 512 tokens a step
FAM_KERNEL_NEOX = dict(b=8, h=64, s=2048, d=96)    # gpt_neox_20b, 8 x 2048 tokens a step
# The element rule's floors where these shapes need other ones than
# ``head_dim_floors`` give. Readings on an H100 (the seeded inputs and the
# kernels are deterministic: every run reads the same): at the BERT shape
# the kernels need out 2.1e-4, dq 3.9e-4, dk 3.4e-4, dv 2.4e-4 (medians
# 0.054, 0.052, 0.040, 0.041), under the default floors; at the NeoX shape
# out 1.03e-3 (median 0.0374: the default 8.5e-4 is too low), dq 7.2e-4, dk
# 1.01e-3 (median 0.0212: the default 1.5e-3 is above 5 % of it, 1.06e-3),
# dv 2.4e-4. The out floor is raised to under 5 % of its median, the dk
# floor lowered to it.
FAM_KERNEL_FLOORS = {"bert": {}, "neox": {"out": 1.8e-3, "dk": 1.05e-3}}


def family_kernel_case(dev, case: str):
    """B1's and B3's operands at one attention layer of a family's training
    step, bf16: BERT-large bidirectional under the pad keys of the first
    ``synthetic_mlm_batches`` batch (queries at ``s - 1``, valid keys at 0,
    pad keys at ``s``: ``models.bert.mask_positions``), or GPT-NeoX-20B
    causal at head_dim 96 (run at the 128-wide build). Returns the forward's
    arguments, dO and the SDPA call on the same inputs."""
    import torch
    import torch.nn.functional as F

    from neuronx_distributed_tpu_torch.examples.common import synthetic_mlm_batches
    from neuronx_distributed_tpu_torch.models.bert import mask_positions

    p = FAM_KERNEL_BERT if case == "bert" else FAM_KERNEL_NEOX
    b, h, s, d = p["b"], p["h"], p["s"], p["d"]
    g = torch.Generator(device=dev).manual_seed(31)
    q, k, v, do = (torch.randn((b * h, s, d), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    q4, k4, v4 = (t.reshape(b, h, s, d) for t in (q, k, v))
    if case == "bert":
        mask = torch.as_tensor(next(synthetic_mlm_batches(30522, b, s))["attention_mask"],
                               device=dev)
        qpos, kpos = mask_positions(mask)
        keep = mask.bool()[:, None, None, :]

        def library(q4=q4, k4=k4, v4=v4):
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=keep)
    else:
        qpos = kpos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)

        def library(q4=q4, k4=k4, v4=v4):
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    qpos, kpos = qpos.reshape(b, 1, s).contiguous(), kpos.reshape(b, 1, s).contiguous()
    return (q, k, v, qpos, kpos, d ** -0.5, 64, 64, 1, h), do, library


def run_family_kernels(dev, flush, reps=5) -> dict:
    """B1 and B3a/B3b at the BERT-large and GPT-NeoX-20B shapes of phase 4o:
    each output held element by element against its twin or its fp64
    evaluation (``held``, the floors of ``head_dim_floors``, each under 5 %
    of its median |ref|), the LSE against the twin's, pad keys' dK/dV
    exactly 0; each timed beside its twin, SDPA on the same inputs (the
    boolean pad mask for BERT, ``is_causal`` for NeoX; its forward plus
    backward for B3) and its bound (the operations of the visible pairs)."""
    import torch

    from neuronx_distributed_tpu_torch.kernels.flash_attn import (
        flash_block_forward,
        flash_block_forward_plain,
        flash_bwd_dkdv,
        flash_bwd_dkdv_plain,
        flash_bwd_dq,
        flash_bwd_dq_plain,
    )

    out, problems = {}, []
    for case in ("bert", "neox"):
        fwd, do, library = family_kernel_case(dev, case)
        q, k, v, qpos, kpos = fwd[:5]
        bh, s, d = q.shape
        b = qpos.shape[0]
        floors = {**head_dim_floors(d), **FAM_KERNEL_FLOORS[case]}
        o, lse = flash_block_forward(*fwd)
        torch.cuda.synchronize()
        ref, ref_lse = flash_block_forward_plain(*fwd)
        r = {"out": held(o, ref, floors["out"], exact=fwd_exact(*fwd)[0]),
             "lse": dict(max_abs_err=float((lse - ref_lse).abs().max()), tolerance=TOL_LSE)}
        del ref, ref_lse
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta, qpos, kpos, *fwd[5:])
        got = (flash_bwd_dq(*args), *flash_bwd_dkdv(*args))
        torch.cuda.synchronize()
        want = (flash_bwd_dq_plain(*args), *flash_bwd_dkdv_plain(*args))
        for name, a, w, x in zip(("dq", "dk", "dv"), got, want, bwd_exact(*args)):
            check(bool(torch.isfinite(a).all()), f"flash backward {name} ({case}) is not finite")
            r[name] = held(a, w, floors[name], exact=x)
        del want
        if case == "bert":   # pad keys take no gradient
            pads = (kpos.reshape(b, s) != 0).repeat_interleave(bh // b, dim=0)
            check(float(got[1][pads].abs().max()) == 0.0 and
                  float(got[2][pads].abs().max()) == 0.0,
                  "family kernels (bert): a pad key got a nonzero dK or dV")
        del got
        if r["lse"]["max_abs_err"] > TOL_LSE:
            problems.append(f"flash_fwd lse ({case}) differs from its twin by "
                            f"{r['lse']['max_abs_err']}")
        for name, x in r.items():
            if "floor" in x:
                problems += held_problems(f"{name} at the {case} shape", x)
        pairs = int((kpos.reshape(b, 1, s) <= qpos.reshape(b, s, 1)).sum()) * (bh // b)
        common = nbytes(q, k, v, do, lse, delta, qpos, kpos)
        qg, kg, vg = (t.reshape(b, -1, s, d).detach().requires_grad_(True) for t in (q, k, v))
        do4 = do.reshape(b, -1, s, d)

        def library_bwd():
            return torch.autograd.grad(library(qg, kg, vg), (qg, kg, vg), do4)

        bwd_library_ms = time_ms(library_bwd, reps, flush)
        shape = (f"q ({bh}, {s}, {d}) bf16, k/v ({bh}, {s}, {d}), group 1, "
                 + ("bidirectional, the pad keys of synthetic_mlm_batches" if case == "bert"
                    else "causal, at the 128-wide build"))
        timed = {
            "flash_fwd": dict(
                ms=time_ms(lambda: flash_block_forward(*fwd), reps, flush),
                plain_ms=time_ms(lambda: flash_block_forward_plain(*fwd), 1, flush),
                library_ms=time_ms(library, reps, flush),
                **bound(4 * d * pairs, nbytes(q, k, v, qpos, kpos, o, lse))),
            "flash_bwd_dkdv": dict(
                ms=time_ms(lambda: flash_bwd_dkdv(*args), reps, flush),
                plain_ms=time_ms(lambda: flash_bwd_dkdv_plain(*args), 1, flush),
                library_ms=bwd_library_ms, **bound(8 * d * pairs, common + 2 * nbytes(k))),
            "flash_bwd_dq": dict(
                ms=time_ms(lambda: flash_bwd_dq(*args), reps, flush),
                plain_ms=time_ms(lambda: flash_bwd_dq_plain(*args), 1, flush),
                library_ms=bwd_library_ms, **bound(6 * d * pairs, common + nbytes(q))),
        }
        library_name = ("SDPA, bool pad mask" if case == "bert" else "SDPA, is_causal")
        for name, t in timed.items():
            t.update(library=library_name + ("" if name == "flash_fwd" else
                                             ", forward + backward"),
                     tflops=t["flops"] / (t["ms"] * 1e-3) / 1e12, bound_share=t["bound_ms"] / t["ms"])
        out[case] = dict(shape=shape, held=r, timed=timed)
        del fwd, do, o, lse, delta, args, qg, kg, vg
        gc.collect()
        torch.cuda.empty_cache()
    return out, problems


def print_family_kernels(fam: dict, card: str) -> None:
    for case, r in fam.items():
        print(f"  held at the {case} shape, {r['shape']}: " + "; ".join(
            f"{n} max |err| {x['max_abs_err']:.3g}" + (
                f", floor needed {x['floor_needed']:.3g} of {x['floor']:.3g}, median |ref| "
                f"{x['median_abs_ref']:.3g}" if "floor" in x else f" (tol {x['tolerance']})")
            for n, x in r["held"].items()) + f" [{card}]", flush=True)
        for name, t in r["timed"].items():
            print(f"kernel {name} at the {case} shape: {r['shape']}; {t['ms']:.4f} ms, "
                  f"{t['tflops']:.1f} TFLOP/s, {t['bound_share']:.1%} of bound, twin "
                  f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms ({t['library']}), "
                  f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}) [{card}]", flush=True)


# --- phase 4o: the GPT-NeoX and BERT families --------------------------------------------

FAM_BERT_BATCH, FAM_BERT_SEQ, FAM_BERT_STEPS = 16, 512, 4   # (b0): bert_large, full depth
FAM_BERT_DESCENT_STEPS = 5        # (b0): one repeated batch, the loss must fall
FAM_NEOX_LAYERS = 1               # gpt_neox_20b depth 44 -> 1 (2 cut to 1: the run time)
FAM_NEOX_SEQ, FAM_NEOX_BATCH, FAM_NEOX_STEPS = 2048, 8, 2   # 3 steps cut to 2: the run time
FAM_LR = 1e-4                     # the examples' default
FAM_WORLD, FAM_TP = 4, 2          # (n1): TP 2 x DP 2, four processes on the one card
FAM_LOSS_RTOL = 1e-2              # (n1) vs (n0), bf16
FAM_SMALL_TOL = 1e-5              # (n2): card ranks vs one CPU rank, fp32, relative
FAM_SMALL_BATCH, FAM_SMALL_STEPS, FAM_SMALL_LR = 4, 3, 1e-4
FAM_TIMEOUT_S = 300               # every group's timeout
FAM_CHILD_TIMEOUT_S = 900         # the parent's wait for the ranks
FAM_COUNTERS = DIST_COUNTERS


def fam_bert_args(extra=()) -> list:
    return ["--tp", "1", "--batch_size", str(FAM_BERT_BATCH), "--seq_len", str(FAM_BERT_SEQ),
            "--steps", str(FAM_BERT_STEPS), "--lr", str(FAM_LR), "--log_every", "0", *extra]


def fam_neox_args(layers: int, extra=()) -> list:
    return ["--size", "20b", "--layers", str(layers), "--seq_len", str(FAM_NEOX_SEQ),
            "--batch_size", str(FAM_NEOX_BATCH), "--steps", str(FAM_NEOX_STEPS), "--lr",
            str(FAM_LR), "--log_every", "0", *extra]


def _step_hook(steps: list, mark: dict):
    """``on_step`` of an example's ``main``: each step's loss, grad norm and
    ms (from the previous step's end; the first step's is None: it follows
    the set-up)."""
    import torch

    def on_step(i, state, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        steps.append(dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                          ms=(now - mark["t"]) * 1e3 if "t" in mark else None))
        mark["t"] = time.perf_counter()

    return on_step


def fam_b0(dev, counters) -> dict:
    """(b0): ``bert_large`` at full width and depth through the BERT
    example's ``main`` on one rank (fp32 weights and masters, bf16 compute,
    dropout 0.1, ZeRO off: one rank), counters zeroed just before ``main``
    and read just after; then the same model on one repeated batch (and
    dropout seed) for ``FAM_BERT_DESCENT_STEPS`` steps through the trainer."""
    import torch

    from neuronx_distributed_tpu_torch.examples import bert_pretrain as example
    from neuronx_distributed_tpu_torch.examples.common import synthetic_mlm_batches, to_device
    from neuronx_distributed_tpu_torch.models.bert import BertForPreTraining
    from neuronx_distributed_tpu_torch.trainer import (
        create_train_state,
        initialize_parallel_model,
        initialize_parallel_optimizer,
        make_train_step,
        neuronx_distributed_config,
    )

    _, total = torch.cuda.mem_get_info()
    torch.cuda.reset_peak_memory_stats()
    steps, mark = [], {}
    zero_launches(counters)
    t0 = time.perf_counter()
    example.main(fam_bert_args(["--device", dev]), on_step=_step_hook(steps, mark))
    launches = {c.__name__: c.launches for c in counters}
    main_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    timed = [s["ms"] for s in steps if s["ms"] is not None]
    out = dict(steps=steps, launches=launches, peak_bytes=peak, card_bytes=total, main_s=main_s,
               step_ms_mean=sum(timed) / len(timed),
               tokens_per_s=FAM_BERT_BATCH * FAM_BERT_SEQ / (sum(timed) / len(timed) / 1e3))
    gc.collect()
    torch.cuda.empty_cache()

    args = example.parse_args(fam_bert_args())
    cfg = example.build_config(args)
    nxd = neuronx_distributed_config(optimizer_config={"zero_one_enabled": False},
                                     mixed_precision_config={"use_master_weights": True})
    model = initialize_parallel_model(nxd, lambda: BertForPreTraining(cfg), device=dev)
    out["params"] = model.num_params()
    opt = initialize_parallel_optimizer(nxd, model, learning_rate=FAM_LR,
                                        weight_decay=args.weight_decay)
    state = create_train_state(model, opt)

    def loss_fn(p, b, rng):
        model.bind(p)
        return model.module.loss(b["input_ids"], b["masked_lm_labels"], b["next_sentence_labels"],
                                 b["token_type_ids"], b["attention_mask"], deterministic=False,
                                 dropout_seed=rng)

    step = make_train_step(model, opt, loss_fn)
    batch = to_device(next(synthetic_mlm_batches(cfg.vocab_size, FAM_BERT_BATCH, FAM_BERT_SEQ)),
                      dev)
    losses = []
    for _ in range(FAM_BERT_DESCENT_STEPS):
        state, m = step(state, batch, 1)
        losses.append(float(m["loss"]))
    out["descent_losses"] = losses
    del model, opt, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fam_b0_problems(b0: dict) -> list:
    bad = []
    if not all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]) for s in b0["steps"]):
        bad.append(f"(b0): a non-finite loss or grad norm {b0['steps']}")
    if len(b0["steps"]) != FAM_BERT_STEPS:
        bad.append(f"(b0) ran {len(b0['steps'])} steps, not {FAM_BERT_STEPS}")
    for name in FAM_COUNTERS:
        if b0["launches"].get(name, 0) <= 0:
            bad.append(f"(b0) never launched {name}")
    if b0["peak_bytes"] >= b0["card_bytes"]:
        bad.append(f"(b0): peak {b0['peak_bytes']} bytes is not below the card's")
    d = b0["descent_losses"]
    if not (all(math.isfinite(x) for x in d) and d[-1] < d[0]):
        bad.append(f"(b0): on one repeated batch the loss did not fall: {d}")
    return bad


def fam_n0(dev, counters, layers=FAM_NEOX_LAYERS) -> dict:
    """(n0): the NeoX example's ``gpt_neox_20b`` model at ``layers`` layers
    and its batches on one rank through the trainer (bf16 weights, fp32
    masters, remat ``"attention"``, clipping 1.0; ZeRO off: one rank),
    counters zeroed just before the steps and read just after; the head
    dims B1 was launched at, recorded at the launch."""
    import torch

    from neuronx_distributed_tpu_torch.examples import gpt_neox_pretrain as example
    from neuronx_distributed_tpu_torch.examples.common import synthetic_lm_batches, to_device
    from neuronx_distributed_tpu_torch.kernels import flash_attn
    from neuronx_distributed_tpu_torch.models.gpt_neox import GPTNeoXForCausalLM
    from neuronx_distributed_tpu_torch.trainer import (
        create_train_state,
        initialize_parallel_model,
        initialize_parallel_optimizer,
        make_train_step,
        neuronx_distributed_config,
    )

    _, total = torch.cuda.mem_get_info()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    args = example.parse_args(fam_neox_args(layers))
    cfg = example.build_config(args, FAM_NEOX_SEQ)
    nxd = neuronx_distributed_config(
        optimizer_config={"zero_one_enabled": False, "grad_clipping": True, "max_grad_norm": 1.0},
        mixed_precision_config={"use_master_weights": True})
    model = initialize_parallel_model(nxd, lambda: GPTNeoXForCausalLM(cfg), device=dev)
    opt = initialize_parallel_optimizer(nxd, model, learning_rate=FAM_LR,
                                        weight_decay=args.weight_decay)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, lambda p, b, rng: model.apply(
        p, b["ids"], b["labels"], method="loss"))
    batches = synthetic_lm_batches(cfg.vocab_size, FAM_NEOX_BATCH, FAM_NEOX_SEQ, seed=args.seed)
    next(batches)   # the example's init sample
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    widths = collections.Counter()
    launch = flash_attn._flash_fwd_kernel

    def spy(q, *rest):
        widths[q.shape[-1]] += 1
        return launch(q, *rest)

    flash_attn._flash_fwd_kernel = spy
    zero_launches(counters)
    steps = []
    try:
        for _ in range(FAM_NEOX_STEPS):
            batch = to_device(next(batches), dev)
            t = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            steps.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                              ms=(time.perf_counter() - t) * 1e3))
    finally:
        flash_attn._flash_fwd_kernel = launch
    out = dict(layers=cfg.num_layers, head_dim=cfg.head_dim_, rope_dims=cfg.rope_dims,
               steps=steps, launches={c.__name__: c.launches for c in counters},
               b1_head_dims={str(w): n for w, n in widths.items()},
               kernel_head_dim=flash_attn.kernel_head_dim(cfg.head_dim_), setup_s=setup_s,
               params=model.num_params(), peak_bytes=torch.cuda.max_memory_allocated(),
               card_bytes=total)
    out["tokens_per_s"] = FAM_NEOX_BATCH * FAM_NEOX_SEQ / (
        sum(s["ms"] for s in steps[1:]) / len(steps[1:]) / 1e3)
    del model, opt, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fam_n0_problems(n0: dict) -> list:
    bad = []
    if not all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]) for s in n0["steps"]):
        bad.append(f"(n0): a non-finite loss or grad norm {n0['steps']}")
    for name in FAM_COUNTERS:
        if n0["launches"].get(name, 0) <= 0:
            bad.append(f"(n0) never launched {name}")
    b1 = n0["launches"].get("flash_block_forward", 0)
    if n0["b1_head_dims"] != {"96": b1} or b1 < n0["layers"] * FAM_NEOX_STEPS:
        bad.append(f"(n0): B1 ran at head dims {n0['b1_head_dims']} ({b1} launches), not every "
                   f"layer's at 96")
    if n0["kernel_head_dim"] != 128:
        bad.append(f"(n0): head_dim 96 runs at the {n0['kernel_head_dim']}-wide build")
    if n0["peak_bytes"] >= n0["card_bytes"]:
        bad.append(f"(n0): peak {n0['peak_bytes']} bytes is not below the card's")
    return bad


def fam_small_configs() -> dict:
    """(n2)'s small fp32 models: NeoX at head_dim 128 (a kernel width,
    rotary over 32 dims) and BERT at head_dim 64, no dropout."""
    import torch

    from neuronx_distributed_tpu_torch.models.bert import BertConfig
    from neuronx_distributed_tpu_torch.models.gpt_neox import GPTNeoXConfig

    return dict(
        neox=GPTNeoXConfig(vocab_size=512, hidden_size=512, intermediate_size=1024,
                           num_layers=2, num_heads=4, num_kv_heads=4, max_seq_len=256,
                           dtype=torch.float32, param_dtype=torch.float32),
        bert=BertConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                        num_heads=4, max_position_embeddings=256, hidden_dropout=0.0,
                        dtype=torch.float32, param_dtype=torch.float32))


def fam_small_batches(name: str) -> list:
    """(n2)'s global batches, numpy (the same on every rank and the CPU)."""
    import numpy as np

    from neuronx_distributed_tpu_torch.examples.common import synthetic_mlm_batches

    if name == "bert":
        it = synthetic_mlm_batches(512, FAM_SMALL_BATCH, 128, seed=40)
        return [next(it) for _ in range(FAM_SMALL_STEPS)]
    out = []
    for i in range(FAM_SMALL_STEPS):
        ids = np.random.RandomState(40 + i).randint(0, 512, (FAM_SMALL_BATCH, 257))
        out.append({"ids": ids[:, :-1].astype(np.int32), "labels": ids[:, 1:].astype(np.int32)})
    return out


def fam_small_run(dev, name: str, tp: int) -> list:
    """(n2): the small fp32 model ``name`` from its seeded global init, TP
    ``tp`` (SP for NeoX), ZeRO-1, fp32 masters, clipping 1.0, 3 steps on the
    rank's rows; each step's loss and grad norm."""
    import torch

    from neuronx_distributed_tpu_torch.models.bert import BertForPreTraining
    from neuronx_distributed_tpu_torch.models.gpt_neox import GPTNeoXForCausalLM
    from neuronx_distributed_tpu_torch.models.llama import init_params
    from neuronx_distributed_tpu_torch.parallel import mesh
    from neuronx_distributed_tpu_torch.trainer import (
        create_train_state,
        initialize_parallel_model,
        initialize_parallel_optimizer,
        make_train_step,
        neuronx_distributed_config,
    )

    cfg = fam_small_configs()[name]
    cls = BertForPreTraining if name == "bert" else GPTNeoXForCausalLM
    params = init_params(cfg, torch.Generator().manual_seed(0), model_cls=cls)
    nxd = neuronx_distributed_config(
        tensor_parallel_size=tp, sequence_parallel=tp > 1 and name == "neox",
        optimizer_config={"zero_one_enabled": True, "grad_clipping": True, "max_grad_norm": 1.0},
        mixed_precision_config={"use_master_weights": True})
    model = initialize_parallel_model(nxd, lambda: cls(cfg), device=dev, params=params)
    opt = initialize_parallel_optimizer(nxd, model, learning_rate=FAM_SMALL_LR, weight_decay=0.01)
    on_mesh = mesh.model_parallel_is_initialized()
    dp_group = mesh.get_data_parallel_group() if on_mesh else None

    def loss_fn(p, b, rng):
        model.bind(p)
        if name == "bert":
            return model.module.loss(b["input_ids"], b["masked_lm_labels"],
                                     b["next_sentence_labels"], b["token_type_ids"],
                                     b["attention_mask"], dp_group=dp_group)
        return model.module.loss(b["ids"], b["labels"])

    state, step = create_train_state(model, opt), make_train_step(model, opt, loss_fn)
    rows = mesh.data_batch_slice(FAM_SMALL_BATCH) if on_mesh else slice(None)
    out = []
    for b in fam_small_batches(name):
        state, m = step(state, {k: torch.as_tensor(v[rows]).to(dev) for k, v in b.items()})
        out.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"])))
    return out


def fam_child(rank: int, world: int, port: int, out_path: str, layers: int = FAM_NEOX_LAYERS,
              dev: str = "cuda:0") -> int:
    """One rank of (n1) and (n2), a process of its own on ``cuda:0`` over
    gloo. (n1): the NeoX example's ``main`` at TP 2 x DP 2 (SP, ZeRO-1),
    with a step hook that reads the loss, grad norm, step time and param
    digests; launch counters zeroed just before ``main`` and read just
    after. (n2): the small fp32 NeoX and BERT models on the same layout.
    Writes every reading to ``out_path``."""
    import datetime

    import torch
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch.examples import gpt_neox_pretrain as example
    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.kernels.flash_attn import (
        flash_block_forward,
        flash_bwd_dkdv,
        flash_bwd_dq,
    )
    from neuronx_distributed_tpu_torch.optimizer.fused_kernel import fused_adamw_leaf
    from neuronx_distributed_tpu_torch.parallel import mesh

    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    res = dict(rank=rank)
    counters = (flash_block_forward, flash_bwd_dkdv, flash_bwd_dq, fused_adamw_leaf)
    steps, mark = [], {}
    hook = _step_hook(steps, mark)

    def on_step(i, state, metrics):
        hook(i, state, metrics)
        pieces = state.layout
        tp_leaves = {n for n, t in state.params.items()
                     if tuple(pieces[f".params['{n}']"].global_shape) != tuple(t.shape)}
        steps[-1]["digest"] = _digest(state.params)
        steps[-1]["replicated_digest"] = _digest({n: t for n, t in state.params.items()
                                                  if n not in tp_leaves})
        if i == 0:
            res["coords"] = mesh.local_mesh_coords()
            res["param_bytes"] = sum(nbytes(t) for t in state.params.values())
        mark["t"] = time.perf_counter()

    argv = fam_neox_args(layers, ["--tp", str(FAM_TP), "--backend", "gloo", "--device", dev,
                                  "--coordinator_address", f"localhost:{port}",
                                  "--num_processes", str(world), "--process_id", str(rank)])
    torch.cuda.reset_peak_memory_stats()
    zero_launches(counters)
    t1 = time.perf_counter()
    example.main(argv, on_step=on_step)
    res["n1"] = dict(steps=steps, launches={c.__name__: c.launches for c in counters},
                     peak_bytes=torch.cuda.max_memory_allocated(),
                     main_s=time.perf_counter() - t1)
    mesh.destroy_model_parallel()
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()

    timeout = datetime.timedelta(seconds=FAM_TIMEOUT_S)
    res["n2"] = {}
    for i, name in enumerate(("neox", "bert")):
        mesh.init_distributed("gloo", rank=rank, world_size=world, local_rank=0,
                              init_method=f"tcp://localhost:{port + 1 + i}", timeout=timeout)
        mesh.initialize_model_parallel(FAM_TP, timeout=timeout)
        res["n2"][name] = fam_small_run(dev, name, FAM_TP)
        mesh.destroy_model_parallel()
        dist.destroy_process_group()
    res["wall_s"] = time.perf_counter() - t0
    Path(out_path).write_text(json.dumps(res))
    return 0


def fam_ranks(tmp: Path, layers: int = FAM_NEOX_LAYERS) -> dict:
    """:func:`fam_child` as ``FAM_WORLD`` processes on the one card; the
    card's used memory polled while they run. A rank that fails or outlives
    ``FAM_CHILD_TIMEOUT_S`` fails the phase (every process is stopped)."""
    import torch

    port = _free_port()
    free0, total = torch.cuda.mem_get_info()
    peak_used = total - free0
    logs = [open(tmp / f"fam{r}.log", "w") for r in range(FAM_WORLD)]
    cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--fam-world", str(FAM_WORLD),
           "--fam-port", str(port), "--fam-layers", str(layers)]
    env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    procs = [subprocess.Popen(cmd + ["--fam-rank", str(r), "--fam-out",
                                     str(tmp / f"fam{r}.json")],
                              cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT, env=env)
             for r in range(FAM_WORLD)]
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            if time.perf_counter() - t0 > FAM_CHILD_TIMEOUT_S:
                raise SmokeFailure(f"families phase: the ranks ran past {FAM_CHILD_TIMEOUT_S} s")
            if any(p.poll() not in (None, 0) for p in procs):
                break   # one rank failed: its peers fail at the group's timeout
            free, _ = torch.cuda.mem_get_info()
            peak_used = max(peak_used, total - free)
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            tail = (tmp / f"fam{r}.log").read_text()[-3000:]
            raise SmokeFailure(f"families phase: rank {r} exited {p.returncode}:\n{tail}")
    ranks = [json.loads((tmp / f"fam{r}.json").read_text()) for r in range(FAM_WORLD)]
    return dict(ranks=ranks, wall_s=wall, card_peak_used_bytes=peak_used, card_bytes=total)


def fam_gates(n0: dict, ranks: list) -> list:
    """(n1)'s hard gates against (n0), as a list of problems; records the
    largest relative loss difference in ``n0``."""
    bad = []
    want = [s["loss"] for s in n0["steps"]]
    worst = 0.0
    for rk in ranks:
        got = [s["loss"] for s in rk["n1"]["steps"]]
        if len(got) != FAM_NEOX_STEPS:
            bad.append(f"rank {rk['rank']} ran {len(got)} (n1) steps")
            continue
        worst = max([worst] + [_rel(a, b) for a, b in zip(got, want)])
        for name in FAM_COUNTERS:
            if rk["n1"]["launches"].get(name, 0) <= 0:
                bad.append(f"rank {rk['rank']} never launched {name} in (n1)")
    n0["n1_loss_max_rel_diff"] = worst
    if worst > FAM_LOSS_RTOL:
        bad.append(f"(n1) losses differ from (n0)'s by {worst:.3g} relative (limit "
                   f"{FAM_LOSS_RTOL})")
    for i in range(FAM_NEOX_STEPS):
        by_tp = {}
        for rk in ranks:
            if len(rk["n1"]["steps"]) > i:
                by_tp.setdefault(rk["coords"]["tp"], set()).add(rk["n1"]["steps"][i]["digest"])
        if any(len(v) != 1 for v in by_tp.values()):
            bad.append(f"(n1) step {i + 1}: data-parallel replicas' params differ {by_tp}")
        rep = {rk["n1"]["steps"][i]["replicated_digest"] for rk in ranks
               if len(rk["n1"]["steps"]) > i}
        if len(rep) != 1:
            bad.append(f"(n1) step {i + 1}: TP-replicated leaves differ across ranks {rep}")
    return bad


def fam_small_errors(runs: list, cpu: list) -> float:
    """The largest relative difference of any rank's loss or grad norm from
    the CPU rank's (the tied MLM decoder over unit-scale embeddings puts the
    small BERT's loss near 50 and its grad norm above 100)."""
    return max(max(_rel(a["loss"], c["loss"]), _rel(a["grad_norm"], c["grad_norm"]))
               for run in runs for a, c in zip(run, cpu))


def fam_small_reference(ranks: list) -> dict:
    """(n2)'s CPU side: each small model on one CPU rank, and the ranks'
    largest relative difference from it."""
    out = dict(cpu={}, max_rel_err={})
    for name in ("neox", "bert"):
        cpu = out["cpu"][name] = fam_small_run("cpu", name, 1)
        out["max_rel_err"][name] = fam_small_errors([rk["n2"][name] for rk in ranks], cpu)
    return out


def fam_small_problems(small: dict) -> list:
    return [f"(n2) {name}: losses or grad norms differ from the CPU rank's by {err:.3g} "
            f"relative (limit {FAM_SMALL_TOL})" for name, err in small["max_rel_err"].items()
            if not err <= FAM_SMALL_TOL]


def run_families_phase(dev, counters, layers: int = FAM_NEOX_LAYERS, dump=None) -> dict:
    """Phase 4o: (b0) and (n0) in this process, the four rank processes
    ((n1), (n2)), then (n2)'s CPU side; every gate. ``dump``: a path the
    readings are written to before the gates are held."""
    import torch

    t0 = time.perf_counter()
    b0 = fam_b0(dev, counters)
    n0 = fam_n0(dev, counters, layers)
    with tempfile.TemporaryDirectory() as tmpdir:
        kids = fam_ranks(Path(tmpdir), layers)
    small = fam_small_reference(kids["ranks"])
    problems = (fam_b0_problems(b0) + fam_n0_problems(n0) + fam_gates(n0, kids["ranks"])
                + fam_small_problems(small))
    out = dict(b0=b0, n0=n0, ranks=kids["ranks"], small=small, ranks_wall_s=kids["wall_s"],
               card_peak_used_bytes=kids["card_peak_used_bytes"], card_bytes=kids["card_bytes"])
    if dump is not None:
        Path(dump).parent.mkdir(parents=True, exist_ok=True)
        Path(dump).write_text(json.dumps({**out, "problems": problems}, default=str))
    check(not problems, "families phase: " + "; ".join(problems))
    gc.collect()
    torch.cuda.empty_cache()
    return dict(out, phase_s=time.perf_counter() - t0)


def print_families(st: dict, card: str) -> None:
    b0, n0 = st["b0"], st["n0"]

    def steps_text(steps):
        return ", ".join(f"{s['loss']:.5f}/{s['grad_norm']:.4f}"
                         + (f" {s['ms']:.0f} ms" if s.get("ms") else "") for s in steps)

    print(f"families (b0): bert_large full width and depth, one rank, {FAM_BERT_BATCH} x "
          f"{FAM_BERT_SEQ} tokens a step of synthetic_mlm_batches, fp32 weights and masters, "
          f"bf16 compute, dropout 0.1, {b0['params']} params; loss/grad norm/step "
          f"{steps_text(b0['steps'])}; step {b0['step_ms_mean']:.1f} ms, "
          f"{b0['tokens_per_s']:.0f} tok/s, peak {b0['peak_bytes']} of {b0['card_bytes']} "
          f"bytes, main {b0['main_s']:.1f} s, launches {json.dumps(b0['launches'])}; one "
          f"repeated batch: losses {[round(x, 4) for x in b0['descent_losses']]} [{card}]",
          flush=True)
    print(f"families (n0): gpt_neox_20b widths, {n0['layers']} of 44 layers (head_dim "
          f"{n0['head_dim']} at the {n0['kernel_head_dim']}-wide build, rotary over "
          f"{n0['rope_dims']} dims), one rank, {FAM_NEOX_BATCH} x {FAM_NEOX_SEQ} tokens a step, "
          f"bf16 + fp32 masters, remat attention; loss/grad norm/step {steps_text(n0['steps'])}; "
          f"{n0['tokens_per_s']:.0f} tok/s after the first step, {n0['params']} params, peak "
          f"{n0['peak_bytes']} of {n0['card_bytes']} bytes, set-up {n0['setup_s']:.1f} s, "
          f"launches {json.dumps(n0['launches'])}, B1 launches by head dim "
          f"{json.dumps(n0['b1_head_dims'])} [{card}]", flush=True)
    for rk in st["ranks"]:
        n1 = rk["n1"]
        print(f"families (n1) rank {rk['rank']} ({json.dumps(rk['coords'])}): the "
              f"gpt_neox_pretrain example over gloo, TP {FAM_TP} x DP {FAM_WORLD // FAM_TP}, SP "
              f"and ZeRO-1 on; loss/grad norm/step {steps_text(n1['steps'])}; param bytes "
              f"{rk['param_bytes']}, peak {n1['peak_bytes']} bytes, launches "
              f"{json.dumps(n1['launches'])}, main {n1['main_s']:.1f} s [{card}]", flush=True)
    print(f"families (n1): losses within {n0['n1_loss_max_rel_diff']:.3g} of (n0)'s (limit "
          f"{FAM_LOSS_RTOL}); DP replicas and TP-replicated leaves bit-identical after every "
          f"step; {FAM_WORLD} processes in {st['ranks_wall_s']:.1f} s with (n2), card peak used "
          f"{st['card_peak_used_bytes']} of {st['card_bytes']} bytes [{card}]", flush=True)
    sm = st["small"]
    print(f"families (n2): small fp32 NeoX (SP) and BERT at TP {FAM_TP} x DP "
          f"{FAM_WORLD // FAM_TP} on the card vs one CPU rank: max relative loss or grad norm "
          f"diff {json.dumps({n: f'{v:.3g}' for n, v in sm['max_rel_err'].items()})} (tol "
          f"{FAM_SMALL_TOL}); phase {st['phase_s']:.1f} s [{card}]", flush=True)


# --- phase 4s: the port's static contract checker -------------------------------------

NXDCHECK_RULES = ("host-sync", "cache-replication", "resource-pairing", "determinism",
                  "surface-drift", "async-contract")
NXDCHECK_MAX_S = 30.0   # the sweep's own seconds (about 5 on an idle 8-core host)
NXDCHECK_BAD = ROOT / "tests" / "fixtures" / "nxdcheck_torch" / "bad"


def nxdcheck_run(root=None) -> tuple:
    """``scripts/nxdcheck_torch.py`` in a subprocess over the port tree (or
    the tree at ``root``): (exit code, its JSON summary or None, wall s)."""
    cmd = [sys.executable, str(ROOT / "scripts" / "nxdcheck_torch.py")]
    if root is not None:
        cmd += ["--root", str(root)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT)
    wall = time.perf_counter() - t0
    try:
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        summary = None
    return proc.returncode, summary, wall


def nxdcheck_problems(clean: tuple, bad: tuple) -> list:
    """Phase 4s's gates on the port tree's run and the bad fixture's."""
    problems = []
    rc, summary, _ = clean
    if rc != 0 or not summary or summary.get("verdict") != "clean" or summary.get("unwaived"):
        problems.append(f"the port tree is not clean: exit {rc}, summary {summary}")
    elif tuple(summary.get("rules", ())) != NXDCHECK_RULES:
        problems.append(f"the port tree ran rules {summary.get('rules')}, not {NXDCHECK_RULES}")
    elif summary["elapsed_s"] > NXDCHECK_MAX_S:
        problems.append(f"the sweep took {summary['elapsed_s']} s (limit {NXDCHECK_MAX_S})")
    rc, summary, _ = bad
    fired = set((summary or {}).get("by_rule", {}))
    if rc != 1 or not summary or summary.get("verdict") != "findings":
        problems.append(f"the bad fixture did not fail: exit {rc}, summary {summary}")
    elif fired != set(NXDCHECK_RULES):
        problems.append(f"rules silent on the bad fixture: {sorted(set(NXDCHECK_RULES) - fired)}")
    return problems


def run_nxdcheck_phase(card: str) -> dict:
    """Phase 4s: the checker over the port tree, then over its bad fixture;
    prints both summaries and the sweep's seconds with ``card``."""
    clean, bad = nxdcheck_run(), nxdcheck_run(NXDCHECK_BAD)
    for name, (rc, summary, wall) in (("port tree", clean), ("bad fixture", bad)):
        print(f"nxdcheck {name}: exit {rc}, {wall:.2f} s wall, summary "
              f"{json.dumps(summary)} [{card}]", flush=True)
    problems = nxdcheck_problems(clean, bad)
    check(not problems, "nxdcheck: " + "; ".join(problems))
    return {"port_tree": clean[1], "port_tree_wall_s": clean[2], "bad_fixture": bad[1],
            "bad_fixture_wall_s": bad[2]}


# --------------------------------------------------------------- phase 4p
# The user's entry points: the serving runner (examples/runner.py) at
# Llama-2-13B full width and depth, bf16 seeded weights, TP 1, through its
# main(argv, params=, config=) and once as a process of the shell entry
# point; its --tiny cases on the card; and the lightning fit loop over
# llama2_7b widths at 1 layer. B1 and B5 are held first at the shapes the
# runner's 13B paths give them.

EP_BENCH = ["benchmark", "--max_batch", "1", "--prompt_len", "2048", "--trials", "10",
            "--decode_steps", "50", "--fused_chunk", "8"]
EP_GENERATE = ["generate", "--max_new_tokens", "32"]
EP_SERVE = ["serve", "--paged", "--paged-kernel", "--async", "--max_batch", "8",
            "--num_requests", "16", "--prompt_len", "512", "--max_new_tokens", "32",
            "--shared_prefix_len", "64"]
EP_SPEC = ["speculate", "--num_draft", "4", "--max_new_tokens", "32"]
EP_SPEC_ROUNDS = 2
EP_CHECK = ["check-accuracy", "--max_new_tokens", "32"]
EP_CHECK_LAYERS = 10          # (r3): llama2_13b depth 40 -> 10 (fp32: 52 + 52 GB at 40)
EP_CHECK_TOL = 1e-3           # the CPU test's bound (tests/test_torch_runner.py LOGIT_TOL)
EP_QUANT = ["generate", "--quantize", "--max_new_tokens", "32"]
EP_SHELL_TIMEOUT_S = 300
# (r0 shell): EP_GENERATE as its own process, the module run as `python -m`
# runs it (runpy, as __main__), with the runner's launch counts printed at
# exit on a line of their own
EP_SHELL_BOOT = (
    "import atexit, json, runpy\n"
    "from neuronx_distributed_tpu_torch.inference.paged_kernel import paged_decode_attention\n"
    "from neuronx_distributed_tpu_torch.kernels.flash_attn import flash_block_forward\n"
    "from neuronx_distributed_tpu_torch.kernels.w8a16 import w8a16_gemm\n"
    "atexit.register(lambda: print('launches ' + json.dumps({c.__name__: c.launches for c in "
    "(flash_block_forward, paged_decode_attention, w8a16_gemm)}), flush=True))\n"
    "runpy.run_module('neuronx_distributed_tpu_torch.examples.runner', run_name='__main__', "
    "alter_sys=True)\n")
# B5 and B1 at the shapes the runner's 13B paths give them, held by the
# element rule (not timed: the kernels phase times B5 at its own shapes).
# B5: the attention products 5120 -> 5120 (q, k, v, o: 40 heads of 128,
# group 1), the MLP's 5120 -> 13824 (gate, up) and 13824 -> 5120 (down), at
# a decode row (max_batch 1) and at the 128-, 512- and 2048-token buckets'
# inserts (compile builds every bucket), in bf16 ((r4)) and fp32 ((r4
# check)); the fp32 floor grows with sqrt(K / 4096) over the kernels
# phase's (summation order over K). B1: the 2048 bucket's insert, 40 query
# heads over 40 kv heads, 2048 queries at positions 0..2047 against the
# 4096 slots of the cache, the blocks the cached path picks. Its reading on
# an H100 80GB HBM3 at 700 W (seeded inputs, deterministic kernels): out
# needs 1.04e-3 against the fp64 evaluation (the twin 5.0e-4), median |ref|
# 0.0374, as at NeoX's causal 2048 (``FAM_KERNEL_FLOORS``): the out floor is
# raised as there, under 5 % of the median.
EP_B5_SHAPES = ((5120, 5120), (5120, 13824), (13824, 5120))
EP_B5_ROWS = (1, 128, 512, 2048)
EP_B1_INSERT = dict(h=40, sq=2048, sk=4096, d=128)
EP_B1_FLOOR = 1.8e-3
EP_FIT_LAYERS = DIST_LAYERS   # (l0): llama2_7b depth 32 -> 1, as the (d0) cell
EP_FIT_BATCH = 2
EP_FIT_SEQ = 4096
EP_FIT_STEPS = 4
EP_FIT_KILL = 2               # SIGTERM at this step; the resumed fit runs to EP_FIT_STEPS
EP_FIT_LR = 1e-4
EP_RUNNER_COUNTERS = ("flash_block_forward", "paged_decode_attention", "w8a16_gemm")
EP_FIT_COUNTERS = DIST_COUNTERS


def ep_runner():
    from neuronx_distributed_tpu_torch.examples import runner

    return runner


def ep_weight_bytes(tensors) -> dict:
    """Bytes of a state dict by dtype, and in all."""
    out = collections.Counter()
    for t in tensors.values():
        out[str(t.dtype).replace("torch.", "")] += t.numel() * t.element_size()
    return dict(out, total=sum(out.values()))


class _Recorded:
    """While active, every ``CausalLM`` the runner builds is kept in
    ``built`` (the caller drops them when it has read them)."""

    def __init__(self):
        self.built = []

    def __enter__(self):
        runner = ep_runner()
        self.base = base = runner.CausalLM
        built = self.built

        class Recorded(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                built.append(self)

        runner.CausalLM = Recorded
        return self

    def __exit__(self, *exc):
        ep_runner().CausalLM = self.base
        return False


def ep_run(argv, dev, counters, params=None, config=None) -> dict:
    """One runner subcommand through ``main``: its report, the counters
    zeroed just before and read just after, wall seconds and the peak
    allocated bytes. A ``SystemExit`` of the runner fails the phase."""
    import torch

    cuda = torch.device(dev).type == "cuda"
    _free(dev)   # the previous cell's garbage out of the base
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    zero_launches(counters)
    t0 = time.perf_counter()
    try:
        report = ep_runner().main(list(argv) + ["--device", dev], params=params, config=config)
    except SystemExit as e:
        raise SmokeFailure(f"runner {' '.join(argv)} exited with {e.code!r}") from None
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    return dict(report=report, launches=launches, launches_by_route=routes_of(counters),
                wall_s=wall, peak_bytes=torch.cuda.max_memory_allocated() if cuda else 0,
                base_bytes=base)


def ep_kv_slab_bytes(cfg, layers: int, rows: int = 1) -> int:
    """K and V of ``rows`` slab rows at ``max_seq_len`` over ``layers``."""
    import torch

    item = torch.empty((), dtype=cfg.param_dtype).element_size()
    return 2 * layers * rows * cfg.max_seq_len * cfg.kv_heads() * cfg.head_dim_ * item


def ep_layer_bytes(params, layers: int) -> int:
    """Bytes of the first ``layers`` decoder layers of a state dict."""
    import re

    pat = re.compile(r"^model\.layers\.(\d+)\.")
    return sum(t.numel() * t.element_size() for n, t in params.items()
               if (m := pat.match(n)) and int(m.group(1)) < layers)


def _free(dev) -> None:
    import torch

    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def ep_b5_cases() -> list:
    """Phase 4p's B5 cases, as ``tpr_b5_cases``' tuples: every
    ``EP_B5_SHAPES`` x ``EP_B5_ROWS`` product in bf16 and fp32."""
    return [(f"{dtype}, {M} rows, {K} -> {N}", dtype, 1, M, K, N, 1, False, False)
            for dtype in ("bf16", "fp32") for K, N in EP_B5_SHAPES for M in EP_B5_ROWS]


def ep_kernel_check(dev) -> dict:
    """B5 on every ``ep_b5_cases`` case and B1 at ``EP_B1_INSERT``, each
    held by ``b5_case_held`` and ``b1_heads_held``. Returns the readings and
    a list of problems."""
    from neuronx_distributed_tpu_torch.models.llama import llama2_13b

    b5 = b5_cases_held(dev, ep_b5_cases())
    h, sq, sk, d = (EP_B1_INSERT[k] for k in ("h", "sq", "sk", "d"))
    b1 = b1_heads_held(dev, h, h, sq, d, llama2_13b, sk=sk, seed=37)
    _free(dev)
    problems = [p for r in b5.values() for p in r["problems"]] + b1["problems"]
    return dict(readings={"w8a16_gemm": b5, "flash_block_forward": b1}, problems=problems)


def ep_runner_cells(dev, counters, params, cfg, config=None) -> dict:
    """(r0), its greedy ``generate`` (the oracle of (r0 shell)), (r1), (r2)
    and (r4) over one seeded 13B tree ``params`` (``cfg`` its config;
    ``config``: handed to the runner, for a rehearsal on another model)."""
    out = {}
    out["r0"] = ep_run(EP_BENCH, dev, counters, params=params, config=config)
    out["r0_generate"] = ep_run(EP_GENERATE, dev, counters, params=params, config=config)
    _free(dev)
    out["r1"] = ep_run(EP_SERVE, dev, counters, params=params, config=config)
    _free(dev)
    spec = {}
    for name, extra in (("host", []), ("fused", ["--fused_rounds", str(EP_SPEC_ROUNDS)])):
        with _Recorded() as rec:
            spec[name] = ep_run(EP_SPEC + extra, dev, counters, params=params, config=config)
            target, draft = rec.built[0], rec.built[1]
            mine = {t.data_ptr() for t in target.model.state_dict().values()}
            theirs = draft.model.state_dict()
            spec[name]["draft_shared"] = all(t.data_ptr() in mine for t in theirs.values())
            spec[name]["draft_tensors"] = len(theirs)
            rec.built.clear()
        _free(dev)
    draft_layers = spec["host"]["report"]["draft_layers"]
    out["r2"] = dict(spec, draft_copy_bytes=ep_layer_bytes(params, draft_layers),
                     kv_bytes=2 * (ep_kv_slab_bytes(cfg, cfg.num_layers)
                                   + ep_kv_slab_bytes(cfg, draft_layers)))
    with _Recorded() as rec:
        out["r4"] = ep_run(EP_QUANT, dev, counters, params=params, config=config)
        out["r4"]["weight_bytes"] = ep_weight_bytes(rec.built[0].model.state_dict())
        rec.built.clear()
    out["bf16_weight_bytes"] = ep_weight_bytes(params)
    _free(dev)
    return out


def ep_check_config(layers: int = EP_CHECK_LAYERS):
    """(r3)'s model: the runner's Llama-2-13B config in fp32, cut in depth."""
    import torch

    runner = ep_runner()
    return dataclasses.replace(runner.build_config(runner.parse_args(["check-accuracy"])),
                               dtype=torch.float32, param_dtype=torch.float32,
                               num_layers=layers)


def ep_check_cell(dev, counters, cfg=None) -> dict:
    """(r3): check-accuracy at 13B widths in fp32 over seeded weights, cut
    to ``EP_CHECK_LAYERS`` layers through the ``config=`` seam; on the same
    model, greedy ``speculate`` (its default draft depth) and ``generate``.
    (r4 check): check-accuracy ``--quantize`` on the same weights, the
    int8-served logits against the fp32 forward of the dequantized ones.
    Returns both, by name."""
    import torch

    from neuronx_distributed_tpu_torch.models.llama import init_params

    cfg = cfg or ep_check_config()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    r3 = ep_run(EP_CHECK, dev, counters, params=params, config=cfg)
    r3["weight_bytes"] = ep_weight_bytes(params)
    r3["layers"] = cfg.num_layers
    # greedy speculation against greedy generate where the arithmetic is
    # fp32 (in bf16 the verify chunk and the decode step round apart)
    r3["generate"] = ep_run(EP_GENERATE, dev, counters, params=params, config=cfg)
    r3["speculate"] = ep_run(EP_SPEC, dev, counters, params=params, config=cfg)
    r4_check = ep_run(EP_CHECK + ["--quantize"], dev, counters, params=params, config=cfg)
    del params
    _free(dev)
    return {"r3": r3, "r4_check": r4_check}


def ep_snapshot(dev, path: str) -> int:
    """A snapshot of the tiny engine stopped after one block (JAX's
    recovery test's set-up): the tokens its completions hold."""
    from neuronx_distributed_tpu_torch.inference.engine import ServeEngine
    from neuronx_distributed_tpu_torch.inference.trace import synthetic_trace

    runner = ep_runner()
    args = runner.parse_args(["serve", "--tiny", "--max_batch", "2", "--device", dev])
    lm, cfg = runner.build_model(args)
    lm.compile()
    eng = ServeEngine(lm, block_steps=3, seed=0)
    for item in synthetic_trace(3, cfg.vocab_size, prompt_lens=(8,), max_new_tokens=9, seed=0):
        eng.submit(item["prompt"], item["max_new_tokens"])
    eng.run(max_blocks=1, snapshot_path=path, snapshot_every_blocks=1)
    pre = sum(len(c.tokens) for c in eng.completed)
    eng.close()
    return pre


EP_TINY = {
    "medusa": ["medusa", "--tiny", "--max_new_tokens", "6"],
    "replicas_crash": ["serve", "--tiny", "--max_batch", "2", "--num_requests", "6",
                       "--max_new_tokens", "6", "--fused_steps", "3", "--replicas", "2",
                       "--crash_replica_at", "2", "--tenants", "2", "--paged", "--page_size",
                       "4"],
    "disagg": ["serve", "--tiny", "--paged", "--page_size", "4", "--max_batch", "2",
               "--num_requests", "4", "--max_new_tokens", "6", "--fused_steps", "3",
               "--disagg", "--replicas", "2", "--prefill_replicas", "1",
               "--mean_interarrival", "2.0"],
    "adapters": ["serve", "--tiny", "--max_batch", "2", "--num_requests", "6",
                 "--max_new_tokens", "4", "--fused_steps", "3", "--adapters", "3",
                 "--adapter_rank", "4", "--adapter_pool_slots", "2", "--adapter_skew", "0.0",
                 "--mean_interarrival", "2.0"],
    "grammar": ["serve", "--tiny", "--max_batch", "2", "--num_requests", "6",
                "--max_new_tokens", "32", "--fused_steps", "4", "--grammar_frac", "0.75",
                "--grammars", "3", "--grammar_pool_slots", "3", "--mean_interarrival", "2.0"],
}


def ep_shell(dev) -> dict:
    """(r0 shell): ``EP_GENERATE`` as a process of its own, the runner's
    module run as ``python -m`` runs it (``EP_SHELL_BOOT``), alone on the
    card: its exit code, wall seconds, report lines and the runner's launch
    counts in it."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", EP_SHELL_BOOT, *EP_GENERATE, "--device", dev],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=EP_SHELL_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = out.splitlines()
    counts = [json.loads(ln[len("launches "):]) for ln in lines if ln.startswith("launches ")]
    return dict(returncode=proc.returncode, wall_s=time.perf_counter() - t0,
                report=[json.loads(ln) for ln in lines if ln.startswith("{")],
                launches=counts[-1] if counts else {}, stderr_tail=err[-2000:])


def ep_tiny_cells(dev, counters, root: Path) -> dict:
    """(r5): the ``--tiny`` runner cases on ``dev`` (each read by
    :func:`ep_tiny_problems` as its JAX test reads it) and the snapshot
    recovery."""
    out = {name: ep_run(argv, dev, counters) for name, argv in EP_TINY.items()}
    snap = str(root / "serve.snap")
    pre = ep_snapshot(dev, snap)
    out["snapshot"] = ep_run(["serve", "--tiny", "--max_batch", "2", "--fused_steps", "3",
                              "--snapshot_path", snap], dev, counters)
    out["snapshot"].update(pre_tokens=pre, file_left=os.path.exists(snap))
    return out


def ep_fit_config(layers: int = EP_FIT_LAYERS, seq: int = EP_FIT_SEQ):
    import torch

    from neuronx_distributed_tpu_torch.models.llama import llama2_7b

    return llama2_7b(max_seq_len=seq, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                     remat_policy="attention", num_layers=layers)


def ep_fit_module(cfg, accum: int = 1):
    """A ``NxDLightningModule`` over ``cfg``: ZeRO-1, clipping at 1.0,
    fp32 masters (the fit loop's defaults), ``grad_accum_steps`` ``accum``."""
    from neuronx_distributed_tpu_torch.lightning import NxDLightningModule
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM
    from neuronx_distributed_tpu_torch.trainer import neuronx_distributed_config

    class FitModule(NxDLightningModule):
        def configure_model(self):
            return LlamaForCausalLM(cfg)

        def model_inputs(self, batch):
            return (batch["ids"],)

        def training_loss(self, model, params, batch, rng):
            return model.apply(params, batch["ids"], batch["labels"], method="loss")

    return FitModule(neuronx_distributed_config(tensor_parallel_size=1),
                     learning_rate=EP_FIT_LR, weight_decay=0.01, grad_accum_steps=accum)


def ep_fit(dev, counters, root: Path, cfg=None, batch: int = EP_FIT_BATCH,
           steps: int = EP_FIT_STEPS, kill_at: int = EP_FIT_KILL) -> dict:
    """(l0): a straight ``steps``-step fit; a fit that SIGTERM stops at
    ``kill_at`` (its preemption checkpoint) and a fresh trainer resuming it
    to ``steps``; a ``grad_accum_steps=2`` fit. Each step's wall time ends on
    a device sync (a callback's); counters zeroed before the first fit and
    read after the last."""
    import signal as _signal

    import torch

    from neuronx_distributed_tpu_torch.examples.common import synthetic_lm_batches
    from neuronx_distributed_tpu_torch.lightning import Callback, NxDTrainer

    cfg = cfg or ep_fit_config()
    cuda = torch.device(dev).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    class Watch(Callback):
        def __init__(self, kill=None, track=False):
            self.kill, self.track = kill, track
            self.ms, self.losses, self.moved, self.prev = [], [], [], None
            self.t = None

        def on_train_start(self, trainer, module):
            sync()
            self.t = time.perf_counter()
            if self.track:
                self.prev = {n: t.clone() for n, t in trainer.state.params.items()}

        def on_step_end(self, trainer, module, step, metrics):
            sync()
            now = time.perf_counter()
            self.ms.append((now - self.t) * 1e3)
            self.losses.append(float(metrics["loss"]))
            if self.track:
                cur = trainer.state.params
                self.moved.append(not all(torch.equal(cur[n], self.prev[n]) for n in cur))
                self.prev = {n: t.clone() for n, t in cur.items()}
            if step == self.kill:
                os.kill(os.getpid(), _signal.SIGTERM)
            self.t = time.perf_counter()

    def fit(max_steps, accum=1, ckpt=None, watch=None):
        trainer = NxDTrainer(max_steps=max_steps, checkpoint_dir=ckpt, callbacks=[watch],
                             device=dev)
        t0 = time.perf_counter()
        state, _ = trainer.fit(ep_fit_module(cfg, accum),
                               synthetic_lm_batches(cfg.vocab_size, batch, cfg.max_seq_len))
        return trainer, state, time.perf_counter() - t0

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    zero_launches(counters)
    straight = Watch()
    _, state, straight_s = fit(steps, watch=straight)
    want = {n: t.clone() for n, t in state.params.items()}
    n_params = sum(t.numel() for t in want.values())
    del state
    ckpt = str(root / "fit_ckpt")
    before = _signal.getsignal(_signal.SIGTERM)
    first = Watch(kill=kill_at)
    pre, _, pre_s = fit(steps, ckpt=ckpt, watch=first)
    preempted, pre_step = pre.preempted, int(pre.state.step)
    ckpt_ms = pre._m_ckpt.sum
    del pre
    restored = _signal.getsignal(_signal.SIGTERM) == before
    resumed_w = Watch()
    res, state, res_s = fit(steps, ckpt=ckpt, watch=resumed_w)
    equal = all(torch.equal(state.params[n], want[n]) for n in want)
    resumed_at = steps - len(resumed_w.losses)
    del res, state, want
    gc.collect()
    accum = Watch(track=True)
    acc, state, acc_s = fit(steps, accum=2, watch=accum)
    opt = state.opt_state
    accum_state = dict(mini_step=opt.mini_step, gradient_step=opt.gradient_step,
                       inner_count=int(opt.inner_opt_state.count))
    del acc, state, opt
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    total = torch.cuda.mem_get_info()[1] if cuda else 0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return dict(layers=cfg.num_layers, params=n_params, batch=batch, seq=cfg.max_seq_len,
                steps=steps, kill_at=kill_at, straight_ms=straight.ms, straight_losses=straight.losses,
                straight_s=straight_s, preempted=preempted, preempted_at=pre_step,
                preempt_s=pre_s, checkpoint_ms=ckpt_ms, disposition_restored=restored,
                resumed_at=resumed_at, resumed_losses=resumed_w.losses, resumed_ms=resumed_w.ms,
                resumed_s=res_s, resumed_equal=equal, accum_moved=accum.moved,
                accum_losses=accum.losses, accum_ms=accum.ms, accum_s=acc_s,
                accum_state=accum_state, launches=launches, peak_bytes=peak, card_bytes=total)


def ep_equal_share(a, b) -> float:
    """The share of positions where two token streams agree."""
    return sum(x == y for x, y in zip(a, b)) / max(len(a), len(b), 1)


def ep_first_diff(a, b) -> int:
    """The first position where two token streams differ (-1: none)."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                -1 if len(a) == len(b) else min(len(a), len(b)))


def ep_runner_problems(st: dict, kernels: bool = True) -> list:
    """The gates of (r0)-(r4) on their readings (empty: all held);
    ``kernels=False`` leaves out the launch and memory gates (a CPU
    rehearsal)."""
    bad = []
    want = lambda cond, msg: None if cond else bad.append(msg)  # noqa: E731
    r0, r1, r2, r3, r4 = (st[k] for k in ("r0", "r1", "r2", "r3", "r4"))
    rep = r0["report"]
    want(not kernels or r0["launches"].get("flash_block_forward", 0) > 0,
         "(r0) never launched flash_fwd")
    want(all(rep[k]["p50_ms"] > 0 for k in ("context_encoding", "token_generation",
                                            "token_generation_fused")),
         "(r0): a latency percentile is not positive")
    k = int(EP_BENCH[EP_BENCH.index("--fused_chunk") + 1])
    want(rep.get("fused_chunk") == k, f"(r0): fused_chunk {rep.get('fused_chunk')}, not {k}")
    rep = r1["report"]
    n = int(EP_SERVE[EP_SERVE.index("--num_requests") + 1])
    want(rep["requests_completed"] == n, f"(r1) completed {rep['requests_completed']} of {n}")
    want(rep.get("prefix_hit_tokens", 0) > 0, "(r1): no prefix hit")
    if kernels:
        for name in ("flash_block_forward", "paged_decode_attention"):
            want(r1["launches"].get(name, 0) > 0, f"(r1) never launched {name}")
        want(r1["peak_bytes"] < st["card_bytes"], f"(r1): peak {r1['peak_bytes']} bytes")
    want(r2["host"]["report"]["generated"] == r2["fused"]["report"]["generated"],
         "(r2): the fused rounds' tokens differ from the host loop's")
    for name in ("host", "fused"):
        s = r2[name]
        want(s["draft_shared"], f"(r2 {name}): the draft holds tensors of its own")
        extra = s["peak_bytes"] - s["base_bytes"]
        want(not kernels or extra < r2["kv_bytes"] + 0.8 * r2["draft_copy_bytes"],
             f"(r2 {name}): {extra} bytes over the weights, past the KV "
             f"{r2['kv_bytes']} and most of a draft copy {r2['draft_copy_bytes']}")
    sh = st["r0_shell"]
    want(sh["returncode"] == 0, f"(r0 shell) exited {sh['returncode']}: "
                                f"{sh['stderr_tail'][-500:]}")
    want(sh["report"] == st["r0_generate"]["report"],
         f"(r0 shell): {sh['report']} against {st['r0_generate']['report']}")
    want(not kernels or sh["launches"].get("flash_block_forward", 0) > 0,
         f"(r0 shell) never launched flash_fwd: {sh['launches']}")
    want(r3["speculate"]["report"]["generated"] == r3["generate"]["report"][0]["generated"],
         "(r3): fp32 speculation's tokens differ from greedy generate's")
    for name, c in (("r3", r3), ("r4 check", st["r4_check"])):
        rep = c["report"]
        want(rep["greedy_match"] is True, f"({name}): greedy diverges at "
                                          f"{rep['first_divergence']}")
        want(rep["logit_max_abs_diff"] < EP_CHECK_TOL,
             f"({name}): logit max |diff| {rep['logit_max_abs_diff']} (tol {EP_CHECK_TOL})")
    for name, c in (("r4", r4), ("r4 check", st["r4_check"])):
        want(not kernels or c["launches"].get("w8a16_gemm", 0) > 0,
             f"({name}) never launched w8a16_gemm")
    wb, bf16 = r4["weight_bytes"], st["bf16_weight_bytes"]["total"]
    want(wb.get("int8", 0) >= 0.9 * wb["total"] and wb["total"] <= 0.55 * bf16,
         f"(r4): weight bytes {wb} against bf16 {bf16}")
    want(len(r4["report"][0]["generated"]) == 32, "(r4): not 32 tokens")
    return bad


def ep_tiny_problems(st: dict) -> list:
    """(r5)'s gates: each case as its JAX test holds it."""
    bad = []
    want = lambda cond, msg: None if cond else bad.append(msg)  # noqa: E731
    m = st["medusa"]["report"]
    want(len(m["generated"]) == 6 and m["matches_base_greedy"] is True
         and m["tree_ms_p50"] is not None, f"(r5 medusa): {m}")
    r = st["replicas_crash"]["report"]
    states = {s["replica"]: s["state"] for s in r["replica_states"]}
    want(r["replicas"] == 2 and r["placement"] == "affinity" and r["requests_completed"] == 6
         and r["total_generated_tokens"] == 36 and r["crashes"] == 1 and r["failovers"] == 1
         and r["last_failover_ms"] is not None and states == {0: "live", 1: "dead"}
         and sum(t["requests"] for t in r["per_tenant"].values()) == 6,
         "(r5 replicas_crash): " + json.dumps({k: r.get(k) for k in (
             "replicas", "requests_completed", "total_generated_tokens", "crashes",
             "failovers")}))
    d = st["disagg"]["report"]
    roles = {s["replica"]: s["role"] for s in d["replica_states"]}
    want(d["disagg"] is True and d["prefill_replicas"] == 1 and d["decode_replicas"] == 1
         and d["requests_completed"] == 4 and d["total_generated_tokens"] == 24
         and d["handoffs_sent"] == d["handoffs_adopted"] == 4 and d["handoffs_degraded"] == 0
         and d["handoff_pages"] >= 4 and d["itl_p99_ms_decode_clock"] is not None
         and roles == {0: "prefill", 1: "decode"}, "(r5 disagg): " + json.dumps(
             {k: d.get(k) for k in ("requests_completed", "handoffs_sent", "handoffs_adopted",
                                    "handoffs_degraded", "handoff_pages")}))
    a = st["adapters"]["report"]
    want(a["multilora"] is True and a["adapter_slots"] == 2
         and a["requests_completed"] + a["rejected"] == 6
         and a["total_generated_tokens"] == a["requests_completed"] * 4
         and a["adapter_loads"] >= 2 and a["adapter_evictions"] >= 1
         and a["adapter_rejects"] == a["rejected"] and a["adapter_load_failures"] == 0
         and a["adapter_bytes_per_slot"] > 0, "(r5 adapters): " + json.dumps(
             {k: a.get(k) for k in ("requests_completed", "rejected", "adapter_loads",
                                    "adapter_evictions", "adapter_rejects")}))
    g = st["grammar"]["report"]
    s = g["structured"]
    want(g["requests_completed"] == 6 and s["constrained_requests"] >= 2
         and s["grammar_slots"] == 3 and s["grammar_loads"] >= 3
         and s["grammar_evictions"] >= 1 and s["grammar_rejects"] == 0
         and set(s["finish_reasons"]) <= {"grammar_accept", "budget", "eos"}
         and s["finish_reasons"].get("grammar_accept", 0) >= 1
         and s["freeform"]["requests"] + s["constrained_requests"] == 6,
         "(r5 grammar): " + json.dumps({k: s.get(k) for k in (
             "constrained_requests", "grammar_loads", "grammar_evictions", "finish_reasons")}))
    sn = st["snapshot"]
    rep = sn["report"]
    want(rep["recovered"] is True and rep["restored_requests"] >= 1 and not sn["file_left"]
         and sn["pre_tokens"] + rep["total_generated_tokens"] == 27,
         f"(r5 snapshot): {rep}, tokens before the crash {sn['pre_tokens']}")
    return bad


def ep_fit_problems(l0: dict, kernels: bool = True) -> list:
    """(l0)'s gates; ``kernels=False`` leaves out the launch and memory
    gates (a CPU rehearsal)."""
    bad = []
    want = lambda cond, msg: None if cond else bad.append(msg)  # noqa: E731
    n, k = l0["steps"], l0["kill_at"]
    want(len(l0["straight_losses"]) == n and all(map(math.isfinite, l0["straight_losses"])),
         f"(l0): straight losses {l0['straight_losses']}")
    want(l0["preempted"] and l0["preempted_at"] == k, f"(l0): preempted "
                                                      f"{l0['preempted']} at {l0['preempted_at']}")
    want(l0["disposition_restored"], "(l0): the SIGTERM disposition was not restored")
    want(l0["resumed_at"] == k and l0["resumed_losses"] == l0["straight_losses"][k:],
         f"(l0): resumed at {l0['resumed_at']} with losses {l0['resumed_losses']}")
    want(l0["resumed_equal"], "(l0): the resumed params differ from the straight run's")
    want(l0["accum_moved"] == [i % 2 == 1 for i in range(n)],
         f"(l0): with grad_accum_steps=2 the params moved at {l0['accum_moved']}")
    want(l0["accum_state"]["inner_count"] == n // 2 and l0["accum_state"]["mini_step"] == 0,
         f"(l0): accumulation state {l0['accum_state']}")
    if kernels:
        for name in EP_FIT_COUNTERS:
            want(l0["launches"].get(name, 0) > 0, f"(l0) never launched {name}")
        want(l0["peak_bytes"] < l0["card_bytes"], f"(l0): peak {l0['peak_bytes']} bytes")
    return bad


def run_entry_points_phase(dev, counters, dump=None) -> dict:
    """Phase 4p: B5 and B1 held at the runner's 13B shapes, (r0)-(r4) over
    one seeded Llama-2-13B tree, (r0 shell) the runner's process alone on
    the card, (r3) and (r4 check) at fp32 and 10 layers, (r5) the tiny
    cases, (l0) the fit loop; every gate. ``counters``: B1, B2, B5 (the
    runner's) then B1, B3a, B3b, B4 (the fit loop's), by ``__name__``.
    ``dump``: a path the readings are written to before the gates are held."""
    import torch

    from neuronx_distributed_tpu_torch.models.llama import init_params

    by_name = {c.__name__: c for c in counters}
    run_c = tuple(by_name[n] for n in EP_RUNNER_COUNTERS)
    fit_c = tuple(by_name[n] for n in EP_FIT_COUNTERS)
    t0 = time.perf_counter()
    kernels = ep_kernel_check(dev)
    out = dict(kernels=kernels["readings"], kernels_s=time.perf_counter() - t0)
    runner = ep_runner()
    cfg = runner.build_config(runner.parse_args(["generate"]))
    t1 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    out.update(init_s=time.perf_counter() - t1, card_bytes=torch.cuda.mem_get_info()[1])
    out.update(ep_runner_cells(dev, run_c, params, cfg))
    del params
    _free(dev)
    out["r0_shell"] = ep_shell(dev)   # nothing else of this process runs meanwhile
    out.update(ep_check_cell(dev, run_c))
    with tempfile.TemporaryDirectory() as tmp:
        out["r5"] = ep_tiny_cells(dev, run_c, Path(tmp))
    _free(dev)
    with tempfile.TemporaryDirectory() as tmp:
        out["l0"] = ep_fit(dev, fit_c, Path(tmp))
    problems = (kernels["problems"] + ep_runner_problems(out) + ep_tiny_problems(out["r5"])
                + ep_fit_problems(out["l0"]))
    if dump is not None:
        Path(dump).parent.mkdir(parents=True, exist_ok=True)
        Path(dump).write_text(json.dumps({**out, "problems": problems}, default=str))
    check(not problems, "entry points phase: " + "; ".join(problems))
    return dict(out, phase_s=time.perf_counter() - t0)


def ep_launches_by_path(st: dict) -> dict:
    """The phase's launches by path for the kernels line: each path with
    the kernels it launched (the gates hold which it must)."""
    out = {f"entry_{c}": st[c]["launches"]
           for c in ("r0", "r0_generate", "r0_shell", "r1", "r3", "r4", "r4_check")}
    out.update({f"entry_r3_{n}": st["r3"][n]["launches"] for n in ("generate", "speculate")})
    out.update({f"entry_r2_{n}": st["r2"][n]["launches"] for n in ("host", "fused")})
    out["entry_l0"] = st["l0"]["launches"]
    out.update({f"entry_r5_{c}": r["launches"] for c, r in st["r5"].items() if "launches" in r})
    out = {path: {k: v for k, v in counts.items() if v} for path, counts in out.items()}
    return {path: counts for path, counts in out.items() if counts}


def print_entry_points(st: dict, card: str) -> None:
    kr = st["kernels"]
    b5 = kr["w8a16_gemm"]
    worst = max(b5, key=lambda c: b5[c]["floor_needed"] / b5[c]["floor"])
    b1 = kr["flash_block_forward"]
    print(f"entry kernels: w8a16_gemm held at the runner's 13B shapes ({len(b5)} cases: "
          f"{', '.join(f'{k} -> {n}' for k, n in EP_B5_SHAPES)} at {EP_B5_ROWS} rows, bf16 and "
          f"fp32; routes {sorted({r['route'] for r in b5.values()})}), every case within its "
          f"floor, the nearest {worst} (needs {b5[worst]['floor_needed']:.3g} of "
          f"{b5[worst]['floor']:.3g}); flash_fwd at the 2048 bucket's insert ({b1['shape']}) "
          f"needs {b1['floor_needed']:.3g} of {b1['floor']:.3g} (median |ref| "
          f"{b1['median_abs_ref']:.3g}), LSE {b1['lse_max_abs_err']:.3g}; "
          f"{st['kernels_s']:.1f} s [{card}]", flush=True)
    r0 = st["r0"]["report"]
    pct = lambda d: f"p50 {d['p50_ms']} p99 {d['p99_ms']} ms"  # noqa: E731
    print(f"entry (r0): runner benchmark, llama2_13b full width and depth (40 layers, bf16 "
          f"seeded weights, init {st['init_s']:.1f} s), batch {r0['batch']}, prompt "
          f"{r0['prompt_len']} tokens: context encoding {pct(r0['context_encoding'])}, token "
          f"generation {pct(r0['token_generation'])} = {r0['decode_tokens_per_sec']} tok/s, "
          f"fused (K {r0['fused_chunk']}) {pct(r0['token_generation_fused'])} a token = "
          f"{r0['decode_tokens_per_sec_fused']} tok/s; wall {st['r0']['wall_s']:.1f} s, peak "
          f"{st['r0']['peak_bytes']} bytes, launches {json.dumps(st['r0']['launches'])} "
          f"[{card}]", flush=True)
    sh = st["r0_shell"]
    print(f"entry (r0 shell): `python -m neuronx_distributed_tpu_torch.examples.runner "
          f"{' '.join(EP_GENERATE)}` (llama2_13b, its own seeded init) alone on the card: exit "
          f"{sh['returncode']} in {sh['wall_s']:.1f} s, tokens equal to this process's greedy "
          f"generate on the same seeded weights {sh['report'] == st['r0_generate']['report']}, "
          f"launches {json.dumps(sh['launches'])} [{card}]", flush=True)
    r1 = st["r1"]["report"]
    print(f"entry (r1): runner serve --paged --paged-kernel --async, llama2_13b, max_batch "
          f"{r1['max_batch']}, {r1['requests_completed']} of {r1['num_requests']} requests, "
          f"{r1['total_generated_tokens']} tokens in {r1['wall_s']} s = {r1['tokens_per_sec']} "
          f"tok/s, TTFT blocks mean {r1.get('ttft_blocks_mean')}, itl p50 {r1.get('itl_p50_ms')} "
          f"p99 {r1.get('itl_p99_ms')} ms, prefix hit tokens {r1.get('prefix_hit_tokens')}, "
          f"decode blocks {r1.get('decode_blocks')}, KV pool {r1.get('kv_hbm_bytes')} bytes, "
          f"peak {st['r1']['peak_bytes']} of {st['card_bytes']} bytes, launches "
          f"{json.dumps(st['r1']['launches'])} [{card}]", flush=True)
    r2 = st["r2"]
    oracle = st["r0_generate"]["report"][0]["generated"]
    for name in ("host", "fused"):
        s = r2[name]
        rep = s["report"]
        print(f"entry (r2 {name}): runner speculate, llama2_13b target, draft its first "
              f"{rep['draft_layers']} layers (shared tensors {s['draft_shared']}), num_draft "
              f"{rep['num_draft']}: {rep['tokens_per_sec']} tok/s, acceptance "
              f"{rep['acceptance_rate']}, tokens a round {rep['tokens_per_round']}, tokens "
              f"equal to greedy generate's {ep_equal_share(rep['generated'], oracle)} (first "
              f"differing {ep_first_diff(rep['generated'], oracle)}), "
              f"{s['peak_bytes'] - s['base_bytes']} bytes over the weights (KV "
              f"{r2['kv_bytes']}, a draft copy would be {r2['draft_copy_bytes']}), launches "
              f"{json.dumps(s['launches'])} [{card}]", flush=True)
    r3 = st["r3"]["report"]
    print(f"entry (r3): runner check-accuracy, llama2_13b widths fp32 at {st['r3']['layers']} "
          f"of 40 layers ({st['r3']['weight_bytes']['total']} weight bytes): greedy match "
          f"{r3['greedy_match']} over {r3['generated']} tokens, logit max |diff| "
          f"{r3['logit_max_abs_diff']} mean {r3['logit_mean_abs_diff']} (tol {EP_CHECK_TOL}) "
          f"over {r3['positions_checked']} positions, launches {json.dumps(st['r3']['launches'])};"
          f" greedy speculate (draft {st['r3']['speculate']['report']['draft_layers']} layers, "
          f"acceptance {st['r3']['speculate']['report']['acceptance_rate']}) tokens equal to "
          f"greedy generate's {ep_equal_share(st['r3']['speculate']['report']['generated'], st['r3']['generate']['report'][0]['generated'])}"
          f" [{card}]", flush=True)
    r4 = st["r4"]
    print(f"entry (r4): runner generate --quantize, llama2_13b, weight bytes "
          f"{json.dumps(r4['weight_bytes'])} against bf16 {st['bf16_weight_bytes']['total']}, "
          f"wall {r4['wall_s']:.1f} s, launches {json.dumps(r4['launches'])}, B5 by route "
          f"{json.dumps(r4['launches_by_route'].get('w8a16_gemm'))} [{card}]", flush=True)
    r4c = st["r4_check"]["report"]
    print(f"entry (r4 check): runner check-accuracy --quantize, (r3)'s fp32 weights at "
          f"{st['r3']['layers']} layers served int8 against the fp32 forward of the dequantized "
          f"weights: greedy match {r4c['greedy_match']} over {r4c['generated']} tokens, logit "
          f"max |diff| {r4c['logit_max_abs_diff']} mean {r4c['logit_mean_abs_diff']} (tol "
          f"{EP_CHECK_TOL}) over {r4c['positions_checked']} positions, launches "
          f"{json.dumps(st['r4_check']['launches'])}, B5 by route "
          f"{json.dumps(st['r4_check']['launches_by_route'].get('w8a16_gemm'))} [{card}]",
          flush=True)
    r5 = st["r5"]
    print(f"entry (r5): tiny runner cases on the card, each as its JAX test holds it: "
          + ", ".join(f"{n} {r5[n]['wall_s']:.1f} s" for n in (*EP_TINY, "snapshot"))
          + f" [{card}]", flush=True)
    lo = st["l0"]
    ms = lambda xs: "/".join(f"{x:.0f}" for x in xs)  # noqa: E731
    print(f"entry (l0): lightning fit, llama2_7b widths at {lo['layers']} of 32 layers "
          f"({lo['params']} params), {lo['batch']} x {lo['seq']} tokens a step, bf16 + fp32 "
          f"masters, ZeRO-1, clipping 1.0: step ms {ms(lo['straight_ms'])} (the first builds), "
          f"losses {[round(x, 4) for x in lo['straight_losses']]}; SIGTERM at step "
          f"{lo['preempted_at']}: preemption checkpoint {lo['checkpoint_ms']:.0f} ms, resumed "
          f"run equal bit for bit {lo['resumed_equal']} (fit {lo['resumed_s']:.1f} s incl. the "
          f"load); grad_accum_steps=2: params moved {lo['accum_moved']}, step ms "
          f"{ms(lo['accum_ms'])}; peak {lo['peak_bytes']} bytes, launches "
          f"{json.dumps(lo['launches'])}; phase {st['phase_s']:.1f} s [{card}]", flush=True)


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="PATH",
                        help="also serve the workload and take one training step under "
                             "torch.profiler; write their kernel tables to PATH and to PATH "
                             "with _train added to its name")
    # one rank of phase 4j's (t2), started by the phase itself
    parser.add_argument("--tp-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--tp-world", type=int, default=TP_WORLD, help=argparse.SUPPRESS)
    parser.add_argument("--tp-port", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--tp-out", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--tp-layers", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--tp-parts", default="t2,rest", help=argparse.SUPPRESS)
    # one rank of phase 4l's (d1)/(d2), started by the phase itself
    parser.add_argument("--dist-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--dist-world", type=int, default=DIST_WORLD, help=argparse.SUPPRESS)
    parser.add_argument("--dist-port", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--dist-out", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--dist-layers", type=int, default=DIST_LAYERS, help=argparse.SUPPRESS)
    parser.add_argument("--dist-dir", default=None, help=argparse.SUPPRESS)
    # one rank of phase 4m's (c1), (c2), (p1)-(p3), started by the phase itself
    parser.add_argument("--cppp-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--cppp-world", type=int, default=CPPP_WORLD, help=argparse.SUPPRESS)
    parser.add_argument("--cppp-port", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--cppp-out", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--cppp-dir", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--cppp-layers", type=int, default=CP_LAYERS, help=argparse.SUPPRESS)
    # one rank of phase 4n's (m1)/(m2), started by the phase itself
    parser.add_argument("--moe-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--moe-world", type=int, default=MOE_WORLD, help=argparse.SUPPRESS)
    parser.add_argument("--moe-port", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--moe-out", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--moe-dir", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--moe-layers", type=int, default=MOE_LAYERS, help=argparse.SUPPRESS)
    # one rank of phase 4o's (n1)/(n2), started by the phase itself
    parser.add_argument("--fam-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--fam-world", type=int, default=FAM_WORLD, help=argparse.SUPPRESS)
    parser.add_argument("--fam-port", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--fam-out", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--fam-layers", type=int, default=FAM_NEOX_LAYERS, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import neuronx_distributed_tpu_torch as port

    if Path(port.__file__).resolve().parent.parent != ROOT:
        print(f"chip_smoke: imported the port from {port.__file__}, not from {ROOT}",
              file=sys.stderr)
        return 1
    if args.tp_rank is not None:
        return tp_child(args.tp_rank, args.tp_world, args.tp_port, args.tp_out, args.tp_layers,
                        tuple(args.tp_parts.split(",")))
    if args.dist_rank is not None:
        return dist_child(args.dist_rank, args.dist_world, args.dist_port, args.dist_out,
                          args.dist_layers, args.dist_dir)
    if args.cppp_rank is not None:
        return cppp_child(args.cppp_rank, args.cppp_world, args.cppp_port, args.cppp_out,
                          args.cppp_dir, cp_layers=args.cppp_layers)
    if args.moe_rank is not None:
        return moe_child(args.moe_rank, args.moe_world, args.moe_port, args.moe_out,
                         args.moe_dir, layers=args.moe_layers)
    if args.fam_rank is not None:
        return fam_child(args.fam_rank, args.fam_world, args.fam_port, args.fam_out,
                         layers=args.fam_layers)
    from neuronx_distributed_tpu_torch.inference.paged_kernel import paged_decode_attention
    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.kernels.flash_attn import (
        flash_block_forward,
        flash_bwd_dkdv,
        flash_bwd_dq,
    )
    from neuronx_distributed_tpu_torch.kernels.w8a16 import w8a16_gemm
    from neuronx_distributed_tpu_torch.models.llama import init_params
    from neuronx_distributed_tpu_torch.optimizer.fused_kernel import fused_adamw_leaf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          + ", ".join(f"{n} {s:.1f} s" for n, s in _build.build_seconds.items())
          + f" [{card}]", flush=True)
    compiled, reports = {}, {}
    for source in ("flash_fwd", "flash_bwd", "w8a16_gemm"):
        report = compile_report(source)
        print(f"compiled {source}: " + "; ".join(
            f"{k} {v.get('registers')} registers, {v.get('static_smem_bytes')} static + "
            f"{v.get('dynamic_smem_bytes', 0)} dynamic smem bytes, {v.get('spill_bytes')} spill "
            f"bytes, {v['hmma']} HMMA, {v['hgmma']} HGMMA"
            for k, v in sorted(report.items())) + f" [{card}]", flush=True)
        compile_gates(report)   # the bf16 routes: tensor-core products, no spills
        compiled.update(report)
        reports[source] = report
    check(all(f"tc::wgmma_kernel<{mw}>" in compiled for mw in (1, 2)),
          f"B5's prefill kernels are missing from {sorted(compiled)}")
    wide = ("tc::fwd_kernel<256>", "tc::dkdv_kernel<256>", "tc::dq_kernel<256>")
    check(all(k in compiled for k in wide), f"the 256-wide builds are missing from {sorted(compiled)}")
    nxdcheck = run_nxdcheck_phase(card)   # phase 4s: static, no kernel

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)   # 256 MB > L2
    flash = run_flash(dev, flush)
    flash["chunk_shape"] = run_flash_chunk(dev, flush)
    cs = flash["chunk_shape"]
    print(f"kernel flash_fwd at the chunk shape: {cs['shape']}; {cs['ms']:.4f} ms, twin "
          f"{cs['plain_ms']:.4f} ms, library {cs['library_ms']:.4f} ms ({cs['library']}), bound "
          f"{cs['bound_ms']:.4f} ms ({cs['bound_by']}); out max |err| {cs['max_abs_err']:.3g}, "
          f"floor needed {cs['held']['out']['floor_needed']:.3g} of "
          f"{cs['held']['out']['floor']:.3g}, lse max |err| {cs['lse_max_abs_err']:.3g} "
          f"[{card}]", flush=True)
    bwd, flash["train_shape"] = run_flash_bwd(dev, flush)
    flash["train_shape_max_abs_err"] = flash["train_shape"]["max_abs_err"]
    ts = flash["train_shape"]
    print(f"kernel flash_fwd at the training shape: {ts['shape']}; {ts['ms']:.4f} ms, "
          f"{ts['tflops']:.1f} TFLOP/s, {ts['bound_share']:.1%} of bound, twin "
          f"{ts['plain_ms']:.4f} ms, library {ts['library_ms']:.4f} ms ({ts['library']}), bound "
          f"{ts['bound_ms']:.4f} ms ({ts['bound_by']}) [{card}]", flush=True)
    flash["compiled"] = {n: v for n, v in compiled.items() if "fwd_kernel" in n}
    for k in bwd:
        k["compiled"] = {n: v for n, v in compiled.items() if k["name"][len("flash_bwd_"):] in n}
    kernels = [flash, run_paged(dev, flush), *bwd, run_adamw(dev, flush), run_w8a16(dev, flush)]
    kernels[-1]["compiled"] = reports["w8a16_gemm"]
    for case, t in kernels[-1]["cases"].items():
        print(f"kernel w8a16_gemm ({case}): {w8a16_line(t)} [{card}]", flush=True)
    head_dims = run_head_dims(dev, flush)
    family_kernels, problems = run_family_kernels(dev, flush)
    print_family_kernels(family_kernels, card)
    check(not problems, "family kernels: " + "; ".join(problems))
    paged_names = ("paged bf16", "paged int8", "paged fp32")
    for d, r in head_dims.items():
        for names in (("out", "lse", "dq", "dk", "dv"),
                      tuple(n for n in paged_names if n in r["held"])):
            at = r["flash_shape"] if names[0] == "out" else r["paged_shape"]
            print(f"  held at head_dim {d}, {at}: " + "; ".join(
                f"{n} max |err| {r['held'][n]['max_abs_err']:.3g}" + (
                    f", floor needed {r['held'][n]['floor_needed']:.3g} of "
                    f"{r['held'][n]['floor']:.3g}, median |ref| "
                    f"{r['held'][n]['median_abs_ref']:.3g}" if "floor" in r["held"][n]
                    else f" (tol {r['held'][n]['tolerance']})") for n in names)
                  + f" [{card}]", flush=True)
    for k in kernels:
        names = {"flash_fwd": ("out", "lse"), "paged_decode": paged_names,
                 "flash_bwd_dkdv": ("dk", "dv"), "flash_bwd_dq": ("dq",)}.get(k["name"])
        if names:
            k["head_dims"] = {d: {n: r["held"][n] for n in names if n in r["held"]}
                              for d, r in head_dims.items()}
            # the 256-wide build of this kernel: its readings at head_dim 256
            t = head_dims[256]["timed"][k["name"]]
            k["instantiations"] = [dict(
                head_dim=256, shape=t["shape"], ms=t["ms"], plain_ms=t["plain_ms"],
                library_ms=t["library_ms"], library=t["library"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"],
                max_abs_err=max(k["head_dims"][256][n]["max_abs_err"] for n in names
                                if n in k["head_dims"][256]),
                compiled={n: v for n, v in compiled.items()
                          if n.endswith("<256>") and k["name"].split("_")[-1] in n})]
            print(f"kernel {k['name']} at head_dim 256: {t['shape']}; {t['ms']:.4f} ms, twin "
                  f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms ({t['library']}), "
                  f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}) [{card}]", flush=True)
    for k in kernels:   # B1, B3a and B3b at the families' shapes (phase 4o's layers)
        if k["name"] in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
            k["family_shapes"] = {case: dict(shape=r["shape"], **r["timed"][k["name"]])
                                  for case, r in family_kernels.items()}
    for k in kernels:
        extra = (f", {k['tflops']:.1f} TFLOP/s, {k['bound_share']:.1%} of bound"
                 if "tflops" in k else "")
        print(f"kernel {k['name']}: {k['shape']}; max_abs_err {k['max_abs_err']:.3g} "
              f"(tol {k['tolerance']}); {k['ms']:.4f} ms, twin {k['plain_ms']:.4f} ms, "
              f"library {k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']}){extra} [{card}]", flush=True)
        for entry in (k, k.get("train_shape", {})):
            for case, names in entry.get("held", {}).items():
                at = entry["ragged_shape"] if case == "ragged" else entry.get(
                    "case_shapes", {}).get(case, entry["shape"])
                print(f"  held at {at} ({case}): " + "; ".join(
                    f"{n} max |err| {r['max_abs_err']:.3g}" + (
                        f", floor needed {r['floor_needed']:.3g} of {r['floor']:.3g}, median "
                        f"|ref| {r['median_abs_ref']:.3g}, rms |ref| {r['rms_ref']:.3g}"
                        if "floor" in r else f" (tol {r['tolerance']})") + (
                        f" (vs twin alone {r['floor_needed_vs_twin']:.3g}; vs fp64: kernel "
                        f"max |err| {r['vs_exact']['kernel']['max_abs_err']:.3g} floor needed "
                        f"{r['vs_exact']['kernel']['floor_needed']:.3g}, twin "
                        f"{r['vs_exact']['twin']['max_abs_err']:.3g} / "
                        f"{r['vs_exact']['twin']['floor_needed']:.3g})"
                        if "vs_exact" in r else "")
                    for n, r in names.items()) + f" [{card}]", flush=True)
    del flush
    gc.collect()
    torch.cuda.empty_cache()

    worst = reference_check(dev)
    print(f"check: small fp32 model, GPU kernels vs CPU twins, max |logit diff| "
          f"{worst:.3g} (tol {TOL_LOGITS_FP32}) [{card}]", flush=True)
    train_counters = (flash_block_forward, flash_bwd_dkdv, flash_bwd_dq, fused_adamw_leaf)
    tc = train_check(dev, train_counters)
    for name, r in tc.items():
        print(f"check: small fp32 model trained 2 steps ({name}), GPU kernels vs CPU twins: "
              f"losses {r['losses_gpu']} vs {r['losses_cpu']}, max |loss diff| "
              f"{r['loss_max_abs_err']:.3g} (tol {TOL_TRAIN_LOSS}), max |weight diff| "
              f"{r['param_max_abs_err']:.3g} over {r['trained_tensors']} trained tensors (tol "
              f"{TOL_TRAIN_PARAMS}), launches {r['launches']} [{card}]", flush=True)

    graph = [graph_check(dev), graph_check(dev, head_dim=96)]
    programs_small = program_check(dev)
    print(f"check: small fp32 model, inserts and chunk extends as captured programs and "
          f"eagerly on the card and on the CPU: bit-identical streams, greedy equal to the "
          f"CPU's; slab generate alike; capture ms {json.dumps(programs_small['capture_ms'])} "
          f"[{card}]", flush=True)
    for g in graph:
        print(f"check: small fp32 model (head_dim {g['head_dim']}) served by the captured "
              f"block and step by step on the card: bit-identical streams, greedy streams "
              f"equal the CPU's (sampled too: {g['sampled_equal_cpu']}); {g['steady_blocks']} "
              f"of {g['blocks']} blocks steady at 2 host ops, host ops a block {g['host_ops']} "
              f"[{card}]", flush=True)

    serve_counters = (flash_block_forward, paged_decode_attention)
    cfg = serve_config()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    spent = {}   # wall seconds of each serving phase, printed with them
    t0 = time.perf_counter()
    # the timed runs first: a profiled run slows the runs after it
    stats = serve(cfg, dev, serve_counters, params=params)
    gc.collect()
    int8 = serve(cfg, dev, serve_counters, params=params, page_dtype="int8",
                 reference=stats["streams"])
    gc.collect()
    spent["serve"] = time.perf_counter() - t0
    cut_cfg, cut_params = serving_cut(cfg, params)
    t0 = time.perf_counter()
    lm = trace_lm(cut_cfg, dev, cut_params)
    torch.cuda.reset_peak_memory_stats()
    trace = run_trace_phase(lm, dev, serve_counters, profile=args.profile is not None)
    trace["capture_ms"] = dict(lm.capture_ms)
    trace["pool_bytes"] = pool_bytes(lm._graph_pool())
    trace["peak_bytes"] = torch.cuda.max_memory_allocated()
    captured = trace.pop("streams")
    spent["trace"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eager = run_eager_trace(lm, dev, serve_counters, captured)
    spent["programs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    overload = run_overload_phase(lm, dev, serve_counters, profile=args.profile is not None)
    spent["overload"] = time.perf_counter() - t0
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm = recovery_lm(cut_cfg, dev, cut_params)
    recovery = run_recovery_phase(lm, dev, serve_counters)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    spent["recovery"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm = tenant_lm(cut_cfg, dev, cut_params)
    tenants = run_tenant_phase(lm, dev, serve_counters, captured["a"],
                               trace.pop("trace"))
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    spent["tenants"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm = trace_lm(cut_cfg, dev, cut_params)
    park = run_park_phase(lm, dev, serve_counters)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    spent["park"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm = trace_lm(cut_cfg, dev, cut_params)
    fleet = run_fleet_phase(lm, dev, serve_counters)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    spent["fleet"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tp = run_tp_phase(cfg, dev, params, serve_counters)
    gc.collect()
    torch.cuda.empty_cache()
    spent["tp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    b1 = (flash_block_forward,)
    spec = run_speculation(cut_cfg, dev, cut_params, b1)
    medusa = run_medusa(cut_cfg, dev, cut_params, b1)
    del cut_params
    with tempfile.TemporaryDirectory() as tmp:
        bundle = run_bundle(cfg, dev, params, b1, Path(tmp))
    spent["speculation"] = time.perf_counter() - t0
    if args.profile is not None:
        gc.collect()
        stats["profile"] = serve(cfg, dev, serve_counters, profile_path=args.profile,
                                 params=params)["profile"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    quant = run_quant_phase(dev, parts=("q3", "q1"), params=params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    quant.update(run_quant_phase(dev, parts=("q2",)))
    quant_route_gates(quant)
    spent["quant"] = time.perf_counter() - t0
    for name, st in (("serve", stats), ("serve int8 pages", int8)):
        print(f"{name}: llama3_8b full width ({st['layers']} layers, no depth cut), "
              f"{st['page_dtype']} pages, {st['requests']} requests, {st['generated_tokens']} "
              f"tokens in {st['wall_s']:.3f} s = {st['tokens_per_s']:.1f} tok/s, TTFT p50 "
              f"{st['ttft_s_p50'] * 1e3:.1f} ms max {st['ttft_s_max'] * 1e3:.1f} ms, KV pool "
              f"{st['kv_pool_bytes']} bytes, prefix hit tokens {st['prefix_hit_tokens']}, "
              f"decode blocks {st['decode_blocks']}: {st['replays']} replays, "
              f"{st['host_fetches']} fetches, {st['h2d_copies']} copies = "
              f"{st['host_ops_per_block']:.3f} host ops a block, capture {st['capture_s']:.3f} s, "
              f"launches {st['launches']} (B2: replays x {st['b2_per_replay']['derived']} "
              f"recorded at capture; one replay traced: split_kernel "
              f"{st['b2_per_replay']['split_kernel']}, merge_kernel "
              f"{st['b2_per_replay']['merge_kernel']}), paged_decode launches a token "
              f"{st['launches_per_token']['paged_decode_attention']:.3f}"
              + (f", tokens matching the bf16 pass {st['token_match_share']:.4f}"
                 if "token_match_share" in st else "") + f" [{card}]", flush=True)
    for label, st in trace["passes"].items():
        print(f"trace pass ({label}): llama3_8b full width at {SERVING_CUT_LAYERS} layers, "
              f"{'async' if st['async_loop'] else 'sync'}"
              f", prefill_chunk_tokens {st['prefill_chunk_tokens']}, {st['requests']} requests "
              f"(every 4th {TRACE_KNOBS['long_prompt_len']} prompt tokens), "
              f"{st['generated_tokens']} tokens in {st['wall_s']:.3f} s = "
              f"{st['tokens_per_s']:.1f} tok/s, TTFT short p50 {st['ttft_ms_p50_short']:.1f} ms "
              f"max {st['ttft_ms_max_short']:.1f} ms, long p50 {st['ttft_ms_p50_long']:.1f} ms "
              f"max {st['ttft_ms_max_long']:.1f} ms, largest gap between tokens of a short "
              f"request {st['max_gap_ms_short']:.1f} ms, decode block ms p50 "
              f"{st['decode_block_ms_p50']}, {st['decode_blocks']} decode blocks at "
              f"{st['host_ops_per_block']:.3f} host ops a block ({st['steady_blocks']} steady), "
              f"{st['inserts']} inserts, chunk_program_calls {st['chunk_program_calls']}, B1 "
              f"launches in chunk extends {st['b1_launches_in_extends']}, launches "
              f"{st['launches']}" + (f", device busy {st['profile']['device_busy_share']:.1%} of "
                                     f"the profiled repeat's {st['profile']['wall_s']:.3f} s"
                                     if "profile" in st else "") + f" [{card}]", flush=True)
    print(f"trace: passes (b) and (c) bit-identical streams, schedules equal "
          f"{trace['schedule_equal_b_c']}; tokens equal between (a) and (b) "
          f"{trace['token_match_a_b']:.4f}; capture {trace['capture_s']:.3f} s [{card}]",
          flush=True)
    for label, st in overload["passes"].items():
        rep = st.get("report") or {}
        print(f"overload pass ({label}): llama3_8b full width at {SERVING_CUT_LAYERS} layers, "
              f"{'async' if st['async_loop'] else 'sync'}, "
              f"{'run_trace (traced)' if st['traced'] else 'run() untraced'}, "
              f"{st['submitted']} submitted: {st['completed']} completed "
              f"({st['ontime']} on time, {st['expired_n']} "
              f"expired: {st.get('queued_expiries', '-')} in the queue, "
              f"{st['partial_expiries']} cut short), {st['rejected_n']} rejected "
              f"({st.get('deadline_evictions', '-')} evictions by deadline), "
              f"{st['generated_tokens']} tokens in {st['wall_s']:.3f} s = "
              f"{st['tokens_per_s']:.1f} tok/s, {st['decode_blocks']} decode blocks at "
              f"{st['host_ops_per_block']:.3f} host ops a block ({st['steady_blocks']} steady), "
              f"host ms launching " + ", ".join(
                  f"{k} {v:.1f} ({st['dispatches'][k]})" for k, v in st["dispatch_ms"].items())
              + f", launches {st['launches']}" + (
                  f", device busy {st['profile']['device_busy_share']:.1%} of the profiled "
                  f"repeat's {st['profile']['wall_s']:.3f} s" if "profile" in st else "") + (
                  f"; run_trace: tokens_per_sec {rep['tokens_per_sec']}, goodput_tokens_per_sec "
                  f"{rep['goodput_tokens_per_sec']}, deadline_miss_rate "
                  f"{rep['deadline_miss_rate']}, itl_p50_ms {rep['itl_p50_ms']}, itl_p99_ms "
                  f"{rep['itl_p99_ms']}, max_itl_gap_ms {rep['max_itl_gap_ms']}, "
                  f"interblock_gap_ms_p50 {rep.get('interblock_gap_ms_p50')}, "
                  f"interblock_gap_ms_p99 {rep.get('interblock_gap_ms_p99')}, "
                  f"fetch_blocked_ms_p50 {rep.get('fetch_blocked_ms_p50')}, "
                  f"host_ops_per_block {rep['host_ops_per_block']}, ttft_blocks_mean "
                  f"{rep['ttft_blocks_mean']}, per_tenant "
                  + json.dumps({t: {k: d[k] for k in ("requests", "goodput_tokens_per_sec",
                                                       "itl_p99_ms", "rejected", "expired")}
                                for t, d in rep["per_tenant"].items()})
                  if rep else "") + f" [{card}]", flush=True)
    print(f"overload: passes (d), (e), (f) equal streams, schedules, rejections, expiries and "
          f"finish reasons; tracing cost (1 - (e) / (f) tok/s) {overload['tracing_cost']:.4f}; "
          f"block_time_ms {overload['block_time_ms']} (a constant), TTFT budget "
          f"{overload['ttft_blocks']} blocks (short prompts a quarter), deadline "
          f"{overload['deadline_blocks']} blocks [{card}]", flush=True)
    for label, st in recovery["passes"].items():
        c = st["counts"]
        print(f"recovery pass ({label}): llama3_8b full width at {SERVING_CUT_LAYERS} layers, "
              + (f"crash after {RECOVERY_CRASH_BLOCKS} rounds and restore from the snapshot, "
                 f"{st['restored_requests']} requests restored, capture of the restored engine "
                 f"{st['capture_s']:.4f} s, snapshot file removed {st['file_removed']}"
                 if label == "k" else
                 f"{'async' if st['async_loop'] else 'sync'}, plan {st['plan']}"
                 + (", corrupting every live page with a tier copy" if label == "l" else "")
                 + (", keep_completions=False" if st["streaming"] else ""))
              + f", pool {RECOVERY_POOL_PAGES} pages, tier {RECOVERY_TIER_PAGES} pages, "
              f"{st['generated_tokens']} tokens in {st['wall_s']:.3f} s = "
              f"{st['tokens_per_s']:.1f} tok/s, {c['decode_blocks']} decode blocks"
              + (f" at {st['host_ops_per_block']:.3f} host ops a block ({st['steady_blocks']} "
                 f"steady)" if "host_ops_per_block" in st else "")
              + f", tier spilled {c['tier_spilled_pages']} restored {c['tier_restored_pages']} "
              f"(hits {c['tier_hits']}, failures {c['tier_restore_failures']}) repaired "
              f"{c['tier_repaired_pages']}, replays {c['corrupt_page_replays']}, dispatch "
              f"retries {c['dispatch_retries']}, faults {c['fault_stats']}"
              + (f", tier_restore_ms_p99 {st['tier_restore_ms_p99']}, spill reads "
                 f"{st['spill_read_s']:.3f} s ({st['tier_blocking_spills']} waited for a block "
                 f"in flight), replays {st['replay_s']:.3f} s, page copies "
                 f"{st['tier_d2h_copies']} D2H / {st['tier_h2d_copies']} H2D, recovery "
                 f"fetches {st['recovery_fetches']}" if "spill_read_s" in st else "")
              + f", launches {st['launches']} [{card}]", flush=True)
    print(f"recovery: (h) and (l) bit-identical to (g), (i) and (j) equal decisions and streams, "
          f"every count as the CPU predicted, (k) resumed every request, (m) totals equal "
          f"(g)'s; tokens of (i) equal to (g)'s {recovery['token_match_i_g']:.4f}; before each "
          f"stream's first replay {recovery['before_replay_i_g']['equal']} of "
          f"{recovery['before_replay_i_g']['tokens']} equal to (g)'s, streams that differ there "
          f"with their first insert in (i) and in (g) (block, ids inserted together) "
          f"{recovery['before_replay_i_g']['differ']} [{card}]",
          flush=True)
    for label, st in tenants["passes"].items():
        c = st.get("counts", {})
        print(f"tenants pass ({label}): llama3_8b full width at {SERVING_CUT_LAYERS} layers, "
              + ("the trace phase's trace, no adapter or grammar, sync, one-shot inserts"
                 if label == "n" else
                 f"{'async' if st['async_loop'] else 'sync'}, adapters"
                 + (", grammars" if label in "qrs" else "")
                 + (f", faults {st['fault_stats']}" if st.get("plan") else ""))
              + f", {st['generated_tokens']} tokens in {st['wall_s']:.3f} s = "
              f"{st['tokens_per_s']:.1f} tok/s, {st['host_ops_per_block']:.3f} host ops a block "
              f"({st['steady_blocks']} steady)"
              + (f", decode block ms p50 {st['decode_block_ms_p50']}" if label == "n" else "")
              + (f", decode block ms p50 {st['decode_block_ms_p50']:.3f} mean "
                 f"{st['decode_block_ms_mean']:.3f}, adapter acquire ms p50 "
                 f"{st['acquire_ms_p50']:.2f} p99 {st['acquire_ms_p99']:.2f} (cold load p50 "
                 f"{st['adapter_load_ms_p50']:.2f}), grammar acquire ms p50 "
                 f"{st['grammar_acquire_ms_p50']} p99 {st['grammar_acquire_ms_p99']}, "
                 f"interblock gap ms p50 {st['interblock_gap_ms_p50']} p99 "
                 f"{st['interblock_gap_ms_p99']}, fetch blocked ms p50 "
                 f"{st['fetch_blocked_ms_p50']}, registration {st['register_s']:.2f} s, "
                 f"counts {json.dumps(c)}, finish {st['finish_reasons']}, parsed "
                 f"{st['parsed']} of {st['constrained']} constrained"
                 if label != "n" else "")
              + f", launches {st['launches']} [{card}]", flush=True)
    lay = tenants["layer"]
    print(f"tenants: (n) bit-identical to trace pass (a), (o) counts as the CPU predicted, (p) = "
          f"(o), (r) = (q) for {tenants['r_admitted_alike']} of {tenants['r_requests']} requests "
          f"admitted alike (tokens equal {tenants['r_token_share_equal_q']:.4f}), (s) tokens "
          f"equal to (q) {tenants['s_token_share_equal_q']:.4f}, every constrained stream "
          f"parsed; one capture ({tenants['capture_ms']} ms); grammar compile ms at vocab "
          f"{cfg.vocab_size} {tenants['passes']['o']['compile_ms']}; adapters built in "
          f"{tenants['adapters_build_s']:.1f} s, {tenants['adapter_bytes_per_slot']} bytes a "
          f"slot; (t) one layer fp32 pooled vs merged max |err| {lay['max_abs_err']:.3g} (tol "
          f"{lay['tolerance']}, max |ref| {lay['max_abs_ref']:.3g}, the adapter moves it by "
          f"{lay['delta_max_abs']:.3g}), slot 0 bit-identical {lay['base_bit_identical']} "
          f"[{card}]", flush=True)
    for label, st in park["passes"].items():
        print(f"park pass ({label}): llama3_8b full width at {SERVING_CUT_LAYERS} layers, "
              f"{len(PARK_LENS)} sessions "
              f"({PARK_LENS}), {st['generated_tokens']} tokens in {st['wall_s']:.3f} s = "
              f"{st['tokens_per_s']:.1f} tok/s, {st['decode_blocks']} decode blocks at "
              f"{st['host_ops_per_block']:.3f} host ops a block ({st['steady_blocks']} steady), "
              f"counts {json.dumps(st['counts'])}, degraded {st['degraded']}, incidents "
              f"{st['incidents']}, launches {st['launches']} [{card}]", flush=True)
    rp = park["report"]
    print(f"park: (v), (w), (y) and (x)'s exact resumes bit-identical to (u), every park left "
          f"no page, (x) counts as the CPU predicted, attribution sums hold in 4c-4f; by "
          f"session prompt length: park ms {json.dumps(rp['park_ms'])}, resume ms "
          f"{json.dumps(rp['resume_ms'])}, resume TTFT ms {json.dumps(rp['resume_ttft_ms'])}, "
          f"cold TTFT ms {json.dumps(rp['cold_ttft_ms'])}, durable bytes "
          f"{json.dumps(rp['durable_bytes'])}, pages held after a park "
          f"{rp['pages_held_after_park']}, host split ms a park/resume "
          f"{json.dumps(rp['host_split_ms'])}; (x) degraded {park['x_degraded']} with "
          f"{park['x_degraded_token_share_equal_u']:.4f} of their tokens equal to (u)'s; "
          f"phase {park['phase_s']:.1f} s [{card}]", flush=True)
    for label, st in eager["passes"].items():
        cap = trace["passes"][label]
        print(f"program pass ({label}): llama3_8b full width at {SERVING_CUT_LAYERS} layers, "
              f"{'async' if st['async_loop'] else 'sync'}, prefill_chunk_tokens "
              f"{st['prefill_chunk_tokens']}: captured {cap['tokens_per_s']:.1f} tok/s, eager "
              f"{st['tokens_per_s']:.1f} tok/s; host ms an insert captured "
              f"{per_call_ms(cap, 'insert')} eager {per_call_ms(st, 'insert')} "
              f"({cap['dispatches'].get('insert', 0)}), a chunk extend captured "
              f"{per_call_ms(cap, 'extend')} eager {per_call_ms(st, 'extend')} "
              f"({cap['dispatches'].get('extend', 0)}); eager host ops a block "
              f"{st['host_ops_per_block']:.3f} ({st['steady_blocks']} steady), launches "
              f"{st['launches']} [{card}]", flush=True)
    print(f"programs: captured and eager streams bit-identical in (a), (b), (c); capture ms "
          f"by signature {json.dumps(trace['capture_ms'])}; graph pool {trace['pool_bytes']} "
          f"bytes, peak allocated {trace['peak_bytes']} bytes over the trace phase "
          f"[{card}]", flush=True)
    for name, r in spec["drafts"].items():
        h, f = r["host_stats"], r["fused_stats"]
        print(f"speculation ({name} draft): llama3_8b full width target at {SERVING_CUT_LAYERS} "
              f"layers, {SPEC_PROMPT}-token "
              f"prompt, {SPEC_NEW} tokens, num_draft {SPEC_DRAFT}: host loop round ms p50 "
              f"{h['round_ms_p50']} (draft {h['draft_ms_p50']}, verify {h['verify_ms_p50']}), "
              f"acceptance {h['acceptance_rate']} (sampled {r['sampled_acceptance']}), tokens "
              f"a round {h['tokens_per_round']}; fused ({SPEC_ROUNDS} rounds a block) block ms "
              f"p50 {f['block_ms_p50']}, {r['fused_tokens_per_s']:.1f} tok/s against generate("
              f"fused_chunk=8) {spec['generate_tokens_per_s']:.1f} tok/s, host dispatches a "
              f"block {f['host_dispatches_per_block']}; bf16 tokens equal to generate's "
              f"{r['bf16_share_equal_generate']:.4f} [{card}]", flush=True)
    print(f"speculation: fused = host loop (greedy and sampled, both drafts); fp32 at "
          f"{EXACT_LAYERS} layers: tokens equal generate's, acceptance "
          f"{json.dumps(spec['fp32_acceptance'])}; launches {spec['launches']} [{card}]",
          flush=True)
    ms = medusa["stats"]
    print(f"medusa: llama3_8b full width at {SERVING_CUT_LAYERS} layers, {MEDUSA_HEADS} seeded "
          f"heads, default tree, "
          f"{SPEC_PROMPT}-token prompt, {SPEC_NEW} tokens: tree ms p50 {ms['tree_ms_p50']}, "
          f"replay ms p50 {ms['replay_ms_p50']}, round ms p50 {ms['round_ms_p50']}, tokens a "
          f"round {ms['tokens_per_round']}, {medusa['tokens_per_s']:.1f} tok/s; fp32 at "
          f"{EXACT_LAYERS} layers equal to greedy generate; launches {medusa['launches']} "
          f"[{card}]", flush=True)
    print(f"bundle: 2-layer full-width insert forward (512 tokens) traced in "
          f"{bundle['trace_s']:.2f} s, saved in {bundle['save_s']:.2f} s "
          f"({bundle['file_bytes']} bytes, {bundle['tensor_bytes_in_file']} of tensors), "
          f"loaded in {bundle['load_s']:.2f} s; the loaded program gives the live one's bits, "
          f"launches {bundle['launches']} [{card}]", flush=True)
    q3, q1, q2 = quant["q3"], quant["q1"], quant["q2"]
    print(f"quant (q3): small fp32 Mixtral (2 layers, 4 experts) with int8 weights, GPU kernels vs "
          f"CPU twins: max |logit diff| {q3['logits_max_abs_err']:.3g} (tol {q3['tolerance']}); "
          f"greedy streams equal on both devices in selective and all_experts; B5 launches "
          f"{q3['launches']} [{card}]", flush=True)
    for name, st in (("bf16", q1["bf16"]), ("int8", q1["int8"])):
        print(f"quant (q1, {name} weights): llama3_8b full width, {st['requests']} requests, "
              f"{st['generated_tokens']} tokens in {st['wall_s']:.3f} s = "
              f"{st['tokens_per_s']:.1f} tok/s, TTFT p50 {st['ttft_s_p50'] * 1e3:.1f} ms, decode "
              f"block ms {st['decode_block_ms']:.3f} ({QUANT_BLOCK_STEPS} steps), "
              f"{st['host_ops_per_block']:.3f} host ops a block ({st['steady_blocks']} steady), "
              f"captured = stepwise streams, launches {st['launches']}, B5 by route "
              f"{st['launches_by_route'].get('w8a16_gemm')}"
              + (f", weight bytes {json.dumps(st['weight_bytes'])} against bf16 "
                 f"{st['bf16_weight_bytes']['total']}, quantized on the card in "
                 f"{st['quantize_s']:.2f} s, tokens matching the bf16 pass "
                 f"{st['token_match_share']:.4f}" if name == "int8" else "") + f" [{card}]",
              flush=True)
    sv, gen = q2["serve"], q2["generate"]
    print(f"quant (q2): mixtral_8x7b full width and depth ({q2['layers']} layers, "
          f"{q2['experts']} experts, top {q2['top_k']}) with int8 weights, weight bytes "
          f"{json.dumps(q2['weight_bytes'])} built in {q2['build_s']:.1f} s, peak allocated "
          f"{q2['peak_bytes']} of {q2['device_bytes']} bytes; serve (all_experts decode): "
          f"{sv['requests']} requests, {sv['generated_tokens']} tokens in {sv['wall_s']:.3f} s = "
          f"{sv['tokens_per_s']:.1f} tok/s, TTFT p50 {sv['ttft_s_p50'] * 1e3:.1f} ms, decode step "
          f"ms {sv['decode_step_ms']:.3f}, {sv['host_ops_per_block']:.3f} host ops a block "
          f"({sv['steady_blocks']} steady), captured = stepwise streams, launches "
          f"{sv['launches']} (B5 by route {sv['launches_by_route']['w8a16_gemm']}); generate "
          f"batch 1 (selective decode), {gen['prompt_tokens']}-token "
          f"prompt, {gen['new_tokens']} tokens in {gen['wall_s']:.3f} s = "
          f"{gen['tokens_per_s']:.1f} tok/s, decode step ms {gen['decode_step_ms']:.3f}, fused = "
          f"stepwise, launches {gen['launches']} (B5 by route "
          f"{gen['launches_by_route']['w8a16_gemm']}) [{card}]", flush=True)
    if "profile" in stats:
        prof = stats["profile"]
        print(f"profile: device busy {prof['device_busy_s']:.3f} s of the profiled run's "
              f"{prof['wall_s']:.3f} s wall ({prof['device_busy_share']:.1%}; the unprofiled "
              f"run took {stats['wall_s']:.3f} s); B2 kernels traced {prof['b2_traced']} for "
              f"{prof['b2_launches']} counted launches; top kernels "
              + "; ".join(f"{t['name'][:48]} {t['ms']:.1f} ms x{t['calls']}"
                          for t in prof["top"][:6]) + f" [{card}]", flush=True)
    print_fleet(fleet, card)
    print_tp(tp, card)
    print_tp_rest(tp["rest"], card)
    print(f"serving phases: wall s {json.dumps({k: round(v, 1) for k, v in spent.items()})}, "
          f"{sum(spent.values()):.1f} in all [{card}]", flush=True)
    # the serve phase's weights and page pool go before training
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        loop = run_train_loop(train_loop_config(), dev, train_counters, Path(tmp))
    failures = train_loop_gates(loop)
    check(not failures, "train loop (k1): " + "; ".join(failures))
    print_train_loop(loop, card)
    gc.collect()
    torch.cuda.empty_cache()

    tstats = train(train_config(), dev, train_counters, profile_path=args.profile)
    print(f"train: llama3_8b widths, {tstats['layers']} of 32 layers, {tstats['params']} "
          f"params, batch {tstats['batch']} x {tstats['seq']} tokens: step "
          f"{tstats['step_ms_mean']:.1f} ms (steps {[round(x, 1) for x in tstats['step_ms']]}), "
          f"{tstats['tokens_per_s']:.0f} tok/s, losses {[round(x, 4) for x in tstats['losses']]}, "
          f"peak {tstats['peak_bytes']} of {tstats['device_bytes']} bytes, launches per step "
          f"{tstats['launches_per_step']}, set-up {tstats['setup_s']:.1f} s [{card}]", flush=True)
    if "profile" in tstats:
        prof = tstats["profile"]
        print(f"profile: training step, device busy {prof['device_busy_s'] * 1e3:.1f} ms of "
              f"{prof['wall_s'] * 1e3:.1f} ms wall ({prof['device_busy_share']:.1%}); top kernels "
              + "; ".join(f"{t['name'][:48]} {t['ms']:.1f} ms x{t['calls']}"
                          for t in prof["top"][:8]) + f" [{card}]", flush=True)
    variants = train_variants(train_config(), dev, train_counters)
    for name, v in variants.items():
        print(f"train ({name}, k2): the train cell, step {v['step_ms_mean']:.1f} ms (steps "
              f"{[round(x, 1) for x in v['step_ms']]}) against {tstats['step_ms_mean']:.1f} "
              f"(full remat, fp32 master), {v['tokens_per_s']:.0f} tok/s, peak "
              f"{v['peak_bytes']} bytes against {tstats['peak_bytes']}, B1 launches a layer "
              f"{v['b1_per_layer']:.2f} against "
              f"{tstats['launches_per_step']['flash_block_forward'] / tstats['layers']:.2f}, "
              f"launches a step {json.dumps(v['launches_per_step'])}, losses "
              f"{[round(x, 4) for x in v['losses']]} [{card}]", flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    dist = run_dist_phase(dev, train_counters)
    print_dist(dist, card)
    gc.collect()
    torch.cuda.empty_cache()
    cp_pp = run_cp_pp_phase(dev, train_counters)
    print_cp_pp(cp_pp, card)
    gc.collect()
    torch.cuda.empty_cache()
    moe = run_moe_phase(dev, train_counters)
    print_moe(moe, card)
    gc.collect()
    torch.cuda.empty_cache()
    families = run_families_phase(dev, train_counters)
    print_families(families, card)
    gc.collect()
    torch.cuda.empty_cache()
    entry = run_entry_points_phase(dev, (flash_block_forward, paged_decode_attention, w8a16_gemm,
                                         flash_bwd_dkdv, flash_bwd_dq, fused_adamw_leaf))
    print_entry_points(entry, card)
    gc.collect()
    torch.cuda.empty_cache()
    lora_moe = run_lora_moe_phase(dev, serve_counters, dist, moe)
    print_lora_moe(lora_moe, card)

    by_path = {"serve": stats["launches"], "serve_int8": int8["launches"],
               **{f"trace_{label}": st["launches"] for label, st in trace["passes"].items()},
               **{f"overload_{label}": st["launches"]
                  for label, st in overload["passes"].items()},
               **{f"recovery_{label}": st["launches"]
                  for label, st in recovery["passes"].items()},
               **{f"tenants_{label}": st["launches"] for label, st in tenants["passes"].items()},
               **{f"park_{label}": st["launches"] for label, st in park["passes"].items()},
               **{f"fleet_z1_{label}": st["launches"] for label, st in fleet["z1"].items()},
               "fleet_z2": fleet["z2"]["launches"],
               **{f"fleet_z3_{label}": st["launches"] for label, st in fleet["z3"].items()},
               "fleet_z4": fleet["z4"]["launches"], "fleet_z5": fleet["z5"]["launches"],
               **{f"tp_t1_{name}": st["launches"] for name, st in tp["t1"].items()},
               **{f"tp_t2_rank{rk['rank']}": rk["serve"]["launches"] for rk in tp["t2"]["ranks"]},
               **{f"program_eager_{label}": st["launches"]
                  for label, st in eager["passes"].items()},
               "speculation": spec["launches"], "medusa": medusa["launches"],
               "bundle": bundle["launches"], "quant_small": {"w8a16_gemm": q3["launches"]},
               "quant_llama_bf16": q1["bf16"]["launches"],
               "quant_llama_int8": q1["int8"]["launches"], "quant_mixtral": sv["launches"],
               "quant_mixtral_generate": gen["launches"], "train_loop": loop["launches"],
               "train": tstats["launches"],
               **{f"train_{name}": v["launches"] for name, v in variants.items()},
               "dist_d0": dist["d0"]["launches"],
               **{f"dist_d1_rank{rk['rank']}": rk["d1"]["launches"]
                  for rk in dist["d1"]["ranks"]},
               "cp_c0": cp_pp["c0"]["launches"], "pp_p0": cp_pp["p0"]["launches"],
               **{f"{part}_rank{rk['rank']}": rk[part]["launches"]
                  for part in ("c1", "p1", "p2") for rk in cp_pp["ranks"]},
               "moe_m0": moe["m0"]["launches"],
               **{f"moe_m1_rank{rk['rank']}": rk["m1"]["launches"] for rk in moe["ranks"]},
               "families_b0": families["b0"]["launches"], "families_n0": families["n0"]["launches"],
               **{f"families_n1_rank{rk['rank']}": rk["n1"]["launches"]
                  for rk in families["ranks"]},
               **ep_launches_by_path(entry), **tpr_launches_by_path(tp["rest"]),
               **lora_moe_launches_by_path(lora_moe)}
    wrapper = {"flash_fwd": "flash_block_forward", "paged_decode": "paged_decode_attention",
               "flash_bwd_dkdv": "flash_bwd_dkdv", "flash_bwd_dq": "flash_bwd_dq",
               "fused_adamw": "fused_adamw_leaf", "w8a16_gemm": "w8a16_gemm"}
    for k in kernels:
        k["launches_by_path"] = {path: counts[wrapper[k["name"]]]
                                 for path, counts in by_path.items() if wrapper[k["name"]] in counts}
        k["launches"] = sum(k["launches_by_path"].values())
        for path, n in k["launches_by_path"].items():
            check(n > 0, f"the {path} path never launched {k['name']}")
    # B5's launches by route on each path that ran it (gated in quant_route_gates)
    b5 = next(k for k in kernels if k["name"] == "w8a16_gemm")
    b5["routes_by_path"] = {
        "quant_small": q3["launches_by_route"],
        "quant_llama_int8": q1["int8"]["launches_by_route"]["w8a16_gemm"],
        "quant_mixtral": sv["launches_by_route"]["w8a16_gemm"],
        "quant_mixtral_generate": gen["launches_by_route"]["w8a16_gemm"],
        "entry_r4": entry["r4"]["launches_by_route"]["w8a16_gemm"],
        "entry_r4_check": entry["r4_check"]["launches_by_route"]["w8a16_gemm"],
        **tpr_b5_routes_by_path(tp["rest"])}
    b5["launches_by_route"] = {
        route: sum(r.get(route, 0) for r in b5["routes_by_path"].values())
        for route in ("wgmma", "decode", "f32")}
    check(sum(b5["launches_by_route"].values()) == b5["launches"],
          f"B5's launches by route {b5['launches_by_route']} do not add up to {b5['launches']}")
    print(f"kernel w8a16_gemm launches by route on the main path: "
          f"{json.dumps(b5['launches_by_route'])}, by path {json.dumps(b5['routes_by_path'])} "
          f"[{card}]", flush=True)
    # the element-by-element readings go on the summary line, which keeps the
    # kernels line short
    checks = {"family_shapes": {case: r["held"] for case, r in family_kernels.items()}}
    for st in (q1["bf16"], q1["int8"], sv):
        st.pop("streams")
    for k in kernels:
        c = checks[k["name"]] = {key: k.pop(key) for key in ("held", "head_dims", "case_shapes")
                                 if key in k}
        for part in ("train_shape", "chunk_shape"):
            if "held" in k.get(part, {}):
                c[part] = k[part].pop("held")
    print(json.dumps({"serve": stats, "serve_int8": int8, "trace": trace, "overload": overload,
                      "programs": eager, "speculation": spec, "medusa": medusa, "bundle": bundle,
                      "recovery": recovery, "tenants": tenants, "park": park, "fleet": fleet,
                      "tp": tp, "dist": dist, "cp_pp": cp_pp, "moe": moe, "families": families,
                      "entry_points": entry,
                      "quant": quant,
                      "train_loop": loop, "train": tstats, "train_variants": variants,
                      "train_check": tc, "graph_check": graph, "kernel_checks": checks,
                      "program_check": programs_small, "nxdcheck": nxdcheck,
                      "card": card}))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{**{key: k[key] for key in keys}, **k} for k in kernels],
                      "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
