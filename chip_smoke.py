#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # needs one card

Phases, in order:

1. card name and power limit (nvidia-smi), then build of every CUDA kernel
   from ``ct_diffusionmodelbench_tpu_torch/csrc`` (one nvcc per source, all
   started together); ptxas's registers, spills and warnings per kernel, and
   whether the flash forward, dq and dk/dv kernels at head dim 128, the
   direct flash kernel's three head-dim-128 configurations, the bf16 and int8
   grouped pairs and the fused expert FFN spill.
2. kernels: each kernel at the main path's shapes against its plain PyTorch
   version on the same inputs, timed with CUDA events beside the plain
   version, one PyTorch library call where one exists, and its bound.  The
   bf16 grouped pair (K1/K4, K2/K5) runs on a random routing through layer
   1's router with the stacked [18, 64, ...] weights, at the row tile the
   layout takes for M 20480 (64; printed), with the pad-skip
   vector ``tile_valid`` the main path hands it (real rows against the plain
   versions, the rest zero) and without it; it is timed in turns (medians
   of 5), with and without ``tile_valid``, beside ``torch._grouped_mm``,
   with its achieved TFLOP/s and share of the bound, and its host
   microseconds per launch (the TMA maps are built on the host) are
   printed.  The flash kernels and their SDPA yardsticks are timed in turns
   (kernel, SDPA, kernel, SDPA, ...; medians), with their achieved TFLOP/s
   and share of the bound.
3. slice: full-width, full-depth ``llada-moe-7b`` (random weights from a
   seeded generator) decoding greedily through ``llada_generate`` at batch 8,
   prompt 64, gen 256, steps 128, block 32; launch counts read around that
   run; no mask id may remain; a repeated forward must give identical logits.
4. reduced depth: a 2-layer forward at full width with the kernels against
   the same forward on the kernels' plain versions.
5. single-prompt kernels: layer 1's routing and attention inputs from a
   full-size B = 1 forward at the chat prompt's shape; the fused expert FFN
   (K3) on the stacked [18, 64, ...] weights and the direct flash attention
   (K9, with and without lse, at llada-moe-7b's H 16 / KV 4 and at Dream's
   H 28 / KV 4) against their plain versions, timed beside them, beside one
   PyTorch call for the same function, beside their bounds and beside the
   pair (K1 + K2) and K8 at the same inputs.  K3 runs with the pad-skip
   vector ``tile_valid`` the chat path hands it (real rows against the plain
   version, the rest zero) and without it, timed in turns (medians of 5)
   with and without it beside the pair (with it) and ``torch._grouped_mm``;
   the count of tiles with a real row is printed.
6. chat slice: with ``CTDB_GROUPED_FUSED=1`` and ``CTDB_FLASH_DIRECT=1``,
   ``cli/chat.py``'s ``build_parser`` → a ``ModelRunner`` on phase 3's
   weights (those of ``--preset llada-moe-7b``) → ``run_chat`` at the chat
   defaults (gen 128, steps 128, block 32, greedy, the Lean-only system
   prompt); a warm-up, then a timed call with launch counts around it (K3
   and K9 only); no mask id may remain; then one short ``cli/chat_base.py``
   ``_respond`` (causal, 8 new tokens) on the same weights.
7. chat depth check: a 2-layer full-width forward through K3 and K9 against
   the same forward on their plain versions.
8. eval sweep: with both switches off, ``cli/bench.py``'s ``build_parser``
   (llada style, the CLI defaults: gen 256, steps 128, block 32, greedy;
   ``--batch-size 8 --fake-lean``) → ``cli/bench.run`` on a runner over
   phase 3's weights and 8 synthetic MathOlympiadBench-schema entries in
   four categories, after a warm-up at one step a block; the artifacts
   must exist, every row must have generated and been verified by the
   async pool (8 verifier calls), no mask id may remain, and K1, K2 and K8
   must be launched 18 × 128 times and no other kernel (one batch, one
   generate: a per-sample fallback would launch 8 times as often).  Prints
   S, M, wall s, tokens/s, the harness's ``average_generation_time``
   and the share of the wall outside ``generate_ids``.  Then the kernels
   on the batch the sweep decoded (its ids and its prompts' left padding,
   S 832): layer 1's K1 and K2 at its routing and at the row tile the
   layout takes for it (64 here; tile_m and m_pad printed) and its K8,
   each against its plain version, and a 2-layer full-width forward
   through the kernels against the same on their plain versions, the plain
   run pinned to the kernel run's expert choice.
9. MiniF2F: likewise ``cli/minif2f.py`` (gen 512, steps 128, block 32,
   greedy, ``avoid_eos``, EOS truncation; ``--batch-size 8 --fake-lean``)
   → ``cli/minif2f.run`` over 8 synthetic miniF2F-schema problems: the
   result file, ``stats.total`` 8 with no error row, every row verified,
   the same launch counts and the same kernel checks on its batch (S 1088:
   M 69632 ≥ 65536, so K1 and K2 run at tile_m 128); prints the pass count
   under the fake verifier.
10. block cache: phase 3's decode (its weights and prompt) through
   ``ModelRunner(..., accel="block-cache")``, (a) alone and (b) with
   ``parallel_threshold`` 0.9, each after a warm-up: wall s, tokens/s
   beside phase 3's, peak memory, forwards per block, the threshold loop's
   host reads (count, seconds blocked), no mask id left, the share of
   tokens equal to phase 3's (printed only: the cache approximates a deep
   model), and exact launch counts: K8 once per layer and refresh (144),
   K1 and K2 once per layer and forward (2304 in (a)), nothing else.  Then,
   on the batch (a) decoded with left padding: layer 1's K8 without RoPE on
   the refresh's rotated q/k, layer 1's K1/K2 at a cached step's routing (M
   2048; tile_m and m_pad printed, timed beside their bound), and a 2-layer
   refresh plus cached step through the kernels against the same on the
   plain versions, the plain run pinned to the kernel run's expert choice.
11. int8 kernels: ``ModelRunner.random_init("llada-moe-7b", quant="int8")``
   (each weight quantized as it is built); the int8 gate/up and down
   kernels on the layer-1 routing of a full-size int8 forward, with the
   stacked [18, 64, ...] int8 experts, against their plain versions, with
   the pad-skip vector ``tile_valid`` the main path hands them (real rows
   against the plain versions, the rest zero) and without it; timed beside
   the plain versions and, in turns (medians of 5), with and without
   ``tile_valid`` beside ``torch._grouped_mm`` on weights dequantized to
   bf16 beforehand, with their achieved TFLOP/s and share of the bound.
12. int8 slice: ``ModelRunner.generate_ids`` at the bf16 slice's shape and
   prompt; launch counts read around that run (the int8 pair and flash, not
   the bf16 pair); no mask id may remain; a repeated forward must give
   identical logits.
13. int8 quantization check: at 2 layers of the full width, the int8 forward
   against the bf16 forward on the dequantized weights (the same function),
   and against itself on the int8 kernels' plain versions.
14. int8 block cache: one ``generate_ids`` of phase 12's prompt on the int8
   weights through ``accel="block-cache"``: K6/K7 2304 launches each, K8
   144, nothing else, no mask id left; K6/K7 at a cached step's routing (M
   2048) against their plain versions.
15. Dream slice: full-width, full-depth ``dream-7b`` (seeded random weights,
   ``ModelRunner.random_init``) generating at B = 1, gen 128, steps 128,
   greedy, ``alg="entropy"`` under ``CTDB_FLASH_DIRECT=1``: K9 launches,
   no mask id left, a repeated forward identical, tokens/s, peak memory.
16. training kernels: the flash forward with lse and the two backward kernels
   at the training shape (B 1, S 2048, H = KV = 32, Dh 128, RoPE) against
   their plain versions, timed beside them and beside SDPA's forward and
   backward (dq, dk/dv and SDPA's backward in turns, each kernel with its
   share of the bound), and the forward beside itself without RoPE; also a
   GQA case (H 16, KV 4) and a padded-mask case.
17. training slice: 8-layer, full-width ``llada-8b`` (random weights) trained
   5 optimizer steps by ``Trainer`` (seq 2048, micro-batch 1, grad-accum 4,
   remat, CE chunk 512, AdamW) on seeded token rows; s/step over steps 2-5,
   tokens/s, train MFU, peak memory, save seconds; launch counts per step.
18. training gradients: a 2-layer full-width loss and every parameter's
   gradient with the kernels against the same on their plain versions.
19. MoE training kernels: full-size ``llada-moe-7b`` from ``cli/train.py``'s
   ``load_model`` (``--preset``, seeded random weights); K1 and K2 at a B 1,
   S 2048 routing through layer 1's router (M 16384; tile_m and m_pad
   printed) against their plain versions; the grouped FFN's backward
   (``torch._grouped_mm`` products) against its plain version (one
   ``torch.mm`` per expert) on one cotangent, both timed with CUDA events;
   K8 with lse, K10 and K11 at H 16, KV 4, S 2048 against their plain
   versions, timed.
20. MoE training slice: those weights trained 5 optimizer steps through
   ``cli/train.py``'s ``build_parser`` → ``run`` with the reference's
   ``sft_train_step_moe`` flags (int8 moments, bf16 accumulation, remat,
   A 4, B 1, L 2048) on 20 seeded token rows, all 18 layers: s/step over
   steps 2-5, tokens/s, train MFU on active parameters, peak memory, the
   optimizer update's share of the step, save seconds (into a temporary
   directory, deleted); exact launches per step (K1 = K2 = K8 = 144, K10 =
   K11 = 72, no other kernel); finite loss and gradient norm; parameters
   moved.
21. MoE training checks at 2 layers of the full width: loss, aux loss and
   every gradient through the kernels against the same on their plain
   versions (the plain run on the kernel run's expert choice);
   ``remat='dots'`` against ``remat=True`` (and their peak memory); one
   int8 / bf16 step's optimizer state saved, loaded into a fresh
   ``Trainer`` and compared bit for bit.

22. TP/DP serving: four ranks spawned by this script (one card each with
   nccl where there are four cards, else all on cuda:0 with gloo; the
   backend, world and ranks per card are printed), dp 2 × tp 2.  Each rank
   draws its shard of full-size ``llada-moe-7b`` (``ModelRunner.random_init(
   ..., dp=2, tp=2)``: the one-process draws, sliced leaf by leaf) and runs
   ``generate_ids`` at the main path's shape (B 8, 4 rows a data rank,
   prompt 64, gen 256, steps 128, block 32, greedy) after a warm-up at one
   step a block: exact launches per rank, no mask id, the same ids on every
   rank, peak memory, tok/s, the collectives' count and their share of the
   wall (each synchronized to be timed).  Then, on each rank's rows of the
   decoded batch, layer 1's K1/K2 at its 32 local experts (other ranks'
   slots dropped from the layout) and its K8 at 8 q / 2 kv heads against
   their plain versions (rank 0 times them beside their library calls and
   bounds), and a 2-layer full-width forward over the mesh against the
   one-rank forward on the gathered first two layers, the one-rank run on
   the sharded run's expert choice.
23. dp × tp training: ``cli/train.py``'s ``build_parser`` → ``train_mesh``
   → ``run`` with ``--dp 2 --tp 2`` on four spawned ranks, each drawing only
   its shard (as ``load_model`` does): llada-moe-7b at full width cut to 2
   layers, L 2048, B 2, 3 steps, bf16 moments and accumulation, against
   the one-rank trainer on the same weights and data (run first in this
   process): loss and gradient norm per step, exact launches per rank; K8
   with lse, K10 and K11 at 8 q / 2 kv heads against their plain versions
   (rank 0, timed); a save (gathered, rank 0 writes) and a resume into a
   fresh trainer: its optimizer state (count, and a position-weighted
   fingerprint of every moment shard) equal to the saved trainer's, the
   next step's loss the same, and the moments after that step, which the
   loaded state fed, within 1e-2 of the saved trainer's after its step.

24. sequence-parallel training: ``cli/train.py``'s ``build_parser`` →
   ``train_mesh`` → ``run`` with ``--dp 1 --sp 2 --tp 2`` on four spawned
   ranks, each drawing its shard: llada-moe-7b at full width cut to 2
   layers, L 4096, B 2, 3 steps, remat, bf16 moments and accumulation,
   against the one-rank trainer on the same weights and data (run first in
   this process): loss and gradient norm per step, exact launches a rank
   (K8 sp chunks a layer and step, twice under remat; K10 / K11 sp; K1 / K2
   twice), exact tensors sent point to point, peak memory, s/step and the
   p2p and all-reduce seconds' share of the steps (each synchronized to be
   timed).  Then, on every rank, ring attention at its heads (8 q / 2 kv),
   B 2, L 4096, forward and backward, against the flash kernels over the
   whole sequence; on rank 0, K8 with lse at the ring chunk (B 2, S 2048, no
   RoPE) and K10 / K11 on the chunk with the ring's global o / lse against
   their plain versions, timed beside them, SDPA and their bounds.
25. pipeline training: (a) the same CLI path with ``--pp 4
   --pp-microbatches 4``: llada-moe-7b at full width cut to 4 layers (one a
   stage), B 4, L 512, 3 steps, bf16 moments and accumulation, against the
   one-rank trainer: loss and gradient norm, exact launches a rank (K8, K10,
   K11, K1, K2 once a microbatch and step), exact tensors sent, peak
   memory; (b) ``llada-8b`` at full width cut to 2 layers on 2 stages × tp
   2, each rank drawing its stage's column / row shard: the pipelined
   logits against the one-rank forward on the gathered weights, and one
   training step's loss and gradient norm against one rank's.

26. busy time: ``utils/profiling.onchip_device_seconds`` around a loop of
   K8 at the main shape (B 8, S 320, H 16, KV 4, Dh 128, RoPE, left
   padding): a number, no larger than the loop's CUDA-event window, and
   within 10 % of the kernels' summed time in ``key_averages`` of a second
   trace of the same loop.
27. headline bench: ``python -m ct_diffusionmodelbench_tpu_torch.bench`` as
   a subprocess (full-size ``llada-moe-7b``, B 8, the main path's
   configuration): rc 0, exactly one stdout line, ``chip_kind`` the card's
   name, ``value`` > 0, ``mfu`` not null, ``onchip_seconds_per_batch`` no
   larger than ``seconds_per_batch``; the line is printed.
28. entry forward: ``entry.entry()`` (``llada-8b`` whole, bf16) on ones at
   (1, 320): 32 launches of K8, 65 of ``rms_norm``, 32 of ``swiglu_act``
   and no other kernel, finite logits of shape (1, 320, vocab), peak
   memory.
29. dry run: ``entry.dryrun_multichip(8)`` (8 spawned ranks: nccl with a
   card each where there are eight, else all on cuda:0 with gloo): its
   four lines (dp × tp, sp, pp, pp-tp).
30. sweep: ``bench_sweep``'s ``attention_crossover``, ``grouped_gemm`` and
   ``sft_train_step`` sections at their full shapes, rows printed; a
   section's error fails the phase.  The sweep's heavy sections drive
   paths that phases 12-15 and 20 drive; they run through its CLI.
31. glue: the model step's two memory-bound kernels (``ops/glue.py``) at
   dense8b-eval's shapes: ``rms_norm`` over [3328, 4096] bf16 (within one
   bf16 ulp of its plain version, bit-equal on 99 % or more) and
   ``swiglu_act`` over [3328, 12288] f32 to bf16 (bit-equal), each timed in
   turns beside its plain version and its bound (each run queued behind a
   sleeping kernel, so the host's cost a call stays out), the norm beside
   ``torch.nn.functional.rms_norm`` and on four input sets in turn (none in
   L2), and the host microseconds a call; ``rms_norm`` against its plain
   version also at the other served rows: llada-moe-7b's qk-norm
   [4, 832, 16, 128] (a warp a row) and D 2048, Dream's D 3584.  The
   kernels line's glue launches are the slice's (phase 3), block cache's
   (phase 9) and Dream's (phase 16).
32. SDAR kernels: K12 (``ops/cache_attention.py``) at sdar30b-eval's
   cached passes (B 32, a block of 4 against 580 and 832 keys, 32 / 4 heads
   of 128, left padding of 0-320 a row) and the flash kernel's block-causal
   mode at its prefill (B 32, S 576, blocks of 4, the same padding), each
   against its plain version, timed in turns beside it, beside SDPA with an
   explicit mask (a yardstick the port never calls) and beside its bound;
   K1 and K2 at the cell's cached pass (128 rows of D 2048 routed by
   ``router_probs`` to 128 experts of F 768, top-8: 1024 slots, about 8
   rows an expert, most tiles padding) against their plain versions, with
   and without ``tile_valid``, timed beside ``torch._grouped_mm`` and their
   bound (the ``sdar`` field of their rows in the kernels line);
   G3, the MoE combine (``ops/grouped_gemm_cuda.py::combine``), at the same
   pass (its 1024 slots over m_pad 9216 rows of D 2048), bit-equal to its
   plain chain and timed in turns beside it and its bound, each run queued
   behind a sleeping kernel as in phase 31;
   G4 and G5, the router's top-k and the padded layout with its rows
   (``ops/grouped_gemm_cuda.py::router_topk``, ``routed_layout``), at the
   same pass, at the cell's prefill (147456 slots over m_pad 163840,
   tile_m 128) and at a forward of phase 3's decode (llada-moe-7b's E 64,
   20480 slots; G5 also with ``drop_foreign``, 32 experts held), each
   bit-equal to the chain it replaces and timed in turns beside it and its
   bound (and beside the chain's ``gather_rows``, which writes the pad rows
   G5 leaves unwritten);
   then an ``sdar-tiny`` decode's exact launches: K12 once a layer for
   every step and commit, the block-causal flash kernel once a layer a
   batch, no other attention kernel.
33. Latent attention (kanana30b-ctx32k's kernels): K13
   (``ops/mla_attention.py::mla_cache_attention``) at the cell's cached
   passes (B 4, a block of 4 at 32 heads against 32516 and 32768 latent
   keys of 576, left padding of 0-16128 a row), the prefill kernel (K8's
   block-causal design at q/k heads of 192 and v heads of 128) against its
   plain version on a 4096-position row and timed at the cell's row (32512
   positions, 24480 real), and G4's sigmoid mode at the cell's cached pass
   (16 rows) and prefill row (32512 rows), bit-equal to its chain; each
   timed in turns beside its plain version, its bound and, for the two
   attention kernels, SDPA with an explicit mask (a yardstick the port
   never calls); then a decode of kanana's first two layers at full width
   (one dense, one of 128 experts; B 2, P 256, 4 blocks of 4 steps) with
   its exact launches: K13 once a layer for every step and commit, the
   prefill kernel once a layer a batch, G4's sigmoid mode, G5, G3, K1 and
   K2 once an MoE block, three norms a block.

Every exact launch check above expects the glue kernels too
(:func:`glue_launches`): a block pass launches ``rms_norm`` twice (four
times with qk-norm) and ``swiglu_act`` once (a dense FFN or a shared
expert), an MoE block G3 (``moe_combine``), G4 (``moe_topk``) and G5
(``moe_layout``) once, and a forward its final norm once more; remat runs
a block again, so the glue follows the attention kernel's count a layer.
The kernels-against-plain checks give the plain run the chains of the
combine, the router's top-k and the layout too (``combine_plain``,
``router_topk_plain``, ``routed_layout_plain``).

The bf16 MoE weights are freed before phase 11, the int8 ones before
phase 15, Dream's before phase 16, the dense training state before phase
19, the MoE training state before phase 22.  A rank that fails, or does
not answer in its phase's time, fails its phase.  Prints the first designs' times of the
redesigned flash and grouped kernels (constants from PERF.md, on a line of
their own),
the ``{"kernels": [...]}`` line and, last, the
``{"ok": true, ...}`` line.  Exits 2, printing no result, without a card or
without the port's package beside it (the script run on its own); exits 1
if any phase fails.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# Peak rates of an H100 SXM (NVIDIA data sheet, dense, at 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Main path: llada-moe-7b, batch 8, prompt 64, gen 256, steps 128, block 32.
BATCH, PROMPT, GEN, STEPS, BLOCK = 8, 64, 256, 128, 32
SEQ = PROMPT + GEN

# Tolerances, kernel against plain version on identical bf16 inputs.  Both
# accumulate products in f32 and round once to bf16; they differ only in the
# order of the f32 sums, which moves a result across a bf16 rounding boundary
# at most once: one bf16 ulp, 2**-7 relative, plus an absolute floor for
# results near zero.  Flash also casts P to bf16 against a running max that
# the kernel's 64-key tiles update in steps and the plain version takes over
# all keys at once, so P's rounding differs: two ulps.
GROUPED_TOL = dict(rtol=2 ** -7, atol=1e-3)
FLASH_TOL = dict(rtol=2 ** -6, atol=4e-3)
# Two-layer forward: each layer rounds its activations to bf16 a dozen times,
# so one-ulp differences inside the kernels move the f32 logits by about one
# bf16 ulp (2**-7) of their largest magnitude; the tolerance is four such
# ulps.  A one-ulp difference at a router input also decides near-ties of the
# 8th and 9th expert (a few tokens in a hundred per layer with random
# weights) and then moves that token's logits by far more than any kernel
# error.  So the plain run takes the kernel run's expert choice in every
# layer, and the tolerance holds at every position.
LOGITS_RTOL_OF_MAX = 2 ** -5
# The int8 forward against the bf16 forward on dequantized weights holds to
# the same tolerance: dequantizing rounds each q·s to bf16 (one bf16 ulp of
# the weight), which moves the products no more than a kernel's ulp does.

# The fused expert FFN against its plain version: both round h to bf16 from
# f32 sums taken in different orders, so now and then one h element differs
# by one bf16 ulp (2**-8 relative) and moves out[row, j] by up to
# 2**-8 * |h_i| * |Wd[i, j]| on top of out's own one-ulp rounding.  h never
# leaves the kernel; out is held to GROUPED_TOL plus that term.
H_FLIP = 2 ** -8

# Single-prompt serving (the chat CLI's defaults): B 1, gen 128, steps 128,
# block 32; the prompt is the chat template around the Lean-only system
# message and CHAT_PROMPT, left-padded to the runner's 64-token bucket.
CHAT_PROMPT = "Prove that for every natural number n, n + 0 = n."
CHAT_GEN, CHAT_STEPS = 128, 128
CHAT_BASE_TOKENS = 8
SINGLE_PROMPT_KERNELS = ("grouped_ffn_fused", "flash_attention_direct")

SERVING_KERNELS = ("grouped_gateup", "grouped_down", "flash_attention_fwd")
# The block-cache cell: the decode cell through accel="block-cache", alone and
# with the reference's threshold (bench.py --full's two accel rows).
BLOCK_CACHE_THRESHOLD = 0.9

# Eval sweeps: the bench and minif2f CLIs' defaults (bench: gen 256, steps
# 128, block 32; minif2f: gen 512, steps 128, block 32, avoid_eos and EOS
# truncation; both greedy, 64-token prompt buckets) on EVAL_ENTRIES
# synthetic entries in the datasets' schemas, all in one batch.
EVAL_ENTRIES = 8
OLYMPIAD_PROBLEMS = [
    ("algebra", "Prove that for all real numbers a and b, a ^ 2 + b ^ 2 ≥ 2 * a * b.",
     "(a b : ℝ) : a ^ 2 + b ^ 2 ≥ 2 * a * b"),
    ("number_theory", "Show that for every natural number n, 6 divides n ^ 3 - n.",
     "(n : ℕ) : 6 ∣ n ^ 3 - n"),
    ("inequality", "Let x, y, z be positive reals. Prove that "
     "(x + y + z) * (1 / x + 1 / y + 1 / z) ≥ 9.",
     "(x y z : ℝ) (hx : 0 < x) (hy : 0 < y) (hz : 0 < z) : "
     "(x + y + z) * (1 / x + 1 / y + 1 / z) ≥ 9"),
    ("combinatorics", "Prove that the sum of the binomial coefficients "
     "choose n k over k from 0 to n is 2 ^ n.",
     "(n : ℕ) : ∑ k in Finset.range (n + 1), n.choose k = 2 ^ n"),
]
MINIF2F_HEADER = ("import Mathlib\nimport Aesop\n\nset_option maxHeartbeats 400000\n\n"
                  "open BigOperators Real Nat Topology Rat\n")
INT8_SERVING_KERNELS = ("grouped_gateup_q", "grouped_down_q", "flash_attention_fwd")
BWD_KERNELS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
# The model step's glue kernels (ops/glue.py): every norm and SwiGLU
# activation launches one (counts: glue_launches, which also counts G3, the
# MoE combine, once an MoE block).
GLUE_KERNELS = ("rms_norm", "swiglu_act")
# Phase 31: dense8b-eval's rows (B 4, S 832) at llada-8b's D and F; rms_norm
# takes GLUE_SETS operand sets in turn, so no launch finds its 27 MB input
# in the 50 MB L2 that the previous one left.
GLUE_ROWS, GLUE_D, GLUE_F, GLUE_SETS = 4 * 832, 4096, 12288, 4
GLUE_EPS = 1e-5
# rms_norm's other served rows: llada-moe-7b's qk-norm over its 16 heads of
# 128 (a warp a row), its D 2048, Dream's D 3584.
GLUE_OTHER_ROWS = ((4, 832, 16, 128), (GLUE_ROWS, 2048), (GLUE_ROWS, 3584))
# ≈ 10 ms of a sleeping kernel at the H100's clock: time for the host to
# queue a timed run's calls before the card reaches them.
QUEUE_SLEEP_CYCLES = 20_000_000

# Training shape: llada-8b at full width, 8 of its 32 layers; seq 2048,
# micro-batch 1, grad-accum 4, prompt 64; 5 optimizer steps of 20 rows.
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_PROMPT, TRAIN_STEPS = 8, 2048, 4, 64, 5
# Kernel against plain version at the training shape.  The forward output
# keeps FLASH_TOL.  lse is f32 from scores and sums taken in another order
# than the plain version's (K9 may also fuse the rotation's multiply-add
# where PyTorch rounds twice): a few 1e-4 at most, checked at 2e-3.  The
# backward's f32 outputs sum products of bf16-rounded P and dS whose f32
# sources differ in their last bits; a flipped rounding moves one term by
# one bf16 ulp (2**-8 relative), so each element stays within 2**-6 of
# itself plus 2**-8 of the tensor's largest magnitude.
LSE_ATOL = 2e-3
BWD_RTOL, BWD_ATOL_OF_MAX = 2 ** -6, 2 ** -8
# Two-layer gradients, kernels against plain: one-ulp differences inside the
# attention backward (and the bf16 attention output they feed) reach every
# gradient through a dozen bf16 roundings per layer; expected relative L2
# error per leaf about 2**-8, limit four bf16 ulps (2**-5).  The loss is one
# f32 sum over the masked tokens: 2**-7 relative.
GRAD_REL_L2 = 2 ** -5
LOSS_RTOL = 2 ** -7

# Times of the first designs of the redesigned kernels, copied from PERF.md's
# kernel table (the WMMA designs: the flash kernels with their accumulators
# in shared memory, the int8 grouped pair widening int8 through shared
# memory, the bf16 grouped pair and the fused expert FFN on cp.async and
# mma.sync; dq at T after its unused shared tile went; the direct flash
# kernel with its score rows in shared memory, as timed in the final run
# before its redesign; on an H100 80GB HBM3 at 700 W); constants, not
# measured here.
FIRST_DESIGN_MS = {"flash_attention_fwd": 0.3158, "flash_attention_fwd T": 2.7245,
                   "flash_attention_fwd chat": 0.1324,
                   "flash_attention_fwd Dream geometry": 0.1455,
                   "flash_attention_bwd_dkv": 1.7452, "flash_attention_bwd_dq": 0.9744,
                   "grouped_gateup_q": 1.3266, "grouped_down_q": 0.7082,
                   "grouped_gateup": 1.1576, "grouped_down": 0.5802,
                   "grouped_ffn_fused": 0.8177,
                   "flash_attention_direct chat": 0.0664,
                   "flash_attention_direct Dream geometry": 0.1296}
# Rounds of the in-turn timings; the median of each is reported.
TURNS = 5


def launch_counts(nonzero: bool = False) -> dict:
    """Launches of each kernel since the last reset; ``nonzero`` keeps only
    the kernels launched."""
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import KERNELS

    return {name: k.launches for name, k in KERNELS.items()
            if k.launches or not nonzero}


def glue_launches(cfg, blocks: int, forwards: int) -> dict:
    """``rms_norm`` and ``swiglu_act`` launches of ``forwards`` forwards of
    ``cfg`` that ran ``blocks`` block passes in all (a rank's layers times
    the forwards, twice under remat): two norms a block, four with
    qk-norm; one activation a block with a dense FFN or a shared expert;
    the final norm once a forward.  An MoE model's blocks each launch G3
    (``moe_combine``), G4 (``moe_topk``) and G5 (``moe_layout``) once too;
    a dense model's count has no such keys."""
    act = not cfg.is_moe or cfg.num_shared_experts > 0
    glue = {"rms_norm": (4 if cfg.qk_norm else 2) * blocks + forwards,
            "swiglu_act": blocks if act else 0}
    if cfg.is_moe:
        glue.update(moe_combine=blocks, moe_topk=blocks, moe_layout=blocks)
    return glue


def expected_launches(glue: dict, **counts) -> dict:
    """Every kernel's expected launches: ``glue`` and ``counts``, 0 for the
    rest."""
    want = {n: 0 for n in launch_counts()}
    want.update(glue, **counts)
    return want


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_turns(fns, iters: int, rounds: int = TURNS) -> dict:
    """Median device ms per call of each function in ``fns`` (name → fn),
    timed in turns: each round times every function ``iters`` calls in a
    row, one after the other, so a drift of the card's clock or of its
    neighbours falls on all of them alike."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(time_ms(fn, iters, warmup=0))
    return {name: statistics.median(t) for name, t in times.items()}


def time_turns_queued(fns, iters: int, rounds: int = TURNS) -> dict:
    """As :func:`time_turns`, but each run of ``iters`` calls is queued
    behind a sleeping kernel, so the card runs the calls back to back and
    the host's cost a call (checks, allocation, the ctypes call) stays out
    of a time that is shorter than it."""
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / iters)
    return {name: statistics.median(t) for name, t in times.items()}


def report_rate(label: str, flops: float, ms: float, bound: float) -> dict:
    """Print and return a kernel's achieved TFLOP/s and share of its bound."""
    tflops = flops / ms / 1e9
    share = bound / ms
    print(f"  {label}: {tflops:.1f} TFLOP/s achieved, {share:.4f} of its bound "
          f"({bound:.4f} ms / {ms:.4f} ms)", flush=True)
    return dict(tflops=tflops, bound_share=share)


def ptxas_report(libs) -> None:
    """Print ptxas's entry, register, spill and warning lines (a warning
    names, among others, wgmma products it had to serialize), and the spill
    bytes of the flash forward, dq and dk/dv kernels at head dim 128, of the
    direct flash kernel at head dim 128 (one or two warpgroups with K
    resident, two with K streamed), of the bf16 and int8 grouped kernels and
    of the fused expert FFN, of the flash forward's block-causal mode and of
    K12 at head dim 128 (found by their mangled names)."""
    watch = {"flash_fwd_kernel<128>": "16flash_fwd_kernelILi128ELb0E",
             "flash_fwd_kernel<128, block-causal>": "16flash_fwd_kernelILi128ELb1E",
             "cache_attn_kernel<128>": "17cache_attn_kernelILi128E",
             "mla_prefill_kernel<192, 128>": "18mla_prefill_kernelILi192ELi128E",
             "mla_latent_attn_kernel (K13)": "22mla_latent_attn_kernel",
             "flash_bwd_dq_kernel<128>": "19flash_bwd_dq_kernelILi128E",
             "flash_bwd_dkv_kernel<128>": "20flash_bwd_dkv_kernelILi128E",
             "flash_direct_kernel<128, 1, resident> (chat)":
                 "19flash_direct_kernelILi128ELi1ELb1E",
             "flash_direct_kernel<128, 2, resident> (Dream)":
                 "19flash_direct_kernelILi128ELi2ELb1E",
             "flash_direct_kernel<128, 2, streamed>": "19flash_direct_kernelILi128ELi2ELb0E",
             "grouped_ffn_fused_kernel": "24grouped_ffn_fused_kernel",
             "grouped_gemm_kernel<2> (gate/up)": "19grouped_gemm_kernelILi2E",
             "grouped_gemm_kernel<1> (down)": "19grouped_gemm_kernelILi1E",
             "grouped_gemm_q_kernel<2> (gate/up)": "21grouped_gemm_q_kernelILi2E",
             "grouped_gemm_q_kernel<1> (down)": "21grouped_gemm_q_kernelILi1E"}
    spills = {}
    for lib in libs:
        entry = ""
        for line in lib.path.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line
            elif not ("registers" in line or "spill" in line
                      or "warning" in line.lower()):
                continue
            print(f"  {lib.source.name}: {line.strip()}", flush=True)
            stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            for name, mangled in watch.items():
                if stores and mangled in entry:
                    spills[name] = int(stores.group(1)) + int(stores.group(2))
    print("  spill bytes: " + ", ".join(
        f"{k} {spills.get(k, 'not found')}" for k in watch), flush=True)


def bound_ms(flops: float, nbytes: float):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def compare(name, got, want, rtol, atol):
    err = (got.float() - want.float()).abs()
    max_err = float(err.max())
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    print(f"  {name}: max_abs_err {max_err:.3e} (rtol {rtol:.3g}, atol {atol:.3g}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_err


def skip_pad_check(name, got, want, real):
    """A grouped kernel's output with ``tile_valid``: the rows of ``real``
    tiles against the plain version, every other row zero."""
    err = compare(f"{name} with tile_valid, real rows", got[real], want[real],
                  **GROUPED_TOL)
    if got[~real].any():
        raise AssertionError(f"{name}: a tile that tile_valid marks empty is not zero")
    return err


def grouped_pair_check(label, cfg, blocks, x, topk_idx, li, int8=False,
                       drop_foreign=False):
    """K1 and K2 (K6 and K7 with ``int8``) on the routing ``topk_idx`` of
    ``x`` (layer ``li``'s stacked experts), at the row tile the main path's
    layout takes for it (``layout_tile_m``: 128 from M 65536 up), against
    their plain versions, with the pad-skip vector the main path hands them
    (real rows against the plain versions, the rest zero) and without it.
    ``drop_foreign``: a model rank's local experts, slots of other ranks'
    experts dropped from the layout as the expert-parallel path drops them.
    Returns the layout, the kernels' inputs and their errors."""
    from types import SimpleNamespace

    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg

    q = "_q" if int8 else ""
    gateup, gateup_plain, down, down_plain = (
        getattr(gg, f"grouped_{name}{q}{plain}")
        for name, plain in (("gateup", ""), ("gateup", "_plain"), ("down", ""),
                            ("down", "_plain")))
    K = cfg.num_experts_per_tok
    wg, wu, wd = blocks["we_gate"], blocks["we_up"], blocks["we_down"]
    E = (wg["q"] if int8 else wg).shape[-3]
    n, m = x.shape[0], topk_idx.numel()
    tile_m = gg.layout_tile_m(m)
    dest, tile_expert, sizes, m_pad = gg.counting_layout(topk_idx, E, tile_m,
                                                      drop_foreign)
    xs = gg.gather_rows(x, dest, K, m_pad)
    used = int((sizes > 0).sum())
    print(f"  {label} routing: N {n}, M {m}, tile_m {tile_m}, m_pad {m_pad}, tiles "
          f"{m_pad // tile_m}, experts used {used}/{E}, largest group "
          f"{int(sizes.max())}", flush=True)
    # The pad-skip vector grouped_expert_ffn_cuda hands the pair: tiles with
    # no real row, zero-filled instead of multiplied.
    valid = gg.valid_tiles(sizes, tile_expert, tile_m, m_pad)
    real = valid.repeat_interleave(tile_m) != 0
    print(f"  pad-skip: {int((valid == 0).sum())} of {valid.numel()} tiles hold no "
          f"real row", flush=True)
    h_k = gateup(xs, wg, wu, tile_expert, tile_m, li)
    h_p = gateup_plain(xs, wg, wu, tile_expert, tile_m, li)
    torch.cuda.synchronize()
    err_gateup = max(compare(f"grouped_gateup{q}", h_k, h_p, **GROUPED_TOL), skip_pad_check(
        f"grouped_gateup{q}", gateup(xs, wg, wu, tile_expert, tile_m, li, valid), h_p,
        real))
    del h_k
    # down, on the plain gate/up output for both
    o_k = down(h_p, wd, tile_expert, tile_m, li)
    o_p = down_plain(h_p, wd, tile_expert, tile_m, li)
    torch.cuda.synchronize()
    err_down = max(compare(f"grouped_down{q}", o_k, o_p, **GROUPED_TOL), skip_pad_check(
        f"grouped_down{q}", down(h_p, wd, tile_expert, tile_m, li, valid), o_p, real))
    return SimpleNamespace(tile_m=tile_m, m=m, m_pad=m_pad, used=used, sizes=sizes,
                           tile_expert=tile_expert, valid=valid, xs=xs, h_p=h_p,
                           err_gateup=err_gateup, err_down=err_down)


def grouped_pair_timing(cfg, blocks, pair, li, dev):
    """K1 and K2 on the layout of ``pair`` (:func:`grouped_pair_check`),
    timed in turns with and without ``tile_valid`` and beside
    ``torch._grouped_mm``, their plain versions alone, each against its
    bound on the routed rows' work and bytes.  Returns the two rows and each
    kernel's launch (with ``tile_valid``, as on the main path)."""
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg

    D, E, Fm = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size
    wg, wu, wd = blocks["we_gate"], blocks["we_up"], blocks["we_down"]
    xs, h_p, tile_expert, sizes = pair.xs, pair.h_p, pair.tile_expert, pair.sizes
    tile_m, m_pad, valid, m, used = pair.tile_m, pair.m_pad, pair.valid, pair.m, pair.used
    stream = torch.cuda.current_stream(dev).cuda_stream
    results = []
    pend = torch.cumsum(gg._round_up(sizes, tile_m), 0, dtype=torch.int32)
    grouped_mm = getattr(torch, "_grouped_mm", None)
    L = wg.shape[0]
    bf16 = xs.element_size()
    src = "ct_diffusionmodelbench_tpu_torch/csrc/grouped_gemm.cu"
    ref = "ct_diffusionmodelbench_tpu/ops/grouped_gemm_pallas.py"

    # gate/up
    err = pair.err_gateup
    h_out = torch.empty_like(h_p)

    def gateup(tile_valid):
        return lambda: gg.GATEUP_KERNEL(
            xs.data_ptr(), wg.data_ptr(), wu.data_ptr(), h_out.data_ptr(),
            tile_expert.data_ptr(), m_pad, D, Fm, E, L, li, tile_m, tile_valid, stream)

    p_ms = time_ms(lambda: gg.grouped_gateup_plain(
        xs, wg, wu, tile_expert, tile_m, li, valid), 3, warmup=1)
    fns = {"kernel": gateup(valid.data_ptr()), "no_skip": gateup(None)}
    if grouped_mm is not None:
        w_gu = torch.cat([wg[li], wu[li]], dim=-1)
        fns["library"] = lambda: grouped_mm(xs, w_gu, offs=pend)
    turns = time_turns(fns, 20)
    # Work and bytes of the m routed rows only: the m_pad - m padding rows
    # copy token 0 and carry combine weight 0.
    flops = 4.0 * m * D * Fm
    b_ms, b_by = bound_ms(flops, m * (D + Fm) * bf16 + nbytes(tile_expert)
                          + used * 2 * D * Fm * bf16)
    rate = report_rate("grouped_gateup", flops, turns["kernel"], b_ms)
    results.append(dict(
        name="grouped_gateup", route="cuda", source=src, replaces=f"{ref}:901",
        max_abs_err=err, ms=turns["kernel"], plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=turns.get("library"), no_skip_ms=turns["no_skip"],
        **rate))

    # down, on the plain gate/up output for both
    err = pair.err_down
    o_out = torch.empty_like(xs)

    def down(tile_valid):
        return lambda: gg.DOWN_KERNEL(
            h_p.data_ptr(), wd.data_ptr(), o_out.data_ptr(), tile_expert.data_ptr(),
            m_pad, Fm, D, E, L, li, tile_m, tile_valid, stream)

    p_ms = time_ms(lambda: gg.grouped_down_plain(
        h_p, wd, tile_expert, tile_m, li, valid), 3, warmup=1)
    fns = {"kernel": down(valid.data_ptr()), "no_skip": down(None)}
    if grouped_mm is not None:
        wd_l = wd[li]
        fns["library"] = lambda: grouped_mm(h_p, wd_l, offs=pend)
    turns = time_turns(fns, 20)
    flops = 2.0 * m * Fm * D
    b_ms, b_by = bound_ms(flops, m * (Fm + D) * bf16 + nbytes(tile_expert)
                          + used * Fm * D * bf16)
    rate = report_rate("grouped_down", flops, turns["kernel"], b_ms)
    results.append(dict(
        name="grouped_down", route="cuda", source=src, replaces=f"{ref}:969",
        max_abs_err=err, ms=turns["kernel"], plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=turns.get("library"), no_skip_ms=turns["no_skip"],
        **rate))
    for r in results:
        print(f"  {r['name']}: kernel (with tile_valid, as on the main path) "
              f"{r['ms']:.4f} ms, without {r['no_skip_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library (torch._grouped_mm; in turns with "
              f"the kernel) {r['library_ms']}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
    return results, {"grouped_gateup": gateup(valid.data_ptr()),
                     "grouped_down": down(valid.data_ptr())}


def kernel_phase(cfg, params, dev):
    """Each kernel at the main path's shapes against its plain version."""
    from ct_diffusionmodelbench_tpu_torch.models.layers import apply_rope, rope_angles
    from ct_diffusionmodelbench_tpu_torch.models.moe import router_probs
    from ct_diffusionmodelbench_tpu_torch.models.transformer import token_positions
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    blocks = params["blocks"]
    li = 1
    x = torch.randn((BATCH * SEQ, cfg.hidden_size), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    _, topk_idx, _ = router_probs(x, blocks["router"][li], cfg.num_experts_per_tok,
                                  cfg.norm_topk_prob)
    pair = grouped_pair_check("decode", cfg, blocks, x, topk_idx, li)
    stream = torch.cuda.current_stream(dev).cuda_stream
    results, launch = grouped_pair_timing(cfg, blocks, pair, li, dev)
    host_us_per_launch(launch)
    del pair, launch

    # flash attention: B 8, S 320, H 16, KV 4, Dh 128, RoPE, left padding
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = torch.randn((BATCH, SEQ, H, Dh), generator=gen, device=dev, dtype=torch.bfloat16)
    k = torch.randn((BATCH, SEQ, KV, Dh), generator=gen, device=dev, dtype=torch.bfloat16)
    v = torch.randn((BATCH, SEQ, KV, Dh), generator=gen, device=dev, dtype=torch.bfloat16)
    mask = torch.ones((BATCH, SEQ), dtype=torch.int32, device=dev)
    for b in range(BATCH):
        mask[b, :4 * b] = 0  # left padding of 0, 4, ..., 28 tokens
    cos, sin = rope_angles(token_positions(mask, BATCH, SEQ, dev), Dh, cfg.rope_theta)
    a_k = fa.flash_attention(q, k, v, mask=mask, rope=(cos, sin))
    a_p = fa.flash_attention_plain(q, k, v, mask=mask, rope=(cos, sin))
    torch.cuda.synchronize()
    err = compare("flash_attention_fwd", a_k, a_p, **FLASH_TOL)
    bias = fa.mask_bias(mask, BATCH, SEQ, dev)
    a_out = torch.empty_like(a_k)
    kv_len = fa.kv_tile_len(SEQ)
    p_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, mask=mask, rope=(cos, sin)), 10)
    qr = apply_rope(q, cos, sin).transpose(1, 2)
    kr = apply_rope(k, cos, sin).transpose(1, 2)
    vt = v.transpose(1, 2)
    keep = mask.bool()[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    turns = time_turns({
        "kernel": lambda: fa.FLASH_KERNEL(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), a_out.data_ptr(), None, BATCH, SEQ, kv_len, H, KV, Dh,
            Dh ** -0.5, stream),
        "sdpa": lambda: sdpa(qr, kr, vt, attn_mask=keep, enable_gqa=True)}, 50)
    k_ms, lib_ms = turns["kernel"], turns["sdpa"]
    flops = 4.0 * BATCH * H * SEQ * SEQ * Dh
    b_ms, b_by = bound_ms(flops, nbytes(q, k, v, a_k, bias, cos, sin))
    rate = report_rate("flash_attention_fwd (decode shape)", flops, k_ms, b_ms)
    results.append(dict(
        name="flash_attention_fwd", route="cuda",
        source="ct_diffusionmodelbench_tpu_torch/csrc/flash_attention.cu",
        replaces="ct_diffusionmodelbench_tpu/ops/flash_attention.py:312",
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, **rate))
    r = results[-1]
    print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
          f"library {r['library_ms']}, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']})", flush=True)
    for r in results:
        r["kernel_ms"] = r["ms"]
    return results


def host_us_per_launch(fns, n: int = 200) -> None:
    """Print the host microseconds of one launch of each kernel in ``fns``
    (name → launch): the ctypes call, the tensor maps encoded on the host,
    the launch.  n launches stay under the launch queue's depth, so the host
    never waits for the card."""
    out = {}
    for name, fn in fns.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    print("  host us per launch: " + ", ".join(f"{k} {v:.2f}" for k, v in out.items()),
          flush=True)


def slice_phase(cfg, params, dev):
    """Full-size greedy decode through the port's entry points."""
    from ct_diffusionmodelbench_tpu_torch.models import make_forward_fn
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import reset_launch_counts
    from ct_diffusionmodelbench_tpu_torch.sampling import llada_generate

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    prompt = torch.randint(10, 100000, (BATCH, PROMPT), generator=gen, device=dev)
    fwd = make_forward_fn(cfg)
    kw = dict(steps=STEPS, gen_length=GEN, block_length=BLOCK,
              mask_id=cfg.mask_token_id)
    llada_generate(fwd, params, prompt, **kw)  # warm-up (cuBLAS plans, libs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = llada_generate(fwd, params, prompt, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"  generate: {secs:.4f} s, {BATCH * GEN / secs:.2f} tok/s "
          f"(B {BATCH}, prompt {PROMPT}, gen {GEN}, steps {STEPS}, block {BLOCK})",
          flush=True)
    print(f"  peak memory: {peak / 2**30:.3f} GiB", flush=True)
    print(f"  launches: {json.dumps(launches)}", flush=True)
    per = cfg.num_layers * STEPS
    want = expected_launches(glue_launches(cfg, per, STEPS),
                             **{n: per for n in SERVING_KERNELS})
    bad = {n: c for n, c in launches.items() if c != want[n]}
    if bad:
        raise AssertionError(f"expected {want} launches (each serving kernel, the "
                             f"glue, none of the backward kernels), got {bad}")
    left = int((out[:, PROMPT:] == cfg.mask_token_id).sum())
    print(f"  mask ids left: {left}", flush=True)
    if left:
        raise AssertionError(f"{left} mask ids remain after decoding")
    l1, _ = fwd(params, out, logit_start=PROMPT, logit_length=BLOCK)
    l2, _ = fwd(params, out, logit_start=PROMPT, logit_length=BLOCK)
    same = torch.equal(l1, l2)
    print(f"  repeated forward bit-identical: {same}", flush=True)
    if not same:
        raise AssertionError("two forwards on the same input differ")
    if not torch.isfinite(l1).all():
        raise AssertionError("non-finite logits")
    return dict(seconds=secs, tokens_per_s=BATCH * GEN / secs,
                peak_gib=peak / 2**30, launches=launches, prompt=prompt, out=out)


def pinned_compare(label, cfg2, ids, dev, params_a, params_b, seams_b, mask=None,
                   logit_start=PROMPT, forward=None):
    """Logits of a forward of ``params_a`` (``cfg2``, through the kernels)
    against a forward of ``params_b`` with ``seams_b`` ((module, name, fn)
    swapped in for that run), the second run given the first one's expert
    choice in every layer, in the order the runs route; both on ``ids``
    with the attention ``mask``, logits of the BLOCK positions from
    ``logit_start``, or ``forward(params)``'s logits.  Fails past
    ``LOGITS_RTOL_OF_MAX``."""
    from ct_diffusionmodelbench_tpu_torch.models import make_forward_fn
    from ct_diffusionmodelbench_tpu_torch.models import moe

    if forward is None:
        def forward(params):
            kw = dict(logit_start=logit_start, logit_length=BLOCK)
            return make_forward_fn(cfg2, dev)(params, ids, mask, **kw)[0]

    router_probs = moe.router_probs
    chosen, flipped = [], []  # per layer: run a's top-k; tokens whose own
                              # run-b choice differs from it

    def recording_router(x, w, top_k, norm_topk, *mode):
        out = router_probs(x, w, top_k, norm_topk, *mode)
        chosen.append(out[1])
        return out

    def pinned_router(x, w, top_k, norm_topk, *mode):
        _, own, probs = router_probs(x, w, top_k, norm_topk, *mode)
        idx = chosen[len(flipped)]
        flipped.append((own.sort(dim=-1).values
                        != idx.sort(dim=-1).values).any(dim=-1))
        topk_probs = probs.gather(-1, idx)
        if norm_topk:
            topk_probs = topk_probs / topk_probs.sum(dim=-1, keepdim=True)
        return topk_probs, idx, probs

    seams = [(moe, "router_probs", pinned_router)] + list(seams_b)
    saved = [getattr(mod, name) for mod, name, _ in seams]
    try:
        moe.router_probs = recording_router
        la = forward(params_a)
        for mod, name, fn in seams:
            setattr(mod, name, fn)
        lb = forward(params_b)
    finally:
        for (mod, name, _), fn in zip(seams, saved):
            setattr(mod, name, fn)
    print(f"  {label}: tokens whose own expert choice differs (pinned to the "
          "first run's choice): "
          + ", ".join(f"layer {i} {int(f.sum())}/{f.numel()}"
                      for i, f in enumerate(flipped)), flush=True)
    if not torch.isfinite(la).all():
        raise AssertionError(f"{label}: non-finite logits")
    err_p = (la - lb).abs().amax(dim=-1).flatten()      # per position
    scale = float(lb.abs().max())
    tol = LOGITS_RTOL_OF_MAX * scale
    top2 = lb.topk(2, dim=-1).values.flatten(0, 1)
    gap = top2[:, 0] - top2[:, 1]
    differ = (la.argmax(-1) != lb.argmax(-1)).flatten()
    # The argmax form of the tolerance: it may move only where the second
    # run's top-2 logits lie within 2 * tol of each other.
    clear_moves = int((differ & (gap > 2 * tol)).sum())
    q = torch.quantile(err_p.float(), torch.tensor([0.5, 0.9, 0.99], device=dev))
    print(f"  {label}: max |logit| {scale:.4e}, tolerance {tol:.4e}: "
          f"per-position max_abs_err median {float(q[0]):.4e}, p90 {float(q[1]):.4e}, "
          f"p99 {float(q[2]):.4e}, max {float(err_p.max()):.4e}; "
          f"{int((err_p > tol).sum())}/{err_p.numel()} positions past tolerance; "
          f"argmax differs at {int(differ.sum())} ({int((gap <= 2 * tol).sum())} "
          f"positions have a top-2 gap within 2 * tolerance; {clear_moves} "
          f"moved outside them)", flush=True)
    if float(err_p.max()) > tol or clear_moves:
        raise AssertionError(f"{label}: the two forwards disagree")
    return float(err_p.max())


def depth_phase(cfg, params, ids, dev, mask=None, logit_start=PROMPT,
                label="2-layer logits, kernels vs plain"):
    """2-layer full-width forward: kernels against their plain versions, the
    plain run on the kernel run's expert choice."""
    from ct_diffusionmodelbench_tpu_torch.models import moe
    from ct_diffusionmodelbench_tpu_torch.ops import attention
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg

    # The plain run swaps each kernel's wrapper for its plain version at the
    # one name the model calls it by.
    seams = [(attention, "flash_attention", fa.flash_attention_plain),
             (gg, "grouped_gateup", gg.grouped_gateup_plain),
             (gg, "grouped_down", gg.grouped_down_plain),
             (gg, "combine", gg.combine_plain),
             (gg, "routed_layout", gg.routed_layout_plain),
             (moe, "router_topk", gg.router_topk_plain)]
    cfg2 = cfg.replace(num_layers=2)  # the first two layers of the full stacks
    return pinned_compare(label, cfg2, ids, dev, params, params, seams, mask=mask,
                          logit_start=logit_start)


def chat_runner(cfg, params, dev):
    """The runner ``--preset llada-moe-7b`` builds (``ModelRunner.random_init``
    at seed 0 draws these very weights), around phase 3's tensors."""
    from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner
    from ct_diffusionmodelbench_tpu_torch.io.tokenizer import Tokenizer

    tok = Tokenizer.byte_fallback(vocab_size=cfg.vocab_size,
                                  eos_token_id=cfg.eos_token_id or 2)
    return ModelRunner(cfg, params, tok, device=dev)


def chat_args():
    from ct_diffusionmodelbench_tpu_torch.cli import chat

    return chat.build_parser().parse_args(
        ["--preset", "llada-moe-7b", "--prompt", CHAT_PROMPT,
         "--gen-length", str(CHAT_GEN), "--steps", str(CHAT_STEPS)])


def chat_step_inputs(runner, args):
    """The ids and mask of a chat denoise step: the template around the
    prompt, left-padded to the runner's bucket, then ``gen`` mask ids."""
    from ct_diffusionmodelbench_tpu_torch.cli.chat import build_system

    messages = [{"role": "system", "content": build_system(not args.no_lean_only,
                                                           args.system_message)},
                {"role": "user", "content": args.prompt}]
    text = runner.tokenizer.apply_chat_template(messages, add_generation_prompt=True)
    ids = runner.tokenizer.encode(text, max_length=args.max_length)
    b = runner.prompt_bucket
    p = (len(ids) + b - 1) // b * b
    x = torch.full((1, p + args.gen_length), runner.mask_id, dtype=torch.long)
    x[0, :p - len(ids)] = runner.tokenizer.pad_token_id or 0
    x[0, p - len(ids):p] = torch.tensor(ids)
    mask = torch.ones_like(x, dtype=torch.int32)
    mask[0, :p - len(ids)] = 0
    return x.to(runner.device), mask.to(runner.device), p


def capture_layer(fwd, params, ids, mask, li, **kw):
    """Layer ``li``'s MoE input and expert choice and its flash attention
    inputs (None where the forward calls no flash attention) in one
    forward."""
    from ct_diffusionmodelbench_tpu_torch.models import moe
    from ct_diffusionmodelbench_tpu_torch.ops import attention

    routed, attended = [], []
    router_probs, flash = moe.router_probs, attention.flash_attention

    def recording_router(x, w, top_k, norm_topk, *mode):
        out = router_probs(x, w, top_k, norm_topk, *mode)
        routed.append((x, out[1]))
        return out

    def recording_flash(q, k, v, mask=None, rope=None, block_len=0):
        attended.append((q, k, v, mask, rope))
        return flash(q, k, v, mask=mask, rope=rope, block_len=block_len)

    try:
        moe.router_probs, attention.flash_attention = recording_router, recording_flash
        fwd(params, ids, mask, **kw)
    finally:
        moe.router_probs, attention.flash_attention = router_probs, flash
    return routed[li], attended[li] if attended else None


def direct_case(name, q, k, v, mask, rope, dev, stream):
    """K9 with and without lse against its plain version; times of K9, K8,
    the plain version and SDPA on the same inputs."""
    from ct_diffusionmodelbench_tpu_torch.models.layers import apply_rope
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa

    b, s, h, dh = q.shape
    kv = k.shape[2]
    cos, sin = rope
    out, lse = fa.flash_attention_cuda(q, k, v, mask=mask, rope=rope, with_lse=True)
    out2 = fa.flash_attention_cuda(q, k, v, mask=mask, rope=rope)
    out_p, lse_p = fa.flash_attention_plain(q, k, v, mask=mask, rope=rope, with_lse=True)
    torch.cuda.synchronize()
    err = max(compare(f"flash_attention_direct {name} out", out, out_p, **GROUPED_TOL),
              compare(f"flash_attention_direct {name} out, no lse", out2, out_p,
                      **GROUPED_TOL),
              compare(f"flash_attention_direct {name} lse", lse, lse_p, 0.0, LSE_ATOL))
    bias = fa.mask_bias(mask, b, s, dev)
    buf = torch.empty_like(out)
    kv_len = fa.kv_tile_len(s)

    def raw(kernel):
        return lambda: kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                              cos.data_ptr(), sin.data_ptr(), buf.data_ptr(), None, b,
                              s, kv_len, h, kv, dh, dh ** -0.5, stream)

    p_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, mask=mask, rope=rope), 10)
    qr = apply_rope(q, cos, sin).transpose(1, 2)
    kr = apply_rope(k, cos, sin).transpose(1, 2)
    vt = v.transpose(1, 2)
    keep = mask.bool()[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    turns = time_turns({"K9": raw(fa.DIRECT_KERNEL), "K8": raw(fa.FLASH_KERNEL),
                        "sdpa": lambda: sdpa(qr, kr, vt, attn_mask=keep, enable_gqa=True)},
                       50)
    k_ms, k8_ms, lib_ms = turns["K9"], turns["K8"], turns["sdpa"]
    flops = 4.0 * b * h * s * s * dh
    b_ms, b_by = bound_ms(flops, nbytes(q, k, v, out, bias, cos, sin))
    rate = report_rate(f"flash_attention_direct {name}", flops, k_ms, b_ms)
    print(f"  flash_attention_direct {name} (B {b}, S {s}, H {h}, KV {kv}, Dh {dh}): "
          f"kernel {k_ms:.4f} ms, K8 {k8_ms:.4f} ms, SDPA {lib_ms:.4f} ms in the same "
          f"turns; plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
          f"{rate['bound_share']:.4f} of its bound; before its redesign "
          f"{FIRST_DESIGN_MS[f'flash_attention_direct {name}']} ms (PERF.md)", flush=True)
    return dict(shape=f"B {b}, S {s}, H {h}, KV {kv}, Dh {dh}, RoPE, left padding",
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, k8_ms=k8_ms, **rate)


def single_prompt_kernel_phase(cfg, params, dev):
    """K3 and K9 at the chat path's shapes against their plain versions."""
    from ct_diffusionmodelbench_tpu_torch.models.layers import rope_angles
    from ct_diffusionmodelbench_tpu_torch.models.transformer import token_positions
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg

    runner = chat_runner(cfg, params, dev)
    ids, mask, p = chat_step_inputs(runner, chat_args())
    li = 1
    (x, topk_idx), (q, k, v, amask, rope) = capture_layer(
        runner.forward_fn, params, ids, mask, li, logit_start=p, logit_length=BLOCK)
    D, E, K, Fm = (cfg.hidden_size, cfg.num_experts, cfg.num_experts_per_tok,
                   cfg.moe_intermediate_size)
    blocks = params["blocks"]
    wg, wu, wd = blocks["we_gate"], blocks["we_up"], blocks["we_down"]
    dest, tile_expert, sizes, m_pad = gg.counting_layout(topk_idx, E, gg.TILE_M)
    xs = gg.gather_rows(x, dest, K, m_pad)
    m = x.shape[0] * K
    used = int((sizes > 0).sum())
    print(f"  chat step: prompt {p} (bucketed), S {ids.shape[1]}, N {x.shape[0]}, "
          f"M {m}, m_pad {m_pad}, experts used {used}/{E}, largest group "
          f"{int(sizes.max())}, smallest {int(sizes.min())}", flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    results = []

    # K3: the fused expert FFN on layer 1's routing, stacked weights, with
    # the pad-skip vector grouped_expert_ffn_cuda hands it and without it
    valid = gg.valid_tiles(sizes, tile_expert, gg.TILE_M, m_pad)
    real = valid.repeat_interleave(gg.TILE_M) != 0
    n_valid = int(valid.sum())
    print(f"  pad-skip: {n_valid} of {valid.numel()} tiles hold a real row", flush=True)
    out_k = gg.grouped_ffn_fused(xs, wg, wu, wd, tile_expert, gg.TILE_M, li, valid)
    out_all = gg.grouped_ffn_fused(xs, wg, wu, wd, tile_expert, gg.TILE_M, li)
    h_p = gg.grouped_gateup_plain(xs, wg, wu, tile_expert, gg.TILE_M, li)
    out_p = gg.grouped_down_plain(h_p, wd, tile_expert, gg.TILE_M, li)
    torch.cuda.synchronize()
    flip = H_FLIP * float(h_p.abs().max()) * float(wd[li].abs().max())
    atol = max(GROUPED_TOL["atol"], flip)
    over = int(((out_all.float() - out_p.float()).abs()
                > GROUPED_TOL["atol"] + GROUPED_TOL["rtol"] * out_p.float().abs()).sum())
    print(f"  grouped_ffn_fused: {over}/{out_p.numel()} elements past one bf16 ulp "
          f"(GROUPED_TOL); the flipped-h term adds atol {flip:.3e}", flush=True)
    err = max(compare("grouped_ffn_fused", out_all, out_p, GROUPED_TOL["rtol"], atol),
              compare("grouped_ffn_fused with tile_valid, real rows", out_k[real],
                      out_p[real], GROUPED_TOL["rtol"], atol))
    if out_k[~real].any():
        raise AssertionError("grouped_ffn_fused: a tile that tile_valid marks empty is "
                             "not zero")
    if not torch.equal(out_k, gg.grouped_ffn_fused(xs, wg, wu, wd, tile_expert, gg.TILE_M,
                                                   li, valid)):
        raise AssertionError("grouped_ffn_fused: two calls on the same input differ")
    buf = torch.empty_like(out_k)
    h_buf = torch.empty_like(h_p)
    L = wg.shape[0]

    def fused(tile_valid):
        return lambda: gg.FUSED_KERNEL(
            xs.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), buf.data_ptr(),
            tile_expert.data_ptr(), m_pad, D, Fm, E, L, li, gg.TILE_M, tile_valid, stream)

    def pair():
        gg.GATEUP_KERNEL(xs.data_ptr(), wg.data_ptr(), wu.data_ptr(), h_buf.data_ptr(),
                         tile_expert.data_ptr(), m_pad, D, Fm, E, L, li, gg.TILE_M,
                         valid.data_ptr(), stream)
        gg.DOWN_KERNEL(h_buf.data_ptr(), wd.data_ptr(), buf.data_ptr(),
                       tile_expert.data_ptr(), m_pad, Fm, D, E, L, li, gg.TILE_M,
                       valid.data_ptr(), stream)

    p_ms = time_ms(lambda: gg.grouped_ffn_fused_plain(
        xs, wg, wu, wd, tile_expert, gg.TILE_M, li, valid), 3, warmup=1)
    fns = {"kernel": fused(valid.data_ptr()), "no_skip": fused(None), "pair": pair}
    grouped_mm = getattr(torch, "_grouped_mm", None)
    if grouped_mm is not None:
        pend = torch.cumsum(gg._round_up(sizes, gg.TILE_M), 0, dtype=torch.int32)
        w_gu = torch.cat([wg[li], wu[li]], dim=-1)
        wd_l = wd[li]

        def library():
            gu = grouped_mm(xs, w_gu, offs=pend)
            h = (torch.nn.functional.silu(gu[:, :Fm].float()) * gu[:, Fm:].float()
                 ).to(xs.dtype)
            return grouped_mm(h, wd_l, offs=pend)

        fns["library"] = library
    turns = time_turns(fns, 20)
    k_ms, pair_ms, lib_ms = turns["kernel"], turns["pair"], turns.get("library")
    bf16 = xs.element_size()
    # The m routed rows' x and out once (padding rows copy token 0 and carry
    # combine weight 0), each used expert's three matrices once; h stays on
    # chip.
    flops = 6.0 * m * D * Fm
    b_ms, b_by = bound_ms(flops, 2 * m * D * bf16 + nbytes(tile_expert)
                          + used * 3 * D * Fm * bf16)
    rate = report_rate("grouped_ffn_fused", flops, k_ms, b_ms)
    print(f"  grouped_ffn_fused: kernel (with tile_valid, as on the chat path) "
          f"{k_ms:.4f} ms, without {turns['no_skip']:.4f} ms, pair (K1 + K2 with "
          f"tile_valid) {pair_ms:.4f} ms, library (torch._grouped_mm, silu * up, "
          f"torch._grouped_mm) {lib_ms}, all in turns; plain {p_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    results.append(dict(
        name="grouped_ffn_fused", route="cuda",
        source="ct_diffusionmodelbench_tpu_torch/csrc/grouped_ffn_fused.cu",
        replaces="ct_diffusionmodelbench_tpu/ops/grouped_gemm_pallas.py:670",
        max_abs_err=err, ms=k_ms, kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, pair_ms=pair_ms, no_skip_ms=turns["no_skip"],
        valid_tiles=n_valid, **rate))
    del out_k, out_all, out_p, h_p, buf, h_buf, xs

    # K9: layer 1's attention inputs (H 16, KV 4), then Dream's geometry
    chat = direct_case("chat", q, k, v, amask, rope, dev, stream)
    s = q.shape[1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    qd = torch.randn((1, s, 28, 128), generator=gen, device=dev, dtype=torch.bfloat16)
    kd, vd = (torch.randn((1, s, 4, 128), generator=gen, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    rope_d = rope_angles(token_positions(amask, 1, s, dev), 128, 1000000.0)
    dream = direct_case("Dream geometry", qd, kd, vd, amask, rope_d, dev, stream)
    results.append(dict(
        name="flash_attention_direct", route="cuda",
        source="ct_diffusionmodelbench_tpu_torch/csrc/flash_attention_direct.cu",
        replaces="ct_diffusionmodelbench_tpu/ops/flash_attention.py:118",
        max_abs_err=max(chat["max_abs_err"], dream["max_abs_err"]), ms=chat["ms"],
        kernel_ms=chat["ms"], plain_ms=chat["plain_ms"], bound_ms=chat["bound_ms"],
        bound_by=chat["bound_by"], library_ms=chat["library_ms"], k8_ms=chat["k8_ms"],
        tflops=chat["tflops"], bound_share=chat["bound_share"], dream_geometry=dream))
    return results, runner


@contextlib.contextmanager
def switches_on(*names):
    """Set the environment switches ``names`` to "1" for a phase."""
    saved = {n: os.environ.get(n) for n in names}
    os.environ.update({n: "1" for n in names})
    try:
        yield
    finally:
        for n, v in saved.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v


def chat_slice_phase(runner, dev):
    """``run_chat`` at the chat defaults through K3 and K9, then one short
    ``chat_base._respond``."""
    from ct_diffusionmodelbench_tpu_torch.cli import chat, chat_base
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import KERNELS, reset_launch_counts

    args = chat_args()
    results = []
    generate = runner.generate

    def recording_generate(*a, **kw):
        results.append(generate(*a, **kw))
        return results[-1]

    runner.generate = recording_generate
    try:
        chat.run_chat(runner, args.prompt, args)          # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = chat.run_chat(runner, args.prompt, args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        del runner.generate
    launches = launch_counts()
    out = results[-1].token_ids
    s = len(out)
    p = s - CHAT_GEN
    m = s * runner.cfg.num_experts_per_tok
    m_pad = gg.padded_rows(m, runner.cfg.num_experts, gg.layout_tile_m(m))
    print(f"  run_chat: {secs:.4f} s ({res['latency_sec']} s inside), "
          f"{CHAT_GEN / secs:.2f} tok/s (B 1, prompt {p} bucketed, gen {CHAT_GEN}, "
          f"steps {CHAT_STEPS}, block {args.block_length}; S {s}, M {m}, m_pad {m_pad})",
          flush=True)
    print(f"  launches: {json.dumps(launches)}", flush=True)
    per = runner.cfg.num_layers * CHAT_STEPS
    want = expected_launches(glue_launches(runner.cfg, per, CHAT_STEPS),
                             **{n: per for n in SINGLE_PROMPT_KERNELS})
    bad = {n: c for n, c in launches.items() if c != want[n]}
    if bad:
        raise AssertionError(f"expected {want} launches (K3, K9 and the glue, none "
                             f"of the others), got {bad}")
    left = int((out[p:] == runner.mask_id).sum())
    print(f"  mask ids left: {left}; continuation {len(results[-1].continuation_ids)} "
          f"tokens after EOS truncation", flush=True)
    if left:
        raise AssertionError(f"{left} mask ids remain after decoding")

    base = chat_runner(runner.cfg, runner.params, dev)
    chat_base.as_causal(base)
    base_args = chat_base.build_parser().parse_args(
        ["--max-new-tokens", str(CHAT_BASE_TOKENS), "--temperature", "0"])
    messages = [{"role": "system", "content": chat.BASE_SYSTEM},
                {"role": "user", "content": CHAT_PROMPT}]
    reset_launch_counts()
    t0 = time.perf_counter()
    reply = chat_base._respond(base, messages, base_args)
    torch.cuda.synchronize()
    base_secs = time.perf_counter() - t0
    fused = KERNELS["grouped_ffn_fused"].launches
    print(f"  chat_base._respond (causal, {CHAT_BASE_TOKENS} new tokens): "
          f"{base_secs:.4f} s, {len(reply)} characters, K3 launches {fused}", flush=True)
    if fused != runner.cfg.num_layers * CHAT_BASE_TOKENS:
        raise AssertionError(f"the AR baseline launched K3 {fused} times")
    return dict(seconds=secs, tokens_per_s=CHAT_GEN / secs, launches=launches,
                ids=torch.from_numpy(out)[None].to(dev))


def chat_depth_phase(cfg, params, ids, dev):
    """2-layer full-width forward through K3 and K9 against the same forward
    on their plain versions, the plain run on the kernel run's expert
    choice."""
    from ct_diffusionmodelbench_tpu_torch.models import moe
    from ct_diffusionmodelbench_tpu_torch.ops import attention
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg

    seams = [(attention, "flash_attention", fa.flash_attention_plain),
             (gg, "grouped_ffn_fused", gg.grouped_ffn_fused_plain),
             (gg, "combine", gg.combine_plain),
             (gg, "routed_layout", gg.routed_layout_plain),
             (moe, "router_topk", gg.router_topk_plain)]
    return pinned_compare("2-layer logits through K3 and K9, kernels vs plain",
                          cfg.replace(num_layers=2), ids, dev, params, params, seams)


def dream_slice_phase(dev):
    """Full-size dream-7b through ``ModelRunner.generate`` at B 1 with the
    direct flash kernel."""
    from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import reset_launch_counts

    t0 = time.perf_counter()
    runner = ModelRunner.random_init("dream-7b", seed=0)
    torch.cuda.synchronize()
    cfg = runner.cfg
    print(f"  init dream-7b (ModelRunner.random_init): {cfg.param_count() / 1e9:.3f} G "
          f"params, {tree_bytes(runner.params) / 1e9:.3f} GB of weights, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    from ct_diffusionmodelbench_tpu_torch.cli.chat import build_system

    text = runner.tokenizer.apply_chat_template(
        [{"role": "system", "content": build_system(True)},
         {"role": "user", "content": CHAT_PROMPT}])             # the chat slice's
    kw = dict(gen_length=CHAT_GEN, temperature=0.0, alg="entropy")
    runner.generate(text, steps=8, **kw)                        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = runner.generate(text, steps=CHAT_STEPS, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    out = res.token_ids
    p = len(out) - CHAT_GEN
    print(f"  generate: {secs:.4f} s, {CHAT_GEN / secs:.2f} tok/s (B 1, prompt {p} "
          f"bucketed, gen {CHAT_GEN}, steps {CHAT_STEPS}, temperature 0, entropy, "
          f"top_p 0.95)", flush=True)
    print(f"  peak memory: {peak / 2**30:.3f} GiB", flush=True)
    print(f"  launches: {json.dumps(launches)}", flush=True)
    per = cfg.num_layers * CHAT_STEPS
    want = expected_launches(glue_launches(cfg, per, CHAT_STEPS),
                             flash_attention_direct=per)
    bad = {n: c for n, c in launches.items() if c != want[n]}
    if bad:
        raise AssertionError(f"expected {want} launches (K9 and the glue, none of "
                             f"the others), got {bad}")
    left = int((out[p:] == runner.mask_id).sum())
    print(f"  mask ids left: {left}", flush=True)
    if left:
        raise AssertionError(f"{left} mask ids remain after decoding")
    ids = torch.from_numpy(out)[None].to(dev)
    l1, _ = runner.forward_fn(runner.params, ids, logit_start=p, logit_length=CHAT_GEN)
    l2, _ = runner.forward_fn(runner.params, ids, logit_start=p, logit_length=CHAT_GEN)
    same = torch.equal(l1, l2)
    print(f"  repeated forward bit-identical: {same}", flush=True)
    if not same:
        raise AssertionError("two forwards on the same input differ")
    if not torch.isfinite(l1).all():
        raise AssertionError("non-finite logits")
    return dict(seconds=secs, tokens_per_s=CHAT_GEN / secs, peak_gib=peak / 2**30,
                launches=launches)


def olympiad_entries():
    """EVAL_ENTRIES MathOlympiadBench-schema entries over four categories."""
    out = []
    for i in range(EVAL_ENTRIES):
        category, informal, formal = OLYMPIAD_PROBLEMS[i % len(OLYMPIAD_PROBLEMS)]
        out.append({"problem_id": f"smoke_{i}", "name": f"smoke problem {i}",
                    "category": category, "informal_prefix": f"/-- {informal} -/\n",
                    "formal_statement": f"theorem smoke_{i} {formal} := by"})
    return out


def minif2f_problems(path):
    """EVAL_ENTRIES miniF2F-schema problems (split "test") written to
    ``path``."""
    problems = []
    for i in range(EVAL_ENTRIES):
        _, informal, formal = OLYMPIAD_PROBLEMS[i % len(OLYMPIAD_PROBLEMS)]
        problems.append({"name": f"smoke_{i}", "split": "test",
                         "informal_statement": informal, "header": MINIF2F_HEADER,
                         "formal_statement": f"theorem smoke_{i} {formal} := by"})
    with open(path, "w") as f:
        json.dump(problems, f)


class GenerateRecorder:
    """Wraps ``runner.generate_ids``: the seconds spent inside it (its
    result is copied to the host, so it ends in a device sync) and each
    call's prompt width, prompt attention mask and output ids."""

    def __init__(self, runner):
        self.runner, self.inner = runner, runner.generate_ids
        self.seconds, self.calls = 0.0, []
        runner.generate_ids = self

    def __call__(self, prompt_ids, **kw):
        t0 = time.perf_counter()
        out = self.inner(prompt_ids, **kw)
        self.seconds += time.perf_counter() - t0
        self.calls.append((prompt_ids.shape[-1], kw.get("attn_mask"), out))
        return out

    def close(self):
        del self.runner.generate_ids


def eval_sweep_check(label, runner, rec, launches, secs, args):
    """What both eval phases demand: one generate of the whole batch, no
    mask id left, K1, K2 and K8 launched once per layer and step and no
    other kernel, and the kernels right on the batch the sweep decoded
    (``eval_kernel_check``).  Prints S, M, wall, tokens/s and the share of
    the wall spent outside ``generate_ids``; returns them with the layout's
    tile_m and m_pad."""
    if len(rec.calls) != 1:
        raise AssertionError(f"{label}: {len(rec.calls)} generates, expected one "
                             "batch (a per-sample fallback?)")
    p, _, out = rec.calls[0]
    b, s = out.shape
    gen = args.gen_length
    m = b * s * runner.cfg.num_experts_per_tok
    left = int((out[:, p:] == runner.mask_id).sum())
    outside = 1 - rec.seconds / secs
    print(f"  {label}: {secs:.4f} s, {b * gen / secs:.2f} tok/s (B {b}, prompt {p} "
          f"bucketed, gen {gen}; S {s}, M {m}); generate_ids {rec.seconds:.4f} s, "
          f"{outside:.4f} of the wall outside it", flush=True)
    print(f"  launches: {json.dumps(launches)}", flush=True)
    print(f"  mask ids left: {left}", flush=True)
    per = runner.cfg.num_layers * args.steps
    want = expected_launches(glue_launches(runner.cfg, per, args.steps),
                             **{n: per for n in SERVING_KERNELS})
    bad = {n: c for n, c in launches.items() if c != want[n]}
    if bad:
        raise AssertionError(f"{label}: expected {want} launches (K1, K2, K8 and the "
                             f"glue, none of the others), got {bad}")
    if left:
        raise AssertionError(f"{label}: {left} mask ids remain after decoding")
    pair = eval_kernel_check(label, runner, rec)
    return dict(seconds=secs, tokens_per_s=b * gen / secs, S=s, M=m,
                tile_m=pair.tile_m, m_pad=pair.m_pad, outside_share=outside,
                launches=launches)


def eval_kernel_check(label, runner, rec):
    """K1, K2 and K8 at the sweep's shapes against their plain versions, on
    the batch the sweep decoded (its ids and its prompts' left padding):
    layer 1's grouped pair at its routing and row tile, and its flash
    attention, captured from a 2-layer full-width forward; then that forward
    through the kernels against the same on their plain versions, the plain
    run pinned to the kernel run's expert choice.  Returns the pair's
    layout."""
    from ct_diffusionmodelbench_tpu_torch.models import make_forward_fn
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa

    p, prompt_mask, out = rec.calls[0]
    dev = runner.device
    ids = torch.as_tensor(out, device=dev)
    mask = torch.ones(ids.shape, dtype=torch.int32, device=dev)
    if prompt_mask is not None:
        mask[:, :p] = torch.as_tensor(prompt_mask, dtype=torch.int32, device=dev)
    b, s = ids.shape
    print(f"  {label} batch: B {b}, S {s}, left padding "
          f"{(p - mask[:, :p].sum(dim=1)).tolist()} tokens", flush=True)
    cfg2 = runner.cfg.replace(num_layers=2)
    (x, topk_idx), (q, k, v, amask, rope) = capture_layer(
        make_forward_fn(cfg2, dev), runner.params, ids, mask, 1, logit_start=p,
        logit_length=BLOCK)
    pair = grouped_pair_check(label, runner.cfg, runner.params["blocks"], x, topk_idx, 1)
    a_k = fa.flash_attention(q, k, v, mask=amask, rope=rope)
    a_p = fa.flash_attention_plain(q, k, v, mask=amask, rope=rope)
    torch.cuda.synchronize()
    compare(f"flash_attention_fwd (B {b}, S {s})", a_k, a_p, **FLASH_TOL)
    del x, q, k, v, a_k, a_p
    depth_phase(runner.cfg, runner.params, ids, dev, mask=mask, logit_start=p,
                label=f"{label}: 2-layer logits, kernels vs plain")
    return pair


def eval_sweep_phase(runner):
    """``cli/bench.py``'s sweep at the CLI defaults (llada style, greedy)
    over EVAL_ENTRIES MathOlympiadBench-schema entries in one batch, with the
    fake Lean verifier in the async pool; a warm-up at one step a block
    (the same shapes) first."""
    from ct_diffusionmodelbench_tpu_torch.cli import bench
    from ct_diffusionmodelbench_tpu_torch.eval.benchmark import device_label
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import reset_launch_counts

    entries = olympiad_entries()
    flags = ["--preset", "llada-moe-7b", "--style", "llada", "--batch-size",
             str(EVAL_ENTRIES), "--fake-lean", "--quiet"]
    with tempfile.TemporaryDirectory() as tmp:
        args = bench.build_parser().parse_args(flags + ["--results-dir", f"{tmp}/sweep"])
        bench.run(bench.build_parser().parse_args(
            flags + ["--steps", str(args.gen_length // args.block_length),
                     "--results-dir", f"{tmp}/warm"]), runner, entries)
        rec = GenerateRecorder(runner)
        try:
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            sweep = bench.run(args, runner, entries)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            rec.close()
        launches = launch_counts()
        missing = [f for f in ("results_batch_8.json", "all_results.json",
                               "final_report.json")
                   if not os.path.exists(f"{tmp}/sweep/{f}")]
        if missing:
            raise AssertionError(f"eval sweep: missing artifacts {missing}")
        with open(f"{tmp}/sweep/final_report.json") as f:
            report = json.load(f)
    out = eval_sweep_check("eval sweep", runner, rec, launches, secs, args)
    rows = sweep.results
    failed = [r["index"] for r in rows if not r["generation_success"]]
    unsettled = [r["index"] for r in rows
                 if r["lean_error_message"] == "Lean verifier unavailable"]
    info, metrics = report["benchmark_info"], report["overall_metrics"]
    print(f"  total_samples {info['total_samples']}, device {info['device']}, "
          f"average_generation_time {metrics['average_generation_time']:.4f} s, "
          f"verifier calls {sweep.verifier.calls}, pipelined "
          f"{sweep.pipeline_verification}, failed rows {failed}", flush=True)
    if info["total_samples"] != EVAL_ENTRIES or len(rows) != EVAL_ENTRIES:
        raise AssertionError(f"eval sweep: {info['total_samples']} samples")
    if info["device"] != device_label(runner.device):
        raise AssertionError(f"eval sweep: device {info['device']}")
    if failed:
        raise AssertionError(f"eval sweep: generation failed in rows {failed}")
    if sweep.verifier.calls != EVAL_ENTRIES or not sweep.pipeline_verification \
            or unsettled:
        raise AssertionError(f"eval sweep: {sweep.verifier.calls} verifier calls, "
                             f"rows {unsettled} not settled by the async pool")
    out["average_generation_time"] = metrics["average_generation_time"]
    return out


def minif2f_phase(runner):
    """``cli/minif2f.py`` at the CLI defaults (gen 512, greedy, avoid_eos,
    EOS truncation) over EVAL_ENTRIES miniF2F-schema problems in one batch,
    the fake Lean verifier pipelined; a warm-up at one step a block first."""
    from ct_diffusionmodelbench_tpu_torch.cli import minif2f
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import reset_launch_counts

    with tempfile.TemporaryDirectory() as tmp:
        minif2f_problems(f"{tmp}/minif2f.json")
        flags = ["--preset", "llada-moe-7b", "--json-path", f"{tmp}/minif2f.json",
                 "--fake-lean", "--batch-size", str(EVAL_ENTRIES)]
        args = minif2f.build_parser().parse_args(flags + ["--output-dir", f"{tmp}/out"])
        minif2f.run(minif2f.build_parser().parse_args(
            flags + ["--steps", str(args.gen_length // args.block_length),
                     "--output-dir", f"{tmp}/warm"]), runner)
        rec = GenerateRecorder(runner)
        try:
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            data = minif2f.run(args, runner)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            rec.close()
        launches = launch_counts()
        files = [f for f in os.listdir(f"{tmp}/out")
                 if f.startswith("minif2f_lean4_results_test_")]
    if len(files) != 1:
        raise AssertionError(f"minif2f: result files {files}")
    out = eval_sweep_check("minif2f", runner, rec, launches, secs, args)
    stats, results = data["stats"], data["results"]
    print(f"  stats {json.dumps(stats)} (the fake verifier on random weights)",
          flush=True)
    if stats["total"] != EVAL_ENTRIES or stats["errors"]:
        raise AssertionError(f"minif2f: {stats}")
    incomplete = [r["name"] for r in results
                  if not {"generated_proof", "verified", "verification_time_sec"} <= set(r)
                  or r.get("verification_message") == "Verification skipped"]
    if incomplete:
        raise AssertionError(f"minif2f: rows without a verified result: {incomplete}")
    out["verified"] = stats["verified"]
    return out


class FlagReads:
    """Wraps ``sampling/llada.py::block_has_mask``, the threshold loop's
    one host read a forward: each read's block (its view's address), result
    and host seconds (the wait for the card to finish the forward, then the
    copy)."""

    def __init__(self):
        from ct_diffusionmodelbench_tpu_torch.sampling import llada

        self.module, self.inner = llada, llada.block_has_mask
        self.reads = []
        llada.block_has_mask = self

    def __call__(self, x_blk, mask_id):
        t0 = time.perf_counter()
        has = self.inner(x_blk, mask_id)
        self.reads.append((x_blk.data_ptr(), has, time.perf_counter() - t0))
        return has

    def close(self):
        self.module.block_has_mask = self.inner

    def iterations(self):
        """Forwards per block, in block order."""
        per = {}
        for ptr, has, _ in self.reads:
            per[ptr] = per.get(ptr, 0) + int(has)
        return list(per.values())


def block_cache_row(label, runner, prompt, exact, **extra):
    """One full-size ``generate_ids`` through the block cache (after a
    warm-up of the same call): wall s, tokens/s beside the exact decode's,
    peak memory, launches, forwards per block, the threshold loop's host
    reads, no mask id left, and the share of tokens equal to the exact
    greedy run's (printed, not checked: the cache approximates a deep
    model)."""
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import reset_launch_counts

    cfg = runner.cfg
    kw = dict(steps=STEPS, gen_length=GEN, block_length=BLOCK, **extra)
    runner.generate_ids(prompt, **kw)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reads = FlagReads()
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        out = runner.generate_ids(prompt, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        reads.close()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    iters = reads.iterations() if reads.reads else [STEPS // (GEN // BLOCK)] * (GEN // BLOCK)
    forwards = sum(iters)
    read_s = sum(t for _, _, t in reads.reads)
    same = float((torch.from_numpy(out[:, PROMPT:]) == exact["out"][:, PROMPT:].cpu())
                 .float().mean())
    print(f"  {label}: {secs:.4f} s, {BATCH * GEN / secs:.2f} tok/s (exact decode "
          f"{exact['tokens_per_s']:.2f} tok/s in phase 3), peak memory "
          f"{peak / 2**30:.3f} GiB; {forwards} forwards ({len(iters)} refreshes), "
          f"forwards per block {iters}", flush=True)
    if reads.reads:
        print(f"  {label}: {len(reads.reads)} host reads of the loop's flag, "
              f"{read_s:.4f} s blocked in them ({read_s / len(reads.reads) * 1e6:.1f} us a "
              f"read, {read_s / secs:.4f} of the wall)", flush=True)
    print(f"  launches: {json.dumps(launches)}", flush=True)
    left = int((out[:, PROMPT:] == runner.mask_id).sum())
    print(f"  mask ids left: {left}; tokens equal to the exact greedy run's: {same:.4f} "
          f"(not checked)", flush=True)
    return dict(seconds=secs, tokens_per_s=BATCH * GEN / secs, peak_gib=peak / 2**30,
                launches=launches, forwards=forwards, iterations=iters,
                flag_reads=len(reads.reads), flag_read_s=read_s, same_share=same,
                mask_left=left, out=out)


def check_block_cache_launches(label, row, kernels, cfg):
    """K8 once per layer and refresh, the FFN pair and the glue once per
    layer and forward (refreshes and cached steps), no other kernel."""
    attn, gateup, down = kernels
    per_forward = row["forwards"] * cfg.num_layers
    want = expected_launches(glue_launches(cfg, per_forward, row["forwards"]),
                             **{attn: len(row["iterations"]) * cfg.num_layers,
                                gateup: per_forward, down: per_forward})
    bad = {n: c for n, c in row["launches"].items() if c != want[n]}
    if bad:
        raise AssertionError(f"{label}: expected launches {want} and none of the others, "
                             f"got {bad}")
    if row["mask_left"]:
        raise AssertionError(f"{label}: {row['mask_left']} mask ids remain after decoding")


def left_padded_mask(dev):
    mask = torch.ones((BATCH, SEQ), dtype=torch.int32, device=dev)
    for b in range(BATCH):
        mask[b, :4 * b] = 0  # left padding of 0, 4, ..., 28 tokens
    return mask


def cached_step_routing(cfg, params, ids, mask, dev):
    """Layer 1's MoE input and expert choice in a 2-layer cached step on the
    first generated block of ``ids`` (M = B · BLOCK · top-k), against the
    cache of a 2-layer refresh."""
    from ct_diffusionmodelbench_tpu_torch.models import make_cached_fns

    refresh_fn, step_fn, _ = make_cached_fns(cfg.replace(num_layers=2))
    with torch.inference_mode():
        _, kc, vc = refresh_fn(params, ids, mask, PROMPT, BLOCK)
        (x, topk_idx), attended = capture_layer(
            lambda p, i, m: step_fn(p, i[:, PROMPT:PROMPT + BLOCK], PROMPT, kc, vc, m),
            params, ids, mask, 1)
    if attended is not None:
        raise AssertionError("the cached step called the flash kernel")
    return x, topk_idx


def cached_pair_timing(label, cfg, blocks, pair, dev, int8=False):
    """The pair's kernels at the cached step's layout with ``tile_valid``,
    as the path launches them: device ms beside the bound of the routed
    rows."""
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg

    D, E, Fm = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size
    tile_m, m, m_pad, used, li = pair.tile_m, pair.m, pair.m_pad, pair.used, 1
    wg, wu, wd = blocks["we_gate"], blocks["we_up"], blocks["we_down"]
    xs, h_p, te, valid = pair.xs, pair.h_p, pair.tile_expert.data_ptr(), pair.valid.data_ptr()
    h_out, o_out = torch.empty_like(h_p), torch.empty_like(xs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if int8:
        g_ms = time_ms(lambda: gg.GATEUP_Q_KERNEL(
            xs.data_ptr(), wg["q"].data_ptr(), wu["q"].data_ptr(), wg["s"].data_ptr(),
            wu["s"].data_ptr(), h_out.data_ptr(), te, m_pad, D, Fm, E, li, tile_m, valid,
            stream), 20)
        d_ms = time_ms(lambda: gg.DOWN_Q_KERNEL(
            h_p.data_ptr(), wd["q"].data_ptr(), wd["s"].data_ptr(), o_out.data_ptr(), te,
            m_pad, Fm, D, E, li, tile_m, valid, stream), 20)
    else:
        L = wg.shape[0]
        g_ms = time_ms(lambda: gg.GATEUP_KERNEL(
            xs.data_ptr(), wg.data_ptr(), wu.data_ptr(), h_out.data_ptr(), te, m_pad, D,
            Fm, E, L, li, tile_m, valid, stream), 20)
        d_ms = time_ms(lambda: gg.DOWN_KERNEL(
            h_p.data_ptr(), wd.data_ptr(), o_out.data_ptr(), te, m_pad, Fm, D, E, L, li,
            tile_m, valid, stream), 20)
    bf16 = xs.element_size()
    # each used expert's weights once: int8 with f32 per-output-channel scales
    g_w = 2 * (D * Fm + 4 * Fm) if int8 else 2 * D * Fm * bf16
    d_w = Fm * D + 4 * D if int8 else Fm * D * bf16
    g_bound = bound_ms(4.0 * m * D * Fm, m * (D + Fm) * bf16 + nbytes(pair.tile_expert)
                       + used * g_w)
    d_bound = bound_ms(2.0 * m * Fm * D, m * (Fm + D) * bf16 + nbytes(pair.tile_expert)
                       + used * d_w)
    q = "_q" if int8 else ""
    print(f"  {label} (M {m}, tile_m {tile_m}, m_pad {m_pad}, experts used {used}/{E}; "
          f"with tile_valid): grouped_gateup{q} {g_ms:.4f} ms, bound {g_bound[0]:.4f} ms "
          f"({g_bound[1]}); grouped_down{q} {d_ms:.4f} ms, bound {d_bound[0]:.4f} ms "
          f"({d_bound[1]})", flush=True)
    common = dict(m=m, tile_m=tile_m, m_pad=m_pad, experts_used=used)
    return (dict(common, ms=g_ms, bound_ms=g_bound[0], bound_by=g_bound[1],
                 max_abs_err=pair.err_gateup),
            dict(common, ms=d_ms, bound_ms=d_bound[0], bound_by=d_bound[1],
                 max_abs_err=pair.err_down))


def block_cache_phase(cfg, params, dev, exact):
    """The decode cell through ``ModelRunner(..., accel="block-cache")``:
    (a) the cache alone, (b) with ``parallel_threshold`` 0.9 (the reference
    ``bench.py --full``'s two accel rows); then the path's kernels at its new
    shapes against their plain versions: K8 without RoPE on the refresh's
    rotated q/k, K1/K2 at a cached step's routing, and a 2-layer refresh plus
    cached step through the kernels against the same on the plain
    versions."""
    from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner
    from ct_diffusionmodelbench_tpu_torch.io.tokenizer import Tokenizer
    from ct_diffusionmodelbench_tpu_torch.models import make_cached_fns, moe
    from ct_diffusionmodelbench_tpu_torch.ops import attention
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg

    tok = Tokenizer.byte_fallback(vocab_size=cfg.vocab_size,
                                  eos_token_id=cfg.eos_token_id or 2)
    runner = ModelRunner(cfg, params, tok, accel="block-cache", device=dev)
    prompt = exact["prompt"].cpu().numpy()
    kernels = ("flash_attention_fwd", "grouped_gateup", "grouped_down")
    rows = {}
    for row, label, extra in (("a", "(a) block cache", {}),
                              ("b", f"(b) block cache, parallel_threshold "
                                    f"{BLOCK_CACHE_THRESHOLD}",
                               dict(parallel_threshold=BLOCK_CACHE_THRESHOLD))):
        rows[row] = block_cache_row(label, runner, prompt, exact, **extra)
        check_block_cache_launches(label, rows[row], kernels, cfg)
    if rows["a"]["flag_reads"]:
        raise AssertionError("the fixed schedule read a flag on the host")

    # the kernels at the path's shapes, on the batch (a) decoded, left-padded
    ids = torch.from_numpy(rows["a"]["out"]).to(dev)
    mask = left_padded_mask(dev)
    cfg2 = cfg.replace(num_layers=2)
    refresh2, step2, _ = make_cached_fns(cfg2)
    with torch.inference_mode():
        _, (q, k, v, amask, rope) = capture_layer(
            lambda p, i, m: refresh2(p, i, m, PROMPT, BLOCK), params, ids, mask, 1)
    if rope is not None:
        raise AssertionError("the refresh handed K8 a rotation")
    a_k = fa.flash_attention(q, k, v, mask=amask)
    a_p = fa.flash_attention_plain(q, k, v, mask=amask)
    torch.cuda.synchronize()
    err_k8 = compare(f"flash_attention_fwd, no RoPE (refresh layer 1, B {BATCH}, S {SEQ}, "
                     "left padding)", a_k, a_p, **FLASH_TOL)
    bias = fa.mask_bias(amask, BATCH, SEQ, dev)
    a_out = torch.empty_like(a_k)
    stream = torch.cuda.current_stream(dev).cuda_stream
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    k8_ms = time_ms(lambda: fa.FLASH_KERNEL(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), None, None,
        a_out.data_ptr(), None, BATCH, SEQ, fa.kv_tile_len(SEQ), H, KV, Dh, Dh ** -0.5,
        stream), 50)
    k8_bound = bound_ms(4.0 * BATCH * H * SEQ * SEQ * Dh, nbytes(q, k, v, a_k, bias))
    print(f"  flash_attention_fwd without RoPE (refresh): {k8_ms:.4f} ms, bound "
          f"{k8_bound[0]:.4f} ms ({k8_bound[1]})", flush=True)
    del q, k, v, a_k, a_p, a_out

    x, topk_idx = cached_step_routing(cfg, params, ids, mask, dev)
    m = topk_idx.numel()
    tile_m = gg.layout_tile_m(m)
    print(f"  cached step: M {m}, layout_tile_m {tile_m}, padded_rows "
          f"{gg.padded_rows(m, cfg.num_experts, tile_m)}", flush=True)
    pair = grouped_pair_check("cached step", cfg, params["blocks"], x, topk_idx, 1)
    g_cached, d_cached = cached_pair_timing("cached step pair", cfg, params["blocks"],
                                            pair, dev)
    del pair, x

    def refresh_and_step(p):
        with torch.inference_mode():
            lr, kc, vc = refresh2(p, ids, mask, PROMPT, BLOCK)
            ls = step2(p, ids[:, PROMPT:PROMPT + BLOCK], PROMPT, kc, vc, mask)
        return torch.cat([lr, ls], dim=1)

    seams = [(attention, "flash_attention", fa.flash_attention_plain),
             (gg, "grouped_gateup", gg.grouped_gateup_plain),
             (gg, "grouped_down", gg.grouped_down_plain),
             (gg, "combine", gg.combine_plain),
             (gg, "routed_layout", gg.routed_layout_plain),
             (moe, "router_topk", gg.router_topk_plain)]
    err_logits = pinned_compare("2-layer refresh + cached step logits, kernels vs plain",
                                cfg2, ids, dev, params, params, seams,
                                forward=refresh_and_step)
    for r in rows.values():
        del r["out"]
    return dict(rows=rows, refresh_no_rope=dict(
        max_abs_err=err_k8, ms=k8_ms, bound_ms=k8_bound[0], bound_by=k8_bound[1]),
        cached_gateup=g_cached, cached_down=d_cached, logits_err=err_logits)


def int8_block_cache_phase(runner, dev, exact_int8):
    """One full-size int8 ``generate_ids`` through the block cache (a runner
    with ``accel="block-cache"`` on the int8 weights), and K6/K7 at a cached
    step's routing against their plain versions."""
    from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner

    cfg = runner.cfg
    bc = ModelRunner(cfg, runner.params, runner.tokenizer, accel="block-cache",
                     quant="int8", device=dev)
    prompt = exact_int8["out"][:, :PROMPT].cpu().numpy()
    row = block_cache_row("int8 block cache", bc, prompt, exact_int8)
    check_block_cache_launches("int8 block cache", row, (
        "flash_attention_fwd", "grouped_gateup_q", "grouped_down_q"), cfg)
    ids = torch.from_numpy(row.pop("out")).to(dev)
    x, topk_idx = cached_step_routing(cfg, runner.params, ids, left_padded_mask(dev), dev)
    pair = grouped_pair_check("int8 cached step", cfg, runner.params["blocks"], x, topk_idx,
                              1, int8=True)
    g_cached, d_cached = cached_pair_timing("int8 cached step pair", cfg,
                                            runner.params["blocks"], pair, dev, int8=True)
    return dict(row=row, cached_gateup=g_cached, cached_down=d_cached)


def tree_bytes(tree) -> int:
    return sum(tree_bytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
               for v in tree.values())


def int8_kernel_phase(runner, dev):
    """The int8 pair at the main path's shapes, on the layer-1 routing of a
    full-size int8 forward, against their plain versions."""
    from ct_diffusionmodelbench_tpu_torch.models import moe
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg
    from ct_diffusionmodelbench_tpu_torch.ops.quant import dequantize_tensor

    cfg, params = runner.cfg, runner.params
    D, E, K, Fm = (cfg.hidden_size, cfg.num_experts, cfg.num_experts_per_tok,
                   cfg.moe_intermediate_size)
    li = 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    ids = torch.randint(10, 100000, (BATCH, SEQ), generator=gen, device=dev)
    seen = []
    router_probs = moe.router_probs

    def recording_router(x, w, top_k, norm_topk, *mode):
        out = router_probs(x, w, top_k, norm_topk, *mode)
        seen.append((x, out[1]))
        return out

    try:
        moe.router_probs = recording_router
        runner.forward_fn(params, ids, logit_start=PROMPT, logit_length=BLOCK)
    finally:
        moe.router_probs = router_probs
    x, topk_idx = seen[li]
    del seen
    blocks = params["blocks"]
    qg, qu, qd = blocks["we_gate"], blocks["we_up"], blocks["we_down"]
    dest, tile_expert, sizes, m_pad = gg.counting_layout(topk_idx, E, gg.TILE_M)
    xs = gg.gather_rows(x, dest, K, m_pad)
    m = x.shape[0] * K
    used = int((sizes > 0).sum())
    print(f"  routing of layer {li} in a full-size int8 forward: N {x.shape[0]}, "
          f"M {m}, m_pad {m_pad}, experts used {used}/{E}, largest group "
          f"{int(sizes.max())}, smallest {int(sizes.min())}", flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    pend = torch.cumsum(gg._round_up(sizes, gg.TILE_M), 0, dtype=torch.int32)
    grouped_mm = getattr(torch, "_grouped_mm", None)
    bf16 = xs.element_size()
    src = "ct_diffusionmodelbench_tpu_torch/csrc/grouped_gemm_q.cu"
    ref = "ct_diffusionmodelbench_tpu/ops/grouped_gemm_pallas.py"
    results = []

    def layer_deq(w):
        return dequantize_tensor({"q": w["q"][li], "s": w["s"][li]}, torch.bfloat16)

    # The pad-skip vector grouped_expert_ffn_cuda hands the pair: tiles with
    # no real row, zero-filled instead of multiplied.
    valid = gg.valid_tiles(sizes, tile_expert, gg.TILE_M, m_pad)
    real = valid.repeat_interleave(gg.TILE_M) != 0
    print(f"  pad-skip: {int((valid == 0).sum())} of {valid.numel()} tiles hold no "
          f"real row", flush=True)

    # gate/up
    h_k = gg.grouped_gateup_q(xs, qg, qu, tile_expert, gg.TILE_M, li)
    h_p = gg.grouped_gateup_q_plain(xs, qg, qu, tile_expert, gg.TILE_M, li)
    torch.cuda.synchronize()
    err = max(compare("grouped_gateup_q", h_k, h_p, **GROUPED_TOL), skip_pad_check(
        "grouped_gateup_q",
        gg.grouped_gateup_q(xs, qg, qu, tile_expert, gg.TILE_M, li, valid), h_p, real))
    h_out = torch.empty_like(h_k)

    def gateup(tile_valid):
        return lambda: gg.GATEUP_Q_KERNEL(
            xs.data_ptr(), qg["q"].data_ptr(), qu["q"].data_ptr(), qg["s"].data_ptr(),
            qu["s"].data_ptr(), h_out.data_ptr(), tile_expert.data_ptr(), m_pad, D, Fm,
            E, li, gg.TILE_M, tile_valid, stream)

    p_ms = time_ms(lambda: gg.grouped_gateup_q_plain(
        xs, qg, qu, tile_expert, gg.TILE_M, li, valid), 3, warmup=1)
    fns = {"kernel": gateup(valid.data_ptr()), "no_skip": gateup(None)}
    if grouped_mm is not None:
        w_gu = torch.cat([layer_deq(qg), layer_deq(qu)], dim=-1)
        fns["library"] = lambda: grouped_mm(xs, w_gu, offs=pend)
    turns = time_turns(fns, 20)
    # The m routed rows' bytes (padding rows copy token 0, weight 0), each
    # used expert's two int8 matrices and their f32 scales once.
    flops = 4.0 * m * D * Fm
    b_ms, b_by = bound_ms(flops, m * (D + Fm) * bf16 + nbytes(tile_expert)
                          + used * 2 * (D * Fm + 4 * Fm))
    rate = report_rate("grouped_gateup_q", flops, turns["kernel"], b_ms)
    results.append(dict(
        name="grouped_gateup_q", route="cuda", source=src, replaces=f"{ref}:1172",
        max_abs_err=err, ms=turns["kernel"], plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=turns.get("library"), no_skip_ms=turns["no_skip"],
        **rate))

    # down, on the plain gate/up output for both
    o_k = gg.grouped_down_q(h_p, qd, tile_expert, gg.TILE_M, li)
    o_p = gg.grouped_down_q_plain(h_p, qd, tile_expert, gg.TILE_M, li)
    torch.cuda.synchronize()
    err = max(compare("grouped_down_q", o_k, o_p, **GROUPED_TOL), skip_pad_check(
        "grouped_down_q",
        gg.grouped_down_q(h_p, qd, tile_expert, gg.TILE_M, li, valid), o_p, real))
    o_out = torch.empty_like(o_k)

    def down(tile_valid):
        return lambda: gg.DOWN_Q_KERNEL(
            h_p.data_ptr(), qd["q"].data_ptr(), qd["s"].data_ptr(), o_out.data_ptr(),
            tile_expert.data_ptr(), m_pad, Fm, D, E, li, gg.TILE_M, tile_valid, stream)

    p_ms = time_ms(lambda: gg.grouped_down_q_plain(
        h_p, qd, tile_expert, gg.TILE_M, li, valid), 3, warmup=1)
    fns = {"kernel": down(valid.data_ptr()), "no_skip": down(None)}
    if grouped_mm is not None:
        wd_l = layer_deq(qd)
        fns["library"] = lambda: grouped_mm(h_p, wd_l, offs=pend)
    turns = time_turns(fns, 20)
    flops = 2.0 * m * Fm * D
    b_ms, b_by = bound_ms(flops, m * (Fm + D) * bf16 + nbytes(tile_expert)
                          + used * (Fm * D + 4 * D))
    rate = report_rate("grouped_down_q", flops, turns["kernel"], b_ms)
    results.append(dict(
        name="grouped_down_q", route="cuda", source=src, replaces=f"{ref}:1242",
        max_abs_err=err, ms=turns["kernel"], plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=turns.get("library"), no_skip_ms=turns["no_skip"],
        **rate))
    for r in results:
        r["kernel_ms"] = r["ms"]
        print(f"  {r['name']}: kernel (with tile_valid, as on the main path) "
              f"{r['ms']:.4f} ms, without {r['no_skip_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library "
              f"(torch._grouped_mm on weights dequantized to bf16 beforehand, not "
              f"timed; in turns with the kernel) {r['library_ms']}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    return results


def int8_slice_phase(runner, dev):
    """Full-size int8 greedy decode through ``ModelRunner.generate_ids``."""
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import reset_launch_counts

    cfg = runner.cfg
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)   # the bf16 slice's prompt
    prompt = torch.randint(10, 100000, (BATCH, PROMPT), generator=gen,
                           device=dev).cpu().numpy()
    kw = dict(steps=STEPS, gen_length=GEN, block_length=BLOCK)
    runner.generate_ids(prompt, **kw)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = runner.generate_ids(prompt, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"  generate_ids: {secs:.4f} s, {BATCH * GEN / secs:.2f} tok/s "
          f"(B {BATCH}, prompt {PROMPT}, gen {GEN}, steps {STEPS}, block {BLOCK})",
          flush=True)
    print(f"  peak memory: {peak / 2**30:.3f} GiB", flush=True)
    print(f"  launches: {json.dumps(launches)}", flush=True)
    per = cfg.num_layers * STEPS
    want = expected_launches(glue_launches(cfg, per, STEPS),
                             **{n: per for n in INT8_SERVING_KERNELS})
    bad = {n: c for n, c in launches.items() if c != want[n]}
    if bad:
        raise AssertionError(f"expected {want} launches (each int8 serving kernel "
                             f"and the glue, none of the others), got {bad}")
    left = int((out[:, PROMPT:] == runner.mask_id).sum())
    print(f"  mask ids left: {left}", flush=True)
    if left:
        raise AssertionError(f"{left} mask ids remain after decoding")
    ids = torch.from_numpy(out).to(dev)
    l1, _ = runner.forward_fn(runner.params, ids, logit_start=PROMPT, logit_length=BLOCK)
    l2, _ = runner.forward_fn(runner.params, ids, logit_start=PROMPT, logit_length=BLOCK)
    same = torch.equal(l1, l2)
    print(f"  repeated forward bit-identical: {same}", flush=True)
    if not same:
        raise AssertionError("two forwards on the same input differ")
    if not torch.isfinite(l1).all():
        raise AssertionError("non-finite logits")
    return dict(seconds=secs, tokens_per_s=BATCH * GEN / secs,
                peak_gib=peak / 2**30, launches=launches, out=ids)


def quant_phase(cfg, qparams, ids, dev):
    """2 layers at full width: the int8 forward against the bf16 forward on
    the dequantized weights (the same function), and the int8 kernels
    against their plain versions; expert choice shared in both."""
    from ct_diffusionmodelbench_tpu_torch.models import moe
    from ct_diffusionmodelbench_tpu_torch.ops import attention
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg
    from ct_diffusionmodelbench_tpu_torch.ops.quant import dequantize_tensor, is_quantized

    def first2(v):
        return {"q": v["q"][:2], "s": v["s"][:2]} if is_quantized(v) else v[:2]

    dt = qparams["embed"].dtype   # the model dtype: bf16 on the card

    def deq(v):
        return dequantize_tensor(v, dt) if is_quantized(v) else v

    cfg2 = cfg.replace(num_layers=2)
    q2 = dict(qparams, blocks={k: first2(v) for k, v in qparams["blocks"].items()})
    d2 = {k: deq(v) for k, v in q2.items() if k != "blocks"}
    d2["blocks"] = {k: deq(v) for k, v in q2["blocks"].items()}
    err_deq = pinned_compare("2-layer logits, int8 vs bf16 on the dequantized "
                             "weights", cfg2, ids, dev, q2, d2, [])
    del d2
    seams = [(attention, "flash_attention", fa.flash_attention_plain),
             (gg, "grouped_gateup_q", gg.grouped_gateup_q_plain),
             (gg, "grouped_down_q", gg.grouped_down_q_plain),
             (gg, "combine", gg.combine_plain),
             (gg, "routed_layout", gg.routed_layout_plain),
             (moe, "router_topk", gg.router_topk_plain)]
    err_plain = pinned_compare("2-layer int8 logits, kernels vs plain", cfg2, ids,
                               dev, q2, q2, seams)
    return err_deq, err_plain


def attention_case(dev, b, s, h, kv, dh, seed, pad=0):
    """Seeded bf16 q, k, v, dO; a mask with ``pad`` left-padding keys in the
    last row (or none); RoPE tables at llada-8b's theta."""
    from ct_diffusionmodelbench_tpu_torch.models.layers import rope_angles
    from ct_diffusionmodelbench_tpu_torch.models.transformer import token_positions

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, do = (torch.randn((b, s, h, dh), generator=gen, device=dev,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, s, kv, dh), generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    mask = None
    if pad:
        mask = torch.ones((b, s), dtype=torch.int32, device=dev)
        mask[-1, :pad] = 0
    rope = rope_angles(token_positions(mask, b, s, dev), dh, 500000.0)
    return q, k, v, do, mask, rope


def compare_bwd(name, got, want):
    return max(compare(f"{name} {label}", g, w, BWD_RTOL,
                       BWD_ATOL_OF_MAX * float(w.abs().max()))
               for label, g, w in zip(("dq", "dk", "dv"), got, want))


def attention_train_check(label, dev, b, h, kv, pad, seed):
    """K8 with lse, then K10 / K11 on its output, at S 2048 and head dim 128
    against their plain versions.  Returns (errors, the kernels' inputs and
    outputs)."""
    from types import SimpleNamespace

    from ct_diffusionmodelbench_tpu_torch.models.layers import apply_rope
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention_bwd as fab

    S, Dh = TRAIN_SEQ, 128
    q, k, v, do, mask, rope = attention_case(dev, b, S, h, kv, Dh, seed, pad)
    out, lse = fa.flash_attention_cuda(q, k, v, mask=mask, rope=rope, with_lse=True)
    out_p, lse_p = fa.flash_attention_plain(q, k, v, mask=mask, rope=rope,
                                            with_lse=True)
    torch.cuda.synchronize()
    err_fwd = max(compare(f"{label} fwd out", out, out_p, **FLASH_TOL),
                  compare(f"{label} fwd lse", lse, lse_p, 0.0, LSE_ATOL))
    qr, kr = apply_rope(q, *rope), apply_rope(k, *rope)
    bias = fa.mask_bias(mask, b, S, dev)
    got = fab.flash_attention_bwd(qr, kr, v, bias, out, do, lse)
    want = fab.flash_attention_bwd_plain(qr, kr, v, bias, out, do, lse)
    torch.cuda.synchronize()
    err_bwd = compare_bwd(label, got, want)
    return SimpleNamespace(err_fwd=err_fwd, err_bwd=err_bwd, q=q, k=k, v=v, do=do,
                           rope=rope, qr=qr, kr=kr, bias=bias, out=out, lse=lse)


def train_kernel_phase(dev):
    """The flash forward with lse and the two backward kernels against their
    plain versions; timed at the training shape."""
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention_bwd as fab

    S, Dh = TRAIN_SEQ, 128
    cases = [("GQA H 16, KV 4", 1, 16, 4, 0), ("padded mask", 2, 32, 32, 300),
             ("training shape", 1, 32, 32, 0)]
    for label, b, h, kv, pad in cases:
        c = attention_train_check(label, dev, b, h, kv, pad, 10 + b + h)
    err_fwd, err_bwd = c.err_fwd, c.err_bwd
    q, k, v, do, rope, qr, kr, bias, out, lse = (
        c.q, c.k, c.v, c.do, c.rope, c.qr, c.kr, c.bias, c.out, c.lse)
    del c

    # Times at the training shape (the last case): B 1, S 2048, H = KV = 32.
    B, H, KV = 1, 32, 32
    cos, sin = rope
    stream = torch.cuda.current_stream(dev).cuda_stream
    scale = Dh ** -0.5
    o_buf, l_buf = torch.empty_like(out), torch.empty_like(lse)
    fwd_plain_ms = time_ms(lambda: fa.flash_attention_plain(
        q, k, v, rope=rope, with_lse=True), 3, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = qr.transpose(1, 2), kr.transpose(1, 2), v.transpose(1, 2)
    def fwd(rope_ptrs):
        return lambda: fa.FLASH_KERNEL(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), *rope_ptrs,
            o_buf.data_ptr(), l_buf.data_ptr(), B, S, fa.kv_tile_len(S), H, KV, Dh,
            scale, stream)

    # The kernel without RoPE (null tables: no cos / sin copies, no rotation)
    # shows what the fused rotation costs.
    turns = time_turns({"kernel": fwd((cos.data_ptr(), sin.data_ptr())),
                        "no_rope": fwd((None, None)),
                        "sdpa": lambda: sdpa(qt, kt, vt)}, 20)
    fwd_ms, fwd_lib_ms, no_rope_ms = turns["kernel"], turns["sdpa"], turns["no_rope"]
    print(f"  flash_attention_fwd with lse (training shape): {fwd_ms:.4f} ms, without "
          f"RoPE {no_rope_ms:.4f} ms", flush=True)
    fwd_flops = 4.0 * B * H * S * S * Dh
    fwd_bound = bound_ms(fwd_flops, nbytes(q, k, v, out, lse, bias, cos, sin))
    fwd_rate = report_rate("flash_attention_fwd with lse (training shape)", fwd_flops,
                           fwd_ms, fwd_bound[0])

    dsum = fab.row_dot(out, do)
    dq, dk, dv = (torch.empty(t.shape, dtype=torch.float32, device=dev)
                  for t in (q, k, v))
    common = (qr.data_ptr(), kr.data_ptr(), v.data_ptr(), bias.data_ptr(),
              do.data_ptr(), lse.data_ptr(), dsum.data_ptr())
    bwd_plain_ms = time_ms(lambda: fab.flash_attention_bwd_plain(
        qr, kr, v, bias, out, do, lse), 3, warmup=1)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
    s_out = sdpa(qg, kg, vg)
    dot = do.transpose(1, 2)
    turns = time_turns({
        "dq": lambda: fab.DQ_KERNEL(*common, dq.data_ptr(), B, S, H, KV, Dh, scale, stream),
        "dkv": lambda: fab.DKV_KERNEL(*common, dk.data_ptr(), dv.data_ptr(), B, S, H, KV,
                                      Dh, scale, stream),
        "sdpa_bwd": lambda: torch.autograd.grad(s_out, (qg, kg, vg), dot,
                                                retain_graph=True)}, 20)
    dq_ms, dkv_ms, sdpa_bwd_ms = turns["dq"], turns["dkv"], turns["sdpa_bwd"]
    ins = nbytes(qr, kr, v, do, lse, dsum, bias)
    dq_flops, dkv_flops = 6.0 * B * H * S * S * Dh, 8.0 * B * H * S * S * Dh
    dq_bound = bound_ms(dq_flops, ins + nbytes(dq))
    dkv_bound = bound_ms(dkv_flops, ins + nbytes(dk, dv))
    dq_rate = report_rate("flash_attention_bwd_dq (training shape)", dq_flops, dq_ms,
                          dq_bound[0])
    print(f"  flash_attention_bwd_dq: {dq_ms:.4f} ms against dk/dv {dkv_ms:.4f} ms and "
          f"SDPA's whole backward {sdpa_bwd_ms:.4f} ms in the same turns; "
          f"{dq_rate['bound_share']:.4f} of its bound; first design "
          f"{FIRST_DESIGN_MS['flash_attention_bwd_dq']} ms (PERF.md)", flush=True)
    dkv_rate = report_rate("flash_attention_bwd_dkv (training shape)", dkv_flops, dkv_ms,
                           dkv_bound[0])
    print(f"  training shape B {B}, S {S}, H {H}, KV {KV}, Dh {Dh}: "
          f"fwd+lse kernel {fwd_ms:.4f} ms, plain {fwd_plain_ms:.4f} ms, SDPA fwd "
          f"{fwd_lib_ms:.4f} ms, bound {fwd_bound[0]:.4f} ms ({fwd_bound[1]}); "
          f"dq kernel {dq_ms:.4f} ms, bound {dq_bound[0]:.4f} ms ({dq_bound[1]}); "
          f"dkv kernel {dkv_ms:.4f} ms, bound {dkv_bound[0]:.4f} ms ({dkv_bound[1]}); "
          f"dq + dkv {dq_ms + dkv_ms:.4f} ms against SDPA backward "
          f"{sdpa_bwd_ms:.4f} ms; plain backward (dq, dk, dv in one call) "
          f"{bwd_plain_ms:.4f} ms", flush=True)
    src = "ct_diffusionmodelbench_tpu_torch/csrc/flash_attention_bwd.cu"
    ref = "ct_diffusionmodelbench_tpu/ops/flash_attention_bwd.py"
    results = [
        dict(name="flash_attention_bwd_dq", route="cuda", source=src,
             replaces=f"{ref}:93", max_abs_err=err_bwd, ms=dq_ms, kernel_ms=dq_ms,
             plain_ms=bwd_plain_ms, bound_ms=dq_bound[0], bound_by=dq_bound[1],
             library_ms=None, sdpa_backward_ms=sdpa_bwd_ms, **dq_rate),
        dict(name="flash_attention_bwd_dkv", route="cuda", source=src,
             replaces=f"{ref}:93", max_abs_err=err_bwd, ms=dkv_ms, kernel_ms=dkv_ms,
             plain_ms=bwd_plain_ms, bound_ms=dkv_bound[0], bound_by=dkv_bound[1],
             library_ms=None, sdpa_backward_ms=sdpa_bwd_ms, **dkv_rate),
    ]
    fwd_train = dict(shape=f"B {B}, S {S}, H {H}, KV {KV}, Dh {Dh}, RoPE, lse",
                     max_abs_err=err_fwd, ms=fwd_ms, plain_ms=fwd_plain_ms,
                     bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
                     library_ms=fwd_lib_ms, no_rope_ms=no_rope_ms, **fwd_rate)
    return results, fwd_train


def train_slice_phase(dev):
    """8-layer full-width llada-8b trained 5 steps through ``Trainer``."""
    import numpy as np

    from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import reset_launch_counts
    from ct_diffusionmodelbench_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = get_config("llada-8b").replace(num_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = cfg.param_count()
    print(f"  init {TRAIN_LAYERS}-layer llada-8b: {n_params / 1e9:.3f} G params, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(3)
    rows = [{"input_ids": r.tolist(), "prompt_lengths": TRAIN_PROMPT}
            for r in rng.integers(10, 100000, (TRAIN_STEPS * TRAIN_ACCUM, TRAIN_SEQ))]
    out_dir = tempfile.mkdtemp(prefix="ctdb-train-")
    try:
        tcfg = TrainConfig(output_dir=out_dir, num_epochs=1, batch_size=1,
                           grad_accum=TRAIN_ACCUM, max_length=TRAIN_SEQ, remat=True,
                           ce_chunk=512, variable_length=False, logging_steps=1,
                           seed=0)
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg, params, tcfg, rows)
        reset_launch_counts()
        trainer.train()
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    tokens = TRAIN_ACCUM * TRAIN_SEQ
    secs = sum(trainer.step_times[1:]) / (len(trainer.step_times) - 1)
    mfu = 6.0 * n_params * tokens / secs / PEAK_BF16_FLOPS
    logs = [e for e in trainer.training_logs if "grad_norm" in e]
    print(f"  steps: {len(trainer.step_times)}, s/step (steps 2-{TRAIN_STEPS}) "
          f"{secs:.4f}, each {[round(t, 4) for t in trainer.step_times]}; "
          f"{tokens / secs:.2f} tokens/s; train MFU {mfu:.4f} (6·P·tokens / s / "
          f"989 TFLOP/s, P {n_params}); peak memory {peak / 2**30:.3f} GiB; save "
          f"{trainer.save_times[-1]:.2f} s", flush=True)
    print("  loss / grad_norm per step: " + ", ".join(
        f"{e['loss']:.5f} / {e['grad_norm']:.5f}" for e in logs), flush=True)
    print(f"  launches: {json.dumps(launches)}", flush=True)
    if len(logs) != TRAIN_STEPS or not all(
            np.isfinite(e["loss"]) and np.isfinite(e["grad_norm"]) and e["grad_norm"] > 0
            for e in logs):
        raise AssertionError("non-finite loss or grad_norm, or a zero gradient")
    per_step = TRAIN_LAYERS * TRAIN_ACCUM
    want = expected_launches(
        glue_launches(cfg, 2 * per_step * TRAIN_STEPS, TRAIN_ACCUM * TRAIN_STEPS),
        flash_attention_fwd=2 * per_step * TRAIN_STEPS,
        flash_attention_bwd_dq=per_step * TRAIN_STEPS,
        flash_attention_bwd_dkv=per_step * TRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    params = trainer.params
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return dict(cfg=cfg, params=params, launches=launches, seconds_per_step=secs,
                tokens_per_s=tokens / secs, mfu=mfu, peak_gib=peak / 2**30)


def train_depth_phase(cfg, params, dev):
    """2-layer full-width loss and gradients: kernels against plain."""
    from functools import partial

    from ct_diffusionmodelbench_tpu_torch.models.transformer import forward, lm_head_logits
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention_bwd as fab
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import KERNELS, reset_launch_counts
    from ct_diffusionmodelbench_tpu_torch.train.diffusion_loss import diffusion_sft_loss
    from ct_diffusionmodelbench_tpu_torch.train.optim import flatten_params, unflatten_params

    cfg2 = cfg.replace(num_layers=2)
    p2 = dict(params, blocks={k: v[:2] for k, v in params["blocks"].items()})
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    ids = torch.randint(10, 100000, (1, TRAIN_SEQ), generator=gen, device=dev)
    plens = torch.full((1,), TRAIN_PROMPT, device=dev)
    noise = (torch.rand((1,), generator=gen, device=dev),
             torch.rand((1, TRAIN_SEQ), generator=gen, device=dev))

    def fwd(p, x, m=None, *, return_hidden=False):
        return forward(cfg2, p, x, attn_mask=m, return_hidden=return_hidden, remat=True)

    def loss_and_grads():
        leaves = {k: t.detach().requires_grad_(True)
                  for k, t in flatten_params(p2).items()}
        with torch.enable_grad():
            loss, _ = diffusion_sft_loss(
                fwd, unflatten_params(leaves), ids, plens, cfg2.mask_token_id,
                noise, aux_coef=0.0, head_fn=lm_head_logits, ce_chunk=512)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.item(), dict(zip(leaves, grads))

    reset_launch_counts()
    loss_k, grads_k = loss_and_grads()
    launches = {n: KERNELS[n].launches
                for n in ("flash_attention_fwd",) + BWD_KERNELS + GLUE_KERNELS}
    # The plain run swaps the forward and backward at the names the autograd
    # wrapper calls them by.
    seams = [(fa, "flash_attention_fwd"), (fab, "flash_attention_bwd")]
    saved = [getattr(mod, name) for mod, name in seams]
    plain = [partial(fa.flash_attention_plain, with_lse=True),
             fab.flash_attention_bwd_plain]
    try:
        for (mod, name), fn in zip(seams, plain):
            setattr(mod, name, fn)
        loss_p, grads_p = loss_and_grads()
    finally:
        for (mod, name), fn in zip(seams, saved):
            setattr(mod, name, fn)
    print(f"  launches with kernels: {json.dumps(launches)}", flush=True)
    print(f"  loss: kernels {loss_k:.6f}, plain {loss_p:.6f}", flush=True)
    worst, zero = 0.0, []
    for name, gk in grads_k.items():
        gk, gp = gk.float(), grads_p[name].float()
        nk, np_ = float(gk.norm()), float(gp.norm())
        rel = float((gk - gp).norm()) / max(np_, 1e-30)
        cos = float((gk * gp).sum()) / max(nk * np_, 1e-30)
        worst = max(worst, rel)
        if nk == 0.0:
            zero.append(name)
        print(f"  grad {name}: norm {nk:.4e} (plain {np_:.4e}), rel L2 err "
              f"{rel:.3e}, cosine {cos:.6f}", flush=True)
    print(f"  largest rel L2 err {worst:.3e} (limit {GRAD_REL_L2:.3e})", flush=True)
    if launches != {"flash_attention_fwd": 4, "flash_attention_bwd_dq": 2,
                    "flash_attention_bwd_dkv": 2, **glue_launches(cfg2, 4, 1)}:
        raise AssertionError(f"2-layer gradient run launched {launches}")
    if zero:
        raise AssertionError(f"zero gradient with the kernels: {zero}")
    if worst > GRAD_REL_L2 or abs(loss_k - loss_p) > LOSS_RTOL * abs(loss_p):
        raise AssertionError("2-layer gradients with kernels disagree with plain")
    return worst


def moe_train_args(out_dir):
    """``cli/train.py``'s parser on the reference's ``sft_train_step_moe``
    flags (int8 moments, bf16 accumulation, remat, A 4, B 1, L 2048)."""
    from ct_diffusionmodelbench_tpu_torch.cli import train as train_cli

    return train_cli.build_parser().parse_args([
        "--preset", "llada-moe-7b", "--optimizer-state-dtype", "int8",
        "--grad-accum-dtype", "bfloat16", "--remat", "--max-length", str(TRAIN_SEQ),
        "--batch-size", "1", "--grad-accum", str(TRAIN_ACCUM), "--epochs", "1",
        "--eval-steps", "0", "--logging-steps", "1", "--output-dir", out_dir,
        "--seed", "0"])


def moe_train_kernel_phase(cfg, params, dev):
    """Phase 19: K1/K2 at the MoE training routing (B 1, S 2048: M 16384)
    against their plain versions; the grouped backward (library products)
    against its plain version on the same cotangent, timed; K8 with lse and
    K10 / K11 at H 16, KV 4 against their plain versions, timed."""
    from ct_diffusionmodelbench_tpu_torch.models.moe import router_probs
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention_bwd as fab
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm as ggm

    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    D, K, li = cfg.hidden_size, cfg.num_experts_per_tok, 1
    blocks = params["blocks"]
    x = torch.randn((TRAIN_SEQ, D), generator=gen, device=dev, dtype=torch.bfloat16)
    topk_probs, topk_idx, _ = router_probs(x, blocks["router"][li], K,
                                           cfg.norm_topk_prob)
    pair = grouped_pair_check("MoE training", cfg, blocks, x, topk_idx, li)
    k1_ms = time_ms(lambda: ggm.grouped_expert_ffn(
        x, topk_probs, topk_idx, *(blocks[k] for k in ("we_gate", "we_up", "we_down")),
        layer_index=li), 10)

    # The backward of layer 1's expert FFN on its own 3-D weights, with the
    # library products and with their plain versions, on one cotangent.
    ins = [x.detach().requires_grad_(True), topk_probs.detach().requires_grad_(True),
           *(blocks[k][li].detach().requires_grad_(True)
             for k in ("we_gate", "we_up", "we_down"))]
    with torch.enable_grad():
        out = ggm.GroupedFFN.apply(ins[0], ins[1], topk_idx, *ins[2:])
    cot = torch.randn(out.shape, generator=gen, device=dev, dtype=out.dtype)

    def backward():
        return torch.autograd.grad(out, ins, cot, retain_graph=True)

    got = backward()
    bwd_ms = time_ms(backward, 10)
    saved = ggm.grouped_mm
    try:
        ggm.grouped_mm = ggm.grouped_mm_plain
        want = backward()
        bwd_plain_ms = time_ms(backward, 1, warmup=0)
    finally:
        ggm.grouped_mm = saved
    torch.cuda.synchronize()
    err_bwd = max(compare(f"grouped backward {name}", g, w, BWD_RTOL,
                          BWD_ATOL_OF_MAX * float(w.float().abs().max()))
                  for name, g, w in zip(("dx", "dprobs", "dWg", "dWu", "dWd"), got, want))
    print(f"  grouped FFN at M {pair.m} (tile_m {pair.tile_m}, m_pad {pair.m_pad}): "
          f"forward (K1 + K2 and the layout) {k1_ms:.4f} ms; backward with "
          f"torch._grouped_mm {bwd_ms:.4f} ms, with one torch.mm per expert "
          f"{bwd_plain_ms:.4f} ms", flush=True)
    del out, got, want, ins

    att = attention_train_check("MoE training H 16, KV 4", dev, 1, 16, 4, 0, 29)
    fwd_ms = time_ms(lambda: fa.flash_attention_cuda(
        att.q, att.k, att.v, rope=att.rope, with_lse=True), 20)
    dq_ms = time_ms(lambda: fab.flash_attention_bwd(
        att.qr, att.kr, att.v, att.bias, att.out, att.do, att.lse), 20)
    print(f"  flash at B 1, S {TRAIN_SEQ}, H 16, KV 4, Dh 128: fwd with lse "
          f"{fwd_ms:.4f} ms, backward (dq and dk/dv) {dq_ms:.4f} ms", flush=True)
    return dict(
        grouped_gateup=dict(m=pair.m, tile_m=pair.tile_m, m_pad=pair.m_pad,
                            max_abs_err=pair.err_gateup, ffn_ms=k1_ms),
        grouped_down=dict(m=pair.m, tile_m=pair.tile_m, m_pad=pair.m_pad,
                          max_abs_err=pair.err_down, ffn_ms=k1_ms),
        grouped_backward=dict(max_abs_err=err_bwd, ms=bwd_ms, plain_ms=bwd_plain_ms),
        flash_attention_fwd=dict(max_abs_err=att.err_fwd, ms=fwd_ms),
        flash_attention_bwd_dq=dict(max_abs_err=att.err_bwd, bwd_ms=dq_ms),
        flash_attention_bwd_dkv=dict(max_abs_err=att.err_bwd, bwd_ms=dq_ms))


def moe_train_slice_phase(args, cfg, params, tokenizer, dev):
    """Phase 20: full-width llada-moe-7b trained 5 steps through
    ``cli/train.py``'s ``run`` (int8 moments, bf16 accumulation, remat)."""
    import numpy as np

    from ct_diffusionmodelbench_tpu_torch.cli import train as train_cli
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import reset_launch_counts
    from ct_diffusionmodelbench_tpu_torch.train import optim

    rng = np.random.default_rng(20)
    rows = [{"input_ids": r.tolist(), "prompt_lengths": TRAIN_PROMPT}
            for r in rng.integers(10, 150000, (TRAIN_STEPS * TRAIN_ACCUM, TRAIN_SEQ))]
    probes = {k: params["blocks"][k][0].flatten()[:1 << 20].clone()
              for k in ("wq", "we_gate", "router")}
    update_s = []
    update = optim.AdamWLowp.update

    def timed_update(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = update(self, *a, **kw)
        torch.cuda.synchronize()
        update_s.append(time.perf_counter() - t0)
        return out

    torch.cuda.reset_peak_memory_stats()
    try:
        optim.AdamWLowp.update = timed_update
        reset_launch_counts()
        trainer = train_cli.run(args, cfg, params, tokenizer, rows, [])
        launches = launch_counts()
    finally:
        optim.AdamWLowp.update = update
        shutil.rmtree(args.output_dir, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    n_steps = len(trainer.step_times)
    tokens = TRAIN_ACCUM * TRAIN_SEQ
    secs = sum(trainer.step_times[1:]) / (n_steps - 1)
    active = cfg.active_param_count()
    mfu = 6.0 * active * tokens / secs / PEAK_BF16_FLOPS
    opt_share = sum(update_s[1:]) / sum(trainer.step_times[1:])
    logs = [e for e in trainer.training_logs if "grad_norm" in e]
    moved = {k: int((params["blocks"][k][0].flatten()[:1 << 20] != v).sum())
             for k, v in probes.items()}
    print(f"  {cfg.num_layers}-layer llada-moe-7b, {cfg.param_count() / 1e9:.3f} G "
          f"params ({active / 1e9:.3f} G active): steps {n_steps}, s/step (steps "
          f"2-{n_steps}) {secs:.4f}, each {[round(t, 4) for t in trainer.step_times]}; "
          f"{tokens / secs:.2f} tokens/s; train MFU {mfu:.4f} (6·active·tokens / s / "
          f"989 TFLOP/s); optimizer update {[round(t, 4) for t in update_s]} s, "
          f"{opt_share:.4f} of the step; peak memory {peak / 2**30:.3f} GiB; save "
          f"{trainer.save_times[-1]:.2f} s", flush=True)
    print("  loss / grad_norm per step: " + ", ".join(
        f"{e['loss']:.5f} / {e['grad_norm']:.5f}" for e in logs), flush=True)
    print(f"  parameter elements moved (first 2^20 of layer 0's): {json.dumps(moved)}",
          flush=True)
    print(f"  launches: {json.dumps(launches)}", flush=True)
    if n_steps != TRAIN_STEPS or len(logs) != TRAIN_STEPS or not all(
            np.isfinite(e["loss"]) and np.isfinite(e["grad_norm"]) and e["grad_norm"] > 0
            for e in logs):
        raise AssertionError("non-finite loss or grad_norm, a zero gradient, or a "
                             "missing step")
    if not any(moved.values()):
        raise AssertionError("no parameter moved")
    per_step = cfg.num_layers * TRAIN_ACCUM
    want = expected_launches(
        glue_launches(cfg, 2 * per_step * TRAIN_STEPS, TRAIN_ACCUM * TRAIN_STEPS),
        **{n: 2 * per_step * TRAIN_STEPS for n in SERVING_KERNELS},
        **{n: per_step * TRAIN_STEPS for n in BWD_KERNELS})
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    per_step_launches = {n: c // TRAIN_STEPS for n, c in launches.items() if c}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches_per_step=per_step_launches, seconds_per_step=secs,
                tokens_per_s=tokens / secs, mfu=mfu, peak_gib=peak / 2**30,
                optimizer_share=opt_share)


def moe_train_depth_phase(cfg, params, dev):
    """Phase 21 at 2 layers of the full width: loss, aux loss and every
    gradient through the kernels against the same on their plain versions
    (pinned to the kernel run's expert choice); an int8 / bf16 step's
    optimizer state through save and load, bit for bit; remat='dots'
    against remat=True."""
    from functools import partial

    import numpy as np

    from ct_diffusionmodelbench_tpu_torch.models import init_params, moe
    from ct_diffusionmodelbench_tpu_torch.models.transformer import forward, lm_head_logits
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention_bwd as fab
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm as ggm
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import reset_launch_counts
    from ct_diffusionmodelbench_tpu_torch.train.diffusion_loss import diffusion_sft_loss
    from ct_diffusionmodelbench_tpu_torch.train.optim import (
        flatten_params, state_tensors, unflatten_params)
    from ct_diffusionmodelbench_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg2 = cfg.replace(num_layers=2)
    p2 = dict(params, blocks={k: v[:2] for k, v in params["blocks"].items()})
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    ids = torch.randint(10, 150000, (1, TRAIN_SEQ), generator=gen, device=dev)
    plens = torch.full((1,), TRAIN_PROMPT, device=dev)
    noise = (torch.rand((1,), generator=gen, device=dev),
             torch.rand((1, TRAIN_SEQ), generator=gen, device=dev))

    def loss_and_grads(remat=True):
        def fwd(p, x, m=None, *, return_hidden=False):
            return forward(cfg2, p, x, attn_mask=m, return_hidden=return_hidden,
                           remat=remat)

        leaves = {k: t.detach().requires_grad_(True)
                  for k, t in flatten_params(p2).items()}
        with torch.enable_grad():
            loss, metrics = diffusion_sft_loss(
                fwd, unflatten_params(leaves), ids, plens, cfg2.mask_token_id, noise,
                aux_coef=0.01, head_fn=lm_head_logits, ce_chunk=512)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.item(), metrics["aux_loss"].item(), dict(zip(leaves, grads))

    def close(label, a, b):
        (loss_a, aux_a, grads_a), (loss_b, aux_b, grads_b) = a, b
        print(f"  {label}: loss {loss_a:.6f} / {loss_b:.6f}, aux loss {aux_a:.6f} / "
              f"{aux_b:.6f}", flush=True)
        worst, zero = 0.0, []
        for name, ga in grads_a.items():
            ga, gb = ga.float(), grads_b[name].float()
            na, nb = float(ga.norm()), float(gb.norm())
            rel = float((ga - gb).norm()) / max(nb, 1e-30)
            worst = max(worst, rel)
            if na == 0.0:
                zero.append(name)
            print(f"    grad {name}: norm {na:.4e} / {nb:.4e}, rel L2 err {rel:.3e}",
                  flush=True)
        print(f"  {label}: largest rel L2 err {worst:.3e} (limit {GRAD_REL_L2:.3e})",
              flush=True)
        if zero:
            raise AssertionError(f"{label}: zero gradient: {zero}")
        if (worst > GRAD_REL_L2 or abs(loss_a - loss_b) > LOSS_RTOL * abs(loss_b)
                or abs(aux_a - aux_b) > LOSS_RTOL * abs(aux_b)):
            raise AssertionError(f"{label}: the two runs disagree")
        return worst

    # (a) kernels against plain, the plain run on the kernel run's experts.
    # The plain run's router calls come in the kernel run's order (forward,
    # then the backward's recompute, last layer first).
    router = moe.router_probs
    chosen, used = [], []

    def recording_router(x, w, top_k, norm_topk, *mode):
        out = router(x, w, top_k, norm_topk, *mode)
        chosen.append(out[1])
        return out

    def pinned_router(x, w, top_k, norm_topk, *mode):
        _, _, probs = router(x, w, top_k, norm_topk, *mode)
        idx = chosen[len(used)]
        used.append(idx)
        topk_probs = probs.gather(-1, idx)
        if norm_topk:
            topk_probs = topk_probs / topk_probs.sum(dim=-1, keepdim=True)
        return topk_probs, idx, probs

    seams = [(moe, "router_probs", pinned_router),
             (fa, "flash_attention_fwd", partial(fa.flash_attention_plain, with_lse=True)),
             (fab, "flash_attention_bwd", fab.flash_attention_bwd_plain),
             (gg, "grouped_gateup", gg.grouped_gateup_plain),
             (gg, "grouped_down", gg.grouped_down_plain),
             (ggm, "grouped_mm", ggm.grouped_mm_plain),
             (ggm, "combine", gg.combine_plain),
             (gg, "routed_layout", gg.routed_layout_plain),
             (moe, "router_topk", gg.router_topk_plain)]
    saved = [getattr(mod, name) for mod, name, _ in seams]
    reset_launch_counts()
    try:
        moe.router_probs = recording_router
        kern = loss_and_grads()
        launches = launch_counts(nonzero=True)
        for mod, name, fn in seams:
            setattr(mod, name, fn)
        plain = loss_and_grads()
    finally:
        for (mod, name, _), fn in zip(seams, saved):
            setattr(mod, name, fn)
    print(f"  launches with kernels: {json.dumps(launches)}", flush=True)
    want = {"grouped_gateup": 4, "grouped_down": 4, "flash_attention_fwd": 4,
            "flash_attention_bwd_dq": 2, "flash_attention_bwd_dkv": 2,
            **glue_launches(cfg2, 4, 1)}
    if launches != want:
        raise AssertionError(f"2-layer MoE gradient run launched {launches}")
    err_grads = close("2-layer MoE gradients, kernels vs plain", kern, plain)
    del kern, plain

    # (b) remat='dots' against remat=True.
    torch.cuda.reset_peak_memory_stats()
    full = loss_and_grads(True)
    peak_full = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dots = loss_and_grads("dots")
    peak_dots = torch.cuda.max_memory_allocated()
    print(f"  peak memory: remat=True {peak_full / 2**30:.3f} GiB, remat='dots' "
          f"{peak_dots / 2**30:.3f} GiB", flush=True)
    err_dots = close("2-layer MoE gradients, remat='dots' vs remat=True", dots, full)
    del full, dots

    # (c) one int8 / bf16 step, its optimizer state saved and loaded.
    out_dir = tempfile.mkdtemp(prefix="ctdb-moe-state-")
    try:
        fresh = init_params(cfg2, seed=3)
        rng = np.random.default_rng(21)
        rows = [{"input_ids": r.tolist(), "prompt_lengths": TRAIN_PROMPT}
                for r in rng.integers(10, 150000, (2, 512))]
        tcfg = TrainConfig(output_dir=out_dir, num_epochs=1, batch_size=1,
                           grad_accum=2, max_length=512, remat=True,
                           variable_length=False, eval_steps=0, warmup_steps=0,
                           optimizer_state_dtype="int8", grad_accum_dtype="bfloat16",
                           save_optimizer_state=True)
        t1 = Trainer(cfg2, fresh, tcfg, rows, pad_token_id=0)
        t1.train()
        t2 = Trainer(cfg2, fresh, tcfg, rows, pad_token_id=0)
        t2.load_training_state(out_dir)
        a, b = state_tensors(t1.opt_state), state_tensors(t2.opt_state)
        differ = [k for k in a if not torch.equal(a[k].cpu(), b[k].cpu())]
        print(f"  optimizer state after one int8 / bf16 step: {len(a)} tensors, "
              f"{sum(t.numel() for t in a.values())} elements, saved and loaded; "
              f"step {t2.global_step}; tensors that differ: {differ}", flush=True)
        if differ or t2.global_step != 1 or int(a["[1][0].count"]) != 1:
            raise AssertionError("optimizer state did not round-trip bit for bit")
        del t1, t2, fresh, a, b
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(grad_rel_l2=err_grads, dots_rel_l2=err_dots)


# ---------------------------------------------------------------------------
# Tensor- and data-parallel phases (22-23): ranks spawned by this script
# ---------------------------------------------------------------------------

# dp 2 × tp 2: four ranks.  One card a rank with nccl where there are four
# cards, else all four on cuda:0 with gloo (NCCL refuses two ranks on one
# device); gloo's times are a shared card's, not NVLink's.
PAR_DP, PAR_TP = 2, 2
PAR_WORLD = PAR_DP * PAR_TP
# Serving: the main path's configuration, each data rank decoding 4 rows.
# Training: llada-moe-7b at full width cut to 2 layers, L 2048, B 2 (a row
# per data rank), 3 steps through cli/train.py, bf16 moments and
# accumulation (the reference's low-precision flags: four ranks' states
# share one card).
PAR_STEPS = STEPS
PAR_TRAIN_LAYERS, PAR_TRAIN_STEPS, PAR_TRAIN_BATCH = 2, 3, 2
# The moments after one step from the saved and from the resumed state: a
# lost or misplaced moment moves their fingerprint by O(1) (b1 = 0.9 of mu
# and b2 = 0.999 of nu are the old state); bf16 rounding of gradients
# summed in another order moves it by far less.
RESUME_MOMENT_TOL = 1e-2
# A rank that has not answered by then fails its phase.
PAR_TIMEOUT_S = {"serve": 480, "train": 300, "sp": 480, "pp": 300, "pptp": 300}
# Sequence-parallel training (phase 24): dp 1 x sp 2 x tp 2 on llada-moe-7b
# at full width cut to 2 layers, L 4096 (twice the reference's training
# length), B 2, 3 steps, per-block remat, bf16 moments and accumulation.
SP_DP, SP_SP, SP_TP = 1, 2, 2
SP_LAYERS, SP_SEQ, SP_BATCH, SP_STEPS = 2, 4096, 2, 3
SP_FLAGS = ("--max-length", str(SP_SEQ), "--batch-size", str(SP_BATCH), "--remat")
# Pipeline training (phase 25): (a) 4 stages of one llada-moe-7b layer each,
# 4 microbatches of one row, L 512, 3 steps; (b) 2 stages x tp 2 of llada-8b
# cut to 2 layers, B 2 in 2 microbatches, L 512.  L 512: the head is whole on
# every stage and computes [B, L, 157184] f32 logits, about 1.3 GB at (a)'s
# B 4, three times over with their gradient, beside the 6.4 GB of embedding
# and head state a rank holds.
PP_STAGES, PP_MICRO, PP_LAYERS, PP_BATCH, PP_SEQ, PP_STEPS = 4, 4, 4, 4, 512, 3
PP_FLAGS = ("--max-length", str(PP_SEQ), "--batch-size", str(PP_BATCH))
PPTP_STAGES, PPTP_TP, PPTP_LAYERS, PPTP_BATCH = 2, 2, 2, 2


def par_layout():
    """(backend, device of every rank or None for a card each, ranks per
    card)."""
    cards = torch.cuda.device_count()
    if cards >= PAR_WORLD:
        return "nccl", None, 1
    return "gloo", "cuda:0", PAR_WORLD


def _par_rank_main(task, rank, port, backend, device, args, results):
    """A spawned rank: join the process group, run ``task``, report."""
    import traceback

    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(PAR_WORLD)
    try:
        from ct_diffusionmodelbench_tpu_torch.parallel import init_distributed

        init_distributed(f"localhost:{port}", PAR_WORLD, rank, backend=backend,
                         device=device)
        results.put((rank, True, globals()[task](rank, *args)))
    except BaseException:  # reported to the parent, which fails the phase
        results.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(task: str, *args, layout: str = f"dp {PAR_DP} x tp {PAR_TP}"):
    """``task(rank, *args)`` on PAR_WORLD spawned ranks; their results in
    rank order.  A rank that fails, or does not answer within the phase's
    time, fails the phase; every rank is stopped before this returns."""
    import queue
    import socket

    import torch.multiprocessing as mp

    backend, device, per_card = par_layout()
    print(f"  backend {backend}, world {PAR_WORLD}, ranks per card {per_card} "
          f"({layout}; {torch.cuda.device_count()} card(s))", flush=True)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_par_rank_main,
                         args=(task, r, port, backend, device, args, results))
             for r in range(PAR_WORLD)]
    out = [None] * PAR_WORLD
    deadline = time.monotonic() + PAR_TIMEOUT_S[task.split("_")[1]]
    try:
        for p in procs:
            p.start()
        for _ in range(PAR_WORLD):
            try:
                rank, ok, value = results.get(timeout=max(deadline - time.monotonic(), 1))
            except queue.Empty:
                raise AssertionError(f"{task}: a rank did not answer in time") from None
            if not ok:
                raise AssertionError(f"{task}: rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=60 if all(o is not None for o in out) else 1)
            if p.is_alive():
                p.kill()
                p.join()
    return out


def par_kernel_times(pair, cfg, blocks, li, q, k, v, mask, rope, dev):
    """K1, K2 and K8 at a rank's sharded shapes: kernel, plain version and
    library call, each timed with CUDA events, and their bounds."""
    from ct_diffusionmodelbench_tpu_torch.models.layers import apply_rope
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg

    wg, wu, wd = blocks["we_gate"], blocks["we_up"], blocks["we_down"]
    D, Fm, bf16 = cfg.hidden_size, cfg.moe_intermediate_size, 2
    xs, h_p, te, tm, valid = pair.xs, pair.h_p, pair.tile_expert, pair.tile_m, pair.valid
    # The real rows and used experts of this rank's layout (dropped slots
    # hold no real row).
    m_real, used = int(pair.sizes.sum()), pair.used
    pend = torch.cumsum(gg._round_up(pair.sizes, tm), 0, dtype=torch.int32)
    pend[-1] = pair.m_pad
    out = {}
    w_gu = torch.cat([wg[li], wu[li]], dim=-1)
    t = time_turns({"kernel": lambda: gg.grouped_gateup(xs, wg, wu, te, tm, li, valid),
                    "library": lambda: torch._grouped_mm(xs, w_gu, offs=pend)}, 20)
    flops = 4.0 * m_real * D * Fm
    b = bound_ms(flops, m_real * (D + Fm) * bf16 + used * 2 * D * Fm * bf16)
    out["grouped_gateup"] = dict(ms=t["kernel"], library_ms=t["library"], plain_ms=time_ms(
        lambda: gg.grouped_gateup_plain(xs, wg, wu, te, tm, li, valid), 3, warmup=1),
        bound_ms=b[0], bound_by=b[1])
    wd_l = wd[li]
    t = time_turns({"kernel": lambda: gg.grouped_down(h_p, wd, te, tm, li, valid),
                    "library": lambda: torch._grouped_mm(h_p, wd_l, offs=pend)}, 20)
    flops = 2.0 * m_real * Fm * D
    b = bound_ms(flops, m_real * (Fm + D) * bf16 + used * Fm * D * bf16)
    out["grouped_down"] = dict(ms=t["kernel"], library_ms=t["library"], plain_ms=time_ms(
        lambda: gg.grouped_down_plain(h_p, wd, te, tm, li, valid), 3, warmup=1),
        bound_ms=b[0], bound_by=b[1])
    B, S, H, Dh = q.shape
    qt, kt = (apply_rope(a, *rope).transpose(1, 2) for a in (q, k))
    vt = v.transpose(1, 2)
    keep = None if mask is None else mask.bool()[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t = time_turns({"kernel": lambda: fa.flash_attention(q, k, v, mask=mask, rope=rope),
                    "library": lambda: sdpa(qt, kt, vt, attn_mask=keep, enable_gqa=True)},
                   50)
    flops = 4.0 * B * H * S * S * Dh
    b = bound_ms(flops, nbytes(q, k, v, q, *rope) + (0 if mask is None else nbytes(mask)))
    out["flash_attention_fwd"] = dict(
        ms=t["kernel"], library_ms=t["library"], plain_ms=time_ms(
            lambda: fa.flash_attention_plain(q, k, v, mask=mask, rope=rope), 10),
        bound_ms=b[0], bound_by=b[1])
    return out


def par_serve_task(rank, steps):
    """Phase 22 on one rank: full-size llada-moe-7b drawn as this rank's
    shard, ``generate_ids`` at the main path's shape over the mesh, the
    kernels against their plain versions at this rank's shapes, and a
    2-layer sharded forward against the one-rank forward."""
    import numpy as np
    import torch.distributed as dist

    from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner
    from ct_diffusionmodelbench_tpu_torch.models import make_forward_fn
    from ct_diffusionmodelbench_tpu_torch.models.moe import local_slots
    from ct_diffusionmodelbench_tpu_torch.models.transformer import forward
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import reset_launch_counts
    from ct_diffusionmodelbench_tpu_torch.parallel import comm, make_sharded_forward, use_mesh
    from ct_diffusionmodelbench_tpu_torch.parallel.sharding import gather_params

    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    runner = ModelRunner.random_init("llada-moe-7b", seed=0, dp=PAR_DP, tp=PAR_TP)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    mesh, cfg, params = runner.mesh, runner.cfg, runner.params
    shard_gb = sum(t.numel() * t.element_size() for t in params["blocks"].values()) + sum(
        t.numel() * t.element_size() for kk, t in params.items() if kk != "blocks")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)   # the slice phase's prompt
    prompt = torch.randint(10, 100000, (BATCH, PROMPT), generator=gen, device=dev)
    prompt_np = prompt.cpu().numpy()
    runner.generate_ids(prompt_np, gen_length=GEN, steps=GEN // BLOCK,
                        block_length=BLOCK)          # warm-up, one step a block
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    comm.reset_counts()
    t0 = time.perf_counter()
    with comm.timed():
        out = runner.generate_ids(prompt_np, gen_length=GEN, steps=steps,
                                  block_length=BLOCK)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    counts, comm_s = dict(comm.COUNTS), comm.SECONDS["total"]
    peak = torch.cuda.max_memory_allocated()
    left = int((out[:, PROMPT:] == cfg.mask_token_id).sum())
    per = cfg.num_layers * steps
    want = expected_launches(glue_launches(cfg, per, steps),
                             **{n: per for n in SERVING_KERNELS})
    if launches != want:
        raise AssertionError(f"rank {rank}: launches {launches}, expected {want}")
    if left:
        raise AssertionError(f"rank {rank}: {left} mask ids remain")

    # The kernels at this rank's shapes: layer 1's local routing (32 of 64
    # experts; other ranks' slots dropped) and its attention (8 q / 2 kv
    # heads) in a forward of the decoded batch's own rows.
    ids = torch.as_tensor(out, device=dev)
    li = 1
    fwd = make_sharded_forward(cfg, mesh)
    (x, topk_idx), (q, k, v, amask, rope) = capture_layer(
        fwd, params, ids, None, li, logit_start=PROMPT, logit_length=BLOCK)
    e_local = params["blocks"]["we_gate"].shape[1]
    pair = grouped_pair_check(f"rank {rank} local experts", cfg, params["blocks"], x,
                              local_slots(topk_idx, e_local, mesh.model_rank), li,
                              drop_foreign=True)
    a_k = fa.flash_attention(q, k, v, mask=amask, rope=rope)
    a_p = fa.flash_attention_plain(q, k, v, mask=amask, rope=rope)
    torch.cuda.synchronize()
    err = {"grouped_gateup": pair.err_gateup, "grouped_down": pair.err_down,
           "flash_attention_fwd": compare(f"rank {rank} flash_attention_fwd "
                                          f"(H {q.shape[2]}, KV {k.shape[2]})",
                                          a_k, a_p, **FLASH_TOL)}
    shapes = dict(tile_m=pair.tile_m, m=pair.m, m_pad=pair.m_pad,
                  real_rows=int(pair.sizes.sum()), experts=e_local,
                  heads=[q.shape[2], k.shape[2]], q_shape=list(q.shape))
    dist.barrier()
    times = (par_kernel_times(pair, cfg, params["blocks"], li, q, k, v, amask, rope, dev)
             if rank == 0 else None)
    del pair, a_k, a_p, q, k, v, x
    dist.barrier()

    # 2 layers at full width: the sharded forward on this data rank's rows
    # against the one-rank forward of the same rows on the gathered first
    # two layers, the one-rank run on the sharded run's expert choice.
    cfg2 = cfg.replace(num_layers=2)
    two = dict(params, blocks={kk: t[:2] for kk, t in params["blocks"].items()})
    full2 = gather_params(cfg2, two, mesh)
    rows = ids[mesh.rows(BATCH)]
    one_rank = make_forward_fn(cfg2, dev)

    def both(p):
        kw = dict(logit_start=PROMPT, logit_length=BLOCK)
        if p is params:
            with torch.inference_mode(), use_mesh(mesh, batch=BATCH):
                return forward(cfg2, p, rows, **kw)[0]
        return one_rank(p, rows, None, **kw)[0]

    depth_err = pinned_compare(f"rank {rank} 2-layer logits, dp {PAR_DP} x tp {PAR_TP} "
                               "against one rank", cfg2, rows, dev, params, full2, [],
                               forward=both)
    return dict(init_s=init_s, shard_gb=shard_gb / 1e9, secs=secs, launches=launches,
                counts=counts, comm_s=comm_s, peak_gib=peak / 2**30, out=np.asarray(out),
                errors=err, shapes=shapes, times=times, depth_err=depth_err,
                device=str(dev))


def serving_parallel_phase():
    """Phase 22: TP/DP serving at dp 2 × tp 2 on spawned ranks."""
    steps = PAR_STEPS
    if steps != STEPS:
        print(f"  steps cut from {STEPS} to {steps}", flush=True)
    res = run_ranks("par_serve_task", steps)
    secs = max(r["secs"] for r in res)
    same = all((r["out"] == res[0]["out"]).all() for r in res)
    print(f"  generate over the mesh: B {BATCH} ({BATCH // PAR_DP} rows a data rank), "
          f"prompt {PROMPT}, gen {GEN}, steps {steps}, block {BLOCK}: {secs:.4f} s, "
          f"{BATCH * GEN / secs:.2f} tok/s", flush=True)
    for r, x in enumerate(res):
        print(f"  rank {r} ({x['device']}): init {x['init_s']:.2f} s, shard "
              f"{x['shard_gb']:.3f} GB, peak {x['peak_gib']:.3f} GiB, generate "
              f"{x['secs']:.4f} s, collectives {json.dumps(x['counts'])}, "
              f"{x['comm_s']:.4f} s in them ({x['comm_s'] / x['secs']:.4f} of the "
              f"wall; each synchronized), launches {json.dumps(x['launches'])}",
              flush=True)
        print(f"  rank {r} sharded shapes: {json.dumps(x['shapes'])}; errors "
              f"{json.dumps(x['errors'])}; 2-layer max_abs_err {x['depth_err']:.4e}",
              flush=True)
    print(f"  identical ids on every rank (each model group's two ranks decode the "
          f"same rows): {same}", flush=True)
    if not same:
        raise AssertionError("the ranks decoded different ids")
    print(f"  rank 0 kernel times at its shapes: {json.dumps(res[0]['times'])}", flush=True)
    return dict(res=res, secs=secs, tokens_per_s=BATCH * GEN / secs, steps=steps)


def par_train_rows(seed=22, n=PAR_TRAIN_STEPS * PAR_TRAIN_BATCH, length=TRAIN_SEQ):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [{"input_ids": r.tolist(), "prompt_lengths": TRAIN_PROMPT}
            for r in rng.integers(10, 150000, (n, length))]


def par_train_args(out_dir, dp, tp, *extra):
    """The training CLI's arguments of phase 23; ``extra`` flags come last
    and override."""
    from ct_diffusionmodelbench_tpu_torch.cli import train as train_cli

    return train_cli.build_parser().parse_args([
        "--preset", "llada-moe-7b", "--optimizer-state-dtype", "bfloat16",
        "--grad-accum-dtype", "bfloat16", "--max-length", str(TRAIN_SEQ),
        "--batch-size", str(PAR_TRAIN_BATCH), "--grad-accum", "1", "--epochs", "1",
        "--eval-steps", "0", "--logging-steps", "1", "--output-dir", out_dir,
        "--seed", "0", "--dp", str(dp), "--tp", str(tp), *extra])


def par_train_run(dp, tp, out_dir, layers=PAR_TRAIN_LAYERS, rows=None, extra=()):
    """llada-moe-7b cut to ``layers`` trained through cli/train.py's
    ``train_mesh`` and ``run`` (``extra`` flags: the seq or stage axis, the
    shape): seeded weights, whole on one rank, under a mesh each rank's
    shard of the same draws (its stage's layers under ``--pp``), as
    ``load_model`` draws a preset."""
    from ct_diffusionmodelbench_tpu_torch.cli import train as train_cli
    from ct_diffusionmodelbench_tpu_torch.io.tokenizer import Tokenizer
    from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params
    from ct_diffusionmodelbench_tpu_torch.parallel.pipeline import init_pp_params
    from ct_diffusionmodelbench_tpu_torch.parallel.sharding import init_sharded_params

    cfg = get_config("llada-moe-7b").replace(num_layers=layers)
    args = par_train_args(out_dir, dp, tp, *extra)
    mesh = train_cli.train_mesh(args)
    if mesh is None:
        params = init_params(cfg, seed=0)
    else:
        params = (init_pp_params if mesh.stage > 1 else init_sharded_params)(cfg, 0, mesh)
    tok = Tokenizer.byte_fallback(vocab_size=cfg.vocab_size, eos_token_id=2)
    trainer = train_cli.run(args, cfg, params, tok, rows or par_train_rows(), [],
                            mesh=mesh)
    del params
    logs = [(e["loss"], e["grad_norm"]) for e in trainer.training_logs if "grad_norm" in e]
    return cfg, tok, trainer, logs


def par_train_noise(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    return (torch.rand((1, PAR_TRAIN_BATCH), generator=gen, device=dev),
            torch.rand((1, PAR_TRAIN_BATCH, TRAIN_SEQ), generator=gen, device=dev))


def par_train_task(rank, out_dir):
    """Phase 23 on one rank: the dp 2 × tp 2 training run, the attention
    kernels at its local heads, and a save then resume."""
    import torch.distributed as dist

    from ct_diffusionmodelbench_tpu_torch.io.checkpoint import load_checkpoint
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import reset_launch_counts
    from ct_diffusionmodelbench_tpu_torch.parallel import comm
    from ct_diffusionmodelbench_tpu_torch.train.trainer import Trainer

    dev = torch.device("cuda", torch.cuda.current_device())
    reset_launch_counts()
    comm.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    cfg, tok, trainer, logs = par_train_run(PAR_DP, PAR_TP, os.path.join(out_dir, "run"))
    launches = launch_counts()
    counts = dict(comm.COUNTS)
    peak = torch.cuda.max_memory_allocated()
    per_step = PAR_TRAIN_LAYERS * PAR_TRAIN_STEPS
    want = expected_launches(glue_launches(cfg, per_step, PAR_TRAIN_STEPS),
                             **{n: per_step for n in SERVING_KERNELS + BWD_KERNELS})
    if launches != want:
        raise AssertionError(f"rank {rank}: launches {launches}, expected {want}")

    # K8 with lse, K10 and K11 at this rank's heads (16 / tp q, 4 / tp kv).
    heads = (cfg.num_heads // PAR_TP, cfg.num_kv_heads // PAR_TP)
    times = None
    if rank == 0:
        c = attention_train_check(f"rank 0 training attention (H {heads[0]}, KV "
                                  f"{heads[1]})", dev, 1, *heads, 0, 30)
        times = par_train_attention_times(c, dev, *heads)
        times.update(err_fwd=c.err_fwd, err_bwd=c.err_bwd)
        del c
    dist.barrier()

    # Save (gathered, rank 0 writes) then resume into a fresh trainer: its
    # optimizer state must be the saved one, its next step's loss the same,
    # and the moments after that step (fed by the loaded state) the saved
    # trainer's after its step.
    ckpt = os.path.join(out_dir, "ckpt")
    trainer.cfg.save_optimizer_state = True
    trainer.save(ckpt)
    saved = state_digest(trainer.opt_state)
    rows = par_train_rows()[:PAR_TRAIN_BATCH]
    ids = torch.tensor([r["input_ids"] for r in rows], device=dev)[None]
    plens = torch.tensor([[r["prompt_lengths"] for r in rows]], device=dev)
    noise = par_train_noise(dev)

    def next_step(t):
        _, t.opt_state, m = t.train_step(t.params, t.opt_state, ids, plens, noise)
        return float(m["loss"]), state_digest(t.opt_state)

    loss_a, after_a = next_step(trainer)
    step_s, tc = list(trainer.step_times), trainer.cfg
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    _, full = load_checkpoint(ckpt, dtype="bfloat16", device="cpu")
    resumed = Trainer(cfg, full, tc, par_train_rows(), pad_token_id=tok.pad_token_id,
                      tokenizer=tok)
    del full
    resumed.load_training_state(ckpt)
    loaded = state_digest(resumed.opt_state)
    loss_b, after_b = next_step(resumed)
    return dict(logs=logs, launches=launches, counts=counts, peak_gib=peak / 2**30,
                step_s=step_s, times=times, loss_a=loss_a, loss_b=loss_b,
                step=resumed.global_step, state_equal=loaded == saved,
                count=loaded[0], moments_err=digest_err(after_a, after_b),
                counts_after=(after_a[0], after_b[0]))


def state_digest(state):
    """(count, {(moment, leaf): (Σ x·w, Σ |x|·w)}) of an optimizer state on
    this rank, in float64 with w = 1 + position mod 65521: a fingerprint
    that a lost, zeroed, misplaced or mis-sliced moment changes, taken
    without a second copy of the moments."""
    out = {}
    for kind, tree in (("mu", state.mu), ("nu", state.nu)):
        for name, t in tree.items():
            x = t.reshape(-1)
            s = a = 0.0
            for lo in range(0, x.numel(), 1 << 22):
                c = x[lo:lo + (1 << 22)].double()
                w = (torch.arange(lo, lo + c.numel(), device=c.device,
                                  dtype=torch.float64) % 65521) + 1
                s += float((c * w).sum())
                a += float((c.abs() * w).sum())
            out[(kind, name)] = (s, a)
    return state.count, out


def digest_err(want, got):
    """The largest difference of two :func:`state_digest` fingerprints'
    sums over a leaf's weighted magnitude."""
    return max(max(abs(g[0] - w[0]), abs(g[1] - w[1])) / max(w[1], 1e-30)
               for w, g in ((want[1][k], got[1][k]) for k in want[1]))


def par_train_attention_times(c, dev, H, KV):
    """K8 with lse, K10 and K11 at a rank's training shape (phase 23: B 1,
    S 2048, H, KV, Dh 128, RoPE; phase 24: a ring chunk, no RoPE): kernel,
    plain version and SDPA's forward / backward, timed, with their
    bounds."""
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention_bwd as fab

    B, S, _, Dh = c.q.shape
    rope = c.rope or ()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = c.qr.transpose(1, 2), c.kr.transpose(1, 2), c.v.transpose(1, 2)
    t = time_turns({"kernel": lambda: fa.flash_attention_cuda(
        c.q, c.k, c.v, rope=c.rope, with_lse=True),
        "library": lambda: sdpa(qt, kt, vt, enable_gqa=True)}, 20)
    flops = 4.0 * B * H * S * S * Dh
    b = bound_ms(flops, nbytes(c.q, c.k, c.v, c.out, c.lse, *rope))
    out = {"flash_attention_fwd": dict(ms=t["kernel"], library_ms=t["library"],
           plain_ms=time_ms(lambda: fa.flash_attention_plain(
               c.q, c.k, c.v, rope=c.rope, with_lse=True), 3, warmup=1),
           bound_ms=b[0], bound_by=b[1])}
    qg, kg, vg = (a.detach().requires_grad_(True) for a in (qt, kt, vt))
    s_out = sdpa(qg, kg, vg, enable_gqa=True)
    dot = c.do.transpose(1, 2)
    dsum = fab.row_dot(c.out, c.do)
    dq, dk, dv = (torch.empty(a.shape, dtype=torch.float32, device=dev)
                  for a in (c.q, c.k, c.v))
    common = (c.qr.data_ptr(), c.kr.data_ptr(), c.v.data_ptr(), c.bias.data_ptr(),
              c.do.data_ptr(), c.lse.data_ptr(), dsum.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    t = time_turns({
        "dq": lambda: fab.DQ_KERNEL(*common, dq.data_ptr(), B, S, H, KV, Dh, Dh ** -0.5,
                                    stream),
        "dkv": lambda: fab.DKV_KERNEL(*common, dk.data_ptr(), dv.data_ptr(), B, S, H, KV,
                                      Dh, Dh ** -0.5, stream),
        "library": lambda: torch.autograd.grad(s_out, (qg, kg, vg), dot,
                                               retain_graph=True)}, 20)
    plain = time_ms(lambda: fab.flash_attention_bwd_plain(
        c.qr, c.kr, c.v, c.bias, c.out, c.do, c.lse), 3, warmup=1)
    ins = nbytes(c.qr, c.kr, c.v, c.do, c.lse, dsum, c.bias)
    for name, key, fl, outs in (("flash_attention_bwd_dq", "dq", 6.0, (dq,)),
                                ("flash_attention_bwd_dkv", "dkv", 8.0, (dk, dv))):
        b = bound_ms(fl * B * H * S * S * Dh, ins + nbytes(*outs))
        # SDPA computes dq, dk and dv in one call: its whole backward is the
        # yardstick of each.
        out[name] = dict(ms=t[key], library_ms=t["library"], plain_ms=plain,
                         bound_ms=b[0], bound_by=b[1])
    return out


def training_parallel_phase():
    """Phase 23: dp 2 × tp 2 training on spawned ranks against the one-rank
    trainer on the same weights and data (run first, in this process)."""
    import numpy as np

    print(f"  llada-moe-7b at full width cut to {PAR_TRAIN_LAYERS} layers (printed cut); "
          f"L {TRAIN_SEQ}, B {PAR_TRAIN_BATCH} (a row per data rank), "
          f"{PAR_TRAIN_STEPS} steps, bf16 moments and accumulation", flush=True)
    out_dir = tempfile.mkdtemp(prefix="ctdb-par-train-")
    try:
        t0 = time.perf_counter()
        _, _, trainer, ref = par_train_run(1, 1, os.path.join(out_dir, "one"))
        one_s = list(trainer.step_times)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  one rank: loss / grad_norm per step "
              + ", ".join(f"{a:.5f} / {g:.5f}" for a, g in ref)
              + f"; s/step {[round(x, 4) for x in one_s]} ({time.perf_counter() - t0:.1f} s "
              "with init)", flush=True)
        res = run_ranks("par_train_task", out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for r, x in enumerate(res):
        print(f"  rank {r}: loss / grad_norm per step "
              + ", ".join(f"{a:.5f} / {g:.5f}" for a, g in x["logs"])
              + f"; s/step {[round(t, 4) for t in x['step_s']]}; peak "
              f"{x['peak_gib']:.3f} GiB; collectives {json.dumps(x['counts'])}; launches "
              f"{json.dumps({k: v for k, v in x['launches'].items() if v})}", flush=True)
    got = np.asarray(res[0]["logs"])
    want = np.asarray(ref)
    loss_err = float(np.max(np.abs(got[:, 0] - want[:, 0]) / np.abs(want[:, 0])))
    norm_err = float(np.max(np.abs(got[:, 1] - want[:, 1]) / np.abs(want[:, 1])))
    same_ranks = all(x["logs"] == res[0]["logs"] for x in res)
    print(f"  dp {PAR_DP} x tp {PAR_TP} against one rank: loss rel err {loss_err:.3e} "
          f"(limit {LOSS_RTOL:.3g}), grad norm rel err {norm_err:.3e} (limit "
          f"{GRAD_REL_L2:.3g}); every rank logs the same: {same_ranks}", flush=True)
    if len(got) != PAR_TRAIN_STEPS or not np.isfinite(got).all() or \
            loss_err > LOSS_RTOL or norm_err > GRAD_REL_L2 or not same_ranks:
        raise AssertionError("dp x tp training disagrees with the one-rank trainer")
    resume = [(x["loss_a"], x["loss_b"]) for x in res]
    print(f"  save then resume (gathered on rank 0, re-sharded): optimizer state "
          f"(count {res[0]['count']}, every moment shard's fingerprint) equal to the "
          f"saved on every rank: {all(x['state_equal'] for x in res)}; next-step loss "
          f"{resume[0][0]:.6f} before, {resume[0][1]:.6f} resumed (step "
          f"{res[0]['step']}), bit-equal on every rank: "
          f"{all(a == b for a, b in resume)}; moments after that step against the "
          f"saved trainer's: fingerprint err {max(x['moments_err'] for x in res):.3e} "
          f"(limit {RESUME_MOMENT_TOL:.3g}), counts {res[0]['counts_after']}", flush=True)
    if not all(x["state_equal"] for x in res):
        raise AssertionError("the resumed optimizer state differs from the saved one")
    if any(abs(a - b) > LOSS_RTOL * abs(a) for a, b in resume):
        raise AssertionError("the resumed trainer's next step differs")
    if any(x["moments_err"] > RESUME_MOMENT_TOL or x["counts_after"][0] != x["counts_after"][1]
           for x in res):
        raise AssertionError("the moments after the resumed step differ")
    times = res[0]["times"]
    print(f"  rank 0 training attention times at its shapes: {json.dumps(times)}",
          flush=True)
    return dict(res=res, ref=ref, loss_err=loss_err, norm_err=norm_err)


def sp_launches_per_rank():
    """Phase 24's launches a rank, from the code: per layer and step, K8
    runs sp chunks in the forward and again in remat's recompute, K10 and
    K11 sp chunks in the backward, K1 and K2 once in the forward and once
    in the recompute (the grouped backward runs on ``torch._grouped_mm``)."""
    per = SP_LAYERS * SP_STEPS
    want = {"flash_attention_fwd": 2 * SP_SP * per, "flash_attention_bwd_dq": SP_SP * per,
            "flash_attention_bwd_dkv": SP_SP * per, "grouped_gateup": 2 * per,
            "grouped_down": 2 * per}
    # Tensors sent a layer and step: (k, v) at each of sp - 1 forward
    # rotations, twice (remat); (k, v, dk, dv) at each of sp - 1 backward
    # rotations and (dk, dv) on their last hop home.
    p2p = (2 * 2 * (SP_SP - 1) + 4 * (SP_SP - 1) + 2) * per
    return want, p2p


def ring_attention_check(rank, mesh, dev):
    """Ring attention over this rank's seq group at its heads (16 / tp q,
    4 / tp kv), B 2, the whole L split over seq, forward and backward,
    against the flash kernels over the whole sequence (one rank's path);
    then the inputs of one ring chunk for the kernel checks."""
    from types import SimpleNamespace

    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
    from ct_diffusionmodelbench_tpu_torch.ops.ring_attention import (
        ring_attention, ring_attention_local)

    H, KV = 16 // SP_TP, 4 // SP_TP
    q, k, v, do, _, _ = attention_case(dev, SP_BATCH, SP_SEQ, H, KV, 128, 240)
    pos = mesh.seq_slice(SP_SEQ)
    mine = [t[:, pos].contiguous().requires_grad_(True) for t in (q, k, v)]
    out_r = ring_attention(*mine, mesh=mesh)
    out_r.backward(do[:, pos].contiguous())
    whole = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out_w = fa.flash_attention(*whole)
    out_w.backward(do)
    torch.cuda.synchronize()
    err_fwd = compare(f"rank {rank} ring attention out (seq rank {mesh.seq_rank}) "
                      "against flash over the whole sequence", out_r.detach(),
                      out_w[:, pos].detach(), **FLASH_TOL)
    err_bwd = compare_bwd(f"rank {rank} ring attention", [t.grad for t in mine],
                          [t.grad[:, pos] for t in whole])
    ql, kl, vl = (t.detach() for t in mine)
    o, lse = ring_attention_local(ql, kl, vl, mesh=mesh)   # the global o / lse
    return err_fwd, err_bwd, SimpleNamespace(
        q=ql, k=kl, v=vl, do=do[:, pos].contiguous(), rope=None, qr=ql, kr=kl,
        bias=fa.mask_bias(None, SP_BATCH, SP_SEQ // SP_SP, dev), out=o, lse=lse)


def chunk_kernel_check(c, dev):
    """K8 with lse at the ring chunk's shape (no RoPE) and K10 / K11 on the
    chunk with the ring's global o and lse, each against its plain
    version."""
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention_bwd as fab

    out, lse = fa.flash_attention_cuda(c.q, c.k, c.v, with_lse=True)
    out_p, lse_p = fa.flash_attention_plain(c.q, c.k, c.v, with_lse=True)
    got = fab.flash_attention_bwd_cuda(c.q, c.k, c.v, c.bias, c.out, c.do, c.lse)
    want = fab.flash_attention_bwd_plain(c.q, c.k, c.v, c.bias, c.out, c.do, c.lse)
    torch.cuda.synchronize()
    shape = "x".join(map(str, c.q.shape))
    err_fwd = max(compare(f"rank 0 K8 with lse at the chunk ({shape}) out", out, out_p,
                          **FLASH_TOL),
                  compare("rank 0 K8 with lse at the chunk lse", lse, lse_p, 0.0, LSE_ATOL))
    err_bwd = compare_bwd(f"rank 0 K10 / K11 at the chunk with the ring's o / lse",
                          got, want)
    return err_fwd, err_bwd


def par_sp_task(rank, out_dir):
    """Phase 24 on one rank: the dp 1 x sp 2 x tp 2 training run through
    the training CLI, the ring attention against the flash kernels over the
    whole sequence, and (rank 0) the kernels at the ring chunk's shape."""
    import torch.distributed as dist

    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import reset_launch_counts
    from ct_diffusionmodelbench_tpu_torch.parallel import comm

    dev = torch.device("cuda", torch.cuda.current_device())
    reset_launch_counts()
    comm.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with comm.timed():
        cfg, _, trainer, logs = par_train_run(
            SP_DP, SP_TP, os.path.join(out_dir, "run"), layers=SP_LAYERS,
            rows=par_train_rows(24, SP_STEPS * SP_BATCH, SP_SEQ),
            extra=SP_FLAGS + ("--sp", str(SP_SP)))
    launches = launch_counts()
    counts, secs = dict(comm.COUNTS), dict(comm.SECONDS)
    peak = torch.cuda.max_memory_allocated()
    step_s, mesh = list(trainer.step_times), trainer.mesh
    want, p2p = sp_launches_per_rank()
    want = expected_launches(
        glue_launches(cfg, 2 * SP_LAYERS * SP_STEPS, SP_STEPS), **want)
    if launches != want:
        raise AssertionError(f"rank {rank}: launches {launches}, expected {want}")
    if counts["p2p"] != p2p:
        raise AssertionError(f"rank {rank}: {counts['p2p']} tensors sent, expected {p2p}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    err_ring_fwd, err_ring_bwd, c = ring_attention_check(rank, mesh, dev)
    times = err_chunk = None
    if rank == 0:
        err_chunk = chunk_kernel_check(c, dev)
        times = par_train_attention_times(c, dev, c.q.shape[2], c.k.shape[2])
    dist.barrier()
    return dict(logs=logs, launches=launches, counts=counts, secs=secs,
                peak_gib=peak / 2**30, step_s=step_s, err_ring=(err_ring_fwd, err_ring_bwd),
                err_chunk=err_chunk, times=times, chunk=list(c.q.shape),
                coords=(mesh.data_rank, mesh.seq_rank, mesh.model_rank))


def sp_training_phase():
    """Phase 24: dp 1 x sp 2 x tp 2 training on spawned ranks against the
    one-rank trainer on the same weights and data (run first, in this
    process)."""
    import numpy as np

    print(f"  llada-moe-7b at full width cut to {SP_LAYERS} layers; L {SP_SEQ}, B "
          f"{SP_BATCH}, {SP_STEPS} steps, remat, bf16 moments and accumulation; "
          f"ring chunk L/sp {SP_SEQ // SP_SP}", flush=True)
    out_dir = tempfile.mkdtemp(prefix="ctdb-sp-train-")
    rows = par_train_rows(24, SP_STEPS * SP_BATCH, SP_SEQ)
    try:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        _, _, trainer, ref = par_train_run(1, 1, os.path.join(out_dir, "one"),
                                           layers=SP_LAYERS, rows=rows, extra=SP_FLAGS)
        one_s, one_peak = list(trainer.step_times), torch.cuda.max_memory_allocated()
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  one rank: loss / grad_norm per step "
              + ", ".join(f"{a:.5f} / {g:.5f}" for a, g in ref)
              + f"; s/step {[round(x, 4) for x in one_s]}; peak {one_peak / 2**30:.3f} GiB "
              f"({time.perf_counter() - t0:.1f} s with init)", flush=True)
        res = run_ranks("par_sp_task", out_dir,
                        layout=f"dp {SP_DP} x sp {SP_SP} x tp {SP_TP}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for r, x in enumerate(res):
        wall = sum(x["step_s"])
        print(f"  rank {r} (data, seq, model) {x['coords']}: loss / grad_norm per step "
              + ", ".join(f"{a:.5f} / {g:.5f}" for a, g in x["logs"])
              + f"; s/step {[round(t, 4) for t in x['step_s']]}; peak "
              f"{x['peak_gib']:.3f} GiB; collectives {json.dumps(x['counts'])}; p2p "
              f"{x['secs']['p2p']:.4f} s ({x['secs']['p2p'] / wall:.4f} of the steps' "
              f"wall), all-reduce {x['secs']['all_reduce']:.4f} s "
              f"({x['secs']['all_reduce'] / wall:.4f}), all-gather "
              f"{x['secs']['all_gather']:.4f} s (the vocab-parallel head's logits, one "
              f"gather over model a CE chunk and pass; on seq rank 0 the save's too; "
              f"each collective synchronized to be timed); launches "
              f"{json.dumps({k: v for k, v in x['launches'].items() if v})}", flush=True)
    got, want = np.asarray(res[0]["logs"]), np.asarray(ref)
    loss_err = float(np.max(np.abs(got[:, 0] - want[:, 0]) / np.abs(want[:, 0])))
    norm_err = float(np.max(np.abs(got[:, 1] - want[:, 1]) / np.abs(want[:, 1])))
    same_ranks = all(x["logs"] == res[0]["logs"] for x in res)
    print(f"  dp {SP_DP} x sp {SP_SP} x tp {SP_TP} against one rank: loss rel err "
          f"{loss_err:.3e} (limit {LOSS_RTOL:.3g}), grad norm rel err {norm_err:.3e} "
          f"(limit {GRAD_REL_L2:.3g}); every rank logs the same: {same_ranks}", flush=True)
    if len(got) != SP_STEPS or not np.isfinite(got).all() or \
            loss_err > LOSS_RTOL or norm_err > GRAD_REL_L2 or not same_ranks:
        raise AssertionError("sp training disagrees with the one-rank trainer")
    print(f"  rank 0 kernel times at the ring chunk {res[0]['chunk']} (no RoPE, the "
          f"ring's o / lse): {json.dumps(res[0]['times'])}", flush=True)
    return dict(res=res, ref=ref, loss_err=loss_err, norm_err=norm_err, one_s=one_s,
                one_peak_gib=one_peak / 2**30)


def pp_launches_per_rank(cfg):
    """Phase 25 (a)'s launches a rank, from the code: each stage runs its
    one layer on each microbatch of each step, K8, K1, K2 and the glue in
    the forward, K10 and K11 in the backward (no remat); every stage takes
    the final norm once a step."""
    n = PP_LAYERS // PP_STAGES * PP_MICRO * PP_STEPS
    return expected_launches(
        glue_launches(cfg, n, PP_STEPS), flash_attention_fwd=n,
        flash_attention_bwd_dq=n, flash_attention_bwd_dkv=n, grouped_gateup=n,
        grouped_down=n)


def par_pp_task(rank, out_dir):
    """Phase 25 (a) on one rank: 4 stages of one llada-moe-7b layer through
    the training CLI (``--pp 4 --pp-microbatches 4``)."""
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import reset_launch_counts
    from ct_diffusionmodelbench_tpu_torch.parallel import comm

    reset_launch_counts()
    comm.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with comm.timed():
        cfg, _, trainer, logs = par_train_run(
            1, 1, os.path.join(out_dir, "run"), layers=PP_LAYERS,
            rows=par_train_rows(25, PP_STEPS * PP_BATCH, PP_SEQ),
            extra=PP_FLAGS + ("--pp", str(PP_STAGES), "--pp-microbatches", str(PP_MICRO)))
    launches = launch_counts()
    want = pp_launches_per_rank(cfg)
    if launches != want:
        raise AssertionError(f"rank {rank}: launches {launches}, expected {want}")
    st = trainer.mesh.stage_rank
    p2p = PP_MICRO * PP_STEPS * ((st < PP_STAGES - 1) + (st > 0))
    if comm.COUNTS["p2p"] != p2p:
        raise AssertionError(f"rank {rank}: {comm.COUNTS['p2p']} tensors sent, "
                             f"expected {p2p}")
    return dict(logs=logs, launches=launches, counts=dict(comm.COUNTS),
                secs=dict(comm.SECONDS), peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                step_s=list(trainer.step_times), stage=st)


def pptp_inputs():
    """Phase 25 (b)'s batch and noise, drawn on the host from a seed (the
    same on every rank and in the parent)."""
    gen = torch.Generator().manual_seed(25)
    ids = torch.randint(10, 120000, (1, PPTP_BATCH, PP_SEQ), generator=gen)
    plens = torch.full((1, PPTP_BATCH), TRAIN_PROMPT)
    t = torch.rand((1, PPTP_BATCH), generator=gen)
    u = torch.rand((1, PPTP_BATCH, PP_SEQ), generator=gen)
    return ids, plens, (t, u)


def pptp_config():
    from ct_diffusionmodelbench_tpu_torch.models import get_config
    from ct_diffusionmodelbench_tpu_torch.train.trainer import TrainConfig

    cfg = get_config("llada-8b").replace(num_layers=PPTP_LAYERS)
    return cfg, lambda **kw: TrainConfig(
        batch_size=PPTP_BATCH, grad_accum=1, max_length=PP_SEQ,
        optimizer_state_dtype="bfloat16", grad_accum_dtype="bfloat16", **kw)


def par_pptp_task(rank):
    """Phase 25 (b) on one rank: llada-8b cut to 2 layers on 2 stages x tp
    2, each rank drawing its stage's layers, column / row split: the
    pipelined logits against the one-rank forward on the gathered weights
    (rank 0), then one training step."""
    import torch.distributed as dist

    from ct_diffusionmodelbench_tpu_torch.models import make_forward_fn
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import reset_launch_counts
    from ct_diffusionmodelbench_tpu_torch.parallel.pipeline import (
        gather_params_pp, init_pp_params, make_pp_forward, make_pp_mesh)
    from ct_diffusionmodelbench_tpu_torch.train.trainer import Trainer

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg, tcfg = pptp_config()
    mesh = make_pp_mesh(PPTP_STAGES, model=PPTP_TP, device=dev)
    params = init_pp_params(cfg, 0, mesh)
    ids, plens, noise = pptp_inputs()
    with torch.inference_mode():
        logits, _ = make_pp_forward(cfg, mesh, 2)(params, ids[0])
        full = gather_params_pp(cfg, params, mesh)
        err = None
        if rank == 0:
            want, _ = make_forward_fn(cfg, dev)(full, ids[0])
            err = float((logits - want).abs().max() / want.abs().max())
            del want
        del full, logits
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    trainer = Trainer(cfg, params, tcfg(pp=PPTP_STAGES, tp=PPTP_TP, pp_microbatches=2),
                      [{"input_ids": [5] * 8, "prompt_lengths": 1}], mesh=mesh)
    del params
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    _, _, m = trainer.train_step(trainer.params, trainer.opt_state, ids, plens, noise)
    torch.cuda.synchronize()
    return dict(err=err, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                launches=launch_counts(),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                coords=(mesh.stage_rank, mesh.model_rank))


def pp_training_phase():
    """Phase 25: (a) pp 4 training of llada-moe-7b cut to 4 layers and (b)
    pp 2 x tp 2 on llada-8b cut to 2 layers, on spawned ranks, against
    one-rank runs in this process."""
    import numpy as np

    from ct_diffusionmodelbench_tpu_torch.models import init_params
    from ct_diffusionmodelbench_tpu_torch.train.trainer import Trainer

    print(f"  (a) llada-moe-7b at full width cut to {PP_LAYERS} layers, {PP_STAGES} "
          f"stages of {PP_LAYERS // PP_STAGES}, {PP_MICRO} microbatches of "
          f"{PP_BATCH // PP_MICRO} row; L {PP_SEQ}, B {PP_BATCH}, {PP_STEPS} steps, bf16 "
          "moments and accumulation", flush=True)
    out_dir = tempfile.mkdtemp(prefix="ctdb-pp-train-")
    rows = par_train_rows(25, PP_STEPS * PP_BATCH, PP_SEQ)
    try:
        torch.cuda.reset_peak_memory_stats()
        _, _, trainer, ref = par_train_run(1, 1, os.path.join(out_dir, "one"),
                                           layers=PP_LAYERS, rows=rows, extra=PP_FLAGS)
        one_s, one_peak = list(trainer.step_times), torch.cuda.max_memory_allocated()
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  (a) one rank: loss / grad_norm per step "
              + ", ".join(f"{a:.5f} / {g:.5f}" for a, g in ref)
              + f"; s/step {[round(x, 4) for x in one_s]}; peak {one_peak / 2**30:.3f} GiB",
              flush=True)
        res = run_ranks("par_pp_task", out_dir,
                        layout=f"dp 1 x pp {PP_STAGES} x tp 1, {PP_MICRO} microbatches")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for r, x in enumerate(res):
        wall = sum(x["step_s"])
        print(f"  (a) rank {r} (stage {x['stage']}): loss / grad_norm per step "
              + ", ".join(f"{a:.5f} / {g:.5f}" for a, g in x["logs"])
              + f"; s/step {[round(t, 4) for t in x['step_s']]}; peak "
              f"{x['peak_gib']:.3f} GiB; collectives {json.dumps(x['counts'])}; p2p "
              f"{x['secs']['p2p']:.4f} s ({x['secs']['p2p'] / wall:.4f} of the steps' "
              f"wall), all-reduce {x['secs']['all_reduce']:.4f} s "
              f"({x['secs']['all_reduce'] / wall:.4f}; each synchronized); launches "
              f"{json.dumps({k: v for k, v in x['launches'].items() if v})}", flush=True)
    got, want = np.asarray(res[0]["logs"]), np.asarray(ref)
    loss_err = float(np.max(np.abs(got[:, 0] - want[:, 0]) / np.abs(want[:, 0])))
    norm_err = float(np.max(np.abs(got[:, 1] - want[:, 1]) / np.abs(want[:, 1])))
    same_ranks = all(x["logs"] == res[0]["logs"] for x in res)
    print(f"  (a) pp {PP_STAGES} against one rank: loss rel err {loss_err:.3e} (limit "
          f"{LOSS_RTOL:.3g}; the aux loss per microbatch is the reference's GPipe "
          f"approximation), grad norm rel err {norm_err:.3e} (limit {GRAD_REL_L2:.3g}); "
          f"every rank logs the same: {same_ranks}", flush=True)
    if len(got) != PP_STEPS or not np.isfinite(got).all() or \
            loss_err > LOSS_RTOL or norm_err > GRAD_REL_L2 or not same_ranks:
        raise AssertionError("pp training disagrees with the one-rank trainer")

    cfg, tcfg = pptp_config()
    print(f"  (b) llada-8b at full width cut to {PPTP_LAYERS} layers, {PPTP_STAGES} "
          f"stages x tp {PPTP_TP}, B {PPTP_BATCH} in 2 microbatches, L {PP_SEQ}",
          flush=True)
    ids, plens, noise = pptp_inputs()
    one = Trainer(cfg, init_params(cfg, seed=0), tcfg(),
                  [{"input_ids": [5] * 8, "prompt_lengths": 1}])
    _, _, m = one.train_step(one.params, one.opt_state, ids, plens, noise)
    ref_b = (float(m["loss"]), float(m["grad_norm"]))
    del one, m
    gc.collect()
    torch.cuda.empty_cache()
    res_b = run_ranks("par_pptp_task", layout=f"dp 1 x pp {PPTP_STAGES} x tp {PPTP_TP}")
    for r, x in enumerate(res_b):
        print(f"  (b) rank {r} (stage, model) {x['coords']}: step loss / grad_norm "
              f"{x['loss']:.5f} / {x['grad_norm']:.5f}; peak {x['peak_gib']:.3f} GiB; "
              f"launches {json.dumps({k: v for k, v in x['launches'].items() if v})}",
              flush=True)
    err_b = res_b[0]["err"]
    loss_err_b = abs(res_b[0]["loss"] - ref_b[0]) / abs(ref_b[0])
    norm_err_b = abs(res_b[0]["grad_norm"] - ref_b[1]) / abs(ref_b[1])
    print(f"  (b) pipelined logits against the one-rank forward: max err / max |logit| "
          f"{err_b:.3e} (limit {LOGITS_RTOL_OF_MAX:.3g}); one step against one rank "
          f"({ref_b[0]:.5f} / {ref_b[1]:.5f}): loss rel err {loss_err_b:.3e} (limit "
          f"{LOSS_RTOL:.3g}), grad norm rel err {norm_err_b:.3e} (limit "
          f"{GRAD_REL_L2:.3g})", flush=True)
    # A rank's one layer on each of 2 microbatches; one final norm.
    want_b = {"flash_attention_fwd": 2, "flash_attention_bwd_dq": 2,
              "flash_attention_bwd_dkv": 2, **glue_launches(cfg, 2, 1)}
    for r, x in enumerate(res_b):
        if {k: v for k, v in x["launches"].items() if v} != want_b:
            raise AssertionError(f"(b) rank {r}: launches {x['launches']}, expected {want_b}")
    if err_b > LOGITS_RTOL_OF_MAX or loss_err_b > LOSS_RTOL or norm_err_b > GRAD_REL_L2:
        raise AssertionError("pp x tp disagrees with one rank")
    return dict(res=res, ref=ref, res_b=res_b, loss_err=loss_err, norm_err=norm_err,
                err_b=err_b, one_s=one_s, one_peak_gib=one_peak / 2**30)


# ---------------------------------------------------------------------------
# The measuring entry points (phases 26-30)
# ---------------------------------------------------------------------------

# Phase 26: K8 launches in the traced loop; the on-chip busy time against
# the kernels' summed time.
BUSY_ITERS = 200
BUSY_REL_TOL = 0.10
BENCH_TIMEOUT_S = 600
SWEEP_SECTIONS = ("attention_crossover", "grouped_gemm", "sft_train_step")


def profiling_phase(dev):
    """Phase 26: ``onchip_device_seconds`` of a K8 loop against the loop's
    CUDA-event window and against ``key_averages``' kernel sum."""
    from torch.profiler import ProfilerActivity, profile

    from ct_diffusionmodelbench_tpu_torch.ops.flash_attention import flash_attention
    from ct_diffusionmodelbench_tpu_torch.utils.profiling import onchip_device_seconds

    q, k, v, _, mask, rope = attention_case(dev, BATCH, SEQ, 16, 4, 128, seed=26,
                                            pad=PROMPT // 2)
    window = {}

    @torch.inference_mode()
    def loop():
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(BUSY_ITERS):
            flash_attention(q, k, v, mask=mask, rope=rope)
        end.record()
        torch.cuda.synchronize()
        window["s"] = start.elapsed_time(end) / 1e3

    loop()
    busy = onchip_device_seconds(loop)
    if not isinstance(busy, float):
        raise AssertionError(f"onchip_device_seconds gave {busy!r} for {BUSY_ITERS} K8 launches")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loop()
    kernel_s = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    rel = abs(busy - kernel_s) / kernel_s
    print(f"  {BUSY_ITERS} K8 launches at B {BATCH}, S {SEQ}, H 16, KV 4: busy "
          f"{busy * 1e3:.3f} ms (union of device intervals), CUDA-event window of the "
          f"traced loop {window['s'] * 1e3:.3f} ms, kernels' sum in key_averages "
          f"{kernel_s * 1e3:.3f} ms (rel diff {rel:.4f}, limit {BUSY_REL_TOL})", flush=True)
    if busy > window["s"]:
        raise AssertionError("busy time exceeds the CUDA-event window")
    if rel > BUSY_REL_TOL:
        raise AssertionError("busy time and the kernels' summed time disagree")


def bench_phase(dev):
    """Phase 27: the headline bench's CLI in a subprocess, its one line
    checked and printed."""
    run = subprocess.run([sys.executable, "-m", "ct_diffusionmodelbench_tpu_torch.bench"],
                         capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    lines = run.stdout.strip().splitlines()
    if run.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"bench: rc {run.returncode}, {len(lines)} stdout lines:\n"
                             f"{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
    print(f"  {lines[0]}", flush=True)
    res = json.loads(lines[0])
    head = res["config"]["headline"]
    checks = {
        "chip_kind names the card": res["config"]["chip_kind"] == torch.cuda.get_device_name(dev),
        "value > 0": (res["value"] or 0) > 0,
        "mfu not null": head.get("mfu") is not None,
        "on-chip seconds <= wall seconds":
            head.get("onchip_seconds_per_batch", float("inf")) <= head["seconds_per_batch"],
    }
    print(f"  busy share of the headline (on-chip / wall seconds per batch): "
          f"{head.get('onchip_seconds_per_batch', float('nan')) / head['seconds_per_batch']:.4f}; "
          + ", ".join(f"{k}: {'ok' if v else 'FAILED'}" for k, v in checks.items()), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"bench line fails {[k for k, v in checks.items() if not v]}")


def entry_phase(dev):
    """Phase 28: ``entry()``'s forward of llada-8b on the card."""
    from ct_diffusionmodelbench_tpu_torch.entry import entry
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import KERNELS, reset_launch_counts

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn, (params, ids) = entry()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reset_launch_counts()
    t0 = time.perf_counter()
    logits = fn(params, ids)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    launches = {name: kk.launches for name, kk in KERNELS.items() if kk.launches}
    vocab = params["lm_head"].shape[-1] if "lm_head" in params else params["embed"].shape[0]
    finite = bool(torch.isfinite(logits).all())
    print(f"  llada-8b: init {init_s:.2f} s, first forward {fwd_s:.3f} s, logits "
          f"{tuple(logits.shape)} {logits.dtype}, finite {finite}, launches "
          f"{json.dumps(launches)}, peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
          flush=True)
    want = {"flash_attention_fwd": 32, "rms_norm": 65, "swiglu_act": 32}
    if launches != want:
        raise AssertionError(f"entry forward launches {launches}, expected {want}")
    if tuple(logits.shape) != (1, 320, vocab) or not finite:
        raise AssertionError("entry forward: wrong shape or non-finite logits")
    del fn, params, ids, logits
    gc.collect()
    torch.cuda.empty_cache()


def dryrun_phase(dev):
    """Phase 29: the eight-rank dry run and its four lines."""
    from ct_diffusionmodelbench_tpu_torch.entry import dryrun_multichip

    res = dryrun_multichip(8)
    print(f"  rank 0: {json.dumps(res)}", flush=True)
    if set(res) < {"loss", "grad_norm", "sp_loss", "pp_err", "pptp_err"}:
        raise AssertionError(f"dry run returned {res}")


def sweep_phase(dev):
    """Phase 30: three of the sweep's sections at full shape."""
    from ct_diffusionmodelbench_tpu_torch import bench_sweep

    ledger = bench_sweep.sweep(set(SWEEP_SECTIONS))
    for name in SWEEP_SECTIONS:
        rows = ledger[name] if isinstance(ledger[name], list) else [ledger[name]]
        for row in rows:
            print(f"  {name}: {json.dumps(row)}", flush=True)
    bad = bench_sweep.erred(ledger)
    if bad:
        raise AssertionError(f"sweep sections failed: {bad}")


def bf16_ulps(got, want):
    """|got − want| in units of the last place of bf16 at want's magnitude."""
    want = want.float()
    exp = torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126)))
    return (got.float() - want).abs() / torch.exp2(exp - 7)


def rms_norm_check(glue, x, scale) -> float:
    """``rms_norm`` of bf16 x against its plain version: at most one bf16
    ulp apart, bit-equal on 99 % or more; returns the largest error."""
    y = glue.rms_norm(x, scale, GLUE_EPS)
    want = glue.rms_norm_plain(x, scale, GLUE_EPS)
    ulps = float(bf16_ulps(y, want).max())
    equal = float((y == want).float().mean())
    print(f"  rms_norm {list(x.shape)} bf16: max {ulps:.0f} bf16 ulp from the composite, "
          f"bit-equal on {100 * equal:.4f} % of elements", flush=True)
    if ulps > 1 or equal < 0.99:
        raise AssertionError(f"rms_norm {list(x.shape)}: kernel disagrees with its plain "
                             f"version")
    return float((y.float() - want.float()).abs().max())


def glue_phase(dev):
    """Phase 31: ``rms_norm`` and ``swiglu_act`` at dense8b-eval's shapes
    against their plain versions, timed in turns beside them and, for the
    norm, ``torch.nn.functional.rms_norm`` (a yardstick the port never
    calls), each run queued behind a sleeping kernel (a norm takes less
    time on the card than its call on the host); then ``rms_norm`` against
    its plain version at the other served rows (:data:`GLUE_OTHER_ROWS`)."""
    from ct_diffusionmodelbench_tpu_torch.ops import glue

    g = torch.Generator(device=dev).manual_seed(31)
    xs = [(torch.randn((GLUE_ROWS, GLUE_D), generator=g, device=dev) * 3).to(torch.bfloat16)
          for _ in range(GLUE_SETS)]
    scale = (1 + 0.5 * torch.randn(GLUE_D, generator=g, device=dev)).to(torch.bfloat16)
    gate = torch.randn((GLUE_ROWS, GLUE_F), generator=g, device=dev) * 4
    up = torch.randn((GLUE_ROWS, GLUE_F), generator=g, device=dev)

    err = rms_norm_check(glue, xs[0], scale)
    h = glue.swiglu_act(gate, up, torch.bfloat16)
    h_equal = bool(torch.equal(h, glue.swiglu_act_plain(gate, up, torch.bfloat16)))
    print(f"  swiglu_act [{GLUE_ROWS}, {GLUE_F}] f32 -> bf16: bit-equal {h_equal}", flush=True)
    if not h_equal:
        raise AssertionError("swiglu_act: kernel disagrees with its plain version")
    del h

    turn = [0]

    def next_x():
        turn[0] = (turn[0] + 1) % GLUE_SETS
        return xs[turn[0]]

    host_us_per_launch({"rms_norm": lambda: glue.rms_norm_cuda(xs[0], scale, GLUE_EPS),
                        "swiglu_act": lambda: glue.swiglu_act_cuda(gate, up, torch.bfloat16)})
    norm = time_turns_queued({
        "kernel": lambda: glue.rms_norm_cuda(next_x(), scale, GLUE_EPS),
        "plain": lambda: glue.rms_norm_plain(next_x(), scale, GLUE_EPS),
        "library": lambda: torch.nn.functional.rms_norm(next_x(), (GLUE_D,), scale,
                                                        GLUE_EPS)}, iters=50)
    act = time_turns_queued({
        "kernel": lambda: glue.swiglu_act_cuda(gate, up, torch.bfloat16),
        "plain": lambda: glue.swiglu_act_plain(gate, up, torch.bfloat16)}, iters=20)
    n_norm, n_act = GLUE_ROWS * GLUE_D, GLUE_ROWS * GLUE_F
    norm_bound, norm_by = bound_ms(4.0 * n_norm, 2 * 2 * n_norm + 2 * GLUE_D)
    act_bound, act_by = bound_ms(6.0 * n_act, (4 + 4 + 2) * n_act)
    rows = [dict(name="rms_norm", source="csrc/glue.cu ctdb_rms_norm_kernel",
                 replaces="none (XLA fused the norm on the TPU)", max_abs_err=err,
                 ms=norm["kernel"], plain_ms=norm["plain"], library_ms=norm["library"],
                 bound_ms=norm_bound, bound_by=norm_by, bound_share=norm_bound / norm["kernel"]),
            dict(name="swiglu_act", source="csrc/glue.cu ctdb_swiglu_act_kernel",
                 replaces="none (XLA fused silu(gate) * up on the TPU)", max_abs_err=0.0,
                 ms=act["kernel"], plain_ms=act["plain"], library_ms=None,
                 bound_ms=act_bound, bound_by=act_by, bound_share=act_bound / act["kernel"])]
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), {r['bound_share']:.4f} of "
              f"its bound", flush=True)
    del xs, gate, up
    for shape in GLUE_OTHER_ROWS:
        x = (torch.randn(shape, generator=g, device=dev) * 3).to(torch.bfloat16)
        s = (1 + 0.5 * torch.randn(shape[-1], generator=g, device=dev)).to(torch.bfloat16)
        rms_norm_check(glue, x, s)
    del x, s
    gc.collect()
    torch.cuda.empty_cache()
    return rows


SDAR_B, SDAR_BL, SDAR_H, SDAR_KV, SDAR_DH = 32, 4, 32, 4, 128
SDAR_P, SDAR_S, SDAR_PAD = 576, 832, 320


def sdar_rows(dev, g):
    """Left padding of 0 .. SDAR_PAD a row: (mask [B, P] int32, first real
    key [B] int32)."""
    pads = torch.randint(0, SDAR_PAD + 1, (SDAR_B,), generator=g, device=dev)
    mask = (torch.arange(SDAR_P, device=dev)[None] >= pads[:, None]).to(torch.int32)
    return mask, pads.to(torch.int32)


def sdar_grouped_check(dev, g) -> dict:
    """K1 and K2 at sdar30b-eval's cached pass: a block of 4 rows a request
    for 32 requests routed by ``router_probs`` over one layer of the
    published expert stacks (128 experts of D 2048, F 768, top-8: 1024
    slots, about 8 rows an expert), against their plain versions with and
    without ``tile_valid``, then timed (:func:`grouped_pair_timing`).
    Returns {kernel: its row}."""
    from types import SimpleNamespace

    from ct_diffusionmodelbench_tpu_torch.models import get_config
    from ct_diffusionmodelbench_tpu_torch.models.moe import router_probs

    cfg = get_config("sdar-30b-a3b")
    D, E, Fm = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size

    def weight(*shape):
        w = torch.randn(shape, generator=g, device=dev) * shape[-2] ** -0.5
        return w.to(torch.bfloat16)

    blocks = {"router": weight(1, D, E), "we_gate": weight(1, E, D, Fm),
              "we_up": weight(1, E, D, Fm), "we_down": weight(1, E, Fm, D)}
    x = torch.randn((SDAR_B * SDAR_BL, D), generator=g, device=dev).to(torch.bfloat16)
    _, topk_idx, _ = router_probs(x, blocks["router"][0], cfg.num_experts_per_tok,
                                  cfg.norm_topk_prob)
    pair = grouped_pair_check("sdar30b-eval cached pass", cfg, blocks, x, topk_idx, 0)
    rows, _ = grouped_pair_timing(cfg, blocks, pair, 0, dev)
    layout = SimpleNamespace(m=pair.m, m_pad=pair.m_pad, tile_m=pair.tile_m,
                             experts_used=pair.used,
                             valid_tiles=int((pair.valid != 0).sum()))
    del pair, blocks
    gc.collect()
    torch.cuda.empty_cache()
    return {r["name"]: dict({k: r[k] for k in ("max_abs_err", "ms", "no_skip_ms", "plain_ms",
                                               "library_ms", "bound_ms", "bound_by",
                                               "bound_share", "tflops")},
                            **vars(layout)) for r in rows}


def sdar_combine_check(dev, g) -> dict:
    """G3 at sdar30b-eval's cached pass: 128 rows routed by ``router_probs``
    over one layer's router (128 experts, top-8), the layout's padded rows
    bf16 [m_pad 9216, D 2048] as K2 leaves them; bit-equal to the plain
    chain, then timed in turns beside it and its bound (the k rows read
    and the output written), each run queued behind a sleeping kernel.
    Returns G3's row."""
    from ct_diffusionmodelbench_tpu_torch.models import get_config
    from ct_diffusionmodelbench_tpu_torch.models.moe import router_probs
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg

    cfg = get_config("sdar-30b-a3b")
    D, E, k = cfg.hidden_size, cfg.num_experts, cfg.num_experts_per_tok
    n = SDAR_B * SDAR_BL
    x = torch.randn((n, D), generator=g, device=dev).to(torch.bfloat16)
    router = (torch.randn((D, E), generator=g, device=dev) * D ** -0.5).to(torch.bfloat16)
    probs, topk_idx, _ = router_probs(x, router, k, cfg.norm_topk_prob)
    dest, _, _, m_pad = gg.counting_layout(topk_idx, E, gg.layout_tile_m(n * k))
    rows = torch.randn((m_pad, D), generator=g, device=dev).to(torch.bfloat16)
    got = gg.combine(rows, dest, probs, n, k, torch.bfloat16)
    equal = bool(torch.equal(got, gg.combine_plain(rows, dest, probs, n, k, torch.bfloat16)))
    print(f"  moe_combine (G3) N {n}, k {k}, D {D}, m_pad {m_pad}: bit-equal to the plain "
          f"chain {equal}", flush=True)
    if not equal:
        raise AssertionError("moe_combine: kernel disagrees with its plain chain")
    host_us_per_launch({"moe_combine": lambda: gg.combine_cuda(rows, dest, probs, n, k,
                                                               torch.bfloat16)})
    # 50 chains of 18 launches stay inside the sleep's time on the host.
    t = time_turns_queued({
        "kernel": lambda: gg.combine_cuda(rows, dest, probs, n, k, torch.bfloat16),
        "plain": lambda: gg.combine_plain(rows, dest, probs, n, k, torch.bfloat16)},
        iters=50)
    bound, by = bound_ms(2.0 * n * k * D, 2 * n * k * D + 2 * n * D + (8 + 4) * n * k)
    row = dict(name="moe_combine", source="csrc/moe_combine.cu ctdb_moe_combine_kernel",
               replaces="none (XLA fused the reference's k-loop combine on the TPU)",
               max_abs_err=0.0, ms=t["kernel"], plain_ms=t["plain"], library_ms=None,
               bound_ms=bound, bound_by=by, bound_share=bound / t["kernel"], m_pad=m_pad)
    print(f"  moe_combine: {row['ms']:.4f} ms, plain chain {row['plain_ms']:.4f} ms, bound "
          f"{bound:.4f} ms ({by}), {row['bound_share']:.4f} of its bound", flush=True)
    return row


# G4 and G5's shapes: (label, config, tokens, experts held by the rank or
# None for all of them).  sdar30b-eval's cached pass (128 rows: 1024 slots
# over m_pad 9216, tile_m 64) and prefill (32 × 576 rows: 147456 slots over
# m_pad 163840, tile_m 128); a forward of phase 3's llada-moe-7b decode
# (B 8 × S 320 = 2560 rows: 20480 slots, tile_m 64, E 64, the M of phase 2's
# grouped pair), and the same with expert parallelism over two ranks (32
# experts here, the other rank's slots dropped).
ROUTE_SHAPES = (("cached pass", "sdar-30b-a3b", SDAR_B * SDAR_BL, None),
                ("prefill", "sdar-30b-a3b", SDAR_B * SDAR_P, None),
                ("llada_moe", "llada-moe-7b", BATCH * SEQ, None),
                ("llada_moe_ep", "llada-moe-7b", BATCH * SEQ, 32))


def route_check(dev, g) -> list:
    """G4 and G5 at :data:`ROUTE_SHAPES`, routed by a router of the
    config's width: each kernel bit-equal to the chain it replaces in every
    output (G4: softmax, stable sort, slice and renormalisation; G5:
    counting_layout, valid_tiles and gather_rows' real rows, with
    ``drop_foreign`` where the rank holds part of the experts), then timed
    in turns beside it and its bound (bytes: the logits read, the
    probabilities and the top-k written; the indices read, dest written,
    each token's row read once and its k real rows written).  G5 leaves the
    pad rows unwritten; the chain's gather_rows, which writes every row, is
    timed beside it, with the bound that writing every row would have.
    Each run but the prefill's is queued behind a sleeping kernel, as in
    phase 31.  Returns G4's and G5's rows: the cached pass's numbers, and
    each other shape's under its label (G4 at the dropped shape is the
    unsplit one's and is not run again)."""
    from ct_diffusionmodelbench_tpu_torch.models import get_config
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg

    topk = dict(name="moe_topk", source="csrc/moe_route.cu ctdb_moe_topk_kernel",
                replaces="none (XLA fused the router's softmax and lax.top_k on the TPU)",
                max_abs_err=0.0, library_ms=None)
    layout = dict(name="moe_layout", source="csrc/moe_route.cu ctdb_moe_layout_*_kernel",
                  replaces="none (XLA fused the padded layout and its row gather on the TPU)",
                  max_abs_err=0.0, library_ms=None)
    for shape, preset, n, held in ROUTE_SHAPES:
        cfg = get_config(preset)
        D, E, k, norm = (cfg.hidden_size, cfg.num_experts, cfg.num_experts_per_tok,
                         cfg.norm_topk_prob)
        router = (torch.randn((D, E), generator=g, device=dev) * D ** -0.5).to(torch.bfloat16)
        x = torch.randn((n, D), generator=g, device=dev).to(torch.bfloat16)
        logits = torch.matmul(x.float(), router.float())
        want = gg.router_topk_plain(logits, k, norm)
        equal = all(torch.equal(a, b) for a, b in zip(gg.router_topk_cuda(logits, k, norm),
                                                       want))
        idx, m, e, drop = want[1], n * k, E, held is not None
        if drop:
            e = held
            idx = torch.where(idx < e, idx, torch.full_like(idx, e))
        tile_m = gg.layout_tile_m(m)
        xs, dest, tile_expert, sizes, valid = gg.routed_layout_cuda(x, idx, e, tile_m, drop)
        w_xs, w_dest, w_te, w_sizes, w_valid = gg.routed_layout_plain(x, idx, e, tile_m, drop)
        m_pad = w_xs.shape[0]
        same = xs.shape == w_xs.shape and torch.equal(xs[dest], w_xs[dest]) and all(
            torch.equal(a, b) for a, b in ((dest, w_dest), (tile_expert, w_te),
                                           (sizes, w_sizes), (valid, w_valid)))
        dropped = int((idx == e).sum()) if drop else 0
        print(f"  {shape}: moe_topk (G4) N {n}, E {E}, k {k}: bit-equal to the chain "
              f"{equal}; moe_layout (G5) M {m}, E {e}{', drop_foreign' if drop else ''} "
              f"({dropped} slots dropped), tile_m {tile_m}, m_pad {m_pad}: indices and real "
              f"rows equal to the chain {same}", flush=True)
        if not (equal and same):
            raise AssertionError(f"moe_topk / moe_layout ({shape}): a kernel disagrees "
                                 "with its chain")
        del xs, w_xs

        fns = {"layout": lambda: gg.routed_layout_cuda(x, idx, e, tile_m, drop),
               "layout_plain": lambda: gg.routed_layout_plain(x, idx, e, tile_m, drop),
               "gather_rows": lambda: gg.gather_rows(x, w_dest, k, m_pad)}
        if not drop:
            fns.update(topk=lambda: gg.router_topk_cuda(logits, k, norm),
                       topk_plain=lambda: gg.router_topk_plain(logits, k, norm))
        if shape == "cached pass":
            host_us_per_launch({"moe_topk": fns["topk"], "moe_layout": fns["layout"]})
        if shape == "prefill":
            t = time_turns(fns, iters=5)
        else:
            # 20 chains of some thirty launches stay inside the sleep's time.
            t = time_turns_queued(fns, iters=20)
        l_bound, l_by = bound_ms(0.0, 2 * 8 * m + 2 * n * D + 2 * m * D)
        all_rows, _ = bound_ms(0.0, 2 * 8 * m + 2 * n * D + 2 * m_pad * D)
        got = {"layout": dict(ms=t["layout"], plain_ms=t["layout_plain"], bound_ms=l_bound,
                              bound_by=l_by, bound_share=l_bound / t["layout"], m=m,
                              m_pad=m_pad, tile_m=tile_m,
                              pad_rows=dict(written=False, gather_rows_ms=t["gather_rows"],
                                            all_rows_bound_ms=all_rows))}
        line = (f"  {shape}: moe_layout {t['layout']:.4f} ms, chain "
                f"{t['layout_plain']:.4f} ms (its gather_rows alone, every one of the "
                f"{m_pad} rows: {t['gather_rows']:.4f} ms), bound {l_bound:.4f} ms ({l_by}; "
                f"{all_rows:.4f} with every row written)")
        if not drop:
            t_bound, t_by = bound_ms(0.0, 2 * 4 * n * E + (4 + 8) * n * k)
            got["topk"] = dict(ms=t["topk"], plain_ms=t["topk_plain"], bound_ms=t_bound,
                               bound_by=t_by, bound_share=t_bound / t["topk"], n=n)
            line = (f"  {shape}: moe_topk {t['topk']:.4f} ms, chain {t['topk_plain']:.4f} ms, "
                    f"bound {t_bound:.4f} ms ({t_by});" + line[len(shape) + 3:])
        print(line, flush=True)
        for row, name in ((topk, "topk"), (layout, "layout")):
            if name not in got:
                continue
            if shape == "cached pass":
                row.update(got[name])
            else:
                row[shape] = got[name]
        del x, logits, want, idx, w_dest, fns
        gc.collect()
        torch.cuda.empty_cache()
    return [topk, layout]


def sdar_phase(dev):
    """Phase 32: K12 and the block-causal flash mode at sdar30b-eval's
    shapes against their plain versions, timed, K1 and K2 at its cached
    pass (:func:`sdar_grouped_check`), G3 there
    (:func:`sdar_combine_check`), G4 and G5 there and at its prefill
    (:func:`sdar_route_check`), and an sdar-tiny decode's exact
    launches.  Returns (K12's, the flash mode's, G3's, G4's and G5's rows,
    {K1 / K2: their row at the cached pass})."""
    import numpy as np

    from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner
    from ct_diffusionmodelbench_tpu_torch.models.layers import apply_rope, rope_angles
    from ct_diffusionmodelbench_tpu_torch.models.transformer import token_positions
    from ct_diffusionmodelbench_tpu_torch.ops import cache_attention as ca
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import reset_launch_counts

    g = torch.Generator(device=dev).manual_seed(32)
    B, bl, H, KV, Dh = SDAR_B, SDAR_BL, SDAR_H, SDAR_KV, SDAR_DH

    def bf16(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    mask, first = sdar_rows(dev, g)
    rows = []
    k = bf16(B, SDAR_S, KV, Dh)
    v = bf16(B, SDAR_S, KV, Dh)
    q = bf16(B, bl, H, Dh)
    for n_keys in (SDAR_P + bl, SDAR_S):
        end = torch.tensor([n_keys], dtype=torch.int32, device=dev)
        err = compare(f"cache_attention, {n_keys} keys",
                      ca.cache_attention(q, k, v, first, end),
                      ca.cache_attention_plain(q, k, v, first, end), **FLASH_TOL)
        keys = int((n_keys - first).sum())
        flops = 4.0 * bl * keys * H * Dh
        bound, by = bound_ms(flops, 2 * 2 * keys * KV * Dh + 2 * 2 * B * bl * H * Dh)
        seen = (torch.arange(n_keys, device=dev)[None] >= first[:, None].long())
        qt, kt, vt = q.transpose(1, 2), k[:, :n_keys].transpose(1, 2), v[:, :n_keys].transpose(1, 2)
        sdpa_mask = seen[:, None, None, :]
        t = time_turns({
            "kernel": lambda: ca.cache_attention_cuda(q, k, v, first, end),
            "plain": lambda: ca.cache_attention_plain(q, k, v, first, end),
            "library": lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=True)}, iters=20)
        rows.append(dict(name="cache_attention", keys=n_keys, max_abs_err=err, ms=t["kernel"],
                         plain_ms=t["plain"], library_ms=t["library"], bound_ms=bound,
                         bound_by=by, bound_share=bound / t["kernel"]))
    cos, sin = rope_angles(token_positions(mask, B, SDAR_P, dev), Dh, 1e6)
    qp = apply_rope(bf16(B, SDAR_P, H, Dh), cos, sin)
    kp = apply_rope(bf16(B, SDAR_P, KV, Dh), cos, sin)
    vp = bf16(B, SDAR_P, KV, Dh)
    real = mask.bool()
    got = fa.flash_attention_cuda(qp, kp, vp, mask=mask, block_len=bl)
    want = fa.flash_attention_plain(qp, kp, vp, mask=mask, block_len=bl)
    err = compare("flash_attention_fwd_block_causal, real rows", got[real], want[real],
                  **FLASH_TOL)
    if not torch.isfinite(got).all():
        raise AssertionError("block-causal flash: a non-finite output")
    vis = fa.block_visible(SDAR_P, SDAR_P, bl, dev)
    pairs = int((real[:, :, None] & real[:, None, :] & vis[None]).sum())
    flops = 4.0 * pairs * H * Dh
    nreal = int(real.sum())
    bound, by = bound_ms(flops, 2 * nreal * (2 * H + 2 * KV) * Dh)
    sdpa_mask = (vis[None] & real[:, None, :])[:, None] | torch.eye(
        SDAR_P, dtype=torch.bool, device=dev)[None, None]
    qt, kt, vt = qp.transpose(1, 2), kp.transpose(1, 2), vp.transpose(1, 2)
    t = time_turns({
        "kernel": lambda: fa.flash_attention_cuda(qp, kp, vp, mask=mask, block_len=bl),
        "plain": lambda: fa.flash_attention_plain(qp, kp, vp, mask=mask, block_len=bl),
        "library": lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=True)}, iters=5)
    rows.append(dict(name="flash_attention_fwd_block_causal", max_abs_err=err,
                     ms=t["kernel"], plain_ms=t["plain"], library_ms=t["library"],
                     bound_ms=bound, bound_by=by, bound_share=bound / t["kernel"]))
    for r in rows:
        print(f"  {r['name']}{' ' + str(r['keys']) + ' keys' if 'keys' in r else ''}: "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, SDPA {r['library_ms']:.4f}, "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']}), {r['bound_share']:.4f} of "
              f"its bound", flush=True)
    del k, v, q, qp, kp, vp, got, want
    grouped = sdar_grouped_check(dev, g)
    rows.append(sdar_combine_check(dev, g))
    rows += route_check(dev, g)

    runner = ModelRunner.random_init("sdar-tiny", seed=3, device=dev)
    cfg = runner.cfg
    ids = torch.randint(10, 400, (2, 16), generator=g, device=dev).cpu().numpy()
    tmask = np.ones((2, 16), np.int32)
    tmask[0, :5] = 0
    reset_launch_counts()
    out = runner.generate_ids(ids, attn_mask=tmask, gen_length=16, steps=16, block_length=4)
    steps, passes = 16, 16 + 4            # a step runs the final norm, a commit not
    blocks = cfg.num_layers * (1 + passes)
    want = expected_launches(glue_launches(cfg, blocks, steps),
                             cache_attention=cfg.num_layers * passes,
                             flash_attention_fwd_block_causal=cfg.num_layers,
                             grouped_gateup=blocks, grouped_down=blocks)
    seen = launch_counts()
    print(f"  sdar-tiny decode (2 rows, 4 blocks of 4 steps): launches "
          f"{launch_counts(nonzero=True)}", flush=True)
    if seen != want:
        raise AssertionError(f"sdar-tiny launches {seen}, expected {want}")
    if (out[:, 16:] == cfg.mask_token_id).any():
        raise AssertionError("sdar-tiny: a mask id is left")
    for r in rows:
        r["launches"] = seen[r["name"]]
    for name, r in grouped.items():
        r["launches"] = seen[name]
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    return rows, grouped


# kanana30b-ctx32k's shapes: B 4 rows padded to P 32512 (S 32768 with the
# 256 generated), a block of 4 at 32 heads; each row's left padding for
# prompts of 16384, 20448, 24480 and 32512 tokens, one a stratum.
KANANA_B, KANANA_BL, KANANA_H = 4, 4, 32
KANANA_P, KANANA_S = 32512, 32768
KANANA_FIRST = (16128, 12064, 8032, 0)


def sdpa_ms(fn):
    """SDPA's time as a yardstick, or None where no backend of this torch
    takes the shapes (the port never calls it)."""
    try:
        return time_turns({"library": fn}, iters=3)["library"]
    except RuntimeError as e:
        print(f"  SDPA not timed: {str(e).splitlines()[0]}", flush=True)
        return None


def mla_phase(dev):
    """Phase 33: K13, the latent prefill kernel and G4's sigmoid mode at
    kanana30b-ctx32k's shapes against their plain versions, timed, and a
    two-layer kanana decode's exact launches.  Returns their rows."""
    import numpy as np

    from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner
    from ct_diffusionmodelbench_tpu_torch.io.tokenizer import Tokenizer
    from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params
    from ct_diffusionmodelbench_tpu_torch.models.mla import prefill_pairs
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg
    from ct_diffusionmodelbench_tpu_torch.ops import mla_attention as ma
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import reset_launch_counts

    g = torch.Generator(device=dev).manual_seed(33)
    B, bl, H = KANANA_B, KANANA_BL, KANANA_H
    scale = 192 ** -0.5

    def bf16(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    cache_row = dict(name="mla_cache_attention",
                     source="csrc/mla_attention.cu ctdb_mla_cache_attention (K13)",
                     replaces="none (the JAX package has no latent attention)")
    first = torch.tensor(KANANA_FIRST, dtype=torch.int32, device=dev)
    q = bf16(B, bl, H, 576)
    cache = bf16(B, KANANA_S, 576)
    for n_keys in (KANANA_P + bl, KANANA_S):
        end = torch.tensor([n_keys], dtype=torch.int32, device=dev)
        err = compare(f"mla_cache_attention, {n_keys} keys",
                      ma.mla_cache_attention_cuda(q, cache, first, end, 512, scale),
                      ma.mla_cache_attention_plain(q, cache, first, end, 512, scale),
                      **FLASH_TOL)
        keys = int((n_keys - first).sum())
        bound, by = bound_ms(2.0 * bl * keys * H * (576 + 512),
                             2 * (keys * 576 + B * bl * H * (576 + 512)))
        t = time_turns({
            "kernel": lambda: ma.mla_cache_attention_cuda(q, cache, first, end, 512, scale),
            "plain": lambda: ma.mla_cache_attention_plain(q, cache, first, end, 512, scale)},
            iters=10)
        seen = (torch.arange(n_keys, device=dev)[None] >= first[:, None].long())
        qt = q.reshape(B, 1, bl * H, 576)
        kt = cache[:, None, :n_keys]
        vt = kt[..., :512]
        lib = sdpa_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=seen[:, None, None, :], scale=scale))
        row = dict(keys=n_keys, max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
                   library_ms=lib, bound_ms=bound, bound_by=by, bound_share=bound / t["kernel"])
        if n_keys == KANANA_S:
            cache_row["last_commit"] = row
        else:
            cache_row.update(row)
        print(f"  mla_cache_attention {n_keys} keys: {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f}, SDPA {lib}, bound {bound:.4f} ({by}), "
              f"{bound / t['kernel']:.4f} of its bound", flush=True)
    del q, cache

    pre_row = dict(name="mla_prefill_attention",
                   source="csrc/mla_attention.cu ctdb_mla_prefill_attention (K8's block-causal "
                          "design at 192 / 128)",
                   replaces="none (the JAX package has no latent attention)")
    S, start = 4096, torch.tensor([1000], dtype=torch.int32, device=dev)
    qs, ks, vs = bf16(1, S, H, 192), bf16(1, S, H, 192), bf16(1, S, H, 128)
    got = ma.mla_prefill_attention_cuda(qs, ks, vs, start, bl, scale)
    want = ma.mla_prefill_attention_plain(qs, ks, vs, start, bl, scale)
    err = compare("mla_prefill_attention, a 4096-position row", got, want, **FLASH_TOL)
    t = time_turns({
        "kernel": lambda: ma.mla_prefill_attention_cuda(qs, ks, vs, start, bl, scale),
        "plain": lambda: ma.mla_prefill_attention_plain(qs, ks, vs, start, bl, scale)},
        iters=3)
    pre_row.update(max_abs_err=err, check_shape=dict(S=S, first=1000, ms=t["kernel"],
                                                     plain_ms=t["plain"]))
    del qs, ks, vs, got, want
    P, real = KANANA_P, KANANA_P - KANANA_FIRST[2]
    start = torch.tensor([KANANA_FIRST[2]], dtype=torch.int32, device=dev)
    qs, ks, vs = bf16(1, P, H, 192), bf16(1, P, H, 192), bf16(1, P, H, 128)
    pairs = prefill_pairs([real], P, bl)
    bound, by = bound_ms(2.0 * pairs * H * 320, 2 * real * H * 640)
    t = time_turns({"kernel": lambda: ma.mla_prefill_attention_cuda(qs, ks, vs, start, bl,
                                                                     scale)}, iters=3)
    pos = torch.arange(P, device=dev)
    vis = ((pos[None, :] < ((pos // bl + 1) * bl)[:, None]) & (pos[None, :] >= KANANA_FIRST[2])
           ) | torch.eye(P, dtype=torch.bool, device=dev)
    qt, kt, vt = qs.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2)
    lib = sdpa_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=vis[None, None], scale=scale))
    del vis
    pre_row.update(ms=t["kernel"], plain_ms=None, library_ms=lib, bound_ms=bound, bound_by=by,
                   bound_share=bound / t["kernel"], prefill=dict(P=P, real=real, pairs=pairs))
    print(f"  mla_prefill_attention, a row of {P} ({real} real): {t['kernel']:.4f} ms, SDPA "
          f"{lib}, bound {bound:.4f} ({by}), {bound / t['kernel']:.4f} of its bound; at S "
          f"{S}: {pre_row['check_shape']['ms']:.4f} ms, plain "
          f"{pre_row['check_shape']['plain_ms']:.4f}", flush=True)
    del qs, ks, vs, qt, kt, vt
    gc.collect()
    torch.cuda.empty_cache()

    topk_row = dict(name="moe_topk_sigmoid",
                    source="csrc/moe_route.cu ctdb_moe_topk_sigmoid_kernel (G4's sigmoid mode)",
                    replaces="none (DeepSeek-V3's router; the JAX package has none)",
                    max_abs_err=0.0, library_ms=None)
    cfg = get_config("kanana-2-30b-a3b")
    D, E, k = cfg.hidden_size, cfg.num_experts, cfg.num_experts_per_tok
    for shape, n in (("cached pass", B * bl), ("prefill", P)):
        router = (torch.randn((D, E), generator=g, device=dev) * D ** -0.5).to(torch.bfloat16)
        logits = torch.matmul(torch.randn((n, D), generator=g, device=dev).float(),
                              router.float())
        bias = 0.02 * torch.randn((E,), generator=g, device=dev)
        args = (logits, k, True, True, bias, cfg.routed_scaling_factor)
        equal = all(torch.equal(a, b) for a, b in zip(gg.router_topk_cuda(*args),
                                                       gg.router_topk_plain(*args)))
        print(f"  {shape}: moe_topk_sigmoid N {n}, E {E}, k {k}: bit-equal to the chain "
              f"{equal}", flush=True)
        if not equal:
            raise AssertionError(f"moe_topk_sigmoid ({shape}): the kernel disagrees with "
                                 "its chain")
        t = time_turns_queued({"kernel": lambda: gg.router_topk_cuda(*args),
                               "plain": lambda: gg.router_topk_plain(*args)}, iters=20)
        bound, by = bound_ms(0.0, 2 * 4 * n * E + 4 * E + (4 + 8) * n * k)
        got = dict(ms=t["kernel"], plain_ms=t["plain"], bound_ms=bound, bound_by=by,
                   bound_share=bound / t["kernel"], n=n)
        if shape == "cached pass":
            topk_row.update(got)
        else:
            topk_row[shape] = got
        print(f"  {shape}: moe_topk_sigmoid {t['kernel']:.4f} ms, chain {t['plain']:.4f} ms, "
              f"bound {bound:.4f} ms ({by})", flush=True)

    cfg = get_config("kanana-2-30b-a3b", num_layers=2)
    params = init_params(cfg, seed=3, device=dev)
    params["blocks"]["e_bias"].normal_(0.0, 0.02, generator=g)
    runner = ModelRunner(cfg, params, Tokenizer.byte_fallback(
        vocab_size=cfg.vocab_size, eos_token_id=cfg.eos_token_id), device=dev)
    ids = torch.randint(10, 128000, (2, 256), generator=g, device=dev).cpu().numpy()
    tmask = np.ones((2, 256), np.int32)
    tmask[0, :61] = 0
    reset_launch_counts()
    out = runner.generate_ids(ids, attn_mask=tmask, gen_length=16, steps=16, block_length=bl)
    steps, passes = 16, 16 + 4            # a step runs the final norm, a commit not
    L, moe = cfg.num_layers, cfg.num_layers - cfg.dense_layers
    blocks, moe_blocks = L * (1 + passes), moe * (1 + passes)
    want = expected_launches(
        {"rms_norm": 3 * blocks + steps, "swiglu_act": blocks},
        mla_cache_attention=L * passes, mla_prefill_attention=L,
        moe_topk_sigmoid=moe_blocks, moe_layout=moe_blocks, moe_combine=moe_blocks,
        grouped_gateup=moe_blocks, grouped_down=moe_blocks)
    seen = launch_counts()
    print(f"  kanana 2-layer decode (2 rows, 4 blocks of 4 steps): launches "
          f"{launch_counts(nonzero=True)}", flush=True)
    if seen != want:
        raise AssertionError(f"kanana 2-layer launches {seen}, expected {want}")
    if (out[:, 256:] == cfg.mask_token_id).any():
        raise AssertionError("kanana 2-layer decode: a mask id is left")
    rows = [cache_row, pre_row, topk_row]
    for r in rows:
        r["launches"] = seen[r["name"]]
    del runner, params
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if importlib.util.find_spec("ct_diffusionmodelbench_tpu_torch") is None:
        print("chip_smoke: the package ct_diffusionmodelbench_tpu_torch is not beside "
              "this script; run it from the repository's root", file=sys.stderr)
        return 2

    from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner
    from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params
    from ct_diffusionmodelbench_tpu_torch.ops import (
        cache_attention, flash_attention, flash_attention_bwd, glue, grouped_gemm_cuda,
        mla_attention)
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import KERNELS, build_all

    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    libs = [grouped_gemm_cuda.LIBRARY, grouped_gemm_cuda.LIBRARY_Q,
            grouped_gemm_cuda.LIBRARY_FUSED, flash_attention.LIBRARY,
            flash_attention.LIBRARY_DIRECT, flash_attention_bwd.LIBRARY, glue.LIBRARY,
            cache_attention.LIBRARY, grouped_gemm_cuda.LIBRARY_COMBINE,
            grouped_gemm_cuda.LIBRARY_ROUTE, mla_attention.LIBRARY]
    build_s = build_all(libs)
    print(f"kernel build: {build_s:.2f} s", flush=True)
    ptxas_report(libs)

    cfg = get_config("llada-moe-7b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params["blocks"].values()) + sum(
        t.numel() for k, t in params.items() if k != "blocks")
    print(f"init llada-moe-7b: {n_params / 1e9:.3f} G params, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    print("kernels:", flush=True)
    results = kernel_phase(cfg, params, dev)
    print("slice:", flush=True)
    sl = slice_phase(cfg, params, dev)
    print("reduced depth:", flush=True)
    depth_phase(cfg, params, sl["out"], dev)
    for r in results:
        r["launches"] = sl["launches"][r["name"]]
    glue_seen = {n: dict(launches=sl["launches"][n]) for n in GLUE_KERNELS}
    exact = dict(prompt=sl["prompt"], out=sl["out"], tokens_per_s=sl["tokens_per_s"])
    del sl
    with switches_on("CTDB_GROUPED_FUSED", "CTDB_FLASH_DIRECT"):
        print("single-prompt kernels:", flush=True)
        sp_results, runner = single_prompt_kernel_phase(cfg, params, dev)
        print("chat slice:", flush=True)
        chat = chat_slice_phase(runner, dev)
        print("chat depth check:", flush=True)
        chat_depth_phase(cfg, params, chat["ids"], dev)
    eval_runner = chat_runner(cfg, params, dev)
    print("eval sweep:", flush=True)
    eval_sweep_phase(eval_runner)
    print("MiniF2F:", flush=True)
    minif2f_phase(eval_runner)
    print("block cache:", flush=True)
    bc = block_cache_phase(cfg, params, dev, exact)
    for r in results:
        r["block_cache_launches"] = bc["rows"]["a"]["launches"][r["name"]]
        r["threshold_launches"] = bc["rows"]["b"]["launches"][r["name"]]
        if r["name"] == "flash_attention_fwd":
            r["refresh_no_rope"] = bc["refresh_no_rope"]
        else:
            r["cached_step"] = bc["cached_" + r["name"].split("_")[1]]
    for n, r in glue_seen.items():
        r["block_cache_launches"] = bc["rows"]["a"]["launches"][n]
        r["threshold_launches"] = bc["rows"]["b"]["launches"][n]
    for r in sp_results:
        r["launches"] = chat["launches"][r["name"]]
    results += sp_results
    del params, runner, chat, eval_runner, exact
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    runner = ModelRunner.random_init("llada-moe-7b", seed=0, quant="int8")
    torch.cuda.synchronize()
    print(f"init int8 llada-moe-7b (ModelRunner.random_init, quant='int8'): "
          f"{tree_bytes(runner.params) / 1e9:.3f} GB of weights, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    print("int8 kernels:", flush=True)
    q_results = int8_kernel_phase(runner, dev)
    print("int8 slice:", flush=True)
    isl = int8_slice_phase(runner, dev)
    print("int8 quantization check:", flush=True)
    quant_phase(runner.cfg, runner.params, isl["out"], dev)
    print("int8 block cache:", flush=True)
    ibc = int8_block_cache_phase(runner, dev, isl)
    for r in q_results:
        r["launches"] = isl["launches"][r["name"]]
        r["block_cache_launches"] = ibc["row"]["launches"][r["name"]]
        r["cached_step"] = ibc["cached_" + r["name"].split("_")[1]]
    results += q_results
    del runner, isl
    gc.collect()
    torch.cuda.empty_cache()

    with switches_on("CTDB_FLASH_DIRECT"):
        print("Dream slice:", flush=True)
        dream = dream_slice_phase(dev)
    next(r for r in results if r["name"] == "flash_attention_direct")[
        "dream_launches"] = dream["launches"]["flash_attention_direct"]
    for n, r in glue_seen.items():
        r["dream_launches"] = dream["launches"][n]
    del dream
    gc.collect()
    torch.cuda.empty_cache()

    print("training kernels:", flush=True)
    train_results, fwd_train = train_kernel_phase(dev)
    print("training slice:", flush=True)
    tr = train_slice_phase(dev)
    print("training gradients:", flush=True)
    train_depth_phase(tr["cfg"], tr["params"], dev)
    for r in train_results:
        r["launches"] = tr["launches"][r["name"]]
    fwd_train["launches"] = tr["launches"]["flash_attention_fwd"]
    next(r for r in results if r["name"] == "flash_attention_fwd")[
        "training_shape"] = fwd_train
    results += train_results
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    from ct_diffusionmodelbench_tpu_torch.cli.train import load_model
    args = moe_train_args(tempfile.mkdtemp(prefix="ctdb-moe-train-"))
    t0 = time.perf_counter()
    moe_cfg, moe_params, tokenizer = load_model(args)
    torch.cuda.synchronize()
    print(f"init llada-moe-7b for training (cli/train.py's load_model, --preset): "
          f"{moe_cfg.num_layers} layers, {torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    print("MoE training kernels:", flush=True)
    moe_checks = moe_train_kernel_phase(moe_cfg, moe_params, dev)
    print("MoE training slice:", flush=True)
    moe_slice = moe_train_slice_phase(args, moe_cfg, moe_params, tokenizer, dev)
    print("MoE training checks:", flush=True)
    moe_depth = moe_train_depth_phase(moe_cfg, moe_params, dev)
    for r in results:
        if r["name"] in moe_checks:
            r["moe_training"] = dict(moe_checks[r["name"]], launches_per_step=
                                     moe_slice["launches_per_step"][r["name"]])
    print("MoE training summary: " + json.dumps(dict(
        moe_slice, grouped_backward=moe_checks["grouped_backward"], **moe_depth)),
        flush=True)
    del moe_params, tokenizer
    gc.collect()
    torch.cuda.empty_cache()

    print("TP/DP serving:", flush=True)
    serve = serving_parallel_phase()
    print("dp x tp training:", flush=True)
    train = training_parallel_phase()
    t0 = time.perf_counter()
    print("sequence-parallel training:", flush=True)
    sp = sp_training_phase()
    print(f"  phase 24: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    print("pipeline training:", flush=True)
    pp = pp_training_phase()
    print(f"  phase 25: {time.perf_counter() - t0:.1f} s", flush=True)
    for r in results:
        name = r["name"]
        if name in SERVING_KERNELS:
            x = serve["res"][0]
            r["sharded"] = dict(
                mesh=f"dp {PAR_DP} x tp {PAR_TP}, {par_layout()[0]}",
                launches_per_rank=[y["launches"][name] for y in serve["res"]],
                max_abs_err=max(y["errors"][name] for y in serve["res"]),
                shape=x["shapes"], **x["times"][name])
        if name in SERVING_KERNELS + BWD_KERNELS:
            x = train["res"][0]
            r["sharded_training"] = dict(
                launches_per_rank=[y["launches"][name] for y in train["res"]],
                max_abs_err=x["times"]["err_bwd" if name in BWD_KERNELS else "err_fwd"]
                if name.startswith("flash") else None,
                **(x["times"].get(name) or {}))
        if name in SERVING_KERNELS + BWD_KERNELS:
            x = sp["res"][0]
            chunk_err = x["err_chunk"][1 if name in BWD_KERNELS else 0] \
                if name.startswith("flash") else None
            r["sequence_parallel"] = dict(
                mesh=f"dp {SP_DP} x sp {SP_SP} x tp {SP_TP}, {par_layout()[0]}",
                launches_per_rank=[y["launches"][name] for y in sp["res"]],
                chunk_shape=x["chunk"], max_abs_err=chunk_err,
                **(x["times"].get(name) or {}))
            r["pipeline"] = dict(
                launches_per_rank_pp4=[y["launches"][name] for y in pp["res"]],
                launches_per_rank_pp2_tp2=[y["launches"][name] for y in pp["res_b"]])
    for number, label, phase in ((26, "busy time", profiling_phase),
                                 (27, "headline bench", bench_phase),
                                 (28, "entry forward", entry_phase),
                                 (29, "dry run", dryrun_phase),
                                 (30, "sweep", sweep_phase)):
        t0 = time.perf_counter()
        print(f"{label}:", flush=True)
        phase(dev)
        print(f"  phase {number}: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    print("glue kernels:", flush=True)
    results += [dict(r, **glue_seen[r["name"]]) for r in glue_phase(dev)]
    print(f"  phase 31: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    print("SDAR kernels:", flush=True)
    sdar, sdar_grouped = sdar_phase(dev)
    for r in results:
        if r["name"] in sdar_grouped:
            r["sdar"] = sdar_grouped[r["name"]]
    results += sdar
    print(f"  phase 32: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    print("latent attention kernels:", flush=True)
    results += mla_phase(dev)
    print(f"  phase 33: {time.perf_counter() - t0:.1f} s", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "tflops", "bound_share", "sdpa_backward_ms", "training_shape", "pair_ms",
            "k8_ms", "dream_geometry", "dream_launches", "no_skip_ms", "valid_tiles",
            "block_cache_launches", "threshold_launches", "refresh_no_rope", "cached_step",
            "moe_training", "sharded", "sharded_training", "sequence_parallel",
            "pipeline", "keys", "sdar", "prefill", "llada_moe", "llada_moe_ep", "n", "m",
            "m_pad", "tile_m", "pad_rows")
    print("first designs' ms (constants from PERF.md, not measured in this run): "
          + json.dumps(FIRST_DESIGN_MS), flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in results]}), flush=True)
    missing = set(KERNELS) - {r["name"] for r in results}
    if missing:
        raise AssertionError(f"kernels not checked: {sorted(missing)}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
