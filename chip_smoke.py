#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. build all ten kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and print the build time;
2. call each support-count kernel's wrapper at the shapes the mining main
   path gives it (one transaction tile × the k=2 candidate batch, and the
   later rounds' 256 and 128 candidates) and at a few ragged shapes (rows
   of 4 words for the packed kernel among them), and require exact
   equality with its plain PyTorch version; time an empty launch
   (``torch.cuda._sleep(0)``, the launch floor printed beside every kernel
   under 0.01 ms); time the kernel, the plain version and, for the int8
   kernel, ``torch._int_mm`` plus the compare-and-sum (a yardstick the
   port never calls), both kernels at each round's shape with the launch
   geometry each took, and the packed kernel's bound at the binary tensor
   cores' rate (``B1_OPS``) and at the CUDA cores' popcounts; then
   hold the intersect kernel (the Eclat plane's) exactly against its
   plain version on random words, bit 31 included, at the shapes the
   vertical plane gives it (a dense-corpus tile, a sparse-corpus k=1 tile,
   a whole k=2 slab) and ragged ones, and time it at the first three with
   the launch geometry it took;
3. mine a corpus at the scale of IBM Quest T10I4D100K (100,000
   transactions over 1,000 items, min_support 1%) three times — through
   the ``packed`` kernel, the ``mxu`` kernel and the plain ``ref`` data
   plane — and require equal supports and rules, launches of each kernel
   on its path, one device-to-host read per counting round, and supports
   that numpy recounts exactly; print each support-count kernel's time
   over its mine (its launches at each round's shape times that shape's
   time, an estimate) beside the mine's wall;
4. mine the same corpus through ``make_miner`` with ``algorithm="eclat"``
   on the intersect kernel and on the plain ``ref`` plane, and with
   ``algorithm="auto"`` (priced by the default, autotune-fed model), and
   require the apriori mine's supports and
   rules, one read per counting round and intersect launches on the
   kernel paths only; then mine a sparse corpus at the scale of the FIMI
   ``retail`` dataset (88,162 baskets over 16,470 items) as a
   ``SparseSlab`` through Eclat on both planes, never densified, with
   supports that numpy recounts from the CSR slab; print every wall and
   the host functions with the most own time in one more (profiled) dense
   Eclat mine; then, on the dense corpus and on the reference's B11
   corpus (8,192 x 96, seed 3, min_support 0.02, 16 tiles), time the
   density scan (beside an int64-accumulating sum of the same bitmap)
   and measure the router two ways: as the reference's B11 does (each
   miner built by ``make_miner`` once and warmed with one run, then
   interleaved timed runs a side: 11 on the dense corpus, 41 on B11's,
   enough to resolve 10%) and, stricter, ``make_miner`` plus a cold run
   three times a side, in turns; print every wall, the columnize times,
   the collector's pauses in each mine and both ratios of auto's median
   wall to the best explicit one, B11's with a seeded bootstrap's 90%
   interval and its value over the first three reps (B11's gate is 1.1;
   printed, not enforced);
5. compile the mined rules into a ``RuleIndex`` and hold each rule-match
   kernel exactly against its plain version at the shapes serving gives
   it (that index against batches of 8 and 64 corpus baskets), at ragged
   batches, rule counts and item axes, and at a wider index of 16,384
   random rules; time both at the 64- and 8-basket shapes and the wide
   one, beside the plain versions, the launch floor and, for the int8
   kernel, ``torch._int_mm`` plus the compare-and-weight (at 16 baskets or
   fewer with the rules as ``_int_mm``'s first operand, which must have
   more than 16 rows), printing each kernel's launch geometry;
6. serve 4,096 corpus baskets through ``RecommendationEngine.serve`` three
   times — the ``packed`` kernel, the ``mxu`` kernel and the plain ``ref``
   scores — and require equal recommendations and reports, launches of
   each kernel on its own path only, and the brute-force oracle's answer
   for the first 512 baskets; print each serve's wall, the part spent in
   scoring calls and in garbage-collector pauses, and the host functions
   with the most own time in one more (profiled) serve per kernel path;
7. mine the dense corpus out of core, in 4 partitions of 25,000
   transactions on disk, through ``make_miner(son=SONConfig(...))`` three
   times — Apriori on the ``packed`` kernel, Eclat (the intersect kernel
   in pass 1, the packed one in pass 2's re-count) and Apriori on the
   ``mxu`` kernel — and require phase 3's supports and rules, launches of
   each path's kernels and no other, and one device-to-host read per
   re-count chunk; kill a mine at the first re-count boundary and require
   its resume to give the same answer; save the rule index, load it back
   and require phase 5's arrays and phase 6's recommendations from it;
   print each wall, the ledger's host time by pass, the spill, load and
   checkpoint times and bytes, and the card's name and power limit;
8. the LM serving path: hold the flash-attention kernel against its plain
   version (2e-5 in float32, 2e-2 in bf16) at gemma3-1b's head shape
   [4, 2048, 4/1, 256] with windows 512 and 0 in both types, hymba-1.5b's
   [1, 2048, 25/5, 64] with window 1024 in both types and its prefill's
   [4, 2048, 25/5, 64] at windows 1024 and 0 in bf16, the smoke shapes
   (hd 16) and ragged lengths (77, 1000, and 1, 129, 1000 at hd 64 and
   256); time it at gemma3-1b's two layer shapes in bf16 beside the
   plain version and ``scaled_dot_product_attention`` (a yardstick the
   port never calls) and its bound; draw gemma3-1b at full width (26
   layers, d 1,152, vocab 262,144) in bf16 on the card and run
   ``make_prefill_step`` at [4 x 2048] tokens, requiring exactly 26 flash
   launches, all on the Hopper (TMA and wgmma) route, and print its wall
   beside the time the host took to return from the call; cast the
   weights to float32 and require the prefill's
   last-position logits at [2 x 640] to match ``prefill_into_cache`` (plain
   attention over the KV cache, no kernel) within a relative 1e-3, with
   equal argmax tokens; run ``serve_demo(smoke=False)`` twice and require
   identical in-range greedy tokens and no kernel launch;
9. the hymba-1.5b serving path: hold the selective-scan kernel against
   its plain version (atol 1e-4; 1e-3 under extreme decay) at the
   prefill's shape [4, 2048, 3200, 16], the smoke shape, N 4, a ragged
   T, one step and extreme decay; time it at the prefill's shape beside
   the plain version and its bound, and the flash kernel at hymba's
   prefill shape beside its plain version and SDPA (a boolean mask at
   window 1024, ``is_causal`` at window 0); draw hymba-1.5b at full width
   (32 layers, d 1,600, 1,662,161,600 parameters) in bf16 on the card and
   run ``make_prefill_step`` at [4 x 2048] tokens, requiring exactly 32
   selective-scan and 32 flash launches, the flash ones all on the
   Hopper route; time one layer's attention
   branch, SSM branch (and in it the float32 ``a``, ``b`` it forms) and
   MLP; cast the weights to float32 and require the prefill's logits at
   [2 x 256] to match ``prefill_into_cache`` within a relative 1e-3, with
   equal argmax tokens; run ``serve_demo("hymba-1.5b", smoke=False)``
   twice and require identical in-range greedy tokens and no kernel
   launch;
10. the rwkv6-7b serving path: hold the wkv6 kernel against its plain
   version (atol 5e-4 with a non-zero initial state; 1e-3 under extreme
   decay) at the prefill's shape [4, 2048, 64, 64], the smoke head size
   16, head sizes 32 and 8, a ragged T, one step and extreme decay, and
   the whole T against two halves chained through the final state; time
   it at the prefill's shape beside the plain version and its bound;
   draw rwkv6-7b at full width (32 layers, d 4,096, 7,584,878,592
   parameters) in bf16 on the card and run ``make_prefill_step`` at
   [4 x 2048] tokens, requiring exactly 32 wkv6 launches and no other
   (no backward, no launch that writes checkpoints), and print its wall
   beside the time the host took to return from the call;
   time one layer's time-mix inputs, WKV, group norm and output, and
   channel-mix; cast the weights to float32 and require the prefill's
   logits at [2 x 256] to match ``prefill_into_cache`` within a relative
   1e-3, with equal argmax tokens; run ``serve_demo("rwkv6-7b",
   smoke=False)`` twice and require identical in-range greedy tokens and
   no kernel launch, no checkpoints written;
11. the streaming plane: hold both support-count kernels exactly against
    their plain versions at the delta phase's shapes (slabs of 1, 5, 8,
    1,000 and 1,024 rows against the tracked sets of the stream's first
    and last windows, sized by one-shot mines) and time them beside the
    launch floor; stream the dense corpus's first 40,000 rows, then
    28,000 stationary ones, through ``StreamingMiner`` (window 20,000,
    batches of 1,000) with a live ``RecommendationEngine`` three times —
    the ``packed`` kernel, the ``mxu`` kernel and the plain ``ref`` plane
    — and require equal state and reports (walls aside), the one-shot
    mine's supports and rules over the final window, re-validations in
    the churn segment and none in the last 3 batches, one d2h a delta
    phase and a validation level, each support-count kernel on its own
    path only, the engine holding the miner's index at monotone
    versions, and 512 baskets of the final window (an item taken out of
    each) served from it equal to ``recommend_bruteforce`` on
    ``rule_match_packed``; print the churn
    and steady batch walls, the refresh-to-visible latency, the tracked
    sets and B10's comparison of a steady delta batch with a one-shot
    re-mine of the window (printed, not enforced);
12. the autotune plane: sweep the port's lattice of the three tunable
    kernels (support count, intersect, rule match) on the card into a
    temporary cache, every swept config held exactly against the plain
    oracle, and print each bucket's winner and ``cost_us`` beside an empty
    launch timed the same way (and the packed kernel alone, its operands
    packed beforehand) and the checked-in cache's winner where it
    differs; require the default dispatch (``tuning=None``) to serve the
    checked-in winner at every lattice shape; print each kernel's
    effective rates (``CostModelPolicy.from_autotune``) beside the data
    sheet's; mine the dense corpus with ``policy="costmodel"``, autotuning
    on and off (phase 3's supports and rules, one read a counting round,
    ``cost_source`` on every phase; walls, launches and whether the plan
    differs from the static one printed); serve phase 6's baskets under
    ``costmodel`` (phase 6's recommendations); print ``select_algorithm``'s
    choice and priced seconds on the dense, B11's and the retail-scale
    corpus under the autotune-fed and the roofline-only model;
13. the sharded plane on the dense corpus: (a) one NCCL rank in this
    process (a file-store group): both support-count kernels held exactly
    against their plain versions at the slabs one rank and the 4-rank
    layout give them ([100,000 and 50,000 × 1,024] against M 2,176, 256
    and 128) and timed there beside the launch floor and the bound;
    ``ShardedMiner`` on ``packed``, ``mxu`` and ``ref`` (phase 3's
    supports and rules, one d2h and one launch of the path's kernel a
    counting round, no other kernel, equal reports walls aside), then
    Eclat (phase 3's answer, no kernel); (b) four gloo ranks spawned on
    the same card (one card takes one NCCL rank), ``mesh_profile(4)``:
    the packed mine with ``device_loss`` of rank 3 at k=2 (phase 3's
    answer on every rank, rows 10,000 / 15,000 / 25,000 / 50,000 then
    20,000 / 30,000 / 50,000 / 0, one re-plan of 4,375 switches and 6,250
    re-issues), then ``SONMiner(mesh=...)`` in phase 7's partitions with
    a device loss in partition 1 (phase 3's answer); every wall printed
    beside phase 3's;
14. the user entry points at the dense corpus: (a) ``core.itemsets.
    apriori`` on the support-count kernel the checked-in cache picks and
    on the plain count (phase 3's supports, one launch a tile a counting
    round on the kernel path and none on the plain one, one read back a
    level); (b) ``launch.mine.mine`` in this process with the default
    flags, ``auto``, ``eclat``, out of core in phase 7's partitions
    (killed at boundary 2, exit code 3, then resumed), sharded on four
    spawned gloo ranks sharing the card, and under ``profile_dir``, each
    giving phase 3's supports and rules, with the device's busy share of
    the traced mine read from its ``*.pt.trace.json``; (c)
    ``launch.recommend.recommend`` with 4,096 queries, closed-loop and
    async (unpaced) under ``static`` and ``dynamic`` (async equal to the
    closed loop, the first 512 equal to ``recommend_bruteforce``,
    rule-match launches), printing the rates; (d) the reference CI's
    command lines for the port (``ci.yml:40, 118-128, 141-171``, and
    ``--sharded`` through ``torchrun`` on one NCCL rank) as subprocesses
    on the card, four at a time: each exits 0, ``--kill-after 3`` exits 3
    and its ``--resume`` 0, and ``--profile-dir`` leaves a
    ``*.pt.trace.json``; every wall printed;
15. the remaining LM families: hold the flash kernel against its plain
    version (2e-5 in float32, 2e-2 in bf16) at their prefill shapes, all
    at window 0 — [4, 2048, 32/8, 128] (granite-3-8b, minitron-8b,
    mistral-nemo-12b), [4, 2048, 48/8, 128] (dbrx-132b), [4, 2304, 48/8,
    128] (internvl2-26b: 256 patches + 2,048 tokens) and [4, 2048, 32/32,
    64] (musicgen-large) — and time it in bf16 beside the plain version,
    SDPA and its bound; then, one model at a time in bf16 at full width
    (the five that fit whole, dbrx-132b at 8 of its 40 layers,
    deepseek-v2-236b at 6 of its 60, each cut printed), require the
    reference's parameter tree, run ``make_prefill_step`` at [4 x 2048]
    tokens (with 256 patch embeddings for internvl2-26b, frame embeddings
    for musicgen-large) requiring exactly one flash launch a GQA layer on
    the Hopper route and no other kernel (none on deepseek-v2-236b: MLA
    and MoE are plain), print its wall beside the host's return time and,
    for the MoE configs, the slots dropped at ``capacity_factor`` 1.25;
    serve twice (``serve_demo(smoke=False)`` for the five whole configs,
    ``prefill_into_cache`` + ``decode`` on the cut weights for the two MoE
    ones), requiring identical in-range greedy tokens ([4, 32, 4] for
    musicgen-large) and no kernel launch; then in float32 (whole, or the
    first 4 layers for internvl2-26b and musicgen-large and 2 for the MoE
    configs, whose ``capacity_factor`` becomes ``n_experts / top_k`` so
    that the prefill drops no slot) require the prefill's last-position
    logits at [2 x 256] to match ``prefill_into_cache`` (the token
    configs) or the same function on the CPU (vision, audio: the decode
    path takes no patches or frames) within a relative 1e-3, with equal
    argmax tokens;
16. one-card training: hold the forward's ``lse`` and output against
    their plain versions, and the flash backward kernel (dQ, dK, dV from
    the forward's ``lse``) against its plain version fed the plain forward's
    (each tile-sized block within ``BWD_GATE``, in bf16 and float32),
    require the gate to fail a planted fault (one tile skipped), two
    launches bit-identical, at the
    training shapes ``TRAIN_BWD_CASES`` (gemma3-1b [4, 2048, 4/1, 256] at
    windows 512 and 0, [4, 2048, 32/8, 128], [4, 2048, 32/32, 64]), and
    in float32 at window 1 (``BWD_WINDOW_ONE``), where dS = dP - D
    cancels to rounding, dQ and dK within rtol·||plain|| plus that
    cancellation's bound (``bwd_cancel_bound`` in the port's
    flash-attention oracle) and the gate failing the planted skipped
    tile; and
    time it in bf16 beside its plain version, SDPA's backward and its
    bound (operations: 10·B·H·hd·live keys flops at the bf16 peak), each
    of its three kernels (``BWD_PASSES``) timed from a ``torch.profiler``
    trace of ``BWD_TRACE_CALLS`` calls in a fresh process; draw
    gemma3-1b whole at full width (bf16, ``remat_policy="full"``) and run
    ``TRAIN_STEPS`` steps of ``make_train_step`` on [4 x 2048] batches of
    the token pipeline, requiring exactly 2 flash forward launches a layer
    a step (one recomputed in backward), all on the Hopper route, one
    backward call (three launches) a layer a step, all on the backward's
    Hopper route, and no other kernel, printing step walls,
    tokens/s and peak memory; repeat the run and require bit-identical
    losses, parameters and moments; run ``TRAIN_SAVE_AFTER`` step, save
    through the store, restore and continue, and require the
    uninterrupted run's bits; trace one more step with ``torch.profiler``
    and print its device time by kernel, the flash backward's share among
    them; one float32 step's gradients at [2 x 2048]
    against the same step with the plain attention on the card, each leaf
    within ``TRAIN_F32_TOL`` of its max |gradient|; granite-3-8b at
    ``GRANITE_TRAIN_LAYERS`` of its 40 layers for ``TRAIN_STEPS`` steps with
    the same counts; the smoke command line ``TRAIN_CLI`` (through
    ``launch.train.main``), whose mean loss over its last 5 steps must sit
    more than 0.1 under its first 5's; then hymba-1.5b (16g-16i,
    ``scan_train_phase``): (g) the selective-scan
    backward kernel (da, db, dC, dh0 from the forward's chunk
    checkpoints) against its plain version in float32 at
    ``SCAN_BWD_CASES`` (hymba's [4, 2048, 3200, 16] training shape and
    ragged ones: T of 1, 17 and off the 16-step chunk, D·N off the
    256-lane block, N 1 and 32, zero and nonzero h0 and dh_last), each
    block of 64 steps within ``BWD_GATE``'s float32 limit, two calls
    bit-identical, each planted fault (dh_last dropped, a chunk's h read
    one step late) failing the gate, the forward's checkpoints within
    1e-4 of the plain version's, and the kernel timed at the training
    shape beside its plain version and its bound; (h) hymba-1.5b whole at
    full width (bf16, ``remat_policy="full"``) for ``TRAIN_STEPS`` steps
    of ``make_train_step`` on [4 x 2048] batches, requiring exactly 2
    scan and 2 flash forward launches a layer a step, one scan backward
    call (two launches) and one flash backward call (three) a layer a
    step and no other kernel, finite losses, and a bit-identical second
    run, printing step walls, tokens/s and peak memory; (i) one float32
    hymba-1.5b step at ``HYMBA_F32_BATCH`` against the same step with the
    plain scan under autograd, each leaf within ``TRAIN_F32_TOL`` of its
    max |gradient|; the new parts' wall is printed; then rwkv6-7b (16j-16l,
    ``wkv_bwd_gate``): (j) the wkv6 backward kernel (dr, dk, dv, dw, du,
    ds0 from the forward's chunk checkpoints) against its plain version
    in float32 at ``WKV_BWD_CASES`` (rwkv6-7b's [4, 2048, 64, 64]
    training shape, T of 1, 17 and 1,000, off the 16-step TMA stage and
    the 8-step chunk, n 8, 16 and 32, zero s0 with no dS_T, strong decays
    in (0.01, 0.5)), each block of 64 steps within ``BWD_GATE``'s float32
    limit, two calls bit-identical, each planted fault (dS_T dropped, the
    u term of dk dropped, S read one step late) failing the gate, the
    forward's checkpoints within 1e-4 of the plain version's, and the
    kernel timed at the training shape beside its plain version and its
    bound; (k) rwkv6-7b at ``RWKV_TRAIN_LAYERS`` of its 32 layers at full
    width (bf16, ``remat_policy="full"``) for ``TRAIN_STEPS`` steps of
    ``make_train_step`` on [4 x 2048] batches, requiring exactly 2 wkv6
    forward launches a layer a step (both writing checkpoints), one wkv6
    backward call (two launches) a layer a step and no other kernel,
    finite losses, and a bit-identical second run, printing step walls,
    tokens/s, peak memory and one traced step's kernels; (l) one float32
    step at ``RWKV_F32_BATCH``: each layer's wkv6 backward call within
    ``BWD_GATE``'s float32 limit of the plain backward on the inputs the
    step handed it, the loss within ``TRAIN_F32_TOL`` of the same step's
    with the plain WKV under autograd, and the step's gradients no further
    from the step's with a float64 plain WKV than the plain float32 WKV's
    are, plus ``TRAIN_F32_TOL`` of a leaf's max (at this width the plain
    WKV's float32 rounding alone moves leaves by ~20% of their max, so a
    leaf-by-leaf 1e-5 against it cannot hold); the new parts' wall is
    printed;
17. the parallel plane (``parallel_phase``): (a) one NCCL rank in this
    process (its CPU tensors through gloo) on a (1, 1) ("data", "model")
    mesh: gemma3-1b drawn whole at full width in bf16, its parameters
    distributed by ``named(param_pspecs)`` and its AdamW moments by
    ``opt_pspecs``; one backward of ``_loss_and_grads`` at [2 x 512]
    (exactly 2 flash forward launches a layer and one backward call);
    ``ef_compress`` (k_frac 0.01) and ``psum_int8`` over the whole
    gradient tree, bit-equal to the same functions on a CPU copy, timed;
    ``ring_all_gather``, ``reduce_scatter_sum`` and ``hierarchical_psum``
    at world size 1; the distributed parameters saved and
    ``restore_elastic`` ed onto the mesh, bit-equal, with times and
    bytes; the [4 x 2048] prefill with ``sequence_parallel=True`` under the
    mesh, bit-equal to the prefill without it, 26 flash launches;
    ``sequence_shard`` and ``_expert_shard`` on replicated DTensor
    activations, which come back with the reference's placements and
    unchanged values; (b) 8 gloo ranks on the card as the (2, 2, 2) test
    mesh: ``hierarchical_psum`` and ``psum_int8`` of a full-width layer
    leaf equal the single-process sums on every rank; then the
    reduce-scatter on two gloo ranks holding CUDA tensors, which must
    give the single-process result, and the ring, which must give it or
    fail by gloo's TCP transport refusing a device pointer (printed on a
    line of its own); the phase's wall is printed;
18. the compile surfaces (``dryrun_phase``): the eight mini cells of the
    dry run (granite-3-8b ``train_4k``, rwkv6-7b ``decode_32k`` and
    gemma3-1b ``prefill_32k`` at two layers and narrow widths, on the
    (2, 4) and (2, 2, 2) test meshes, and deepseek-v2-236b and dbrx-132b
    ``train_4k`` on the (2, 2, 2) mesh at grad-accum 128, 2 microbatch
    rows over 4 batch shards as the 2 x 16 x 16 mesh has 16 over 32)
    through
    ``repro_torch.launch.dryrun.lower_cell`` on fake process groups
    under ``FakeTensorMode``, in subprocesses (one for the (2, 4) cells,
    one for each (2, 2, 2) cell, side by side, each with a 300 s limit)
    in which ``jax``, ``jaxlib`` and ``repro`` are blocked: the card's
    machine has no jax, and the port's dry run must stand alone there.
    Every cell must come out ``ok`` with FLOPs above 0, and granite-3-8b's
    train cell must move collective bytes on both meshes, as must the two
    uneven cells; each cell's
    FLOPs, collective bytes and fake step's wall, and the phase's wall,
    are printed.  The dry run needs no card; its counts are analytic;
19. print the card's name and power limit, the ``kernels`` JSON line and,
    last, ``{"ok": true, "device": {...}}``.

The phases that count each kernel's launches (3, 4, 6, 7 and 11) pin the
support-count and rule-match variant (``tuning={"variant": "packed"}``
or ``"mxu"``): the default, ``tuning=None``, takes the variant the
checked-in autotune cache picks for the card.

It exits non-zero and prints no result where no CUDA device is available,
or where the port's sources are not beside it.
"""
from __future__ import annotations

import cProfile
import dataclasses
import gc
import json
import os
import pstats
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

# The H100's rates are repro_torch.launch.roofline's: HBM, the dense int8
# tensor-core rate (NVIDIA data sheet) and the binary tensor cores' bit
# AND-popcount-adds (B1_OPS, measured by tools/rule_match_packed_designs.py
# at 7,844-7,897e12 on an NVIDIA H100 80GB HBM3 at 700.00 W, whose s8 loop
# read 98-100% of the int8 rate); the packed kernels' operations bound
# counts at B1_OPS.  Beside them, the 32-bit popcount issue rate per SM
# per clock (CUDA C++ programming guide, arithmetic instruction
# throughput, compute 9.0).
POPC_PER_SM_PER_CLOCK = 16
# the support-count and rule-match variant the phases that count each
# kernel's launches pin, whatever the autotune cache picks
PACKED = {"variant": "packed"}
# synced reps per config in phase 12's sweep (two sweeps of the lattice
# at 31 reps picked the same winners on an NVIDIA H100 80GB HBM3)
AUTOTUNE_REPS = 31
# candidates a counting round of the dense mine pads to: k = 2, 3, then 4
# and 5 (the mine line's m_padded)
ROUND_M = (2176, 256, 128)

CORPUS = dict(n_tx=100_000, n_items=1000, seed=0)   # T10I4D100K scale
MIN_SUPPORT = 0.01
# FIMI retail scale (Brijs et al., KDD 1999): 88,162 baskets over 16,470
# items, about 10 items a basket
SPARSE_CORPUS = dict(n_tx=88_162, n_items=16_470, basket_len=10,
                     max_item_freq=0.01, seed=0)
SPARSE_MIN_SUPPORT = 0.005
# the reference's B11 corpus (benchmarks/bench_algorithms.py)
B11_CORPUS = dict(n_tx=8192, n_items=96, seed=3)
B11_MIN_SUPPORT = 0.02
B11_N_TILES = 16
B11_REPS = 3               # timed runs per arm (bench_algorithms.py REPS)
# interleaved timed runs per arm for the router ratio, enough to resolve
# 10% at each corpus's wall (dense 0.15-0.25 s, B11's 8-40 ms a mine)
ROUTER_REPS_DENSE = 11
ROUTER_REPS_B11 = 41
BOOTSTRAP_RESAMPLES = 2000   # for the ratio's 90% interval
N_TILES = 32
# SON's partitions of the dense corpus: 4 chunks, each mined at a local
# threshold of 250 (floor(1,000 x 25,000 / 100,000))
SON_PARTITION_ROWS = 25_000
# hymba-1.5b's prefill [batch x tokens], and its parameter tree's size
# (the reference's, by jax.eval_shape of its init_params; the config's
# param_count() formula leaves out x_proj, dt_proj, dt_bias and the fuse
# norms)
HYMBA_PREFILL = (4, 2048)
HYMBA_TREE_PARAMS = 1_662_161_600
# rwkv6-7b's prefill [batch x tokens], and its parameter tree's size (the
# reference's, by jax.eval_shape of its init_params; the config's
# param_count() formula leaves out the channel-mix wr and counts the
# LoRAs roughly)
RWKV_PREFILL = (4, 2048)
RWKV_TREE_PARAMS = 7_584_878_592
# the remaining LM families (phase 15): each config's full-width prefill
# shape, its depth on the card (None: whole) and in the float32 check,
# and the reference's parameter tree at that depth (jax.eval_shape of its
# init_params; the configs' param_count() formula leaves out final_ln, the
# vision projection and musicgen's extra codebook tables)
FAMILY_PREFILL = (4, 2048)
FAMILY_F32 = (2, 256)
FAMILIES = {
    # arch: (layers drawn in bf16, layers in the float32 check, tree)
    "granite-3-8b": (None, None, 8_372_187_136),
    "minitron-8b": (None, None, 9_882_046_464),
    "mistral-nemo-12b": (None, None, 12_247_782_400),
    "internvl2-26b": (None, 4, 19_899_009_024),
    "musicgen-large": (None, 4, 3_259_172_864),
    "dbrx-132b": (8, 2, 27_305_809_920),
    "deepseek-v2-236b": (6, 2, 21_247_132_672),
}
# the flash kernel's new shapes [B, S, H, KV, hd] on these prefills, all
# at window 0 (internvl2: 256 vision + 2,048 text tokens)
FAMILY_FLASH = {
    "granite-3-8b, minitron-8b, mistral-nemo-12b": (4, 2048, 32, 8, 128),
    "dbrx-132b": (4, 2048, 48, 8, 128),
    "internvl2-26b": (4, 2304, 48, 8, 128),
    "musicgen-large": (4, 2048, 32, 32, 64),
}
# one-card training (phase 16): the backward kernel's training shapes
# (name, B, S, H, KV, hd, window); the kernel's gate against its plain
# version, (rtol, atol) by dtype: each block of BWD_GATE_ROWS rows (one
# tile, n elements) of each batch row and head within rtol·||plain|| +
# atol·√n (the atol holds the gradients that cancel to 0, as dq's first
# row does); the forward's lse against its plain version (float32,
# relative and absolute); the
# [batch x tokens] of a train step, steps a run, the step after which the
# resumed run saves, the float32 step's batch and its gradients'
# tolerance against the plain attention (each leaf's max |difference|
# over its max |gradient|: float32 sums in another order through 26
# random-weight layers), granite-3-8b's depth of 40 on the card, and the
# smoke CLI's command line
TRAIN_BWD_CASES = [("gemma3-1b", 4, 2048, 4, 1, 256, 512),
                   ("gemma3-1b", 4, 2048, 4, 1, 256, 0),
                   ("granite-3-8b", 4, 2048, 32, 8, 128, 0),
                   ("musicgen-large", 4, 2048, 32, 32, 64, 0)]
BWD_GATE_ROWS = 64
# the float32 window-1 case of phase 16a (P = 1: dS cancels to rounding)
BWD_WINDOW_ONE = ("gemma3-1b", 4, 2048, 4, 1, 256, 1)
# the backward's three bf16 kernels at hd 64-256, by name in a trace, and
# the calls a per-kernel trace averages over
BWD_PASSES = {"flash_bwd_dot_kernel": "D",
              "flash_bwd_dkdv_hopper_kernel": "dK/dV",
              "flash_bwd_dq_hopper_kernel": "dQ"}
BWD_TRACE_CALLS = 5
BWD_GATE = {"float32": (1e-5, 1e-7), "bfloat16": (1e-2, 1e-5)}
LSE_TOL = 1e-5
TRAIN_BATCH = (4, 2048)
TRAIN_STEPS = 3
TRAIN_SAVE_AFTER = 1
TRAIN_F32_BATCH = (2, 2048)
TRAIN_F32_TOL = 1e-5
GRANITE_TRAIN_LAYERS = 8
TRAIN_CLI = ["--arch", "gemma3-1b", "--smoke", "--steps", "30", "--batch",
             "8", "--seq", "64", "--lr", "3e-3", "--device", "cuda"]
# hymba-1.5b's training (phase 16g-16i): the selective-scan backward's
# cases (name, [B, T, D, N], nonzero h0, dh_last given), gated at
# BWD_GATE["float32"] in blocks of BWD_GATE_ROWS steps, the first at the
# training shape; the forward's checkpoints against the plain version's
# (max abs, as phase 9 holds the forward); the float32 step's [batch x
# tokens]
SCAN_BWD_CASES = [("hymba-1.5b train", (4, 2048, 3200, 16), True, True),
                  ("one step", (2, 1, 3200, 16), True, True),
                  ("T 17", (2, 17, 300, 16), True, True),
                  ("T off the chunk, D·N off the block", (2, 1000, 520, 16),
                   True, True),
                  ("N 1", (2, 77, 333, 1), True, True),
                  ("N 32", (1, 129, 100, 32), True, True),
                  ("zero h0, no dh_last", (2, 64, 256, 8), False, False)]
SCAN_CKPT_TOL = 1e-4
HYMBA_F32_BATCH = (1, 512)
# rwkv6-7b's training (phase 16j-16l): the wkv6 backward's cases (name,
# [B, T, H, n], nonzero s0, dS_T given, strong decays), gated at
# BWD_GATE["float32"] in blocks of BWD_GATE_ROWS steps, the first at the
# training shape; its depth on the card (the whole model's parameters,
# gradients and AdamW moments take about 91 GB, more than one 80 GB card;
# 8 of 32 layers take about 27 GB) and the float32 step's [batch x tokens]
WKV_BWD_CASES = [("rwkv6-7b train", (4, 2048, 64, 64), True, True, False),
                 ("one step", (2, 1, 64, 64), True, True, False),
                 ("T 17", (2, 17, 8, 64), True, True, False),
                 ("T off the stage and the chunk", (2, 1000, 4, 64), True,
                  True, False),
                 ("n 8", (2, 77, 5, 8), True, True, False),
                 ("n 16", (2, 130, 4, 16), True, True, False),
                 ("n 32", (1, 96, 3, 32), True, True, False),
                 ("zero s0, no dS_T", (2, 64, 4, 64), False, False, False),
                 ("strong decays", (2, 300, 4, 64), True, True, True),
                 ("one (b, h): one cluster", (1, 9, 1, 64), True, True,
                  False)]
WKV_CKPT_TOL = 1e-4
RWKV_TRAIN_LAYERS = 8
RWKV_F32_BATCH = (1, 512)
# float32 outside the tensor cores (NVIDIA H100 SXM data sheet)
FP32_FLOPS_PER_S = 67e12
# the parallel plane (phase 17): gemma3-1b's backward on a short batch,
# its [4 x 2048] prefill under sequence_parallel, top-k error feedback at
# PARALLEL_K_FRAC; then PARALLEL_RANKS gloo ranks on the card as a
# (2, 2, 2) mesh, summing one full-width layer leaf (w_gate's [d, d_ff])
PARALLEL_ARCH = "gemma3-1b"
PARALLEL_BATCH = (2, 512)
PARALLEL_PREFILL = (4, 2048)
PARALLEL_K_FRAC = 0.01
PARALLEL_RANKS = 8
# the compile surfaces (phase 18): the reference's mini dry-run gate
# (tests/test_dryrun_mini.py): these cells at DRYRUN_SMALL, grad-accum 2,
# gemma3-1b with one KV head and 16-token windows every other layer
DRYRUN_CELLS = (("granite-3-8b", "train_4k"), ("rwkv6-7b", "decode_32k"),
                ("gemma3-1b", "prefill_32k"))
DRYRUN_SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                    head_dim=16, d_ff=128, vocab_size=512)
# and the MoE archs' train cells at the production ratio of microbatch rows
# to batch shards (16 over 2 x 16 at grad-accum 16): grad-accum 128 leaves
# 2 rows over the (2, 2, 2) mesh's 4 batch shards
DRYRUN_UNEVEN = (("deepseek-v2-236b", "train_4k"), ("dbrx-132b", "train_4k"))
DRYRUN_UNEVEN_ACCUM = 128
DRYRUN_TIMEOUT_S = 300
REPS = 20
N_QUERIES = 4096           # baskets served on each serving path
N_ORACLE = 512             # of them checked against the brute-force oracle
WIDE_RULES = 16_384        # rows of the wider index the kernels are timed on
# phase 11's stream: the dense corpus's first 40,000 rows (Zipf noise, so
# the lattice churns), then 28,000 stationary rows (a window and 8 batches
# more), through a window of 20,000 (a fifth of T10I4D100K) in batches of
# 1,000; the delta-phase kernels are held at slabs of these rows
STREAM_CHURN_ROWS = 40_000
STREAM_STEADY_ROWS = 28_000
STREAM_WINDOW = 20_000
STREAM_BATCH = 1_000
STREAM_N_TILES = 8
STREAM_DELTA_N = (1, 5, 8, 1000, 1024)
# the sharded plane (phase 13): the 4-rank layout's profile is
# mesh_profile(4) = 80/120/200/400, and its device loss (rank 3 at k = 2)
# moves the dense corpus's row blocks as the reference's count_moves
# gives on these plans (row blocks of 8)
SHARDED_RANKS = 4
SHARDED_ROWS = ((10_000, 15_000, 25_000, 50_000),      # before the fault
                (20_000, 30_000, 50_000, 0))           # after it
SHARDED_MOVES = (4375, 6250)                           # switches, re-issued
# the slab rows one rank and the 4-rank layout give each support-count
# launch
SHARDED_SLAB_ROWS = (100_000, 50_000)
# clocks the card spins before each timed loop, so that every timed launch
# is queued before the first one starts (about 25 ms at 1,980 MHz)
QUEUE_SLEEP_CYCLES = 50_000_000
# the CLIs (phase 14): the dense mine killed at this partition boundary and
# resumed, and the spawned gloo ranks of the sharded mine
CLI_KILL_AFTER = 2
CLI_SHARDS = 4
# the reference CI's commands (.github/workflows/ci.yml:40, 118-128,
# 141-171) with repro replaced by repro_torch, as chains run in turn, each
# command with the exit code it must give; "{tmp}" is a scratch directory
CLI_MATRIX = {
    "recommend --smoke": [(["recommend", "--smoke"], 0)],
    "mine --sharded --smoke": [(["mine", "--sharded", "--smoke"], 0)],
    "mine --sharded --smoke --policy dynamic": [
        (["mine", "--sharded", "--smoke", "--policy", "dynamic"], 0)],
    "mine --algorithm eclat --smoke": [
        (["mine", "--algorithm", "eclat", "--smoke"], 0)],
    "mine --algorithm eclat --smoke --policy dynamic": [
        (["mine", "--algorithm", "eclat", "--smoke", "--policy",
          "dynamic"], 0)],
    "mine --algorithm auto --smoke": [
        (["mine", "--algorithm", "auto", "--smoke"], 0)],
    "mine --algorithm auto --sharded --smoke --policy dynamic": [
        (["mine", "--algorithm", "auto", "--sharded", "--smoke", "--policy",
          "dynamic"], 0)],
    "mine --smoke --profile-dir": [
        (["mine", "--smoke", "--profile-dir", "{tmp}/mine-trace"], 0)],
    "recommend --async --smoke": [(["recommend", "--async", "--smoke"], 0)],
    "mine --out-of-core --smoke": [
        (["mine", "--out-of-core", "--smoke", "--son-dir",
          "{tmp}/son-smoke"], 0)],
    "mine --out-of-core --sharded --smoke --policy dynamic": [
        (["mine", "--out-of-core", "--sharded", "--smoke", "--policy",
          "dynamic", "--son-dir", "{tmp}/son-smoke-sharded"], 0)],
    "mine --out-of-core --smoke --kill-after 3, then --resume": [
        (["mine", "--out-of-core", "--smoke", "--son-dir", "{tmp}/son-kr",
          "--kill-after", "3"], 3),
        (["mine", "--out-of-core", "--smoke", "--son-dir", "{tmp}/son-kr",
          "--resume"], 0)],
    # not in the reference CI: the torchrun route of --sharded (one NCCL
    # rank on the card)
    "torchrun --nproc-per-node 1 mine --sharded --smoke": [
        (["torchrun", "mine", "--sharded", "--smoke"], 0)],
}
CLI_PARALLEL = 4            # chains of the matrix running at once
CLI_TIMEOUT_S = 300         # a command of the matrix


def _nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def _cuda_ms(torch, fn, reps: int = REPS, queued: bool = True) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, after warm-up
    (inputs stay in the 50 MB L2 between launches where they fit).

    The card first spins for ``QUEUE_SLEEP_CYCLES``; the launches are
    queued meanwhile, so they run back to back and the events time the
    device, not the host's rate of enqueueing small kernels.  Where the
    host took longer to enqueue them than the card spun (a pause of the
    host's), the window is timed again, up to three times, and then it
    raises: no timing with host gaps in it is returned.  With
    ``queued=False`` the card does not spin first: for a function that
    enqueues thousands of small kernels (a Python loop over time steps),
    whose time is set by the host, the events then time the host's loop
    as the card sees it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        spin, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        spin.record()
        if queued:
            torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if not queued or enqueue_ms < spin.elapsed_time(start):
            return start.elapsed_time(end) / reps
    raise AssertionError(f"enqueueing {reps} calls took {enqueue_ms:.2f}"
                         " ms, longer than the card spun, three times: the "
                         "timing would include host gaps")


WALL_FIELDS = ("wall_time_s", "host_time_s", "wall_s", "refresh_latency_s")


def _without_walls(x):
    """A report as plain values, without the fields that time this process
    (``WALL_FIELDS``)."""
    if dataclasses.is_dataclass(x):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _without_walls(v) for k, v in x.items()
                if k not in WALL_FIELDS}
    if isinstance(x, (list, tuple)):
        return [_without_walls(v) for v in x]
    return x


def host_profile(label: str, fn, *args) -> None:
    """Run ``fn(*args)`` under cProfile and print the six host functions
    with the most own time."""
    prof = cProfile.Profile()
    prof.runcall(fn, *args)
    top = sorted(pstats.Stats(prof).stats.items(),
                 key=lambda kv: -kv[1][2])[:6]
    print(f"host profile, {label} (own time): " + "; ".join(
        f"{Path(f).name}:{line} {fn_name} {tt * 1e3:.1f} ms"
        for (f, line, fn_name), (_, _, tt, _, _) in top))


def son_phase(torch, dev, T_all, packed, index, queries, s_packed,
              zero_counts, read_counts) -> dict:
    """Phase 7: out-of-core SON mining of the dense corpus on the card.

    Mines ``T_all`` in partitions of ``SON_PARTITION_ROWS`` through
    ``make_miner(son=...)`` with Apriori (the packed kernel), Eclat (the
    intersect kernel in pass 1, the packed one in pass 2) and Apriori on
    the ``mxu`` kernel, each required to give the in-core mine's supports
    and rules (``packed``) with one d2h a re-count chunk; kills a mine at
    the first re-count boundary and resumes it; saves the rule index,
    loads it back and serves ``queries`` through it, requiring
    ``s_packed``.  Returns each kernel's launches per SON path."""
    import tempfile

    from repro_torch.mining import SONConfig, SONKilled, make_miner
    from repro_torch.pipeline import PipelineConfig
    from repro_torch.serving import (RecommendationEngine, RuleIndex,
                                     ServingConfig)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def son_mine(workdir, label, son_kw=None, **kw):
        """One SON path: counts zeroed just before, read just after; the
        wall ends in a synchronise."""
        kw.setdefault("tuning", PACKED)
        cfg = PipelineConfig(min_support=MIN_SUPPORT, n_tiles=N_TILES,
                             device=dev.type, **kw)
        son = SONConfig(workdir=workdir, partition_rows=SON_PARTITION_ROWS,
                        **(son_kw or {}))
        zero_counts()
        t0 = time.perf_counter()
        miner, _ = make_miner(T_all, config=cfg, son=son)
        res = miner.run(T_all)
        sync()
        wall = time.perf_counter() - t0
        on = read_counts()
        rep, led = res.report, res.report.ledger

        def host(prefix):
            return sum(p.host_time_s for p in led.phases
                       if p.name.startswith(prefix))

        recounts = [p for p in led.phases
                    if p.name.startswith("son-recount-p")]
        # the ledger times every phase of SON's own and the local mines'
        # serial phases; their map rounds record no host time, so pass 1
        # is the rest of the wall (with the density scan and host glue)
        timed = {k: host(k) for k in ("son-recount-p", "son-spill-p",
                                      "son-load-p", "son-ckpt-b",
                                      "mba-rules")}
        print(f"son {label}: {rep.n_partitions} partitions x "
              f"{rep.partition_rows} rows, algorithm {rep.algorithm}, "
              f"{len(res.supports)} itemsets, {len(res.rules)} rules, wall "
              f"{wall:.3f} s; host time from the ledger: pass 2 (re-counts:"
              f" densify, upload, count, one read a chunk) "
              f"{timed['son-recount-p']:.3f} s, spills "
              f"{timed['son-spill-p']:.3f} s, loads "
              f"{timed['son-load-p']:.3f} s, checkpoints "
              f"{timed['son-ckpt-b']:.3f} s ({rep.checkpoint_saves} saves, "
              f"{rep.checkpoint_bytes} B), rules {timed['mba-rules']:.3f} "
              f"s, pass 1's serial phases {host('son-p'):.3f} s; the rest, "
              f"pass 1 with the density scan, "
              f"{wall - sum(timed.values()):.3f} s; re-count d2h "
              f"{[(p.name, p.syncs, p.d2h_bytes) for p in recounts]}; "
              f"launches {on}")
        # a resumed mine re-counts only the chunks its checkpoint lacks
        todo = rep.n_partitions - max(0, rep.partitions_resumed
                                      - rep.n_partitions)
        if len(recounts) != todo or any(p.syncs != 1 for p in recounts):
            raise AssertionError(f"son {label}: each re-count chunk must "
                                 "read back once: "
                                 f"{[(p.name, p.syncs) for p in recounts]}")
        if res.supports != packed.supports or res.rules != packed.rules:
            raise AssertionError(f"son {label} differs from the in-core mine")
        return res, on, wall

    out = {}
    with tempfile.TemporaryDirectory() as wd:
        apriori, on_apriori, out["wall_apriori_s"] = son_mine(
            f"{wd}/apriori", "apriori (packed)")
        _, on_eclat, out["wall_eclat_s"] = son_mine(
            f"{wd}/eclat", "eclat", algorithm="eclat")
        _, on_mxu, out["wall_mxu_s"] = son_mine(
            f"{wd}/mxu", "apriori (mxu)", tuning={"variant": "mxu"})
        # the Eclat local mines never run the packed kernel, so its
        # launches in that path are pass 2's re-counts
        if (on_apriori["packed"] <= 0 or on_eclat["intersect"] <= 0
                or on_eclat["packed"] <= 0 or on_mxu["int8"] <= 0):
            raise AssertionError("a SON path did not launch its kernels: "
                                 f"{on_apriori}, {on_eclat}, {on_mxu}")
        if (on_apriori["int8"] or on_apriori["intersect"]
                or on_eclat["int8"] or on_mxu["packed"]
                or on_mxu["intersect"]
                or any(c[k] for c in (on_apriori, on_eclat, on_mxu)
                       for k in ("rm_packed", "rm_int8", "flash", "scan",
                                 "wkv"))):
            raise AssertionError("a SON path launched another path's kernel")
        out["launches"] = {"packed": on_apriori["packed"],
                           "int8": on_mxu["int8"],
                           "intersect": on_eclat["intersect"],
                           "packed_in_eclat_pass2": on_eclat["packed"]}

        # kill at the first re-count boundary, then resume
        P = apriori.report.n_partitions
        try:
            son_mine(f"{wd}/kill", "killed", son_kw={"abort_after": P + 1})
        except SONKilled as e:
            if e.boundary != P + 1:
                raise AssertionError(f"killed at boundary {e.boundary}, "
                                     f"not {P + 1}") from e
        else:
            raise AssertionError("abort_after did not kill the mine")
        resumed, _, out["wall_resumed_s"] = son_mine(
            f"{wd}/kill", "resumed", son_kw={"resume": True})
        if resumed.report.partitions_resumed != P + 1:
            raise AssertionError(
                f"resumed {resumed.report.partitions_resumed} partition "
                f"passes, not {P + 1}")
        print(f"son kill at boundary {P + 1} and resume: "
              f"{resumed.report.partitions_resumed} partition passes "
              "resumed, the same supports and rules")

        # the rule index through the checkpoint store
        built = RuleIndex.build(apriori.rules, index.n_items)
        t0 = time.perf_counter()
        built.save(f"{wd}/index")
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = RuleIndex.load(f"{wd}/index")
        load_s = time.perf_counter() - t0
        if not (loaded.same_arrays(built) and loaded.same_arrays(index)):
            raise AssertionError("the loaded rule index differs")
        results, report = RecommendationEngine(
            loaded, config=ServingConfig(device=dev.type)).serve(queries)
        if results != s_packed:
            raise AssertionError("the loaded index serves other "
                                 "recommendations")
        print(f"rule index saved in {save_s:.4f} s and loaded in "
              f"{load_s:.4f} s ({loaded.nbytes} B of arrays); serving "
              f"{report.n_queries} queries through it gives phase 6's "
              "top-k items and scores")
    return out


def stream_phase(torch, np, dev, T_all, sms, floor_ms, zero_counts,
                 read_counts, churn_rows=STREAM_CHURN_ROWS,
                 steady_rows=STREAM_STEADY_ROWS, window=STREAM_WINDOW,
                 batch=STREAM_BATCH) -> dict:
    """Phase 11: the streaming plane on the card.

    Streams ``T_all[:churn_rows]`` then ``stationary_baskets(steady_rows)``
    through ``StreamingMiner`` with a live ``RecommendationEngine`` three
    times (the packed kernel, ``mxu``, the ``ref`` plane), after holding
    both support-count kernels exactly against their plain versions at the
    delta phase's shapes (slabs of 1 to 1,024 rows against the churn
    segment's and the stationary tracked sets, sized from one-shot mines
    of the first and the last window).  Requires equal state and reports
    on all three paths, the one-shot mine's answer over the final window,
    re-validations in the churn segment and none in the last 3 batches,
    one d2h a delta phase and a validation level, each kernel on its own
    path only, the engine holding the miner's index at monotone versions,
    and ``N_ORACLE`` baskets of the final window, an item taken out of
    each, served from it equal to the brute-force oracle on
    ``rule_match_packed``.  Prints the walls and B10's delta
    batch against a one-shot re-mine (printed, not enforced); returns the
    launches and the delta-shape times."""
    from repro_torch.data.baskets import pad_items, stationary_baskets
    from repro_torch.kernels.support_count import fused, kernel
    from repro_torch.launch.roofline import B1_OPS, HBM_BW, INT8_OPS
    from repro_torch.pipeline import MarketBasketPipeline
    from repro_torch.serving import (Query, RecommendationEngine, RuleIndex,
                                     ServingConfig, recommend_bruteforce)
    from repro_torch.streaming import (StreamingConfig, StreamingMiner,
                                       TransactionStream)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    S = np.vstack([T_all[:churn_rows],
                   stationary_baskets(steady_rows, T_all.shape[1], seed=1)])
    n_items = S.shape[1]
    n_churn = churn_rows // batch              # batches of the churn segment
    base = dict(window=window, batch_size=batch, min_support=MIN_SUPPORT,
                min_confidence=0.6, n_tiles=STREAM_N_TILES, device=dev.type)
    cfg = StreamingConfig(**base)

    # ---- the delta shapes: slabs of batch rows against a tracked set ----
    def tracked(rows):
        """The candidates a validation of ``rows`` tracks (every level's,
        the negative border included), from a one-shot mine's rounds."""
        rep = MarketBasketPipeline(config=cfg.pipeline_config()).run(
            rows).report
        return sum(r.n_candidates for r in rep.rounds if r.k >= 2)

    m_churn, m_steady = tracked(S[:window]), tracked(S[-window:])
    rows = torch.from_numpy(pad_items(S[churn_rows - max(STREAM_DELTA_N):
                                        churn_rows])).to(dev).view(torch.int8)
    I = rows.shape[1]
    W = I // 32
    g = np.random.default_rng(11)
    delta = []
    for m in (m_churn, m_steady):
        M = -(-m // 128) * 128                 # the data plane's bucket
        C = np.zeros((M, I), np.int8)
        for r in range(m):                     # 1-3 items; the rest padding
            C[r, g.choice(n_items, 1 + r % 3, replace=False)] = 1
        C = torch.from_numpy(C).to(dev)
        sizes = C.sum(dim=1, dtype=torch.int32)
        Cw = fused.pack_words(C)
        for N in STREAM_DELTA_N:
            T = rows[:N]
            Tw = fused.pack_words(T)
            for key, fn, plain, args, geom, ops, nbytes in (
                    ("packed", fused.support_count_packed,
                     fused.support_count_packed_plain, (Tw, Cw, sizes),
                     fused.geometry(N, M, W, sms).describe(N, M, W),
                     N * M * W * 32 / B1_OPS,
                     N * W * 4 + M * W * 4 + 2 * M * 4),
                    ("int8", kernel.support_count_int8,
                     kernel.support_count_int8_plain, (T, C, sizes),
                     kernel.geometry(N, M, I, sms).describe(N, M, I),
                     2 * N * M * I / INT8_OPS,
                     N * I + M * I + 2 * M * 4)):
                got, want = fn(*args), plain(*args)
                sync()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"support_count_{key} [{N}, {M}] differs from its "
                        f"plain version in {int((got != want).sum())} counts")
                bnd = {"operations": ops * 1e3, "bytes": nbytes / HBM_BW * 1e3}
                by = max(bnd, key=bnd.get)
                delta.append(dict(kernel=key, N=N, M=M, tracked=m,
                                  ms=_cuda_ms(torch, lambda: fn(*args)),
                                  bound_ms=bnd[by], bound_by=by,
                                  geometry=geom))
    for d in delta:
        print(f"stream delta shape {d['kernel']} [{d['N']} x {d['M']} "
              f"({d['tracked']} tracked)]: {d['ms']:.4f} ms "
              f"({d['ms'] / floor_ms:.2f}x the launch floor), bound "
              f"{d['bound_ms']:.6f} ms ({d['bound_by']}); launch: "
              f"{d['geometry']}")
    print(f"support-count kernels match their plain versions exactly at "
          f"the delta shapes: N {list(STREAM_DELTA_N)} x tracked sets "
          f"{m_churn} (churn, the first window) and {m_steady} "
          "(stationary, the last window)")

    # ---- the stream, three ways ----------------------------------------
    def drive(label, **kw):
        """One path: counts zeroed just before, read just after."""
        engine = RecommendationEngine(
            RuleIndex.build([], n_items),
            config=ServingConfig(k=5, tuning=PACKED, device=dev.type))
        kw.setdefault("tuning", PACKED)
        miner = StreamingMiner(n_items, config=StreamingConfig(**base, **kw),
                               engine=engine)
        sizes, same = [], []
        zero_counts()
        t0 = time.perf_counter()
        for b in TransactionStream(S, batch):
            miner.process_batch(b)
            sizes.append(len(miner._tracked))
            same.append(engine.index is miner.index)
        miner.flush()
        sync()
        wall = time.perf_counter() - t0
        on = read_counts()
        report = miner.take_report()
        phases = report.ledger.phases
        deltas = [p for p in phases if p.name.startswith("stream-delta-")]
        levels = [p for p in phases if p.name.startswith("stream-validate-k")]
        revalidated = [b.idx for b in report.batches if b.revalidated]
        print(f"stream {label}: backend {report.backend}, "
              f"{report.n_batches} batches, {report.n_revalidations} "
              f"re-validations (batches {revalidated}), "
              f"{report.n_refreshes} refreshes, {len(miner.supports)} "
              f"itemsets, {len(miner.rules)} rules, index "
              f"v{miner.index.version}, wall {wall:.3f} s; launches {on}")
        if len(deltas) != report.n_batches or any(
                p.syncs != 1 for p in deltas + levels) or sum(
                p.syncs for p in phases) != len(deltas) + len(levels):
            raise AssertionError(
                f"stream {label}: one d2h a delta phase and a validation "
                f"level: {[(p.name, p.syncs) for p in phases if p.syncs]}")
        if not any(i < n_churn for i in revalidated) or any(
                b.revalidated for b in report.batches[-3:]):
            raise AssertionError(f"stream {label}: re-validated at batches "
                                 f"{revalidated}")
        versions = [b.index_version for b in report.batches]
        if not all(same) or versions != sorted(versions):
            raise AssertionError(f"stream {label}: the engine lost the "
                                 f"miner's index or versions went back")
        if sizes[-1] != m_steady:
            raise AssertionError(f"stream {label}: tracks {sizes[-1]} "
                                 f"itemsets, the last window {m_steady}")
        return dict(miner=miner, report=report, engine=engine, on=on,
                    wall=wall, sizes=sizes)

    runs = {"packed": drive("packed"),
            "mxu": drive("mxu", tuning={"variant": "mxu"}),
            "ref": drive("ref", data_plane="ref")}
    packed = runs["packed"]
    miner, report = packed["miner"], packed["report"]
    want = dict(_without_walls(report), backend="cuda")
    for name, run in runs.items():
        other = run["miner"]
        if (other.supports != miner.supports or other.rules != miner.rules
                or not other.index.same_arrays(miner.index)
                or other.index.version != miner.index.version
                or dict(_without_walls(run["report"]),
                        backend="cuda") != want):
            raise AssertionError(f"stream path {name} differs from packed")
    on = {name: run["on"] for name, run in runs.items()}
    if (on["packed"]["packed"] <= 0 or on["mxu"]["int8"] <= 0
            or on["packed"]["int8"] or on["mxu"]["packed"]
            or any(on["ref"].values())
            or on["packed"]["packed"] != on["mxu"]["int8"]
            or any(c[k] for c in on.values() for k in c
                   if k not in ("packed", "int8"))):
        raise AssertionError(f"a stream path launched another path's "
                             f"kernel, or none: {on}")

    # ---- the one-shot re-mine of the final window (and B10) -------------
    final = miner.window.rows_raw()
    remine = []
    for _ in range(2):
        t0 = time.perf_counter()
        once = MarketBasketPipeline(config=cfg.pipeline_config()).run(final)
        sync()
        remine.append(time.perf_counter() - t0)
        if once.supports != miner.supports or once.rules != miner.rules:
            raise AssertionError("the stream differs from a one-shot mine "
                                 "of its final window")
    # batches whose window held stationary rows only, none re-validated
    steady = [b for b in report.batches
              if b.idx >= (churn_rows + window) // batch]
    if not steady or any(b.revalidated for b in steady):
        raise AssertionError("the steady tail re-validated")
    host = {p.name: p.host_time_s for p in report.ledger.phases}

    def mean(xs):
        return sum(xs) / len(xs)

    churn = report.batches[:n_churn]
    # host time by phase, summed over the stream (names without their
    # batch index and level); the rest of the wall is the window's pushes
    # and stacking, the validation tiles' upload and the supports dicts
    by_phase = {}
    for p in report.ledger.phases:
        key = re.sub(r"-k?\d+$", "", p.name)
        by_phase[key] = by_phase.get(key, 0.0) + p.host_time_s
    print(f"stream packed, host time by phase: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in by_phase.items()) + "; the rest "
        f"{packed['wall'] - sum(by_phase.values()):.3f} s of the "
        f"{packed['wall']:.3f} s wall")
    out = dict(
        tracked_churn=m_churn, tracked_steady=m_steady,
        tracked_range_churn=[min(packed["sizes"][:n_churn]),
                             max(packed["sizes"][:n_churn])],
        batch_wall_churn_s=mean([b.wall_s for b in churn]),
        batch_wall_steady_s=mean([b.wall_s for b in steady]),
        delta_host_churn_s=mean([host[f"stream-delta-{b.idx}"]
                                 for b in churn]),
        delta_host_steady_s=mean([host[f"stream-delta-{b.idx}"]
                                  for b in steady]),
        remine_s=remine[-1],
        refresh_latency_s=report.mean_refresh_latency_s,
        walls_s={name: run["wall"] for name, run in runs.items()})
    out["b10_remine_over_delta_batch"] = (out["remine_s"]
                                          / out["batch_wall_steady_s"])
    print(f"stream walls: a batch {out['batch_wall_churn_s']:.4f} s in the "
          f"churn segment ({len(churn)} batches, delta phase "
          f"{out['delta_host_churn_s']:.4f} s), "
          f"{out['batch_wall_steady_s']:.4f} s in the steady tail "
          f"({len(steady)} batches, delta phase "
          f"{out['delta_host_steady_s']:.4f} s); mean refresh-to-visible "
          f"{out['refresh_latency_s'] * 1e3:.2f} ms; tracked sets "
          f"{out['tracked_range_churn']} in the churn segment, "
          f"{m_steady} steady")
    print(f"B10 (printed, not enforced): a one-shot re-mine of the "
          f"{len(final)}-row window takes {out['remine_s']:.4f} s (first "
          f"{remine[0]:.4f} s), the steady delta batch "
          f"{out['batch_wall_steady_s']:.4f} s: "
          f"{out['b10_remine_over_delta_batch']:.2f}x")

    # ---- serving from the hot-swapped index -----------------------------
    # baskets of the final window with one item taken out in turn: a
    # whole pattern basket holds every item its rules would recommend
    engine = packed["engine"]
    queries = [Query.of(np.delete(ids, i % len(ids)).tolist())
               for i, ids in enumerate(map(np.flatnonzero,
                                           final[-N_ORACLE:]))]
    zero_counts()
    results, srep = engine.serve(queries)
    on_serve = read_counts()
    if on_serve["rm_packed"] <= 0 or any(
            v for k, v in on_serve.items() if k != "rm_packed"):
        raise AssertionError(f"serving the stream's index launched "
                             f"{on_serve}")
    for q, got in zip(queries, results):
        if got != recommend_bruteforce(miner.rules, q.payload,
                                       engine.config.k):
            raise AssertionError(f"basket {q.payload}: {got} is not the "
                                 "brute-force oracle's answer")
    if not any(results):
        raise AssertionError("no basket got a recommendation")
    print(f"served {len(queries)} baskets of the final window (an item "
          f"taken out of each) from index "
          f"v{engine.index.version} ({srep.index_rows} rows): equal to "
          f"recommend_bruteforce, {sum(map(bool, results))} non-empty; "
          f"launches {on_serve}")
    out["launches"] = {"packed": on["packed"]["packed"],
                       "int8": on["mxu"]["int8"],
                       "rm_packed": on_serve["rm_packed"]}
    out["delta"] = delta
    return out


def autotune_phase(torch, np, dev, T_all, packed, index, queries,
                   s_packed) -> dict:
    """Phase 12: the autotune plane and the cost-model policy on the card.

    Sweeps the port's whole lattice for the three tunable kernels into a
    temporary cache (never the checked-in one), requiring every swept
    config to equal the plain oracle exactly, and prints each bucket's
    winner and ``cost_us`` beside the launch floor measured the same way
    (and, for a packed config, its kernel alone on operands packed
    beforehand), naming the checked-in cache's winner where it differs;
    requires ``resolve_config(..., None, dev)`` to serve the checked-in
    cache's winner at every lattice shape; prints each kernel's effective
    rates from ``CostModelPolicy.from_autotune`` on the fresh cache beside
    the data sheet's; mines the dense corpus with ``policy="costmodel"``
    with autotuning on and off (phase 3's answer, one d2h a counting
    round, ``cost_source`` on every phase; the wall, the launches and
    whether the plan differs from phase 3's static one printed); serves
    ``queries`` under ``costmodel`` (phase 6's answers); and prints
    ``select_algorithm``'s choice and priced seconds on the dense, B11's
    and the retail-scale corpus under ``AlgorithmCostModel.from_autotune``
    and the roofline-only model."""
    import tempfile

    from repro_torch.data.baskets import (BasketConfig, generate_baskets,
                                          sparse_baskets)
    from repro_torch.data.sparse import SparseSlab, density_stats
    from repro_torch.kernels.autotune.cache import (DEFAULT_CACHE_PATH,
                                                    AutotuneCache,
                                                    device_kind,
                                                    resolve_config)
    from repro_torch.kernels.autotune.tuner import (make_inputs, measure_us,
                                                    standard_shapes)
    from repro_torch.kernels.rule_match import fused as rm_fused
    from repro_torch.kernels.support_count import fused
    from repro_torch.kernels.support_count.kernel import support_count_int8
    from repro_torch.launch.autotune import autotune
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS
    from repro_torch.launch.tuning import TUNABLE_KERNELS, default_config
    from repro_torch.mining import AlgorithmCostModel, select_algorithm
    from repro_torch.pipeline import MarketBasketPipeline, PipelineConfig
    from repro_torch.runtime import CostModelPolicy
    from repro_torch.serving import RecommendationEngine, ServingConfig

    kind = device_kind(dev)
    checked_in = AutotuneCache.load(DEFAULT_CACHE_PATH)
    if checked_in.load_error:
        raise AssertionError(f"the checked-in cache: {checked_in.load_error}")
    on_card = checked_in.has_kernel("support_count", dev)
    print(f"autotune: device kind {kind}; the checked-in cache holds "
          f"{len(checked_in)} entries, "
          f"{'some' if on_card else 'none'} for this kind")

    # ---- 1-2. the sweep, into a scratch cache ---------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as wd:
        fresh = autotune(out=f"{wd}/cache.json", reps=AUTOTUNE_REPS,
                         device=dev.type, log=lambda line: None)
    sweep_s = time.perf_counter() - t0
    empty = torch.empty(0, device=dev)
    floor_us = measure_us(lambda: (torch.cuda._sleep(0), empty)[1],
                          reps=AUTOTUNE_REPS)
    print(f"autotune sweep: {len(fresh)} buckets in {sweep_s:.1f} s "
          f"({AUTOTUNE_REPS} reps a config, CUDA events); an empty launch "
          f"measured the same way: {floor_us:.2f} us")
    sweep = {}
    for kernel in TUNABLE_KERNELS:
        for shape in standard_shapes(kernel):
            ent = fresh.lookup(kernel, shape, dev)
            if ent is None or ent["shape"] != list(shape):
                raise AssertionError(f"the sweep has no entry for {kernel} "
                                     f"{shape}")
            if not all(s["matched"] for s in ent["swept"]):
                raise AssertionError(f"{kernel} {shape}: a config differs "
                                     f"from the oracle: {ent['swept']}")
            costs = {s["config"]["variant"]: s["cost_us"]
                     for s in ent["swept"]}
            line = (f"autotune {kernel} {list(shape)}: winner "
                    f"{ent['config']['variant']} {ent['cost_us']:.2f} us "
                    f"({ent['cost_us'] / floor_us:.1f}x the floor); swept "
                    + ", ".join(f"{v} {c:.2f} us" for v, c in costs.items()))
            alone = None
            if kernel != "intersect_count":
                x = make_inputs(kernel, shape, device=dev)
                if kernel == "support_count":
                    args = (fused.pack_words(x["T"]), fused.pack_words(x["C"]),
                            x["sizes"][0].to(torch.int32))
                    alone = measure_us(lambda: fused.support_count_packed(
                        *args), reps=AUTOTUNE_REPS)
                else:
                    args = (fused.pack_words(x["Q"]), fused.pack_words(x["A"]),
                            x["sizes"][0].to(torch.int32), x["conf"][0])
                    alone = measure_us(lambda: rm_fused.rule_scores_packed(
                        *args), reps=AUTOTUNE_REPS)
                line += (f"; the packed kernel alone on packed operands "
                         f"{alone:.2f} us")
                del x, args
            ci = checked_in.lookup(kernel, shape, dev)
            if ci is not None and ci["config"] != ent["config"]:
                line += f"; the checked-in cache's winner {ci['config']}"
            print(line)
            sweep[f"{kernel} {list(shape)}"] = dict(
                winner=ent["config"]["variant"], cost_us=ent["cost_us"],
                swept_us=costs, packed_kernel_alone_us=alone)

    # ---- 3. the default dispatch serves the checked-in winners -----------
    for kernel in TUNABLE_KERNELS:
        for shape in standard_shapes(kernel):
            ci = checked_in.lookup(kernel, shape, dev)
            want = ci["config"] if ci else default_config(kernel, shape)
            got = resolve_config(kernel, shape, None, dev)
            if got != want:
                raise AssertionError(f"{kernel} {shape}: the default "
                                     f"dispatch picks {got}, not {want}")
    print("the default dispatch (tuning=None) serves the checked-in "
          "cache's winner at every lattice shape")

    # ---- 4. the effective rates the cost model is fed -------------------
    rates = {}
    for kernel in TUNABLE_KERNELS:
        pol = CostModelPolicy.from_autotune(fresh, kernel, device=dev)
        rates[kernel] = dict(peak_flops=pol.peak_flops, hbm_bw=pol.hbm_bw,
                             flops_per_byte=pol.flops_per_byte)
        print(f"autotune rates {kernel}: {pol.peak_flops:.4g} flop/s "
              f"({pol.peak_flops / PEAK_FLOPS:.2%} of the data sheet's "
              f"{PEAK_FLOPS:.4g}), {pol.hbm_bw:.4g} B/s "
              f"({pol.hbm_bw / HBM_BW:.2%} of {HBM_BW:.4g}), intensity "
              f"{pol.flops_per_byte:.1f} flop/B (the data sheet's ridge "
              f"{PEAK_FLOPS / HBM_BW:.1f})")

    # ---- 5. the dense mine under costmodel, autotune on and off ----------
    def plans(res):
        return [p.tiles_done for p in res.report.ledger.by_kind("map")]

    mines = {}
    for autotune_on in (True, False):
        label = f"costmodel, autotune {'on' if autotune_on else 'off'}"
        cfg = PipelineConfig(min_support=MIN_SUPPORT, n_tiles=N_TILES,
                             policy="costmodel", autotune=autotune_on,
                             device=dev.type)
        counts = (fused.support_count_packed, support_count_int8)
        before = [f.launches for f in counts]
        t0 = time.perf_counter()
        res = MarketBasketPipeline(config=cfg).run(T_all)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = [f.launches - b for f, b in zip(counts, before)]
        led = res.report.ledger
        want = "autotune" if autotune_on and on_card else "roofline"
        sources = {p.cost_source for p in led.phases}
        maps = led.by_kind("map")
        if res.supports != packed.supports or res.rules != packed.rules:
            raise AssertionError(f"mine {label} differs from phase 3's")
        if not maps or any(p.syncs != 1 for p in maps):
            raise AssertionError(f"mine {label}: one read a counting round: "
                                 f"{[(p.name, p.syncs) for p in maps]}")
        if sources != {want} or res.report.policy != "costmodel":
            raise AssertionError(f"mine {label}: cost sources {sources}, "
                                 f"not {want}")
        differs = plans(res) != plans(packed)
        print(f"mine {label}: wall {wall:.3f} s, cost_source {want} on all "
              f"{len(led.phases)} phases, launches packed {launches[0]} / "
              f"int8 {launches[1]}; the plan "
              f"{'differs from' if differs else 'equals'} phase 3's static "
              "plan")
        mines[label] = dict(wall_s=wall, plan_differs=differs,
                            launches_packed=launches[0],
                            launches_int8=launches[1])

    # ---- 6. the serve under costmodel -----------------------------------
    t0 = time.perf_counter()
    results, report = RecommendationEngine(index, config=ServingConfig(
        policy="costmodel", device=dev.type)).serve(queries)
    serve_s = time.perf_counter() - t0
    if results != s_packed:
        raise AssertionError("the costmodel serve differs from phase 6's")
    rule_source = {p.cost_source for p in report.ledger.phases}
    print(f"serve costmodel: {report.n_queries} queries, phase 6's "
          f"recommendations, cost_source {sorted(rule_source)}, wall "
          f"{serve_s:.4f} s")

    # ---- 7. the router under both models --------------------------------
    corpora = {"dense": (T_all, MIN_SUPPORT),
               "b11": (generate_baskets(BasketConfig(**B11_CORPUS)),
                       B11_MIN_SUPPORT),
               "retail": (SparseSlab.from_baskets(
                   sparse_baskets(**SPARSE_CORPUS),
                   n_items=SPARSE_CORPUS["n_items"]), SPARSE_MIN_SUPPORT)}
    models = {"autotune": AlgorithmCostModel.from_autotune(device=dev),
              "roofline": AlgorithmCostModel()}
    router = {}
    for name, (baskets, min_support) in corpora.items():
        stats = density_stats(baskets)
        min_sup = PipelineConfig(min_support=min_support,
                                 device=dev.type).abs_support(stats.n_tx)
        for model_name, model in models.items():
            choice = select_algorithm(baskets, min_sup, model=model,
                                      stats=stats)
            router[f"{name} {model_name}"] = dict(
                algorithm=choice.algorithm, est_cost_s=choice.est_cost_s)
            print(f"router {name} under the {model_name} model: "
                  f"{choice.summary()}")
    return dict(sweep=sweep, floor_us=floor_us, rates=rates, mines=mines,
                serve_wall_s=serve_s, router=router)


def _live_pairs(S: int, window: int) -> int:
    """Σ over queries of the keys a causal (windowed) row attends to."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def _planted_faults(torch, q, k, v, lse, dout, out, window: int,
                    tile: int = BWD_GATE_ROWS):
    """What a backward kernel that skips one tile would lose, as (dq, dk,
    dv) in float32 and zero elsewhere: the last query tile's farthest live
    KV tile in the dQ pass, and the last live query tile of the middle KV
    tile in the dK/dV pass.  ``got - fault`` is such a kernel's result."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    scale = hd ** -0.5
    qf, of, gf = (x.float() for x in (q, out, dout))
    kf, vf = (x.float().repeat_interleave(H // KV, dim=2) for x in (k, v))
    D = (gf * of).sum(-1).transpose(1, 2)                 # [B, H, S]

    def p_ds(qr, kr):
        s = torch.einsum("bqhd,bkhd->bhqk", qf[:, qr], kf[:, kr]) * scale
        i = torch.arange(qr.start, qr.stop, device=q.device)[:, None]
        j = torch.arange(kr.start, kr.stop, device=q.device)[None, :]
        live = (j <= i) & ((j > i - window) if window > 0 else True)
        p = torch.where(live, torch.exp(s - lse[:, :, qr, None]), 0.0)
        dp = torch.einsum("bqhd,bkhd->bhqk", gf[:, qr], vf[:, kr])
        return p, p * (dp - D[:, :, qr, None])

    def tile_of(row):
        t0 = row // tile * tile
        return slice(t0, min(S, t0 + tile))

    dq = torch.zeros_like(qf)
    dk, dv = (torch.zeros(k.shape, device=q.device) for _ in range(2))
    qr = tile_of(S - 1)
    kr = tile_of(max(0, qr.start - window + 1) if window > 0 else 0)
    _, ds = p_ds(qr, kr)
    dq[:, qr] = torch.einsum("bhqk,bkhd->bqhd", ds, kf[:, kr]) * scale
    kr = tile_of(S // 2)
    qr = tile_of(min(S - 1, kr.stop + window - 2) if window > 0 else S - 1)
    p, ds = p_ds(qr, kr)
    n = kr.stop - kr.start
    dk[:, kr] = (torch.einsum("bhqk,bqhd->bkhd", ds, qf[:, qr]) * scale
                 ).reshape(B, n, KV, H // KV, hd).sum(3)
    dv[:, kr] = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(),
                             gf[:, qr]).reshape(B, n, KV, H // KV, hd).sum(3)
    return dq, dk, dv


def lm_phase(torch, np, dev, zero_counts, read_counts) -> dict:
    """Phase 8: the flash kernel against its plain version and timed, then
    gemma3-1b at full width through make_prefill_step, the decode path and
    serve_demo.  Returns the kernel's row of the ``kernels`` line."""
    import torch.nn.functional as F

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS
    from repro_torch.launch.serve import prefill_into_cache, serve_demo
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T

    bf16, f32 = torch.bfloat16, torch.float32
    tol = {f32: 2e-5, bf16: 2e-2}         # tests/test_kernels.py:61
    gen = torch.Generator(device=dev).manual_seed(7)

    def qkv(B, S, H, KV, hd, dtype):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]

    # -- the kernel against its plain version ---------------------------
    max_err = 0.0
    cases = [("gemma3-1b", 4, 2048, 4, 1, 256, w, dt)
             for w in (512, 0) for dt in (bf16, f32)]
    cases += [("hymba-1.5b", 1, 2048, 25, 5, 64, 1024, dt)
              for dt in (bf16, f32)]
    cases += [("hymba-1.5b prefill", 4, 2048, 25, 5, 64, w, bf16)
              for w in (1024, 0)]
    cases += [("smoke", 2, 40, 4, 1, 16, w, dt) for w in (16, 0)
              for dt in (bf16, f32)]
    cases += [("ragged", 1, 77, 4, 2, 64, 0, f32),
              ("ragged", 2, 77, 8, 8, 128, 16, bf16),
              ("ragged", 1, 1000, 4, 4, 32, 100, f32),
              ("ragged", 2, 1000, 4, 1, 256, 512, bf16)]
    # lengths that end inside, or just past, a 128-row query tile
    cases += [("ragged", 1, S, 4, 1, hd, 0, bf16)
              for S in (1, 129, 1000) for hd in (64, 256)]
    for name, B, S, H, KV, hd, w, dt in cases:
        q, k, v = qkv(B, S, H, KV, hd, dt)
        got = flash.flash_attention_fwd(q, k, v, window=w).float()
        want = flash.flash_attention_plain(q, k, v, window=w).float()
        torch.cuda.synchronize()
        diff = (got - want).abs()
        bad = int((diff > tol[dt] + tol[dt] * want.abs()).sum())
        e = float(diff.max())
        print(f"flash_attention {name} [B {B}, S {S}, H {H}, KV {KV}, hd "
              f"{hd}] window {w} {str(dt)[6:]}: max abs err {e:.3g} "
              f"(tolerance {tol[dt]} + {tol[dt]}·|plain|)")
        if bad or not torch.isfinite(got).all():
            raise AssertionError(f"flash_attention {name}: {bad} values "
                                 "differ from the plain version")
        max_err = max(max_err, e)
        del q, k, v, got, want, diff

    # -- timed at gemma3-1b's two layer shapes (bf16, the model's type) --
    B, S, H, KV, hd = 4, 2048, 4, 1, 256
    q, k, v = qkv(B, S, H, KV, hd, bf16)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    idx = torch.arange(S, device=dev)
    timing = {}
    for w in (512, 0):
        if w:
            mask = (idx[None, :] <= idx[:, None]) & (
                idx[None, :] > idx[:, None] - w)

            def sdpa(mask=mask):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
        else:
            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
        plain = flash.flash_attention_plain(q, k, v, window=w).float()
        e = float((sdpa().transpose(1, 2).float() - plain).abs().max())
        flops = 4 * B * H * hd * _live_pairs(S, w)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        bnd = {"operations": flops / PEAK_FLOPS * 1e3,
               "bytes": nbytes / HBM_BW * 1e3}
        by = max(bnd, key=bnd.get)
        t = dict(
            ms=_cuda_ms(torch, lambda w=w: flash.flash_attention_fwd(
                q, k, v, window=w)),
            plain_ms=_cuda_ms(torch, lambda w=w: flash.flash_attention_plain(
                q, k, v, window=w), reps=3),
            library_ms=_cuda_ms(torch, sdpa),
            bound_ms=bnd[by], bound_by=by, window=w,
            shape=[B, S, H, KV, hd])
        print(f"flash_attention [{B}, {S}, {H}/{KV}, {hd}] window {w} bf16: "
              f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA "
              f"{t['library_ms']:.4f} ms (max abs err vs plain {e:.3g}), "
              f"bound {t['bound_ms']:.4f} ms ({by}; {flops:.3g} flops, "
              f"{nbytes} bytes); the kernel at "
              f"{t['ms'] / t['bound_ms']:.2f}x its bound and "
              f"{t['ms'] / t['library_ms']:.2f}x SDPA's time")
        timing[w] = t
    del q, k, v, qt, kt, vt, mask, plain

    # -- full-width prefill through make_prefill_step -------------------
    cfg = get_config("gemma3-1b")
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    torch.cuda.synchronize()
    n_params = T.param_count(params)
    print(f"gemma3-1b: {n_params} parameters in {cfg.param_dtype} drawn on "
          f"the card in {time.perf_counter() - t0:.2f} s")
    if n_params != cfg.param_count() + cfg.d_model:      # + final_ln
        raise AssertionError(f"{n_params} parameters")
    windows = [0 if (i + 1) % cfg.global_every == 0 else cfg.local_window
               for i in range(cfg.n_layers)]
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (4, 2048))).to(dev)
    step = make_prefill_step(cfg)
    step(params, {"tokens": tokens})                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    logits = step(params, {"tokens": tokens})
    enqueue = time.perf_counter() - t0     # the host's share of the wall
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    on = read_counts()
    routes = dict(flash.flash_attention_fwd.launches_by_route)
    if on["flash"] != cfg.n_layers or any(
            n for key, n in on.items() if key != "flash"):
        raise AssertionError(f"a full-width prefill launched {on}; want "
                             f"{cfg.n_layers} flash launches only")
    if routes["hopper"] != cfg.n_layers:
        raise AssertionError(f"the prefill's flash launches took the routes "
                             f"{routes}; want all {cfg.n_layers} on hopper")
    if (logits.shape != (4, cfg.vocab_size)
            or not torch.isfinite(logits).all()):
        raise AssertionError("prefill logits are not finite [4, V]")
    kernel_ms = sum(timing[w]["ms"] for w in windows)
    print(f"prefill gemma3-1b [4 x 2048] bf16: wall {wall * 1e3:.2f} ms "
          f"(the host returned from the call after {enqueue * 1e3:.2f} ms), "
          f"{4 * 2048 / wall:.0f} tokens/s, {on['flash']} flash launches "
          f"(by route {routes}); "
          f"the kernel {kernel_ms:.2f} ms = {kernel_ms / (wall * 1e3):.1%} "
          f"of the wall; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    launches = on["flash"]

    # -- the prefill against the decode path, in float32 ----------------
    REL_TOL = 1e-3     # max |prefill - decode| / max |decode|, float32
    cfg32 = cfg.replace(param_dtype="float32", activ_dtype="float32")

    def to_f32(tree):
        return ({key: to_f32(val) for key, val in tree.items()}
                if isinstance(tree, dict) else tree.float())
    params32 = to_f32(params)
    del params, logits
    torch.cuda.empty_cache()
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (2, 640))).to(dev)
    zero_counts()
    t0 = time.perf_counter()
    by_prefill = make_prefill_step(cfg32)(params32, {"tokens": tokens})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    on_prefill = read_counts()
    zero_counts()
    t0 = time.perf_counter()
    by_decode, _ = prefill_into_cache(params32, cfg32, tokens, 640)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    on_decode = read_counts()
    rel = float((by_prefill - by_decode).abs().max()
                / by_decode.abs().max())
    same = bool((by_prefill.argmax(-1) == by_decode.argmax(-1)).all())
    print(f"float32 [2 x 640]: make_prefill_step {t_prefill:.3f} s "
          f"({on_prefill['flash']} flash launches) against "
          f"prefill_into_cache {t_decode:.3f} s ({on_decode['flash']}): "
          f"relative max error {rel:.3g} (tolerance {REL_TOL}), argmax "
          f"tokens {'equal' if same else 'DIFFER'}")
    if (rel > REL_TOL or not same or on_prefill["flash"] != cfg.n_layers
            or on_decode["flash"]):
        raise AssertionError("the prefill and the decode path disagree")
    del params32, by_prefill, by_decode
    torch.cuda.empty_cache()

    # -- serve_demo at full width, twice ---------------------------------
    served = []
    for _ in range(2):
        zero_counts()
        out = serve_demo("gemma3-1b", smoke=False, batch=4, prompt_len=32,
                         new_tokens=32, device="cuda")
        on = read_counts()
        toks = out["tokens"]
        print(f"serve_demo gemma3-1b full width: prefill "
              f"{out['prefill_s']:.3f} s, decode {out['decode_s']:.3f} s, "
              f"{out['tok_per_s']:.1f} tok/s; launches {on}")
        if any(on.values()):
            raise AssertionError("serve_demo decodes with plain attention "
                                 f"only, but launched {on}")
        if toks.shape != (4, 32) or not ((toks >= 0)
                                         & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"serve_demo tokens {toks.shape} out of "
                                 "range")
        served.append(toks)
    if not np.array_equal(*served):
        raise AssertionError("two greedy serve_demo runs disagree")
    print("serve_demo: identical greedy tokens twice")

    row = dict(timing[512], launches=launches, max_abs_err=max_err)
    row["global"] = timing[0]
    return row


def hymba_phase(torch, np, dev, zero_counts, read_counts) -> dict:
    """Phase 9: the selective-scan kernel against its plain version and
    timed, then hymba-1.5b at full width through make_prefill_step, the
    decode path and serve_demo.  Returns the scan kernel's row of the
    ``kernels`` line and the flash kernel's timing at hymba's shape."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.selective_scan import kernel as scan
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS
    from repro_torch.launch.serve import prefill_into_cache, serve_demo
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import attention, layers, ssm
    from repro_torch.models import transformer as T

    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(8)
    cfg = get_config("hymba-1.5b")
    di, N = cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state
    B, S = HYMBA_PREFILL

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def scan_inputs(b, t, d, n):
        """a ∈ (0, 1], b, C, h0 as tests/test_kernels.py draws them."""
        return (torch.exp(-torch.exp(randn(b, t, d, n, scale=0.5) - 1)),
                randn(b, t, d, n, scale=0.3), randn(b, t, n),
                randn(b, d, n, scale=0.2))

    # -- the kernel against its plain version ---------------------------
    max_err = 0.0
    cases = [("hymba-1.5b prefill", (B, S, di, N), 1e-4),   # test_kernels:150
             ("smoke", (2, 40, 128, 4), 1e-4),
             ("N 4", (2, 300, 640, 4), 1e-4),
             ("ragged T", (3, 77, 100, 16), 1e-4),
             ("one step", (2, 1, 3200, 16), 1e-4),
             ("extreme decay", (1, 32, 16, 4), 1e-3)]       # :185
    for name, shape, tol in cases:
        a, b, C, h0 = scan_inputs(*shape)
        if name == "extreme decay":
            a = torch.where(torch.rand(shape, generator=gen, device=dev)
                            < 0.5, 1e-4, 0.99999)
            b = randn(*shape)
        y, h = scan.selective_scan_fwd(a, b, C, h0)
        y_p, h_p = scan.selective_scan_plain(a, b, C, h0)
        torch.cuda.synchronize()
        e = max(float((y - y_p).abs().max()), float((h - h_p).abs().max()))
        finite = bool(torch.isfinite(y).all() and torch.isfinite(h).all())
        print(f"selective_scan {name} {list(shape)}: max abs err {e:.3g} "
              f"(tolerance {tol})")
        if e > tol or not finite:
            raise AssertionError(f"selective_scan {name}: the kernel "
                                 "differs from the plain version")
        max_err = max(max_err, e)
        del a, b, C, h0, y, h, y_p, h_p

    # -- timed at the prefill's shape, beside the plain version ---------
    a, b, C, h0 = scan_inputs(B, S, di, N)
    elems = B * S * di * N
    nbytes = 4 * (2 * elems + B * S * N + 2 * B * di * N + B * S * di)
    bnd = {"bytes": nbytes / HBM_BW * 1e3,
           "operations": 4 * elems / FP32_FLOPS_PER_S * 1e3}
    by = max(bnd, key=bnd.get)
    row = dict(
        ms=_cuda_ms(torch, lambda: scan.selective_scan_fwd(a, b, C, h0)),
        plain_ms=_cuda_ms(torch, lambda: scan.selective_scan_plain(
            a, b, C, h0), reps=2, queued=False),
        library_ms=None, bound_ms=bnd[by], bound_by=by,
        shape=[B, S, di, N])
    print(f"selective_scan [{B}, {S}, {di}, {N}] float32: kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms (a Python "
          f"loop over {S} steps), library none, bound {row['bound_ms']:.4f}"
          f" ms ({by}; {nbytes} bytes, {4 * elems:.3g} flops)")
    del a, b, C, h0

    # -- the flash kernel at hymba's prefill shape (bf16) ----------------
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = (randn(B, S, n, hd).to(bf16) for n in (H, KV, KV))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    idx = torch.arange(S, device=dev)
    flash_t = {}
    for w in (cfg.local_window, 0):
        if w:
            mask = (idx[None, :] <= idx[:, None]) & (
                idx[None, :] > idx[:, None] - w)

            def sdpa(mask=mask):
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
        else:
            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
        fb = {"operations": 4 * B * H * hd * _live_pairs(S, w) / PEAK_FLOPS
              * 1e3,
              "bytes": (2 * q.numel() + k.numel() + v.numel()) * 2
              / HBM_BW * 1e3}
        fby = max(fb, key=fb.get)
        t = flash_t[w] = dict(
            ms=_cuda_ms(torch, lambda w=w: flash.flash_attention_fwd(
                q, k, v, window=w)),
            plain_ms=_cuda_ms(torch, lambda w=w: flash.flash_attention_plain(
                q, k, v, window=w), reps=3),
            library_ms=_cuda_ms(torch, sdpa),
            bound_ms=fb[fby], bound_by=fby, window=w, shape=[B, S, H, KV, hd])
        print(f"flash_attention hymba-1.5b [{B}, {S}, {H}/{KV}, {hd}] window "
              f"{w} bf16: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
              f"ms, SDPA {t['library_ms']:.4f} ms, bound {fb[fby]:.4f} ms "
              f"({fby}); the kernel at {t['ms'] / fb[fby]:.2f}x its bound "
              f"and {t['ms'] / t['library_ms']:.2f}x SDPA's time")
    del q, k, v, qt, kt, vt, mask

    # -- full-width prefill through make_prefill_step -------------------
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    torch.cuda.synchronize()
    n_params = T.param_count(params)
    print(f"hymba-1.5b: {n_params} parameters in {cfg.param_dtype} drawn on "
          f"the card in {time.perf_counter() - t0:.2f} s (config formula "
          f"{cfg.param_count()})")
    if n_params != HYMBA_TREE_PARAMS:
        raise AssertionError(f"{n_params} parameters, not the reference "
                             f"tree's {HYMBA_TREE_PARAMS}")
    windows = attention.layer_windows(cfg)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
    step = make_prefill_step(cfg)
    step(params, {"tokens": tokens})                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    logits = step(params, {"tokens": tokens})
    enqueue = time.perf_counter() - t0     # the host's share of the wall
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    on = main_path = read_counts()
    routes = dict(flash.flash_attention_fwd.launches_by_route)
    want = {"flash": cfg.n_layers, "scan": cfg.n_layers}
    if {key: n for key, n in on.items() if n} != want:
        raise AssertionError(f"a full-width prefill launched {on}; want "
                             f"{want} only")
    if routes["hopper"] != cfg.n_layers:
        raise AssertionError(f"the prefill's flash launches took the routes "
                             f"{routes}; want all {cfg.n_layers} on hopper")
    if (logits.shape != (B, cfg.vocab_size)
            or not torch.isfinite(logits).all()):
        raise AssertionError("prefill logits are not finite [4, V]")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    scan_ms = on["scan"] * row["ms"]
    flash_ms = sum(flash_t[w]["ms"] for w in windows)
    print(f"prefill hymba-1.5b [{B} x {S}] {cfg.activ_dtype}: wall "
          f"{wall * 1e3:.2f} ms (the host returned from the call after "
          f"{enqueue * 1e3:.2f} ms), {B * S / wall:.0f} tokens/s, "
          f"{on['scan']} selective_scan and {on['flash']} flash "
          f"launches (flash by route {routes}); the kernels {scan_ms:.2f} + "
          f"{flash_ms:.2f} ms = {(scan_ms + flash_ms) / (wall * 1e3):.1%} of "
          f"the wall; peak memory {peak:.2f} GiB")

    # -- where one layer's time goes (device time, one layer's inputs) ---
    p0 = T._layer(params["layers"], 0)
    x = params["embed"][tokens]
    h = layers.rmsnorm(p0["ln1"], x, cfg.rms_eps)
    u_c = randn(B, S, di).to(bf16)
    dt = torch.nn.functional.softplus(randn(B, S, di) - 2)
    A = -torch.exp(p0["ssm"]["A_log"])
    Bc = randn(B, S, N).to(bf16)

    def materialise():
        (dt[..., None] * A[None, None]).exp_()
        (dt[..., None] * Bc[:, :, None, :]).mul_(u_c[..., None])

    parts = {
        "attention branch (projections, RoPE, flash)": lambda: (
            attention.gqa_forward(p0["attn"], cfg, h, cfg.local_window)),
        "SSM branch (ssm_forward)": lambda: ssm.ssm_forward(p0["ssm"], cfg,
                                                            h),
        "  of which a = exp(dt·A), b = dt·B·u in float32": materialise,
        "  of which the selective_scan launch": None,
        "SwiGLU MLP": lambda: layers.mlp(p0["ffn"], h),
    }
    for label, fn in parts.items():
        t = row["ms"] if fn is None else _cuda_ms(torch, fn, reps=3)
        print(f"hymba-1.5b layer, {label}: {t:.3f} ms")
    del x, h, u_c, dt, Bc, logits
    torch.cuda.empty_cache()

    # -- the prefill against the decode path, in float32 ----------------
    REL_TOL = 1e-3     # max |prefill - decode| / max |decode|, float32
    cfg32 = cfg.replace(param_dtype="float32", activ_dtype="float32")

    def to_f32(tree):
        return ({key: to_f32(val) for key, val in tree.items()}
                if isinstance(tree, dict) else tree.float())
    params32 = to_f32(params)
    del params
    torch.cuda.empty_cache()
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (2, 256))).to(dev)
    zero_counts()
    t0 = time.perf_counter()
    by_prefill = make_prefill_step(cfg32)(params32, {"tokens": tokens})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    on_prefill = read_counts()
    zero_counts()
    t0 = time.perf_counter()
    by_decode, _ = prefill_into_cache(params32, cfg32, tokens, 256)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    on_decode = read_counts()
    rel = float((by_prefill - by_decode).abs().max()
                / by_decode.abs().max())
    same = bool((by_prefill.argmax(-1) == by_decode.argmax(-1)).all())
    print(f"hymba-1.5b float32 [2 x 256]: make_prefill_step {t_prefill:.3f} "
          f"s ({on_prefill['scan']} selective_scan, {on_prefill['flash']} "
          f"flash launches) against prefill_into_cache {t_decode:.3f} s "
          f"({sum(on_decode.values())} launches): relative max error "
          f"{rel:.3g} (tolerance {REL_TOL}), argmax tokens "
          f"{'equal' if same else 'DIFFER'}")
    if (rel > REL_TOL or not same or on_prefill["scan"] != cfg.n_layers
            or on_prefill["flash"] != cfg.n_layers
            or any(on_decode.values())):
        raise AssertionError("the prefill and the decode path disagree")
    del params32, by_prefill, by_decode
    torch.cuda.empty_cache()

    # -- serve_demo at full width, twice ---------------------------------
    served = []
    for _ in range(2):
        zero_counts()
        out = serve_demo("hymba-1.5b", smoke=False, batch=4, prompt_len=32,
                         new_tokens=32, device="cuda")
        on = read_counts()
        toks = out["tokens"]
        print(f"serve_demo hymba-1.5b full width: prefill "
              f"{out['prefill_s']:.3f} s, decode {out['decode_s']:.3f} s, "
              f"{out['tok_per_s']:.1f} tok/s; launches {on}")
        if any(on.values()):
            raise AssertionError("serve_demo decodes with plain attention "
                                 f"and SSM steps only, but launched {on}")
        if toks.shape != (4, 32) or not ((toks >= 0)
                                         & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"serve_demo tokens {toks.shape} out of "
                                 "range")
        served.append(toks)
    if not np.array_equal(*served):
        raise AssertionError("two greedy serve_demo runs disagree")
    print("serve_demo hymba-1.5b: identical greedy tokens twice")

    row.update(launches=main_path["scan"], max_abs_err=max_err)
    flash_row = dict(flash_t[cfg.local_window], launches=main_path["flash"])
    flash_row["global"] = flash_t[0]
    return row, flash_row


def rwkv_phase(torch, np, dev, zero_counts, read_counts) -> dict:
    """Phase 10: the wkv6 kernel against its plain version and timed, then
    rwkv6-7b at full width through make_prefill_step, the decode path and
    serve_demo.  Returns the kernel's row of the ``kernels`` line."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.rwkv6_wkv import kernel as wkv
    from repro_torch.kernels.rwkv6_wkv.ops import wkv6
    from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref
    from repro_torch.launch.roofline import HBM_BW
    from repro_torch.launch.serve import prefill_into_cache, serve_demo
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import layers, rwkv6
    from repro_torch.models import transformer as T

    gen = torch.Generator(device=dev).manual_seed(9)
    cfg = get_config("rwkv6-7b")
    H, n = cfg.n_heads, cfg.head_dim
    B, S = RWKV_PREFILL

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def wkv_inputs(b, t, h, hs):
        """r, k, v, w ∈ (0, 1), u and a non-zero s0 as
        tests/test_kernels.py:85-91 draws them."""
        return (*(randn(b, t, h, hs, scale=0.5) for _ in range(3)),
                torch.exp(-torch.exp(randn(b, t, h, hs, scale=0.5) - 1.0)),
                randn(h, hs, scale=0.5), randn(b, h, hs, hs, scale=0.1))

    def compare(got, want, what, tol):
        e = max(float((g - w).abs().max()) for g, w in zip(got, want))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        print(f"wkv6 {what}: max abs err {e:.3g} (tolerance {tol})")
        if e > tol or not finite:
            raise AssertionError(f"wkv6 {what}: the kernel differs from the "
                                 "plain version")
        return e

    # -- the kernel against its plain version ---------------------------
    max_err = 0.0
    cases = [("rwkv6-7b prefill", (B, S, H, n), 5e-4),   # test_kernels:94
             ("smoke n 16", (2, 40, 4, 16), 5e-4),
             ("n 32", (1, 96, 1, 32), 5e-4),
             ("n 8", (2, 64, 3, 8), 5e-4),
             ("ragged T", (3, 77, 5, 64), 5e-4),
             ("one step", (B, 1, H, n), 5e-4),
             ("extreme decay", (1, 64, 1, 16), 1e-3)]    # :112-125
    for name, shape, tol in cases:
        r, k, v, w, u, s0 = wkv_inputs(*shape)
        if name == "extreme decay":
            r, k, v = (randn(*shape) for _ in range(3))
            w = torch.where(torch.rand(shape, generator=gen, device=dev)
                            < 0.5, 0.01, 0.9999)
            u = torch.zeros_like(u)
        got = wkv.wkv6_fwd(r, k, v, w, u, s0)
        want = wkv6_ref(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        max_err = max(max_err, compare(got, want, f"{name} {list(shape)}",
                                       tol))
    # the whole T against two halves chained through S_final
    r, k, v, w, u, s0 = wkv_inputs(B, S, H, n)
    half = [x[:, : S // 2].contiguous() for x in (r, k, v, w)]
    rest = [x[:, S // 2:].contiguous() for x in (r, k, v, w)]
    y1, s1 = wkv.wkv6_fwd(*half, u, s0)
    y2, s2 = wkv.wkv6_fwd(*rest, u, s1)
    y, s_fin = wkv.wkv6_fwd(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    compare((torch.cat([y1, y2], dim=1), s2), (y, s_fin),
            f"[{B}, {S}, {H}, {n}] as two halves chained through S_final",
            5e-4)
    del half, rest, y1, y2, s1, s2, y, s_fin

    # -- timed at the prefill's shape, beside the plain version ---------
    elems = B * S * H * n
    nbytes = 4 * (5 * elems + 2 * B * H * n * n + H * n)
    # a step of a head: k·v and two FMAs per state element, and the u
    # term v[m]·Σ_i r[i]·u[i]·k[i] in O(n)
    flops = (5 * n * n + 5 * n) * S * B * H
    bnd = {"bytes": nbytes / HBM_BW * 1e3,
           "operations": flops / FP32_FLOPS_PER_S * 1e3}
    by = max(bnd, key=bnd.get)
    row = dict(
        ms=_cuda_ms(torch, lambda: wkv.wkv6_fwd(r, k, v, w, u, s0)),
        plain_ms=_cuda_ms(torch, lambda: wkv6_ref(r, k, v, w, u, s0),
                          reps=2, queued=False),
        library_ms=None, bound_ms=bnd[by], bound_by=by, shape=[B, S, H, n])
    print(f"wkv6 [{B}, {S}, {H}, {n}] float32: kernel {row['ms']:.4f} ms, "
          f"plain {row['plain_ms']:.4f} ms (a Python loop over {S} steps), "
          f"library none, bound {row['bound_ms']:.4f} ms ({by}; {nbytes} "
          f"bytes = {bnd['bytes']:.4f} ms, {flops:.4g} float32 flops = "
          f"{bnd['operations']:.4f} ms)")
    del r, k, v, w, u, s0

    # -- full-width prefill through make_prefill_step -------------------
    torch.cuda.empty_cache()
    print(f"rwkv6-7b: {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
          "still allocated before drawing the weights")
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    torch.cuda.synchronize()
    n_params = T.param_count(params)
    print(f"rwkv6-7b: {n_params} parameters in {cfg.param_dtype} drawn on "
          f"the card in {time.perf_counter() - t0:.2f} s (config formula "
          f"{cfg.param_count()})")
    if n_params != RWKV_TREE_PARAMS:
        raise AssertionError(f"{n_params} parameters, not the reference "
                             f"tree's {RWKV_TREE_PARAMS}")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
    step = make_prefill_step(cfg)
    step(params, {"tokens": tokens})                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    logits = step(params, {"tokens": tokens})
    enqueue = time.perf_counter() - t0     # the host's share of the wall
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    on = main_path = read_counts()
    want = {"wkv": cfg.n_layers}
    if {key: c for key, c in on.items() if c} != want or (
            wkv.wkv6_fwd.checkpoint_launches):
        raise AssertionError(f"a full-width prefill launched {on} "
                             f"({wkv.wkv6_fwd.checkpoint_launches} writing "
                             f"checkpoints); want {want} only, none writing "
                             "checkpoints")
    if (logits.shape != (B, cfg.vocab_size)
            or not torch.isfinite(logits).all()):
        raise AssertionError("prefill logits are not finite [4, V]")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    wkv_ms = on["wkv"] * row["ms"]
    print(f"prefill rwkv6-7b [{B} x {S}] {cfg.activ_dtype}: wall "
          f"{wall * 1e3:.2f} ms (the host returned from the call after "
          f"{enqueue * 1e3:.2f} ms), {B * S / wall:.0f} tokens/s, {on['wkv']} "
          f"wkv6 launches; the kernel {wkv_ms:.2f} ms = "
          f"{wkv_ms / (wall * 1e3):.1%} of the wall; peak memory "
          f"{peak:.2f} GiB")

    # -- where one layer's time goes (device time, one layer's inputs) ---
    p0 = T._layer(params["layers"], 0)
    x = params["embed"][tokens]
    h = layers.rmsnorm(p0["ln1"], x, cfg.rms_eps)
    h2 = layers.rmsnorm(p0["ln2"], x, cfg.rms_eps)
    rr, kk, vv, ww, g, s0 = rwkv6.time_mix_inputs(p0["time"], cfg, h)
    y, _ = wkv6(rr, kk, vv, ww, p0["time"]["u"], s0)
    parts = {
        "time-mix inputs (token shift, _ddlerp, decay LoRA, r/k/v/g "
        "projections)": lambda: rwkv6.time_mix_inputs(p0["time"], cfg, h),
        "WKV (float32 casts of r, k, v and the wkv6 launch)": lambda: wkv6(
            rr, kk, vv, ww, p0["time"]["u"], s0),
        "  of which the wkv6 launch": None,
        "group norm, gate and output projection": lambda: (
            rwkv6.time_mix_output(p0["time"], y, g, h)),
        "channel-mix": lambda: rwkv6.rwkv_channel_forward(p0["channel"],
                                                          cfg, h2),
    }
    for label, fn in parts.items():
        t = row["ms"] if fn is None else _cuda_ms(torch, fn, reps=3)
        print(f"rwkv6-7b layer, {label}: {t:.3f} ms")
    del x, h, h2, rr, kk, vv, ww, g, s0, y, logits
    torch.cuda.empty_cache()

    # -- the prefill against the decode path, in float32 ----------------
    # The end to end logits are printed, not gated: with random weights
    # the 32 layers amplify float32 rounding (the layer-by-layer
    # divergence printed below), so two correct orders of the same sums
    # drift apart with depth; a third chain, the prefill with the WKV in
    # its plain version, drifts from the decode path as the kernel's
    # does.  The gate holds each layer's prefill (the kernel) against the
    # decode path of that layer, one token at a time in plain code, on the
    # same input: the prefill's own hidden state.  The layer-by-layer
    # chains are gated against the two entry points' logits, so that they
    # stand for make_prefill_step and prefill_into_cache.
    REL_TOL = 1e-3     # max |prefill - decode| / max |decode|, float32
    CHAIN_TOL = 1e-5   # a chain against its entry point: the same ops
    cfg32 = cfg.replace(param_dtype="float32", activ_dtype="float32")

    def to_f32(tree):
        return ({key: to_f32(val) for key, val in tree.items()}
                if isinstance(tree, dict) else tree.float())

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def logits_of(hidden):
        h_last = layers.rmsnorm(params32["final_ln"], hidden[:, -1:],
                                cfg.rms_eps)
        return h_last[:, 0] @ params32["lm_head"].T

    params32 = to_f32(params)
    del params
    torch.cuda.empty_cache()
    B2, S2 = 2, 256
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (B2, S2))).to(dev)
    zero_counts()
    t0 = time.perf_counter()
    by_prefill = make_prefill_step(cfg32)(params32, {"tokens": tokens})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    on_prefill = read_counts()
    zero_counts()
    t0 = time.perf_counter()
    by_decode, _ = prefill_into_cache(params32, cfg32, tokens, S2)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    on_decode = read_counts()
    end_rel = rel(by_prefill, by_decode)
    end_same = bool((by_prefill.argmax(-1) == by_decode.argmax(-1)).all())
    print(f"rwkv6-7b float32 [{B2} x {S2}], end to end: make_prefill_step "
          f"{t_prefill:.3f} s ({on_prefill['wkv']} wkv6 launches) against "
          f"prefill_into_cache {t_decode:.3f} s ({sum(on_decode.values())} "
          f"launches): relative max error {end_rel:.3g}, argmax tokens "
          f"{'equal' if end_same else 'DIFFER'} (printed, not gated)")
    if on_prefill["wkv"] != cfg.n_layers or any(on_decode.values()):
        raise AssertionError(f"launches {on_prefill} in the prefill, "
                             f"{on_decode} in the decode path")

    def decode_layer(p_layer, x):
        """One layer's decode path over x, one token at a time."""
        cache = rwkv6.rwkv_init_state(cfg32, B2, torch.float32, dev)
        return torch.cat([T._block_decode(cfg32, p_layer, x[:, t:t + 1],
                                          cache, t, 0)[0]
                          for t in range(x.shape[1])], dim=1)

    x_p = x_d = x_pl = params32["embed"][tokens]
    worst, t0 = 0.0, time.perf_counter()
    with torch.no_grad():
        for i in range(cfg.n_layers):
            p_layer = T._layer(params32["layers"], i)
            zero_counts()
            out_p, _ = T._block_full(cfg32, p_layer, x_p, 0)
            if read_counts()["wkv"] != 1:
                raise AssertionError(f"layer {i}'s prefill launched "
                                     f"{read_counts()}")
            out_tf = decode_layer(p_layer, x_p)
            if i == cfg.n_layers - 1:
                tf_logits = (logits_of(out_p), logits_of(out_tf))
            e = rel(out_p, out_tf)
            worst = max(worst, e)
            with mock.patch.object(rwkv6, "wkv6", wkv6_ref):
                x_pl, _ = T._block_full(cfg32, p_layer, x_pl, 0)
            x_p, x_d = out_p, decode_layer(p_layer, x_d)
            if i % 4 == 0 or i == cfg.n_layers - 1:
                print(f"rwkv6-7b float32 layer {i}: prefill against the "
                      f"decode path on the same input {e:.3g}; end to end "
                      f"the prefill runs {rel(x_p, x_d):.3g} and the plain "
                      f"prefill {rel(x_pl, x_d):.3g} from the decode path")
    tf_rel = rel(*tf_logits)
    tf_same = bool((tf_logits[0].argmax(-1) == tf_logits[1].argmax(-1)).all())
    chain_p = rel(logits_of(x_p), by_prefill)
    chain_d = rel(logits_of(x_d), by_decode)
    print(f"rwkv6-7b float32 [{B2} x {S2}], layer by layer "
          f"({time.perf_counter() - t0:.1f} s): worst relative error "
          f"{worst:.3g} over {cfg.n_layers} layers, last layer's logits "
          f"{tf_rel:.3g} (tolerance {REL_TOL}), argmax tokens "
          f"{'equal' if tf_same else 'DIFFER'}; the chains against "
          f"make_prefill_step {chain_p:.3g} and prefill_into_cache "
          f"{chain_d:.3g} (tolerance {CHAIN_TOL}); end to end, the plain "
          f"prefill's logits {rel(logits_of(x_pl), by_decode):.3g} and the "
          f"kernel's {end_rel:.3g} from the decode path's (printed)")
    if worst > REL_TOL or tf_rel > REL_TOL or not tf_same:
        raise AssertionError("the prefill and the decode path disagree")
    if chain_p > CHAIN_TOL or chain_d > CHAIN_TOL:
        raise AssertionError("the layer-by-layer chains do not compute "
                             "what the entry points compute")
    del params32, by_prefill, by_decode, x_p, x_d, x_pl, out_p, out_tf
    del tf_logits
    torch.cuda.empty_cache()

    # -- serve_demo at full width, twice ---------------------------------
    served = []
    for _ in range(2):
        zero_counts()
        out = serve_demo("rwkv6-7b", smoke=False, batch=4, prompt_len=32,
                         new_tokens=32, device="cuda")
        on = read_counts()
        toks = out["tokens"]
        print(f"serve_demo rwkv6-7b full width: prefill "
              f"{out['prefill_s']:.3f} s, decode {out['decode_s']:.3f} s, "
              f"{out['tok_per_s']:.1f} tok/s; launches {on}")
        if any(on.values()) or wkv.wkv6_fwd.checkpoint_launches:
            raise AssertionError("serve_demo steps the WKV state in plain "
                                 f"code only, but launched {on}")
        if toks.shape != (4, 32) or not ((toks >= 0)
                                         & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"serve_demo tokens {toks.shape} out of "
                                 "range")
        served.append(toks)
        torch.cuda.empty_cache()
    if not np.array_equal(*served):
        raise AssertionError("two greedy serve_demo runs disagree")
    print("serve_demo rwkv6-7b: identical greedy tokens twice")

    row.update(launches=main_path["wkv"], max_abs_err=max_err)
    return row


def _sharded_rank(rank: int, out: str, corpus: str, workdir: str,
                  device: str) -> None:
    """Phase 13b's rank ``rank`` (run by ``spawn_ranks``): the packed mine
    with a device loss and SON over the mesh, written to
    ``<out>/rank<r>.json``."""
    import numpy as np
    import torch

    from repro_torch.distributed.fault import FaultEvent, FaultPlan
    from repro_torch.distributed.mining import ShardedMiner, make_shard_mesh
    from repro_torch.kernels.support_count import fused, kernel
    from repro_torch.mining import SONConfig, SONMiner
    from repro_torch.pipeline import PipelineConfig

    if device == "cuda":
        torch.cuda.set_device(0)             # every rank shares the card
    T_all = np.load(corpus)
    mesh = make_shard_mesh()
    cfg = PipelineConfig(min_support=MIN_SUPPORT, n_tiles=N_TILES,
                         tuning=PACKED, device=device)

    def counted(fn):
        fused.support_count_packed.launches = 0
        kernel.support_count_int8.launches = 0
        t0 = time.perf_counter()
        res = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        return res, {"packed": fused.support_count_packed.launches,
                     "int8": kernel.support_count_int8.launches,
                     "wall_s": time.perf_counter() - t0}

    def answer(res):
        return {"supports": sorted([list(k), v]
                                   for k, v in res.supports.items()),
                "rules": [dataclasses.astuple(r) for r in res.rules]}

    mined, on = counted(lambda: ShardedMiner(mesh=mesh, config=cfg).run(
        T_all, FaultPlan([FaultEvent(2, "device_loss", 3)])))
    rep = mined.report
    r2 = [r for r in rep.rounds if r.k == 2][0]
    maps = rep.ledger.by_kind("map")
    son, son_on = counted(lambda: SONMiner(
        config=cfg, mesh=mesh, son=SONConfig(
            workdir=workdir, partition_rows=SON_PARTITION_ROWS)).run(
        T_all, {1: FaultPlan([FaultEvent(2, "device_loss", 1)])}))
    Path(out, f"rank{rank}.json").write_text(json.dumps({
        "mine": dict(answer(mined), launches=on,
                     rows_before=[8 * b for b in rep.rounds[0]
                                  .tiles_per_device],
                     rows_after=rep.shard_rows, replans=rep.replans,
                     moves=[r2.switches, r2.reissued],
                     failed=r2.failed_devices,
                     counting_rounds=sum(1 for r in rep.rounds
                                         if r.m_padded),
                     syncs=[p.syncs for p in maps]),
        "son": dict(answer(son), launches=son_on, replans=son.report.replans,
                    partitions=son.report.n_partitions)}))


def sharded_phase(torch, np, dev, T_all, packed, walls, floor_ms,
                  zero_counts, read_counts, backend="nccl",
                  slab_rows=SHARDED_SLAB_ROWS) -> dict:
    """Phase 13: the sharded plane on the card.

    a) One NCCL rank in this process (a file-store group, destroyed
       afterwards; ``backend`` is ``gloo`` only where this is rehearsed on
       the CPU): both support-count kernels held exactly against their
       plain versions at the slabs ``slab_rows`` of the dense corpus
       against phase 3's k=2 candidates (M 2,176, 256, 128) and timed
       there; ``ShardedMiner`` on ``packed``, ``mxu`` and ``ref``, each
       giving phase 3's supports and rules, one d2h and one launch of its
       kernel a counting round, and equal reports walls aside; then Eclat
       (no kernel).
    b) ``SHARDED_RANKS`` gloo ranks spawned on the same card (one card
       takes one NCCL rank, so ranks that share it reduce through gloo),
       each holding the corpus (saved once, loaded by each): the packed
       mine with ``device_loss`` of rank 3 at k=2, giving phase 3's answer
       on every rank, ``SHARDED_ROWS`` before and after and one re-plan
       of ``SHARDED_MOVES``; then SON over the mesh in phase 7's
       partitions with a device loss in partition 1.

    Returns the kernels' launches on 13a's paths, the slab timings and
    the walls."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from repro_torch.core.itemsets import (generate_candidates,
                                           itemsets_to_bitmap)
    from repro_torch.distributed.mining import ShardedMiner, make_shard_mesh
    from repro_torch.distributed.ranks import spawn_ranks
    from repro_torch.kernels.support_count import fused, kernel
    from repro_torch.launch.roofline import B1_OPS, HBM_BW, INT8_OPS
    from repro_torch.pipeline import PipelineConfig, ingest_baskets
    from repro_torch.pipeline.dataplane import pad_candidates

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    out = {"walls": {}}
    # phase 3's answer as the ranks write theirs: through JSON
    want = json.loads(json.dumps({
        "supports": sorted([list(k), v] for k, v in packed.supports.items()),
        "rules": [dataclasses.astuple(r) for r in packed.rules]}))

    # ---- a. one rank ----------------------------------------------------
    print(f"phase 13a: one {backend} rank in this process")
    with tempfile.TemporaryDirectory() as wd:
        dist.init_process_group(backend, init_method=f"file://{wd}/store",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=300))
        try:
            mesh = make_shard_mesh()
            # the group's first collective sets up its communicator: done
            # here, so that no mine's wall holds it
            t0 = time.perf_counter()
            dist.barrier(group=mesh.get_group(0))
            sync()
            out["walls"]["1 rank group set-up"] = time.perf_counter() - t0
            print(f"{backend} group set-up (first collective): "
                  f"{out['walls']['1 rank group set-up']:.3f} s")

            # the kernels at the slab shapes: phase 3's bitmap against its
            # k = 2 candidates (the first M of them at the later rounds')
            T, _, n_tx = ingest_baskets(T_all)
            counts = T.sum(axis=0, dtype=np.int64)
            min_sup = max(1, int(MIN_SUPPORT * n_tx))
            cands = generate_candidates(
                [(int(i),) for i in np.flatnonzero(counts >= min_sup)])
            C = torch.from_numpy(pad_candidates(
                itemsets_to_bitmap(cands, T.shape[1]), 128)).to(dev)
            Cw, Ci = fused.pack_words(C), C.view(torch.int8)
            sizes = C.sum(dim=1, dtype=torch.int32)
            I = T.shape[1]
            W = I // 32
            out["slabs"] = {}
            for n in slab_rows:
                # the 4-rank layout's slabs are 50,000 rows wide: the
                # fastest rank's, all real rows
                slab = torch.from_numpy(T[n_tx - n:]).to(dev)
                Tw, Ti = fused.pack_words(slab), slab.view(torch.int8)
                for m in ROUND_M:
                    for key, fn, plain, args in (
                            ("packed", fused.support_count_packed,
                             fused.support_count_packed_plain,
                             (Tw, Cw[:m], sizes[:m])),
                            ("int8", kernel.support_count_int8,
                             kernel.support_count_int8_plain,
                             (Ti, Ci[:m], sizes[:m]))):
                        got, ref = fn(*args), plain(*args)
                        sync()
                        if not torch.equal(got, ref):
                            raise AssertionError(
                                f"{key} at the slab [{n}, {m}] differs from "
                                f"its plain version in "
                                f"{int((got != ref).sum())} counts")
                        bnd = ({"operations": n * m * W * 32 / B1_OPS,
                                "bytes": (n * W * 4 + m * W * 4 + 2 * m * 4)
                                / HBM_BW} if key == "packed" else
                               {"operations": 2 * n * m * I / INT8_OPS,
                                "bytes": (n * I + m * I + 2 * m * 4)
                                / HBM_BW})
                        by = max(bnd, key=bnd.get)
                        ms = (_cuda_ms(torch, lambda: fn(*args))
                              if dev.type == "cuda" else None)
                        out["slabs"].setdefault(key, {})[f"{n}x{m}"] = dict(
                            ms=ms, bound_ms=bnd[by] * 1e3, bound_by=by)
                        if ms is not None:
                            print(f"{key} at the slab [{n}, {m}]: kernel "
                                  f"{ms:.4f} ms ({ms / floor_ms:.1f}x the "
                                  f"launch floor), bound "
                                  f"{bnd[by] * 1e3:.5f} ms ({by})")
                del slab, Tw, Ti
            print("both support-count kernels match their plain versions "
                  f"exactly at the slabs {list(slab_rows)} x M {ROUND_M}")

            # the three kernel paths and Eclat
            reports, launches = {}, {}
            for label, kw in (("packed", {"tuning": PACKED}),
                              ("mxu", {"tuning": {"variant": "mxu"}}),
                              ("ref", {"data_plane": "ref"}),
                              ("eclat", {"algorithm": "eclat",
                                         "tuning": PACKED})):
                miner = ShardedMiner(mesh=mesh, config=PipelineConfig(
                    min_support=MIN_SUPPORT, n_tiles=N_TILES,
                    device=dev.type, **kw))
                zero_counts()
                t0 = time.perf_counter()
                res = miner.run(T_all)
                sync()
                wall = time.perf_counter() - t0
                on = read_counts()
                rep = res.report
                maps = rep.ledger.by_kind("map")
                counting = sum(1 for r in rep.rounds if r.m_padded)
                out["walls"][f"1 rank {label}"] = wall
                # the in-core mine of the same path (phase 3; phase 4 for
                # Eclat on the intersect kernel)
                in_core = walls.get("eclat cuda" if label == "eclat"
                                    else "apriori " + label, float("nan"))
                print(f"sharded 1 rank {label}: {len(rep.rounds)} rounds, "
                      f"{counting} counting rounds, syncs "
                      f"{[p.syncs for p in maps]}, wall {wall:.3f} s "
                      f"(in core {in_core:.3f} s); launches {on}")
                if res.supports != packed.supports or \
                        res.rules != packed.rules:
                    raise AssertionError(f"sharded {label} differs from "
                                         "phase 3's mine")
                if any(p.syncs != 1 for p in maps):
                    raise AssertionError(f"sharded {label}: one d2h a "
                                         "counting round")
                kern = {"packed": "packed", "mxu": "int8"}.get(label)
                if any(v for k, v in on.items() if k != kern) or (
                        kern and on[kern] != counting):
                    raise AssertionError(
                        f"sharded {label} must launch its kernel once a "
                        f"counting round ({counting}) and no other: {on}")
                if kern:
                    launches[kern] = on[kern]
                if label != "eclat":
                    reports[label] = dict(_without_walls(rep),
                                          backend="cuda")
            if not reports["packed"] == reports["mxu"] == reports["ref"]:
                raise AssertionError("the sharded reports differ between "
                                     "kernel paths")
            host_profile("sharded 1 rank packed mine", ShardedMiner(
                mesh=mesh, config=PipelineConfig(
                    min_support=MIN_SUPPORT, tuning=PACKED,
                    device=dev.type)).run, T_all)
            out["launches"] = launches
            print("sharded 1 rank: packed, mxu and ref give phase 3's "
                  "answer with equal reports; Eclat too, launching no "
                  "kernel")
        finally:
            dist.destroy_process_group()

    # ---- b. ranks sharing the card -------------------------------------
    ranks = SHARDED_RANKS
    print(f"phase 13b: {ranks} gloo ranks sharing {dev.type}:0 (one card "
          "takes one NCCL rank: ranks that share it reduce through gloo)")
    with tempfile.TemporaryDirectory() as wd:
        np.save(f"{wd}/corpus.npy", T_all)
        t0 = time.perf_counter()
        spawn_ranks(_sharded_rank, ranks,
                    args=(wd, f"{wd}/corpus.npy", f"{wd}/son", dev.type),
                    store=f"{wd}/store", timeout_s=600)
        out["walls"][f"{ranks} ranks, spawn to exit"] = (time.perf_counter()
                                                         - t0)
        got = [json.loads(Path(wd, f"rank{r}.json").read_text())
               for r in range(ranks)]
    for r, g in enumerate(got):
        mine, son = g["mine"], g["son"]
        print(f"rank {r}: mine wall {mine['launches']['wall_s']:.3f} s "
              f"(in core {walls.get('apriori packed', float('nan')):.3f} "
              "s), "
              f"rows {mine['rows_before']} -> {mine['rows_after']}, "
              f"{mine['replans']} re-plan, k=2 switches/re-issued "
              f"{mine['moves']}, launches {mine['launches']}; SON wall "
              f"{son['launches']['wall_s']:.3f} s, {son['partitions']} "
              f"partitions, {son['replans']} re-plans, launches "
              f"{son['launches']}")
        if {k: mine[k] for k in want} != want:
            raise AssertionError(f"rank {r}'s sharded mine differs from "
                                 "phase 3's")
        if {k: son[k] for k in want} != want:
            raise AssertionError(f"rank {r}'s SON mine differs from "
                                 "phase 3's")
        if (tuple(mine["rows_before"]) != SHARDED_ROWS[0]
                or tuple(mine["rows_after"]) != SHARDED_ROWS[1]
                or mine["replans"] != 1 or mine["failed"] != [3]
                or tuple(mine["moves"]) != SHARDED_MOVES):
            raise AssertionError(f"rank {r}'s re-plan: {mine}")
        if (set(mine["syncs"]) != {1}
                or mine["launches"]["packed"] != mine["counting_rounds"]
                or mine["launches"]["int8"]
                or son["launches"]["packed"] <= 0
                or son["launches"]["int8"] or son["replans"] < 1):
            raise AssertionError(f"rank {r}'s syncs or launches: {g}")
        out["walls"][f"rank {r} mine"] = mine["launches"]["wall_s"]
        out["walls"][f"rank {r} son"] = son["launches"]["wall_s"]
    print(f"{ranks} ranks: phase 3's answer on every rank, rows "
          f"{list(SHARDED_ROWS[0])} -> {list(SHARDED_ROWS[1])}, "
          f"{SHARDED_MOVES[0]} switches and {SHARDED_MOVES[1]} re-issues; "
          "SON over the mesh gives phase 3's answer")
    return out


def _kernel_name(name: str) -> str:
    """A trace's kernel name without its template arguments and
    parameters: "void (anonymous namespace)::name<...>(...)" -> "name"."""
    name = name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("<")[0].split("(")[0]


def _kernel_ms(torch, fn, calls: int = 5) -> dict:
    """Device time by kernel name of one call of ``fn``, from a
    ``torch.profiler`` trace of ``calls`` calls after a warm-up: {name: ms
    a call}, each name's launches summed; empty where the trace holds no
    kernel."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "trace.json")
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            name = _kernel_name(e["name"])
            out[name] = out.get(name, 0.0) + float(e["dur"]) / 1e3 / calls
    return out


def bwd_passes(cases) -> dict:
    """The flash backward's kernels at each bf16 case of ``cases``
    (``TRAIN_BWD_CASES``' form), timed by name with ``_kernel_ms``: {"<name>
    window <w>": {"D" | "dK/dV" | "dQ": ms a call}}.  Raises where a trace
    lacks one of the three Hopper kernels."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as flash

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(16)
    out = {}
    for name, B, S, H, KV, hd, w in cases:
        q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((B, S, H, hd), (B, S, KV, hd),
                                          (B, S, KV, hd), (B, S, H, hd)))
        o, lse = flash.flash_attention_fwd(q, k, v, window=w,
                                           return_lse=True)
        by_kernel = _kernel_ms(torch, lambda: flash.flash_attention_bwd(
            q, k, v, o, lse, g, window=w), BWD_TRACE_CALLS)
        passes = {BWD_PASSES[n]: ms for n, ms in by_kernel.items()
                  if n in BWD_PASSES}
        if set(passes) != set(BWD_PASSES.values()):
            raise AssertionError(f"{name} window {w}: the trace's kernels "
                                 f"{sorted(by_kernel)} are not the three "
                                 "Hopper passes")
        out[f"{name} window {w}"] = passes
    return out


def _bwd_passes_fresh(root: Path) -> dict:
    """``bwd_passes(TRAIN_BWD_CASES)`` in a fresh Python process.  Late in
    this long run, an H100's torch.profiler sessions recorded no kernel
    launched through ctypes (the traced train step, whose torch ops come
    first, did), while a fresh process records them all."""
    import os

    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke as c; "
            "print(json.dumps(c.bwd_passes(c.TRAIN_BWD_CASES)))")
    r = subprocess.run([sys.executable, "-c", code, str(root)],
                       env={**os.environ, "PYTHONPATH": str(root / "src")},
                       capture_output=True, text=True, timeout=600)
    if r.returncode:
        raise AssertionError(f"the backward's per-pass trace failed:\n"
                             f"{r.stdout[-2000:]}{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def trace_busy(path: str, window: str) -> dict:
    """The device's busy share of a ``torch.profiler`` trace over the
    ``window`` range: the union of kernel intervals (and of kernel, copy
    and fill intervals) clipped to the range, over the range's length."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    ranges = [e for e in events if e.get("name") == window
              and e.get("cat") == "user_annotation"]
    if len(ranges) != 1:
        raise AssertionError(f"the trace holds {len(ranges)} {window} "
                             "ranges, not 1")
    t0 = float(ranges[0]["ts"])
    t1 = t0 + float(ranges[0]["dur"])

    def union(cats):
        spans = sorted((max(float(e["ts"]), t0),
                        min(float(e["ts"]) + float(e["dur"]), t1))
                       for e in events if e.get("cat") in cats
                       and e.get("ph") == "X")
        busy, end = 0.0, t0
        for s, e in spans:
            s = max(s, end)
            if e > s:
                busy += e - s
                end = e
        return busy

    by_name = {}
    for e in events:
        if e.get("cat") == "kernel":
            name = _kernel_name(e["name"])
            by_name[name] = by_name.get(name, 0) + 1
    return {"window_ms": (t1 - t0) / 1e3,
            "kernel_share": union({"kernel"}) / (t1 - t0),
            "device_share": union({"kernel", "gpu_memcpy",
                                   "gpu_memset"}) / (t1 - t0),
            "kernels": by_name}


def _cli_matrix(root: Path, device: str) -> dict:
    """Every chain of ``CLI_MATRIX`` as subprocesses, ``CLI_PARALLEL`` at
    a time: name -> [wall s of each command].  Raises on an exit code
    that is not the command's, and stops every process it started."""
    import os
    import signal
    import tempfile

    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        def start(args):
            if args[0] == "torchrun":
                head = ["-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", "1", "-m",
                        f"repro_torch.launch.{args[1]}"]
                args = args[1:]
            else:
                head = ["-m", f"repro_torch.launch.{args[0]}"]
            # without --device the commands run on the card, as a user's
            extra = [] if device == "cuda" else ["--device", device]
            return subprocess.Popen(
                [sys.executable, *head, *[a.format(tmp=tmp)
                                          for a in args[1:]], *extra],
                env=env, cwd=root, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, start_new_session=True)

        waiting = list(CLI_MATRIX.items())
        running = {}
        try:
            while waiting or running:
                while waiting and len(running) < CLI_PARALLEL:
                    name, chain = waiting.pop(0)
                    running[name] = (list(chain), start(chain[0][0]),
                                     time.perf_counter())
                    walls[name] = []
                for name, (chain, proc, t0) in list(running.items()):
                    if proc.poll() is None:
                        if time.perf_counter() - t0 > CLI_TIMEOUT_S:
                            raise AssertionError(f"{name}: no exit in "
                                                 f"{CLI_TIMEOUT_S} s")
                        continue
                    out, err = proc.communicate()
                    walls[name].append(time.perf_counter() - t0)
                    args, want = chain.pop(0)
                    if proc.returncode != want:
                        raise AssertionError(
                            f"{' '.join(args)} exited {proc.returncode}, "
                            f"not {want}:\n{out[-1500:]}\n{err[-3000:]}")
                    if "--profile-dir" in args and not list(
                            Path(tmp, "mine-trace").glob("*.pt.trace.json")):
                        raise AssertionError("--profile-dir left no "
                                             "*.pt.trace.json")
                    if chain:
                        running[name] = (chain, start(chain[0][0]),
                                         time.perf_counter())
                    else:
                        del running[name]
                time.sleep(0.05)
        finally:
            for _, proc, _ in running.values():  # a command and its ranks
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.communicate()
    return walls


def cli_phase(torch, np, dev, T_all, packed, walls, zero_counts,
              read_counts, corpus=CORPUS, partition_rows=SON_PARTITION_ROWS,
              n_queries=N_QUERIES, n_oracle=N_ORACLE,
              matrix=True) -> dict:
    """Phase 14: the port's user entry points on the card, at the dense
    corpus (``corpus``; phase 3's answer ``packed``).

    a) ``apriori`` (the minimal driver) on the support-count kernel the
       checked-in cache picks and on the plain count: phase 3's supports,
       one launch a tile a counting round on the kernel path and none on
       the plain one, one read back (``TransferMeter`` sync) a level.
    b) ``launch.mine.mine`` in this process: the default flags, ``auto``,
       ``eclat``, out of core (killed at boundary ``CLI_KILL_AFTER``, then
       resumed), sharded on ``CLI_SHARDS`` spawned gloo ranks sharing the
       card, and under ``profile_dir`` (the device's busy share of the
       traced mine); each gives phase 3's supports and rules.
    c) ``launch.recommend.recommend`` with ``n_queries`` queries,
       closed-loop and async (unpaced) under ``static`` and ``dynamic``:
       async equal to the closed loop, the first ``n_oracle`` equal to
       ``recommend_bruteforce``, rule-match launches on the kernel path.
    d) ``CLI_MATRIX`` as subprocesses (skipped when ``matrix`` is False).

    Returns the walls, each kernel's launches in (a) and in each run of
    (b) and (c), the trace's busy share and the serving rates."""
    import contextlib
    import io
    import tempfile

    from repro_torch.core.itemsets import apriori
    from repro_torch.data.baskets import BasketConfig
    from repro_torch.launch.mine import TRACE_RANGE, mine
    from repro_torch.launch.recommend import recommend, synthetic_trace
    from repro_torch.runtime import TransferMeter
    from repro_torch.serving import recommend_bruteforce

    device = dev.type
    out = {"walls": {}, "apriori_launches": {}, "cli_launches": {}}

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def timed(label, fn):
        """``fn()`` quietly, with counts zeroed just before and read just
        after: its value, wall and launches (recorded under ``label``,
        also where it raises)."""
        zero_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                res = fn()
            sync()
        finally:                      # a killed mine raises SystemExit
            wall = time.perf_counter() - t0
            on = read_counts()
            out["walls"][label] = wall
            for k, v in on.items():
                if v and not label.startswith("apriori"):
                    out["cli_launches"].setdefault(k, {})[label] = v
        return res, wall, on

    def same(res, what):
        if res.supports != packed.supports or res.rules != packed.rules:
            raise AssertionError(f"{what} differs from phase 3's mine")

    in_core = ", ".join(f"{k} {walls[k]:.3f} s" for k in
                        ("apriori packed", "apriori mxu", "apriori ref")
                        if k in walls)

    # ---- a. the minimal Apriori driver ---------------------------------
    n_tx = T_all.shape[0]
    min_abs = max(1, int(MIN_SUPPORT * n_tx))
    for use_kernel in (True, False):
        meter = TransferMeter(dev)
        res, wall, on = timed(
            f"apriori() use_kernel={use_kernel}", lambda: apriori(
                T_all, min_abs, n_tiles=N_TILES, use_kernel=use_kernel,
                device=device, meter=meter))
        if res.supports != packed.supports:
            raise AssertionError(f"apriori(use_kernel={use_kernel}) "
                                 "differs from phase 3's supports")
        counting = len(res.reports) - 1
        launched = on["packed"] + on["int8"]
        others = sum(v for k, v in on.items() if k not in ("packed", "int8"))
        print(f"apriori(use_kernel={use_kernel}): {res.levels} levels, "
              f"{counting} counting, {meter.syncs} reads back "
              f"({meter.d2h_bytes} B), {meter.h2d_bytes} B uploaded, "
              f"wall {wall:.3f} s (phase 3: {in_core}); launches {on}")
        if meter.syncs != len(res.reports):
            raise AssertionError("apriori must read back once a level")
        if others or launched != (N_TILES * counting if use_kernel else 0):
            raise AssertionError(
                f"apriori(use_kernel={use_kernel}) must launch the cached "
                f"support-count kernel once a tile a counting round "
                f"({N_TILES} x {counting}) on the kernel path and nothing "
                f"on the plain one: {on}")
        if use_kernel:
            out["apriori_launches"] = on

    # ---- b. mine() in process ------------------------------------------
    base = dict(n_tx=corpus["n_tx"], n_items=corpus["n_items"],
                seed=corpus["seed"], min_support=MIN_SUPPORT,
                n_tiles=N_TILES, top=0, device=device)
    with tempfile.TemporaryDirectory() as wd:
        for label, kw in (("mine default", {}),
                          ("mine auto", {"algorithm": "auto"}),
                          ("mine eclat", {"algorithm": "eclat"})):
            res, wall, on = timed(label, lambda: mine(**base, **kw))
            same(res, label)
            print(f"{label}: {res.report.algorithm}, wall {wall:.3f} s "
                  f"(corpus generation included); launches {on}")
            if not any(on.values()):
                raise AssertionError(f"{label} launched no kernel")
        son = dict(base, out_of_core=True, partition_rows=partition_rows,
                   son_dir=f"{wd}/son")
        try:
            timed("mine out-of-core killed",
                  lambda: mine(**son, kill_after=CLI_KILL_AFTER))
            raise AssertionError("the killed mine ran to its end")
        except SystemExit as e:
            if e.code != 3:
                raise AssertionError(f"the killed mine exited {e.code}")
        res, wall, on = timed("mine out-of-core resumed",
                              lambda: mine(**son, resume=True))
        same(res, "the resumed out-of-core mine")
        if res.report.partitions_resumed != CLI_KILL_AFTER:
            raise AssertionError(f"resumed {res.report.partitions_resumed} "
                                 f"partitions, not {CLI_KILL_AFTER}")
        print(f"mine out-of-core: killed at boundary {CLI_KILL_AFTER} "
              f"(exit 3, {out['walls']['mine out-of-core killed']:.3f} s), "
              f"resumed {res.report.partitions_resumed} partitions in "
              f"{wall:.3f} s; launches {on}")
        res, wall, _ = timed("mine sharded", lambda: mine(
            **base, sharded=True, n_shards=CLI_SHARDS))
        same(res, "the sharded mine")
        print(f"mine sharded: {CLI_SHARDS} spawned gloo ranks on "
              f"{device}, {res.report.n_shards} shards, spawn to exit "
              f"{wall:.3f} s")
        res, wall, on = timed("mine profiled", lambda: mine(
            **base, profile_dir=f"{wd}/trace"))
        same(res, "the profiled mine")
        traces = list(Path(wd, "trace").glob("*.pt.trace.json"))
        if len(traces) != 1:
            raise AssertionError(f"--profile-dir left {len(traces)} traces")
        busy = trace_busy(str(traces[0]), TRACE_RANGE)
        out["trace"] = busy
        print(f"mine profiled: wall {wall:.3f} s; trace "
              f"{traces[0].stat().st_size / 1e6:.1f} MB, the mine's range "
              f"{busy['window_ms']:.2f} ms, kernels busy "
              f"{busy['kernel_share']:.4f} of it, kernels + copies + fills "
              f"{busy['device_share']:.4f}; kernels {busy['kernels']}; "
              f"launches {on}")
        if device == "cuda" and busy["kernels"].get(
                "support_count_kernel", 0) != on["packed"] + on["int8"]:
            raise AssertionError("the trace must hold each support-count "
                                 f"launch: {busy['kernels']}, {on}")

    # ---- c. recommend() closed-loop and async --------------------------
    rbase = dict(n_tx=corpus["n_tx"], n_items=corpus["n_items"],
                 seed=corpus["seed"], min_support=MIN_SUPPORT,
                 n_queries=n_queries, top=0, device=device)
    queries, _ = synthetic_trace(BasketConfig(**corpus), n_queries,
                                 corpus["seed"] + 101)
    out["serving"] = {}
    for pol in ("static", "dynamic"):
        (closed, crep), _, on_closed = timed(
            f"recommend {pol}", lambda: recommend(**rbase, policy=pol))
        (got, arep), _, on_async = timed(
            f"recommend --async {pol}",
            lambda: recommend(**rbase, policy=pol, use_async=True))
        if got != closed:
            raise AssertionError(f"async serving ({pol}) differs from the "
                                 "closed loop")
        for q, recs in zip(queries[:n_oracle], closed):
            want = recommend_bruteforce(packed.rules,
                                        np.flatnonzero(q.payload).tolist(),
                                        crep.k)
            if recs != want:
                raise AssertionError(f"recommend ({pol}): {recs} is not the "
                                     f"brute-force oracle's {want}")
        for what, on in (("closed", on_closed), ("async", on_async)):
            if on["rm_packed"] + on["rm_int8"] <= 0:
                raise AssertionError(f"recommend {what} {pol} launched no "
                                     f"rule-match kernel: {on}")
        rates = {"closed_wall_qps": crep.wall_qps,
                 "closed_p99_sim_s": crep.p99_latency_s,
                 "async_wall_qps": arep.n_completed / arep.wall_time_s,
                 "async_sustained_sim_qps": arep.sustained_qps,
                 "async_p99_sim_s": arep.p99_latency_s}
        out["serving"][pol] = rates
        print(f"recommend {pol}: {n_queries} queries, "
              f"{sum(map(bool, closed))} non-empty, async == closed loop, "
              f"first {n_oracle} == recommend_bruteforce; closed loop "
              f"{crep.wall_qps:.0f} QPS (host wall), p99 "
              f"{crep.p99_latency_s:.4f} s (scheduler clock); async "
              f"{rates['async_wall_qps']:.0f} QPS (host wall), "
              f"{arep.sustained_qps:.1f} sustained and p99 "
              f"{arep.p99_latency_s:.4f} s (scheduler clock); launches "
              f"closed {on_closed}, async {on_async}")

    # ---- d. the CI's command lines -------------------------------------
    if matrix:
        t0 = time.perf_counter()
        cli = _cli_matrix(Path(__file__).resolve().parent, device)
        out["walls"]["command lines"] = time.perf_counter() - t0
        out["command_walls"] = cli
        for name, ws in cli.items():
            print(f"  {name}: exit as required, "
                  + " then ".join(f"{w:.1f} s" for w in ws))
        print(f"{len(cli)} command chains ({CLI_PARALLEL} at a time) in "
              f"{out['walls']['command lines']:.1f} s")
    return out


def _family_batch(torch, np, cfg, B, S, dev, seed=0):
    """A prefill batch: tokens, with bf16/float32 patch embeddings for
    vision, or frame embeddings for audio, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, cfg.activ_dtype)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S))).to(dev)}
    if cfg.frontend == "vision":
        batch["vision_embeds"] = torch.randn(
            (B, cfg.n_vision_tokens, cfg.d_model), generator=gen,
            device=dev).to(dtype)
    if cfg.frontend == "audio":
        batch = {"frames": torch.randn((B, S, cfg.d_model), generator=gen,
                                       device=dev).to(dtype)}
    return batch


def families_phase(torch, np, dev, zero_counts, read_counts) -> dict:
    """Phase 15: the flash kernel at the new families' shapes, then each
    family's model at full width (whole, or at ``FAMILIES``' depth) through
    make_prefill_step, the float32 check and the serving loop, one model
    at a time.  Returns the flash row's additions to the ``kernels``
    line."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS
    from repro_torch.launch.serve import (decode, prefill_into_cache,
                                          serve_demo)
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T

    bf16, f32 = torch.bfloat16, torch.float32
    tol = {f32: 2e-5, bf16: 2e-2}         # tests/test_kernels.py:61
    gen = torch.Generator(device=dev).manual_seed(15)

    # -- the kernel at the new shapes: against its plain version, timed --
    shapes, max_err = {}, 0.0
    for name, (B, S, H, KV, hd) in FAMILY_FLASH.items():
        for dt in (bf16, f32):
            q, k, v = (torch.randn((B, S, n, hd), generator=gen,
                                   device=dev).to(dt) for n in (H, KV, KV))
            got = flash.flash_attention_fwd(q, k, v, window=0).float()
            want = flash.flash_attention_plain(q, k, v, window=0).float()
            diff = (got - want).abs()
            bad = int((diff > tol[dt] + tol[dt] * want.abs()).sum())
            e = float(diff.max())
            print(f"flash_attention {name} [B {B}, S {S}, H {H}, KV {KV}, "
                  f"hd {hd}] window 0 {str(dt)[6:]}: max abs err {e:.3g} "
                  f"(tolerance {tol[dt]} + {tol[dt]}·|plain|)")
            if bad or not torch.isfinite(got).all():
                raise AssertionError(f"flash_attention {name}: {bad} values "
                                     "differ from the plain version")
            max_err = max(max_err, e)
            del got, want, diff
            if dt == f32:
                continue
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            flops = 4 * B * H * hd * _live_pairs(S, 0)
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
            bnd = {"operations": flops / PEAK_FLOPS * 1e3,
                   "bytes": nbytes / HBM_BW * 1e3}
            by = max(bnd, key=bnd.get)
            t = shapes[name] = dict(
                ms=_cuda_ms(torch, lambda: flash.flash_attention_fwd(
                    q, k, v, window=0)),
                plain_ms=_cuda_ms(torch, lambda: flash.flash_attention_plain(
                    q, k, v, window=0), reps=3),
                library_ms=_cuda_ms(
                    torch, lambda: torch.nn.functional
                    .scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)),
                bound_ms=bnd[by], bound_by=by, shape=[B, S, H, KV, hd])
            print(f"flash_attention {name} [{B}, {S}, {H}/{KV}, {hd}] window"
                  f" 0 bf16: kernel {t['ms']:.4f} ms, plain "
                  f"{t['plain_ms']:.4f} ms, SDPA {t['library_ms']:.4f} ms, "
                  f"bound {t['bound_ms']:.4f} ms ({by}; {flops:.3g} flops, "
                  f"{nbytes} bytes); the kernel at "
                  f"{t['ms'] / t['bound_ms']:.2f}x its bound and "
                  f"{t['ms'] / t['library_ms']:.2f}x SDPA's time")
            del qt, kt, vt
        del q, k, v
    torch.cuda.empty_cache()
    shape_of = {arch: name for name in FAMILY_FLASH
                for arch in name.split(", ")}
    launches, walls = {}, {}

    for arch, (depth, depth32, tree) in FAMILIES.items():
        full = get_config(arch)
        cfg = full.replace(n_layers=depth) if depth else full
        gqa = 0 if cfg.mla is not None else cfg.n_layers
        B, S = FAMILY_PREFILL
        cut = (f"{cfg.n_layers} of {full.n_layers} layers" if depth
               else f"all {cfg.n_layers} layers")
        t0 = time.perf_counter()
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
            0), dev)
        torch.cuda.synchronize()
        n_params = T.param_count(params)
        print(f"{arch}: {cut} at full width, {n_params} parameters in "
              f"{cfg.param_dtype} drawn on the card in "
              f"{time.perf_counter() - t0:.2f} s (the reference's tree at "
              f"this depth {tree})")
        if n_params != tree:
            raise AssertionError(f"{arch}: {n_params} parameters, not the "
                                 f"reference tree's {tree}")

        # -- full-width prefill through make_prefill_step ---------------
        batch = _family_batch(torch, np, cfg, B, S, dev)
        step = make_prefill_step(cfg)
        step(params, batch)                                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        t0 = time.perf_counter()
        logits = step(params, batch)
        enqueue = time.perf_counter() - t0   # the host's share of the wall
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        on = read_counts()
        routes = dict(flash.flash_attention_fwd.launches_by_route)
        want = {"flash": gqa} if gqa else {}
        if {key: n for key, n in on.items() if n} != want:
            raise AssertionError(f"{arch}: a full-width prefill launched "
                                 f"{on}; want {want or 'no kernel'}")
        if routes["hopper"] != gqa:
            raise AssertionError(f"{arch}: the prefill's flash launches took"
                                 f" the routes {routes}; want all {gqa} on "
                                 "hopper")
        lshape = ((B, cfg.n_codebooks, cfg.vocab_size)
                  if cfg.frontend == "audio" else (B, cfg.vocab_size))
        if tuple(logits.shape) != lshape or not torch.isfinite(
                logits).all():
            raise AssertionError(f"{arch}: prefill logits are not finite "
                                 f"{lshape}")
        launches[arch] = on["flash"]
        kernel_ms = gqa * shapes[shape_of[arch]]["ms"] if gqa else 0.0
        tokens = B * (S + cfg.n_vision_tokens)
        walls[arch] = dict(wall_ms=wall * 1e3, enqueue_ms=enqueue * 1e3,
                           layers=cfg.n_layers, tokens=tokens)
        print(f"prefill {arch} [{B} x {S}] {cfg.activ_dtype}, {cut}: wall "
              f"{wall * 1e3:.2f} ms (the host returned from the call after "
              f"{enqueue * 1e3:.2f} ms), {tokens / wall:.0f} tokens/s, "
              f"{on['flash']} flash launches (by route {routes}); the "
              f"kernel {kernel_ms:.2f} ms = {kernel_ms / (wall * 1e3):.1%} "
              f"of the wall; peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        del logits

        if cfg.moe is not None:
            # the slots the prefill drops past capacity, layer by layer
            dropped = []
            forward = moe_mod.moe_forward

            def counting(p, c, x):
                r = moe_mod.route(p, c, x)
                dropped.append((int(r.dropped), r.keep.numel()))
                return forward(p, c, x)
            with mock.patch.object(moe_mod, "moe_forward", counting):
                step(params, batch)
            cap = moe_mod.moe_capacity(S, cfg.moe.n_experts,
                                       cfg.moe.top_k,
                                       cfg.moe.capacity_factor)
            print(f"{arch} prefill at capacity_factor "
                  f"{cfg.moe.capacity_factor} (capacity {cap} slots an "
                  f"expert a row): dropped "
                  f"{sum(d for d, _ in dropped)} of "
                  f"{sum(n for _, n in dropped)} slots over "
                  f"{len(dropped)} MoE layers "
                  f"({[d for d, _ in dropped]})")
            walls[arch]["dropped"] = [d for d, _ in dropped]

        # -- the serving loop, twice, with no kernel launch -------------
        served = []
        for _ in range(2):
            zero_counts()
            if depth:
                # serve_demo draws the whole model: at a cut depth the
                # same loop runs on these weights
                prompts = torch.from_numpy(np.random.default_rng(0).integers(
                    0, cfg.vocab_size, (4, 32))).to(dev)
                t0 = time.perf_counter()
                last, cache = prefill_into_cache(params, cfg, prompts, 64)
                toks, _ = decode(params, cfg, cache, last, 32, 32)
                out = {"tokens": toks, "s": time.perf_counter() - t0}
                del cache, last
            else:
                if not served:
                    del params, batch
                    torch.cuda.empty_cache()
                out = serve_demo(arch, smoke=False, batch=4, prompt_len=32,
                                 new_tokens=32, device="cuda")
                out["s"] = out["prefill_s"] + out["decode_s"]
            on = read_counts()
            toks = out["tokens"]
            kshape = ((4, 32, cfg.n_codebooks) if cfg.frontend == "audio"
                      else (4, 32))
            loop = ("prefill_into_cache + decode" if depth
                    else "serve_demo")
            print(f"{loop} {arch} ({cut}): 32 + 32 tokens x 4 in "
                  f"{out['s']:.3f} s; launches {on}")
            if any(on.values()):
                raise AssertionError(f"{arch}: the serving loop decodes in "
                                     f"plain code only, but launched {on}")
            if toks.shape != kshape or not ((toks >= 0)
                                            & (toks < cfg.vocab_size)).all():
                raise AssertionError(f"{arch}: served tokens {toks.shape} "
                                     "out of range")
            served.append(toks)
            torch.cuda.empty_cache()
        if not np.array_equal(*served):
            raise AssertionError(f"{arch}: two greedy serves disagree")
        print(f"{arch}: identical greedy tokens twice")
        params = batch = None
        torch.cuda.empty_cache()

        # -- float32: the prefill against the decode path, or the CPU ----
        REL_TOL = 1e-3     # max |prefill - reference| / max |reference|
        cfg32 = full.replace(param_dtype="float32", activ_dtype="float32",
                             n_layers=depth32 or full.n_layers)
        if cfg32.moe is not None:
            # no slot dropped: the S = 1 decode path drops none either
            cfg32 = cfg32.replace(moe=dataclasses.replace(
                cfg32.moe, capacity_factor=cfg32.moe.n_experts
                / cfg32.moe.top_k))
        params32 = T.init_params(
            cfg32, torch.Generator(device=dev).manual_seed(0), dev)
        B32, S32 = FAMILY_F32
        batch = _family_batch(torch, np, cfg32, B32, S32, dev, seed=1)
        zero_counts()
        by_prefill = make_prefill_step(cfg32)(params32, batch)
        torch.cuda.synchronize()
        on_prefill = read_counts()
        zero_counts()
        t0 = time.perf_counter()
        if cfg.frontend is None:
            against = "prefill_into_cache on the card"
            ref, _ = prefill_into_cache(params32, cfg32, batch["tokens"],
                                        S32)
        else:
            # the decode path takes no patches and no frames: the same
            # function runs plain on the CPU
            against = "make_prefill_step on the CPU"
            ref = make_prefill_step(cfg32)(
                _tree_to(params32, "cpu"), _tree_to(batch, "cpu"))
        ref = ref.to(dev)
        t_ref = time.perf_counter() - t0
        on_ref = read_counts()
        rel = float((by_prefill - ref).abs().max() / ref.abs().max())
        same = bool((by_prefill.argmax(-1) == ref.argmax(-1)).all())
        print(f"{arch} float32 [{B32} x {S32}], {cfg32.n_layers} of "
              f"{full.n_layers} layers: make_prefill_step "
              f"({on_prefill['flash']} flash launches) against {against} "
              f"({t_ref:.3f} s, {sum(on_ref.values())} launches): relative "
              f"max error {rel:.3g} (tolerance {REL_TOL}), argmax tokens "
              f"{'equal' if same else 'DIFFER'}")
        want32 = 0 if cfg32.mla is not None else cfg32.n_layers
        if (rel > REL_TOL or not same or on_prefill["flash"] != want32
                or any(on_ref.values())):
            raise AssertionError(f"{arch}: the float32 prefill disagrees")
        walls[arch].update(f32_layers=cfg32.n_layers, f32_rel_err=rel)
        del params32, batch, by_prefill, ref
        torch.cuda.empty_cache()

    return dict(family_launches=launches, family_shapes=shapes,
                family_walls=walls, family_max_abs_err=max_err)


def bwd_window_one(torch, dev, gen) -> dict:
    """Phase 16a's float32 case at window 1 (``BWD_WINDOW_ONE``; P = 1, so
    dS = dP - D cancels to rounding): dQ and dK within rtol·||plain|| plus
    the block's cancellation bound (``bwd_cancel_bound``), dV within the
    gate, and the gate failing the planted skipped tile (at window 1 a skipped
    tile loses dV's whole tile; what it loses of dQ and dK is itself
    rounding, and is printed).  Returns the readings."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.flash_attention.ref import (
        bwd_block_err, bwd_cancel_bound)

    name, B, S, H, KV, hd, w = BWD_WINDOW_ONE
    rtol, atol = BWD_GATE["float32"]
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev)
                  for shape in ((B, S, H, hd), (B, S, KV, hd),
                                (B, S, KV, hd), (B, S, H, hd)))
    out, lse = flash.flash_attention_fwd(q, k, v, window=w, return_lse=True)
    out_p = flash.flash_attention_plain(q, k, v, window=w)
    lse_p = flash.flash_attention_lse_plain(q, k, window=w)
    got = flash.flash_attention_bwd(q, k, v, out, lse, g, window=w)
    want = flash.flash_attention_bwd_plain(q, k, v, out_p, lse_p, g,
                                           window=w)
    fault = _planted_faults(torch, q, k, v, lse_p, g, out_p, w)
    bounds = bwd_cancel_bound(q, k, v, g) + (None,)
    gate = [bwd_block_err(a, ref, rtol, atol, row_bound=b)
            for a, ref, b in zip(got, want, bounds)]
    caught = [bwd_block_err(a.float() - f, ref, rtol, atol, row_bound=b)
              for a, ref, f, b in zip(got, want, fault, bounds)]
    old = bwd_block_err(got[0], want[0], rtol, atol)
    label = (f"flash_attention_bwd {name} [{B}, {S}, {H}/{KV}, {hd}] window "
             f"{w} float32")
    print(f"{label}: dq/dk at {gate[0]:.3g}/{gate[1]:.3g} of rtol x "
          f"||plain|| + the cancellation bound (2 eps sum|dO V| |K| scale a "
          f"row), dv at {gate[2]:.3g} of its block limit; a planted skipped "
          f"tile at {caught[0]:.3g}/{caught[1]:.3g}/{caught[2]:.3g}; dq "
          f"reads {old:.3g} of the atol gate, which does not bound this "
          "cancellation")
    if max(gate) > 1:
        raise AssertionError(f"{label}: differs from the plain version")
    if max(caught) <= 1:
        raise AssertionError(f"{label}: the gate passes a planted skipped "
                             "tile")
    return dict(gate=gate, planted=caught, atol_gate_dq=old)


def scan_bwd_gate(torch, dev, gen, smi: str) -> dict:
    """Phase 16g: the selective-scan backward kernel against its plain
    version at ``SCAN_BWD_CASES``, in float32: the forward's checkpoints
    within ``SCAN_CKPT_TOL`` of the plain version's; da, db, dC and dh0
    each within ``BWD_GATE["float32"]`` in blocks of ``BWD_GATE_ROWS``
    (``bwd_block_errs``), printed as fractions of their limits; two calls
    bit-identical; each planted fault (``bwd_planted_faults``) failing the
    gate.  Then the kernel timed at the training shape (the first case)
    beside the plain version and its bound, and the forward with and
    without checkpoints.  Returns the ``kernels`` line's row."""
    from repro_torch.kernels.selective_scan import kernel as scan
    from repro_torch.kernels.selective_scan.ref import (bwd_block_errs,
                                                        bwd_planted_faults)
    from repro_torch.launch.roofline import HBM_BW

    rtol, atol = BWD_GATE["float32"]

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    max_err, timed = 0.0, None
    for name, (B, T, D, N), with_h0, with_dh in SCAN_BWD_CASES:
        a = torch.exp(-torch.exp(randn(B, T, D, N, scale=0.5) - 1))
        b, C = randn(B, T, D, N, scale=0.3), randn(B, T, N)
        h0 = randn(B, D, N, scale=0.2) * with_h0
        dy = randn(B, T, D)
        dh_last = randn(B, D, N) if with_dh else None
        label = f"selective_scan_bwd {name} {[B, T, D, N]}"
        y, h_last, hck = scan.selective_scan_fwd(a, b, C, h0,
                                                 checkpoints=True)
        y_p, h_p, hck_p = scan.selective_scan_checkpoints_plain(a, b, C, h0)
        ck_err = max(float((x - w).abs().max()) if x.numel() else 0.0
                     for x, w in ((y, y_p), (h_last, h_p), (hck, hck_p)))
        del y, h_last, y_p, h_p, hck_p
        got = scan.selective_scan_bwd(a, b, C, h0, dy, dh_last,
                                      checkpoints=hck)
        again = scan.selective_scan_bwd(a, b, C, h0, dy, dh_last,
                                        checkpoints=hck)
        want = scan.selective_scan_bwd_plain(a, b, C, h0, dy, dh_last)
        torch.cuda.synchronize()
        for x, x2, w, part in zip(got, again, want, ("da", "db", "dC",
                                                    "dh0")):
            if not torch.equal(x, x2):
                raise AssertionError(f"{label}: {part} differs between two "
                                     "calls")
            if not torch.isfinite(x).all():
                raise AssertionError(f"{label}: {part} is not finite")
        del again
        errs = [float((x - w).abs().max()) for x, w in zip(got, want)]
        gate = bwd_block_errs(got, want, rtol, atol, BWD_GATE_ROWS)
        caught = {k: max(bwd_block_errs(f, want, rtol, atol, BWD_GATE_ROWS))
                  for k, f in bwd_planted_faults(a, b, C, h0, dy, dh_last,
                                                 got, want).items()}
        max_err = max(max_err, *errs)
        print(f"{label}: checkpoints, y and h_last at {ck_err:.3g} max abs "
              f"(tolerance {SCAN_CKPT_TOL}); da/db/dC/dh0 at "
              + "/".join(f"{g:.3g}" for g in gate)
              + f" of their block limit ({rtol} x ||plain|| + {atol} x "
              f"sqrt(n), blocks of {BWD_GATE_ROWS} steps), max abs err "
              + "/".join(f"{e:.3g}" for e in errs) + "; planted faults at "
              + ", ".join(f"{k} {v:.3g}" for k, v in caught.items())
              + "; two calls bit-identical")
        if ck_err > SCAN_CKPT_TOL or max(gate) > 1:
            raise AssertionError(f"{label}: differs from the plain version")
        if min(caught.values()) <= 1:
            raise AssertionError(f"{label}: the gate passes a planted fault")
        del got, want
        if timed is None:
            timed = (a, b, C, h0, dy, dh_last, hck)
        else:
            del a, b, C, h0, dy, dh_last, hck
        torch.cuda.empty_cache()

    a, b, C, h0, dy, dh_last, hck = timed
    B, T, D, N = a.shape
    elems = B * T * D * N
    # read a, b, C, h0, dy, dh_last once, write da, db, dC, dh0 once
    nbytes = 4 * (4 * elems + B * T * D + 2 * B * T * N + 3 * B * D * N)
    flops = 8 * elems
    bnd = {"bytes": nbytes / HBM_BW * 1e3,
           "operations": flops / FP32_FLOPS_PER_S * 1e3}
    by = max(bnd, key=bnd.get)
    row = dict(
        ms=_cuda_ms(torch, lambda: scan.selective_scan_bwd(
            a, b, C, h0, dy, dh_last, checkpoints=hck)),
        plain_ms=_cuda_ms(torch, lambda: scan.selective_scan_bwd_plain(
            a, b, C, h0, dy, dh_last), reps=2, queued=False),
        library_ms=None, bound_ms=bnd[by], bound_by=by, shape=[B, T, D, N],
        fwd_ms=_cuda_ms(torch, lambda: scan.selective_scan_fwd(a, b, C, h0)),
        fwd_checkpoints_ms=_cuda_ms(torch, lambda: scan.selective_scan_fwd(
            a, b, C, h0, checkpoints=True)),
        max_abs_err=max_err)
    print(f"selective_scan_bwd [{B}, {T}, {D}, {N}] float32: kernel "
          f"{row['ms']:.4f} ms ({scan.BWD_LAUNCHES_PER_CALL} launches), plain "
          f"{row['plain_ms']:.4f} ms (a Python loop over {T} steps each "
          f"way), library none, bound {row['bound_ms']:.4f} ms ({by}; "
          f"{nbytes} bytes, {flops:.3g} flops): the kernel at "
          f"{row['ms'] / row['bound_ms']:.2f}x its bound; the forward "
          f"{row['fwd_ms']:.4f} ms, with checkpoints "
          f"{row['fwd_checkpoints_ms']:.4f} ms, on {smi}")
    del timed, a, b, C, h0, dy, dh_last, hck
    torch.cuda.empty_cache()
    return row


def wkv_bwd_gate(torch, dev, gen, smi: str) -> dict:
    """Phase 16j: the wkv6 backward kernel against its plain version at
    ``WKV_BWD_CASES``, in float32: the forward's checkpoints, y and
    S_final within ``WKV_CKPT_TOL`` of the plain version's; dr, dk, dv,
    dw, du and ds0 each within ``BWD_GATE["float32"]`` in blocks of
    ``BWD_GATE_ROWS`` (``bwd_block_errs``), printed as fractions of their
    limits; two calls bit-identical; each planted fault
    (``bwd_planted_faults``) failing the gate.  Then the kernel timed at
    the training shape (the first case) beside the plain version and its
    bound, and the forward with and without checkpoints.  Returns the
    ``kernels`` line's row."""
    from repro_torch.kernels.rwkv6_wkv import kernel as wkv
    from repro_torch.kernels.rwkv6_wkv.ref import (bwd_block_errs,
                                                   bwd_planted_faults)
    from repro_torch.launch.roofline import HBM_BW

    rtol, atol = BWD_GATE["float32"]

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    max_err, timed = 0.0, None
    for name, (B, T, H, n), with_s0, with_dS, strong in WKV_BWD_CASES:
        r, k, v = (randn(B, T, H, n, scale=0.5) for _ in range(3))
        w = (0.01 + 0.49 * torch.rand((B, T, H, n), generator=gen,
                                      device=dev) if strong
             else torch.exp(-torch.exp(randn(B, T, H, n, scale=0.5) - 1)))
        u = randn(H, n, scale=0.5)
        s0 = randn(B, H, n, n, scale=0.1) * with_s0
        dy = randn(B, T, H, n)
        dS_T = randn(B, H, n, n) if with_dS else None
        label = f"wkv6_bwd {name} {[B, T, H, n]}"
        y, s_fin, ck = wkv.wkv6_fwd(r, k, v, w, u, s0, checkpoints=True)
        y_p, s_p, ck_p = wkv.wkv6_checkpoints_plain(r, k, v, w, u, s0)
        ck_err = max(float((x - p_).abs().max()) if x.numel() else 0.0
                     for x, p_ in ((y, y_p), (s_fin, s_p), (ck, ck_p)))
        del y, s_fin, y_p, s_p, ck_p
        got = wkv.wkv6_bwd(r, k, v, w, u, s0, dy, dS_T, checkpoints=ck)
        again = wkv.wkv6_bwd(r, k, v, w, u, s0, dy, dS_T, checkpoints=ck)
        want = wkv.wkv6_bwd_plain(r, k, v, w, u, s0, dy, dS_T)
        torch.cuda.synchronize()
        parts = ("dr", "dk", "dv", "dw", "du", "ds0")
        for x, x2, part in zip(got, again, parts):
            if not torch.equal(x, x2):
                raise AssertionError(f"{label}: {part} differs between two "
                                     "calls")
            if not torch.isfinite(x).all():
                raise AssertionError(f"{label}: {part} is not finite")
        del again
        errs = [float((x - p_).abs().max()) for x, p_ in zip(got, want)]
        gate = bwd_block_errs(got, want, rtol, atol, BWD_GATE_ROWS)
        caught = {f: max(bwd_block_errs(x, want, rtol, atol, BWD_GATE_ROWS))
                  for f, x in bwd_planted_faults(r, k, v, w, u, s0, dy, dS_T,
                                                 got, want).items()}
        max_err = max(max_err, *errs)
        print(f"{label}: checkpoints, y and S_final at {ck_err:.3g} max abs "
              f"(tolerance {WKV_CKPT_TOL}); {'/'.join(parts)} at "
              + "/".join(f"{g:.3g}" for g in gate)
              + f" of their block limit ({rtol} x ||plain|| + {atol} x "
              f"sqrt(n), blocks of {BWD_GATE_ROWS} steps), max abs err "
              + "/".join(f"{e:.3g}" for e in errs) + "; planted faults at "
              + ", ".join(f"{f} {x:.3g}" for f, x in caught.items())
              + "; two calls bit-identical")
        if ck_err > WKV_CKPT_TOL or max(gate) > 1:
            raise AssertionError(f"{label}: differs from the plain version")
        if min(caught.values()) <= 1:
            raise AssertionError(f"{label}: the gate passes a planted fault")
        del got, want
        if timed is None:
            timed = (r, k, v, w, u, s0, dy, dS_T, ck)
        else:
            del r, k, v, w, u, s0, dy, dS_T, ck
        torch.cuda.empty_cache()

    r, k, v, w, u, s0, dy, dS_T, ck = timed
    B, T, H, n = r.shape
    elems = B * T * H * n
    # read r, k, v, w, dy, u, s0 and dS_T once, write dr, dk, dv, dw, du
    # and ds0 once
    nbytes = 4 * (9 * elems + 3 * B * H * n * n + 2 * H * n)
    # a step of a head: the state's recurrence (k·v and an FMA) and dS's
    # (r·dy and an FMA), an FMA each for dr, dk, dv and dw, and 16 n for
    # dy·v, Σ r·u·k and the u terms of dr, dk, dv and du
    flops = (14 * n * n + 16 * n) * B * T * H
    bnd = {"bytes": nbytes / HBM_BW * 1e3,
           "operations": flops / FP32_FLOPS_PER_S * 1e3}
    by = max(bnd, key=bnd.get)
    row = dict(
        ms=_cuda_ms(torch, lambda: wkv.wkv6_bwd(
            r, k, v, w, u, s0, dy, dS_T, checkpoints=ck)),
        plain_ms=_cuda_ms(torch, lambda: wkv.wkv6_bwd_plain(
            r, k, v, w, u, s0, dy, dS_T), reps=2, queued=False),
        library_ms=None, bound_ms=bnd[by], bound_by=by, shape=[B, T, H, n],
        fwd_ms=_cuda_ms(torch, lambda: wkv.wkv6_fwd(r, k, v, w, u, s0)),
        fwd_checkpoints_ms=_cuda_ms(torch, lambda: wkv.wkv6_fwd(
            r, k, v, w, u, s0, checkpoints=True)),
        max_abs_err=max_err)
    occ = row["occupancy"] = wkv.bwd_occupancy(n)
    print(f"wkv6_bwd occupancy at n {n}: {occ['registers']} registers a "
          f"thread, {occ['static_smem_bytes'] + occ['dynamic_smem_bytes']} "
          f"bytes of shared memory a CTA of {occ['threads']} threads, "
          f"{occ['cluster']} CTAs a cluster, {B * H * occ['cluster']} CTAs "
          f"a call; {occ['ctas_per_sm']} CTAs ({occ['warps_per_sm']} warps) "
          f"an SM, {occ['active_clusters']} clusters resident on the card")
    if occ["ctas_per_sm"] < 2 or occ["warps_per_sm"] < 8:
        raise AssertionError("wkv6_bwd: fewer than 2 CTAs (8 warps) an SM "
                             f"at n {n}")
    print(f"wkv6_bwd [{B}, {T}, {H}, {n}] float32: kernel {row['ms']:.4f} "
          f"ms ({wkv.BWD_LAUNCHES_PER_CALL} launches), plain "
          f"{row['plain_ms']:.4f} ms (a Python loop over {T} steps each "
          f"way), library none, bound {row['bound_ms']:.4f} ms ({by}; "
          f"{nbytes} bytes = {bnd['bytes']:.4f} ms, {flops:.4g} float32 "
          f"flops = {bnd['operations']:.4f} ms): the kernel at "
          f"{row['ms'] / row['bound_ms']:.2f}x its bound; the forward "
          f"{row['fwd_ms']:.4f} ms, with checkpoints "
          f"{row['fwd_checkpoints_ms']:.4f} ms, on {smi}")
    del timed, r, k, v, w, u, s0, dy, dS_T, ck
    torch.cuda.empty_cache()
    return row


def train_phase(torch, np, dev, zero_counts, read_counts) -> dict:
    """Phase 16: one-card training.  The flash backward kernel against its
    plain version and timed at the training shapes; gemma3-1b whole at
    full width (bf16, ``remat_policy="full"``) through ``make_train_step``
    with exact launch counts, a bit-identical repeat and a bit-identical
    resume from a checkpoint; one float32 step against the plain
    attention's; granite-3-8b at ``GRANITE_TRAIN_LAYERS`` of 40 layers; the
    smoke CLI's falling loss; the selective-scan backward kernel against
    its plain version (``scan_bwd_gate``), hymba-1.5b whole at full width
    with exact launch counts and a bit-identical repeat, and one float32
    hymba-1.5b step against the plain scan's; the wkv6 backward kernel
    against its plain version (``wkv_bwd_gate``), rwkv6-7b at
    ``RWKV_TRAIN_LAYERS`` of 32 layers at full width with exact launch
    counts and a bit-identical repeat, and one float32 step of it, its
    backward calls against the plain backward and its gradients against
    the plain WKV's in float32 and float64.  Returns the three backward
    kernels' rows of the ``kernels`` line and the forward kernels'
    training launches."""
    import tempfile

    import torch.nn.functional as F

    from repro_torch.checkpoint import store
    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.flash_attention.ref import bwd_block_err
    from repro_torch.kernels.rwkv6_wkv import kernel as wkv
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.kernels.rwkv6_wkv.ref import (
        bwd_block_errs as wkv_block_errs)
    from repro_torch.kernels.selective_scan import kernel as scan
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS
    from repro_torch.models import attention as attn
    from repro_torch.models import rwkv6, ssm
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    bf16, f32 = torch.bfloat16, torch.float32
    per_call = flash.BWD_LAUNCHES_PER_CALL
    gen = torch.Generator(device=dev).manual_seed(16)
    smi = _nvidia_smi("name,power.limit")

    # -- 16a: the backward kernel against its plain version, timed --------
    # The plain backward is fed the plain forward's out and lse, so that
    # the oracle inherits nothing of the kernels; a planted fault (one
    # tile skipped) must fail the gate that the kernel passes.  Each pass's
    # device time comes from a fresh process's traces.
    passes_by_case = _bwd_passes_fresh(Path(__file__).resolve().parent)
    max_err, timing = 0.0, {}
    for name, B, S, H, KV, hd, w in TRAIN_BWD_CASES:
        for dt in (bf16, f32):
            label = (f"flash_attention_bwd {name} [{B}, {S}, {H}/{KV}, "
                     f"{hd}] window {w} {str(dt)[6:]}")
            rtol, atol = BWD_GATE[str(dt)[6:]]
            q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dt)
                          for shape in ((B, S, H, hd), (B, S, KV, hd),
                                        (B, S, KV, hd), (B, S, H, hd)))
            out, lse = flash.flash_attention_fwd(q, k, v, window=w,
                                                 return_lse=True)
            out_p = flash.flash_attention_plain(q, k, v, window=w)
            lse_p = flash.flash_attention_lse_plain(q, k, window=w)
            lse_err = float(((lse - lse_p).abs()
                             / (LSE_TOL * (1 + lse_p.abs()))).max())
            out_err = bwd_block_err(out, out_p, rtol, atol)
            got = flash.flash_attention_bwd(q, k, v, out, lse, g, window=w)
            again = flash.flash_attention_bwd(q, k, v, out, lse, g,
                                              window=w)
            want = flash.flash_attention_bwd_plain(q, k, v, out_p, lse_p, g,
                                                   window=w)
            fault = _planted_faults(torch, q, k, v, lse_p, g, out_p, w)
            torch.cuda.synchronize()
            errs, gate, caught = [], [], []
            for x, a, b, ref, f in zip("qkv", got, again, want, fault):
                if not torch.equal(a, b):
                    raise AssertionError(f"{label}: d{x} differs between "
                                         "two launches")
                if not torch.isfinite(a).all():
                    raise AssertionError(f"{label}: d{x} is not finite")
                errs.append(float((a.float() - ref.float()).abs().max()))
                gate.append(bwd_block_err(a, ref, rtol, atol))
                caught.append(bwd_block_err(a.float() - f, ref, rtol,
                                            atol))
            max_err = max(max_err, *errs)
            print(f"{label}: lse at {lse_err:.3g} of its tolerance ("
                  f"{LSE_TOL} x (1 + |plain|)); out and dq/dk/dv at "
                  f"{out_err:.3g} and {gate[0]:.3g}/{gate[1]:.3g}/"
                  f"{gate[2]:.3g} of their block limit ({rtol} x ||plain|| "
                  f"+ {atol} x sqrt(n)), a planted skipped tile at "
                  f"{caught[0]:.3g}/{caught[1]:.3g}/{caught[2]:.3g}; max "
                  f"abs err {errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g}; two "
                  "launches bit-identical")
            if lse_err > 1 or out_err > 1 or max(gate) > 1:
                raise AssertionError(f"{label}: differs from the plain "
                                     "version")
            if min(caught) <= 1:
                raise AssertionError(f"{label}: the gate passes a planted "
                                     "skipped tile")
            del got, again, want, fault, out_p, lse_p
            if dt is bf16:
                flops = 10 * B * H * hd * _live_pairs(S, w)
                nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
                    + lse.numel() * 4
                bnd = {"operations": flops / PEAK_FLOPS * 1e3,
                       "bytes": nbytes / HBM_BW * 1e3}
                by = max(bnd, key=bnd.get)
                held = [x.transpose(1, 2).contiguous().requires_grad_(True)
                        for x in (q, k, v)]
                if w:
                    i = torch.arange(S, device=dev)
                    mask = (i[None, :] <= i[:, None]) & (
                        i[None, :] > i[:, None] - w)
                    o_s = F.scaled_dot_product_attention(
                        *held, attn_mask=mask, enable_gqa=True)
                else:
                    o_s = F.scaled_dot_product_attention(
                        *held, is_causal=True, enable_gqa=True)
                g_s = g.transpose(1, 2).contiguous()
                passes = passes_by_case[f"{name} window {w}"]
                t = dict(
                    ms=_cuda_ms(torch, lambda: flash.flash_attention_bwd(
                        q, k, v, out, lse, g, window=w)),
                    plain_ms=_cuda_ms(
                        torch, lambda: flash.flash_attention_bwd_plain(
                            q, k, v, out, lse, g, window=w), reps=3),
                    library_ms=_cuda_ms(torch, lambda: torch.autograd.grad(
                        o_s, held, g_s, retain_graph=True)),
                    bound_ms=bnd[by], bound_by=by, window=w,
                    shape=[B, S, H, KV, hd], model=name,
                    passes_ms=passes)
                print(f"flash_attention_bwd [{B}, {S}, {H}/{KV}, {hd}] "
                      f"window {w} bf16: kernel {t['ms']:.4f} ms, plain "
                      f"{t['plain_ms']:.4f} ms, SDPA backward "
                      f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} "
                      f"ms ({by}; {flops:.3g} flops, {nbytes} bytes): the "
                      f"kernel at {t['ms'] / t['bound_ms']:.1f}x its bound "
                      f"and {t['ms'] / t['library_ms']:.2f}x SDPA's backward"
                      f" on {smi}; by pass (torch.profiler, "
                      f"{BWD_TRACE_CALLS} calls): "
                      + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                  passes.items()))
                timing[f"{name} window {w}"] = t
                del held, o_s, g_s
            del q, k, v, g, out, lse

    window_one = bwd_window_one(torch, dev, gen)
    torch.cuda.empty_cache()

    def tree_equal(a, b):
        """Leaf for leaf bit-equal, ``b`` brought to ``a``'s device a leaf
        at a time."""
        return all(torch.equal(x, y.to(x.device))
                   for x, y in zip(adamw.tree_leaves(a),
                                   adamw.tree_leaves(b)))

    def to_host(tree):
        return adamw.tree_map(lambda t: t.to("cpu"), tree)

    def run_steps(cfg, step, pipe, p, s, first, n, B, S):
        """``n`` train steps from step ``first``: (p, s, losses, walls),
        each wall ending in a synchronise."""
        losses, walls = [], []
        for i in range(first, first + n):
            batch = train_mod.make_batch_for(cfg, pipe, i, B, S, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, s, m = step(p, s, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{cfg.arch_id}: losses {losses}")
        return p, s, losses, walls

    def counted_run(cfg, label):
        """Draw ``cfg`` at full width and run ``TRAIN_STEPS`` steps with the
        counts zeroed just before and read just after."""
        B, S = TRAIN_BATCH
        t0 = time.perf_counter()
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dev)
        torch.cuda.synchronize()
        n = T.param_count(params)
        print(f"{label}: {n} parameters drawn in {time.perf_counter() - t0:.2f}"
              " s")
        opt_cfg = adamw.AdamWConfig(lr=1e-4, warmup_steps=1,
                                    total_steps=TRAIN_STEPS)
        step = steps.make_train_step(cfg, opt_cfg)
        pipe = TokenPipeline(TokenPipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=0))
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        p, s, losses, walls = run_steps(cfg, step, pipe, params,
                                        adamw.init_opt_state(params), 0,
                                        TRAIN_STEPS, B, S)
        on = read_counts()
        routes = dict(flash.flash_attention_fwd.launches_by_route)
        bwd_routes = dict(flash.flash_attention_bwd.launches_by_route)
        checkpointed = wkv.wkv6_fwd.checkpoint_launches
        peak = torch.cuda.max_memory_allocated(dev)
        if cfg.block_type == "rwkv":
            # each layer's WKV: a forward launch, again recomputed (both
            # writing checkpoints), and one backward call; no attention
            want = {"wkv": 2 * cfg.n_layers * TRAIN_STEPS,
                    "wkv_bwd": wkv.BWD_LAUNCHES_PER_CALL * cfg.n_layers
                    * TRAIN_STEPS}
        else:
            want = {"flash": 2 * cfg.n_layers * TRAIN_STEPS,
                    "flash_bwd": per_call * cfg.n_layers * TRAIN_STEPS}
        if cfg.block_type == "hybrid":
            # each layer's SSM scan: a forward launch, again recomputed,
            # and one backward call
            want.update(scan=2 * cfg.n_layers * TRAIN_STEPS,
                        scan_bwd=scan.BWD_LAUNCHES_PER_CALL * cfg.n_layers
                        * TRAIN_STEPS)
        if {k: on[k] for k in want} != want or any(
                n_ for k, n_ in on.items() if k not in want):
            raise AssertionError(f"{label}: {TRAIN_STEPS} steps launched "
                                 f"{on}; want {want} and nothing else")
        if routes["hopper"] != want.get("flash", 0):
            raise AssertionError(f"{label}: forward routes {routes}")
        if bwd_routes["hopper"] != want.get("flash_bwd", 0):
            raise AssertionError(f"{label}: backward routes {bwd_routes}")
        if checkpointed != want.get("wkv", 0):
            raise AssertionError(f"{label}: {checkpointed} wkv6 launches "
                                 f"wrote checkpoints, not all "
                                 f"{want.get('wkv', 0)}")
        steady = float(np.median(walls[1:]))
        row = dict(parameters=n, steps=TRAIN_STEPS, batch=[B, S],
                   losses=losses, step_walls_s=walls,
                   tokens_per_s=B * S / steady, peak_gib=peak / 2**30,
                   launches=on, forward_routes=routes,
                   backward_routes=bwd_routes)
        print(f"{label} train [{B} x {S}], remat {cfg.remat_policy}: losses "
              f"{[round(x, 4) for x in losses]}, step walls "
              f"{[round(x, 4) for x in walls]} s ({row['tokens_per_s']:.0f} "
              f"tokens/s after the first), peak {row['peak_gib']:.2f} GiB; "
              f"launches {on} ("
              + (f"exactly {want['flash']} forward, "
                 f"{want['flash'] // 2} of them recomputed, and "
                 f"{want['flash_bwd']} backward, {per_call} a call; backward "
                 f"routes {bwd_routes}" if "flash" in want else "")
              + (f"; {want['scan']} scan forward, half recomputed, and "
                 f"{want['scan_bwd']} scan backward, "
                 f"{scan.BWD_LAUNCHES_PER_CALL} a call"
                 if "scan" in want else "")
              + (f"exactly {want['wkv']} wkv6 forward, half recomputed, "
                 f"all writing checkpoints, and {want['wkv_bwd']} wkv6 "
                 f"backward, {wkv.BWD_LAUNCHES_PER_CALL} a call"
                 if "wkv" in want else "") + f") on {smi}")
        return row, params, step, pipe, p, s

    # -- 16b: gemma3-1b whole, bf16: counts, repeat, resume ---------------
    cfg = get_config("gemma3-1b")
    if cfg.remat_policy != "full":
        raise AssertionError(f"gemma3-1b's remat_policy {cfg.remat_policy}")
    gemma, params, step, pipe, pA, sA = counted_run(cfg, "gemma3-1b")
    # the uninterrupted run's state waits on the host, so that the card
    # holds one run's state beside a step's activations and logits
    pA, sA = to_host(pA), to_host(sA)
    torch.cuda.empty_cache()
    B, S = TRAIN_BATCH
    pB, sB, lossB, _ = run_steps(cfg, step, pipe, params,
                                 adamw.init_opt_state(params), 0,
                                 TRAIN_STEPS, B, S)
    if lossB != gemma["losses"] or not tree_equal(pA, pB) or not (
            tree_equal(sA, sB)):
        raise AssertionError("gemma3-1b: two runs from one state differ")
    del pB, sB
    torch.cuda.empty_cache()
    print(f"gemma3-1b: a second run of {TRAIN_STEPS} steps gives "
          "bit-identical losses, parameters and moments")
    pC, sC, lossC, _ = run_steps(cfg, step, pipe, params,
                                 adamw.init_opt_state(params), 0,
                                 TRAIN_SAVE_AFTER, B, S)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        store.save(d, TRAIN_SAVE_AFTER, (pC, sC), codec="raw",
                   extra={"step": TRAIN_SAVE_AFTER})
        save_s = time.perf_counter() - t0
        like = adamw.tree_map(lambda t: t.to("meta"), (pC, sC))
        t0 = time.perf_counter()
        del pC, sC
        torch.cuda.empty_cache()
        (pC, sC), extra = store.restore(d, like, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del like
        torch.cuda.empty_cache()
    pC, sC, lossC2, _ = run_steps(cfg, step, pipe, pC, sC,
                                  int(extra["step"]),
                                  TRAIN_STEPS - TRAIN_SAVE_AFTER, B, S)
    if lossC + lossC2 != gemma["losses"] or not tree_equal(pA, pC) or not (
            tree_equal(sA, sC)):
        raise AssertionError("gemma3-1b: the run resumed from its "
                             f"step-{TRAIN_SAVE_AFTER} checkpoint differs")
    gemma.update(save_s=save_s, restore_s=restore_s)
    print(f"gemma3-1b: saved at step {TRAIN_SAVE_AFTER} ({save_s:.1f} s), "
          f"restored ({restore_s:.1f} s) and continued: bit-identical to the"
          " uninterrupted run")
    # a step from the resumed state under torch.profiler (after one
    # untraced): its device time by kernel, the flash kernels' part of it
    batch = train_mod.make_batch_for(cfg, pipe, TRAIN_STEPS, B, S, dev)
    traced = _kernel_ms(torch, lambda: step(pC, sC, batch), calls=1)
    steady_ms = float(np.median(gemma["step_walls_s"][1:])) * 1e3
    if traced:
        kernel_ms = sum(traced.values())
        bwd_ms = sum(v for n, v in traced.items() if n in BWD_PASSES)
        fwd_ms = traced.get("flash_attention_hopper_kernel", 0.0)
        top = sorted(traced.items(), key=lambda kv: -kv[1])[:6]
        gemma["traced_step"] = dict(kernel_ms=kernel_ms, flash_bwd_ms=bwd_ms,
                                    flash_fwd_ms=fwd_ms, top_kernels=top)
        print(f"gemma3-1b traced step: {kernel_ms:.2f} ms of kernels "
              f"(untraced step wall {steady_ms:.2f} ms); the flash backward "
              f"{bwd_ms:.2f} ms ({bwd_ms / kernel_ms:.1%} of the kernels, "
              f"{bwd_ms / steady_ms:.1%} of the wall), the flash forward "
              f"{fwd_ms:.2f} ms; the largest: "
              + ", ".join(f"{n} {v:.2f} ms" for n, v in top))
    else:
        gemma["traced_step"] = "not measured"
        print("gemma3-1b traced step: not measured (no kernel in the trace)")
    del pA, sA, pC, sC, params, step, batch
    torch.cuda.empty_cache()

    # -- 16c: one float32 step against the plain attention's --------------
    cfg32 = get_config("gemma3-1b").replace(param_dtype="float32",
                                            activ_dtype="float32")
    p32 = T.init_params(cfg32, torch.Generator(device=dev).manual_seed(0),
                        dev)
    B32, S32 = TRAIN_F32_BATCH
    pipe32 = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg32.vocab_size, seq_len=S32, global_batch=B32, seed=0))
    batch32 = train_mod.make_batch_for(cfg32, pipe32, 0, B32, S32, dev)
    zero_counts()
    loss_k, g_k = steps._loss_and_grads(cfg32, p32, batch32)
    torch.cuda.synchronize()
    on_k = read_counts()
    routes = dict(flash.flash_attention_fwd.launches_by_route)
    bwd_routes = dict(flash.flash_attention_bwd.launches_by_route)
    if (on_k["flash"], on_k["flash_bwd"], routes["f32"],
            bwd_routes["f32"]) != (
            2 * cfg32.n_layers, per_call * cfg32.n_layers,
            2 * cfg32.n_layers, per_call * cfg32.n_layers):
        raise AssertionError(f"the float32 step launched {on_k}, {routes}, "
                             f"backward {bwd_routes}")

    def plain_attention(q, k, v, *, window=0):
        return attn.naive_attention(q, k, v, causal=True, window=window)

    zero_counts()
    with mock.patch.object(attn, "flash_attention", plain_attention):
        loss_p, g_p = steps._loss_and_grads(cfg32, p32, batch32)
    torch.cuda.synchronize()
    if any(read_counts().values()):
        raise AssertionError("the plain float32 step launched a kernel")
    worst = 0.0
    for (path, a), b in zip(store._paths(g_k), adamw.tree_leaves(g_p)):
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if rel > TRAIN_F32_TOL:
            raise AssertionError(f"float32 step: {'/'.join(path)} differs by "
                                 f"{rel:.3g} of its max |gradient|")
        worst = max(worst, rel)
    f32_row = dict(batch=[B32, S32], loss_kernel=float(loss_k),
                   loss_plain=float(loss_p), worst_leaf_rel=worst,
                   tolerance=TRAIN_F32_TOL)
    print(f"gemma3-1b float32 step [{B32} x {S32}]: loss {float(loss_k):.6f} "
          f"with the kernels, {float(loss_p):.6f} with the plain attention; "
          f"gradients within {worst:.3g} of each leaf's max |gradient| "
          f"(tolerance {TRAIN_F32_TOL})")
    del p32, g_k, g_p, batch32
    torch.cuda.empty_cache()

    # -- 16d: granite-3-8b at GRANITE_TRAIN_LAYERS of 40 layers ------------
    cfg_g = get_config("granite-3-8b").replace(n_layers=GRANITE_TRAIN_LAYERS)
    granite, *rest = counted_run(
        cfg_g, f"granite-3-8b ({GRANITE_TRAIN_LAYERS} of 40 layers)")
    del rest
    torch.cuda.empty_cache()

    # -- 16e: the smoke CLI's loss falls -----------------------------------
    zero_counts()
    t0 = time.perf_counter()
    with mock.patch.object(sys, "argv", ["train", *TRAIN_CLI]):
        hist = train_mod.main()
    cli_s = time.perf_counter() - t0
    on = read_counts()
    smoke = get_config("gemma3-1b", smoke=True)
    n_steps = int(TRAIN_CLI[TRAIN_CLI.index("--steps") + 1])
    want = {"flash": 2 * smoke.n_layers * n_steps,
            "flash_bwd": per_call * smoke.n_layers * n_steps}
    if {k: on[k] for k in want} != want:
        raise AssertionError(f"the smoke CLI launched {on}; want {want}")
    first, last = np.mean(hist["loss"][:5]), np.mean(hist["loss"][-5:])
    if not last < first - 0.1:
        raise AssertionError(f"the smoke CLI's loss fell from {first:.4f} "
                             f"to {last:.4f}, not by more than 0.1")
    cli_row = dict(argv=TRAIN_CLI, first5=float(first), last5=float(last),
                   wall_s=cli_s, launches=on)
    print(f"python -m repro_torch.launch.train {' '.join(TRAIN_CLI)}: mean "
          f"loss {first:.4f} over the first 5 steps, {last:.4f} over the "
          f"last 5 (falls by {first - last:.4f} > 0.1); {cli_s:.1f} s; "
          f"launches {on}")

    # -- 16g: the selective-scan backward kernel against its plain version -
    t_scan = time.perf_counter()
    scan_row = scan_bwd_gate(torch, dev, gen, smi)

    # -- 16h: hymba-1.5b whole, bf16: counts, repeat -----------------------
    cfg_h = get_config("hymba-1.5b")
    if cfg_h.remat_policy != "full":
        raise AssertionError(f"hymba-1.5b's remat_policy "
                             f"{cfg_h.remat_policy}")
    hymba, params, step, pipe, pA, sA = counted_run(cfg_h, "hymba-1.5b")
    if hymba["parameters"] != HYMBA_TREE_PARAMS:
        raise AssertionError(f"hymba-1.5b: {hymba['parameters']} parameters,"
                             f" not the reference tree's {HYMBA_TREE_PARAMS}")
    pA, sA = to_host(pA), to_host(sA)
    torch.cuda.empty_cache()
    pB, sB, lossB, _ = run_steps(cfg_h, step, pipe, params,
                                 adamw.init_opt_state(params), 0,
                                 TRAIN_STEPS, B, S)
    if lossB != hymba["losses"] or not tree_equal(pA, pB) or not (
            tree_equal(sA, sB)):
        raise AssertionError("hymba-1.5b: two runs from one state differ")
    print(f"hymba-1.5b: a second run of {TRAIN_STEPS} steps gives "
          "bit-identical losses, parameters and moments")
    del pA, sA
    # one more step under torch.profiler (after one untraced): its device
    # time by kernel, the scan kernels' and the flash kernels' parts
    batch = train_mod.make_batch_for(cfg_h, pipe, TRAIN_STEPS, B, S, dev)
    traced = _kernel_ms(torch, lambda: step(pB, sB, batch), calls=1)
    steady_ms = float(np.median(hymba["step_walls_s"][1:])) * 1e3
    if traced:
        kernel_ms = sum(traced.values())
        scan_ms = {k: v for k, v in traced.items()
                   if k.startswith("selective_scan")}
        flash_ms = sum(v for k, v in traced.items()
                       if k.startswith(("flash_attention", "flash_bwd")))
        top = sorted(traced.items(), key=lambda kv: -kv[1])[:8]
        hymba["traced_step"] = dict(kernel_ms=kernel_ms, scan_ms=scan_ms,
                                    flash_ms=flash_ms, top_kernels=top)
        print(f"hymba-1.5b traced step: {kernel_ms:.2f} ms of kernels "
              f"(untraced step wall {steady_ms:.2f} ms); the scan kernels "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in scan_ms.items())
              + f" ({sum(scan_ms.values()) / kernel_ms:.1%} of the kernels)"
              f", the flash kernels {flash_ms:.2f} ms; the largest: "
              + ", ".join(f"{n} {v:.2f} ms" for n, v in top))
    else:
        hymba["traced_step"] = "not measured"
        print("hymba-1.5b traced step: not measured (no kernel in the "
              "trace)")
    del pB, sB, params, step, batch
    torch.cuda.empty_cache()

    # -- 16i: one float32 hymba-1.5b step against the plain scan's ---------
    cfg_h32 = cfg_h.replace(param_dtype="float32", activ_dtype="float32")
    p32 = T.init_params(cfg_h32, torch.Generator(device=dev).manual_seed(0),
                        dev)
    Bh, Sh = HYMBA_F32_BATCH
    pipe32 = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg_h32.vocab_size, seq_len=Sh, global_batch=Bh, seed=0))
    batch32 = train_mod.make_batch_for(cfg_h32, pipe32, 0, Bh, Sh, dev)
    L = cfg_h32.n_layers
    zero_counts()
    loss_k, g_k = steps._loss_and_grads(cfg_h32, p32, batch32)
    torch.cuda.synchronize()
    on_k = read_counts()
    want_k = {"flash": 2 * L, "flash_bwd": per_call * L, "scan": 2 * L,
              "scan_bwd": scan.BWD_LAUNCHES_PER_CALL * L}
    if {k: n_ for k, n_ in on_k.items() if n_} != want_k:
        raise AssertionError(f"the float32 hymba step launched {on_k}; want "
                             f"{want_k}")

    def plain_scan(a, b, C, h0):
        return scan.selective_scan_plain(a, b, C, h0)

    zero_counts()
    with mock.patch.object(ssm, "selective_scan", plain_scan):
        loss_p, g_p = steps._loss_and_grads(cfg_h32, p32, batch32)
    torch.cuda.synchronize()
    on_p = read_counts()
    if on_p["scan"] or on_p["scan_bwd"]:
        raise AssertionError(f"the plain-scan step launched {on_p}")
    worst, worst_leaf = 0.0, ""
    for (path, a), b_ in zip(store._paths(g_k), adamw.tree_leaves(g_p)):
        rel = float((a - b_).abs().max()) / max(float(b_.abs().max()),
                                                1e-30)
        if rel > TRAIN_F32_TOL:
            raise AssertionError(f"float32 hymba step: {'/'.join(path)} "
                                 f"differs by {rel:.3g} of its max "
                                 "|gradient|")
        if rel > worst:
            worst, worst_leaf = rel, "/".join(path)
    hymba_f32 = dict(batch=[Bh, Sh], loss_kernel=float(loss_k),
                     loss_plain=float(loss_p), worst_leaf_rel=worst,
                     worst_leaf=worst_leaf, tolerance=TRAIN_F32_TOL)
    print(f"hymba-1.5b float32 step [{Bh} x {Sh}]: loss {float(loss_k):.6f} "
          f"with the scan kernels, {float(loss_p):.6f} with the plain scan "
          f"under autograd; gradients within {worst:.3g} of each leaf's max "
          f"|gradient| (worst {worst_leaf}; tolerance {TRAIN_F32_TOL}); "
          f"launches {on_k}, plain {on_p}")
    del p32, g_k, g_p, batch32
    torch.cuda.empty_cache()
    scan_wall = time.perf_counter() - t_scan
    print(f"phase 16g-16i (hymba-1.5b training) wall {scan_wall:.1f} s")
    # -- 16j: the wkv6 backward kernel against its plain version -----------
    t_wkv = time.perf_counter()
    wkv_row = wkv_bwd_gate(torch, dev, gen, smi)

    # -- 16k: rwkv6-7b at RWKV_TRAIN_LAYERS of 32 layers, bf16 -------------
    cfg_r = get_config("rwkv6-7b").replace(n_layers=RWKV_TRAIN_LAYERS)
    if cfg_r.remat_policy != "full":
        raise AssertionError(f"rwkv6-7b's remat_policy {cfg_r.remat_policy}")
    rwkv, params, step, pipe, pA, sA = counted_run(
        cfg_r, f"rwkv6-7b ({RWKV_TRAIN_LAYERS} of 32 layers)")
    pA, sA = to_host(pA), to_host(sA)
    torch.cuda.empty_cache()
    pB, sB, lossB, _ = run_steps(cfg_r, step, pipe, params,
                                 adamw.init_opt_state(params), 0,
                                 TRAIN_STEPS, B, S)
    if lossB != rwkv["losses"] or not tree_equal(pA, pB) or not (
            tree_equal(sA, sB)):
        raise AssertionError("rwkv6-7b: two runs from one state differ")
    print(f"rwkv6-7b: a second run of {TRAIN_STEPS} steps gives "
          "bit-identical losses, parameters and moments")
    del pA, sA
    # one more step under torch.profiler (after one untraced): its device
    # time by kernel, the wkv6 kernels' part
    batch = train_mod.make_batch_for(cfg_r, pipe, TRAIN_STEPS, B, S, dev)
    traced = _kernel_ms(torch, lambda: step(pB, sB, batch), calls=1)
    steady_ms = float(np.median(rwkv["step_walls_s"][1:])) * 1e3
    if traced:
        kernel_ms = sum(traced.values())
        wkv_ms = {k: v for k, v in traced.items() if k.startswith("wkv6")}
        top = sorted(traced.items(), key=lambda kv: -kv[1])[:8]
        rwkv["traced_step"] = dict(kernel_ms=kernel_ms, wkv_ms=wkv_ms,
                                   top_kernels=top)
        print(f"rwkv6-7b traced step: {kernel_ms:.2f} ms of kernels "
              f"(untraced step wall {steady_ms:.2f} ms); the wkv6 kernels "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in wkv_ms.items())
              + f" ({sum(wkv_ms.values()) / kernel_ms:.1%} of the kernels)"
              "; the largest: "
              + ", ".join(f"{n} {v:.2f} ms" for n, v in top))
    else:
        rwkv["traced_step"] = "not measured"
        print("rwkv6-7b traced step: not measured (no kernel in the trace)")
    del pB, sB, params, step, batch
    torch.cuda.empty_cache()

    # -- 16l: one float32 rwkv6-7b step against the plain WKV's -------------
    # At full width with random weights this step's gradients are
    # ill-conditioned: each head's group norm subtracts a mean that
    # dominates y, and 8 layers compound it, so the plain WKV in float32
    # and in float64 give gradients up to ~20% of a leaf's max apart
    # (measured, PERF.md §6).  So the gate holds what the kernel
    # computes inside the step: each layer's backward call, on the inputs
    # and dy the step hands it, within the float32 block gate of the plain
    # backward on the same inputs; the loss within TRAIN_F32_TOL of the
    # plain WKV's; and the step's worst leaf no further from the float64
    # WKV's step than the plain float32 WKV's step's worst leaf is, plus
    # TRAIN_F32_TOL.  The worst leaf of all three pairs is printed.
    cfg_r32 = cfg_r.replace(param_dtype="float32", activ_dtype="float32")
    p32 = T.init_params(cfg_r32, torch.Generator(device=dev).manual_seed(0),
                        dev)
    Br, Sr = RWKV_F32_BATCH
    pipe32 = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg_r32.vocab_size, seq_len=Sr, global_batch=Br, seed=0))
    batch32 = train_mod.make_batch_for(cfg_r32, pipe32, 0, Br, Sr, dev)
    L = cfg_r32.n_layers
    calls = []

    def kept_bwd(*args, **kw):
        out = wkv.wkv6_bwd(*args, **kw)
        calls.append((args, out))
        return out

    zero_counts()
    with mock.patch.object(wkv_ops, "wkv6_bwd", kept_bwd):
        loss_k, g_k = steps._loss_and_grads(cfg_r32, p32, batch32)
    torch.cuda.synchronize()
    on_k = read_counts()
    want_k = {"wkv": 2 * L, "wkv_bwd": wkv.BWD_LAUNCHES_PER_CALL * L}
    if {k: n_ for k, n_ in on_k.items() if n_} != want_k or len(calls) != L:
        raise AssertionError(f"the float32 rwkv step launched {on_k}; want "
                             f"{want_k}, one backward call a layer")
    rtol, atol = BWD_GATE["float32"]
    in_step = max(max(wkv_block_errs(out, wkv.wkv6_bwd_plain(*args), rtol,
                                     atol, BWD_GATE_ROWS))
                  for args, out in calls)
    del calls
    if in_step > 1:
        raise AssertionError(f"float32 rwkv step: a layer's wkv6 backward "
                             f"is at {in_step:.3g} of its block limit "
                             "against the plain backward on its inputs")

    def plain_wkv(r, k, v, w, u, s0):
        return wkv.wkv6_plain(r, k, v, w, u, s0)

    def plain_wkv64(r, k, v, w, u, s0):
        y, s_fin, _ = wkv.wkv6_checkpoints_plain(
            *(x.double() for x in (r, k, v, w, u, s0)))
        return y.float(), s_fin.float()

    grads = {"kernel": g_k}
    losses = {"kernel": float(loss_k)}
    for name, fn in (("plain", plain_wkv), ("float64", plain_wkv64)):
        zero_counts()
        with mock.patch.object(rwkv6, "wkv6", fn):
            loss_x, grads[name] = steps._loss_and_grads(cfg_r32, p32,
                                                        batch32)
        torch.cuda.synchronize()
        losses[name] = float(loss_x)
        if any(read_counts().values()):
            raise AssertionError(f"the {name}-WKV step launched "
                                 f"{read_counts()}")
    paths = ["/".join(path) for path, _ in store._paths(g_k)]
    leaves = {k: adamw.tree_leaves(v) for k, v in grads.items()}
    worst = {}
    for a, b_ in (("kernel", "plain"), ("kernel", "float64"),
                  ("plain", "float64")):
        rels = [float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
                for x, y in zip(leaves[a], leaves[b_])]
        i = max(range(len(rels)), key=rels.__getitem__)
        worst[f"{a} vs {b_}"] = (rels[i], paths[i])
    loss_rel = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
    rwkv_f32 = dict(batch=[Br, Sr], losses=losses, worst_leaf=worst,
                    in_step_backward_gate=in_step, loss_rel=loss_rel,
                    tolerance=TRAIN_F32_TOL)
    print(f"rwkv6-7b ({L} layers) float32 step [{Br} x {Sr}]: losses "
          + ", ".join(f"{k} {v:.6f}" for k, v in losses.items())
          + f" (kernel against plain {loss_rel:.3g}, tolerance "
          f"{TRAIN_F32_TOL}); each layer's wkv6 backward within "
          f"{in_step:.3g} of its block limit against the plain backward on "
          "its inputs; the worst leaf, as a share of its max |gradient|: "
          + ", ".join(f"{k} {v:.3g} ({n})" for k, (v, n) in worst.items())
          + f"; launches {on_k}")
    if loss_rel > TRAIN_F32_TOL:
        raise AssertionError("float32 rwkv step: the loss differs from the "
                             "plain WKV's")
    if worst["kernel vs float64"][0] > (worst["plain vs float64"][0]
                                        + TRAIN_F32_TOL):
        raise AssertionError("float32 rwkv step: the kernels' gradients sit "
                             "further from the float64 WKV's than the plain "
                             "float32 WKV's do (by more than "
                             f"{TRAIN_F32_TOL} of a leaf's max)")
    del p32, g_k, grads, leaves, batch32
    torch.cuda.empty_cache()
    wkv_wall = time.perf_counter() - t_wkv
    print(f"phase 16j-16l (rwkv6-7b training) wall {wkv_wall:.1f} s")
    wkv_row.update(
        launches=rwkv["launches"]["wkv_bwd"],
        launches_per_step=wkv.BWD_LAUNCHES_PER_CALL * cfg_r.n_layers,
        train=dict(rwkv6_7b=rwkv, float32_step=rwkv_f32, wall_s=wkv_wall))

    scan_row.update(
        launches=hymba["launches"]["scan_bwd"],
        launches_per_step=scan.BWD_LAUNCHES_PER_CALL * cfg_h.n_layers,
        train=dict(hymba_1_5b=hymba, float32_step=hymba_f32,
                   wall_s=scan_wall))

    row = dict(timing["gemma3-1b window 512"])
    row.update(window0=timing["gemma3-1b window 0"],
               shapes={k: v for k, v in timing.items()
                       if not k.startswith("gemma3-1b")},
               window1_float32=window_one,
               launches=gemma["launches"]["flash_bwd"],
               launches_by_route=gemma["backward_routes"],
               launches_per_step=per_call * cfg.n_layers,
               max_abs_err=max_err,
               train=dict(gemma3_1b=gemma, float32_step=f32_row,
                          granite_3_8b=granite, smoke_cli=cli_row))
    return dict(bwd=row, fwd_train_launches_per_step=2 * cfg.n_layers,
                scan_bwd=scan_row,
                scan_train_launches_per_step=2 * cfg_h.n_layers,
                wkv_bwd=wkv_row,
                wkv_train_launches_per_step=2 * cfg_r.n_layers)


def _leaf_draw(torch, shape, dev, rank: int):
    """Rank ``rank``'s float32 draw of one layer leaf's ``shape``, the same
    in any process."""
    gen = torch.Generator(device=dev).manual_seed(1700 + rank)
    return torch.randn(tuple(shape), generator=gen, device=dev)


def _parallel_rank(rank: int, out: str, device: str, shape) -> None:
    """Phase 17b's rank ``rank`` (run by ``spawn_ranks``, gloo, every rank
    on the one card): the (2, 2, 2) test mesh, ``hierarchical_psum`` over
    ("data", "pod") and ``psum_int8`` over "data" of this rank's draw of
    one layer leaf, saved to ``<out>/rank<r>.pt``."""
    import torch

    from repro_torch.core.compat import mesh_context
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim.compression import psum_int8

    if device == "cuda":
        torch.cuda.set_device(0)             # every rank shares the card
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    mesh = make_test_mesh(multi_pod=True)
    g = _leaf_draw(torch, shape, dev, rank)
    res = {"coordinate": list(mesh.get_coordinate())}
    with mesh_context(mesh):
        t0 = time.perf_counter()
        res["hier"] = C.hierarchical_psum(g, "data", "pod")
        if device == "cuda":
            torch.cuda.synchronize()
        res["hier_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["int8"] = psum_int8(g, "data")
        if device == "cuda":
            torch.cuda.synchronize()
        res["int8_s"] = time.perf_counter() - t0
    torch.save({k: v.cpu() if isinstance(v, torch.Tensor) else v
                for k, v in res.items()}, Path(out, f"rank{rank}.pt"))


# what gloo's TCP transport says when it is handed a CUDA tensor's device
# pointer to write to its socket: the kernel refuses it (EFAULT)
GLOO_DEVICE_POINTER = re.compile(r"pair\.cc:\d+\] writev \S+: Bad address")


def _gloo_probe_rank(rank: int, out: str, device: str, op: str) -> None:
    """One of two gloo ranks on the card running ``op``
    (``ring_all_gather`` or ``reduce_scatter_sum``) on a CUDA tensor over
    a (2,) "model" mesh.  The rank's standard error goes to
    ``<out>/probe<r>.err``: gloo writes there when it aborts the process,
    and a rank whose op raises writes its exception there and waits a
    second before raising it, so that the peer it failed gets to write
    its own first.  A result the op returns is saved to
    ``<out>/probe<r>.pt``."""
    import torch

    from repro_torch.core.compat import make_mesh, mesh_context
    from repro_torch.distributed import collectives as C

    err = os.open(Path(out, f"probe{rank}.err"),
                  os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(err, 2)
    if device == "cuda":
        torch.cuda.set_device(0)
    x = (torch.arange(32, dtype=torch.float32) + 100 * rank).reshape(8, 4)
    x = x.to(device)
    fn = C.ring_all_gather if op == "ring_all_gather" \
        else C.reduce_scatter_sum
    with mesh_context(make_mesh((2,), ("model",))):
        try:
            y = fn(x, "model")
        except Exception as e:
            print(f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
            time.sleep(1.0)
            raise
    torch.save(y.cpu(), Path(out, f"probe{rank}.pt"))


def gloo_probes(torch, dev):
    """Run the ring and the reduce-scatter on two gloo ranks holding
    ``dev`` tensors; each that runs must give the single-process result.
    ``reduce_scatter_sum`` must run.  ``ring_all_gather`` may fail only
    by gloo's TCP transport refusing a device pointer
    (``GLOO_DEVICE_POINTER`` in the exception or in either rank's
    standard error): then that message is returned, and None where the
    ring ran.  Any other failure is raised.  A refused op is named,
    never retried on host tensors."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch.multiprocessing as mp

    from repro_torch.distributed.ranks import spawn_ranks

    xs = [torch.arange(32, dtype=torch.float32).reshape(8, 4) + 100 * r
          for r in range(2)]
    want = {"ring_all_gather": [torch.cat(xs)] * 2,
            "reduce_scatter_sum": [(xs[0] + xs[1])[4 * r:4 * r + 4]
                                   for r in range(2)]}

    def run(op, wd):
        spawn_ranks(_gloo_probe_rank, 2, args=(wd, dev.type, op),
                    store=f"{wd}/store", timeout_s=60)
        got = [torch.load(Path(wd, f"probe{r}.pt")) for r in range(2)]
        if not all(torch.equal(g, w) for g, w in zip(got, want[op])):
            raise AssertionError(f"gloo {op} on {dev.type} tensors ran and "
                                 "gave a wrong result")

    def reduce_scatter():
        with tempfile.TemporaryDirectory() as wd:
            run("reduce_scatter_sum", wd)

    def ring():
        with tempfile.TemporaryDirectory() as wd:
            try:
                run("ring_all_gather", wd)
            except (mp.ProcessRaisedException,
                    mp.ProcessExitedException) as e:
                said = [str(e)] + [
                    Path(wd, f"probe{r}.err").read_text(errors="replace")
                    for r in range(2) if Path(wd, f"probe{r}.err").exists()]
                hits = [m.group(0) for m in map(GLOO_DEVICE_POINTER.search,
                                                said) if m]
                if not hits:
                    raise
                return hits[0]
        return None

    # the probes' ranks start together (each process takes seconds to
    # reach the card)
    with ThreadPoolExecutor(2) as ex:
        scattered, refused = ex.submit(reduce_scatter), ex.submit(ring)
        scattered.result()
        return refused.result()


def parallel_phase(torch, np, dev, zero_counts, read_counts,
                   backend="cpu:gloo,cuda:nccl") -> dict:
    """Phase 17: the parallel plane on the card.

    a) One NCCL rank in this process (a file-store group whose CPU tensors
       go through gloo, destroyed afterwards; ``backend`` is ``gloo`` only
       where this is rehearsed on the CPU): a (1, 1) ("data", "model")
       mesh; ``PARALLEL_ARCH`` drawn whole at full width in bf16, its
       parameters distributed by ``named(param_pspecs)`` and its AdamW
       moments by ``opt_pspecs``; one backward of ``_loss_and_grads`` on
       a ``PARALLEL_BATCH`` batch (exact flash forward and backward
       launches); ``ef_compress`` at ``PARALLEL_K_FRAC`` and ``psum_int8``
       over the whole gradient tree, each equal bit for bit to the same
       function on a CPU copy of the tree and timed; ``ring_all_gather``,
       ``reduce_scatter_sum`` and ``hierarchical_psum`` at world size 1;
       a checkpoint of the distributed parameters saved and
       ``restore_elastic`` ed onto the mesh, bit-equal, its times and bytes
       printed; the ``PARALLEL_PREFILL`` prefill with
       ``sequence_parallel=True`` under the mesh, bit-equal to the prefill
       without it, with exactly one flash launch a layer (its activations
       are plain tensors, which the hints return as they are); then
       ``sequence_shard`` and ``_expert_shard`` on replicated bf16
       DTensor activations on the mesh, which must come back with the
       reference's placements and unchanged values.
    b) ``PARALLEL_RANKS`` gloo ranks spawned on the same card as the
       (2, 2, 2) test mesh: ``hierarchical_psum`` and ``psum_int8`` of one
       full-width layer leaf, each rank's result equal bit for bit to the
       single-process sum on the card; then ``gloo_probes``: the
       reduce-scatter on two gloo ranks holding CUDA tensors must give
       the single-process result; the ring's send/recv must give it too
       or fail by gloo's transport refusing a device pointer, which is
       printed on a line of its own (never moved to host tensors).

    Returns the flash kernels' launches on 17a's paths, the times and the
    bytes."""
    import datetime
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch.distributed as dist

    from repro_torch.checkpoint import store
    from repro_torch.checkpoint.elastic import restore_elastic
    from repro_torch.configs.base import get_config
    from repro_torch.core.compat import make_mesh, mesh_context
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import meshes as M
    from repro_torch.distributed.ranks import spawn_ranks
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.optim.compression import (ef_compress,
                                               init_error_state, psum_int8)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        return res, time.perf_counter() - t0

    def leaves_equal(a, b):
        la, lb = adamw.tree_leaves(a), adamw.tree_leaves(b)
        return len(la) == len(lb) and all(
            x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
            for x, y in zip(la, lb))

    smi = _nvidia_smi("name,power.limit")
    per_call = flash.BWD_LAUNCHES_PER_CALL
    out = {"times_s": {}, "bytes": {}, "launches": {}}
    cfg = get_config(PARALLEL_ARCH)

    # ---- a. one rank ----------------------------------------------------
    print(f"phase 17a: one {backend} rank in this process")
    with tempfile.TemporaryDirectory() as wd:
        dist.init_process_group(backend, init_method=f"file://{wd}/store",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=300))
        try:
            mesh = make_mesh((1, 1), ("data", "model"))
            if mesh.device_type != dev.type:
                raise AssertionError(f"the mesh's device type "
                                     f"{mesh.device_type}, not {dev.type}")
            # the group's first collective sets up its communicator: done
            # here, so that no timed step holds it
            _, t_setup = timed(lambda: dist.all_reduce(
                torch.zeros(1, device=dev), group=mesh.get_group("data")))
            out["times_s"]["group set-up"] = t_setup
            params = T.init_params(
                cfg, torch.Generator(device=dev).manual_seed(17), dev)
            opt = adamw.init_opt_state(params)

            def distribute(tree, specs):
                return adamw.tree_map(lambda x, sh: sh.distribute(x), tree,
                                      M.named(specs, mesh))

            d_params, t_dist = timed(lambda: distribute(
                params, M.param_pspecs(cfg, params, mesh)))
            opt_specs = M.opt_pspecs(cfg, params, mesh)
            (d_mu, d_nu), t_moments = timed(lambda: (
                distribute(opt.mu, opt_specs), distribute(opt.nu, opt_specs)))
            for tree, want in ((d_params, params), (d_mu, opt.mu),
                               (d_nu, opt.nu)):
                for x, y in zip(adamw.tree_leaves(tree),
                                adamw.tree_leaves(want)):
                    if x.to_local().device != y.device or not torch.equal(
                            x.to_local(), y):
                        raise AssertionError("a distributed leaf differs "
                                             "from its parameter")
            n_params = T.param_count(params)
            out["times_s"].update(distribute=t_dist,
                                  distribute_moments=t_moments)
            print(f"{PARALLEL_ARCH}: {n_params} parameters and both moments "
                  f"distributed on the (1, 1) mesh ({t_dist:.3f} s for the "
                  f"parameters, DTensor's first use; {t_moments:.3f} s for "
                  f"the moments; the group's set-up {t_setup:.3f} s "
                  "before), each local block the whole leaf")
            del d_mu, d_nu, opt

            # one backward on a short batch: the gradient tree
            B, S = PARALLEL_BATCH
            batch = {"tokens": torch.from_numpy(
                np.random.default_rng(17).integers(
                    0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)}
            zero_counts()
            (loss, grads), t_bwd = timed(
                lambda: steps._loss_and_grads(cfg, params, batch))
            on = read_counts()
            want = {"flash": 2 * cfg.n_layers,
                    "flash_bwd": per_call * cfg.n_layers}
            if {k: on[k] for k in want} != want or any(
                    n_ for k, n_ in on.items() if k not in want):
                raise AssertionError(f"the backward launched {on}; want "
                                     f"{want} and nothing else")
            out["launches"]["backward"] = {k: on[k] for k in want}
            out["times_s"]["backward"] = t_bwd
            print(f"{PARALLEL_ARCH} backward [{B} x {S}]: loss "
                  f"{float(loss):.4f}, {t_bwd:.3f} s, launches {on}")

            # top-k error feedback and the int8 sum, card against CPU
            host = adamw.tree_map(lambda t: t.cpu(), grads)
            k_frac = PARALLEL_K_FRAC
            (comp, carry), t_ef = timed(lambda: ef_compress(
                grads, init_error_state(grads), k_frac))
            # each leaf is compressed on its own, so the CPU copy's leaves
            # go through ef_compress in threads (topk holds one core a leaf)
            with ThreadPoolExecutor(8) as ex:
                pairs_h, t_ef_h = timed(lambda: list(ex.map(
                    lambda g: ef_compress(g, init_error_state(g), k_frac),
                    adamw.tree_leaves(host))))
            comp_h = [c for c, _ in pairs_h]
            carry_h = [e for _, e in pairs_h]
            if not (leaves_equal(comp, comp_h)
                    and leaves_equal(carry, carry_h)):
                raise AssertionError("ef_compress on the card differs from "
                                     "its CPU copy's")
            del pairs_h
            kept = sum(int((x != 0).sum()) for x in adamw.tree_leaves(comp))
            n_grad = sum(x.numel() for x in adamw.tree_leaves(grads))
            del comp, carry, comp_h, carry_h
            with mesh_context(mesh):
                q, t_q = timed(lambda: adamw.tree_map(
                    lambda g: psum_int8(g, "data"), grads))
                q_h, t_q_h = timed(lambda: adamw.tree_map(
                    lambda g: psum_int8(g, "data"), host))
            if not leaves_equal(q, q_h):
                raise AssertionError("psum_int8 on the card differs from "
                                     "its CPU copy's")
            del q, q_h, host
            out["times_s"].update(ef_compress=t_ef, ef_compress_cpu=t_ef_h,
                                  psum_int8=t_q, psum_int8_cpu=t_q_h)
            out["kept"] = [kept, n_grad]
            print(f"ef_compress (k_frac {k_frac}) over {n_grad} gradient "
                  f"entries in {len(adamw.tree_leaves(grads))} leaves keeps "
                  f"{kept}: {t_ef:.3f} s on {dev.type}, {t_ef_h:.3f} s on "
                  f"the CPU (a leaf a thread, 8 threads), outputs and carry "
                  f"bit-equal; psum_int8 over the "
                  f"tree {t_q:.3f} s / {t_q_h:.3f} s, bit-equal, on {smi}")

            # the collectives at world size 1
            x = adamw.tree_leaves(grads)[0]
            with mesh_context(mesh):
                for name, fn in (
                        ("ring_all_gather",
                         lambda: C.ring_all_gather(x, "model")),
                        ("reduce_scatter_sum",
                         lambda: C.reduce_scatter_sum(x, "data")),
                        ("hierarchical_psum",
                         lambda: C.hierarchical_psum(x, "data", "model"))):
                    y, t = timed(fn)
                    if not torch.equal(y, x):
                        raise AssertionError(f"{name} at world size 1 "
                                             "changed its input")
                    out["times_s"][name] = t
            print(f"ring_all_gather, reduce_scatter_sum, hierarchical_psum "
                  f"at world size 1 on a {list(x.shape)} leaf: equal to it, "
                  + ", ".join(f"{k} {out['times_s'][k]:.4f} s" for k in
                              ("ring_all_gather", "reduce_scatter_sum",
                               "hierarchical_psum")))
            del grads, x

            # save the distributed parameters, restore them elastically
            ckpt = f"{wd}/ckpt"
            _, t_save = timed(lambda: store.save(ckpt, 1, d_params,
                                                 extra={"step": 1}))
            nbytes = sum(os.path.getsize(os.path.join(dp, f))
                         for dp, _, fs in os.walk(ckpt) for f in fs)
            (restored, extra), t_restore = timed(lambda: restore_elastic(
                ckpt, params, cfg, mesh))
            got = adamw.tree_leaves(restored)
            if extra["step"] != 1 or not all(
                    torch.equal(r.to_local(), p) for r, p in
                    zip(got, adamw.tree_leaves(params))):
                raise AssertionError("restore_elastic differs from the "
                                     "saved parameters")
            out["times_s"].update(save=t_save, restore_elastic=t_restore)
            out["bytes"]["checkpoint"] = nbytes
            print(f"checkpoint of the distributed parameters: {nbytes} "
                  f"bytes, save {t_save:.3f} s, restore_elastic onto the "
                  f"mesh {t_restore:.3f} s, every leaf bit-equal on {smi}")
            del restored, got, d_params

            # the sequence-parallel prefill under the mesh
            B, S = PARALLEL_PREFILL
            toks = torch.from_numpy(np.random.default_rng(18).integers(
                0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
            base, t_base = timed(lambda: steps.make_prefill_step(cfg)(
                params, {"tokens": toks}))
            sp = cfg.replace(sequence_parallel=True)
            zero_counts()
            with mesh_context(mesh):
                got, t_sp = timed(lambda: steps.make_prefill_step(sp)(
                    params, {"tokens": toks}))
            on = read_counts()
            if not torch.equal(got, base):
                raise AssertionError("the sequence-parallel prefill differs "
                                     "from the prefill without it")
            want = {"flash": cfg.n_layers}
            if on["flash"] != want["flash"] or any(
                    n_ for k, n_ in on.items() if k != "flash"):
                raise AssertionError(f"the sequence-parallel prefill "
                                     f"launched {on}; want {want}")
            out["launches"]["prefill"] = {"flash": on["flash"]}
            out["times_s"].update(prefill=t_base, prefill_sp=t_sp)
            print(f"{PARALLEL_ARCH} prefill [{B} x {S}] with "
                  f"sequence_parallel=True under the mesh: {t_sp:.3f} s "
                  f"(without it {t_base:.3f} s), logits bit-equal, "
                  f"{on['flash']} flash launches (its activations are "
                  "plain tensors, which the hints pass through)")
            del params, base, got

            # the hints on DTensor activations replicated on the mesh:
            # sequence_shard's [B, S, d] goes to batch x "data" and
            # sequence x "model", _expert_shard's [E, B, C, d] to experts
            # x "data", each with its values unchanged
            from torch.distributed.tensor import (Replicate, Shard,
                                                  distribute_tensor)

            from repro_torch.models import layers, moe
            gen = torch.Generator(device=dev).manual_seed(19)
            for name, fn, shape, want in (
                    ("sequence_shard", layers.sequence_shard,
                     (B, S, cfg.d_model), (Shard(0), Shard(1))),
                    ("_expert_shard", moe._expert_shard,
                     (8, B, 256, cfg.d_model), (Shard(0), Replicate()))):
                a = torch.randn(shape, generator=gen, device=dev).to(
                    torch.bfloat16)
                d = distribute_tensor(a, mesh, (Replicate(), Replicate()))
                with mesh_context(mesh):
                    y = fn(d)
                if tuple(y.placements) != want or not torch.equal(
                        y.full_tensor(), a) or not torch.equal(
                            y.to_local(), a):
                    raise AssertionError(
                        f"{name} gave {tuple(y.placements)} on the mesh; "
                        f"want {want} with the values unchanged")
                print(f"{name} on a replicated {list(shape)} bf16 DTensor "
                      f"under the mesh: placements {tuple(y.placements)}, "
                      "values unchanged")
            del a, d, y
        finally:
            dist.destroy_process_group()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- b. ranks sharing the card -------------------------------------
    ranks = PARALLEL_RANKS
    print(f"phase 17b: {ranks} gloo ranks on {dev.type}:0 as the (2, 2, 2) "
          "test mesh")
    with tempfile.TemporaryDirectory() as wd:
        t0 = time.perf_counter()
        # one full-width layer leaf: w_gate's [d_model, d_ff]
        shape = (cfg.d_model, cfg.d_ff)
        spawn_ranks(_parallel_rank, ranks, args=(wd, dev.type, shape),
                    store=f"{wd}/store", timeout_s=300)
        out["times_s"][f"{ranks} ranks, spawn to exit"] = (
            time.perf_counter() - t0)
        got = [torch.load(Path(wd, f"rank{r}.pt")) for r in range(ranks)]
    leaves = {r: _leaf_draw(torch, shape, dev, r) for r in range(ranks)}
    at = {tuple(g["coordinate"]): r for r, g in enumerate(got)}
    for r, g in enumerate(got):
        pod, data, model = g["coordinate"]
        # data first (pairs), then pod: the ranks' order of the adds
        pair = [leaves[at[(p, 0, model)]] + leaves[at[(p, 1, model)]]
                for p in (0, 1)]
        want_h = pair[0] + pair[1]
        s = torch.maximum(leaves[at[(pod, 0, model)]].abs().max(),
                          leaves[at[(pod, 1, model)]].abs().max()
                          ) / 127.0 + 1e-12
        want_q = sum(torch.clamp(torch.round(
            leaves[at[(pod, d, model)]] / s), -127, 127).to(torch.int8).to(
                torch.int32) for d in (0, 1)).to(torch.float32) * s
        if not torch.equal(g["hier"], want_h.cpu()):
            raise AssertionError(f"rank {r}: hierarchical_psum differs from "
                                 "the single-process sum")
        if not torch.equal(g["int8"], want_q.cpu()):
            raise AssertionError(f"rank {r}: psum_int8 differs from the "
                                 "single-process sum")
    out["times_s"]["17b hierarchical_psum"] = max(g["hier_s"] for g in got)
    out["times_s"]["17b psum_int8"] = max(g["int8_s"] for g in got)
    out["bytes"]["17b leaf"] = leaves[0].numel() * 4
    print(f"{ranks} ranks: hierarchical_psum and psum_int8 of a "
          f"{list(leaves[0].shape)} float32 leaf equal the single-process "
          f"sums on every rank (slowest rank {out['times_s']['17b hierarchical_psum']:.3f} s / "
          f"{out['times_s']['17b psum_int8']:.3f} s) on {smi}")
    t0 = time.perf_counter()
    refused = gloo_probes(torch, dev)
    out["times_s"]["gloo probes"] = time.perf_counter() - t0
    print(f"gloo with {dev.type} tensors: reduce_scatter_sum ran on two "
          "ranks and gave the single-process result")
    if refused is None:
        print(f"gloo with {dev.type} tensors: ring_all_gather ran on two "
              "ranks and gave the single-process result")
    else:
        print(f"gloo with {dev.type} tensors refuses ring_all_gather's "
              f"send/recv: its TCP transport cannot write a device pointer "
              f"({refused}); the ring is held across ranks by the CPU "
              "tests and on the card by 17a's NCCL rank")
    out["gloo_refused"] = ({} if refused is None
                           else {"ring_all_gather": refused})
    return out


_DRYRUN_CELLS = r"""
import json, sys, time
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
from repro_torch.launch.dryrun import fake_process_group, lower_cell
from repro_torch.launch.mesh import make_test_mesh
cells, small, multi_pod, accum = json.loads(sys.argv[1])
out = {}
with fake_process_group(8):
    mesh = make_test_mesh(multi_pod=multi_pod)
    for arch, shape in cells:
        over = dict(small)
        if arch == "gemma3-1b":
            over.update(n_kv_heads=1, local_window=16, global_every=2)
        rec = lower_cell(arch, shape, mesh, profile="tuned", overrides=over,
                         opt_overrides={"grad_accum": accum})
        out[f"{arch}|{shape}|{'mp' if multi_pod else 'pod'}"] = {
            "ok": rec["ok"], "flops": rec["cost"]["flops"],
            "coll": rec["collectives"]["total_bytes"],
            "grad_accum": rec["config"]["grad_accum"],
            "lower_s": rec["lower_s"]}
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "repro") and sys.modules[m] is not None)
assert not bad, bad
print(json.dumps(out))
"""


def dryrun_phase(root: Path) -> dict:
    """The eight mini dry-run cells in subprocesses with jax and the
    reference blocked: the (2, 4) mesh's three in one, each (2, 2, 2)
    cell in its own, side by side, the two uneven MoE train cells among
    them.  Returns {cell: {ok, flops, coll, grad_accum, lower_s}}; raises
    if a subprocess fails or a cell is not ok."""
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    jobs = ([(list(DRYRUN_CELLS), False, 2)]
            + [([c], True, 2) for c in DRYRUN_CELLS]
            + [([c], True, DRYRUN_UNEVEN_ACCUM) for c in DRYRUN_UNEVEN])
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_CELLS,
         json.dumps([cells, DRYRUN_SMALL, mp, accum])], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cells, mp, accum in jobs]
    cells = {}
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
            if proc.returncode:
                raise AssertionError(f"a dry-run subprocess failed:\n"
                                     f"{out[-2000:]}{err[-4000:]}")
            cells.update(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert len(cells) == 2 * len(DRYRUN_CELLS) + len(DRYRUN_UNEVEN), \
        sorted(cells)
    for key, rec in sorted(cells.items()):
        print(f"phase 18: {key} ok={rec['ok']} flops={rec['flops']:.6e} "
              f"collective_bytes={rec['coll']} "
              f"grad_accum={rec['grad_accum']} lower_s={rec['lower_s']}")
        assert rec["ok"] and rec["flops"] > 0, key
    for mesh in ("pod", "mp"):
        assert cells[f"granite-3-8b|train_4k|{mesh}"]["coll"] > 0, mesh
    for arch, shape in DRYRUN_UNEVEN:
        rec = cells[f"{arch}|{shape}|mp"]
        assert rec["coll"] > 0 and \
            rec["grad_accum"] == DRYRUN_UNEVEN_ACCUM, arch
    return cells


def _tree_to(tree, device):
    """A tree of dicts and lists of tensors, copied to ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))

    import numpy as np

    from repro_torch.core.itemsets import (AprioriResult,
                                           apriori_bruteforce,
                                           generate_candidates,
                                           itemsets_to_bitmap)
    from repro_torch.core.rules import generate_rules
    from repro_torch.data.baskets import (BasketConfig, generate_baskets,
                                          sparse_baskets)
    from repro_torch.data.sparse import SparseSlab, density_stats
    from repro_torch.kernels import loader
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.rule_match import fused as rm_fused
    from repro_torch.kernels.rule_match import kernel as rm_kernel
    from repro_torch.kernels.rule_match.ops import rule_topk
    from repro_torch.kernels.rwkv6_wkv import kernel as wkv
    from repro_torch.kernels.selective_scan import kernel as scan
    from repro_torch.kernels.support_count import fused, intersect, kernel
    from repro_torch.launch.roofline import B1_OPS, HBM_BW, INT8_OPS
    from repro_torch.mining import EclatMiner, make_miner
    from repro_torch.pipeline import (MarketBasketPipeline, PipelineConfig,
                                      ingest_baskets, uniform_tiles)
    from repro_torch.pipeline.dataplane import pad_candidates
    from repro_torch.serving import (Query, RecommendationEngine, RuleIndex,
                                     ServingConfig, recommend_bruteforce)

    wrappers = {"packed": fused.support_count_packed,
                "int8": kernel.support_count_int8,
                "rm_packed": rm_fused.rule_scores_packed,
                "rm_int8": rm_kernel.rule_scores_int8,
                "intersect": intersect.intersect_count_words,
                "flash": flash.flash_attention_fwd,
                "flash_bwd": flash.flash_attention_bwd,
                "scan": scan.selective_scan_fwd,
                "scan_bwd": scan.selective_scan_bwd,
                "wkv": wkv.wkv6_fwd,
                "wkv_bwd": wkv.wkv6_bwd}

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0
        flash.zero_launches()
        scan.zero_launches()
        wkv.zero_launches()

    def read_counts():
        return {k: w.launches for k, w in wrappers.items()}

    # float32 matmuls in the plain versions run in full float32 (the
    # default); their 0/1 operands are exact under TF32 too
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(dev)

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    logs = loader.build(["support_count_packed", "support_count_int8",
                         "rule_match_packed", "rule_match_int8",
                         "intersect_count", "flash_attention",
                         "flash_attention_bwd", "selective_scan",
                         "selective_scan_bwd", "wkv6", "wkv6_bwd"])
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(logs) or 'already built'})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # ---- 2. kernels against their plain versions ----------------------
    t0 = time.perf_counter()
    T_all = generate_baskets(BasketConfig(**CORPUS))
    print(f"corpus: {T_all.shape} generated in "
          f"{time.perf_counter() - t0:.2f} s")
    T, n_items_raw, n_tx = ingest_baskets(T_all)
    tile = torch.from_numpy(uniform_tiles(T, N_TILES)[0]).to(dev)
    min_sup = max(1, int(MIN_SUPPORT * n_tx))
    counts = T.sum(axis=0, dtype=np.int64)
    frequent = [(int(i),) for i in np.flatnonzero(counts >= min_sup)]
    cands = generate_candidates(frequent)
    C = torch.from_numpy(pad_candidates(
        itemsets_to_bitmap(cands, T.shape[1]), 128)).to(dev)
    N, I = tile.shape
    M = C.shape[0]
    W = I // 32
    print(f"main-path shape: tile [{N}, {I}] x k=2 candidates [{M}, {I}] "
          f"({len(cands)} real)")

    def check(got, want, what):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"{what}: {bad} of {want.numel()} values "
                                 "differ from the plain version")
        return float((got.to(torch.float64) - want.to(torch.float64)).abs()
                     .max()) if want.numel() else 0.0

    Tw, Cw = fused.pack_words(tile), fused.pack_words(C)
    Ti, Ci = tile.view(torch.int8), C.view(torch.int8)
    sizes = C.sum(dim=1, dtype=torch.int32)
    err = {
        "packed": check(fused.support_count_packed(Tw, Cw, sizes),
                        fused.support_count_packed_plain(Tw, Cw, sizes),
                        "support_count_packed (main-path shape)"),
        "int8": check(kernel.support_count_int8(Ti, Ci, sizes),
                      kernel.support_count_int8_plain(Ti, Ci, sizes),
                      "support_count_int8 (main-path shape)"),
    }
    rng = np.random.default_rng(1)
    for n, m, i in [(77, 200, 128), (4133, 1, 256), (1000, 257, 1024)]:
        t = torch.from_numpy((rng.random((n, i)) < 0.5).astype(np.int8))
        c = torch.from_numpy((rng.random((m, i)) < 0.02).astype(np.int8))
        c[0] = 0                                  # |c| = 0 matches all rows
        t, c = t.to(dev), c.to(dev)
        s = c.sum(dim=1, dtype=torch.int32)
        tw, cw = fused.pack_words(t), fused.pack_words(c)
        check(fused.support_count_packed(tw, cw, s),
              fused.support_count_packed_plain(tw, cw, s),
              f"support_count_packed [{n}, {m}, {i}]")
        check(kernel.support_count_int8(t, c, s),
              kernel.support_count_int8_plain(t, c, s),
              f"support_count_int8 [{n}, {m}, {i}]")
    # both kernels at the later rounds' shapes: the first 256 and 128
    # candidates of the k=2 batch
    if M != ROUND_M[0]:
        raise AssertionError(f"the k=2 batch pads to {M}, not {ROUND_M[0]}")
    for m in ROUND_M[1:]:
        check(fused.support_count_packed(Tw, Cw[:m], sizes[:m]),
              fused.support_count_packed_plain(Tw, Cw[:m], sizes[:m]),
              f"support_count_packed [{N}, {m}, {W} words]")
        check(kernel.support_count_int8(Ti, Ci[:m], sizes[:m]),
              kernel.support_count_int8_plain(Ti, Ci[:m], sizes[:m]),
              f"support_count_int8 [{N}, {m}, {I}]")
    print("kernels match their plain versions exactly (main-path shape, "
          "both at every round's shape, 3 ragged shapes)")

    # an empty kernel queued behind others: the least a launch costs
    floor_ms = _cuda_ms(torch, lambda: torch.cuda._sleep(0))
    print(f"launch floor (torch.cuda._sleep(0), queued): {floor_ms:.5f} ms")

    def vs_floor(ms):
        return f", {ms / floor_ms:.2f}x the launch floor" if ms < 0.01 else ""

    def int_mm_count(Ci, sizes):
        dots = torch._int_mm(Ti, Ci.t())
        return (dots == sizes[None, :]).sum(dim=0, dtype=torch.int32)
    check(int_mm_count(Ci, sizes),
          kernel.support_count_int8_plain(Ti, Ci, sizes),
          "torch._int_mm yardstick")
    timing = {
        "packed": dict(
            ms=_cuda_ms(torch, lambda: fused.support_count_packed(
                Tw, Cw, sizes)),
            plain_ms=_cuda_ms(torch, lambda: fused.support_count_packed_plain(
                Tw, Cw, sizes), reps=3),
            library_ms=None),
        "int8": dict(
            ms=_cuda_ms(torch, lambda: kernel.support_count_int8(
                Ti, Ci, sizes)),
            plain_ms=_cuda_ms(torch, lambda: kernel.support_count_int8_plain(
                Ti, Ci, sizes), reps=3),
            library_ms=_cuda_ms(torch, lambda: int_mm_count(Ci, sizes))),
    }
    clock_hz = float(_nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    popc_per_s = props.multi_processor_count * POPC_PER_SM_PER_CLOCK * clock_hz
    # the packed kernel's AND-popcounts at the binary tensor cores' rate;
    # the CUDA cores' popcount rate, its bound before, is printed beside
    bound = {
        "packed": {"operations": N * M * W * 32 / B1_OPS * 1e3,
                   "bytes": (N * W * 4 + M * W * 4 + 2 * M * 4)
                   / HBM_BW * 1e3},
        "int8": {"operations": 2 * N * M * I / INT8_OPS * 1e3,
                 "bytes": (N * I + M * I + 2 * M * 4)
                 / HBM_BW * 1e3},
    }
    for k, v in timing.items():
        by = max(bound[k], key=bound[k].get)
        v.update(bound_ms=bound[k][by], bound_by=by)
        print(f"{k}: kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, "
              f"library {v['library_ms']} ms, bound {v['bound_ms']:.5f} ms "
              f"({by})")
    cuda_core_ms = N * M * W / popc_per_s * 1e3
    print(f"packed on CUDA cores' popcounts ({props.multi_processor_count} "
          f"SMs at {clock_hz / 1e6:.0f} MHz) would take at least "
          f"{cuda_core_ms:.4f} ms")

    # the packed kernel at each round's shape, beside its bound
    timing["packed"]["rounds"] = {}
    for m in ROUND_M:
        bnd = {"operations": N * m * W * 32 / B1_OPS * 1e3,
               "bytes": (N * W * 4 + m * W * 4 + 2 * m * 4) / HBM_BW * 1e3}
        by = max(bnd, key=bnd.get)
        geom = fused.geometry(N, m, W, props.multi_processor_count)
        row = dict(
            ms=_cuda_ms(torch, lambda: fused.support_count_packed(
                Tw, Cw[:m], sizes[:m])),
            bound_ms=bnd[by], bound_by=by,
            geometry=geom.describe(N, m, W))
        timing["packed"]["rounds"][m] = row
        print(f"packed [{N}, {m}, {W} words]: kernel {row['ms']:.4f} ms"
              f"{vs_floor(row['ms'])}, bound {row['bound_ms']:.5f} ms "
              f"({by}); launch: {row['geometry']}")

    # the int8 kernel at each round's shape, beside _int_mm and its bound
    timing["int8"]["rounds"] = {}
    for m in ROUND_M:
        bnd = {"operations": 2 * N * m * I / INT8_OPS * 1e3,
               "bytes": (N * I + m * I + 2 * m * 4) / HBM_BW * 1e3}
        by = max(bnd, key=bnd.get)
        geom = kernel.geometry(N, m, I, props.multi_processor_count)
        row = dict(
            ms=_cuda_ms(torch, lambda: kernel.support_count_int8(
                Ti, Ci[:m], sizes[:m])),
            library_ms=_cuda_ms(torch, lambda: int_mm_count(Ci[:m],
                                                            sizes[:m])),
            bound_ms=bnd[by], bound_by=by,
            geometry=geom.describe(N, m, I))
        timing["int8"]["rounds"][m] = row
        print(f"int8 [{N}, {m}, {I}]: kernel {row['ms']:.4f} ms"
              f"{vs_floor(row['ms'])}, _int_mm {row['library_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.5f} ms ({by}); launch: "
              f"{row['geometry']}")

    # the intersect kernel at the vertical plane's shapes: W is the
    # corpus's tid words padded to 128, M a dense-corpus tile (128 rows),
    # a sparse-corpus k=1 tile and the whole k=2 slab (the join's M rows)
    def pad128(n):
        return -(-n // 128) * 128

    w_dense = pad128(-(-n_tx // 32))
    w_sparse = pad128(-(-SPARSE_CORPUS["n_tx"] // 32))
    g_words = np.random.default_rng(4)

    def words(m, w):
        """Random words, about half with bit 31 set, on the card."""
        return torch.from_numpy(g_words.integers(
            0, 2**32, size=(m, w), dtype=np.uint32).view(np.int32)).to(dev)

    ix_inputs = {"tile": (128, w_dense), "sparse_tile": (640, w_sparse),
                 "whole_slab": (M, w_dense)}
    for key, (m, w) in [*ix_inputs.items(), ("ragged", (1, 4)),
                        ("ragged", (129, 4)), ("ragged", (1, w_dense)),
                        ("ragged", (129, w_sparse)), ("ragged", (3, 516))]:
        a, b = words(m, w), words(m, w)
        a[0, : w // 2] = -1                       # all 32 bits of a word
        err["intersect"] = max(err.get("intersect", 0.0), check(
            intersect.intersect_count_words(a, b),
            intersect.intersect_count_plain(a, b),
            f"intersect_count [{m}, {w}]"))
        if key != "ragged":
            ix_inputs[key] = (a, b)
    print("intersect kernel matches its plain version exactly "
          f"({', '.join(f'{k} {list(v[0].shape)}' for k, v in ix_inputs.items())}"
          " + 5 ragged shapes)")

    def time_intersect(a, b):
        m, w = a.shape
        bnd = {"bytes": (2 * m * w * 4 + 4 * m) / HBM_BW * 1e3,
               "operations": m * w / popc_per_s * 1e3}
        by = max(bnd, key=bnd.get)
        geom = intersect.geometry(w)
        out = dict(
            ms=_cuda_ms(torch, lambda: intersect.intersect_count_words(a, b)),
            plain_ms=_cuda_ms(torch, lambda: intersect.intersect_count_plain(
                a, b), reps=3),
            library_ms=None, bound_ms=bnd[by], bound_by=by, shape=[m, w],
            geometry=geom.describe(m, w))
        print(f"intersect [{m}, {w}]: kernel {out['ms']:.4f} ms"
              f"{vs_floor(out['ms'])}, plain {out['plain_ms']:.4f} ms, "
              f"bound {out['bound_ms']:.5f} ms ({by}); launch: "
              f"{out['geometry']}")
        return out

    timing["intersect"] = time_intersect(*ix_inputs["tile"])
    for key in ("whole_slab", "sparse_tile"):
        timing["intersect"][key] = time_intersect(*ix_inputs[key])
    del ix_inputs

    # ---- 3. the mining main path, three ways --------------------------
    walls = {}

    def mine(**kw):
        cfg = PipelineConfig(min_support=MIN_SUPPORT, n_tiles=N_TILES, **kw)
        t0 = time.perf_counter()
        res = MarketBasketPipeline(config=cfg).run(T_all)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        walls["apriori " + ("mxu" if kw.get("tuning") == {"variant": "mxu"}
                            else kw.get("data_plane", "packed"))] = wall
        rounds = [(r.k, r.n_candidates, r.n_frequent, r.m_padded)
                  for r in res.report.rounds]
        serial_s = sum(p.host_time_s for p in res.report.ledger.phases
                       if p.kind == "serial")
        print(f"mine {kw}: backend "
              f"{res.report.backend}, {len(rounds)} rounds "
              f"(k, candidates, frequent, m_padded) {rounds}, "
              f"{len(res.supports)} itemsets, {len(res.rules)} rules, "
              f"wall {wall:.3f} s, of which candidate generation and "
              f"rules (serial phases) {serial_s:.3f} s")
        maps = res.report.ledger.by_kind("map")
        if not maps or any(p.syncs != 1 for p in maps):
            raise AssertionError("pipelined rounds must read back once "
                                 f"each: {[(p.name, p.syncs) for p in maps]}")
        return res

    # first mine on the card: a small corpus against the brute-force
    # oracle, which also takes the one-time start-up costs out of the walls
    small = generate_baskets(BasketConfig(n_tx=300, n_items=24, n_patterns=4,
                                          pattern_len=3, pattern_prob=0.5,
                                          seed=5))
    got = MarketBasketPipeline(config=PipelineConfig(
        min_support=0.05, n_tiles=4, tuning=PACKED)).run(small).supports
    if got != apriori_bruteforce(small, 15, max_k=24):
        raise AssertionError("small mine differs from apriori_bruteforce")
    print("small corpus mined on the card = apriori_bruteforce")

    def drive(**kw):
        """One path of the main path: counts zeroed just before, read
        just after."""
        zero_counts()
        res = mine(**kw)
        return res, read_counts()

    packed, on_packed = drive(tuning=PACKED)
    mxu, on_mxu = drive(tuning={"variant": "mxu"})
    ref, on_ref = drive(data_plane="ref")
    print(f"launches: packed path {on_packed}, mxu path {on_mxu}, "
          f"ref path {on_ref}")
    launches = {"packed": on_packed["packed"], "int8": on_mxu["int8"]}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was never launched: {launches}")
    if (on_packed["int8"] or on_mxu["packed"] or any(on_ref.values())
            or any(c[k] for c in (on_packed, on_mxu)
                   for k in ("rm_packed", "rm_int8", "intersect"))):
        raise AssertionError("a path launched another path's kernel")
    if launches["packed"] != launches["int8"]:
        raise AssertionError("both variants must count the same tiles")

    # each kernel over its mine, estimated: its launches at each round's
    # shape times that shape's time alone (phase 2); not a measurement of
    # the mine, so it stays off the kernels line
    for key, res, on, label in (("packed", packed, on_packed, "packed"),
                                ("int8", mxu, on_mxu, "mxu")):
        per_shape = {}
        for r in res.report.rounds:
            if r.m_padded:
                per_shape[r.m_padded] = per_shape.get(r.m_padded, 0) + N_TILES
        rounds = timing[key]["rounds"]
        if sum(per_shape.values()) != on[key] or any(
                m not in rounds for m in per_shape):
            raise AssertionError(f"the {label} mine launched the {key} "
                                 f"kernel at {per_shape}, {on[key]} in all")
        kernel_ms = sum(n * rounds[m]["ms"] for m, n in per_shape.items())
        print(f"{key} kernel over the {label} mine, launches x time a "
              "launch alone (an estimate, not a measurement): "
              + " + ".join(f"{n} x {rounds[m]['ms']:.4f} ms (M {m})"
                           for m, n in per_shape.items())
              + f" = {kernel_ms:.3f} ms, beside the mine's "
              f"{walls['apriori ' + label]:.3f} s wall")

    for name, res in (("mxu", mxu), ("ref", ref)):
        if res.supports != packed.supports or res.rules != packed.rules:
            raise AssertionError(f"{name} mine differs from packed")
    del mxu, ref, res                 # nothing reads these mines again
    for itemset, sup in packed.supports.items():
        if int(T_all[:, list(itemset)].all(axis=1).sum()) != sup:
            raise AssertionError(f"support of {itemset} is not {sup}")
    want_rules = generate_rules(
        AprioriResult(supports=packed.supports, n_tx=n_tx, levels=0),
        0.6, min_lift=0.0)
    if packed.rules != want_rules:
        raise AssertionError("rules differ from generate_rules on the "
                             "recounted supports")
    if not packed.rules or max(len(s) for s in packed.supports) < 3:
        raise AssertionError("the corpus must mine rules and 3-itemsets")
    print(f"mines agree: {len(packed.supports)} itemsets recounted by "
          "numpy, rules regenerated")

    # ---- 4. the vertical (Eclat) plane, dense and sparse --------------
    # the garbage collector's pauses, summed from here to the end of the
    # serving phase: they land in some mines and serves and not others
    gc_pause = {"s": 0.0, "t0": 0.0}

    def on_gc(phase, _info):
        if phase == "start":
            gc_pause["t0"] = time.perf_counter()
        else:
            gc_pause["s"] += time.perf_counter() - gc_pause["t0"]

    gc.callbacks.append(on_gc)

    def mine_eclat(baskets, min_support, label, n_tiles=N_TILES, **kw):
        """One path through make_miner: counts zeroed just before, read
        just after; the wall includes auto's density measurement.  The
        Apriori mines run the packed kernel."""
        cfg = PipelineConfig(min_support=min_support, n_tiles=n_tiles,
                             tuning=PACKED, **kw)
        zero_counts()
        gc_pause["s"] = 0.0
        t0 = time.perf_counter()
        miner, choice = make_miner(baskets, config=cfg)
        res = miner.run(baskets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        on = read_counts()
        walls[label] = wall
        gc_s[label] = gc_pause["s"]
        led = res.report.ledger
        columnize = [p.host_time_s for p in led.phases
                     if p.name == "eclat-columnize"]
        serial_s = sum(p.host_time_s for p in led.phases
                       if p.kind == "serial")
        rounds = [(r.k, r.n_candidates, r.n_frequent) for r in
                  res.report.rounds]
        print(f"mine {label}: {type(miner).__name__}, backend "
              f"{res.report.backend}, rounds (k, candidates, frequent) "
              f"{rounds}, {len(res.supports)} itemsets, {len(res.rules)} "
              f"rules, wall {wall:.3f} s, of which serial phases "
              f"{serial_s:.3f} s (columnize "
              f"{columnize[0] if columnize else 0.0:.3f} s), gc pauses "
              f"{gc_s[label]:.3f} s; launches {on}")
        maps = led.by_kind("map")
        if not maps or any(p.syncs != 1 for p in maps):
            raise AssertionError("pipelined rounds must read back once "
                                 f"each: {[(p.name, p.syncs) for p in maps]}")
        host_s[label] = columnize[0] if columnize else 0.0
        return res, on, choice

    host_s, gc_s = {}, {}

    def router_ratio(baskets, min_support, label, reps, n_tiles=N_TILES):
        """The router's cost, measured two ways on one corpus.

        B11's way (``benchmarks/bench_algorithms.py``): build apriori,
        Eclat and auto with ``make_miner`` once, outside the timed window,
        warm each with one ``run``, then time ``reps`` interleaved
        ``miner.run`` calls per arm (each ending in a synchronise); the
        ratio of auto's median to the best explicit median is B11's gated
        number (1.1).  Every rep counts: none is dropped or trimmed.  Its
        90% interval comes from a seeded bootstrap over each arm's reps;
        the ratio over the first ``B11_REPS`` reps alone is what
        bench_algorithms.py's three reps would have read.  The stricter
        way times ``make_miner`` (and so the density scan) plus a cold
        ``run`` in each of three mines a side, in turns.  Prints the
        ratios beside every wall, Eclat's columnize times and the
        collector's pauses in each mine, and returns {"b11": ratio,
        "b11_ci90": [low, high], "b11_first3": ratio, "make_miner":
        ratio}."""
        t0 = time.perf_counter()
        stats = density_stats(baskets)
        scan_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        baskets.sum(axis=0, dtype=np.int64)
        int64_s = time.perf_counter() - t0
        got, order = {}, ("apriori", "eclat", "auto")
        for algorithm in order + order[::-1] + order:
            name = f"{label} {algorithm}"
            res, _, _ = mine_eclat(baskets, min_support, name,
                                   n_tiles=n_tiles, algorithm=algorithm)
            if (res.supports, res.rules) != got.get("answer", (
                    res.supports, res.rules)):
                raise AssertionError(f"{name} mines another answer")
            got["answer"] = (res.supports, res.rules)
            got.setdefault(algorithm, []).append(
                (walls[name], host_s[name], gc_s[name]))
        del res
        median = {a: float(np.median([w for w, _, _ in got[a]]))
                  for a in order}
        strict = median["auto"] / min(median["apriori"], median["eclat"])

        miners = {}
        for algorithm in order:
            miners[algorithm], _ = make_miner(baskets, config=PipelineConfig(
                min_support=min_support, n_tiles=n_tiles,
                algorithm=algorithm, tuning=PACKED))
            miners[algorithm].run(baskets)                 # warm-up
        torch.cuda.synchronize()
        runs = {a: [] for a in order}
        for _ in range(reps):
            for algorithm, miner in miners.items():
                gc_pause["s"] = 0.0
                t0 = time.perf_counter()
                res = miner.run(baskets)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if (res.supports, res.rules) != got["answer"]:
                    raise AssertionError(f"{label} {algorithm} (B11's way) "
                                         "mines another answer")
                runs[algorithm].append((wall, gc_pause["s"]))
        del miners, res
        walls_by_arm = {a: np.array([w for w, _ in runs[a]]) for a in order}

        def ratio_of_medians(med):
            return med["auto"] / min(med["apriori"], med["eclat"])
        b11 = ratio_of_medians({a: np.median(w)
                                for a, w in walls_by_arm.items()})
        first3 = ratio_of_medians({a: np.median(w[:B11_REPS])
                                   for a, w in walls_by_arm.items()})
        boot_rng = np.random.default_rng(0)
        boot = np.array([ratio_of_medians({
            a: np.median(boot_rng.choice(w, size=w.size))
            for a, w in walls_by_arm.items()})
            for _ in range(BOOTSTRAP_RESAMPLES)])
        ci90 = [float(np.percentile(boot, 5)), float(np.percentile(boot, 95))]

        def by_arm(values, i):
            return "; ".join(f"{a} " + " / ".join(f"{v[i]:.4f}"
                                                   for v in values[a]) + " s"
                             for a in order)
        print(f"router {label} ({stats.summary()}): density scan "
              f"{scan_s:.4f} s (an int64-accumulating sum of the bitmap: "
              f"{int64_s:.4f} s)")
        print(f"router {label}, B11's way (make_miner once, one warm run, "
              f"{reps} interleaved runs): walls {by_arm(runs, 0)}; gc "
              f"pauses in them {by_arm(runs, 1)}")
        print(f"router {label}, B11's way: ratio (gate 1.1) = {b11:.3f} "
              f"(medians of {reps} reps), 90% interval [{ci90[0]:.3f}, "
              f"{ci90[1]:.3f}] (bootstrap, {BOOTSTRAP_RESAMPLES} resamples, "
              f"seed 0); {first3:.3f} over the first {B11_REPS} reps, as "
              f"bench_algorithms.py ({B11_REPS} reps)")
        print(f"router {label}, make_miner + cold run: eclat columnize "
              + " / ".join(f"{c:.4f}" for _, c, _ in got["eclat"])
              + f" s; walls {by_arm(got, 0)}; gc pauses in them "
              f"{by_arm(got, 2)}; make_miner-inclusive ratio = {strict:.3f} "
              "(medians)")
        return {"b11": float(b11), "b11_ci90": ci90,
                "b11_first3": float(first3), "make_miner": strict}

    got = make_miner(small, config=PipelineConfig(
        min_support=0.05, n_tiles=4, algorithm="eclat"))[0].run(small)
    if got.supports != apriori_bruteforce(small, 15, max_k=24):
        raise AssertionError("small eclat mine differs from "
                             "apriori_bruteforce")
    print("small corpus mined by eclat on the card = apriori_bruteforce")

    eclat, on_eclat, _ = mine_eclat(T_all, MIN_SUPPORT, "eclat cuda",
                                    algorithm="eclat")
    eclat_ref, on_eclat_ref, _ = mine_eclat(
        T_all, MIN_SUPPORT, "eclat ref", algorithm="eclat", data_plane="ref")
    auto, on_auto, choice = mine_eclat(T_all, MIN_SUPPORT, "auto",
                                       algorithm="auto")
    print(f"the router's default model, AlgorithmCostModel.from_autotune "
          f"on the card: {choice.summary()}")
    for name, res in (("eclat cuda", eclat), ("eclat ref", eclat_ref),
                      ("auto", auto)):
        if res.supports != packed.supports or res.rules != packed.rules:
            raise AssertionError(f"{name} mine differs from apriori packed")
    del eclat, eclat_ref, auto, res   # nothing reads these mines again
    launches["intersect"] = on_eclat["intersect"]
    if launches["intersect"] <= 0:
        raise AssertionError("the intersect kernel was never launched")
    if (any(n for k, n in on_eclat.items() if k != "intersect")
            or any(on_eclat_ref.values())
            or on_auto != (on_eclat if choice.algorithm == "eclat"
                           else on_packed)):
        raise AssertionError(f"eclat paths launched {on_eclat}, "
                             f"{on_eclat_ref}, auto {on_auto}")
    print("dense walls: " + ", ".join(f"{k} {v:.3f} s"
                                      for k, v in walls.items()))
    host_profile("eclat cuda mine", EclatMiner(config=PipelineConfig(
        min_support=MIN_SUPPORT, n_tiles=N_TILES)).run, T_all)
    ratios = {"dense": router_ratio(T_all, MIN_SUPPORT, "dense",
                                    ROUTER_REPS_DENSE)}
    T_b11 = generate_baskets(BasketConfig(**B11_CORPUS))
    ratios["b11"] = router_ratio(T_b11, B11_MIN_SUPPORT, "b11",
                                 ROUTER_REPS_B11, n_tiles=B11_N_TILES)
    print("router ratios (B11's gate 1.1; printed, not enforced): "
          + json.dumps(ratios))
    del T_b11

    t0 = time.perf_counter()
    slab = SparseSlab.from_baskets(sparse_baskets(**SPARSE_CORPUS),
                                   n_items=SPARSE_CORPUS["n_items"])
    print(f"sparse corpus: {slab.n_tx} x {slab.n_items}, nnz {slab.nnz}, "
          f"built in {time.perf_counter() - t0:.2f} s")

    def no_densify(self):
        raise AssertionError("the sparse slab was densified")

    to_dense, SparseSlab.to_dense = SparseSlab.to_dense, no_densify
    sparse, on_sparse, _ = mine_eclat(slab, SPARSE_MIN_SUPPORT,
                                      "sparse eclat cuda", algorithm="eclat")
    sparse_ref, on_sparse_ref, _ = mine_eclat(
        slab, SPARSE_MIN_SUPPORT, "sparse eclat ref", algorithm="eclat",
        data_plane="ref")
    SparseSlab.to_dense = to_dense
    if (sparse.supports != sparse_ref.supports
            or sparse.rules != sparse_ref.rules):
        raise AssertionError("sparse eclat mines differ between planes")
    if (on_sparse["intersect"] <= 0 or any(on_sparse_ref.values())
            or any(n for k, n in on_sparse.items() if k != "intersect")):
        raise AssertionError(f"sparse paths launched {on_sparse}, "
                             f"{on_sparse_ref}")
    tx_of_row = np.repeat(np.arange(slab.n_tx), np.diff(slab.indptr))
    tids = {}
    for itemset, sup in sparse.supports.items():
        common = None
        for i in itemset:
            if i not in tids:
                tids[i] = tx_of_row[slab.indices == i]
            common = tids[i] if common is None else np.intersect1d(
                common, tids[i], assume_unique=True)
        if len(common) != sup:
            raise AssertionError(f"sparse support of {itemset} is not {sup}")
    if not sparse.rules or max(len(s) for s in sparse.supports) < 3:
        raise AssertionError("the sparse corpus must mine rules and "
                             "3-itemsets")
    print(f"sparse mines agree: {len(sparse.supports)} itemsets recounted "
          f"from the CSR slab by numpy; walls cuda "
          f"{walls['sparse eclat cuda']:.3f} s, ref "
          f"{walls['sparse eclat ref']:.3f} s")
    del slab, tx_of_row

    # ---- 5. rule-match kernels against their plain versions ----------
    index = RuleIndex.build(packed.rules, n_items_raw)
    R, Ip = index.n_rows_padded, index.n_items_padded
    print(f"rule index: {index.n_rows} rows from {index.n_rules} rules, "
          f"padded to [{R}, {Ip}]")
    if Ip != I:
        raise AssertionError(f"index items {Ip} != corpus lanes {I}")

    def rule_match_both(Qm, Am, s_f, cf, what):
        """Both rule-match kernels against their plain versions on 0/1
        int8 queries/antecedents, float32 sizes and conf."""
        Qmw, Amw, s_i = fused.pack_words(Qm), fused.pack_words(Am), \
            s_f.to(torch.int32)
        for key, got, want in (
                ("rm_packed", rm_fused.rule_scores_packed(Qmw, Amw, s_i, cf),
                 rm_fused.rule_scores_packed_plain(Qmw, Amw, s_i, cf)),
                ("rm_int8", rm_kernel.rule_scores_int8(Qm, Am, s_f, cf),
                 rm_kernel.rule_scores_int8_plain(Qm, Am, s_f, cf))):
            err[key] = max(err.get(key, 0.0),
                           check(got, want, f"{key} {what}"))
        return want

    def random_index(n_rules, n_items, seed):
        """n_rules antecedents of 1-3 random items below n_items, with
        random confidences, on the card."""
        g = np.random.default_rng(seed)
        A = np.zeros((n_rules, Ip), np.int8)
        cols = g.integers(0, n_items, (n_rules, 3))
        keep = np.arange(3)[None, :] < g.integers(1, 4, (n_rules, 1))
        A[np.repeat(np.arange(n_rules)[:, None], 3, 1)[keep], cols[keep]] = 1
        return (torch.from_numpy(A).to(dev),
                torch.from_numpy(A.sum(1).astype(np.float32)).to(dev),
                torch.from_numpy(g.random(n_rules).astype(np.float32)).to(dev))

    A8 = torch.from_numpy(index.ante).to(dev).view(torch.int8)
    sizes_f = torch.from_numpy(index.sizes).to(dev)
    conf = torch.from_numpy(index.conf).to(dev)
    baskets = torch.from_numpy(T[:64]).to(dev).view(torch.int8)
    for b in (8, 64):
        hits = rule_match_both(baskets[:b], A8, sizes_f, conf,
                               f"(serving shape, bucket {b})")
    if not (hits > 0).any():
        raise AssertionError("no corpus basket matches a mined rule")
    g = np.random.default_rng(2)
    for b, r, i in [(5, 200, 128), (64, 333, 1024), (9, 129, 1152)]:
        Qr = torch.from_numpy((g.random((b, i)) < 0.3).astype(np.int8))
        Ar = torch.from_numpy((g.random((r, i)) < 4 / i).astype(np.int8))
        Ar[0] = 0                          # |a| = 0 matches every basket
        Qr, Ar = Qr.to(dev), Ar.to(dev)
        rule_match_both(Qr, Ar, Ar.sum(1).to(torch.float32),
                        torch.from_numpy(g.random(r).astype(np.float32))
                        .to(dev), f"[{b}, {r}, {i}]")
    # an index of padding rows only: sizes -1 never match
    pad_only = rule_match_both(
        baskets[:8], torch.zeros((128, Ip), dtype=torch.int8, device=dev),
        torch.full((128,), -1.0, device=dev),
        torch.zeros(128, device=dev), "(128 padding rows)")
    if pad_only.any():
        raise AssertionError("a padding row matched")
    A_wide, sizes_wide, conf_wide = random_index(WIDE_RULES, n_items_raw, 3)
    rule_match_both(baskets, A_wide, sizes_wide, conf_wide,
                    f"(wide index [{WIDE_RULES}, {Ip}])")
    print("rule-match kernels match their plain versions exactly "
          "(serving shapes + 4 ragged shapes + a wide index)")

    def int_mm_scores(Qm, Am, s_i, cf):
        # torch._int_mm's first operand needs more than 16 rows: a small
        # batch goes second, and the [R, B] dots are read transposed
        if Qm.shape[0] > 16:
            dots = torch._int_mm(Qm, Am.t())
        else:
            dots = torch._int_mm(Am, Qm.t()).t()
        return (dots == s_i[None, :]).to(torch.float32) * cf[None, :]

    def time_rule_match(Qm, Am, s_f, cf):
        Qmw, Amw, s_i = fused.pack_words(Qm), fused.pack_words(Am), \
            s_f.to(torch.int32)
        B_, R_ = Qm.shape[0], Am.shape[0]
        check(int_mm_scores(Qm, Am, s_i, cf),
              rm_kernel.rule_scores_int8_plain(Qm, Am, s_f, cf),
              "torch._int_mm yardstick")
        W_ = Ip // 32
        bound = {
            "rm_packed": {"operations": B_ * R_ * W_ * 32 / B1_OPS
                          * 1e3,
                          "bytes": (B_ * W_ * 4 + R_ * W_ * 4 + 2 * R_ * 4
                                    + B_ * R_ * 4) / HBM_BW * 1e3},
            "rm_int8": {"operations": 2 * B_ * R_ * Ip / INT8_OPS
                        * 1e3,
                        "bytes": (B_ * Ip + R_ * Ip + 2 * R_ * 4
                                  + B_ * R_ * 4) / HBM_BW * 1e3},
        }
        out = {
            "rm_packed": dict(
                ms=_cuda_ms(torch, lambda: rm_fused.rule_scores_packed(
                    Qmw, Amw, s_i, cf)),
                plain_ms=_cuda_ms(torch, lambda: rm_fused
                                  .rule_scores_packed_plain(Qmw, Amw, s_i,
                                                            cf), reps=3),
                library_ms=None),
            "rm_int8": dict(
                ms=_cuda_ms(torch, lambda: rm_kernel.rule_scores_int8(
                    Qm, Am, s_f, cf)),
                plain_ms=_cuda_ms(torch, lambda: rm_kernel
                                  .rule_scores_int8_plain(Qm, Am, s_f, cf),
                                  reps=3),
                library_ms=_cuda_ms(torch, lambda: int_mm_scores(
                    Qm, Am, s_i, cf))),
        }
        sms = props.multi_processor_count
        out["rm_int8"]["geometry"] = rm_kernel.geometry(
            B_, R_, Ip, sms).describe(B_, R_, Ip)
        out["rm_packed"]["geometry"] = rm_fused.geometry(
            B_, R_, W_, sms).describe(B_, R_)
        for k, v in out.items():
            by = max(bound[k], key=bound[k].get)
            v.update(bound_ms=bound[k][by], bound_by=by)
            print(f"{k} [{B_}, {R_}, {Ip}]: kernel {v['ms']:.4f} ms"
                  f"{vs_floor(v['ms'])}, plain {v['plain_ms']:.4f} ms, "
                  f"library {v['library_ms']} ms, bound {v['bound_ms']:.5f} "
                  f"ms ({by}); launch: {v['geometry']}")
        return out

    timing.update(time_rule_match(baskets, A8, sizes_f, conf))
    for k, v in time_rule_match(baskets[:8], A8, sizes_f, conf).items():
        timing[k]["bucket8"] = v
    for k, v in time_rule_match(baskets, A_wide, sizes_wide,
                                conf_wide).items():
        timing[k]["wide"] = dict(v, rules=WIDE_RULES)

    # ---- 6. the serving main path, three ways -------------------------
    queries = [Query.of(np.flatnonzero(row).tolist())
               for row in T_all[:N_QUERIES]]

    def serve(**kw):
        """One serving path: a warm-up serve on its own engine, then the
        measured one, with counts zeroed just before and read just after."""
        cfg = ServingConfig(**kw)
        RecommendationEngine(index, config=cfg).serve(queries[:64])
        engine = RecommendationEngine(index, config=cfg)
        zero_counts()
        gc_pause["s"] = 0.0
        results, report = engine.serve(queries)
        on = read_counts()
        score_s = sum(p.host_time_s for p in report.ledger.by_kind("map"))
        print(f"serve {kw}: backend {report.backend}, "
              f"{report.n_queries} queries in {report.n_batches} batches, "
              f"cache {report.cache_hits} hit / {report.cache_misses} miss, "
              f"batches by bucket {report.bucket_counts}, "
              f"wall {report.wall_time_s:.4f} s = {report.wall_qps:.0f} "
              f"QPS, of which scoring calls {score_s:.4f} s, gc pauses "
              f"{gc_pause['s']:.4f} s; launches {on}")
        return results, report, on

    paths = {"packed": {"tuning": PACKED},
             "mxu": {"tuning": {"variant": "mxu"}},
             "ref": {"data_plane": "ref"}}
    runs = {name: [] for name in paths}
    for name in ("packed", "mxu", "ref", "ref", "mxu", "packed"):
        runs[name].append(serve(**paths[name]))
    gc.callbacks.remove(on_gc)
    for name in ("packed", "mxu"):
        host_profile(f"{name} serve", RecommendationEngine(
            index, config=ServingConfig(**paths[name])).serve, queries)
    (s_packed, rep_packed, on_packed), (_, _, on_mxu), (_, _, on_ref) = (
        runs[name][0] for name in paths)
    launches.update(rm_packed=on_packed["rm_packed"],
                    rm_int8=on_mxu["rm_int8"])
    if min(launches["rm_packed"], launches["rm_int8"]) <= 0:
        raise AssertionError(f"a rule-match kernel was never launched: "
                             f"{launches}")
    if (on_packed["rm_int8"] or on_mxu["rm_packed"] or any(on_ref.values())
            or any(c[k] for c in (on_packed, on_mxu)
                   for k in ("packed", "int8", "intersect"))):
        raise AssertionError("a serving path launched another path's "
                             "kernel")
    want = _without_walls(rep_packed)
    for name, path_runs in runs.items():
        for results, report, on in path_runs:
            if results != s_packed:
                raise AssertionError(f"serving path {name} disagrees on "
                                     "recommendations")
            if dict(_without_walls(report), backend="cuda") != want:
                raise AssertionError(f"serving path {name} disagrees on its "
                                     "report")
            if on != path_runs[0][2]:
                raise AssertionError(f"serving path {name} launched "
                                     f"{on} then {path_runs[0][2]}")
    k = rep_packed.k
    for q, got in zip(queries[:N_ORACLE], s_packed):
        if got != recommend_bruteforce(packed.rules, q.payload, k):
            raise AssertionError(f"basket {q.payload}: {got} is not the "
                                 "brute-force oracle's answer")
    if not any(s_packed):
        raise AssertionError("no basket got a recommendation")
    print(f"serving paths agree: {N_QUERIES} recommendations, "
          f"{sum(map(bool, s_packed))} non-empty, the first {N_ORACLE} "
          "equal to recommend_bruteforce")

    # ---- 7. out-of-core SON mining of the dense corpus ----------------
    son = son_phase(torch, dev, T_all, packed, index, queries, s_packed,
                    zero_counts, read_counts)
    print(f"son walls on {_nvidia_smi('name,power.limit')}: "
          + json.dumps({k: v for k, v in son.items() if k != "launches"}))
    son_launches = son["launches"]

    # ---- 8. the LM serving path (gemma3-1b at full width) --------------
    lm = lm_phase(torch, np, dev, zero_counts, read_counts)
    launches["flash"] = lm.pop("launches")
    err["flash"] = lm.pop("max_abs_err")
    timing["flash"] = lm

    # ---- 9. the hymba-1.5b serving path (full width) -------------------
    timing["scan"], timing["flash"]["hymba"] = hymba_phase(
        torch, np, dev, zero_counts, read_counts)
    launches["scan"] = timing["scan"].pop("launches")
    err["scan"] = timing["scan"].pop("max_abs_err")

    # ---- 10. the rwkv6-7b serving path (full width) --------------------
    timing["wkv"] = rwkv_phase(torch, np, dev, zero_counts, read_counts)
    launches["wkv"] = timing["wkv"].pop("launches")
    err["wkv"] = timing["wkv"].pop("max_abs_err")

    # ---- 11. the streaming plane (the dense corpus, then a stationary tail)
    stream = stream_phase(torch, np, dev, T_all, props.multi_processor_count,
                          floor_ms, zero_counts, read_counts)
    print(f"stream on {_nvidia_smi('name,power.limit')}: " + json.dumps(
        {k: v for k, v in stream.items() if k not in ("launches", "delta")}))

    # ---- 12. the autotune plane and the cost-model policy -------------
    tuned = autotune_phase(torch, np, dev, T_all, packed, index, queries,
                           s_packed)
    print(f"autotune on {_nvidia_smi('name,power.limit')}: "
          + json.dumps(tuned))

    # ---- 13. the sharded plane ----------------------------------------
    sharded = sharded_phase(torch, np, dev, T_all, packed, walls, floor_ms,
                            zero_counts, read_counts)
    print(f"sharded on {_nvidia_smi('name,power.limit')}: "
          + json.dumps(sharded["walls"]))

    # ---- 14. the mining and serving CLIs ------------------------------
    clis = cli_phase(torch, np, dev, T_all, packed, walls, zero_counts,
                     read_counts)
    print(f"clis on {_nvidia_smi('name,power.limit')}: " + json.dumps(
        {k: clis[k] for k in ("walls", "trace", "serving")}))

    # ---- 15. the remaining LM families (full width) --------------------
    fam = families_phase(torch, np, dev, zero_counts, read_counts)
    err["flash"] = max(err["flash"], fam.pop("family_max_abs_err"))
    print(f"families on {_nvidia_smi('name,power.limit')}: "
          + json.dumps(fam["family_walls"]))
    timing["flash"].update(fam)

    # ---- 16. one-card training (gemma3-1b and hymba-1.5b whole, ------
    # ---- granite-3-8b and rwkv6-7b cut) ---------------------------------
    trained = train_phase(torch, np, dev, zero_counts, read_counts)
    timing["flash_bwd"] = trained["bwd"]
    launches["flash_bwd"] = timing["flash_bwd"].pop("launches")
    err["flash_bwd"] = timing["flash_bwd"].pop("max_abs_err")
    timing["flash"]["train_launches_per_step"] = trained[
        "fwd_train_launches_per_step"]
    timing["scan_bwd"] = trained["scan_bwd"]
    launches["scan_bwd"] = timing["scan_bwd"].pop("launches")
    err["scan_bwd"] = timing["scan_bwd"].pop("max_abs_err")
    timing["scan"]["train_launches_per_step"] = trained[
        "scan_train_launches_per_step"]
    timing["wkv_bwd"] = trained["wkv_bwd"]
    launches["wkv_bwd"] = timing["wkv_bwd"].pop("launches")
    err["wkv_bwd"] = timing["wkv_bwd"].pop("max_abs_err")
    timing["wkv"]["train_launches_per_step"] = trained[
        "wkv_train_launches_per_step"]
    print(f"training on {_nvidia_smi('name,power.limit')}: " + json.dumps(
        {k: {kk: vv for kk, vv in v.items() if kk != "losses"}
         for k, v in timing["flash_bwd"]["train"].items()}))
    hymba_train = timing["scan_bwd"]["train"]
    print(f"hymba-1.5b training on {_nvidia_smi('name,power.limit')}: "
          + json.dumps({"hymba_1_5b": {
              k: v for k, v in hymba_train["hymba_1_5b"].items()
              if k != "losses"}, "float32_step": hymba_train["float32_step"],
              "wall_s": hymba_train["wall_s"]}))
    rwkv_train = timing["wkv_bwd"]["train"]
    print(f"rwkv6-7b training on {_nvidia_smi('name,power.limit')}: "
          + json.dumps({"rwkv6_7b": {
              k: v for k, v in rwkv_train["rwkv6_7b"].items()
              if k != "losses"}, "float32_step": rwkv_train["float32_step"],
              "wall_s": rwkv_train["wall_s"]}))

    # ---- 17. the parallel plane ----------------------------------------
    t0 = time.perf_counter()
    par = parallel_phase(torch, np, dev, zero_counts, read_counts)
    par["times_s"]["phase 17 wall"] = time.perf_counter() - t0
    print(f"parallel plane on {_nvidia_smi('name,power.limit')}: "
          + json.dumps({k: par[k] for k in ("times_s", "bytes")}))

    # ---- 18. the compile surfaces (host only) ----------------------------
    t0 = time.perf_counter()
    dryrun_phase(root)
    print(f"phase 18 (the dry run's eight mini cells) wall "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- 19. result lines ---------------------------------------------
    print(_nvidia_smi("name,power.limit"))
    rows = []
    for key, name, src, replaces in (
            ("packed", "support_count_packed",
             "src/repro_torch/csrc/support_count_packed.cu",
             "src/repro/kernels/support_count/fused.py:94"),
            ("int8", "support_count_int8",
             "src/repro_torch/csrc/support_count_int8.cu",
             "src/repro/kernels/support_count/kernel.py:74"),
            ("rm_packed", "rule_match_packed",
             "src/repro_torch/csrc/rule_match_packed.cu",
             "src/repro/kernels/rule_match/fused.py:59"),
            ("rm_int8", "rule_match_int8",
             "src/repro_torch/csrc/rule_match_int8.cu",
             "src/repro/kernels/rule_match/kernel.py:72"),
            ("intersect", "intersect_count",
             "src/repro_torch/csrc/intersect_count.cu",
             "src/repro/kernels/support_count/intersect.py:63"),
            ("flash", "flash_attention",
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:96"),
            ("flash_bwd", "flash_attention_bwd",
             "src/repro_torch/csrc/flash_attention_bwd.cu",
             "src/repro/models/attention.py:98"),
            ("scan", "selective_scan",
             "src/repro_torch/csrc/selective_scan.cu",
             "src/repro/kernels/selective_scan/kernel.py:77"),
            ("wkv", "wkv6", "src/repro_torch/csrc/wkv6.cu",
             "src/repro/kernels/rwkv6_wkv/kernel.py:87"),
            ("scan_bwd", "selective_scan_bwd",
             "src/repro_torch/csrc/selective_scan_bwd.cu",
             "src/repro/models/ssm.py:118"),
            ("wkv_bwd", "wkv6_bwd", "src/repro_torch/csrc/wkv6_bwd.cu",
             "src/repro/models/rwkv6.py:65")):
        rows.append(dict(name=name, route="cuda", source=src,
                         replaces=replaces, launches=launches[key],
                         max_abs_err=err[key], ok=True, **timing[key]))
        if key == "flash_bwd":
            rows[-1]["note"] = (
                "no Pallas backward: the reference differentiates its "
                "checkpointed chunked attention with jax.value_and_grad; "
                "this kernel is the gradient of row flash_attention's "
                "function")
        if key == "scan_bwd":
            rows[-1]["note"] = (
                "no Pallas backward: the reference differentiates its "
                "lax.scan over time with jax.value_and_grad; this kernel "
                "is the gradient of row selective_scan's function")
        if key == "wkv_bwd":
            rows[-1]["note"] = (
                "no Pallas backward: the reference differentiates its "
                "lax.scan (src/repro/models/rwkv6.py:65); this kernel is "
                "the gradient of row wkv6's function")
        if rows[-1]["ms"] < 0.01:
            rows[-1]["launch_floor_ms"] = floor_ms
        rows[-1]["apriori_launches"] = clis["apriori_launches"].get(key, 0)
        rows[-1]["cli_launches"] = clis["cli_launches"].get(key, {})
        if key in son_launches:
            rows[-1]["son_launches"] = son_launches[key]
        if key in sharded["launches"]:
            rows[-1]["sharded_launches"] = sharded["launches"][key]
            rows[-1]["sharded_slabs"] = sharded["slabs"][key]
        if key in ("flash", "flash_bwd"):
            rows[-1]["parallel_launches"] = {
                path: n[key] for path, n in par["launches"].items()
                if key in n}
        if key in stream["launches"]:
            rows[-1]["stream_launches"] = stream["launches"][key]
            rows[-1]["stream_delta"] = [
                {k: v for k, v in d.items() if k != "kernel"}
                for d in stream["delta"] if d["kernel"] == key]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
