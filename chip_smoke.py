#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out results.json]

Builds the port's six CUDA kernels from the sources in this checkout,
then:

1. kernels at deployment shapes, each against its plain PyTorch version
   on the same inputs, timed with CUDA events beside its plain version
   and its bound: ``gather_distance``, ``fused_hop_l2`` and ``lsh_hash``
   over an N=1,000,000 x d=768 table (B=4096 lanes, C=64 candidates,
   L=16 beam, and the catapult init hop's C=41), ``lsh_hash`` also at
   the main path's B=256, d=24; ``pq_adc`` (by id over the code table, as
   the search path calls it, and over gathered (B, C, M) rows, the two
   bit for bit) and ``fused_hop_pq`` over a (1,000,000, 8) int32 code
   table with (4096, 8, 256) LUTs and again over (1,000,000, 96) codes
   with (4096, 96, 256) LUTs (96 KB a lane), the fused PQ hop also bit
   for bit against the composed one; ``l2_distance`` at 4096 x 4096 x 768 and
   1000 x 777, beside ``torch.cdist``, its bound taken both for its
   3xTF32 tensor-core route and for f32 outside the tensor cores;
2. the main path: ``create(IndexSpec(), corpus)`` on the tripclick
   workload (20,000 x 24, 4,096 queries) — Vamana build plus catapult
   search on the card — replayed twice in batches of 256, beside a
   ``mode="diskann"`` twin, a ``hop_backend="fused"`` twin and a CPU twin
   over the same graph, with recall against brute force; then the same
   four twins with PQ traversal and full-precision rerank
   (``IndexSpec(pq=8)``) over that graph; then, over that graph, the
   mutations (keyed upserts, a true upsert, deletes by key and a
   consolidate on a card twin and a CPU twin that must end with the same
   graph), ``mode="lsh_apg"`` and ``search_two_phase`` under both hop
   backends, and a stationary stream of uniform queries served through
   ``db.serve(max_batch=64)`` with the adapt layer's production
   ``PolicyConfig()`` on a card twin and a CPU twin; then the disk tier
   (``IndexSpec(tier="disk", pq=8)``, a CTPL store in a temporary
   directory) over the graph: catapult, fused and diskann twins in a
   cold (2 frames) and a warm (1,250 frames) cache regime, CPU twins
   over copies of the card twins' files, a pipelined twin, save /
   ``sniff`` / reopen, and mutations whose card and CPU block files must
   end byte-identical;
3. filtered search: ``make_papers(n=10,000)`` (10,000 x 24, 16 labels,
   2,048 queries, each with its own label; its default 20,000 rows are
   cut to keep the run inside its time limit), one
   ``build_stitched_graph`` on the card, then the four twins with
   ``IndexSpec(filters=True)``, at full precision and with ``pq=8``:
   every id and every catapult start on its lane's label;
4. adaptation: ``make_shifted_zipf(kind="sudden")`` (20,000 x 24, its
   graph built on the CPU by a second process while the card phases
   run) served through ``db.serve(max_batch=64)`` with the maintainer
   attached, on a card twin and a CPU twin with equal maintainer events
   and buckets, at least one drift flush after the shift and a recovered
   win share, beside a frozen-buckets twin that recovers less;
5. deployment width: 1,000,000 x 768 vectors, degree 64, over a random
   regular graph, 4 batches of 4,096 queries under both hop backends, at
   full precision and with PQ (M=8, K=256; training, encoding and LUT
   times recorded); then ``IndexSpec(pq=96)`` (96 KB LUTs) on a 20,000
   x 768 slice under both hop backends, whose ids must be equal; then
   filtered search over a stitched-shaped (1M, 64 + 32) adjacency with
   16 labels, an upsert of 64 rows and a delete of 4,096, and
   ``mode="lsh_apg"`` (its build hashes every row), all at 1M rows,
   ``consolidate`` on the 20,000-row slice, ``db.serve(max_batch=
   4096)`` at 1M rows in turns with and without the maintainer, and the
   disk tier at 1M rows (a 3.58 GB store, 62,500 cache frames): catapult,
   fused and diskann twins, 4 explained batches of 4,096 each (block
   reads, hit rate, route / fetch / rerank time, idle share), the
   engine's device memory, and a reopen; then the tiered tier over that
   store (renamed into a tiered directory, hot capacity 1,024, served 4
   batches with the ``TieredMaintainer``) and the mesh search (4 RAM
   shards, 8 virtual devices, 4 steps of 4,096);
6. in a second process on the card beside phases 2 to 5: the sharded,
   mesh and tiered tiers at the reference benches' size
   (``make_medrag_zipf(n=8,000)``): ``IndexSpec(tier=
   "sharded", pq=8)`` at S = 2 and 4 with diskann, fused and CPU twins,
   save / ``sniff`` / reopen and mutations (card and CPU shard files
   byte-identical); ``build_sharded_state`` and three mesh steps on the
   card and the CPU (equal ids and bucket tables); ``IndexSpec(tier=
   "tiered")`` replaying ``bench_substrates.run_tiered`` with a frozen-
   hot-set twin, a pure-disk control and a CPU twin (equal rebalances;
   adaptive cold reads below the frozen twin's), once more over a
   sharded cold tier, and save / reopen; then the sharded tier at 1M x
   768 (4 shards of 250,000 rows over random regular graphs, catapult
   and diskann twins: scatter, merge and per-shard stage times, block
   reads, idle share, device bytes);
7. in a third process on the card beside phases 2 to 5: streaming
   ingest.  A database born empty at deployment width (``make_medrag_
   zipf(d=768)``, degree 64, beam 16, ``PolicyConfig()``; its stream and
   ``IngestSpec`` sizes cut and printed as ``reduced:``) served through
   ``db.serve(max_batch=64, ingest=True)``, puts of 64 keyed rows in
   turns with 64-query searches, beside a CPU twin that takes the card's
   graph at each build: empty (all -1), seed (exact), the cutover, two
   growth rebuilds, a keyed re-upsert, deletes by key past the 0.25
   threshold and the maintainer's background consolidate, each stage on
   its launch formula (``IngestSpy``), the twins equal in every ext id,
   transition, key, search id and maintainer event, the streamed
   recall@10 within a point of a batch twin's, then 4 producer threads
   (distinct gids in caller order); the same on the disk, sharded (S=2)
   and tiered tiers at bench width (``make_medrag_zipf``, d=24): stream,
   ``save``, reopen on the card and on the CPU, continue with keyed
   upserts and deletes, twins equal; then the baselines: ``HnswEngine``
   over ``make_tripclick(n=4,000)``, plain against catapult over one
   hierarchy, two passes each beside CPU twins, and a Proximity cache in
   front of a database born empty at ``benchmarks/bench_dynamic.py``'s
   settings, static and with inserts (the cached answers' recall beside
   the database's; hits equal to a CPU twin cache's);
8. the LM serving path, alone on the card right after phase 1:
   gemma-2b at its published config (18 layers, d_model 2,048, 8 heads
   over 1 KV head of 256, d_ff 16,384, vocab 256,000, bf16) through
   ``python -m repro_torch.launch.serve`` at the reference driver's
   defaults (6 requests, 2 slots, prompts of 6, 8 new tokens), then its
   ``--rag`` path (256 docs of 8 tokens, catapult retrieval through
   ``repro_torch.db``, k=2), then decode-step, prefill and tokens/s
   times, the device idle share of a decode step and peak device
   memory; and in a fourth process beside phases 2 to 5, one arch per
   family at its published widths and a cut depth (gemma-2b, deepseek-
   moe-16b, falcon-mamba-7b, zamba2-7b, seamless-m4t-large-v2,
   internvl2-26b, gemma2-27b; printed as ``reduced:``): a prefill of 2 x
   16 tokens and 4 teacher-forced decode steps in bf16 and in f32 on the
   card against CPU twins with the same weights, then one ``loss_fn``
   and every gradient in f32 against the CPU twin's;
9. training, alone on the card right after phase 8: gemma-2b at its
   published config through ``python -m repro_torch.launch.train --arch
   gemma-2b --steps 20`` (the reference driver's defaults: batch 4 x 64,
   ``AdamWConfig(total_steps=20)``; no checkpoint at this width, printed
   as ``reduced:``): finite losses and grad norms, the median step ms
   over steps 3-20, the device busy ms and idle share of one more step,
   tokens/s, ``train_mfu`` against the analytic roofline, the step's byte
   bound, peak device memory; then remat against no remat at published
   widths cut to 2 layers on 2 x 1,024 tokens (flash attention's 2 x 2
   blocks of 512): the gradients agree and remat lowers peak memory;
   then the reference's drills on the card (the loss falls on reduced
   gemma-2b; reduced falcon-mamba-7b resumes from its checkpoint within
   rtol 1e-5 of a straight run); and in
   the fourth process, gemma-2b at published widths cut to 2 layers in
   f32 trains 3 steps on the card and on the CPU from one draw (losses,
   grad norms and parameters agree);
10. the mesh over ``torch.distributed``, last, in the main process: a
   world of one rank over NCCL on ``cuda:0`` (a ``file://`` store in a
   temporary directory) on a (1, 1) ``DeviceMesh``.  The 1,000,000 x
   768 table over a random regular graph of degree 64, beam 16, 3
   batches of 4,096: the rank's search step and the one-card tuple step
   from the same state, in turns, bit-equal in ids, distances, bucket
   tables and step after every batch, with equal launches; their median
   step ms, device busy ms and idle share.  Then ``reshard`` places
   gemma-2b's published-width bf16 parameters on the mesh per
   ``launch.train.build_shardings``; every ``full_tensor()`` equals its
   source bit for bit.  Then training across ranks on that mesh:
   gemma-2b at its published config (batch 4 x 64) 5 steps through
   ``launch.train.train(mesh=...)`` (every collective of
   ``models.parallel`` over NCCL) beside 5 one-device steps from the
   same seed-0 init, one after the other: step 0's loss within rtol
   1e-5, the later ones within 1e-3, no kernel launched; then the two
   steps timed in turns on one state and one of each profiled (busy ms,
   idle share, NCCL kernels' device ms), the collectives a step and
   one's host µs alone, peak device memory.  The other families train
   on a world of one of their own in the fourth process, after its LM
   twins (``phase_dist_families``, off the main process's path, which
   the time limit binds): deepseek-moe-16b at its published widths cut
   to 4 layers (1 dense + 3 MoE: the routing over the global batch, the
   experts' FSDP gathers), falcon-mamba-7b at 2 and zamba2-7b at 7
   (printed as ``reduced:``), batch 4 x 64, 5, 3 and 3 steps of
   ``train(mesh=(1, 1))`` beside as many one-device steps from the same
   seed-0 init: step 0's loss within rtol 1e-6, the later ones within
   1e-4, no kernel launched; the two steps in turns on one state (median
   ms, busy ms and idle share of one profiled step each), the
   collectives a step by kind, peak device memory.
11. the production mesh's dry run, in a fifth process beside phases 2
   to 5 (``phase_dryrun``): deepseek-moe-16b at its published widths cut
   to 4 layers, its loss and every gradient twice with deterministic
   algorithms off, bit-equal; gemma2-27b at its published widths cut to
   4 layers, a prefill of 2 x 64 and 8 decode steps on one device and
   on an NCCL world of one under a (1, 1) mesh (the serve steps'
   groups, the cache the rank's block), every step's logits and the
   cache bit-equal; then ``catapultdb x search`` on both production
   meshes on a real 1,000,000 x 768 shard, its ``lsh_hash`` and
   ``gather_distance`` launches held to ``expected_launches``.  The
   other dry-run cells, ``python -m repro_torch.launch.dryrun --device
   cuda`` (rank 0 of a fake 256- or 512-rank world, fake tensors of its
   local shapes) on gemma2-27b x train_4k (its depth cut to 4
   layers: 46 would take ~530 s of host a mesh), prefill_32k and decode_32k,
   deepseek-moe-16b x decode_32k and gemma-2b x decode_32k (refused:
   8 heads over model = 16), each on both meshes, run from before
   phase 1 as processes of the lowest CPU priority (``DryCells``: host
   work that launches nothing), read before phase 10; one line a cell.

Kernel launch counts are set to 0 just before each path (the Vamana
build, each twin's replay, and each deployment-width twin) and read just
after it; each path must show exactly the launches its batches imply
(``expected_launches``, ``two_phase_launches``, ``serve_launches``,
``hnsw_launches``; a masked search stays on the composed hop, insert
searches and builds launch ``gather_distance`` alone, deletes and
consolidates launch nothing, a database born empty launches nothing
until its cutover and its consolidate is a rebuild, a
maintainer's telemetry fold launches one ``lsh_hash`` and
its shadow and gated-off batches run the diskann path; a disk search
launches no ``gather_distance``, its rerank being on the host; a
sharded or tiered search launches, shard by shard and tier by tier,
what ``PathSpy`` records; the mesh search each virtual device's
catapult RAM step, and a rank's step as many as the tuple step; the LM
path, the training paths and the serve steps (on one device and on a
mesh) launch nothing, the dry run's search cell a rank's catapult step,
the RAG retrieval its Vamana build's and one catapult batch's).
Any failed check exits non-zero.  Prints the
card's name and power limit first, a ``{"kernels": [...]}`` line, and as
the last line ``{"ok": true, "device": {...}}``.  Imports nothing of JAX
or of the reference package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import tempfile
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12        # H100 SXM fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12       # H100 SXM TF32 tensor cores, dense
RTOL = 1e-5                    # 768-term sums added in different orders
RTOL_PQ = 1e-6                 # eight-term ADC sums in different orders
TOL_L2 = 1e-4                  # expanded against direct form (rtol, atol)
N, D, B, C, L = 1_000_000, 768, 4096, 64, 16
C_INIT = 41                    # bucket_capacity + 1 catapult starts
PQ_M, PQ_K = 8, 256            # default_pq_subspaces(768), 8-bit codes
PQ_M_WIDE = 96                 # a 96 KB LUT a lane, beyond 48 KB of shared
                               # memory without the opt-in
LSH_TRIP = (256, 24, 8)        # the main path's lsh_hash: B, d, L
PHASE1_ITERS = 8               # search_two_phase's default phase-1 budget
N_LABELS = 16                  # make_papers' categories, also at 1M rows
PAPERS_N = 10_000              # the filtered phase's corpus (default 20,000)
DEPLOY_UPSERT = 32             # rows upserted at 1M x 768 (host-bound)
SPIN_CYCLES = 2 ** 25          # ~17 ms at 1.98 GHz, before each timed run
SERVE_BATCH = 64               # the adapt phase's frontend batch
# the reference bench's (benchmarks/bench_adapt.py) shift policy: the
# stream is 64 batches, so shadows and ticks come early enough to act
SHIFT_POLICY = dict(observe_every=1, baseline_every=6, min_batches=4)
SHIFT_TICK_EVERY = 2
ADAPT_EVENTS = ("ticks", "ttl_evicted", "flushed_entries", "drift_flushes",
                "gate_transitions", "shadows", "probes")
STATIONARY_QUERIES = 12_288    # 192 batches: a shadow every 48
STATIONARY_TICK = 4
DEPLOY_FLUSHES = 16            # flushes of 4,096 at 1M x 768, each side
DISK_TWINS = (("catapult", "catapult", "unfused"),
              ("fused", "catapult", "fused"),
              ("diskann", "diskann", "unfused"))
DISK_UPSERT = 256              # keyed rows upserted into the tripclick store
DISK_REOPEN_LANES = 1024       # the 1M reopen check's publish=False batch
# the sharded and tiered phases replay the reference benches' workload,
# make_medrag_zipf(n=8,000, n_queries=2,048): bench_disk.run_sharded's
# k, beam, batch and frame budget (split over the shards) ...
BENCH_N, BENCH_Q = 8_000, 2_048
SHARD_K, SHARD_BEAM, SHARD_BATCH = 8, 16, 256
SHARD_FRAMES = 500             # max(256, n // 16) in total
SHARD_SPARE = 256              # the S=2 twin's spare rows, for mutations
MESH = (2, 4)                  # (data, model): D = 8 virtual devices
# ... and bench_substrates.run_tiered's
TIER_K, TIER_BATCH = 4, 128
TIER_FRAMES = 333              # max(128, n // 24)
TIER_POLICY = dict(observe_every=1, baseline_every=8, min_batches=4)
TIER_TICK = 2
DEPLOY_SHARDS = 4              # 250,000 rows a shard at 1M x 768
DEPLOY_HOT = 1024              # the 1M tiered layout's hot_capacity
DIST_BATCHES = 3               # the world of one's batches of 4,096
# training across ranks on the world of one: gemma-2b at its published
# config, DIST_TRAIN_STEPS steps of launch.train.train(mesh=(1, 1)) beside
# as many of the one-device train from the same seed-0 init; step 0's
# loss within DIST_LOSS0_RTOL (the same bf16 ops, only the f32 cross
# entropy's order differs), the later ones within DIST_LOSS_RTOL (bf16
# parameters updated from gradients that part by that order)
DIST_TRAIN_STEPS = 5
DIST_LOSS0_RTOL, DIST_LOSS_RTOL = 1e-5, 1e-3
COLLECTIVE_REPS = 200          # one-element all_reduces timed in a row
DIST_PAIRS = 6                 # mesh and one-device steps timed in turns
DIST_TOP_OPS = 8               # host ops listed whose time grew the most
# ... and the other families on their own world of one (the fourth card
# process, after the LM twins): published widths, depth cut, batch 4 x 64,
# launch.train.train(mesh=(1, 1)) beside as many one-device steps from the
# same seed-0 init.  The world of one runs the one-device ops (the MoE
# routing's and mamba2's norm's sums over groups of one, logsumexp's own
# backward in the vocab-parallel cross entropy) and the MoE combine adds
# in a fixed order, so every step's loss is bit-equal on an H100; held to
# DIST_FAMILY_LOSS0_RTOL at step 0 and DIST_FAMILY_LOSS_RTOL after
DIST_FAMILIES = (("deepseek-moe-16b", dict(n_layers=4), 5),   # dense + 3 MoE
                 ("falcon-mamba-7b", dict(n_layers=2), 3),
                 ("zamba2-7b", dict(n_layers=7), 3))  # 6 mamba2, shared, 1
DIST_FAMILY_LOSS0_RTOL, DIST_FAMILY_LOSS_RTOL = 1e-6, 1e-4
DIST_FAMILY_PAIRS = 3          # mesh and one-device steps timed in turns
# the dry-run phase (a fifth card process): deepseek-moe-16b's train step
# twice, deterministic algorithms off (bit-equal); gemma2-27b's prefill of
# DRY_SERVE_B x DRY_SERVE_S and DRY_SERVE_DECODE decode steps on an NCCL
# world of one against one device (bit-equal); then these dry-run cells on
# both production meshes (gemma-2b is refused: 8 heads over model = 16)
DRY_MOE = ("deepseek-moe-16b", dict(n_layers=4))     # dense + 3 MoE
DRY_SERVE = ("gemma2-27b", dict(n_layers=4))         # 2 local, 2 global
DRY_SERVE_B, DRY_SERVE_S, DRY_SERVE_DECODE = 2, 64, 8
DRY_CELLS = (("gemma2-27b", "train_4k"), ("gemma2-27b", "prefill_32k"),
             ("gemma2-27b", "decode_32k"), ("deepseek-moe-16b", "decode_32k"),
             ("gemma-2b", "decode_32k"), ("catapultdb", "search"))
DRY_REFUSED = ("gemma-2b",)
# train_4k on fakes at 46 layers is ~530 s of host a mesh on the card's
# machine, beside phases 2-5 (which it slowed by ~100 s): its depth is
# cut; `launch/dryrun.py --all` runs it whole
DRY_LAYERS = {("gemma2-27b", "train_4k"): 4}
DRY_JOBS = 2                   # fake cells at once (niced host work)
# streaming ingest: a database born empty at deployment width (d=768,
# degree 64), puts of 64 keyed rows in turns with 64-query searches.  Cut
# from make_medrag_zipf(n=4,096) and IngestSpec()'s cutover 256 and
# initial capacity 1,024 (printed as reduced:): every cutover, growth and
# consolidate is a Vamana build and every put an insert, host
# RobustPrune at d=768 (ingest_stats' cutover_ms/grow_ms); these sizes
# still run every transition, two growths included
INGEST_N = 448                 # make_medrag_zipf rows streamed
INGEST = dict(bootstrap_cutover=128, initial_capacity=256, batch_size=64)
INGEST_PUT = 64
INGEST_REUPSERT = 128          # keys put again (true upserts)
INGEST_DELETE = 0.3            # share of the keys then deleted by key
INGEST_RECALL_Q = 1_024        # queries of the streamed-vs-batch recall
INGEST_THREADS = 4             # producers of the threaded run, 2 puts each
TWIN_PARTED = 0.02             # lanes of a d=768 step the twins may part on
# ... and on the persisted tiers at bench width (d=24)
TIER_INGEST_N = 1_792          # rows of make_medrag_zipf: streamed, then
TIER_INGEST_MORE = 192         # these last ones upserted after the reopen
TIER_INGEST = dict(bootstrap_cutover=128, initial_capacity=512,
                   batch_size=64)
HNSW_N = 4_000                 # make_tripclick rows under HnswEngine
# benchmarks/bench_dynamic.py run()'s Proximity settings, on its d=24
# Zipf workload
PROX = dict(capacity=512, tau=2.0, k=5, batch=50, insert=250)
PROX_N, PROX_Q = 2_048, 300
# the LM serving path: gemma-2b at its published config through
# launch/serve at the reference driver's defaults (6 requests, 2 slots,
# prompts of 6, 8 new tokens; --rag: 256 docs of 8 tokens, k=2) ...
LM_ARCH = "gemma-2b"
LM_STEPS = 16                  # timed decode steps at the engine's batch
# ... and one arch per family at published widths and cut depth against
# its CPU twin (same weights): a prefill of 2 x 16 tokens (vlm: 256
# patches more), then 4 teacher-forced decode steps
LM_TWINS = (("gemma-2b", dict(n_layers=2)),
            ("deepseek-moe-16b", dict(n_layers=2)),      # dense + 1 MoE
            ("falcon-mamba-7b", dict(n_layers=2)),
            ("zamba2-7b", dict(n_layers=7)),    # 6 mamba2, shared, 1 tail
            ("seamless-m4t-large-v2", dict(n_layers=2, n_enc_layers=2)),
            ("internvl2-26b", dict(n_layers=2)),
            ("gemma2-27b", dict(n_layers=2)))   # one local, one global
LM_B, LM_S, LM_DECODE = 2, 16, 4
# f32 card vs f32 CPU, a share of the largest real-vocab logit: the
# reference's init (fan-in = depth for stacked weights) drives SSM states
# to ~1e5, and falcon-mamba's prefill parts by 9.4e-4 on an H100 (the
# other archs by <= 7e-4, most by <= 7e-5)
LM_TOL32 = 2e-3
# bf16: the card's bf16 logits may part from the CPU's f32 logits by at
# most twice what the CPU's own bf16 logits do, plus 1% of max |logit|
# (the CPU parity tests' rule, tests/test_torch_models.py)
LM_BF16_FACTOR, LM_BF16_FLOOR = 2.0, 0.01
LM_THREADS = 4                 # CPU twins' threads beside the other phases
# every LM twin's loss_fn and gradients, f32 card vs f32 CPU: the loss to
# LM_LOSS_RTOL, each gradient leaf within LM_GRAD_TOL of its largest |g|
# (gemma-2b, deepseek-moe, zamba2, internvl2 and gemma2-27b parted by
# 3e-5 to 7.9e-3 on an H100) or, where f32 cannot resolve a leaf
# (falcon-mamba's first layer and seamless-m4t's encoder projection part
# from a float64 run by up to 0.34 and 0.056 on the CPU), within twice
# the CPU's own f32 error against float64 (lm_grads)
LM_LOSS_RTOL, LM_GRAD_TOL = 1e-4, 1e-2
LM_GRAD_ROWS = 1               # of the LM_B rows (the CPU twins' backward
                               # runs beside phases 2-5)
# training: gemma-2b at its published config through launch/train at the
# reference driver's defaults (batch 4 x 64, AdamWConfig(total_steps=20))
TRAIN_STEPS, TRAIN_B, TRAIN_S = 20, 4, 64
TRAIN_TIMED_FROM = 3           # the median step over steps 3-20
PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16 (train_mfu's yardstick)
# remat on the card: 2 layers at published widths, 2 x 1,024 tokens (flash
# attention runs 2 x 2 blocks of 512); bf16 gradients with and without
# remat within REMAT_TOL of each leaf's largest |g| (one bf16 step is 2^-8)
REMAT_LAYERS, REMAT_B, REMAT_S, REMAT_TOL = 2, 2, 1024, 1e-2
# the reference's drills (tests/test_train_loop.py's settings)
DRILL_FALL = dict(steps=60, global_batch=8, seq_len=32)
DRILL_RESTART = dict(global_batch=4, seq_len=32)
# the fourth process's training twin: gemma-2b at published widths, 2
# layers, f32, 3 steps of 2 x 64 on the card and the CPU from one draw
TWIN_TRAIN = dict(n_layers=2, dtype="float32")
TWIN_TRAIN_STEPS, TWIN_TRAIN_B, TWIN_TRAIN_S = 3, 2, 64
# losses rtol; the first step's grad norm (one set of parameters) rtol;
# the later steps' (after an update, the parameters part by f32 error: an
# AdamW step moves an element whose gradient is near zero by up to lr in
# a direction that error picks, and the reference's init (fan-in = depth)
# amplifies it: the third step's norm parted by 2.5% on an H100);
# parameters: no element beyond TWIN_PARAM_TOL of the summed learning
# rates (two opposite updates part by about twice it; 1.62 measured), at
# most TWIN_PARAM_SHARE of them beyond 1e-3 of it (0.37% measured)
TWIN_LOSS_RTOL, TWIN_GNORM_RTOL, TWIN_GNORM_LATER_RTOL = 1e-4, 1e-4, 0.1
TWIN_PARAM_TOL, TWIN_PARAM_SHARE = 2.5, 0.05


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn`` over ``reps`` back-to-back
    calls (CUDA events).

    The card first spins (``torch.cuda._sleep``) while the host enqueues
    every call, so the events time the device's work and not the host's
    launch rate: a wrapper's checks and ctypes call take tens of µs, as
    long as the smallest kernels run.  The spin doubles until it outlasts
    the enqueue; a ``fn`` that waits on the card never lets it, and is
    timed with its host time after four doublings."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = SPIN_CYCLES
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(spin)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ev[2].record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            break
        spin *= 2
    return ev[1].elapsed_time(ev[2]) / reps


def bound(n_bytes: float, n_flops: float,
          peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def hop_ids(gen, n, b, c, l, dev):
    """Candidate and beam ids of a mid-traversal hop: -1 holes, duplicate
    candidates, a beam id among the candidates, one all -1 lane and an
    interior -1 before valid ids."""
    cand = torch.randint(0, n, (b, c), generator=gen, device=dev,
                         dtype=torch.int32)
    cand[torch.rand((b, c), generator=gen, device=dev) < 0.1] = -1
    bids = torch.randint(0, n, (b, l), generator=gen, device=dev,
                         dtype=torch.int32)
    bids[torch.rand((b, l), generator=gen, device=dev) < 0.2] = -1
    cand[:, 2] = cand[:, 1]
    cand[:, -1] = bids[:, 0]
    cand[0, 0] = -1
    cand[-1] = -1
    return cand, bids


def sorted_beam(gen, bids, bd, dev):
    """The beam in ascending distance order, about half of it expanded."""
    bd, order = torch.sort(bd, dim=1, stable=True)
    bids = bids.gather(1, order).contiguous()
    bexp = (bids < 0) | (torch.rand(bids.shape, generator=gen, device=dev)
                         < 0.5)
    return bids, bd.contiguous(), bexp


def hop_inputs(gen, vectors, b, c, l, dev):
    """A mid-traversal L2 hop at full width with true beam distances."""
    from repro_torch.kernels import ref
    n = vectors.shape[0]
    q = vectors[torch.randint(0, n, (b,), generator=gen, device=dev)] \
        + 0.1 * torch.randn((b, vectors.shape[1]), generator=gen, device=dev)
    cand, bids = hop_ids(gen, n, b, c, l, dev)
    bids, bd, bexp = sorted_beam(
        gen, bids, ref.gather_distance_ref(vectors, bids, q), dev)
    return q.contiguous(), cand, bids, bd, bexp


def pq_hop_inputs(gen, luts, codes, c, l, dev):
    """A mid-traversal PQ hop: the same id structure, true ADC beam
    distances."""
    from repro_torch.kernels import ref
    cand, bids = hop_ids(gen, codes.shape[0], luts.shape[0], c, l, dev)
    bd = ref.pq_adc_ref(luts, codes, bids)
    return (cand, *sorted_beam(gen, bids, bd, dev))


def unique_rows(ids) -> int:
    """Distinct table rows a set of ids needs (each read once)."""
    return int(torch.unique(ids[ids >= 0]).numel())


def lut_entries(luts, rows, valid) -> int:
    """Distinct LUT entries (lane, m, code) that the valid candidates'
    (B, C, M) code rows touch (each read once)."""
    b, m, k = luts.shape
    lane = torch.arange(b, device=rows.device)[:, None, None]
    sub = torch.arange(m, device=rows.device)[None, None, :]
    key = (lane * m + sub) * k + rows.long()
    return int(torch.unique(key[valid]).numel())


def dist_agreement(got, want, name, rtol=RTOL):
    check(torch.equal(torch.isfinite(got), torch.isfinite(want)),
          f"{name}: +inf positions differ from the plain version")
    m = torch.isfinite(want)
    err = (got[m] - want[m]).abs()
    check(bool((err <= rtol * want[m].abs()).all()),
          f"{name}: distances differ beyond rtol {rtol}")
    return float(err.max()) if err.numel() else 0.0


def tie_free_lanes(hop_ref, inputs, rtol):
    """Lanes whose first L+1 merged entries (an extra empty beam slot
    shows the first entry dropped) hold no two distances within 2*rtol:
    there ids and flags must equal the plain version's."""
    *head, bids, bd, bexp = inputs

    def pad(t, v):
        return torch.cat([t, torch.full((t.shape[0], 1), v, dtype=t.dtype,
                                        device=t.device)], 1)
    ext = hop_ref(*head, pad(bids, -1), pad(bd, float("inf")),
                  pad(bexp, True))[1]
    nxt = ext[:, 1:]
    return ((nxt - ext[:, :-1] > 2 * rtol * nxt.abs())
            | ~torch.isfinite(nxt)).all(1)


def phase_kernels(vectors, gen, dev) -> dict:
    """Each kernel against its plain version at deployment shapes."""
    from repro_torch.kernels import ops, ref
    out = {}

    # gather_distance: (N, d) table, (B, C) ids, (B, d) queries
    q, cand, bids, bd, bexp = hop_inputs(gen, vectors, B, C, L, dev)
    got = ops.gather_distance(vectors, cand, q)
    want = ref.gather_distance_ref(vectors, cand, q)
    err = dist_agreement(got, want, "gather_distance")
    n_valid = int((cand >= 0).sum())
    b_ms, b_by = bound(unique_rows(cand) * D * 4 + cand.numel() * 4
                       + q.numel() * 4 + got.numel() * 4, 3.0 * D * n_valid)
    out["gather_distance"] = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        ms=cuda_ms(lambda: ops.gather_distance(vectors, cand, q)),
        plain_ms=cuda_ms(lambda: ref.gather_distance_ref(vectors, cand, q),
                         reps=5),
        shape=f"N={N} d={D} B={B} C={C}", tolerance=f"rtol {RTOL}")

    # fused_hop_l2 at the traversal hop (C=64) and the init hop (C=41)
    mismatched, errs = {}, []
    for c, inputs in ((C, (q, cand, bids, bd, bexp)),
                      (C_INIT, hop_inputs(gen, vectors, B, C_INIT, L, dev))):
        hq, hc, hb, hd, he = inputs
        got = ops.fused_hop_l2(vectors, hc, hq, hb, hd, he)
        # bit for bit the composed hop: the plain merge over the gather
        # kernel's distances (both kernels reduce through row_sqdist)
        composed = ref._merge_ref(hc, ops.gather_distance(vectors, hc, hq),
                                  hb, hd, he)
        for g, w, what in zip(got, composed, ("ids", "dists", "exp",
                                              "n_fresh")):
            check(torch.equal(g, w), f"fused_hop_l2 C={c}: {what} differ "
                                     f"from the composed hop's")
        want = ref.fused_hop_ref(vectors, hc, hq, hb, hd, he)
        errs.append(dist_agreement(got[1], want[1], f"fused_hop_l2 C={c}"))
        check(torch.equal(got[3], want[3]),
              f"fused_hop_l2 C={c}: n_fresh differs from the plain version")
        tie_free = tie_free_lanes(ref.fused_hop_ref,
                                  (vectors, hc, hq, hb, hd, he), RTOL)
        lanes = ((got[0] != want[0]) | (got[2] != want[2])).any(1)
        mismatched[c] = int(lanes.sum())
        n_bad = int((lanes & tie_free).sum())
        print(f"fused_hop_l2 C={c}: ids/exp differ from the plain version on "
              f"{mismatched[c]} of {B} lanes, {n_bad} of them among the "
              f"{int(tie_free.sum())} tie-free lanes; max |err| "
              f"{errs[-1]:.3g}")
        check(n_bad == 0, f"fused_hop_l2 C={c}: ids/exp differ from the "
                          f"plain version on {n_bad} tie-free lanes")
    n_valid = int((cand >= 0).sum())
    hop_bytes = (unique_rows(cand) * D * 4 + cand.numel() * 4 + q.numel() * 4
                 + 2 * B * L * (4 + 4 + 1) + B * 4)
    b_ms, b_by = bound(hop_bytes, 3.0 * D * n_valid)
    out["fused_hop_l2"] = dict(
        max_abs_err=max(errs), bound_ms=b_ms, bound_by=b_by,
        ms=cuda_ms(lambda: ops.fused_hop_l2(vectors, cand, q, bids, bd, bexp)),
        plain_ms=cuda_ms(
            lambda: ref.fused_hop_ref(vectors, cand, q, bids, bd, bexp), reps=5),
        mismatched_lanes=mismatched,
        shape=f"N={N} d={D} B={B} C={C} L={L} (and C={C_INIT} checked)",
        tolerance=f"rtol {RTOL}; ids/exp equal except near-ties")

    # lsh_hash: (B, d) queries, (8, d) hyperplanes; then the main path's
    # tripclick shape, on a generator of its own so that the later
    # phases draw as before
    planes = torch.randn((8, D), generator=gen, device=dev)
    out["lsh_hash"] = check_lsh(q, planes, f"B={B} d={D} L=8")
    trip = torch.Generator(device=dev).manual_seed(LSH_TRIP[1])
    tq = torch.randn(LSH_TRIP[:2], generator=trip, device=dev)
    tplanes = torch.randn((LSH_TRIP[2], LSH_TRIP[1]), generator=trip,
                          device=dev)
    r = out["lsh_hash"]["tripclick"] = check_lsh(
        tq, tplanes, "B={} d={} L={}".format(*LSH_TRIP))
    out["lsh_hash"]["max_abs_err"] = max(out["lsh_hash"]["max_abs_err"],
                                         r["max_abs_err"])
    for name, r in out.items():
        print(f"{name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']})")
    r = out["lsh_hash"]["tripclick"]
    print(f"lsh_hash at {r['shape']}: {r['ms']:.4f} ms (plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms)")
    return out


def check_lsh(q, planes, shape: str) -> dict:
    """lsh_hash on (B, d) queries and (L, d) hyperplanes against its plain
    version: every query is compared, and a bit may flip only where its
    projection sits within rounding of 0.  Timed beside its bound."""
    from repro_torch.kernels import ops, ref
    b, d = q.shape
    l = planes.shape[0]
    got = ops.lsh_hash(q, planes)
    want = ref.lsh_hash_ref(q, planes)
    proj = q.double() @ planes.double().T
    scale = q.double().norm(dim=1)[:, None] * planes.double().norm(dim=1)
    near = proj.abs() <= RTOL * scale                            # (B, L)
    weights = 2 ** torch.arange(l, dtype=torch.int32, device=q.device)
    near_bits = (near.to(torch.int32) * weights).sum(1).to(torch.int32)
    diff = got ^ want
    check(not bool((diff & ~near_bits).any()),
          f"lsh_hash {shape}: a code bit differs from the plain version "
          f"where its projection is farther than {RTOL}*|q|*|h| from 0")
    n_diff = int((diff != 0).sum())
    print(f"lsh_hash {shape}: {n_diff} of {b} codes differ from the plain "
          f"version ({int(near.any(1).sum())} queries have a projection "
          f"near 0)")
    b_ms, b_by = bound((q.numel() + planes.numel() + b) * 4, 2.0 * b * l * d)
    return dict(
        max_abs_err=float(n_diff), bound_ms=b_ms, bound_by=b_by,
        ms=cuda_ms(lambda: ops.lsh_hash(q, planes)),
        plain_ms=cuda_ms(lambda: ref.lsh_hash_ref(q, planes)),
        near_zero_queries=int(near.any(1).sum()), codes_differing=n_diff,
        shape=shape,
        tolerance=f"bits equal where |proj| > {RTOL}*|q|*|h|; max_abs_err "
                  f"is the number of codes that differ")


def check_pq_hops(luts, codes, gen, dev, tag: str):
    """fused_hop_pq at the traversal hop (C=64) and the init hop (C=41):
    bit for bit the composed PQ hop, and the plain version's n_fresh,
    distances and (on tie-free lanes) ids/exp.  Returns the hop inputs by
    C, the largest distance error and the mismatched lanes by C."""
    from repro_torch.kernels import ops, ref
    inputs, errs, mismatched = {}, [], {}
    for c in (C, C_INIT):
        cand, bids, bd, bexp = inputs[c] = pq_hop_inputs(gen, luts, codes,
                                                         c, L, dev)
        name = f"fused_hop_pq {tag} C={c}"
        got = ops.fused_hop_pq(luts, codes, cand, bids, bd, bexp)
        # bit for bit the composed PQ hop: the plain merge over the
        # pq_adc kernel's sums by id (both kernels add in row_adc's m
        # order)
        composed = ref._merge_ref(cand, ops.pq_adc(luts, codes, cand), bids,
                                  bd, bexp)
        for g, w, what in zip(got, composed, ("ids", "dists", "exp",
                                              "n_fresh")):
            check(torch.equal(g, w), f"{name}: {what} differ from the "
                                     f"composed PQ hop's")
        want = ref.fused_hop_pq_ref(luts, codes, cand, bids, bd, bexp)
        errs.append(dist_agreement(got[1], want[1], name, RTOL_PQ))
        check(torch.equal(got[3], want[3]),
              f"{name}: n_fresh differs from the plain version")
        tie_free = tie_free_lanes(ref.fused_hop_pq_ref,
                                  (luts, codes, cand, bids, bd, bexp),
                                  RTOL_PQ)
        lanes = ((got[0] != want[0]) | (got[2] != want[2])).any(1)
        mismatched[c] = int(lanes.sum())
        n_bad = int((lanes & tie_free).sum())
        print(f"{name}: ids/exp differ from the plain version on "
              f"{mismatched[c]} of {B} lanes, {n_bad} of them among the "
              f"{int(tie_free.sum())} tie-free lanes; max |err| "
              f"{errs[-1]:.3g}")
        check(n_bad == 0, f"{name}: ids/exp differ from the plain version "
                          f"on {n_bad} tie-free lanes")
    return inputs, max(errs), mismatched


def check_pq_adc(luts, codes, cand, tag: str, plain: bool) -> dict:
    """pq_adc in both forms on one hop's candidates: by id over the (N, M)
    table (the form the search path calls) and over the (B, C, M) rows
    torch gathers.  The id form must equal the table form bit for bit
    (+inf at the -1 ids) and both the plain version within RTOL_PQ.  Each
    timed beside its bound: the ids, the distinct code rows (the gathered
    rows for the table form) and the distinct LUT entries the codes touch,
    read once, the (B, C) sums written once."""
    from repro_torch.kernels import ops, ref
    m = luts.shape[1]
    valid = cand >= 0
    rows = codes[cand.clamp(min=0).long()].contiguous()        # (B, C, M)
    got = ops.pq_adc(luts, codes, cand)
    table = ops.pq_adc(luts, rows)
    check(torch.equal(got, torch.where(valid, table, torch.inf)),
          f"pq_adc {tag}: the id form differs from the table form")
    err = max(dist_agreement(got, ref.pq_adc_ref(luts, codes, cand),
                             f"pq_adc {tag} by id", RTOL_PQ),
              dist_agreement(table, ref.pq_adc_ref(luts, rows),
                             f"pq_adc {tag} on rows", RTOL_PQ))
    out_bytes = got.numel() * 4
    ids_ms, ids_by = bound(cand.numel() * 4 + unique_rows(cand) * m * 4
                           + lut_entries(luts, rows, valid) * 4 + out_bytes,
                           float(int(valid.sum()) * m))
    rows_ms, rows_by = bound(rows.numel() * 4 + out_bytes
                             + lut_entries(luts, rows,
                                           torch.ones_like(valid)) * 4,
                             float(rows.numel()))
    r = dict(max_abs_err=err, bound_ms=ids_ms, bound_by=ids_by,
             ms=cuda_ms(lambda: ops.pq_adc(luts, codes, cand)),
             rows_ms=cuda_ms(lambda: ops.pq_adc(luts, rows)),
             rows_bound_ms=rows_ms, rows_bound_by=rows_by)
    if plain:
        r["plain_ms"] = cuda_ms(lambda: ref.pq_adc_ref(luts, codes, cand),
                                reps=5)
        r["rows_plain_ms"] = cuda_ms(lambda: ref.pq_adc_ref(luts, rows),
                                     reps=5)
    return r


def phase_pq_kernels(gen, dev) -> dict:
    """pq_adc (both forms) and fused_hop_pq against their plain versions
    at deployment shapes: a (1,000,000, 8) int32 code table, (4096, 8,
    256) LUTs; then the same checks with M=96 ((1,000,000, 96) codes,
    (4096, 96, 256) LUTs: 96 KB a lane)."""
    from repro_torch.kernels import ops, ref
    codes = torch.randint(0, PQ_K, (N, PQ_M), generator=gen, device=dev,
                          dtype=torch.int32)
    luts = torch.rand((B, PQ_M, PQ_K), generator=gen, device=dev)
    out = {}
    hop_inputs_by_c, hop_err, mismatched = check_pq_hops(
        luts, codes, gen, dev, f"M={PQ_M}")

    cand, bids, bd, bexp = hop_inputs_by_c[C]
    out["pq_adc"] = dict(
        **check_pq_adc(luts, codes, cand, f"M={PQ_M}", plain=True),
        shape=f"N={N} M={PQ_M} K={PQ_K} B={B} C={C} by id (rows_*: the "
              f"(B, C, M) rows torch gathers)",
        tolerance=f"rtol {RTOL_PQ}; the id form equal to the table form "
                  f"bit for bit",
        library_note="no single PyTorch call computes a batched LUT "
                     "gather-sum")
    valid = cand >= 0
    rows = codes[cand.clamp(min=0).long()]
    hop_bytes = (unique_rows(cand) * PQ_M * 4 + cand.numel() * 4
                 + lut_entries(luts, rows, valid) * 4
                 + 2 * B * L * (4 + 4 + 1) + B * 4)
    b_ms, b_by = bound(hop_bytes, float(int(valid.sum()) * PQ_M))
    out["fused_hop_pq"] = dict(
        max_abs_err=hop_err, bound_ms=b_ms, bound_by=b_by,
        ms=cuda_ms(lambda: ops.fused_hop_pq(luts, codes, cand, bids, bd,
                                            bexp)),
        plain_ms=cuda_ms(lambda: ref.fused_hop_pq_ref(luts, codes, cand, bids,
                                                      bd, bexp), reps=5),
        mismatched_lanes=mismatched,
        shape=f"N={N} M={PQ_M} K={PQ_K} B={B} C={C} L={L} "
              f"(and C={C_INIT} checked)",
        tolerance=f"rtol {RTOL_PQ}; ids/exp equal except near-ties; equal "
                  f"to the composed PQ hop bit for bit",
        library_note="no single PyTorch call computes a fused hop")
    del codes, luts, rows

    # M=96: LUTs beyond 48 KB, which neither PQ kernel stages.  Its own
    # generator leaves the draws of the later phases as they were
    # without it.
    wide = torch.Generator(device=dev).manual_seed(PQ_M_WIDE)
    codes = torch.randint(0, PQ_K, (N, PQ_M_WIDE), generator=wide,
                          device=dev, dtype=torch.int32)
    luts = torch.rand((B, PQ_M_WIDE, PQ_K), generator=wide, device=dev)
    hop_inputs_by_c, hop_err, mismatched = check_pq_hops(
        luts, codes, wide, dev, f"M={PQ_M_WIDE}")
    cand, bids, bd, bexp = hop_inputs_by_c[C]
    shape = f"N={N} M={PQ_M_WIDE} K={PQ_K} B={B} C={C} L={L}"
    out["pq_adc"]["wide"] = dict(
        **check_pq_adc(luts, codes, cand, f"M={PQ_M_WIDE}", plain=False),
        shape=shape)
    out["fused_hop_pq"]["wide"] = dict(
        shape=shape + f" (and C={C_INIT} checked)", max_abs_err=hop_err,
        mismatched_lanes=mismatched,
        ms=cuda_ms(lambda: ops.fused_hop_pq(luts, codes, cand, bids, bd,
                                            bexp)))
    for name in ("pq_adc", "fused_hop_pq"):
        r = out[name]
        r["max_abs_err"] = max(r["max_abs_err"], r["wide"]["max_abs_err"])
        print(f"{name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}); at "
              f"M={PQ_M_WIDE} {r['wide']['ms']:.4f} ms")
    for tag, r in ((f"M={PQ_M}", out["pq_adc"]),
                   (f"M={PQ_M_WIDE}", out["pq_adc"]["wide"])):
        print(f"pq_adc {tag}: by id {r['ms']:.4f} ms (bound "
              f"{r['bound_ms']:.4f}), on gathered rows {r['rows_ms']:.4f} ms "
              f"(bound {r['rows_bound_ms']:.4f})")
    return out


def phase_l2_distance(vectors, dev) -> dict:
    """l2_distance against its plain version at B = C = 4096, d = 768 and
    at a ragged 1000 x 777; library yardstick: torch.cdist squared."""
    from repro_torch.kernels import ops, ref
    errs = []
    for b, c in ((B, B), (1000, 777)):
        q, x = vectors[:b], vectors[b: b + c]
        got, want = ops.l2_distance(q, x), ref.l2_distance_ref(q, x)
        err = (got - want).abs()
        check(bool((err <= TOL_L2 + TOL_L2 * want.abs()).all()),
              f"l2_distance {b}x{c}: beyond rtol/atol {TOL_L2}")
        errs.append(float(err.max()))
    q, x = vectors[:B], vectors[B: 2 * B]
    n_bytes, n_flops = (2 * B * D + B * B) * 4, 2.0 * B * B * D
    # the kernel's route: three TF32 products on the tensor cores
    b_ms, b_by = bound(n_bytes, 3 * n_flops, PEAK_TF32_FLOPS)
    out = dict(
        max_abs_err=max(errs), bound_ms=b_ms, bound_by=b_by,
        bound_f32_ms=bound(n_bytes, n_flops)[0],
        ms=cuda_ms(lambda: ops.l2_distance(q, x)),
        plain_ms=cuda_ms(lambda: ref.l2_distance_ref(q, x), reps=5),
        library_ms=cuda_ms(lambda: torch.cdist(q, x).square()),
        shape=f"B={B} C={B} d={D} (and 1000x777 checked)",
        tolerance=f"rtol and atol {TOL_L2} (expanded form in 3xTF32 "
                  f"against the direct form in f32)",
        library_note="torch.cdist(q, x).square() with TF32 off")
    print(f"l2_distance: {out['ms']:.4f} ms (plain {out['plain_ms']:.4f} ms, "
          f"cdist {out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
          f"by {b_by} in TF32, {out['bound_f32_ms']:.4f} ms in f32); max "
          f"|err| {out['max_abs_err']:.3g}")
    return out


def device_busy_ms(fn) -> float:
    """Device-busy ms of one call of ``fn``: the union of the card's
    kernel/copy intervals in a ``torch.profiler`` trace (0.0 if the
    profiler saw no device activity)."""
    return device_activity(fn)[0]


def device_activity(fn) -> tuple[float, int]:
    """``device_busy_ms`` of one call of ``fn``, and the number of device
    kernel/copy events in its trace."""
    spans = device_events(fn)
    return busy_ms(spans), len(spans)


def device_events(fn) -> list:
    """(start µs, end µs, name) of every device kernel/copy event in a
    ``torch.profiler`` trace of one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def host_op_ms(fn) -> dict:
    """{op name: host self ms} of one call of ``fn`` (``torch.profiler``,
    CPU activity only)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.self_cpu_time_total / 1e3 for e in prof.key_averages()}


def busy_ms(spans) -> float:
    """The union of ``device_events``' intervals, in ms."""
    busy, covered = 0.0, float("-inf")
    for start, end, _ in sorted(spans):
        if end > covered:
            busy += end - max(start, covered)
            covered = end
    return busy / 1e3


def idle_share(database, queries, **kw) -> dict:
    """Wall ms of one ``publish=False`` search (unprofiled, after a warm
    call) beside its device-busy ms (profiled run of the same search)."""
    def search():
        database.search(queries, publish=False, **kw)

    search()
    t0 = time.perf_counter()
    search()
    wall = (time.perf_counter() - t0) * 1e3
    busy = device_busy_ms(search)
    return dict(wall_ms=wall, device_busy_ms=busy,
                idle_share=(1.0 - busy / wall) if busy > 0 else None)


def brute_force_knn_cuda(corpus, queries, k, dev, labels=None,
                         filter_labels=None, exclude=None):
    """Exact k-NN on the card; ``filter_labels`` (with ``labels``) keeps a
    filtered lane to its label, ``exclude`` hides rows."""
    x = torch.as_tensor(corpus, device=dev)
    lab = None if labels is None else torch.as_tensor(labels, device=dev)
    out = []
    for lo in range(0, queries.shape[0], 256):
        q = torch.as_tensor(queries[lo: lo + 256], device=dev)
        d = torch.square(q[:, None, :] - x[None]).sum(-1)
        if exclude is not None:
            d[:, torch.as_tensor(exclude, device=dev)] = torch.inf
        if filter_labels is not None:
            fl = torch.as_tensor(filter_labels[lo: lo + 256], device=dev)
            d[(lab[None, :] != fl[:, None]) & (fl[:, None] >= 0)] = torch.inf
        out.append(torch.topk(d, k, dim=1, largest=False).indices)
    return torch.cat(out).to(torch.int32).cpu().numpy()


def counted(fn):
    """Run ``fn`` with every kernel launch count set to 0 just before it;
    returns (its result, the counts read just after it)."""
    from repro_torch.kernels import ops
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    out = fn()
    torch.cuda.synchronize()
    return out, dict(ops.LAUNCHES)


def expected_launches(mode: str, hop_backend: str, loop_iters,
                      pq: bool = False, filtered: bool = False,
                      folds: int = 0, disk: bool = False) -> dict:
    """Kernel launches of a run of search batches whose beam searches
    took ``loop_iters`` loop iterations each (a batch's iterations are the
    largest ``hops`` of its lanes).  The composed hop's distance kernel
    is ``gather_distance`` at full precision and ``pq_adc`` with PQ; the
    fused hop is ``fused_hop_l2`` or ``fused_hop_pq``.  Per batch:
    catapult mode hashes once and scores the catapult starts and the
    fallback (two composed-distance launches); ``lsh_apg`` mode hashes
    once and traverses at full precision even with PQ; the init merge and
    every iteration are one composed-distance launch unfused, one
    fused-hop launch fused, and always composed on a filtered engine (a
    predicate mask keeps the search off the fused kernels); PQ reranks
    the final beam with one ``gather_distance`` launch, except on the
    disk tier (``disk``: PQ traversal, rerank on the host from the
    fetched blocks, so no ``gather_distance`` at all).  A maintainer's
    telemetry fold of a batch (``folds`` of them) hashes it once more,
    one ``lsh_hash`` launch each; its shadow and gated-off batches are
    diskann batches (``serve_launches``).  ``l2_distance`` is on no
    path."""
    nb, it = len(loop_iters), int(sum(loop_iters))
    adc = pq and mode != "lsh_apg"
    composed = "pq_adc" if adc else "gather_distance"
    fused = "fused_hop_pq" if adc else "fused_hop_l2"
    out = dict.fromkeys(("gather_distance", "lsh_hash", "fused_hop_l2",
                         "fused_hop_pq", "pq_adc", "l2_distance"), 0)
    if mode in ("catapult", "lsh_apg"):
        out["lsh_hash"] = nb
    if mode == "catapult":
        out[composed] += 2 * nb
    hop = fused if hop_backend == "fused" and not filtered else composed
    out[hop] += nb + it
    if pq and not disk:
        out["gather_distance"] += nb
    out["lsh_hash"] += folds
    return out


def serve_launches(batches, hop_backend: str) -> dict:
    """Kernel launches of served batches (``ServeSpy.batches``): a batch
    dispatched with catapults active is a catapult batch, a shadow or
    gated-off one a diskann batch, and each folded batch adds its
    ``lsh_hash``."""
    cat = expected_launches("catapult", hop_backend,
                            [b["iters"] for b in batches if b["active"]],
                            folds=sum(b["folded"] for b in batches))
    dk = expected_launches("diskann", hop_backend,
                           [b["iters"] for b in batches if not b["active"]])
    return {k: cat[k] + dk[k] for k in cat}


class ServeSpy:
    """Records what a served engine did, batch by batch, for the launch
    formula and the adaptation curve: its dispatch path, loop iterations,
    mean hops and win share over the real lanes, and whether the
    maintainer folded the batch (by wrapping ``adapt.stats.
    observe_update`` while installed).  ``freeze_at``: from that batch on
    the bucket table is put back after every search, so the batches read
    the table as it was and their publishes are discarded (the reference
    bench's frozen-buckets baseline; its stats stay real)."""

    def __init__(self, eng, freeze_at=None):
        self.eng, self.freeze_at, self.batches = eng, freeze_at, []
        self._frozen = None

    def __enter__(self):
        from repro_torch.adapt import stats as ts
        eng, real_search = self.eng, self.eng.search
        self._ts, self._observe = ts, ts.observe_update

        def search(queries, k, beam_width=None, publish_mask=None, **kw):
            real = np.asarray(publish_mask, bool)
            frozen = (self.freeze_at is not None
                      and len(self.batches) >= self.freeze_at)
            if frozen and self._frozen is None:
                self._frozen = eng._cat
            rec = dict(active=eng.catapult_active,
                       enabled=eng.catapult_enabled, folded=False)
            ids, dists, st = real_search(queries, k, beam_width=beam_width,
                                         publish_mask=publish_mask, **kw)
            if frozen:
                eng._cat = self._frozen
            rec.update(iters=int(st.hops.max()),
                       hops=float(st.hops[real].mean()),
                       won=float(st.won[real].mean()))
            self.batches.append(rec)
            return ids, dists, st

        def observe(*args, **kw):
            self.batches[-1]["folded"] = True
            return self._observe(*args, **kw)

        eng.search = search
        ts.observe_update = observe
        return self

    def __exit__(self, *exc):
        del self.eng.search              # the bound method again
        self._ts.observe_update = self._observe
        return False

    def wins(self) -> np.ndarray:
        """Per-batch catapult win share, scored as the reference's
        adaptation bench scores it: a shadow batch (gate on, one-batch
        diskann override) carries the last value, a gated-off batch
        scores 0."""
        out = []
        for b in self.batches:
            if b["active"]:
                out.append(b["won"])
            elif b["enabled"] and out:
                out.append(out[-1])
            else:
                out.append(0.0)
        return np.asarray(out)


def adaptation_metrics(wins, shift_batch: int, batch: int):
    """(pre-shift win, post-shift win, recovery queries | -1), computed
    as the reference's ``benchmarks/bench_adapt.adaptation_metrics``:
    recovery is the first post-shift batch whose 2-batch smoothed win
    share regains 0.9 of the pre-shift level."""
    n = wins.size
    tail = max(2, shift_batch // 4)
    pre = float(wins[shift_batch - tail: shift_batch].mean())
    post = float(wins[-max(2, (n - shift_batch) // 4):].mean())
    for j in range(shift_batch, n):
        if wins[max(shift_batch, j - 1): j + 1].mean() >= 0.9 * pre:
            return pre, post, (j - shift_batch + 1) * batch
    return pre, post, -1


def serve_stream(fe, queries, batch: int, on_flush=None) -> list:
    """Submit ``batch`` tickets and flush, over the whole stream; returns
    each flush's host ms (its results are on the host when it returns).
    ``on_flush(i)`` runs after flush i."""
    ms = []
    for i, lo in enumerate(range(0, queries.shape[0], batch)):
        for q in queries[lo: lo + batch]:
            fe.submit(q)
        t0 = time.perf_counter()
        fe.flush()
        ms.append((time.perf_counter() - t0) * 1e3)
        if on_flush is not None:
            on_flush(i)
    return ms


def two_phase_launches(mode: str, hop_backend: str, hops,
                       phase1_iters: int) -> dict:
    """Kernel launches of one ``search_two_phase`` batch from its summed
    ``hops``.  Phase 1 (full precision, unfiltered; the diskann path in
    every mode but catapult) runs ``phase1_iters`` iterations when any lane
    straggles, and a straggler was active in all of them, so lanes with
    more hops are exactly the stragglers; phase 2 is one more search over
    them, from their phase-1 beams, of ``max(hops) - phase1_iters``
    iterations."""
    top = int(np.max(hops))
    first = "catapult" if mode == "catapult" else "diskann"
    if top <= phase1_iters:
        return expected_launches(first, hop_backend, [top])
    one = expected_launches(first, hop_backend, [phase1_iters])
    two = expected_launches("diskann", hop_backend, [top - phase1_iters])
    return {k: one[k] + two[k] for k in one}


def replay(database, queries, batch=256, passes=2, filter_labels=None,
           two_phase=False, k=10, beam_width=None):
    """Replay the queries in order, ``passes`` times; per-pass results
    (with ``block_reads`` and ``cache_hits`` on the disk tiers).
    ``two_phase`` replays through ``search_two_phase`` (phase 1 of
    ``PHASE1_ITERS`` iterations) instead of ``Database.search``."""
    res = []
    for _ in range(passes):
        ids, hops, used, won, ms, iters = [], [], [], [], [], []
        reads, hits = [], []
        for lo in range(0, queries.shape[0], batch):
            q = queries[lo: lo + batch]
            t0 = time.perf_counter()
            if two_phase:
                got, _, st = database.backend.search_two_phase(
                    q, k=10, phase1_iters=PHASE1_ITERS)
            else:
                got, _, st = database.search(
                    q, k=k, beam_width=beam_width,
                    filter_labels=None if filter_labels is None
                    else filter_labels[lo: lo + batch])
            ms.append((time.perf_counter() - t0) * 1e3)
            ids.append(got)
            hops.append(st.hops)
            used.append(st.used)
            won.append(st.won)
            iters.append(int(st.hops.max()))
            if st.block_reads is not None:
                reads.append(st.block_reads)
                hits.append(st.cache_hits)
        res.append(dict(ids=np.concatenate(ids), hops=np.concatenate(hops),
                        used=np.concatenate(used), won=np.concatenate(won),
                        batch_hops=hops, batch_ms=ms, loop_iters=iters))
        if reads:
            res[-1].update(block_reads=np.concatenate(reads),
                           cache_hits=np.concatenate(hits))
    return res


def path_launches(mode, hb, passes, pq=False, filtered=False,
                  two_phase=False, disk=False) -> dict:
    """What a replay's batches imply: ``expected_launches`` over their
    loop iterations, or ``two_phase_launches`` batch by batch."""
    if not two_phase:
        return expected_launches(mode, hb,
                                 [i for p in passes for i in p["loop_iters"]],
                                 pq=pq, filtered=filtered, disk=disk)
    out = expected_launches(mode, hb, [])
    for p in passes:
        for hops in p["batch_hops"]:
            for name, n in two_phase_launches(mode, hb, hops,
                                              PHASE1_ITERS).items():
                out[name] += n
    return out


def spy_starts(fn):
    """Run ``fn`` with ``core.catapult``'s beam search wrapped so that the
    start ids of every call are kept (host copies, in call order)."""
    from repro_torch.core import catapult as cat_mod
    real, seen = cat_mod.beam_search, []

    def spy(adjacency, queries, start_ids, *args, **kw):
        seen.append(start_ids.cpu().numpy())
        return real(adjacency, queries, start_ids, *args, **kw)

    cat_mod.beam_search = spy
    try:
        return fn(), seen
    finally:
        cat_mod.beam_search = real


def off_label(ids, fl, labels) -> int:
    """Ids >= 0 of filtered lanes whose label is not the lane's."""
    lane = np.broadcast_to(fl[:, None], ids.shape)
    bad = (ids >= 0) & (lane >= 0) & (labels[np.maximum(ids, 0)] != lane)
    return int(bad.sum())


def pq_stages(database, queries, dev, **kw) -> dict:
    """Where a PQ batch's time goes: LUT build (CUDA events), and the
    route (LUT, ADC hops, publish) and rerank stages of an explained
    ``publish=False`` search (host clock, each synced)."""
    from repro_torch.core import pq
    eng = database.backend
    qd = torch.as_tensor(queries, device=dev)
    database.search(queries, publish=False, explain=True, **kw)
    tr = database.search(queries, publish=False, explain=True, **kw)
    return dict(lut_ms=cuda_ms(lambda: pq.query_luts(eng._pq, qd), reps=10),
                route_ms=tr.stage_ms("route"),
                rerank_ms=tr.stage_ms("rerank"), total_ms=tr.total_ms)


def replay_twins(wl, truth, graph, dev, pq=None, built=None,
                 filtered=False) -> dict:
    """Replay the workload twice through the catapult, diskann and fused
    twins over one graph (``built`` serves as the catapult twin) and a
    CPU twin of the catapult one, each path's launches counted; the
    gates every traversal must pass, at full precision or with PQ.

    ``filtered``: every twin is ``IndexSpec(filters=True)`` over the
    workload's labels and ``graph`` is (adjacency, medoid, label
    entries); each query carries its own label.  The gates then are the
    predicate on every returned id and on every start of the catapult
    twin (its catapult destinations and label entries), fused ids equal
    to unfused ids, catapult pass-2 hops below diskann's, catapult
    recall@10 within 1 point of diskann's and the CPU twin within 1
    point of the card."""
    from repro_torch import db
    from repro_torch.core.engine import recall_at_k
    prefix = ("filtered_" if filtered else "") + ("pq_" if pq else "")
    fl = wl.filter_labels if filtered else None
    labels = wl.labels if filtered else None
    twins, runs, paths, starts = {}, {}, {}, []
    for name, mode, hb in (("catapult", "catapult", "unfused"),
                           ("diskann", "diskann", "unfused"),
                           ("fused", "catapult", "fused")):
        def drive(name=name, mode=mode, hb=hb):
            d = built if built is not None and name == "catapult" else \
                db.create(db.IndexSpec(mode=mode, hop_backend=hb, pq=pq,
                                       filters=filtered),
                          wl.corpus, labels, prebuilt=graph)
            if filtered and name == "catapult":
                passes, seen = spy_starts(
                    lambda: replay(d, wl.queries, filter_labels=fl))
                starts.extend(seen)
                return d, passes
            return d, replay(d, wl.queries, filter_labels=fl)

        (twins[name], runs[name]), paths[prefix + name] = counted(drive)
        want = path_launches(mode, hb, runs[name], pq=bool(pq),
                             filtered=filtered)
        check(paths[prefix + name] == want,
              f"{prefix}{name} replay launched {paths[prefix + name]}, its "
              f"batches imply {want}")
    tail = {} if fl is None else dict(filter_labels=fl[-256:])
    profiled = {name: idle_share(d, wl.queries[-256:], k=10, **tail)
                for name, d in twins.items()}
    cpu_twin = db.create(db.IndexSpec(pq=pq, filters=filtered), wl.corpus,
                         labels, prebuilt=graph, device="cpu")
    runs["cpu"] = replay(cpu_twin, wl.queries, filter_labels=fl)

    out = {"launches": paths, "one_batch_256": profiled}
    if pq:
        out["stages_batch_256"] = pq_stages(twins["catapult"],
                                            wl.queries[-256:], dev, k=10,
                                            **tail)
    for name, passes in runs.items():
        for i, p in enumerate(passes):
            out[f"{name}_pass{i + 1}"] = dict(
                recall_at_10=recall_at_k(p["ids"], truth),
                mean_hops=float(p["hops"].mean()),
                used=float(p["used"].mean()),
                batch_ms_mean=float(np.mean(p["batch_ms"])),
                batch_ms_p50=float(np.median(p["batch_ms"])))
    for k, v in out.items():
        print(f"main path {prefix}{k}: {v}")
    what = ("filtered " if filtered else "") + ("PQ " if pq else "")
    c1, c2 = out["catapult_pass1"], out["catapult_pass2"]
    dk = out["diskann_pass2"]
    if filtered:
        bad = {name: sum(off_label(p["ids"], fl, labels) for p in passes)
               for name, passes in runs.items()}
        out["off_label_ids"] = bad
        check(not any(bad.values()), f"{what}search returned ids off their "
                                     f"lane's label: {bad}")
        # the catapult twin's starts, batch by batch: catapult
        # destinations and the label entry, all on the lane's label
        nq = wl.queries.shape[0]
        lanes = np.concatenate([fl[lo: lo + 256] for _ in range(2)
                                for lo in range(0, nq, 256)])
        st = np.concatenate(starts)
        out["catapult_starts"] = dict(
            lanes=int(st.shape[0]), valid=int((st >= 0).sum()),
            catapult=int((st[:, :-1] >= 0).sum()),
            off_label=off_label(st, lanes, labels))
        print(f"main path {prefix}catapult starts: {out['catapult_starts']}")
        check(st.shape[0] == lanes.size and out["catapult_starts"]
              ["off_label"] == 0 and out["catapult_starts"]["catapult"] > 0,
              f"{what}catapult twin started a filtered lane off its label "
              f"(or from no catapult at all): {out['catapult_starts']}")
    else:
        check(c2["mean_hops"] < c1["mean_hops"],
              f"{what}catapult hops did not fall on the second pass")
        check(c2["used"] >= 0.9, f"{what}catapult used {c2['used']} < 0.9")
    check(c2["mean_hops"] < dk["mean_hops"],
          f"{what}catapult hops are not below diskann's")
    check(c2["recall_at_10"] >= dk["recall_at_10"] - 0.01,
          f"{what}catapult recall fell more than 1 point below diskann's")
    for i in (1, 2):
        check(abs(out[f"cpu_pass{i}"]["recall_at_10"]
                  - out[f"catapult_pass{i}"]["recall_at_10"]) <= 0.01,
              f"the {what}CPU twin's recall is not within 1 point of the "
              f"card's")
        check(np.array_equal(runs["fused"][i - 1]["ids"],
                             runs["catapult"][i - 1]["ids"]),
              f"{what}hop_backend='fused' ids differ from 'unfused'")
    return out


def phase_main_path(seed: int, dev) -> dict:
    """The tripclick workload: the Vamana build, then the full-precision
    twins and the PQ twins (``IndexSpec(pq=8)``, d=24 so ds=3) over the
    built graph; then, over the same graph, the mutations, ``lsh_apg``
    and ``search_two_phase``."""
    from repro_torch import db
    from repro_torch.data import make_tripclick

    wl = make_tripclick(seed=seed)
    truth = brute_force_knn_cuda(wl.corpus, wl.queries, 10, dev)

    def build():
        t0 = time.perf_counter()
        return db.create(db.IndexSpec(), wl.corpus), time.perf_counter() - t0

    (cat, build_s), built = counted(build)
    check(built["gather_distance"] > 0
          and not any(n for k, n in built.items() if k != "gather_distance"),
          f"the Vamana build's searches did not run on the gather-distance "
          f"kernel alone: {built}")
    graph = (cat.backend._adj_np.copy(), cat.backend.medoid)
    out = replay_twins(wl, truth, graph, dev, built=cat)
    out["build_s"] = build_s
    out["launches"]["build"] = built
    out["pq"] = replay_twins(wl, truth, graph, dev, pq=8)
    for name, fn in (("mutations", phase_mutations), ("modes", phase_modes),
                     ("adapt_stationary", lambda *a: phase_adapt_stationary(
                         *a, seed)), ("disk", phase_disk)):
        t0 = time.perf_counter()
        out[name] = fn(wl, graph, dev)
        out[name]["seconds"] = time.perf_counter() - t0
        print(f"phase {name}: {out[name]['seconds']:.1f} s", flush=True)
    return out


def copy_store(src: str, dst: str) -> None:
    """A CTPL file and its ``.io.json``: a twin opens the copy."""
    shutil.copyfile(src, dst)
    shutil.copyfile(src + ".io.json", dst + ".io.json")


def disk_pass_stats(p: dict) -> dict:
    reads = p["block_reads"].astype(np.float64)
    hits = p["cache_hits"].astype(np.float64)
    return dict(mean_hops=float(p["hops"].mean()),
                block_reads_per_query=float(reads.mean()),
                cache_hits_per_query=float(hits.mean()),
                hit_rate=float(hits.sum() / max((hits + reads).sum(), 1.0)),
                used=float(p["used"].mean()),
                batch_ms_mean=float(np.mean(p["batch_ms"])))


def twin_agreement(a: list, b: list) -> dict:
    """Share of queries whose ids (all k), hops, block reads and cache
    hits are equal in two replays, over both passes."""
    out = {}
    for fld in ("ids", "hops", "block_reads", "cache_hits"):
        eq = [(x[fld] == y[fld]).reshape(x[fld].shape[0], -1).all(1)
              for x, y in zip(a, b)]
        out[fld] = float(np.concatenate(eq).mean())
    return out


def phase_disk(wl, graph, dev) -> dict:
    """The disk tier over the tripclick graph, ``IndexSpec(tier="disk",
    pq=8)`` with the store in a temporary directory, replayed twice in
    batches of 256 at the disk engine's default beam (max(3k, 24) = 30).

    * twins: catapult, fused catapult and diskann on the card, in two
      cache regimes (``benchmarks/bench_disk.py``'s "cold", 2 frames,
      and "warm", corpus/16 = 1,250 frames); in each regime a CPU twin
      of each opens a copy of the card twin's file (same codebook).
      Fused and unfused, and card and CPU, ids, hops, block reads and
      cache hits are equal; catapult's pass-2 block reads per query are
      below diskann's in both regimes; one explained batch of each warm
      twin splits its time into route, fetch and rerank;
    * an ``IoSpec(pipeline=True)`` twin returns the synchronous twin's
      ids and hops;
    * reopen: the warm catapult twin, its maintainer attached, is
      ``save()``d; ``sniff`` gives ('disk', 3) and the reopened
      database's ``publish=False`` ids and distances equal the live
      one's;
    * mutations: a keyed upsert of 256 rows, a delete of half of them by
      key and a consolidate on a card twin and a CPU twin that opened a
      copy of its file; after every step the two block files are
      byte-identical;
    * launches: every search path launches what ``expected_launches(...,
      pq=True, disk=True)`` gives, ``gather_distance`` never (the rerank
      is on the host); an upsert's insert search ``gather_distance``
      alone; a delete and a consolidate nothing."""
    from repro_torch import db
    from repro_torch.core.engine import recall_at_k
    truth = brute_force_knn_cuda(wl.corpus, wl.queries, 10, dev)
    n = wl.corpus.shape[0]
    regimes = {"cold": 2, "warm": max(256, n // 16)}
    out, paths, runs, opened, cards = {}, {}, {}, [], {}
    tmp = tempfile.mkdtemp(prefix="disk_")

    def spec(tag, frames, **kw):
        return db.IndexSpec(tier="disk", pq=8, cache_frames=frames,
                            path=os.path.join(tmp, f"{tag}.ctpl"), **kw)

    try:
        for regime, frames in regimes.items():
            for name, mode, hb in DISK_TWINS:
                tag = f"disk_{regime}_{name}"

                def drive(tag=tag, frames=frames, mode=mode, hb=hb):
                    d = cards[tag] = db.create(
                        spec(tag, frames, mode=mode, hop_backend=hb),
                        wl.corpus, prebuilt=graph)
                    opened.append(d)
                    return replay(d, wl.queries)

                runs[tag], paths[tag] = counted(drive)
                want = path_launches(mode, hb, runs[tag], pq=True, disk=True)
                check(paths[tag] == want and paths[tag]["gather_distance"]
                      == 0, f"{tag} replay launched {paths[tag]}, its "
                            f"batches imply {want}")
                dst = os.path.join(tmp, f"{tag}_cpu.ctpl")
                copy_store(cards[tag].spec.path, dst)
                c = db.open(dst, mode=mode, spec=db.IndexSpec(
                    hop_backend=hb, cache_frames=frames), device="cpu")
                opened.append(c)
                runs[tag + "_cpu"] = replay(c, wl.queries)
            for i in range(2):
                for fld in ("ids", "hops", "block_reads", "cache_hits"):
                    check(np.array_equal(
                        runs[f"disk_{regime}_fused"][i][fld],
                        runs[f"disk_{regime}_catapult"][i][fld]),
                        f"disk {regime}: hop_backend='fused' {fld} differ "
                        f"from 'unfused' (pass {i + 1})")
        for tag, passes in runs.items():
            for i, p in enumerate(passes):
                out[f"{tag}_pass{i + 1}"] = dict(
                    disk_pass_stats(p),
                    recall_at_10=recall_at_k(p["ids"], truth))
        for regime in regimes:
            c2 = out[f"disk_{regime}_catapult_pass2"]
            d2 = out[f"disk_{regime}_diskann_pass2"]
            check(c2["block_reads_per_query"] < d2["block_reads_per_query"],
                  f"disk {regime}: catapult's pass-2 block reads a query "
                  f"{c2['block_reads_per_query']} are not below diskann's "
                  f"{d2['block_reads_per_query']}")
            check(c2["mean_hops"] < out[f"disk_{regime}_catapult_pass1"]
                  ["mean_hops"], f"disk {regime}: catapult hops did not "
                                 f"fall on the second pass")
        for tag in cards:
            agree = twin_agreement(runs[tag], runs[tag + "_cpu"])
            out[f"{tag}_cpu_agreement"] = agree
            check(all(v == 1.0 for v in agree.values()),
                  f"{tag}: the CPU twin over the same file differs from the "
                  f"card twin (shares of queries equal: {agree})")
        for name, _, _ in DISK_TWINS:
            tag = f"disk_warm_{name}"
            # where a batch's time goes: one explained publish=False batch
            tr = cards[tag].search(wl.queries[-256:], k=10, publish=False,
                                   explain=True)
            out[f"{tag}_stages_batch_256"] = dict(
                total_ms=tr.total_ms,
                **{f"{st}_ms": tr.stage_ms(st)
                   for st in ("route", "fetch", "rerank")})

        # the async I/O pipeline: results of the synchronous engine
        def piped():
            d = db.create(spec("disk_pipeline", regimes["warm"],
                               io=db.IoSpec(pipeline=True)), wl.corpus,
                          prebuilt=graph)
            opened.append(d)
            return d, replay(d, wl.queries)

        (pd, pruns), paths["disk_pipeline"] = counted(piped)
        want = path_launches("catapult", "unfused", pruns, pq=True, disk=True)
        check(paths["disk_pipeline"] == want,
              f"disk pipeline replay launched {paths['disk_pipeline']}, its "
              f"batches imply {want}")
        for i in range(2):
            for fld in ("ids", "hops"):
                check(np.array_equal(pruns[i][fld],
                                     runs["disk_warm_catapult"][i][fld]),
                      f"IoSpec(pipeline=True): {fld} differ from the "
                      f"synchronous engine's (pass {i + 1})")
        out["disk_pipeline_io"] = pd.io_stats()._asdict()

        # save, sniff, reopen
        warm_cat = cards["disk_warm_catapult"]
        t0 = time.perf_counter()
        warm_cat.attach_maintainer()
        warm_cat.save()
        out["disk_save_s"] = time.perf_counter() - t0
        path = warm_cat.spec.path
        out["disk_sniff"] = db.sniff(path)
        check(out["disk_sniff"] == ("disk", 3),
              f"sniff gave {out['disk_sniff']}")
        t0 = time.perf_counter()
        back = db.open(path, spec=db.IndexSpec(cache_frames=regimes["warm"]))
        opened.append(back)
        out["disk_reopen_s"] = time.perf_counter() - t0
        q = wl.queries[-256:]
        live = warm_cat.search(q, k=10, publish=False)
        got, paths["disk_reopen"] = counted(
            lambda: back.search(q, k=10, publish=False))
        want = expected_launches("catapult", "unfused",
                                 [int(got.stats.hops.max())], pq=True,
                                 disk=True)
        check(paths["disk_reopen"] == want,
              f"the reopened search launched {paths['disk_reopen']}, its "
              f"batch implies {want}")
        check(np.array_equal(got.ids, live.ids)
              and got.dists.tobytes() == live.dists.tobytes(),
              "the reopened disk database's publish=False results differ "
              "from the live one's")
        out["disk_mutations"] = disk_mutations(wl, graph, spec, regimes,
                                               paths, opened, tmp)
    finally:
        for d in opened:
            d.close()
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = paths
    for k, v in out.items():
        if k != "launches":
            print(f"disk {k}: {v}")
    return out


def disk_mutations(wl, graph, spec, regimes, paths, opened, tmp) -> dict:
    """Keyed upsert of ``DISK_UPSERT`` rows, delete of half of them by key,
    consolidate: a card twin and a CPU twin over a copy of its file end
    every step with byte-identical block files; no dead id returned."""
    from repro_torch import db
    rng = np.random.default_rng(DISK_UPSERT)
    n = wl.corpus.shape[0]
    new = (wl.corpus[rng.integers(0, n, DISK_UPSERT)]
           + 0.25 * rng.normal(size=(DISK_UPSERT, wl.corpus.shape[1]))
           ).astype(np.float32)
    keys = list(range(DISK_UPSERT))
    card = db.create(spec("disk_mut", regimes["warm"],
                          spare_capacity=DISK_UPSERT), wl.corpus,
                     prebuilt=graph)
    opened.append(card)
    cpu_path = os.path.join(tmp, "disk_mut_cpu.ctpl")
    copy_store(card.spec.path, cpu_path)
    cpu = db.open(cpu_path, spec=db.IndexSpec(cache_frames=regimes["warm"]),
                  device="cpu")
    opened.append(cpu)
    out = {}
    for name, fn in (("upsert", lambda d: d.upsert(new, keys=keys)),
                     ("delete", lambda d: d.delete(keys=keys[128:])),
                     ("consolidate", lambda d: d.consolidate())):
        t0 = time.perf_counter()
        got, paths[f"disk_mutation_{name}"] = counted(lambda: fn(card))
        out[f"{name}_s"] = time.perf_counter() - t0
        fn(cpu)
        n_calls = paths[f"disk_mutation_{name}"]
        if name == "upsert":
            gids = got
            check(n_calls["gather_distance"] > 0
                  and sum(n_calls.values()) == n_calls["gather_distance"],
                  f"the disk upsert's insert searches launched {n_calls}")
            check(tuple(card.backend._vec.shape) == (1, wl.corpus.shape[1]),
                  "the disk upsert left a vector table on the card")
        else:
            check(not any(n_calls.values()),
                  f"disk {name} launched {n_calls}")
        same = Path(card.spec.path).read_bytes() == Path(cpu_path).read_bytes()
        out[f"{name}_files_identical"] = same
        check(same, f"disk mutation {name}: the card twin's block file "
                    f"differs from the CPU twin's")
    dead = gids[128:]
    r = card.search(new, k=10)
    out["dead_returned"] = int(np.isin(r.ids, dead).sum())
    out["upserted_own_top1"] = float(np.mean(r.ids[:128, 0] == gids[:128]))
    check(out["dead_returned"] == 0, f"dead ids came back: {out}")
    return out


def deploy_disk(vec_np, graph, queries, paths, dev, tmp) -> dict:
    """1,000,000 x 768 on the disk tier: ``IndexSpec(tier="disk", pq=8)``
    writes 1,000,000 blocks of 3,584 B; cache frames corpus/16 = 62,500
    (bench_disk's warm regime); the disk engine's default beam
    (max(3k, 24) = 30).  Catapult unfused (the created database), catapult
    fused and diskann unfused (each ``open``ed over the same file) run 4
    batches of 4,096, explained: per batch the route, fetch and rerank
    times, per query the block reads and cache hits; the last batch of
    each under the profiler (device busy time, idle share).  The engine's
    device memory after ``create`` and after ``open`` must stay well
    under the vector table's; ``gather_distance`` never launches; the
    catapult database, saved with its maintainer attached and reopened,
    returns the live ids with ``publish=False``.  The store stays in
    ``tmp`` (the caller's) for the tiered phase."""
    from repro_torch import db
    from repro_torch.store.layout import HEADER_SIZE, block_size_for
    out, dbs = {}, {}
    n = N
    store_bytes = HEADER_SIZE + n * block_size_for(D, 64)
    free = shutil.disk_usage(tmp).free
    out.update(store_bytes=store_bytes, free_disk_bytes=free)
    print(f"deployment disk: {free / 1e9:.1f} GB free where the store goes, "
          f"the store takes {store_bytes / 1e9:.2f} GB", flush=True)
    if free < 2 * store_bytes:
        n = max(20_000, int(N * free / (2 * store_bytes)) // 1000 * 1000)
        print(f"reduced: the disk deployment phase stores {n:,} rows, not "
              f"{N:,}: {free / 1e9:.1f} GB free where the store goes",
              flush=True)
    adj = graph[0] if n == N else np.where(graph[0][:n] < n, graph[0][:n], -1)
    frames = n // 16
    table_bytes = n * D * 4
    path = os.path.join(tmp, "deploy.ctpl")
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        d, paths["deployment_disk_create"] = counted(lambda: db.create(
            db.IndexSpec(tier="disk", path=path, dim=D, degree=64, pq=PQ_M,
                         cache_frames=frames), vec_np[:n],
            prebuilt=(adj, graph[1] if n == N else 0)))
        out["create_s"] = time.perf_counter() - t0
        dbs["catapult_unfused"] = d
        check(not any(paths["deployment_disk_create"].values()),
              f"deployment disk: create launched "
              f"{paths['deployment_disk_create']}")
        out["device_bytes_after_create"] = torch.cuda.memory_allocated() - base
        out["vector_table_bytes"] = table_bytes
        for name, mode, hb in (("catapult_fused", "catapult", "fused"),
                               ("diskann_unfused", "diskann", "unfused")):
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            dbs[name] = db.open(path, mode=mode, spec=db.IndexSpec(
                hop_backend=hb, cache_frames=frames))
            out[f"open_s_{name}"] = time.perf_counter() - t0
            out[f"device_bytes_after_open_{name}"] = \
                torch.cuda.memory_allocated() - before
        for key in [k for k in out if k.startswith("device_bytes_after")]:
            check(out[key] < table_bytes / 4,
                  f"deployment disk: the engine holds {out[key]} bytes on "
                  f"the card ({key}), not well under the {table_bytes}-byte "
                  f"vector table")
        ids = {}
        for name, d in dbs.items():
            mode, hb = name.split("_")
            traces, busy = [], []

            def drive(d=d, traces=traces, busy=busy):
                for i in range(4):
                    def one(i=i):
                        traces.append(d.search(queries[i * B: (i + 1) * B],
                                               k=10, explain=True))
                    if i == 3:
                        busy.append(device_busy_ms(one))
                    else:
                        one()

            _, paths[f"deployment_disk_{name}"] = counted(drive)
            iters = [int(t.hops.max()) for t in traces]
            want = expected_launches(mode, hb, iters, pq=True, disk=True)
            check(paths[f"deployment_disk_{name}"] == want
                  and want["gather_distance"] == 0,
                  f"deployment disk {name}: launched "
                  f"{paths[f'deployment_disk_{name}']}, its batches imply "
                  f"{want}")
            ids[name] = np.concatenate([t.ids for t in traces])
            reads = np.concatenate([t.blocks_read for t in traces])
            hits = np.concatenate([t.cache_hits for t in traces])
            last = traces[-1]
            out[name] = dict(
                batch_ms=[t.total_ms for t in traces],
                route_ms=[t.stage_ms("route") for t in traces],
                fetch_ms=[t.stage_ms("fetch") for t in traces],
                rerank_ms=[t.stage_ms("rerank") for t in traces],
                loop_iterations=iters,
                mean_hops=float(np.mean([t.hops.mean() for t in traces])),
                block_reads_per_query=float(reads.mean()),
                cache_hits_per_query=float(hits.mean()),
                hit_rate=float(hits.sum() / max(hits.sum() + reads.sum(), 1)),
                used=float(np.mean([t.catapult_used for t in traces]) / B),
                last_batch=dict(wall_ms=last.total_ms,
                                device_busy_ms=busy[0],
                                idle_share=(1.0 - busy[0] / last.total_ms)
                                if busy[0] > 0 else None),
                io_stats=d.io_stats()._asdict())
            print(f"deployment disk {name}: {out[name]}", flush=True)
        check(np.array_equal(ids["catapult_unfused"], ids["catapult_fused"]),
              "deployment disk: fused and unfused ids differ")
        cat = dbs["catapult_unfused"]
        cat.attach_maintainer()
        t0 = time.perf_counter()
        cat.save()
        out["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dbs["reopened"] = back = db.open(path, spec=db.IndexSpec(
            cache_frames=frames))
        out["reopen_s"] = time.perf_counter() - t0
        q = queries[:DISK_REOPEN_LANES]
        live = cat.search(q, k=10, publish=False)
        got, paths["deployment_disk_reopen"] = counted(
            lambda: back.search(q, k=10, publish=False))
        want = expected_launches("catapult", "unfused",
                                 [int(got.stats.hops.max())], pq=True,
                                 disk=True)
        check(paths["deployment_disk_reopen"] == want,
              f"deployment disk: the reopened search launched "
              f"{paths['deployment_disk_reopen']}, its batch implies {want}")
        out["reopen_ids_equal"] = bool(np.array_equal(got.ids, live.ids))
        check(out["reopen_ids_equal"], "deployment disk: the reopened "
                                       "database's publish=False ids differ "
                                       "from the live one's")
    finally:
        for d in dbs.values():
            d.close()
    out["rows"] = n
    print("deployment disk: " + str({k: v for k, v in out.items()
                                     if k not in dbs}), flush=True)
    return out


def add_launches(total: dict, more: dict) -> dict:
    for name, n in more.items():
        total[name] = total.get(name, 0) + n
    return total


def launches_of(fn):
    """(``fn()``, the kernel launches made during it), without setting
    the counts to 0 (for a part of a path that ``counted`` reads)."""
    from repro_torch.kernels import ops
    before = dict(ops.LAUNCHES)
    out = fn()
    return out, {k: ops.LAUNCHES[k] - before[k] for k in before}


class PathSpy:
    """Records, search by search, what each catapult unit (a disk engine:
    a sharded database's shards, a tiered database's cold units) ran —
    its dispatch path and loop iterations (the largest ``hops`` of the
    batch) — and what a tiered engine's hot RAM tier ran, and counts the
    maintainer's telemetry folds (one ``lsh_hash`` each, by wrapping
    ``adapt.stats.observe_update``).  Unit searches run on the sharded
    tier's pool threads; a list append is atomic under the interpreter
    lock.  ``expected(hb)`` is the searches' launches."""

    def __init__(self, units, tiered=None):
        self.units, self.tiered = list(units), tiered
        self.cold, self.hot, self.folds = [], [], 0

    def __enter__(self):
        from repro_torch.adapt import stats as ts
        self._ts, self._observe = ts, ts.observe_update
        for unit in self.units:
            def search(*a, _real=unit.search, _unit=unit, **kw):
                path = ("catapult" if _unit.mode == "catapult"
                        and _unit.catapult_active else "diskann")
                out = _real(*a, **kw)
                self.cold.append((path, int(out[2].hops.max())))
                return out
            unit.search = search
        if self.tiered is not None:
            eng, real_hot = self.tiered, self.tiered._search_hot

            def search_hot(*a, **kw):
                ran = eng.hot is not None and bool(eng._hot_slot)
                out = real_hot(*a, **kw)
                if ran:
                    self.hot.append(int(out[2].hops.max()))
                return out
            eng._search_hot = search_hot

        def observe(*a, **kw):
            self.folds += 1
            return self._observe(*a, **kw)
        ts.observe_update = observe
        return self

    def __exit__(self, *exc):
        for unit in self.units:
            del unit.search              # the bound method again
        if self.tiered is not None:
            del self.tiered._search_hot
        self._ts.observe_update = self._observe
        return False

    def expected(self, hb: str) -> dict:
        """Cold searches at ``expected_launches(..., pq=True, disk=True)``
        by their path, hot searches at the RAM diskann formula."""
        out = expected_launches("diskann", hb, [])
        for path in ("catapult", "diskann"):
            add_launches(out, expected_launches(
                path, hb, [i for p, i in self.cold if p == path], pq=True,
                disk=True))
        return add_launches(out, expected_launches("diskann", hb, self.hot))


def spy_lookups(fn):
    """Run ``fn`` with ``core.catapult.catapulted_lookup`` wrapped so that
    each call's loop iterations are kept (the mesh search's per-device
    steps go through it)."""
    from repro_torch.core import catapult as cat_mod
    real, iters = cat_mod.catapulted_lookup, []

    def spy(*args, **kw):
        out = real(*args, **kw)
        iters.append(int(out[1].hops.max()))
        return out

    cat_mod.catapulted_lookup = spy
    try:
        return fn(), iters
    finally:
        cat_mod.catapulted_lookup = real


def rows_of(gids, offsets, bounds):
    """Capacity-ranged global ids of a sharded store -> corpus rows (the
    shard's first row plus the local id); -1 stays -1."""
    g = np.asarray(gids, np.int64)
    s = np.clip(np.searchsorted(offsets, g, side="right") - 1, 0,
                len(bounds) - 2)
    return np.where(g >= 0, bounds[s] + g - offsets[s], -1)


def same_files(a: str, b: str) -> bool:
    """Every file of two directories (recursively) byte for byte, the
    ``.npz`` members by name and bytes (a zip stamps write times)."""
    import zipfile
    names = sorted(str(p.relative_to(a)) for p in Path(a).rglob("*")
                   if p.is_file())
    if names != sorted(str(p.relative_to(b)) for p in Path(b).rglob("*")
                       if p.is_file()):
        return False
    for name in names:
        x, y = Path(a) / name, Path(b) / name
        if name.endswith(".npz"):
            with zipfile.ZipFile(x) as zx, zipfile.ZipFile(y) as zy:
                if [(m, zx.read(m)) for m in zx.namelist()] != \
                        [(m, zy.read(m)) for m in zy.namelist()]:
                    return False
        elif x.read_bytes() != y.read_bytes():
            return False
    return True


def phase_sharded(wl, dev) -> dict:
    """The sharded tier at ``bench_disk.run_sharded``'s settings:
    ``make_medrag_zipf(n=8,000, n_queries=2,048)``, k=8, beam 16,
    batches of 256, 500 cache frames in total split over the shards,
    replayed twice.

    * ``create(IndexSpec(tier="sharded", pq=8, n_shards=S))`` on the card
      for S = 2 (with 256 spare rows for the mutations) and S = 4 in
      catapult mode; at S = 4 a diskann twin, a fused twin and a CPU twin
      each open a copy of the card directory.  Fused and unfused, card
      and CPU: ids, hops, block reads and cache hits equal.  Recall
      against brute force; catapult's pass-2 block reads below
      diskann's.
    * save / ``sniff`` / ``open``: the first ``publish=False`` batch of
      the reopened database equals the live one's.
    * mutations on the S = 2 twin and a CPU twin over a copy: a keyed
      upsert of the 256 spare rows, a delete of half of them, a
      consolidate; after every step the two directories' files are
      byte-identical.
    * launches: each replay equals, shard search by shard search, the
      disk formula (``PathSpy``); a build or upsert launches
      ``gather_distance`` alone; a delete or consolidate nothing."""
    from repro_torch import db
    from repro_torch.core.engine import recall_at_k
    n = wl.corpus.shape[0]
    truth = brute_force_knn_cuda(wl.corpus, wl.queries, SHARD_K, dev)
    out, paths, runs, opened, cards = {}, {}, {}, [], {}
    tmp = tempfile.mkdtemp(prefix="sharded_")

    def spec(s, **kw):
        return db.IndexSpec(tier="sharded", pq=8, n_shards=s,
                            cache_frames=SHARD_FRAMES // s, **kw)

    def spied(tag, d, hb):
        with PathSpy(d.backend.shards) as spy:
            runs[tag], paths[tag] = counted(lambda: replay(
                d, wl.queries, k=SHARD_K, beam_width=SHARD_BEAM))
        want = spy.expected(hb)
        check(paths[tag] == want and want["gather_distance"] == 0,
              f"{tag} replay launched {paths[tag]}, its shard searches "
              f"imply {want}")

    try:
        for s, spare in ((2, SHARD_SPARE), (4, 0)):
            tag = f"sharded_s{s}"
            t0 = time.perf_counter()
            cards[tag], paths[f"{tag}_create"] = counted(lambda: db.create(
                spec(s, spare_capacity=spare, path=os.path.join(tmp, tag)),
                wl.corpus))
            out[f"{tag}_create_s"] = time.perf_counter() - t0
            opened.append(cards[tag])
            built = paths[f"{tag}_create"]
            check(built["gather_distance"] > 0 and sum(built.values())
                  == built["gather_distance"],
                  f"{tag}: the shard builds launched {built}")
            spied(tag, cards[tag], "unfused")
        card_dir = cards["sharded_s4"].spec.path
        for name, mode, hb, where in (("diskann", "diskann", "unfused", dev),
                                      ("fused", "catapult", "fused", dev),
                                      ("cpu", "catapult", "unfused", "cpu")):
            tag = f"sharded_s4_{name}"
            d = db.open(shutil.copytree(card_dir, os.path.join(tmp, tag)),
                        mode=mode, spec=db.IndexSpec(
                            hop_backend=hb, cache_frames=SHARD_FRAMES // 4),
                        device=where)
            opened.append(d)
            if name == "cpu":
                runs[tag] = replay(d, wl.queries, k=SHARD_K,
                                   beam_width=SHARD_BEAM)
            else:
                spied(tag, d, hb)
        for twin in ("fused", "cpu"):
            agree = twin_agreement(runs["sharded_s4"],
                                   runs[f"sharded_s4_{twin}"])
            out[f"s4_{twin}_agreement"] = agree
            check(all(v == 1.0 for v in agree.values()),
                  f"sharded S=4: the {twin} twin differs from the card's "
                  f"catapult twin (shares of queries equal: {agree})")
        offsets2 = cards["sharded_s2"].backend.offsets
        bounds2 = np.linspace(0, n, 3).astype(np.int64)
        for tag, passes in runs.items():
            for i, p in enumerate(passes):
                ids = (rows_of(p["ids"], offsets2, bounds2)
                       if tag == "sharded_s2" else p["ids"])
                out[f"{tag}_pass{i + 1}"] = dict(
                    disk_pass_stats(p), recall_at_8=recall_at_k(ids, truth))
        c2, d2 = out["sharded_s4_pass2"], out["sharded_s4_diskann_pass2"]
        check(c2["block_reads_per_query"] < d2["block_reads_per_query"],
              f"sharded S=4: catapult's pass-2 block reads a query "
              f"{c2['block_reads_per_query']} are not below diskann's "
              f"{d2['block_reads_per_query']}")
        for tag in ("sharded_s2", "sharded_s4"):
            check(out[f"{tag}_pass2"]["recall_at_8"] > 0.9,
                  f"{tag}: pass-2 recall@8 {out[f'{tag}_pass2']}")
        # where a batch's time goes: one explained publish=False batch
        tr = cards["sharded_s4"].search(wl.queries[-SHARD_BATCH:],
                                        k=SHARD_K, beam_width=SHARD_BEAM,
                                        publish=False, explain=True)
        out["s4_stages_batch_256"] = dict(
            total_ms=tr.total_ms,
            **{f"{st}_ms": tr.stage_ms(st)
               for st in ("scatter", "merge", "route", "fetch", "rerank")})

        # save, sniff, reopen
        live = cards["sharded_s4"]
        live.attach_maintainer()
        live.save()
        out["sniff"] = db.sniff(card_dir)
        check(out["sniff"] == ("sharded", 1), f"sniff gave {out['sniff']}")
        back = db.open(card_dir, spec=db.IndexSpec(
            cache_frames=SHARD_FRAMES // 4))
        opened.append(back)
        q = wl.queries[-SHARD_BATCH:]
        want_r = live.search(q, k=SHARD_K, beam_width=SHARD_BEAM,
                             publish=False)
        with PathSpy(back.backend.shards) as spy:
            got, paths["sharded_reopen"] = counted(lambda: back.search(
                q, k=SHARD_K, beam_width=SHARD_BEAM, publish=False))
        check(paths["sharded_reopen"] == spy.expected("unfused"),
              f"the reopened sharded search launched "
              f"{paths['sharded_reopen']}, not {spy.expected('unfused')}")
        check(np.array_equal(got.ids, want_r.ids)
              and got.dists.tobytes() == want_r.dists.tobytes(),
              "the reopened sharded database's publish=False results "
              "differ from the live one's")
        out["mutations"] = sharded_mutations(wl, cards["sharded_s2"], paths,
                                             opened, tmp)
    finally:
        for d in opened:
            d.close()
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = paths
    for k, v in out.items():
        if k != "launches":
            print(f"sharded {k}: {v}")
    return out


def sharded_mutations(wl, card, paths, opened, tmp) -> dict:
    """Keyed upsert of the S = 2 twin's ``SHARD_SPARE`` spare rows (routed
    to the least-loaded shard), delete of half of them by key,
    consolidate: the card twin and a CPU twin over a copy of its
    directory end every step with byte-identical files; no dead id is
    returned."""
    from repro_torch import db
    rng = np.random.default_rng(SHARD_SPARE)
    n = wl.corpus.shape[0]
    new = (wl.corpus[rng.integers(0, n, SHARD_SPARE)]
           + 0.25 * rng.normal(size=(SHARD_SPARE, wl.corpus.shape[1]))
           ).astype(np.float32)
    keys = list(range(SHARD_SPARE))
    card.save()            # the CPU twin starts from the card's saved state
    cpu = db.open(shutil.copytree(card.spec.path,
                                  os.path.join(tmp, "mut_cpu")),
                  spec=db.IndexSpec(cache_frames=SHARD_FRAMES // 2),
                  device="cpu")
    opened.append(cpu)
    out = {}
    half = SHARD_SPARE // 2
    for name, fn in (("upsert", lambda d: d.upsert(new, keys=keys)),
                     ("delete", lambda d: d.delete(keys=keys[half:])),
                     ("consolidate", lambda d: d.consolidate())):
        t0 = time.perf_counter()
        got, paths[f"sharded_mutation_{name}"] = counted(lambda: fn(card))
        out[f"{name}_s"] = time.perf_counter() - t0
        fn(cpu)
        n_calls = paths[f"sharded_mutation_{name}"]
        if name == "upsert":
            gids = got
            check(n_calls["gather_distance"] > 0
                  and sum(n_calls.values()) == n_calls["gather_distance"],
                  f"the sharded upsert's insert searches launched {n_calls}")
        else:
            check(not any(n_calls.values()),
                  f"sharded {name} launched {n_calls}")
        for d in (card, cpu):
            d.save()
        same = same_files(card.spec.path, cpu.spec.path)
        out[f"{name}_files_identical"] = same
        check(same, f"sharded mutation {name}: the card twin's files "
                    f"differ from the CPU twin's")
    r = card.search(new, k=SHARD_K)
    out["dead_returned"] = int(np.isin(r.ids, gids[half:]).sum())
    out["upserted_own_top1"] = float(np.mean(r.ids[:half, 0] == gids[:half]))
    check(out["dead_returned"] == 0, f"dead ids came back: {out}")
    return out


def phase_mesh(wl, dev) -> dict:
    """The mesh search at bench size: ``build_sharded_state`` over the
    medrag corpus with S = 4 shards and D = 8 virtual devices (a (2, 4)
    mesh), three steps of 512 queries on the card and on the CPU from
    the same state: ids, every device's bucket table and step equal
    after each step, recall@8 > 0.9; the build launches
    ``gather_distance`` alone, each step each virtual device's catapult
    RAM launches."""
    from repro_torch.core import sharded as sh
    from repro_torch.core.beam_search import SearchSpec
    from repro_torch.core.engine import recall_at_k
    n = wl.corpus.shape[0]
    out, paths = {}, {}
    t0 = time.perf_counter()
    state, paths["mesh_build"] = counted(lambda: sh.build_sharded_state(
        wl.corpus, n_shards=MESH[1], n_devices=MESH[0] * MESH[1],
        device=dev))
    out["build_s"] = time.perf_counter() - t0
    built = paths["mesh_build"]
    check(built["gather_distance"] > 0
          and sum(built.values()) == built["gather_distance"],
          f"the mesh build launched {built}")
    cpu = sh.ShardedEngineState(*[t.cpu() for t in state])
    spec = SearchSpec(beam_width=SHARD_BEAM, k=SHARD_K,
                      max_iters=4 * SHARD_BEAM + 64)
    step = sh.make_sharded_search(MESH, spec, n // MESH[1], 8)
    nq = min(512, wl.queries.shape[0] // 6 * 2)   # even: 2 query blocks
    batches = [wl.queries[i * nq: (i + 1) * nq] for i in range(3)]
    tables = ("bucket_ids", "bucket_stamp", "bucket_step")
    ids, ms = [], []

    def run_card():
        nonlocal state
        after = []
        for q in batches:
            t0 = time.perf_counter()
            state, got, _ = step(state, torch.as_tensor(q, device=dev))
            ids.append(got.cpu().numpy())
            ms.append((time.perf_counter() - t0) * 1e3)
            after.append({name: getattr(state, name).cpu().numpy()
                          for name in tables})
        return after

    (card_states, iters), paths["mesh"] = counted(
        lambda: spy_lookups(run_card))
    want = expected_launches("catapult", "unfused", iters)
    check(paths["mesh"] == want and len(iters) == 3 * MESH[0] * MESH[1],
          f"the mesh steps launched {paths['mesh']}, their "
          f"{len(iters)} device steps imply {want}")
    for i, q in enumerate(batches):
        cpu, got, _ = step(cpu, torch.as_tensor(q))
        check(np.array_equal(got.numpy(), ids[i]),
              f"mesh step {i}: the CPU ids differ from the card's")
        for name, arr in card_states[i].items():
            check(np.array_equal(getattr(cpu, name).numpy(), arr),
                  f"mesh step {i}: the CPU {name} differs from the card's")
    truth = brute_force_knn_cuda(wl.corpus, np.concatenate(batches),
                                 SHARD_K, dev)
    out.update(step_ms=ms, loop_iterations=iters,
               recall_at_8=recall_at_k(np.concatenate(ids), truth),
               published=int(state.bucket_step.sum()))
    check(out["recall_at_8"] > 0.9, f"mesh recall@8 {out['recall_at_8']}")
    out["launches"] = paths
    print(f"mesh: {out}", flush=True)
    return out


def tiered_replay(d, q, maint=None, ticks=None, corpus=None):
    """``bench_substrates._replay``: batches of 128 at beam max(2k, 8) = 8,
    the maintainer observing every batch and ticking every 2; each
    tick's launches and the hot set after it go to ``ticks``.  With
    ``corpus``, every returned id's distance must be its corpus row's
    (ids are stable across rebalances).  Returns per-batch ms."""
    beam = max(2 * TIER_K, 8)
    ms = []
    for i in range(q.shape[0] // TIER_BATCH):
        qs = q[i * TIER_BATCH: (i + 1) * TIER_BATCH]
        t0 = time.perf_counter()
        ids, dists, st = d.search(qs, k=TIER_K, beam_width=beam)
        ms.append((time.perf_counter() - t0) * 1e3)
        if corpus is not None:
            true = ((corpus[np.maximum(ids, 0)] - qs[:, None]) ** 2).sum(-1)
            check(np.allclose(np.where(ids >= 0, dists, 0),
                              np.where(ids >= 0, true, 0), rtol=1e-4,
                              atol=1e-4),
                  "a tiered id came back with another row's distance")
        if maint is not None:
            def fold():
                maint.observe(qs, st, np.ones(qs.shape[0], bool))
                if (i + 1) % TIER_TICK == 0:
                    maint.tick()
                    eng = d.backend
                    ticks.append(dict(hot=eng._hot_live_gids(),
                                      stats=eng.tier_stats()))
            _, n = launches_of(fold)
            if (i + 1) % TIER_TICK == 0:
                ticks[-1]["launches"] = n
            else:
                ticks.append(dict(launches=n))
    return ms


def tiered_measured(d, q, truth, scan) -> dict:
    """``bench_substrates._measured``: each batch of 128 preceded by an
    untimed scan batch; p50 µs a query, cold block reads a query,
    recall@4."""
    from repro_torch.core.engine import recall_at_k
    beam = max(2 * TIER_K, 8)
    ids_all, times, reads = [], [], 0
    for i in range(q.shape[0] // TIER_BATCH):
        d.search(scan, k=TIER_K, beam_width=beam)
        qs = q[i * TIER_BATCH: (i + 1) * TIER_BATCH]
        r0 = d.io_stats().block_reads
        t0 = time.perf_counter()
        ids, _, _ = d.search(qs, k=TIER_K, beam_width=beam)
        times.append(time.perf_counter() - t0)
        reads += d.io_stats().block_reads - r0
        ids_all.append(ids)
    ids = np.concatenate(ids_all)
    return dict(p50_us_per_query=float(np.percentile(times, 50))
                / TIER_BATCH * 1e6,
                block_reads_per_query=reads / ids.shape[0],
                recall_at_4=recall_at_k(ids, truth))


def check_tiered_launches(tag, spy, hb, total, ticks) -> dict:
    """A tiered run's launches: its searches as ``PathSpy`` implies, the
    maintainer's folds one ``lsh_hash`` each, and its ticks' hot inserts
    and rebuilds ``gather_distance`` alone."""
    maint = {}
    for t in ticks:
        add_launches(maint, t["launches"])
    check(maint.get("lsh_hash", 0) == spy.folds
          and all(v == 0 for k, v in maint.items()
                  if k not in ("lsh_hash", "gather_distance")),
          f"{tag}: the maintainer launched {maint} for {spy.folds} folds")
    want = add_launches(spy.expected(hb), maint)
    check(total == want, f"{tag}: launched {total}, its searches, folds "
                         f"and ticks imply {want}")
    return dict(maintenance=maint, searches=spy.expected(hb))


def phase_tiered(wl, dev) -> dict:
    """The tiered tier at ``bench_substrates.run_tiered``'s settings on
    the medrag workload: k=4, batches of 128, 333 cold frames,
    ``TieredSpec(hot_fraction=0.05, promote_top=16, demote_after=1)``,
    the maintainer at ``PolicyConfig(observe_every=1, baseline_every=8,
    min_batches=4)`` ticking every 2 batches over the first half of the
    stream, then the measured second half with full-corpus scan
    co-traffic before each batch.

    * twins: the adaptive card twin (``create``); a frozen-hot-set twin
      (its cold tier under a plain ``CatapultMaintainer``, so the two
      cold tiers see the same maintenance and differ only in the hot
      set and its tier pins) and a CPU twin over copies of its directory
      taken at ``create``; a pure-disk control over the same cold graph.
      Adaptive cold block reads a query below the frozen twin's; the CPU
      twin's hot sets and tier counters equal the card's after every
      tick; every returned id's distance is its corpus row's;
    * once more with ``cold_tier="sharded"`` (2 shards);
    * save, then ``open``: the reopened database's ``publish=False`` ids
      equal the live one's after the save;
    * launches: the searches as ``PathSpy`` implies (cold units at the
      disk formula, the hot tier at the RAM diskann one), the folds one
      ``lsh_hash`` each, the ticks ``gather_distance`` alone."""
    from repro_torch import db
    from repro_torch.adapt import CatapultMaintainer, PolicyConfig
    n = wl.corpus.shape[0]
    q = wl.queries
    half = (q.shape[0] // 2 // TIER_BATCH) * TIER_BATCH
    truth = brute_force_knn_cuda(wl.corpus, q[half:], TIER_K, dev)
    rng = np.random.default_rng(7)
    scan = (wl.corpus[rng.choice(n, TIER_BATCH, replace=False)]
            + 0.1 * rng.normal(size=(TIER_BATCH, wl.corpus.shape[1]))
            ).astype(np.float32)
    cfg = db.TieredSpec(hot_fraction=0.05, promote_top=16, demote_after=1)
    out, paths, opened, ticks = {}, {}, [], {}
    tmp = tempfile.mkdtemp(prefix="tiered_")

    def run(tag, d, maintained, hb="unfused", where=dev):
        if maintained == "cold only":
            # the frozen twin's cold tier gets the same maintenance (TTL,
            # drift flush, gate, shadow batches) as the adaptive twin's;
            # only the rebalance, and so its hot set, is missing
            m = CatapultMaintainer(d.backend, PolicyConfig(**TIER_POLICY),
                                   tick_every=d.spec.adapt_tick_every)
        else:
            m = d.attach_maintainer(PolicyConfig(**TIER_POLICY)) \
                if maintained else None
        ticks[tag] = []

        def drive():
            warm = tiered_replay(d, q[:half], m, ticks[tag],
                                 corpus=wl.corpus)
            return warm, tiered_measured(d, q[half:], truth, scan)

        if where == "cpu":
            warm, meas = drive()
        else:
            units = getattr(d.backend, "shards", None) or [d.backend]
            tiered = d.backend if d.caps.tier == "tiered" else None
            with PathSpy(units, tiered) as spy:
                (warm, meas), paths[tag] = counted(drive)
            out[f"{tag}_launch_split"] = check_tiered_launches(
                tag, spy, hb, paths[tag], ticks[tag])
        out[tag] = dict(meas, warm_batch_ms_mean=float(np.mean(warm)))
        if d.caps.tier == "tiered":
            eng = d.backend
            s0 = eng.tier_stats()
            out[tag].update(s0, units=len(d.backend.shards))
            live = eng._hot_gid >= 0
            check(np.array_equal(
                eng.hot._vec_np[: live.size][live] if eng.hot is not None
                else np.empty((0, wl.corpus.shape[1]), np.float32),
                wl.corpus[eng._hot_gid[live]]),
                f"{tag}: a hot row is not its gid's corpus row")
        print(f"tiered {tag}: {out[tag]}", flush=True)
        return m

    try:
        path = os.path.join(tmp, "adaptive.d")
        t0 = time.perf_counter()
        card, paths["tiered_create"] = counted(lambda: db.create(
            db.IndexSpec(tier="tiered", cache_frames=TIER_FRAMES,
                         path=path, tiered=cfg), wl.corpus))
        out["create_s"] = time.perf_counter() - t0
        opened.append(card)
        built = paths["tiered_create"]
        check(built["gather_distance"] > 0
              and sum(built.values()) == built["gather_distance"],
              f"the tiered build launched {built}")
        frozen_dir = shutil.copytree(path, os.path.join(tmp, "frozen.d"))
        cpu_dir = shutil.copytree(path, os.path.join(tmp, "cpu.d"))
        cold = card.backend.cold
        disk = db.create(db.IndexSpec(tier="disk", cache_frames=TIER_FRAMES,
                                      path=os.path.join(tmp, "disk.ctpl")),
                         wl.corpus, prebuilt=(np.array(cold._adj_np[:n]),
                                              cold.medoid))
        opened.append(disk)
        run("disk_control", disk, False)
        m = run("adaptive", card, True)
        check(len(m._units) == 1, "the tiered maintainer's units")
        frozen = db.open(frozen_dir, spec=db.IndexSpec(
            cache_frames=TIER_FRAMES))
        opened.append(frozen)
        run("frozen", frozen, "cold only")
        cpu = db.open(cpu_dir, spec=db.IndexSpec(cache_frames=TIER_FRAMES),
                      device="cpu")
        opened.append(cpu)
        run("cpu", cpu, True, where="cpu")
        same = [np.array_equal(a["hot"], b["hot"]) and a["stats"] == b["stats"]
                for a, b in zip(ticks["adaptive"], ticks["cpu"]) if "hot" in a]
        out["cpu_rebalances_equal"] = float(np.mean(same)) if same else None
        check(same and all(same), f"the CPU twin's rebalances differ from "
                                  f"the card's: {same}")
        a, f = out["adaptive"], out["frozen"]
        check(a["promotions"] > 0, f"no row was promoted: {a}")
        check(a["block_reads_per_query"] < f["block_reads_per_query"],
              f"adaptive cold block reads a query {a['block_reads_per_query']}"
              f" are not below the frozen twin's "
              f"{f['block_reads_per_query']}")

        # the same with a sharded cold tier (2 shards)
        t0 = time.perf_counter()
        sharded = db.create(db.IndexSpec(
            tier="tiered", n_shards=2, cache_frames=TIER_FRAMES,
            path=os.path.join(tmp, "sharded.d"),
            tiered=dataclasses.replace(cfg, cold_tier="sharded")),
            wl.corpus)
        out["sharded_create_s"] = time.perf_counter() - t0
        opened.append(sharded)
        ms = run("sharded_cold", sharded, True)
        check(len(ms._units) == 2, "the maintainer does not reach both "
                                   "cold shards")
        check(out["sharded_cold"]["promotions"] > 0,
              f"no row was promoted over the sharded cold tier")

        # save, then open: the same ids
        for unit in card.backend.shards:
            unit.catapult_override = None     # a pending shadow batch
        card.save()
        probe = q[half: half + TIER_BATCH]
        after = card.search(probe, k=TIER_K, beam_width=8, publish=False)
        back = db.open(path, spec=db.IndexSpec(cache_frames=TIER_FRAMES))
        opened.append(back)
        got = back.search(probe, k=TIER_K, beam_width=8, publish=False)
        out["reopen_ids_equal"] = bool(np.array_equal(got.ids, after.ids))
        check(out["reopen_ids_equal"], "the reopened tiered database's ids "
                                       "differ from the saved one's")
        check(back.backend.tier_stats()["promotions"] == a["promotions"],
              "the reopened tiered database lost its counters")
    finally:
        for d in opened:
            d.close()
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = paths
    return out


def trace_stages(tr) -> dict:
    """A sharded trace's top-level spans and each shard's own."""
    out = {f"{st}_ms": tr.stage_ms(st)
           for st in ("scatter", "merge", "route", "fetch", "rerank")}
    out["total_ms"] = tr.total_ms
    out["shards"] = {sh["name"]: {sp.name: sp.ms for sp in sh["stages"]}
                     for sh in tr.shards}
    return out


def deploy_sharded(vec_np, queries, rows, paths, dev, tmp, seed) -> dict:
    """1,000,000 x 768 on the sharded tier: S = 4 shards of 250,000 rows,
    each over its own random regular graph of degree 64 (local ids),
    written through the port's ``DiskVectorSearchEngine.build(prebuilt=)``
    with seed ``seed + s`` and PQ M=8, the manifest through
    ``ShardedDiskVectorSearchEngine`` (``create`` refuses ``prebuilt``,
    and a host Vamana build at 1M is out of reach); then
    ``repro_torch.db.open`` of the directory as a catapult and a diskann
    twin, each 4 explained batches of 4,096 (scatter, merge and per-shard
    route / fetch / rerank ms, block reads, hit rate), the last under
    the profiler (idle share), and the device bytes each holds against
    the vector table."""
    from repro_torch import db
    from repro_torch.core.vamana import _random_regular_init, medoid_index
    from repro_torch.store.io_engine import DiskVectorSearchEngine
    from repro_torch.store.layout import HEADER_SIZE, block_size_for
    from repro_torch.store.sharded_store import ShardedDiskVectorSearchEngine
    out, dbs = {}, {}
    n = N
    store_bytes = DEPLOY_SHARDS * HEADER_SIZE + n * block_size_for(D, 64)
    free = shutil.disk_usage(tmp).free
    out.update(store_bytes=store_bytes, free_disk_bytes=free)
    if free < 2 * store_bytes:
        n = max(20_000, int(N * free / (2 * store_bytes))
                // (4 * 1000) * (4 * 1000))
        print(f"reduced: the sharded deployment phase stores {n:,} rows, "
              f"not {N:,}: {free / 1e9:.1f} GB free", flush=True)
    per = n // DEPLOY_SHARDS
    frames = (n // 16) // DEPLOY_SHARDS
    path = os.path.join(tmp, "sharded.d")
    rng = np.random.default_rng(seed + 1)
    print(f"reduced: the sharded deployment phase's {DEPLOY_SHARDS} shards "
          f"of {per:,} rows each take a random regular graph of degree 64, "
          f"not a Vamana build (host RobustPrune at 1M x 768 is beyond a "
          f"smoke run)", flush=True)

    def write():
        eng = ShardedDiskVectorSearchEngine(
            store_dir=path, n_shards=DEPLOY_SHARDS, pq_subspaces=PQ_M,
            cache_frames=frames, io=db.IoSpec(), device=dev)
        os.makedirs(path)
        eng.offsets = np.arange(DEPLOY_SHARDS + 1, dtype=np.int64) * per
        try:
            for s in range(DEPLOY_SHARDS):
                part = vec_np[s * per: (s + 1) * per]
                shard = DiskVectorSearchEngine(
                    mode="catapult", pq_subspaces=PQ_M, capacity=per,
                    store_path=os.path.join(path, f"shard_{s:04d}.ctpl"),
                    **eng._shard_kwargs(s))
                eng.shards.append(shard)
                shard.build(part, prebuilt=(
                    _random_regular_init(per, 64, rng), medoid_index(part)))
            eng.n_active, eng.dim = n, D
            eng._write_manifest()
        finally:
            eng.close()

    t0 = time.perf_counter()
    _, paths["deployment_sharded_write"] = counted(write)
    out["write_s"] = time.perf_counter() - t0
    check(not any(paths["deployment_sharded_write"].values()),
          f"the sharded store write launched "
          f"{paths['deployment_sharded_write']}")
    table_bytes = n * D * 4
    ids = {}
    try:
        for name, mode in (("catapult", "catapult"), ("diskann", "diskann")):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            d = dbs[name] = db.open(path, mode=mode, spec=db.IndexSpec(
                cache_frames=frames))
            out[f"open_s_{name}"] = time.perf_counter() - t0
            held = torch.cuda.memory_allocated() - before
            out[f"device_bytes_after_open_{name}"] = held
            check(held < table_bytes / 4,
                  f"deployment sharded: the {name} engine holds {held} "
                  f"bytes on the card, not well under the {table_bytes}-"
                  f"byte vector table")
            traces, busy = [], []

            def drive(d=d, traces=traces, busy=busy):
                for i in range(4):
                    def one(i=i):
                        traces.append(d.search(queries[i * B: (i + 1) * B],
                                               k=10, explain=True))
                    if i == 3:
                        busy.append(device_busy_ms(one))
                    else:
                        one()

            with PathSpy(d.backend.shards) as spy:
                _, paths[f"deployment_sharded_{name}"] = counted(drive)
            want = spy.expected("unfused")
            check(paths[f"deployment_sharded_{name}"] == want,
                  f"deployment sharded {name}: launched "
                  f"{paths[f'deployment_sharded_{name}']}, its shard "
                  f"searches imply {want}")
            ids[name] = np.concatenate([t.ids for t in traces])
            reads = np.concatenate([t.blocks_read for t in traces])
            hits = np.concatenate([t.cache_hits for t in traces])
            last = traces[-1]
            out[name] = dict(
                batches=[trace_stages(t) for t in traces],
                shard_loop_iterations=[i for _, i in spy.cold],
                mean_hops=float(np.mean([t.hops.mean() for t in traces])),
                block_reads_per_query=float(reads.mean()),
                cache_hits_per_query=float(hits.mean()),
                hit_rate=float(hits.sum() / max(hits.sum() + reads.sum(), 1)),
                top1_is_source_row=float(np.mean(ids[name][:, 0]
                                                 == rows[: 4 * B])),
                last_batch=dict(wall_ms=last.total_ms,
                                device_busy_ms=busy[0],
                                idle_share=(1.0 - busy[0] / last.total_ms)
                                if busy[0] > 0 else None),
                io_stats=d.io_stats()._asdict())
            print(f"deployment sharded {name}: {out[name]}", flush=True)
    finally:
        for d in dbs.values():
            d.close()
        shutil.rmtree(path, ignore_errors=True)
    out.update(rows=n, vector_table_bytes=table_bytes)
    return out


def deploy_mesh(vectors, vec_np, queries, rows, paths, dev, seed) -> dict:
    """The mesh search at 1,000,000 x 768: the deployment table as S = 4
    RAM shards of 250,000 rows, each over its own random regular graph of
    degree 64, D = 8 virtual devices ((2, 4)), 4 steps of 4,096 queries
    (each virtual device searches 2,048 against its shard, beam 16); the
    last step under the profiler (its device time against the unprofiled
    steps' wall time)."""
    from repro_torch.core import lsh as lsh_mod
    from repro_torch.core import sharded as sh
    from repro_torch.core.beam_search import SearchSpec
    from repro_torch.core.vamana import _random_regular_init, medoid_index
    rng = np.random.default_rng(seed + 2)
    per = N // MESH[1]
    adj = np.concatenate([_random_regular_init(per, 64, rng)
                          for _ in range(MESH[1])])
    medoids = [medoid_index(vec_np[s * per: (s + 1) * per])
               for s in range(MESH[1])]
    n_dev, nb = MESH[0] * MESH[1], 2 ** 8
    lsh = lsh_mod.make_lsh(torch.Generator().manual_seed(seed), 8, D, dev)
    state = sh.ShardedEngineState(
        vectors=vectors, adjacency=torch.as_tensor(adj, device=dev),
        medoids=torch.tensor(medoids, dtype=torch.int32, device=dev),
        hyperplanes=lsh.hyperplanes,
        bucket_ids=torch.full((n_dev * nb, 40), -1, dtype=torch.int32,
                              device=dev),
        bucket_stamp=torch.full((n_dev * nb, 40), -1, dtype=torch.int32,
                                device=dev),
        bucket_step=torch.zeros(n_dev, dtype=torch.int32, device=dev))
    step = sh.make_sharded_search(
        MESH, SearchSpec(beam_width=16, k=10, max_iters=64), per, 8)
    ms, got, busy = [], [], []

    def run():
        nonlocal state
        for i in range(4):
            def one(i=i):
                nonlocal state
                state, ids, _ = step(state, torch.as_tensor(
                    queries[i * B: (i + 1) * B], device=dev))
                got.append(ids.cpu().numpy())
            t0 = time.perf_counter()
            if i == 3:
                busy.append(device_busy_ms(one))
            else:
                one()
            ms.append((time.perf_counter() - t0) * 1e3)

    (_, iters), paths["deployment_mesh"] = counted(lambda: spy_lookups(run))
    want = expected_launches("catapult", "unfused", iters)
    check(paths["deployment_mesh"] == want and len(iters) == 4 * n_dev,
          f"deployment mesh: launched {paths['deployment_mesh']}, its "
          f"{len(iters)} device steps imply {want}")
    ids = np.concatenate(got)
    out = dict(step_ms=ms, device_loop_iterations=iters,
               top1_is_source_row=float(np.mean(ids[:, 0] == rows[: 4 * B])),
               # the profiled step's own wall time is mostly the
               # profiler's: its device time stands against the mean wall
               # time of the three unprofiled steps
               last_step=dict(wall_ms=float(np.mean(ms[:3])),
                              device_busy_ms=busy[0],
                              idle_share=(1.0 - busy[0] / np.mean(ms[:3]))
                              if busy[0] > 0 else None),
               published=int(state.bucket_step.sum()),
               adjacency_bytes=adj.nbytes)
    print(f"deployment mesh: {out}", flush=True)
    return out


def deploy_tiered(tmp, disk_out, queries, paths, dev) -> dict:
    """The tiered tier at 1,000,000 x 768 over the disk deployment phase's
    store: its CTPL file (and ``.io.json`` / ``.adapt.npz`` sidecars,
    buckets and telemetry included) renamed to ``cold.ctpl`` in a tiered
    directory with a ``tiered.json`` and no ``hot.npz`` (no second
    3.58 GB write), ``TieredSpec(hot_capacity=DEPLOY_HOT)``, opened and
    served 4 batches of 4,096 (the disk phase's queries) with the
    ``TieredMaintainer`` ticking after each: promotions, hot hits, each
    tick's seconds (hot builds on the host) and cold block reads a query
    beside the single-store phase's."""
    from repro_torch import db
    from repro_torch.adapt import PolicyConfig
    from repro_torch.tiered import (TIERED_FORMAT, TIERED_MANIFEST_NAME,
                                    TIERED_VERSION)
    n = disk_out["rows"]
    store = os.path.join(tmp, "deploy.ctpl")
    tdir = os.path.join(tmp, "tiered.d")
    os.makedirs(tdir)
    for ext in ("", ".io.json", ".adapt.npz"):
        if os.path.exists(store + ext):
            os.rename(store + ext, os.path.join(tdir, "cold.ctpl" + ext))
    cfg = db.TieredSpec(hot_capacity=DEPLOY_HOT, promote_top=16,
                        demote_after=1)
    spec = db.IndexSpec()
    manifest = {"format": TIERED_FORMAT, "version": TIERED_VERSION,
                "cold_tier": "disk", "cold": "cold.ctpl", "mode": "catapult",
                "dim": D, "seed": spec.seed, "n_bits": spec.n_bits,
                "bucket_capacity": spec.bucket_capacity, "filtered": False,
                "n_labels": 0, "tiered": cfg.to_dict(), "hot_file": "hot.npz"}
    Path(tdir, TIERED_MANIFEST_NAME).write_text(json.dumps(manifest,
                                                           indent=1))
    print(f"reduced: the tiered deployment phase holds at most "
          f"{DEPLOY_HOT:,} hot rows (hot_capacity), so that a hot rebuild "
          f"of 768-wide rows stays a host build of seconds", flush=True)
    out, ticks = {}, []
    t0 = time.perf_counter()
    d = db.open(tdir, spec=db.IndexSpec(cache_frames=n // 16))
    out["open_s"] = time.perf_counter() - t0
    try:
        check(db.sniff(tdir) == ("tiered", TIERED_VERSION)
              and d.backend.hot is None, "the 1M tiered layout")
        m = d.attach_maintainer(PolicyConfig())
        eng = d.backend
        batches = []

        def drive():
            for i in range(4):
                q = queries[i * B: (i + 1) * B]
                h0, r0 = eng.hot_hits, d.io_stats().block_reads
                tr = d.search(q, k=10, explain=True)
                batch = dict(total_ms=tr.total_ms,
                             scatter_ms=tr.stage_ms("scatter"),
                             merge_ms=tr.stage_ms("merge"),
                             fetch_ms=tr.stage_ms("fetch"),
                             hot_hits=(eng.hot_hits - h0) / B,
                             cold_block_reads_per_query=(
                                 d.io_stats().block_reads - r0) / B)

                def fold(q=q, st=tr.stats):
                    t1 = time.perf_counter()
                    m.observe(q, st, np.ones(B, bool))
                    m.tick()
                    return time.perf_counter() - t1
                batch["tick_s"], n_tick = launches_of(fold)
                ticks.append(dict(launches=n_tick))
                batch.update(eng.tier_stats())
                batches.append(batch)
                print(f"deployment tiered batch {i}: {batch}", flush=True)

        with PathSpy(eng.shards, eng) as spy:
            _, paths["deployment_tiered"] = counted(drive)
        out["launch_split"] = check_tiered_launches(
            "deployment tiered", spy, "unfused", paths["deployment_tiered"],
            ticks)
        out.update(batches=batches, tier_stats=eng.tier_stats(),
                   single_store_block_reads_per_query=disk_out[
                       "catapult_unfused"]["block_reads_per_query"])
        check(eng.promotions > 0, "no row was promoted at 1M")
    finally:
        d.close()
        shutil.rmtree(tdir, ignore_errors=True)
    print(f"deployment tiered: {out}", flush=True)
    return out


class SearchSpy:
    """Records every ``beam_search_l2`` call made through ``modules``
    (``core.vamana``'s build, ``core.insert``'s insert, ``core.hnsw``'s
    levels): its loop iterations and its wall ms (each call ends with a
    copy to the host).  Such a search is the composed full-precision
    hop: ``gather_distance`` once for the init merge and once an
    iteration, so ``expected()`` is ``expected_launches("diskann",
    "unfused", iters)``.  Only searches on ``device_type`` are kept (a
    CPU twin's builds launch nothing on the card).  Calls from pool
    threads append under the interpreter lock."""

    def __init__(self, *modules, device_type: str = "cuda"):
        self.modules, self.iters, self.ms, self.where = modules, [], [], []
        self.device_type = device_type

    def __enter__(self):
        self._real = [m.beam_search_l2 for m in self.modules]
        for m, real in zip(self.modules, self._real):
            def spy(*a, _real=real, _name=m.__name__, **kw):
                t0 = time.perf_counter()
                res = _real(*a, **kw)
                if a[2].device.type == self.device_type:   # the queries
                    self.iters.append(int(res.hops.max()))
                    self.ms.append((time.perf_counter() - t0) * 1e3)
                    self.where.append(_name)
                return res
            m.beam_search_l2 = spy
        return self

    def __exit__(self, *exc):
        for m, real in zip(self.modules, self._real):
            m.beam_search_l2 = real
        return False

    def expected(self) -> dict:
        return expected_launches("diskann", "unfused", self.iters)


def build_spy(device_type: str = "cuda") -> SearchSpy:
    """The searches of every Vamana build (cutover, growth and
    consolidate rebuilds) and of every graph-phase insert."""
    from repro_torch.core import insert, vamana
    return SearchSpy(vamana, insert, device_type=device_type)


def hnsw_launches(mode: str, level_iters) -> dict:
    """Kernel launches of one ``HnswEngine.search`` batch from the loop
    iterations of its beam searches (each upper level's descent, then
    level 0; ``SearchSpy(core.hnsw)``): each is the composed full-
    precision hop (``gather_distance`` once plus once an iteration), and
    catapult mode hashes the batch once (``lsh_hash``; the publish is
    the host fold)."""
    out = expected_launches("diskann", "unfused", level_iters)
    out["lsh_hash"] += mode == "catapult"
    return out


class IngestSpy:
    """Records what a database born empty ran, call by call: each
    search's phase and launches (an empty or seeding database answers by
    host numpy: no launch), the graph-phase searches' dispatch path and
    loop iterations (the RAM tier), the maintainer's telemetry folds (one
    ``lsh_hash`` each) and every build and insert search
    (``build_spy``), all on ``device_type`` (a CPU twin's folds and
    builds are not counted).  ``expected(hb)`` is their launches;
    ``seed_launches`` the launches the empty and seed searches made."""

    def __init__(self, backend, device_type: str = "cuda"):
        self.eng, self.searches, self.folds = backend, [], 0
        self.device_type = device_type
        self.seed_launches = {}
        self.builds = build_spy(device_type)

    def __enter__(self):
        from repro_torch.adapt import stats as ts
        eng, real = self.eng, self.eng.search
        self._ts, self._observe = ts, ts.observe_update

        def search(*a, **kw):
            phase = eng.bootstrap_phase
            active = phase == "graph" and eng.inner.catapult_active
            out, made = launches_of(lambda: real(*a, **kw))
            if phase != "graph":
                add_launches(self.seed_launches, made)
            self.searches.append((phase, active, int(out[2].hops.max())))
            return out

        def observe(*a, **kw):
            if a[2].device.type == self.device_type:       # the queries
                self.folds += 1
            return self._observe(*a, **kw)

        eng.search = search
        ts.observe_update = observe
        self.builds.__enter__()
        return self

    def __exit__(self, *exc):
        self.builds.__exit__(*exc)
        del self.eng.search                 # the bound method again
        self._ts.observe_update = self._observe
        return False

    def expected(self, hb: str) -> dict:
        out = self.builds.expected()
        for path, active in (("catapult", True), ("diskann", False)):
            add_launches(out, expected_launches(
                path, hb, [i for p, a, i in self.searches
                           if p == "graph" and a == active]))
        out["lsh_hash"] += self.folds
        return out


class CardGraphs:
    """Hands each build of a CPU twin (``factory._build_engine`` on the
    CPU) the graph its card twin built at the same step, as ``prebuilt``
    (RAM tier): a Vamana build on the card and one on the CPU may part on
    a near-tie of float sums, so the twins would otherwise compare two
    graphs rather than one path.  The card twin runs each step first."""

    def __enter__(self):
        from repro_torch.db import factory
        self._factory = factory
        self._real = real = factory._build_engine
        self.graphs, self.taken, self.card_ms = [], 0, 0.0

        def build(spec, vectors, labels, n_labels, prebuilt=None, *,
                  device="cuda"):
            if torch.device(device).type == "cuda":
                t0 = time.perf_counter()
                eng = real(spec, vectors, labels, n_labels, prebuilt,
                           device=device)
                self.card_ms += (time.perf_counter() - t0) * 1e3
                self.graphs.append((eng._adj_np.copy(), int(eng.medoid),
                                    vectors.shape[0]))
                return eng
            check(self.graphs, "a CPU twin built with no card build before "
                               "it")
            adj, med, n = self.graphs.pop(0)
            check(n == vectors.shape[0], f"CPU twin build of "
                  f"{vectors.shape[0]} rows against the card's {n}")
            self.taken += 1
            return real(spec, vectors, labels, n_labels, (adj, med),
                        device=device)

        factory._build_engine = build
        return self

    def __exit__(self, *exc):
        self._factory._build_engine = self._real
        return False


def twin_lanes_agree(a, b, tag: str) -> int:
    """Card and CPU twins' (ids, dists) of one d=768 search: ids equal on
    all but ``TWIN_PARTED`` of the lanes, distances within ``RTOL`` on the
    equal lanes.  A 768-term sum in the kernel's order and in torch's can
    differ in the last bit, and a bounded beam may then keep one of two
    near-equal candidates on one side and the other on the other; such a
    lane is counted, and the recall of the twins compared at the end
    (the parity standard's near-tie rule).  Returns the parted lanes."""
    same = (a[0] == b[0]).all(1)
    check(np.allclose(a[1][same], b[1][same], rtol=RTOL),
          f"{tag}: the twins' distances differ")
    parted = int((~same).sum())
    check(parted <= TWIN_PARTED * same.size,
          f"{tag}: card and CPU twins' ids differ{lane_diff(a, b)}")
    return parted


def lane_diff(a, b) -> str:
    """The lanes where two (ids, dists) results differ: count, and the
    first lane's ids and distances on each side."""
    bad = np.nonzero((a[0] != b[0]).any(1))[0]
    if not bad.size:
        return ""
    i = int(bad[0])
    return (f": {bad.size} lanes, first {i}: ids {a[0][i].tolist()} / "
            f"{b[0][i].tolist()}, dists {a[1][i].tolist()} / "
            f"{b[1][i].tolist()}")


def ingest_twins_equal(card, cpu, tag: str) -> None:
    """The twins' bootstrap state: phase, transitions, the external-id
    indirection, tombstones and keys exactly equal."""
    a, b = card.backend, cpu.backend
    check((a.phase, a.cutovers, a.growths, a.capacity, a.n_active)
          == (b.phase, b.cutovers, b.growths, b.capacity, b.n_active),
          f"{tag}: card and CPU twins' transitions differ: "
          f"{a.ingest_stats()} against {b.ingest_stats()}")
    check(np.array_equal(a._ext_tomb, b._ext_tomb),
          f"{tag}: the twins' tombstones differ")
    if a.phase == "graph":
        check(np.array_equal(a._ext2int, b._ext2int)
              and np.array_equal(a._gen[1], b._gen[1]),
              f"{tag}: the twins' ext2int/int2ext differ")
    check(dict(card.keys._fwd) == dict(cpu.keys._fwd),
          f"{tag}: the twins' keys differ")


def ingest_spec(**ingest):
    from repro_torch import db
    from repro_torch.adapt import PolicyConfig
    return db.IndexSpec(tier="ram", mode="catapult", dim=D, degree=64,
                        beam_width=L, adapt=PolicyConfig(),
                        ingest=db.IngestSpec(**ingest))


def phase_ingest(dev) -> dict:
    """A database born empty at deployment width: ``make_medrag_zipf(
    n=INGEST_N, d=768)`` streamed into ``create(IndexSpec(dim=768,
    degree=64, beam_width=16, adapt=PolicyConfig(), ingest=IngestSpec()))``
    through ``db.serve(max_batch=64, ingest=True)`` from one thread, puts
    of 64 keyed rows in turns with 64-query searches, on the card and on a
    CPU twin (which takes the card's graph at each build, ``CardGraphs``):
    empty, seed, the cutover, the growth rebuilds, a keyed re-upsert of
    512 rows, deletes by key past the 0.25 threshold and the maintainer's
    background consolidate; then the streamed recall against a batch
    twin, and 4 producer threads on a fresh database."""
    from repro_torch import db
    from repro_torch.core import buckets as bk
    from repro_torch.core.engine import recall_at_k
    from repro_torch.data import make_medrag_zipf

    wl = make_medrag_zipf(n=INGEST_N, d=D)
    rows, qs = wl.corpus, wl.queries
    check(INGEST_N % INGEST_PUT == 0, "the stream is whole puts")
    print(f"reduced: the full-width ingest stream is make_medrag_zipf(n="
          f"{INGEST_N}, d={D}) with IngestSpec({INGEST}) (4,096 rows and "
          f"IngestSpec()'s cutover 256, initial capacity 1,024, batch 256 "
          f"asked): every build and insert is host RobustPrune at d={D}; "
          f"every transition runs", flush=True)
    spec = ingest_spec(**INGEST)
    out = {"stages": {}, "launches": {}}
    card = db.create(spec)
    twins = CardGraphs()
    with twins:
        cpu = db.create(spec, device="cpu")
        fes = [card.serve(max_batch=SERVE_BATCH, ingest=True),
               cpu.serve(max_batch=SERVE_BATCH, ingest=True)]
        put_gids, step, parted = [[], []], [0], [0, 0]

        def serve_step(put=None, keys=None):
            """A put on both twins, then one 64-query search on both
            (it pumps the put in); ids compared."""
            tickets = [None, None]
            if put is not None:
                tickets = [fe.ingest.put(put, keys=keys) for fe in fes]
            q = qs[(step[0] * SERVE_BATCH) % qs.shape[0]:][:SERVE_BATCH]
            step[0] += 1
            got = [fe.search(q, k=10) for fe in fes]
            for t in tickets:       # a failed insert fails its ticket
                if t is not None:
                    t.wait(0.0)
            parted[0] += twin_lanes_agree(got[0], got[1],
                                          f"ingest step {step[0]}")
            parted[1] += q.shape[0]
            if card.backend.bootstrap_phase == "graph":
                # one catapult table for the next step, where a near-tie
                # flip published another top-1 (a no-op otherwise)
                cpu.backend.inner._cat = dataclasses.replace(
                    cpu.backend.inner._cat,
                    buckets=bk.from_arrays(bk.to_arrays(
                        card.backend.inner._cat.buckets), "cpu"))
            ingest_twins_equal(card, cpu, f"ingest step {step[0]}")
            return tickets, got[0][:2]

        def stage(name, fn):
            with IngestSpy(card.backend) as spy:
                t0 = time.perf_counter()
                res, made = counted(fn)
                secs = time.perf_counter() - t0
            want = spy.expected("unfused")
            check(made == want, f"ingest {name}: launches {made} against "
                                f"the formula {want}")
            check(not any(spy.seed_launches.values()),
                  f"ingest {name}: an empty or seed search launched "
                  f"{spy.seed_launches}")
            build_ms = float(sum(spy.builds.ms))
            out["stages"][name] = dict(
                seconds=secs, searches=len(spy.searches), folds=spy.folds,
                build_searches=len(spy.builds.iters),
                build_search_ms=build_ms,
                vamana_search_ms=float(sum(
                    ms for ms, w in zip(spy.builds.ms, spy.builds.where)
                    if w.endswith(".vamana"))),
                phases=sorted({p for p, _, _ in spy.searches}))
            out["launches"][f"ingest_{name}"] = made
            print(f"ingest {name}: {secs:.1f} s, {len(spy.searches)} "
                  f"searches ({out['stages'][name]['phases']}), "
                  f"{len(spy.builds.iters)} build/insert searches "
                  f"({build_ms:.0f} ms), launches {made}", flush=True)
            return res

        def stream(lo, hi, src=rows):
            """Puts of src[lo:hi] keyed by row index, one step each."""
            for a in range(lo, hi, INGEST_PUT):
                tickets, _ = serve_step(src[a: a + INGEST_PUT],
                                        list(range(a, a + INGEST_PUT)))
                for side in (0, 1):
                    put_gids[side].append(tickets[side])

        # empty: searches answer at once, all -1, no launch
        def empty():
            _, (ids, dists) = serve_step()
            check((ids == -1).all() and np.isinf(dists).all(),
                  "an empty database answered something")
        stage("empty", empty)
        check(card.backend.bootstrap_phase == "empty", "not empty")
        # seed: exact brute force over the buffered rows
        cut = card.spec.ingest.bootstrap_cutover
        stage("seed", lambda: (stream(0, cut - INGEST_PUT), serve_step()))
        check(card.backend.bootstrap_phase == "seed", "not seeding")
        seed_n = cut - INGEST_PUT
        truth = brute_force_knn_cuda(rows[:seed_n], qs[:SERVE_BATCH], 10,
                                     dev)
        g = np.concatenate([t.gids for t in put_gids[0]])
        row_of = np.empty(seed_n, np.int64)
        row_of[g] = np.arange(seed_n)
        ids = card.search(qs[:SERVE_BATCH], k=10, publish=False).ids
        check(np.array_equal(row_of[ids], truth),
              "the seed phase's search is not exact brute force")
        # the cutover, then growth until two rebuilds have run
        stage("cutover", lambda: stream(cut - INGEST_PUT, cut + INGEST_PUT))
        check(card.backend.cutovers == 1, "no cutover")
        stage("grow", lambda: stream(cut + INGEST_PUT, INGEST_N))
        # a keyed re-upsert of 512 rows (true upserts), noise added
        rng = np.random.default_rng(5)
        again = (rows[:INGEST_REUPSERT] + 0.05 * rng.standard_normal(
            (INGEST_REUPSERT, D)).astype(np.float32))

        stage("reupsert", lambda: stream(0, INGEST_REUPSERT, again))
        check(card.backend.growths >= 2,
              f"only {card.backend.growths} growth rebuilds")
        check(not fes[0].ingest.depth and not fes[1].ingest.depth,
              "puts left in the queue")
        ingest_twins_equal(card, cpu, "after the re-upsert")
        # every ticket resolved, in caller order, on both twins
        for side in (0, 1):
            gids = np.concatenate([t.gids for t in put_gids[side]])
            check(len(np.unique(gids)) == gids.size,
                  "two puts got the same gid")
            if side == 0:
                card_gids = gids
            else:
                check(np.array_equal(gids, card_gids),
                      "the twins' ticket gids differ")
        put_rows = np.concatenate([rows, again])
        live = ~card.tombstones[card_gids]
        check(live.sum() == INGEST_N and live[INGEST_N:].all()
              and np.array_equal(card.vectors[card_gids[live]],
                                 put_rows[live]),
              "db.vectors[gids] is not the rows that were put (or a "
              "replaced row is live)")
        # deletes by key past the threshold, then searches until the
        # maintainer's tick consolidates
        n_del = int(np.ceil(INGEST_DELETE * INGEST_N))
        dead_keys = list(range(INGEST_N - n_del, INGEST_N))

        def delete_and_consolidate():
            for d in (card, cpu):
                d.delete(keys=dead_keys)
            frac = card.backend.tombstone_fraction()
            check(frac >= card.spec.ingest.consolidate_threshold,
                  f"tombstone fraction {frac:.3f} under the threshold")
            for _ in range(4 * card.spec.adapt_tick_every):
                serve_step()
                if fes[0].maintainer.consolidations:
                    break
            return frac
        t0 = time.perf_counter()
        frac = stage("consolidate", delete_and_consolidate)
        check(fes[0].maintainer.consolidations >= 1
              and fes[1].maintainer.consolidations
              == fes[0].maintainer.consolidations,
              "the maintainer did not consolidate (or the twins differ)")
        check(card.backend.tombstone_fraction()
              < card.spec.ingest.consolidate_threshold,
              "consolidate left the tombstones")
        consolidate_s = time.perf_counter() - t0
        snap = [fe.maintainer.snapshot() for fe in fes]
        for key in ADAPT_EVENTS + ("consolidations", "n_queries"):
            check(snap[0][key] == snap[1][key],
                  f"maintainer {key}: card {snap[0][key]} CPU {snap[1][key]}")
        stats = card.backend.ingest_stats()
        out.update(stats=stats, twin_builds=twins.taken,
                   card_build_ms=getattr(twins, "card_ms", 0.0),
                   maintainer=snap[0], delete_fraction=frac,
                   consolidate_s=consolidate_s, parted_lanes=parted[0],
                   lanes=parted[1])
    # recall against brute force over the live rows, beside a batch twin
    live = np.nonzero(~card.tombstones)[0]
    q_eval = qs[: INGEST_RECALL_Q]
    truth = live[brute_force_knn_cuda(card.vectors[live], q_eval, 10, dev)]
    ids = card.search(q_eval, k=10, publish=False).ids
    check(not np.isin(ids, np.nonzero(card.tombstones)[0]).any(),
          "a tombstoned id came back")
    r_stream = recall_at_k(ids, truth)
    r_cpu = recall_at_k(cpu.search(q_eval, k=10, publish=False).ids, truth)
    check(abs(r_cpu - r_stream) <= 0.01, f"card recall@10 {r_stream:.4f} "
          f"against the CPU twin's {r_cpu:.4f}")
    t0 = time.perf_counter()
    twin = db.create(dataclasses.replace(spec, ingest=None, adapt=None),
                     card.vectors[live])
    twin_s = time.perf_counter() - t0
    r_batch = recall_at_k(live[twin.search(q_eval, k=10).ids], truth)
    check(r_stream >= r_batch - 0.01, f"streamed recall@10 {r_stream:.4f} "
          f"more than a point under the batch twin's {r_batch:.4f}")
    del twin
    build_ms = sum(out["stages"][s]["build_search_ms"]
                   for s in out["stages"])
    vamana_ms = sum(out["stages"][s]["vamana_search_ms"]
                    for s in out["stages"])
    # the card's Vamana builds (cutover, growths, consolidate) outside
    # their searches on the card: host RobustPrune and graph surgery
    check(out["card_build_ms"] > 0, "no card build was timed")
    host_share = 1.0 - vamana_ms / out["card_build_ms"]
    out.update(recall_stream=r_stream, recall_batch=r_batch,
               recall_cpu_twin=r_cpu, batch_twin_s=twin_s,
               live=int(live.size), build_host_share=host_share)
    print(f"ingest: cutover {stats['cutover_ms']:.0f} ms, {stats['growths']}"
          f" growths {stats['grow_ms']:.0f} ms, consolidate phase "
          f"{consolidate_s:.1f} s; the card's builds "
          f"{out['card_build_ms']:.0f} ms, their searches on the card "
          f"{vamana_ms:.0f} ms (host share {host_share:.4f}); build and insert "
          f"searches {build_ms:.0f} ms in all; recall@10 streamed "
          f"{r_stream:.4f} "
          f"batch twin {r_batch:.4f} ({live.size} live rows, twin build "
          f"{twin_s:.1f} s); CPU twin took {twins.taken} card graphs, its "
          f"recall@10 {r_cpu:.4f}, {parted[0]} of {parted[1]} served lanes "
          f"parted on a near-tie", flush=True)
    out["threads"] = ingest_threads(rows)
    return out


def ingest_threads(rows) -> dict:
    """4 producer threads put 2 x 32 rows each into a fresh database born
    empty while the main thread serves (the puts cross its cutover):
    every gid distinct, each ticket in its caller's row order."""
    import threading
    from repro_torch import db
    d = db.create(ingest_spec(**INGEST))
    fe = d.serve(max_batch=SERVE_BATCH, ingest=True)
    tickets, put = {}, INGEST_PUT // 2

    def producer(p):
        for j in range(2):
            lo = (2 * p + j) * put
            tickets[lo] = fe.ingest.put(rows[lo: lo + put])

    t0 = time.perf_counter()
    threads = [threading.Thread(target=producer, args=(p,))
               for p in range(INGEST_THREADS)]
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads) or fe.ingest.depth:
        fe.search(rows[:SERVE_BATCH], k=10)
    for t in threads:
        t.join()
    fe.ingest.flush()
    secs = time.perf_counter() - t0
    gids = np.concatenate([tickets[lo].gids for lo in sorted(tickets)])
    n = 2 * INGEST_THREADS * put
    check(len(np.unique(gids)) == n, "threaded puts shared a gid")
    check(np.array_equal(d.vectors[gids], rows[:n]),
          "a threaded ticket's gids are not in its caller's order")
    print(f"ingest threads: {INGEST_THREADS} producers, {n} rows in "
          f"{secs:.1f} s, gids distinct and in caller order", flush=True)
    return dict(rows=n, seconds=secs)


def phase_ingest_tiers(dev) -> dict:
    """Databases born empty on the persisted tiers at bench width: the
    rows of ``make_medrag_zipf(n=TIER_INGEST_N)`` (d=24) streamed in
    keyed puts of 64 with ``IngestSpec(bootstrap_cutover=128,
    initial_capacity=512, batch_size=64)`` on ``disk``, ``sharded`` (S=2)
    and ``tiered`` (over a disk cold tier), on the card (launches at the
    build formula); then ``save``, and a copy opened on the card and one
    on the CPU (its hot graph, on the tiered tier, the card's), which
    continue with keyed upserts, re-upserts and deletes by key, no
    rebuild: ext ids and keys survive the reopen and the twins are equal
    in every id, hop and block read."""
    from repro_torch import db
    from repro_torch.data import make_medrag_zipf
    from repro_torch.ingest import BootstrapEngine

    wl = make_medrag_zipf(n=TIER_INGEST_N, n_queries=4 * TIER_BATCH)
    rows, qs = wl.corpus, wl.queries
    head = TIER_INGEST_N - TIER_INGEST_MORE
    out = {"launches": {}}
    check(head % 64 == 0, "the persisted tiers' stream is whole puts")
    for tier in ("disk", "sharded", "tiered"):
        tmp = tempfile.mkdtemp(prefix=f"ingest_{tier}_")
        opened = []
        try:
            path = os.path.join(tmp, "born")
            spec = db.IndexSpec(tier=tier, path=path, dim=rows.shape[1],
                                n_shards=2, cache_frames=TIER_FRAMES,
                                ingest=db.IngestSpec(**TIER_INGEST))
            d = db.create(spec)
            opened.append(d)
            t0 = time.perf_counter()
            with build_spy() as spy:
                _, stream_made = counted(lambda: [
                    d.upsert(rows[a: a + 64], keys=list(range(a, a + 64)))
                    for a in range(0, head, 64)])
            check(stream_made == spy.expected(), f"ingest {tier} stream: "
                  f"launches {stream_made} against the build formula "
                  f"{spy.expected()}")
            stream_s = time.perf_counter() - t0
            st = d.backend.ingest_stats()
            check(st["cutovers"] == 1 and st["growths"] >= 2,
                  f"ingest {tier}: transitions {st}")
            check(st["capacity"] - d.n_active >= TIER_INGEST_MORE + 64,
                  f"ingest {tier}: no room to continue without a rebuild")
            ext2int = d.backend._ext2int.copy()
            keys = dict(d.keys._fwd)
            d.save()
            d.close()
            opened.remove(d)
            twins = []
            for name, where in (("card", "cuda"), ("cpu", "cpu")):
                p = os.path.join(tmp, name)
                (shutil.copytree if os.path.isdir(path) else copy_store)(
                    path, p)
                if not os.path.isdir(path):
                    for suffix in (".keys.npz", ".ingest.json"):
                        shutil.copy(path + suffix, p + suffix)
                twins.append(db.open(p, device=where))
                opened.append(twins[-1])
            card, cpu = twins
            for t in twins:
                check(isinstance(t.backend, BootstrapEngine)
                      and np.array_equal(t.backend._ext2int, ext2int)
                      and dict(t.keys._fwd) == keys
                      and t.spec.ingest == spec.ingest,
                      f"ingest {tier}: ext ids, keys or the ingest spec "
                      f"did not survive the reopen")
            if tier == "tiered":
                th, ch = cpu.backend.inner.hot, card.backend.inner.hot
                th._adj_np[:] = ch._adj_np
                th._adj = th._upload(th._adj_np)
                th.medoid = int(ch.medoid)
            inner = card.backend.inner
            units = list(getattr(inner, "shards", None) or [inner])
            more = rows[head:]
            rng = np.random.default_rng(7)
            again = rows[:64] + 0.05 * rng.standard_normal(
                (64, rows.shape[1])).astype(np.float32)

            def cont(t):
                new = t.upsert(more, keys=list(range(head, TIER_INGEST_N)))
                t.upsert(again, keys=list(range(64)))
                t.delete(keys=list(range(64, 192)))
                res = [t.search(qs[a: a + TIER_BATCH], k=TIER_K)
                       for a in range(0, qs.shape[0], TIER_BATCH)]
                return new, res

            with PathSpy(units, inner if tier == "tiered" else None) as ps, \
                    build_spy() as bs:
                (new, res), made = counted(lambda: cont(card))
            want = add_launches(ps.expected("unfused"), bs.expected())
            check(made == want, f"ingest {tier} after the reopen: launches "
                  f"{made} against {want}")
            new_cpu, res_cpu = cont(cpu)
            check(np.array_equal(new, new_cpu), f"ingest {tier}: the twins' "
                  f"gids differ after the reopen")
            check(int(new.min()) == int(ext2int.size),
                  f"ingest {tier}: ext ids did not continue")
            check(all(np.array_equal(a.ids, b.ids)
                      and np.array_equal(a.stats.hops, b.stats.hops)
                      and np.array_equal(a.stats.block_reads,
                                         b.stats.block_reads)
                      for a, b in zip(res, res_cpu)),
                  f"ingest {tier}: card and CPU twins differ after the "
                  f"reopen")
            check(card.backend.growths == card.backend.cutovers == 0,
                  f"ingest {tier}: the continuation rebuilt")
            ingest_twins_equal(card, cpu, f"ingest {tier}")
            dead = np.nonzero(card.backend._ext_tomb)[0]
            check(not np.isin(np.concatenate([r.ids for r in res]),
                              dead).any(),
                  f"ingest {tier}: a tombstoned id came back")
            out[tier] = dict(stream_s=stream_s, stats=st,
                             rows=int(card.backend.ext_rows),
                             reads=float(np.mean([r.stats.block_reads.mean()
                                                  for r in res])))
            out["launches"][f"{tier}_stream"] = stream_made
            out["launches"][f"{tier}_reopen"] = made
            print(f"ingest {tier}: streamed {head} rows in {stream_s:.1f} s "
                  f"(cutover {st['cutover_ms']:.0f} ms, {st['growths']} "
                  f"growths {st['grow_ms']:.0f} ms), reopened on the card "
                  f"and the CPU, {TIER_INGEST_MORE} more rows, 64 "
                  f"re-upserts, 128 deletes: twins equal, "
                  f"{out[tier]['reads']:.2f} block reads a query",
                  flush=True)
        finally:
            for t in opened:
                t.close()
            shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase_baselines(dev) -> dict:
    """The paper's two baselines on the card.  ``HnswEngine`` over
    ``make_tripclick(n=HNSW_N)`` (built once, shared by a plain and a
    catapult engine), two passes of the queries in batches of 256: hops
    and recall@10 beside CPU twins over the same hierarchy and planes
    (ids and hops equal); each batch at ``hnsw_launches``.  Then a
    Proximity cache in front of a database born empty, at
    ``benchmarks/bench_dynamic.py``'s settings (capacity 512, tau 2.0,
    k=5, batches of 50, inserts of 250 every 50 queries) on its d=24
    Zipf workload, static and dynamic: the cached answers' recall beside
    the live database's, and hits, ids and stamps equal to a CPU twin
    cache fed the same queries and database answers."""
    from repro_torch import convert, db
    from repro_torch.core import buckets as bk
    from repro_torch.core import hnsw
    from repro_torch.core.engine import recall_at_k
    from repro_torch.core.lsh import LSHParams
    from repro_torch.data import make_tripclick

    out = {"launches": {}}
    wl = make_tripclick(n=HNSW_N)
    truth = brute_force_knn_cuda(wl.corpus, wl.queries, 10, dev)
    t0 = time.perf_counter()
    with build_spy() as spy:
        cat, made = counted(lambda: hnsw.HnswEngine(
            mode="catapult", device=dev).build(wl.corpus,
                                               db.IndexSpec().vamana()))
    check(made == spy.expected(), f"HNSW build launches {made} against "
          f"{spy.expected()}")
    build_s = time.perf_counter() - t0
    out["launches"]["hnsw_build"] = made
    plain = hnsw.HnswEngine(mode="plain", device=dev)
    plain.index = cat.index
    ix = cat.index
    cpu_ix = convert.hnsw_index_from_numpy(
        ix.vectors.cpu().numpy(), ix.level_ids,
        [a.cpu().numpy() for a in ix.level_adj], ix.base_adj.cpu().numpy(),
        ix.entry, device="cpu")
    twins = {}
    for mode in ("plain", "catapult"):
        t = hnsw.HnswEngine(mode=mode, device="cpu")
        t.index = cpu_ix
        t._lsh = LSHParams(hyperplanes=cat._lsh.hyperplanes.cpu())
        t._buckets = bk.make_buckets(2 ** t.n_bits, t.bucket_capacity,
                                     device="cpu")
        twins[mode] = t
    res = {}
    for mode, eng in (("plain", plain), ("catapult", cat)):
        per_pass = []
        for rnd in range(2):
            with SearchSpy(hnsw) as hs:
                ids, made = counted(lambda: [
                    eng.search(wl.queries[a: a + 256], k=10, beam_width=L)
                    for a in range(0, wl.queries.shape[0], 256)])
            n_b = len(ids)
            per = len(hs.iters) // n_b
            want = expected_launches("diskann", "unfused", [])
            for b in range(n_b):
                add_launches(want, hnsw_launches(
                    mode, hs.iters[b * per: (b + 1) * per]))
            check(made == want, f"HNSW {mode} pass {rnd + 1}: launches "
                  f"{made} against {want}")
            out["launches"][f"hnsw_{mode}_pass{rnd + 1}"] = made
            got = np.concatenate([r[0] for r in ids])
            hops = np.concatenate([r[2]["hops"] for r in ids])
            cpu = [twins[mode].search(wl.queries[a: a + 256], k=10,
                                      beam_width=L)
                   for a in range(0, wl.queries.shape[0], 256)]
            check(np.array_equal(got, np.concatenate([r[0] for r in cpu]))
                  and np.array_equal(hops, np.concatenate(
                      [r[2]["hops"] for r in cpu])),
                  f"HNSW {mode} pass {rnd + 1}: card and CPU twins differ")
            per_pass.append(dict(hops=float(hops.mean()),
                                 recall=recall_at_k(got, truth),
                                 used=float(np.concatenate(
                                     [r[2]["used"] for r in ids]).mean())))
        res[mode] = per_pass
    check(res["catapult"][1]["hops"] < res["plain"][1]["hops"]
          and res["catapult"][1]["recall"] >= res["plain"][1]["recall"]
          - 0.01, f"catapults over HNSW: {res}")
    out["hnsw"] = dict(build_s=build_s, passes=res,
                       levels=[len(i) for i in ix.level_ids])
    print(f"hnsw: build {build_s:.1f} s, levels {out['hnsw']['levels']}; "
          + "; ".join(f"{m} pass {i + 1} hops {p['hops']:.2f} recall@10 "
                      f"{p['recall']:.4f}" for m, ps in res.items()
                      for i, p in enumerate(ps)) + "; CPU twins equal",
          flush=True)
    t0 = time.perf_counter()
    out["proximity"] = proximity(dev)
    out["proximity"]["seconds"] = time.perf_counter() - t0
    out["launches"].update(out["proximity"].pop("launches"))
    return out


def phase_ingest_all(dev) -> dict:
    """This slice's phases: streaming ingest at deployment width, on the
    persisted tiers, and the two baselines."""
    out = {}
    for name, fn in (("ingest", phase_ingest),
                     ("ingest_tiers", phase_ingest_tiers),
                     ("baselines", phase_baselines)):
        t0 = time.perf_counter()
        out[name] = fn(dev)
        out[name]["seconds"] = time.perf_counter() - t0
        print(f"phase {name}: {out[name]['seconds']:.1f} s", flush=True)
    return out


def proximity(dev) -> dict:
    """The Fig. 2 contrast at ``bench_dynamic.run``'s settings: a
    database born empty takes the rows of ``make_medrag_zipf(n=PROX_N,
    d=24)`` (upserts of 256); a Proximity cache in front of it serves a
    hit verbatim and sends misses to the database.  A static replay
    (fresh cache, no inserts), then a dynamic one (fresh cache, 250 rows
    near the stream's queries upserted before every batch of 50 after the
    first): median recall of the served answers beside the database's
    own, against brute force over the live rows.  A CPU twin cache gets
    the same queries and database answers: hits, ids and stamps equal
    after every batch.  The cache launches nothing; the database's
    searches and inserts are on ``IngestSpy``'s formula."""
    from repro_torch import db
    from repro_torch.core import proximity_cache as pc
    from repro_torch.core.engine import recall_at_k
    from repro_torch.data import make_medrag_zipf

    cfg = PROX
    wl = make_medrag_zipf(n=PROX_N, n_queries=PROX_Q)
    d = db.create(db.IndexSpec(dim=wl.corpus.shape[1],
                               ingest=db.IngestSpec()))
    t0 = time.perf_counter()
    for a in range(0, PROX_N, 256):
        d.upsert(wl.corpus[a: a + 256])
    stream_s = time.perf_counter() - t0
    rng = np.random.default_rng(9)
    out = {"stream_s": stream_s, "launches": {}}
    for dynamic in (False, True):
        caches = [pc.make_cache(cfg["capacity"], wl.corpus.shape[1],
                                cfg["k"], device=where)
                  for where in (dev, "cpu")]
        rec_cache, rec_db, hits = [], [], 0

        def replay():
            nonlocal caches, hits
            for i, a in enumerate(range(0, PROX_Q, cfg["batch"])):
                q = wl.queries[a: a + cfg["batch"]]
                if dynamic and i > 0:
                    centers = q[rng.integers(0, q.shape[0],
                                             cfg["insert"])]
                    d.upsert(centers + 0.05 * rng.standard_normal(
                        centers.shape).astype(np.float32))
                hit = [pc.cache_probe(
                    c, torch.as_tensor(q, device=c.keys.device), cfg["tau"])
                    for c in caches]
                ids_db = d.search(q, k=cfg["k"],
                                  beam_width=2 * cfg["k"]).ids
                h = hit[0].hit.cpu().numpy()
                check(np.array_equal(h, hit[1].hit.numpy())
                      and np.array_equal(hit[0].ids.cpu().numpy()[h],
                                         hit[1].ids.numpy()[h]),
                      "Proximity: card and CPU caches' hits differ")
                hits += int(h.sum())
                served = np.where(h[:, None], hit[0].ids.cpu().numpy(),
                                  ids_db)
                caches = [pc.cache_insert(
                    c, torch.as_tensor(q, device=c.keys.device),
                    torch.as_tensor(ids_db, device=c.keys.device),
                    torch.as_tensor(~h, device=c.keys.device))
                    for c in caches]
                check(np.array_equal(caches[0].stamp.cpu().numpy(),
                                     caches[1].stamp.numpy())
                      and np.array_equal(caches[0].values.cpu().numpy(),
                                         caches[1].values.numpy())
                      and caches[0].step == caches[1].step,
                      "Proximity: card and CPU caches' stamps differ")
                truth = brute_force_knn_cuda(d.vectors, q, cfg["k"], dev)
                for row in range(q.shape[0]):
                    rec_cache.append(recall_at_k(served[row: row + 1],
                                                 truth[row: row + 1]))
                    rec_db.append(recall_at_k(ids_db[row: row + 1],
                                              truth[row: row + 1]))

        tag = "dynamic" if dynamic else "static"
        with IngestSpy(d.backend) as spy:
            _, made = counted(replay)
        want = spy.expected("unfused")
        check(made == want, f"Proximity {tag}: launches {made} against "
                            f"{want}")
        out["launches"][f"proximity_{tag}"] = made
        out[tag] = dict(cache_median_recall=float(np.median(rec_cache)),
                        db_median_recall=float(np.median(rec_db)),
                        cache_mean_recall=float(np.mean(rec_cache)),
                        db_mean_recall=float(np.mean(rec_db)), hits=hits,
                        rows=int(d.backend.ext_rows))
        print(f"proximity {tag}: cached answers median recall "
              f"{out[tag]['cache_median_recall']:.3f} (mean "
              f"{out[tag]['cache_mean_recall']:.3f}), the live database "
              f"{out[tag]['db_median_recall']:.3f} (mean "
              f"{out[tag]['db_mean_recall']:.3f}); {hits} hits of {PROX_Q}"
              f" (CPU twin equal); {out[tag]['rows']} rows", flush=True)
    check(out["dynamic"]["cache_mean_recall"]
          < out["dynamic"]["db_mean_recall"],
          "the cache did not go stale under insertion")
    return out


def tier_process(seed: int, dev) -> dict:
    """The second process's work: ``phase_tiers``, then the sharded tier
    at 1,000,000 x 768 (``deploy_sharded``) over the deployment table,
    drawn from ``--seed`` as the main process draws it, and 4 x 4,096
    queries of its own drawn the same way (source rows plus 0.1 noise)."""
    out = phase_tiers(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    vectors = torch.randn((N, D), generator=gen, device=dev)
    rows = torch.randint(0, N, (4 * B,), generator=gen, device=dev)
    queries = (vectors[rows] + 0.1 * torch.randn(
        (4 * B, D), generator=gen, device=dev)).cpu().numpy()
    vec_np = vectors.cpu().numpy()
    del vectors
    paths, tmp = {}, tempfile.mkdtemp(prefix="deploy_sharded_")
    t0 = time.perf_counter()
    try:
        sharded = deploy_sharded(vec_np, queries, rows.cpu().numpy(), paths,
                                 dev, tmp, seed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    sharded.update(launches=paths, seconds=time.perf_counter() - t0)
    print(f"phase deployment sharded: {sharded['seconds']:.1f} s",
          flush=True)
    out["deployment_sharded"] = sharded
    return out


def phase_tiers(dev) -> dict:
    """The sharded, mesh and tiered phases on one medrag workload."""
    from repro_torch.data import make_medrag_zipf
    wl = make_medrag_zipf(n=BENCH_N, n_queries=BENCH_Q)
    out = {}
    for name, fn in (("sharded", phase_sharded), ("mesh", phase_mesh),
                     ("tiered", phase_tiered)):
        t0 = time.perf_counter()
        out[name] = fn(wl, dev)
        out[name]["seconds"] = time.perf_counter() - t0
        print(f"phase {name}: {out[name]['seconds']:.1f} s", flush=True)
    return out


def phase_filtered(dev) -> dict:
    """``make_papers(n=PAPERS_N)`` (10,000 x 24, 16 labels, 2,048 queries,
    each with its own label): one ``build_stitched_graph`` on the card,
    then the catapult, diskann, fused and CPU twins with
    ``IndexSpec(filters=True)`` over it, replayed twice, at full
    precision and with ``pq=8``."""
    from repro_torch import db
    from repro_torch.core.filters import build_stitched_graph
    from repro_torch.data import make_papers

    print(f"reduced: the filtered phase builds its stitched graph over "
          f"make_papers(n={PAPERS_N:,}), not its default 20,000 rows: the "
          f"build is minutes of host RobustPrune, and the run has to stay "
          f"inside its time limit", flush=True)
    wl = make_papers(n=PAPERS_N)
    truth = brute_force_knn_cuda(wl.corpus, wl.queries, 10, dev,
                                 labels=wl.labels,
                                 filter_labels=wl.filter_labels)

    def build():
        t0 = time.perf_counter()
        g = build_stitched_graph(wl.corpus, wl.labels, N_LABELS,
                                 db.IndexSpec().vamana(), device=dev)
        return g, time.perf_counter() - t0

    (graph, build_s), built = counted(build)
    check(built["gather_distance"] > 0
          and not any(n for k, n in built.items() if k != "gather_distance"),
          f"the stitched build's searches did not run on the gather-distance "
          f"kernel alone: {built}")
    out = replay_twins(wl, truth, graph, dev, filtered=True)
    out["build_s"] = build_s
    out["launches"]["filtered_build"] = built
    out["pq"] = replay_twins(wl, truth, graph, dev, pq=8, filtered=True)
    return out


def phase_mutations(wl, graph, dev) -> dict:
    """The tripclick catapult twin with ``spare_capacity=1,280`` (the
    1,024 upserted rows and the 256 that replace some of them; buckets
    warmed by one replay) and a CPU twin over the same graph take the
    same steps: ``upsert`` 1,024 rows with keys, search those rows,
    ``upsert`` 256 of the keys again (a true upsert), ``delete`` 512 by
    key, ``consolidate``.  After every step the two hold the same
    adjacency, tombstones and medoid; no dead id comes back from a search
    or stays in a bucket; recall@10 over the live rows stays within 1
    point of the CPU twin's.  The share of upserted rows that come back
    as their own top-1 is held within 1 point of the CPU twin's, not to
    1: the reference's insert can leave a row of a batch with no in-edge
    (a later row's reverse-edge prune drops it), and such rows are not
    found."""
    from repro_torch import db
    from repro_torch.core.engine import recall_at_k
    rng = np.random.default_rng(1024)
    n = wl.corpus.shape[0]
    new = (wl.corpus[rng.integers(0, n, 1024)]
           + 0.25 * rng.normal(size=(1024, wl.corpus.shape[1]))).astype(
               np.float32)
    spec = db.IndexSpec(spare_capacity=1280)
    twins = {where: db.create(spec, wl.corpus, prebuilt=graph, device=where)
             for where in ("cuda", "cpu")}
    card = twins["cuda"]
    for d in twins.values():
        replay(d, wl.queries, passes=1)
    out, paths, steps = {}, {}, {}

    def step(name, fn, search=None):
        t0 = time.perf_counter()
        got, paths[f"mutation_{name}"] = counted(lambda: fn(card))
        steps[name] = time.perf_counter() - t0
        fn(twins["cpu"])
        a, b = card.backend, twins["cpu"].backend
        same = dict(adjacency=bool(np.array_equal(a._adj_np, b._adj_np)),
                    tombstones=bool(np.array_equal(a._tomb_np, b._tomb_np)),
                    medoid=a.medoid == b.medoid,
                    device_adjacency=bool(np.array_equal(
                        a._adj.cpu().numpy(), a._adj_np)))
        if not all(same.values()):
            rows = (a._adj_np != b._adj_np).any(1).nonzero()[0]
            print(f"mutation {name}: card and CPU twins differ {same}; "
                  f"{rows.size} adjacency rows, first {rows[:8].tolist()}")
        check(all(same.values()), f"mutation {name}: the card twin's state "
                                  f"differs from the CPU twin's: {same}")
        return got

    keys = list(range(1024))
    gids = step("upsert", lambda d: d.upsert(new, keys=keys))
    check(paths["mutation_upsert"]["gather_distance"] > 0
          and sum(paths["mutation_upsert"].values())
          == paths["mutation_upsert"]["gather_distance"],
          f"the insert searches did not run on the gather-distance kernel "
          f"alone: {paths['mutation_upsert']}")
    res, paths["mutation_search"] = counted(lambda: [
        card.search(new[lo: lo + 256], k=10) for lo in range(0, 1024, 256)])
    want = expected_launches("catapult", "unfused",
                             [int(r.stats.hops.max()) for r in res])
    check(paths["mutation_search"] == want,
          f"searching the upserted rows launched "
          f"{paths['mutation_search']}, its batches imply {want}")
    top1 = np.concatenate([r.ids[:, 0] for r in res])
    cpu_top1 = np.concatenate([twins["cpu"].search(new[lo: lo + 256],
                                                   k=10).ids[:, 0]
                               for lo in range(0, 1024, 256)])
    adj = card.backend._adj_np
    in_deg = np.bincount(adj[adj >= 0], minlength=adj.shape[0])[gids]
    out.update(upserted_own_top1=float(np.mean(top1 == gids)),
               upserted_own_top1_cpu=float(np.mean(cpu_top1 == gids)),
               upserted_without_in_edge=int((in_deg == 0).sum()))
    check(abs(out["upserted_own_top1"] - out["upserted_own_top1_cpu"])
          <= 0.01, f"upserted rows found as their own top-1: "
                   f"{out['upserted_own_top1']} on the card against "
                   f"{out['upserted_own_top1_cpu']} on the CPU twin")
    again = step("reupsert", lambda d: d.upsert(new[:256] + 0.01,
                                                keys=keys[:256]))
    step("delete", lambda d: d.delete(keys=keys[512:]))
    for name in ("reupsert", "delete"):
        extra = {k: v for k, v in paths[f"mutation_{name}"].items()
                 if k != "gather_distance" or name == "delete"}
        check(not any(extra.values()), f"mutation {name} launched "
                                       f"{paths[f'mutation_{name}']}")
    dead = np.concatenate([gids[:256], gids[512:]])
    check(card.tombstones[dead].all() and not card.tombstones[again].any(),
          "the upserted/deleted rows' tombstones are wrong")
    live_q = np.concatenate([new, new[:256] + 0.01, wl.queries[-512:]])

    def no_dead(tag):
        ids = np.concatenate([card.search(live_q[lo: lo + 256], k=10).ids
                              for lo in range(0, live_q.shape[0], 256)])
        in_buckets = int(np.isin(card.backend._cat.buckets.ids.cpu().numpy(),
                                 dead).sum())
        came_back = int(np.isin(ids, dead).sum())
        out[f"dead_ids_{tag}"] = dict(returned=came_back,
                                      in_buckets=in_buckets)
        check(came_back == 0 and in_buckets == 0,
              f"dead ids {tag}: {came_back} returned, {in_buckets} in "
              f"buckets")

    no_dead("after_delete")
    out["repaired_rows"] = step("consolidate", lambda d: d.consolidate())
    check(not any(paths["mutation_consolidate"].values()),
          f"consolidate launched {paths['mutation_consolidate']}")
    no_dead("after_consolidate")
    tomb = card.tombstones
    truth = brute_force_knn_cuda(card.vectors, live_q, 10, dev,
                                 exclude=np.nonzero(tomb)[0])
    for where, d in twins.items():
        ids = np.concatenate([d.search(live_q[lo: lo + 256], k=10).ids
                              for lo in range(0, live_q.shape[0], 256)])
        out[f"recall_at_10_{where}"] = recall_at_k(ids, truth)
    check(abs(out["recall_at_10_cuda"] - out["recall_at_10_cpu"]) <= 0.01,
          f"mutated card twin's recall {out['recall_at_10_cuda']} is not "
          f"within 1 point of the CPU twin's {out['recall_at_10_cpu']}")
    out.update(launches=paths, step_s=steps, dead=int(dead.size),
               tombstone_fraction=card.backend.tombstone_fraction())
    print(f"mutations: {out}")
    return out


def phase_modes(wl, graph, dev) -> dict:
    """``mode='lsh_apg'`` and ``search_two_phase`` (catapult mode) over
    the tripclick graph under both hop backends, replayed twice: fused
    ids equal unfused ids; lsh_apg's pass-2 hops equal its pass-1 hops
    (its table never adapts); the two-phase catapult ``won`` is nonzero
    on the replay."""
    from repro_torch import db
    out, paths, runs = {}, {}, {}
    for hb in ("unfused", "fused"):
        (d, paths[f"lsh_apg_build_{hb}"]) = counted(lambda hb=hb: db.create(
            db.IndexSpec(mode="lsh_apg", hop_backend=hb), wl.corpus,
            prebuilt=graph))
        check(paths[f"lsh_apg_build_{hb}"] == dict(
                  expected_launches("diskann", hb, []), lsh_hash=1),
              f"the lsh_apg build launched {paths[f'lsh_apg_build_{hb}']}, "
              f"not one lsh_hash over the corpus")
        for tag, mode, kw in (("lsh_apg", "lsh_apg", {}),
                              ("two_phase", "catapult",
                               dict(two_phase=True))):
            if tag == "two_phase":
                d = db.create(db.IndexSpec(hop_backend=hb), wl.corpus,
                              prebuilt=graph)
            name = f"{tag}_{hb}"
            runs[name], paths[name] = counted(
                lambda d=d, kw=kw: replay(d, wl.queries, **kw))
            want = path_launches(mode, hb, runs[name], **kw)
            check(paths[name] == want, f"{name} replay launched "
                                       f"{paths[name]}, its batches imply "
                                       f"{want}")
            out[name] = [dict(mean_hops=float(p["hops"].mean()),
                              won=float(p["won"].mean()),
                              batch_ms_mean=float(np.mean(p["batch_ms"])))
                         for p in runs[name]]
    for tag in ("lsh_apg", "two_phase"):
        for i in range(2):
            check(np.array_equal(runs[f"{tag}_fused"][i]["ids"],
                                 runs[f"{tag}_unfused"][i]["ids"]),
                  f"{tag}: hop_backend='fused' ids differ from 'unfused'")
    first, second = runs["lsh_apg_unfused"]
    check(np.array_equal(first["hops"], second["hops"]),
          "lsh_apg hops changed on the replay (its table must not adapt)")
    check(runs["two_phase_unfused"][1]["won"].any(),
          "search_two_phase: no catapult won on the replay")
    out["launches"] = paths
    print(f"modes: {out}")
    return out


def adapt_twins(spec, corpus, graph, queries, dev, on_flush=None,
                freeze_at=None) -> dict:
    """Serve ``queries`` through ``db.serve(max_batch=SERVE_BATCH)`` of a
    database per ``spec`` on the card, counted and spied, and (unless
    ``freeze_at``) through its CPU twin; the card run's launches must
    equal ``serve_launches``.  ``on_flush(i, maintainer, spy)`` runs after
    the card twin's flush i.  Returns per device: the spy, flush ms, the
    maintainer's snapshot and the final bucket table."""
    from repro_torch import db
    from repro_torch.core import buckets as bk
    out = {}
    for where in ("cuda",) if freeze_at is not None else ("cuda", "cpu"):
        d = db.create(spec, corpus, prebuilt=graph, device=where)
        fe = d.serve(max_batch=SERVE_BATCH)

        def drive(d=d, fe=fe, where=where):
            with ServeSpy(d.backend, freeze_at) as spy:
                hook = (None if on_flush is None or where != "cuda" else
                        lambda i: on_flush(i, fe.maintainer, spy))
                ms = serve_stream(fe, queries, SERVE_BATCH, hook)
            return spy, ms

        if where == "cuda":
            (spy, ms), launches = counted(drive)
            want = serve_launches(spy.batches, "unfused")
            check(launches == want, f"served stream launched {launches}, "
                                    f"its batches imply {want}")
        else:
            spy, ms = drive()
            launches = None
        m = fe.maintainer
        out[where] = dict(spy=spy, ms=ms, launches=launches,
                          snapshot=None if m is None else m.snapshot(),
                          buckets=bk.to_arrays(d.backend._cat.buckets))
        if m is not None:
            tel = d.backend.adapt_state
            folds = sum(b["folded"] for b in spy.batches)
            check(int(tel.n_batches) + int(tel.n_base) == folds,
                  f"the telemetry counts {int(tel.n_batches)} + "
                  f"{int(tel.n_base)} folded batches, the spy {folds}")
    if "cpu" in out:
        c, p = out["cuda"]["snapshot"], out["cpu"]["snapshot"]
        diff = {k: (c[k], p[k]) for k in ADAPT_EVENTS if c[k] != p[k]}
        same = {k: bool(np.array_equal(out["cuda"]["buckets"][k],
                                       out["cpu"]["buckets"][k]))
                for k in ("ids", "stamp")}
        check(not diff and all(same.values()),
              f"the card twin's maintainer differs from the CPU twin's: "
              f"events {diff}, equal buckets {same}")
    return out


def phase_adapt_shift(graph, dev) -> dict:
    """``make_shifted_zipf(kind="sudden")`` at the generator's defaults
    (20,000 x 24, 256 clusters, 4,096 queries, the hot set swapped at
    query 2,048) served through ``db.serve(max_batch=64)`` with the
    reference bench's ``SHIFT_POLICY`` and ``adapt_tick_every=2``: a card
    twin and a CPU twin with equal event counters and buckets, at least
    one drift flush after the shift, a recovered post-shift win share,
    and a frozen-buckets twin (its publishes discarded from the shift on,
    no maintainer) that recovers less or not at all."""
    from repro_torch import db
    from repro_torch.adapt import PolicyConfig
    from repro_torch.data import make_shifted_zipf
    wl = make_shifted_zipf(kind="sudden")
    shift_batch = wl.meta["shift_point"] // SERVE_BATCH
    spec = db.IndexSpec(adapt=PolicyConfig(**SHIFT_POLICY),
                        adapt_tick_every=SHIFT_TICK_EVERY)
    windows, at_shift = [], {}

    def on_flush(i, m, spy):
        """The snapshot at the shift, and a readout every 4 flushes (host
        syncs, outside the timed flushes)."""
        if i + 1 == shift_batch:
            at_shift.update(m.snapshot())
        if (i + 1) % 4 == 0:
            s = m.snapshot()
            windows.append(dict(
                flushes=i + 1, win_ewma=s["win_ewma"], drift=s["drift"],
                drift_flushes=s["drift_flushes"], enabled=s["enabled"],
                hops=float(np.mean([b["hops"] for b in spy.batches[-4:]]))))

    out = {"rows": wl.corpus.shape[0], "queries": wl.queries.shape[0],
           "shift_batch": shift_batch}
    runs = adapt_twins(spec, wl.corpus, graph, wl.queries, dev,
                       on_flush=on_flush)
    frozen = adapt_twins(dataclasses.replace(spec, adapt=None), wl.corpus,
                         graph, wl.queries, dev, freeze_at=shift_batch)
    card = runs["cuda"]
    for w in windows:
        ms = card["ms"][w["flushes"] - 4: w["flushes"]]
        w["flush_ms"] = float(np.mean(ms))
        print(f"adapt shift window to flush {w['flushes']}: win EWMA "
              f"{w['win_ewma']:.4f}, drift {w['drift']:.4f}, drift flushes "
              f"{w['drift_flushes']}, enabled {w['enabled']}, hops a query "
              f"{w['hops']:.2f}, flush ms {w['flush_ms']:.2f}")
    for name, r in (("adaptive", card), ("frozen", frozen["cuda"])):
        pre, post, rec = adaptation_metrics(r["spy"].wins(), shift_batch,
                                            SERVE_BATCH)
        hops = [b["hops"] for b in r["spy"].batches]
        out[name] = dict(pre_shift_win=pre, post_shift_win=post,
                         recovery_queries=rec,
                         post_shift_hops=float(np.mean(hops[shift_batch:])),
                         flush_ms_mean=float(np.mean(r["ms"])),
                         flush_ms_p50=float(np.median(r["ms"])),
                         launches=r["launches"])
    out["adaptive"]["snapshot"] = card["snapshot"]
    out["adaptive"]["cpu_snapshot"] = runs["cpu"]["snapshot"]
    out["windows"] = windows
    after = card["snapshot"]["drift_flushes"] - at_shift["drift_flushes"]
    out["drift_flushes_after_shift"] = after
    print(f"adapt shift: {out}")
    a, f = out["adaptive"], out["frozen"]
    check(after >= 1, "no drift flush after the shift point")
    check(a["recovery_queries"] != -1,
          f"the adaptive twin's win share did not recover after the shift: "
          f"{a}")
    check(f["recovery_queries"] == -1
          or f["post_shift_win"] < a["post_shift_win"],
          f"the frozen twin recovered as well as the adaptive one: {f}")
    return out


def phase_adapt_stationary(wl, graph, dev, seed: int) -> dict:
    """Uniform queries (U(-1, 1)^d x 4 from ``--seed``, as ``make_uniform``
    draws them) over the tripclick graph, served with the production
    ``PolicyConfig()`` and ``adapt_tick_every=STATIONARY_TICK``: at least
    one shadow batch, launches as the formula gives them, event counters
    and buckets equal to the CPU twin's; reports whether the gate turned
    catapults off, and the probes."""
    from repro_torch import db
    from repro_torch.adapt import PolicyConfig
    rng = np.random.default_rng(seed)
    queries = rng.uniform(-1, 1, size=(STATIONARY_QUERIES,
                                       wl.corpus.shape[1])
                          ).astype(np.float32) * 4.0
    spec = db.IndexSpec(adapt=PolicyConfig(),
                        adapt_tick_every=STATIONARY_TICK)
    runs = adapt_twins(spec, wl.corpus, graph, queries, dev)
    card = runs["cuda"]
    s = card["snapshot"]
    spy = card["spy"]
    out = dict(queries=STATIONARY_QUERIES, snapshot=s,
               gate_turned_off=s["gate_transitions"] > 0,
               batches_gated_off=sum(not b["active"] and not b["enabled"]
                                     for b in spy.batches),
               folded_batches=sum(b["folded"] for b in spy.batches),
               flush_ms_mean=float(np.mean(card["ms"])),
               launches=card["launches"])
    print(f"adapt stationary: {out}")
    check(s["shadows"] >= 1, "the stationary stream ran no shadow batch")
    return out


def deploy_serve(vectors, vec_np, graph, dev) -> dict:
    """``db.serve(max_batch=4096)`` over 1,000,000 x 768 (beam 16), in
    turns with and without the maintainer (``PolicyConfig()``,
    ``adapt_tick_every=4``), over ``DEPLOY_FLUSHES`` flushes of fresh
    random queries each; the fold's device time (one ``lsh_hash`` at
    (4096, 768) plus the histogram scatter), tick ms and a flush's
    device idle share."""
    from repro_torch import db
    from repro_torch.adapt import PolicyConfig
    from repro_torch.adapt import stats as ts
    gen = torch.Generator(device=dev).manual_seed(DEPLOY_FLUSHES)
    batches = []
    for _ in range(DEPLOY_FLUSHES + 2):
        rows = torch.randint(0, N, (B,), generator=gen, device=dev)
        batches.append((vectors[rows] + 0.1 * torch.randn(
            (B, D), generator=gen, device=dev)).cpu().numpy())
    spec = db.IndexSpec(dim=D, degree=64, beam_width=16)
    dbs = {"plain": db.create(spec, vec_np, prebuilt=graph),
           "adapt": db.create(dataclasses.replace(
               spec, adapt=PolicyConfig(), adapt_tick_every=4), vec_np,
               prebuilt=graph)}
    fes = {name: d.serve(max_batch=B) for name, d in dbs.items()}
    spies = {name: ServeSpy(d.backend) for name, d in dbs.items()}
    ms = {name: [] for name in dbs}
    launches = {name: dict.fromkeys(
        ("gather_distance", "lsh_hash", "fused_hop_l2", "fused_hop_pq",
         "pq_adc", "l2_distance"), 0) for name in dbs}
    for i, q in enumerate(batches[:DEPLOY_FLUSHES]):
        for name in (("plain", "adapt") if i % 2 == 0 else ("adapt",
                                                            "plain")):
            with spies[name]:
                got, n = counted(lambda: serve_stream(fes[name], q, B))
            ms[name].extend(got)
            for k, v in n.items():
                launches[name][k] += v
    for name in dbs:
        want = serve_launches(spies[name].batches, "unfused")
        check(launches[name] == want,
              f"deployment width serve ({name}): launched {launches[name]}, "
              f"its batches imply {want}")
    eng = dbs["adapt"].backend
    m = fes["adapt"].maintainer
    qd = torch.as_tensor(batches[0], device=dev)
    ones = torch.ones(B, dtype=torch.bool, device=dev)
    hops = torch.full((B,), 20.0, device=dev)
    state = eng.adapt_state
    fold_ms = cuda_ms(lambda: ts.observe_update(state, eng._cat.lsh, qd, ones,
                                                ones, hops, ones), reps=20)
    hash_ms = cuda_ms(lambda: ts.lsh_mod.hash_codes(eng._cat.lsh, qd),
                      reps=20)
    tick_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        m.tick()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    extra = batches[DEPLOY_FLUSHES]

    def flush():
        serve_stream(fes["adapt"], extra, B)

    flush()
    t0 = time.perf_counter()
    flush()
    wall = (time.perf_counter() - t0) * 1e3
    busy = device_busy_ms(flush)
    out = dict(flushes=DEPLOY_FLUSHES, batch=B, ms=ms,
               flush_ms_mean={k: float(np.mean(v)) for k, v in ms.items()},
               flush_ms_p50={k: float(np.median(v)) for k, v in ms.items()},
               fold_device_ms=fold_ms, fold_lsh_hash_ms=hash_ms,
               tick_ms=tick_ms, tick_ms_p50=float(np.median(tick_ms)),
               one_flush=dict(wall_ms=wall, device_busy_ms=busy,
                              idle_share=(1.0 - busy / wall) if busy > 0
                              else None),
               snapshot=m.snapshot(), launches=launches)
    print(f"deployment serve: {out}")
    return out


def phase_deployment(vectors, gen, seed: int, dev, kernel_ms) -> dict:
    """1,000,000 x 768 over a random regular graph of degree 64, 4 batches
    of 4,096 queries (beam 16, max_iters 64) under both hop backends, at
    full precision and with PQ (M=8, K=256); then a small PQ twin with
    M=96 (20,000 x 768, one batch of 256)."""
    from repro_torch import db
    from repro_torch.core import buckets as bk
    from repro_torch.core import pq as pq_mod
    from repro_torch.core.vamana import _random_regular_init, medoid_index
    from repro_torch.kernels import ops

    vec_np = vectors.cpu().numpy()
    rng = np.random.default_rng(seed)
    graph = (_random_regular_init(N, 64, rng), medoid_index(vec_np))
    rows = torch.randint(0, N, (4 * B,), generator=gen, device=dev)
    queries = (vectors[rows] + 0.1 * torch.randn((4 * B, D), generator=gen,
                                                 device=dev)).cpu().numpy()
    out, ids, paths, peak = {}, {}, {}, {}

    # the codebook the PQ twins train, timed alone (same seed stream)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cb = pq_mod.train_pq(torch.Generator().manual_seed(db.IndexSpec().seed
                                                       + 1),
                         vectors, PQ_M, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    codes = pq_mod.encode(cb, vectors)
    torch.cuda.synchronize()
    out["pq_train_s"], out["pq_encode_s"] = t1 - t0, time.perf_counter() - t1
    qd = torch.as_tensor(queries[:B], device=dev)
    out["pq_lut_ms_per_batch"] = cuda_ms(lambda: pq_mod.query_luts(cb, qd),
                                         reps=10)

    for hb, pq in (("unfused", None), ("fused", None), ("unfused", PQ_M),
                   ("fused", PQ_M)):
        name = ("pq_" if pq else "") + hb

        def drive(hb=hb, pq=pq):
            t0 = time.perf_counter()
            d = db.create(db.IndexSpec(dim=D, degree=64, hop_backend=hb,
                                       pq=pq), vec_np, prebuilt=graph)
            create_s = time.perf_counter() - t0
            ms, hops, got = [], [], []
            for i in range(4):
                t0 = time.perf_counter()
                r = d.search(queries[i * B: (i + 1) * B], k=10,
                             beam_width=16, max_iters=64)
                ms.append((time.perf_counter() - t0) * 1e3)
                hops.append(r.stats.hops)
                got.append(r.ids)
            return d, create_s, ms, hops, got

        torch.cuda.reset_peak_memory_stats()
        (d, create_s, ms, hops, got), paths[name] = counted(drive)
        peak[name] = torch.cuda.max_memory_allocated() / 1e9
        want = expected_launches("catapult", hb, [int(h.max()) for h in hops],
                                 pq=bool(pq))
        check(paths[name] == want, f"deployment width {name}: launched "
                                   f"{paths[name]}, its batches imply {want}")
        ids[name] = np.concatenate(got)
        prof = idle_share(d, queries[:B], k=10, beam_width=16, max_iters=64)
        iters = float(np.mean([h.max() for h in hops]))
        k_ms = kernel_ms[{(False, "unfused"): "gather_distance",
                          (False, "fused"): "fused_hop_l2",
                          (True, "unfused"): "pq_adc",
                          (True, "fused"): "fused_hop_pq"}[bool(pq), hb]]
        out[name] = dict(create_s=create_s, batch_ms=ms,
                         batch_ms_mean=float(np.mean(ms)),
                         mean_hops=float(np.mean(np.concatenate(hops))),
                         loop_iterations=iters,
                         host_ms_per_hop=(float(np.mean(ms)) - iters * k_ms)
                         / iters, one_batch=prof, peak_memory_gb=peak[name])
        if pq and hb == "unfused":
            check(torch.equal(d.backend._pq.centroids, cb.centroids)
                  and torch.equal(d.backend._codes[:N], codes),
                  "deployment width: retraining PQ from one seed gave "
                  "another codebook or other codes")
            out["pq_stages_batch_4096"] = pq_stages(
                d, queries[:B], dev, k=10, beam_width=16, max_iters=64)
        if name == "unfused":
            # the serial-LRU publish of one 4096-query batch, on the host
            st = d.backend._cat
            hashes = ops.lsh_hash(qd, st.lsh.hyperplanes)
            best = torch.as_tensor(ids[name][:B, 0], device=dev)
            tags = torch.full((B,), -1, dtype=torch.int32, device=dev)
            for nb in (256, B):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    bk.publish(st.buckets, hashes[:nb], best[:nb], tags[:nb])
                out[f"publish_host_ms_b{nb}"] = \
                    (time.perf_counter() - t0) * 1e3 / 3
        del d

    # IndexSpec(pq=96): a 96 KB LUT a query, on a 20,000-row slice of the
    # table over its own random regular graph (degree 32), one batch of
    # 256 under both backends
    n96 = 20_000
    graph96 = (_random_regular_init(n96, 32, rng), medoid_index(vec_np[:n96]))
    for hb in ("unfused", "fused"):
        def drive96(hb=hb):
            d = db.create(db.IndexSpec(dim=D, degree=32, pq=PQ_M_WIDE,
                                       hop_backend=hb), vec_np[:n96],
                          prebuilt=graph96)
            return d.search(queries[:256], k=10, beam_width=16, max_iters=64)

        name = f"pq{PQ_M_WIDE}_{hb}"
        r, paths[name] = counted(drive96)
        want = expected_launches("catapult", hb, [int(r.stats.hops.max())],
                                 pq=True)
        check(paths[name] == want, f"{name} (d={D}, {n96} rows): launched "
                                   f"{paths[name]}, its batch implies {want}")
        ids[name] = r.ids
        out[name] = dict(rows=n96, mean_hops=float(r.stats.hops.mean()))

    # this slice's paths at the same width: filtered, mutations, lsh_apg;
    # consolidate on the pq=96 slice
    rows_np = rows.cpu().numpy()
    # the batch's results, best first: its distinct top-1 ids, then the
    # next column's, ... up to 4,096 rows to delete
    flat = ids["unfused"][:B].T.ravel()
    flat = flat[flat >= 0]
    _, first = np.unique(flat, return_index=True)
    dead = flat[np.sort(first)][:B]
    # the disk phase's store stays here for the tiered phase
    tmp = tempfile.mkdtemp(prefix="deploy_disk_")
    for name, fn in (
            ("filtered", lambda: deploy_filtered(
                vec_np, graph, queries, rows_np, rng, paths, ids, dev)),
            ("mutations", lambda: deploy_mutations(
                vec_np, graph, queries, dead, rng, paths)),
            ("lsh_apg", lambda: deploy_lsh_apg(vec_np, graph, queries, paths,
                                               ids)),
            ("consolidate", lambda: deploy_consolidate(
                vec_np[:n96], graph96, queries, rng, paths)),
            ("serve", lambda: deploy_serve(vectors, vec_np, graph, dev)),
            ("disk", lambda: deploy_disk(vec_np, graph, queries, paths,
                                         dev, tmp)),
            ("tiered", lambda: deploy_tiered(tmp, out["disk"], queries,
                                             paths, dev)),
            ("mesh", lambda: deploy_mesh(vectors, vec_np, queries, rows_np,
                                         paths, dev, seed))):
        t0 = time.perf_counter()
        try:
            out[name] = fn()
        finally:
            if name == "mesh" or name not in out:
                shutil.rmtree(tmp, ignore_errors=True)
        out[name]["seconds"] = time.perf_counter() - t0
        print(f"phase deployment {name}: {out[name]['seconds']:.1f} s",
              flush=True)
    for name, n in out["serve"]["launches"].items():
        paths[f"serve_{name}"] = n
    out["launches"] = paths
    out["max_memory_allocated_gb"] = max(peak["unfused"], peak["fused"])
    out["pq_max_memory_allocated_gb"] = max(peak["pq_unfused"],
                                            peak["pq_fused"])
    flag = torch.ones(1, dtype=torch.bool, device=dev)
    t0 = time.perf_counter()
    for _ in range(200):
        bool(flag.any())
    out["sync_roundtrip_us"] = (time.perf_counter() - t0) * 1e6 / 200
    print(f"deployment width: {out}")
    check(np.array_equal(ids["unfused"], ids["fused"]),
          "deployment width: fused and unfused ids differ")
    check(np.array_equal(ids["pq_unfused"], ids["pq_fused"]),
          "deployment width: PQ fused and unfused ids differ")
    check(np.array_equal(ids[f"pq{PQ_M_WIDE}_unfused"],
                         ids[f"pq{PQ_M_WIDE}_fused"]),
          f"IndexSpec(pq={PQ_M_WIDE}): fused and unfused ids differ")
    return out


def stitched_shape(global_adj, labels, rng, label_degree=32):
    """A stitched-shaped adjacency over random regular graphs: the global
    rows, then each label's own random regular subgraph of
    ``label_degree`` remapped to global ids in the slack columns, laid
    out as ``core.filters.build_stitched_graph`` lays them (edges a row
    already has are skipped, the rest fill its free slots in order)."""
    from repro_torch.core.vamana import _random_regular_init
    n, rg = global_adj.shape
    out = np.full((n, rg + label_degree), -1, np.int32)
    out[:, :rg] = global_adj
    earlier = np.tril(np.ones((label_degree, label_degree), bool), -1)
    for lbl in range(int(labels.max()) + 1):
        idx = np.nonzero(labels == lbl)[0]
        if idx.size < 2:
            continue
        sub = _random_regular_init(idx.size, label_degree, rng)
        for lo in range(0, idx.size, 16384):
            rows = idx[lo: lo + 16384]
            cand = idx[sub[lo: lo + 16384]]                     # global ids
            dup = ((cand[:, :, None] == global_adj[rows][:, None, :]).any(2)
                   | ((cand[:, :, None] == cand[:, None, :])
                      & earlier[None]).any(2))
            keep = ~dup
            pos = np.cumsum(keep, 1) - 1
            r, c = np.nonzero(keep)
            out[rows[r], rg + pos[r, c]] = cand[r, c]
    return out


def deploy_filtered(vec_np, graph, queries, rows, rng, paths, ids, dev):
    """1,000,000 x 768 filtered: 16 random labels, a stitched-shaped
    adjacency (1M, 64 + 32), entries from ``label_entry_points``, each
    query filtered to the label of the row it was drawn from; 4 batches
    of 4,096 under both backends.  Every id satisfies its predicate and
    fused ids equal unfused ids."""
    from repro_torch import db
    from repro_torch.core.filters import label_entry_points
    t0 = time.perf_counter()
    labels = rng.integers(0, N_LABELS, N).astype(np.int32)
    adj = stitched_shape(graph[0], labels, rng)
    entries = label_entry_points(vec_np, labels, N_LABELS)
    out = dict(setup_s=time.perf_counter() - t0,
               adjacency_mb=adj.nbytes / 1e6)
    fl = labels[rows]
    for hb in ("unfused", "fused"):
        def drive(hb=hb):
            d = db.create(db.IndexSpec(dim=D, degree=64, filters=True,
                                       hop_backend=hb), vec_np, labels,
                          prebuilt=(adj, graph[1], entries))
            ms, got = [], []
            for i in range(4):
                sl = slice(i * B, (i + 1) * B)
                t0 = time.perf_counter()
                got.append(d.search(queries[sl], k=10, beam_width=16,
                                    max_iters=64, filter_labels=fl[sl]))
                ms.append((time.perf_counter() - t0) * 1e3)
            return d, ms, got

        name = f"filtered_{hb}"
        (d, ms, got), paths[name] = counted(drive)
        want = expected_launches("catapult", hb,
                                 [int(r.stats.hops.max()) for r in got],
                                 filtered=True)
        check(paths[name] == want, f"deployment width {name}: launched "
                                   f"{paths[name]}, its batches imply {want}")
        ids[name] = np.concatenate([r.ids for r in got])
        bad = off_label(ids[name], fl, labels)
        out[hb] = dict(batch_ms=ms, batch_ms_mean=float(np.mean(ms)),
                       mean_hops=float(np.mean([r.stats.hops.mean()
                                                for r in got])),
                       loop_iterations=float(np.mean(
                           [r.stats.hops.max() for r in got])),
                       used=float(np.mean([r.stats.used.mean()
                                           for r in got])),
                       off_label_ids=bad,
                       one_batch=idle_share(d, queries[:B], k=10,
                                            beam_width=16, max_iters=64,
                                            filter_labels=fl[:B]))
        check(bad == 0, f"deployment width {name}: {bad} ids off their "
                        f"lane's label")
        del d
    check(np.array_equal(ids["filtered_unfused"], ids["filtered_fused"]),
          "deployment width filtered: fused and unfused ids differ")
    print(f"deployment filtered: {out}")
    return out


def deploy_mutations(vec_np, graph, queries, dead, rng, paths):
    """1,000,000 x 768: ``upsert`` one batch of ``DEPLOY_UPSERT`` rows
    (timed; its searches on the gather-distance kernel alone), ``delete``
    4,096 result ids of a published batch of 4,096 (its top-1 ids
    first), then the same batch again: no dead id returned, none left in
    a bucket."""
    from repro_torch import db
    print(f"reduced: the upsert at {N:,} x {D} takes {DEPLOY_UPSERT} rows, "
          f"not 256: host RobustPrune of an insert's ~8,000 scored "
          f"candidates at d={D} takes ~0.7 s a row", flush=True)
    d = db.create(db.IndexSpec(dim=D, degree=64,
                               spare_capacity=DEPLOY_UPSERT),
                  vec_np, prebuilt=graph)
    new = (vec_np[rng.integers(0, N, DEPLOY_UPSERT)]
           + 0.1 * rng.normal(size=(DEPLOY_UPSERT, D))).astype(np.float32)
    d.search(queries[:B], k=10, beam_width=16, max_iters=64)
    t0 = time.perf_counter()
    gids, paths["deployment_mutation_upsert"] = counted(lambda: d.upsert(new))
    out = dict(insert_s=time.perf_counter() - t0, inserted=int(gids.size))
    up = paths["deployment_mutation_upsert"]
    check(up["gather_distance"] > 0
          and sum(up.values()) == up["gather_distance"],
          f"deployment width: the insert searches launched {up}")
    t0 = time.perf_counter()
    _, paths["deployment_mutation_delete"] = counted(lambda: d.delete(dead))
    out.update(delete_s=time.perf_counter() - t0, deleted=int(dead.size))
    check(not any(paths["deployment_mutation_delete"].values()),
          "deployment width: delete launched a kernel")
    r, paths["deployment_mutation_search"] = counted(
        lambda: d.search(queries[:B], k=10, beam_width=16, max_iters=64))
    want = expected_launches("catapult", "unfused", [int(r.stats.hops.max())])
    check(paths["deployment_mutation_search"] == want,
          f"deployment width: the search after delete launched "
          f"{paths['deployment_mutation_search']}, its batch implies {want}")
    out["dead_returned"] = int(np.isin(r.ids, dead).sum())
    out["dead_in_buckets"] = int(np.isin(
        d.backend._cat.buckets.ids.cpu().numpy(), dead).sum())
    print(f"deployment mutations: {out}")
    check(out["dead_returned"] == 0 and out["dead_in_buckets"] == 0,
          f"deployment width: dead ids came back after delete: {out}")
    return out


def deploy_lsh_apg(vec_np, graph, queries, paths, ids):
    """1,000,000 x 768 ``mode='lsh_apg'``: the build hashes every row (one
    ``lsh_hash`` launch), then 4 batches of 4,096 under both backends;
    fused ids equal unfused ids."""
    from repro_torch import db
    out = {}
    for hb in ("unfused", "fused"):
        t0 = time.perf_counter()
        d, paths[f"lsh_apg_build_{hb}"] = counted(lambda hb=hb: db.create(
            db.IndexSpec(dim=D, degree=64, mode="lsh_apg", hop_backend=hb),
            vec_np, prebuilt=graph))
        build_s = time.perf_counter() - t0
        check(paths[f"lsh_apg_build_{hb}"] == dict(
                  expected_launches("diskann", hb, []), lsh_hash=1),
              f"deployment width: the lsh_apg build launched "
              f"{paths[f'lsh_apg_build_{hb}']}, not one lsh_hash")
        name = f"deployment_lsh_apg_{hb}"
        got, paths[name] = counted(lambda d=d: [
            d.search(queries[i * B: (i + 1) * B], k=10, beam_width=16,
                     max_iters=64) for i in range(4)])
        want = expected_launches("lsh_apg", hb,
                                 [int(r.stats.hops.max()) for r in got])
        check(paths[name] == want, f"{name}: launched {paths[name]}, its "
                                   f"batches imply {want}")
        ids[name] = np.concatenate([r.ids for r in got])
        filled = int((d.backend._apg.table >= 0).sum())
        out[hb] = dict(create_s=build_s, table_entries=filled,
                       mean_hops=float(np.mean([r.stats.hops.mean()
                                                for r in got])))
        del d
    check(np.array_equal(ids["deployment_lsh_apg_unfused"],
                         ids["deployment_lsh_apg_fused"]),
          "deployment width lsh_apg: fused and unfused ids differ")
    print(f"deployment lsh_apg: {out}")
    return out


def deploy_consolidate(vec, graph, queries, rng, paths):
    """``consolidate`` at 20,000 x 768 (the pq=96 slice and its graph)
    after deleting 256 random rows: no live row keeps an edge to a dead
    one, the dead rows lose theirs, and a batch returns no dead id."""
    from repro_torch import db
    print(f"reduced: consolidate runs at {vec.shape[0]:,} x {D} (the pq=96 "
          f"phase's slice), not at {N:,} rows: host RobustPrune over every "
          f"repaired row is beyond a smoke run there", flush=True)
    d = db.create(db.IndexSpec(dim=D, degree=32), vec, prebuilt=graph)
    dead = rng.choice(vec.shape[0], 256, replace=False)
    d.delete(dead)
    t0 = time.perf_counter()
    repaired, paths["deployment_consolidate"] = counted(d.consolidate)
    out = dict(rows=vec.shape[0], deleted=256, repaired_rows=repaired,
               consolidate_s=time.perf_counter() - t0)
    check(not any(paths["deployment_consolidate"].values()),
          "consolidate launched a kernel")
    adj = d.backend._adj_np
    r = d.search(queries[:256], k=10, beam_width=16, max_iters=64)
    out["dead_edges"] = int(np.isin(adj, dead).sum())
    out["dead_returned"] = int(np.isin(r.ids, dead).sum())
    print(f"deployment consolidate: {out}")
    check(repaired > 0 and out["dead_edges"] == 0
          and (adj[dead] == -1).all() and out["dead_returned"] == 0,
          f"consolidate left dead rows reachable: {out}")
    return out


def lm_lines(text: str) -> list:
    """The ``[serve] req i: ...`` lines of ``launch/serve``'s output."""
    return [ln for ln in text.splitlines() if ln.startswith("[serve] req ")]


def run_main(main, argv):
    """A launcher's ``main(argv)`` in this process (``python -m
    repro_torch.launch.serve`` / ``.train``), its standard output
    captured and echoed; returns (what ``main`` returns, the output)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    print(buf.getvalue(), end="", flush=True)
    return result, buf.getvalue()


def phase_serve(seed: int, dev) -> dict:
    """The LM serving path at gemma-2b's published config: ``launch/
    serve``'s ``ServingEngine`` path and its ``--rag`` path as a user runs
    them (launch counts set to 0 just before each, read just after: the
    LM launches no hand-written kernel, the retrieval's Vamana build and
    catapult search launch what ``build_spy`` and ``expected_launches``
    say), then the measurements on a model of the same config: decode
    step wall ms and device busy ms at the engine's batch, prefill ms,
    tokens/s through ``ServingEngine.run``, peak device memory."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.layers import padded_vocab
    from repro_torch.serving import rag
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_config(LM_ARCH)
    out = {"launches": {}}
    t0 = time.perf_counter()
    (_, text), made = counted(lambda: run_main(serve.main,
                                               ["--arch", LM_ARCH]))
    out["serve_s"] = time.perf_counter() - t0
    reqs = lm_lines(text)
    check(len(reqs) == 6, f"serve printed {len(reqs)} requests, not 6")
    for ln in reqs:
        toks = json.loads(ln.split(": ", 1)[1])
        check(1 <= len(toks) <= 9 and all(0 <= t < cfg.vocab_size
                                          for t in toks),
              f"serve: bad tokens {ln}")
    check(not any(made.values()), f"the LM path launched {made}")
    out["launches"]["serve_lm"] = made
    out["serve_tok_s"] = float(text.rsplit(" tokens, ", 1)[1].split()[0])

    hops = []
    real = rag.RagPipeline.retrieve

    def retrieve(self, *a, **kw):
        ids, st = real(self, *a, **kw)
        hops.append(int(st.hops.max()))
        return ids, st

    rag.RagPipeline.retrieve = retrieve
    try:
        t0 = time.perf_counter()
        with build_spy() as spy:
            (_, text), made = counted(lambda: run_main(
                serve.main, ["--arch", LM_ARCH, "--rag"]))
        out["rag_s"] = time.perf_counter() - t0
    finally:
        rag.RagPipeline.retrieve = real
    want = add_launches(spy.expected(), expected_launches(
        "catapult", "unfused", hops))
    check(made == want, f"RAG launches {made} against {want}")
    check(made["lsh_hash"] > 0 and made["gather_distance"] > 0,
          "the RAG path launched no lsh_hash or gather_distance")
    out["launches"]["serve_rag_build"] = spy.expected()
    out["launches"]["serve_rag_search"] = expected_launches(
        "catapult", "unfused", hops)
    for ln in lm_lines(text):
        docs = json.loads(ln.split("docs=")[1].split(" tokens=")[0])
        toks = json.loads(ln.split(" tokens=")[1])
        check(len(docs) == 2 and all(0 <= d < 256 for d in docs)
              and len(toks) == 8
              and all(0 <= t < cfg.vocab_size for t in toks),
              f"RAG: bad answer {ln}")
    check(len(lm_lines(text)) == 6, "RAG: not 6 answers")

    # measurements on a model of the same config and seed; device memory
    # counted above what the process held before (phase 1's tables)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = M.init(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    torch.cuda.synchronize()
    out["param_gb"] = sum(p.numel() * p.element_size()
                          for p in model.parameters()) / 1e9
    out["init_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, 6) for _ in range(6)]
    eng = ServingEngine(cfg, model, slots=2, max_len=6 + 8 + 2)
    t0 = time.perf_counter()
    done = eng.run([Request(prompt=p, max_new_tokens=8) for p in prompts])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    total = sum(len(r.out) for r in done)
    out.update(engine_tokens=total, engine_s=run_s,
               engine_tok_s=total / run_s)

    with torch.no_grad():
        cache = M.init_cache(cfg, 2, 6 + 8 + 2, dev)
        toks = torch.full((2, 1), 7, dtype=torch.int32, device=dev)

        def step(i=[0]):
            M.decode_step(cfg, model, toks, cache, 6 + i[0] % 8)
            i[0] += 1

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        walls = []
        for _ in range(LM_STEPS):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        busy, events = device_activity(step)
        wall = float(np.median(walls))
        out.update(decode_ms=wall, decode_ms_min=float(np.min(walls)),
                   decode_busy_ms=busy, decode_device_events=events,
                   decode_idle_share=1.0 - busy / wall if busy else None,
                   decode_tok_s=2 * 1e3 / wall)
        for name, shape in (("prefill", (2, 6)), ("prefill_rag", (6, 22))):
            batch = {"tokens": torch.as_tensor(
                rng.integers(2, cfg.vocab_size, shape), device=dev)}
            c = M.init_cache(cfg, shape[0], shape[1] + 8, dev)
            walls = []
            for _ in range(6):              # the first call warms up
                t0 = time.perf_counter()
                logits, _ = M.prefill(cfg, model, batch, c)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            out[f"{name}_ms"] = float(np.median(walls[1:]))
            out[f"{name}_busy_ms"] = device_busy_ms(
                lambda: M.prefill(cfg, model, batch, c))
            check(tuple(logits.shape)
                  == (shape[0], 1, padded_vocab(cfg.vocab_size))
                  and bool(torch.isfinite(logits.float()).all()),
                  f"{name}: logits {tuple(logits.shape)} not finite")
    out["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    del model, eng, cache
    torch.cuda.empty_cache()
    print(f"serve {LM_ARCH} (published config, {out['param_gb']:.2f} GB "
          f"of bf16 weights): launch/serve {out['serve_tok_s']:.1f} tok/s; "
          f"ServingEngine {total} tokens in {run_s:.2f} s "
          f"({out['engine_tok_s']:.1f} tok/s); decode step {wall:.2f} ms "
          f"(min {out['decode_ms_min']:.2f}) at batch 2, device busy "
          f"{busy:.3f} ms in {events} kernels/copies, idle share "
          f"{out['decode_idle_share']:.3f}; "
          f"prefill 2x6 {out['prefill_ms']:.2f} ms (busy "
          f"{out['prefill_busy_ms']:.3f}), 6x22 {out['prefill_rag_ms']:.2f} "
          f"ms (busy {out['prefill_rag_busy_ms']:.3f}); peak device memory "
          f"{out['init_peak_gb']:.2f} GB at init, {out['peak_gb']:.2f} GB "
          f"serving; RAG launches {made}", flush=True)
    return out


class StepTimer:
    """Wraps ``launch.train``'s ``make_train_step`` while in the ``with``:
    each step's wall ms (host clock between two device syncs), loss and
    grad norm (read after the step's own sync)."""

    def __enter__(self):
        from repro_torch.launch import train
        self.mod, self.real = train, train.make_train_step
        self.ms, self.loss, self.gnorm = [], [], []

        def make(*a, **kw):
            step = self.real(*a, **kw)

            def timed(model, opt_state, batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(model, opt_state, batch)
                torch.cuda.synchronize()
                self.ms.append((time.perf_counter() - t0) * 1e3)
                self.loss.append(float(out[2]["loss"]))
                self.gnorm.append(float(out[2]["grad_norm"]))
                return out
            return timed

        train.make_train_step = make
        return self

    def __exit__(self, *exc):
        self.mod.make_train_step = self.real
        return False


def train_lines(text: str) -> list:
    """The ``[train] step=...`` lines' step numbers, each line checked
    against the reference driver's format."""
    import re
    pat = re.compile(r"^\[train\] step=(\d+) loss=-?\d+\.\d{4} "
                     r"gnorm=\d+\.\d{3} t=\d+\.\d{3}s$")
    steps = []
    for ln in text.splitlines():
        if ln.startswith("[train] step="):
            m = pat.match(ln)
            check(m is not None, f"train printed {ln!r}")
            steps.append(int(m.group(1)))
    return steps


def phase_train(seed: int, dev) -> dict:
    """The training path at gemma-2b's published config, alone on the
    card: ``python -m repro_torch.launch.train --arch gemma-2b --steps
    20`` (the reference driver's defaults) with launch counts set to 0
    just before it and read just after (training launches no
    hand-written kernel), each step timed; then one more step under the
    profiler (device busy ms, idle share), tokens/s, ``train_mfu``
    against the roofline, peak device memory; then remat against no
    remat at published widths (``train_remat``) and the reference's two
    drills (``train_drills``)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import roofline, train
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import adamw

    cfg = get_config(LM_ARCH)
    out = {"launches": {}}
    print(f"reduced: no checkpoint at {LM_ARCH}'s full width (its state "
          f"is 25 GB; the reference driver's default is ckpt_dir=None); "
          f"the restart drill checkpoints reduced falcon-mamba-7b",
          flush=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with StepTimer() as timer:
        ((model, opt_state, losses), text), made = counted(
            lambda: run_main(train.main, ["--arch", LM_ARCH, "--steps",
                                          str(TRAIN_STEPS)]))
    out["train_s"] = time.perf_counter() - t0
    out["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    check(not any(made.values()), f"the training path launched {made}")
    out["launches"]["train"] = made
    check(train_lines(text) == [0, 10, TRAIN_STEPS - 1],
          f"train printed steps {train_lines(text)}")
    check(len(losses) == TRAIN_STEPS and losses == timer.loss
          and len(timer.gnorm) == TRAIN_STEPS,
          f"train ran {len(losses)} steps, timed {len(timer.ms)}")
    check(all(np.isfinite(losses)) and all(np.isfinite(timer.gnorm)),
          f"non-finite training: losses {losses}, gnorms {timer.gnorm}")
    timed = timer.ms[TRAIN_TIMED_FROM - 1:]
    step_ms = float(np.median(timed))

    pipe = TokenPipeline(cfg.vocab_size, TRAIN_S, TRAIN_B)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_at(TRAIN_STEPS).items()}
    step = make_train_step(cfg, adamw.AdamWConfig(total_steps=TRAIN_STEPS))
    busy, events = device_activity(lambda: step(model, opt_state, batch))
    split = step_split(cfg, model, opt_state, batch)
    flops = roofline.model_flops(cfg, "train", TRAIN_S, TRAIN_B)
    hbm = roofline.analytic_hbm_bytes(cfg, "train", TRAIN_S, TRAIN_B)
    out.update(
        params=roofline.count_params(cfg), losses=losses,
        grad_norms=timer.gnorm, step_ms_all=timer.ms, step_ms=step_ms,
        step_ms_min=float(np.min(timed)), busy_ms=busy,
        device_events=events,
        idle_share=1.0 - busy / step_ms if busy else None,
        tokens_s=TRAIN_B * TRAIN_S / (step_ms / 1e3),
        train_mfu=flops / (step_ms / 1e3 * PEAK_BF16_FLOPS),
        model_flops=flops, hbm_bytes=hbm,
        bound_bytes_ms=hbm / PEAK_BYTES_PER_S * 1e3,
        bound_flops_ms=flops / PEAK_BF16_FLOPS * 1e3, split=split)
    del model, opt_state, step, batch
    torch.cuda.empty_cache()
    print(f"train {LM_ARCH} (published config, {out['params'] / 1e9:.3f} B "
          f"params, batch {TRAIN_B} x {TRAIN_S}, {TRAIN_STEPS} steps in "
          f"{out['train_s']:.1f} s): step {step_ms:.2f} ms median over "
          f"steps {TRAIN_TIMED_FROM}-{TRAIN_STEPS} (min "
          f"{out['step_ms_min']:.2f}), device busy {busy:.3f} ms in "
          f"{events} kernels/copies, idle share {out['idle_share']:.3f}; "
          f"{out['tokens_s']:.1f} tokens/s; train_mfu "
          f"{out['train_mfu']:.4f} ({flops / 1e12:.3f} TFLOP a step, "
          f"{out['bound_flops_ms']:.2f} ms at 989 TFLOP/s); byte bound "
          f"{out['bound_bytes_ms']:.2f} ms ({hbm / 1e9:.2f} GB at 3.35 "
          f"TB/s); peak device memory {out['peak_gb']:.2f} GB; losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, grad norms "
          f"{min(timer.gnorm):.3f}-{max(timer.gnorm):.3f}; split: loss + "
          f"backward {split['grad_ms']:.2f} ms wall, {split['grad_busy_ms']:.3f}"
          f" busy in {split['grad_events']} events; adamw.update "
          f"{split['update_ms']:.2f} ms wall, {split['update_busy_ms']:.3f} "
          f"busy in {split['update_events']} events", flush=True)
    out["remat"] = train_remat(seed, dev)
    out["drills"] = train_drills(dev)
    out["launches"].update(out["drills"].pop("launches"))
    return out


def step_split(cfg, model, opt_state, batch) -> dict:
    """A training step's two halves apart: ``loss_fn`` with every
    gradient (remat on), then ``adamw.update`` with those gradients; the
    wall ms of each (host clock between device syncs, the second call)
    and its device busy ms and events (a third, profiled call)."""
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    params = dict(model.named_parameters())
    opt = adamw.AdamWConfig(total_steps=TRAIN_STEPS)

    def grads():
        loss = M.loss_fn(cfg, model, batch)
        return dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    g, grad_ms = timed(grads)
    grad_busy, grad_events = device_activity(grads)
    state = [opt_state]

    def update():
        state[0] = adamw.update(opt, g, state[0], params)[1]

    _, update_ms = timed(update)
    update_busy, update_events = device_activity(update)
    return dict(grad_ms=grad_ms, grad_busy_ms=grad_busy,
                grad_events=grad_events, update_ms=update_ms,
                update_busy_ms=update_busy, update_events=update_events)


def train_remat(seed: int, dev) -> dict:
    """One loss and every gradient of gemma-2b at published widths (2
    layers, bf16) on REMAT_B x REMAT_S tokens, with remat and without:
    the gradients within REMAT_TOL of each other, the peak device memory
    (above what was allocated before the pass) lower with remat."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    full = get_config(LM_ARCH)
    cfg = dataclasses.replace(full, n_layers=REMAT_LAYERS)
    print(f"reduced: remat check {LM_ARCH} n_layers {full.n_layers} -> "
          f"{REMAT_LAYERS} (published widths, bf16), batch {REMAT_B} x "
          f"{REMAT_S}", flush=True)
    model = M.init(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (REMAT_B, REMAT_S)), device=dev)}
    params = list(model.parameters())
    res = {}
    for remat in (True, False):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = M.loss_fn(cfg, model, batch, remat=remat)
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        res[remat] = dict(ms=(time.perf_counter() - t0) * 1e3,
                          loss=float(loss.detach()), grads=grads,
                          peak_gb=(torch.cuda.max_memory_allocated()
                                   - base) / 1e9)
    shares = [float((a.float() - b.float()).abs().max()
                    / b.float().abs().max().clamp(min=1e-30))
              for a, b in zip(res[True]["grads"], res[False]["grads"])]
    finite = all(bool(torch.isfinite(g).all()) for g in res[True]["grads"])
    out = {"loss": res[True]["loss"], "loss_plain": res[False]["loss"],
           "grad_share_max": max(shares),
           "leaves_bit_equal": sum(torch.equal(a, b) for a, b in
                                   zip(res[True]["grads"],
                                       res[False]["grads"])),
           "leaves": len(shares),
           "peak_gb": res[True]["peak_gb"],
           "peak_gb_plain": res[False]["peak_gb"],
           "ms": res[True]["ms"], "ms_plain": res[False]["ms"]}
    del model, params, res, grads, loss
    torch.cuda.empty_cache()
    print(f"remat ({LM_ARCH}, {REMAT_LAYERS} layers, {REMAT_B} x "
          f"{REMAT_S}): peak {out['peak_gb']:.2f} GB with remat, "
          f"{out['peak_gb_plain']:.2f} GB without; gradients within "
          f"{out['grad_share_max']:.3g} of each leaf's largest (<= "
          f"{REMAT_TOL}), {out['leaves_bit_equal']} of {out['leaves']} "
          f"leaves bit-equal; loss {out['loss']:.6f} / "
          f"{out['loss_plain']:.6f}; loss + backward {out['ms']:.1f} / "
          f"{out['ms_plain']:.1f} ms", flush=True)
    check(finite and np.isfinite(out["loss"]), "remat: non-finite gradients")
    check(out["grad_share_max"] <= REMAT_TOL,
          f"remat changed the gradients by {out['grad_share_max']:.3g}")
    check(out["peak_gb"] < out["peak_gb_plain"],
          f"remat did not lower peak memory: {out['peak_gb']:.2f} against "
          f"{out['peak_gb_plain']:.2f} GB")
    return out


def train_drills(dev) -> dict:
    """The reference's two training drills on the card, at its test
    settings: the loss falls on reduced gemma-2b (60 steps of 8 x 32,
    lr 3e-3, warmup 5); reduced falcon-mamba-7b trains 8 steps with a
    checkpoint every 4, resumes to 12, and matches 12 straight steps
    within rtol 1e-5.  ``CUBLAS_WORKSPACE_CONFIG`` is left unset: set
    for the whole process it made gemma-2b's decode step half again as
    slow on an H100 (``kernel_times.py --decode``); on one stream cuBLAS
    repeats its results, which the drill's equality checks."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch import train
    from repro_torch.optim import adamw

    def quiet(*a):
        pass

    out = {"launches": {}}
    print("reduced: the drills run get_reduced(gemma-2b) and "
          "get_reduced(falcon-mamba-7b), as the reference's own tests "
          "(tests/test_train_loop.py)", flush=True)
    t0 = time.perf_counter()
    (_, _, losses), made = counted(lambda: train.train(
        get_reduced(LM_ARCH), opt_cfg=adamw.AdamWConfig(
            lr=3e-3, warmup=5, total_steps=DRILL_FALL["steps"]),
        device=dev, log=quiet, **DRILL_FALL))
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    out.update(fall_first=first, fall_last=last,
               fall_s=time.perf_counter() - t0)
    out["launches"]["train_drill_fall"] = made
    check(not any(made.values()), f"the loss drill launched {made}")
    check(last < first - 0.1, f"the loss did not fall: {first} -> {last}")

    cfg = get_reduced("falcon-mamba-7b")
    kw = dict(opt_cfg=adamw.AdamWConfig(total_steps=12, warmup=2),
              device=dev, log=quiet, **DRILL_RESTART)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        def drill():
            train.train(cfg, steps=8, ckpt_dir=tmp, ckpt_every=4, **kw)
            resumed = train.train(cfg, steps=12, ckpt_dir=tmp, resume=True,
                                  **kw)[2]
            return resumed, train.train(cfg, steps=12, **kw)[2]
        (resumed, full), made = counted(drill)
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, full[8:]))
    out.update(restart_rel=rel, restart_s=time.perf_counter() - t0,
               resumed=resumed, full=full[8:])
    out["launches"]["train_drill_restart"] = made
    print(f"drills: loss {first:.4f} -> {last:.4f} (mean of the first and "
          f"last 10 of 60 steps, {out['fall_s']:.1f} s); restart resumed "
          f"steps 8-11 within {rel:.3g} of a straight run (rtol 1e-5, "
          f"{out['restart_s']:.1f} s)", flush=True)
    check(not any(made.values()), f"the restart drill launched {made}")
    check(len(resumed) == 4 and rel <= 1e-5,
          f"the resumed losses {resumed} part from {full[8:]} by {rel:.3g}")
    return out


def copy_model(src, cfg, device):
    """A ``Model`` of ``cfg`` on ``device`` with ``src``'s weights (cast
    to ``cfg.dtype``; bf16 to f32 is exact)."""
    from repro_torch.models import model as M
    dst = M.Model(cfg, device)
    with torch.no_grad():
        for d, s_ in zip(dst.parameters(), src.parameters()):
            d.copy_(s_)
    return dst


def lm_inputs(cfg, seed: int = 0):
    """A prefill batch of LM_B x LM_S tokens (vlm: patches, encdec:
    frames) and LM_DECODE teacher-forced tokens, from a numpy seed."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (LM_B, LM_S))}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (LM_B, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(
            np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (LM_B, LM_S, cfg.frontend_dim)).astype(np.float32)
    toks = [rng.integers(0, cfg.vocab_size, (LM_B, 1))
            for _ in range(LM_DECODE)]
    return batch, toks


def lm_logits(cfg, model, batch, toks) -> list:
    """Prefill logits, then each teacher-forced decode step's, as f32
    numpy on the host, over the real vocab (the padded columns hold
    -1e9)."""
    from repro_torch.models import model as M
    dev = model.device
    prefix = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    with torch.no_grad():
        cache = M.init_cache(cfg, LM_B, LM_S + prefix + LM_DECODE, dev)
        logits, cache = M.prefill(cfg, model, {
            k: torch.as_tensor(v, device=dev) for k, v in batch.items()},
            cache)
        outs = [logits]
        for i, t in enumerate(toks):
            logits, cache = M.decode_step(
                cfg, model, torch.as_tensor(t, device=dev), cache,
                LM_S + prefix + i)
            outs.append(logits)
    return [o[..., :cfg.vocab_size].float().cpu().numpy() for o in outs]


def share(got, want) -> float:
    """max |got - want| as a share of max |want|."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def lm_twin(arch: str, cut: dict, seed: int, dev) -> dict:
    """One arch at its published widths and ``cut`` depth: a bf16 model
    drawn on the card, its f32 upcast on the card, and CPU twins of both
    (the same weights).  Prefill and every decode step: the f32 card
    logits within LM_TOL32 of the f32 CPU's, the bf16 card logits within
    the bf16 rule of the f32 CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    full = get_config(arch)
    cfg16 = dataclasses.replace(full, **cut)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    print("reduced: " + arch + " " + ", ".join(
        f"{k} {getattr(full, k)} -> {v}" for k, v in cut.items())
        + " (published widths)", flush=True)
    batch, toks = lm_inputs(cfg16, seed)
    t0 = time.perf_counter()
    card16 = M.init(cfg16, torch.Generator(device=dev).manual_seed(seed),
                    dev)
    res = {"params": sum(p.numel() for p in card16.parameters())}
    res["card16"] = lm_logits(cfg16, card16, batch, toks)
    res["cpu16"] = lm_logits(cfg16, copy_model(card16, cfg16, "cpu"),
                             batch, toks)
    cpu32 = copy_model(card16, cfg32, "cpu")
    res["cpu32"] = lm_logits(cfg32, cpu32, batch, toks)
    card32 = copy_model(card16, cfg32, dev)
    del card16
    res["card32"] = lm_logits(cfg32, card32, batch, toks)
    grads = lm_grads(cfg32, card32, cpu32, batch)
    del card32, cpu32
    torch.cuda.empty_cache()
    agree = dict(prefill=[], decode=[])
    out = {"params": res["params"], "err32": [], "err16": [],
           "err16_cpu": []}
    for i, want in enumerate(res["cpu32"]):
        check(np.isfinite(res["card16"][i]).all()
              and np.isfinite(res["card32"][i]).all(),
              f"{arch}: non-finite logits")
        check(res["card16"][i].shape == want.shape
              == (LM_B, 1, cfg16.vocab_size),
              f"{arch}: logits shaped {res['card16'][i].shape}")
        e32 = share(res["card32"][i], want)
        e16 = share(res["card16"][i], want)
        own = share(res["cpu16"][i], want)
        out["err32"].append(e32)
        out["err16"].append(e16)
        out["err16_cpu"].append(own)
        check(e32 <= LM_TOL32, f"{arch} step {i}: f32 card vs CPU {e32:.3g}"
                               f" > {LM_TOL32}")
        check(e16 <= LM_BF16_FACTOR * own + LM_BF16_FLOOR,
              f"{arch} step {i}: bf16 card {e16:.3g} against the CPU's "
              f"own bf16 {own:.3g}")
        agree["prefill" if i == 0 else "decode"].append(
            float((res["card16"][i].argmax(-1) == want.argmax(-1)).mean()))
    out["argmax_agree_bf16"] = agree
    out["grads"] = grads
    out["seconds"] = time.perf_counter() - t0
    print(f"{arch} twin ({res['params'] / 1e9:.2f} B params): f32 card vs "
          f"CPU max share {max(out['err32']):.3g} (<= {LM_TOL32}); bf16 "
          f"card {max(out['err16']):.3g} against the CPU's own bf16 "
          f"{max(out['err16_cpu']):.3g} (prefill, 4 decode steps); "
          f"loss_fn {grads['loss_card']:.6f} / {grads['loss_cpu']:.6f}, "
          f"gradients within {grads['grad_share_max']:.3g} of each "
          f"leaf's largest ({grads['worst']}; <= {LM_GRAD_TOL}, or "
          f"against float64 card / CPU "
          f"{max((e for e in grads.get('over_f64', {}).values()), default='-')}"
          f" on {len(grads.get('over_f64', {}))} leaves); "
          f"{out['seconds']:.1f} s", flush=True)
    return out


def named_grads(cfg, model, batch) -> tuple:
    """(loss_fn, {name: gradient}) of ``model`` on ``batch`` (numpy),
    through autograd with the training path's remat."""
    from repro_torch.models import model as M
    params = dict(model.named_parameters())
    loss = M.loss_fn(cfg, model, {
        k: torch.as_tensor(v, device=model.device) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def lm_grads(cfg, card, cpu, batch) -> dict:
    """One ``loss_fn`` and every gradient (f32) of the card model against
    its CPU twin, on the batch's first LM_GRAD_ROWS rows: the loss within
    LM_LOSS_RTOL, each leaf within
    LM_GRAD_TOL of its largest |g|.  At published widths the reference's
    init (fan-in = depth) can leave a leaf's f32 gradient mostly rounding
    error (falcon-mamba's first layer parts from a float64 run by ~0.7 of
    its largest on the CPU): a leaf beyond LM_GRAD_TOL is held instead to
    twice the CPU twin's own f32 error against a float64 run of the CPU
    twin, plus LM_GRAD_TOL (the rule the bf16 logits follow).  ``cpu`` is
    cast to float64 then."""
    batch = {k: v[:LM_GRAD_ROWS] for k, v in batch.items()}
    loss_card, g_card = named_grads(cfg, card, batch)
    loss_cpu, g_cpu = named_grads(cfg, cpu, batch)
    g_card = {name: g.cpu() for name, g in g_card.items()}
    shares = {name: share(g.numpy(), g_cpu[name].numpy())
              for name, g in g_card.items()}
    worst = max(shares, key=shares.get)
    out = {"loss_card": loss_card, "loss_cpu": loss_cpu,
           "grad_share_max": shares[worst], "worst": worst,
           "leaves": len(shares)}
    check(np.isfinite(loss_card) and all(
        bool(torch.isfinite(g).all()) for g in g_card.values()),
        f"{cfg.name}: non-finite loss or gradients on the card")
    check(abs(loss_card - loss_cpu) <= LM_LOSS_RTOL * abs(loss_cpu),
          f"{cfg.name}: loss_fn {loss_card} on the card, {loss_cpu} on the "
          f"CPU")
    over = sorted(name for name, v in shares.items() if v > LM_GRAD_TOL)
    if over:
        _, g64 = named_grads(cfg, cpu.double(), {
            k: v.astype(np.float64) if v.dtype.kind == "f" else v
            for k, v in batch.items()})
        f64 = {}
        for name in over:
            want = g64[name].numpy()
            f64[name] = (share(g_card[name].double().numpy(), want),
                         share(g_cpu[name].double().numpy(), want))
        out["over_f64"] = f64
        bad = {n: e for n, e in f64.items()
               if e[0] > 2 * e[1] + LM_GRAD_TOL}
        check(not bad, f"{cfg.name}: gradients part from a float64 run "
                       f"by more than twice the CPU's own f32 error: {bad}")
    return out


def train_twin(seed: int, dev) -> dict:
    """gemma-2b at published widths, cut to 2 layers, f32: one draw on the
    card, its copy on the CPU, TWIN_TRAIN_STEPS steps of ``make_train_step``
    on each from one AdamW state and one pipeline: the losses, grad norms
    and final parameters agree (TWIN_* tolerances)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import adamw
    full = get_config(LM_ARCH)
    cfg = dataclasses.replace(full, **TWIN_TRAIN)
    print(f"reduced: training twin {LM_ARCH} n_layers {full.n_layers} -> "
          f"{cfg.n_layers}, dtype {full.dtype} -> {cfg.dtype} (published "
          f"widths), {TWIN_TRAIN_STEPS} steps of {TWIN_TRAIN_B} x "
          f"{TWIN_TRAIN_S}", flush=True)
    t0 = time.perf_counter()
    opt = adamw.AdamWConfig(lr=1e-3, warmup=1, total_steps=TWIN_TRAIN_STEPS)
    card = M.init(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    cpu = copy_model(card, cfg, "cpu")
    start = {n: p.detach().cpu().numpy().copy()
             for n, p in card.named_parameters()}
    pipe = TokenPipeline(cfg.vocab_size, TWIN_TRAIN_S, TWIN_TRAIN_B)
    step = make_train_step(cfg, opt)
    runs = {}
    for side, model in (("card", card), ("cpu", cpu)):
        state = adamw.init(dict(model.named_parameters()))
        losses, gnorms = [], []
        for i in range(TWIN_TRAIN_STEPS):
            batch = {k: torch.from_numpy(v).to(model.device)
                     for k, v in pipe.batch_at(i).items()}
            model, state, m = step(model, state, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        runs[side] = dict(losses=losses, gnorms=gnorms)
        del state
    lr_sum = sum(adamw.schedule(opt, s)
                 for s in range(1, TWIN_TRAIN_STEPS + 1))
    worst = apart = total = moved = 0.0
    for (name, p), q in zip(card.named_parameters(), cpu.parameters()):
        diff = (p.detach().cpu() - q.detach()).abs()
        worst = max(worst, float(diff.max()) / lr_sum)
        apart += int((diff > 1e-3 * lr_sum).sum())
        total += diff.numel()
        moved = max(moved, float(np.abs(q.detach().numpy()
                                        - start[name]).max()) / lr_sum)
    del card, cpu
    torch.cuda.empty_cache()
    out = dict(runs, param_worst=worst, param_apart_share=apart / total,
               cpu_moved=moved, lr_sum=lr_sum,
               seconds=time.perf_counter() - t0)
    print(f"training twin: losses card {runs['card']['losses']} / CPU "
          f"{runs['cpu']['losses']}; grad norms {runs['card']['gnorms']} / "
          f"{runs['cpu']['gnorms']} (rtol {TWIN_GNORM_RTOL} at the first "
          f"step, {TWIN_GNORM_LATER_RTOL} after); parameters apart by at most "
          f"{worst:.3g} of the summed lr (<= {TWIN_PARAM_TOL}), "
          f"{out['param_apart_share']:.4%} of them beyond 1e-3 of it (<= "
          f"{TWIN_PARAM_SHARE:.0%}); the largest move {moved:.3g} of it; "
          f"{out['seconds']:.1f} s", flush=True)
    for a, b in zip(runs["card"]["losses"] + runs["card"]["gnorms"],
                    runs["cpu"]["losses"] + runs["cpu"]["gnorms"]):
        check(np.isfinite(a), f"training twin: non-finite {a}")
    check(np.allclose(runs["card"]["losses"], runs["cpu"]["losses"],
                      rtol=TWIN_LOSS_RTOL, atol=0),
          "training twin: the losses part")
    gn_card, gn_cpu = runs["card"]["gnorms"], runs["cpu"]["gnorms"]
    check(np.allclose(gn_card[:1], gn_cpu[:1], rtol=TWIN_GNORM_RTOL, atol=0)
          and np.allclose(gn_card[1:], gn_cpu[1:],
                          rtol=TWIN_GNORM_LATER_RTOL, atol=0),
          f"training twin: the grad norms part: {gn_card} / {gn_cpu}")
    check(worst <= TWIN_PARAM_TOL
          and out["param_apart_share"] <= TWIN_PARAM_SHARE,
          "training twin: the parameters part")
    return out


def phase_lm_twins(seed: int, dev) -> dict:
    """The fourth card process: every LM_TWINS arch against its CPU twin
    (logits, then ``loss_fn`` and every gradient), then the training twin
    (the LM launches no hand-written kernel: counts must stay 0)."""
    torch.set_num_threads(LM_THREADS)
    print("reduced: arctic-480b left out on the card (one MoE layer alone "
          "holds over 13 B parameters); its dense residual is held by the "
          "CPU parity tests", flush=True)
    print(f"reduced: each twin's loss_fn and gradients on {LM_GRAD_ROWS} of "
          f"its {LM_B} rows (the CPU twins' backward runs beside phases "
          f"2-5)", flush=True)
    t0 = time.perf_counter()
    archs, made = counted(lambda: {
        arch: lm_twin(arch, cut, seed, dev) for arch, cut in LM_TWINS})
    check(not any(made.values()), f"the LM twins launched {made}")
    trained, made_train = counted(lambda: train_twin(seed, dev))
    check(not any(made_train.values()),
          f"the training twin launched {made_train}")
    out = {"lm_twins": {"archs": archs, "train_twin": trained,
                        "launches": {"lm_twins": made,
                                     "train_twin": made_train},
                        "seconds": time.perf_counter() - t0}}
    print(f"phase lm twins: {out['lm_twins']['seconds']:.1f} s", flush=True)
    return out


def build_shift_graph(path: str) -> None:
    """The adapt phase's graph: ``build_vamana`` of
    ``make_shifted_zipf(kind="sudden")``'s corpus with ``IndexSpec()``'s
    build parameters, on the CPU (two threads), saved to ``path``."""
    torch.set_num_threads(2)
    from repro_torch import db
    from repro_torch.core.vamana import build_vamana
    from repro_torch.data import make_shifted_zipf
    t0 = time.perf_counter()
    adj, med = build_vamana(make_shifted_zipf(kind="sudden").corpus,
                            db.IndexSpec().vamana(), device="cpu")
    np.savez(path, adjacency=adj, medoid=med,
             seconds=time.perf_counter() - t0)


class ShiftGraph:
    """The adapt phase's Vamana build in a second process on the CPU,
    started before phase 1 so that it overlaps the card phases (its host
    RobustPrune takes minutes; run alone it would add them to the run).
    ``result()`` waits for it; leaving the ``with`` stops it."""

    def __init__(self, path: Path):
        self.path = path

    def __enter__(self):
        env = dict(os.environ, OMP_NUM_THREADS="2")
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--shift-graph",
             str(self.path)], env=env)
        return self

    def result(self):
        t0 = time.perf_counter()
        rc = self.proc.wait()
        check(rc == 0, f"the shift corpus's graph build exited {rc}")
        with np.load(self.path) as f:
            print(f"adapt shift graph: built on the CPU in "
                  f"{float(f['seconds']):.1f} s beside the card phases; "
                  f"waited {time.perf_counter() - t0:.1f} s for it",
                  flush=True)
            return f["adjacency"], int(f["medoid"])

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        return False


def moe_repeat(dev, card: str) -> dict:
    """deepseek-moe-16b at its published widths cut to DRY_MOE's depth:
    the loss and every gradient of one batch, twice, with deterministic
    algorithms off, must be bit-equal (the MoE combine adds each token's
    slots in a fixed order)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.models.steps import loss_and_grads
    arch, cut = DRY_MOE
    cfg = dataclasses.replace(get_config(arch), **cut)
    print(f"reduced: MoE repeat {arch} n_layers {get_config(arch).n_layers} "
          f"-> {cut['n_layers']} (published widths)", flush=True)
    check(not torch.are_deterministic_algorithms_enabled(),
          "deterministic algorithms are on")
    model = M.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in TokenPipeline(
        cfg.vocab_size, TRAIN_S, TRAIN_B).batch_at(0).items()}

    def run():
        loss, grads = loss_and_grads(cfg, model, batch)
        return loss.detach(), grads
    (loss_a, grads_a), made_a = counted(run)
    (loss_b, grads_b), made_b = counted(run)
    parted = sorted(n for n in grads_a
                    if not torch.equal(grads_a[n], grads_b[n]))
    print(f"MoE repeat {arch} ({cut}, batch {TRAIN_B} x {TRAIN_S}) on "
          f"{card}: losses {float(loss_a)!r} and {float(loss_b)!r}; "
          f"{len(grads_a) - len(parted)} of {len(grads_a)} gradients "
          f"bit-equal", flush=True)
    check(torch.equal(loss_a, loss_b) and not parted,
          f"the MoE step did not repeat itself: losses {float(loss_a)!r} "
          f"{float(loss_b)!r}, gradients parted {parted[:8]}")
    check(not any(made_a.values()) and not any(made_b.values()),
          f"the MoE step launched {made_a} {made_b}")
    del model, grads_a, grads_b
    torch.cuda.empty_cache()
    return {"losses": [float(loss_a), float(loss_b)], "launches": made_a}


def serve_world_of_one(dev, card: str) -> dict:
    """gemma2-27b at its published widths cut to DRY_SERVE's depth: a
    prefill and DRY_SERVE_DECODE decode steps on one device, then on an
    NCCL world of one rank under a (1, 1) mesh (the serve steps'
    ``groups``, the cache the rank's block): every step's logits and the
    cache bit-equal."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as tm
    from repro_torch.launch.train import RankPlan
    from repro_torch.models import model as M
    from repro_torch.models import parallel as par
    from repro_torch.models.steps import make_decode_step, make_prefill_step
    arch, cut = DRY_SERVE
    cfg = dataclasses.replace(get_config(arch), **cut)
    print(f"reduced: serve across ranks {arch} n_layers "
          f"{get_config(arch).n_layers} -> {cut['n_layers']} (published "
          f"widths), batch {DRY_SERVE_B} x {DRY_SERVE_S} + "
          f"{DRY_SERVE_DECODE} decode steps", flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = {"tokens": torch.randint(0, cfg.vocab_size,
                                      (DRY_SERVE_B, DRY_SERVE_S),
                                      generator=gen, device=dev,
                                      dtype=torch.int32)}
    toks = torch.randint(0, cfg.vocab_size,
                         (DRY_SERVE_DECODE, DRY_SERVE_B, 1), generator=gen,
                         device=dev, dtype=torch.int32)
    max_len = DRY_SERVE_S + DRY_SERVE_DECODE

    def serve(model, cache, groups):
        pre = make_prefill_step(cfg, groups=groups)
        dec = make_decode_step(cfg, groups=groups)
        logits, cache = pre(model, prompt, cache)
        out = [logits.clone()]
        for i, t in enumerate(toks):
            logits, cache = dec(model, t, cache, DRY_SERVE_S + i)
            out.append(logits.clone())
        torch.cuda.synchronize()
        return out, cache

    model = M.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    t0 = time.perf_counter()
    (one, one_cache), made_one = counted(lambda: serve(
        model, M.init_cache(cfg, DRY_SERVE_B, max_len, dev), None))
    one_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        tm.init_world(dev.type, init_method=f"file://{tmp}/store", rank=0,
                      world_size=1)
        try:
            mesh = tm.make_local_mesh(1, 1, dev.type)
            plan = RankPlan(cfg, mesh)
            plan.shard(model)
            par.COUNTS.clear()
            bytes_before = dict(par.BYTES)
            t0 = time.perf_counter()
            (ranked, cache), made = counted(lambda: serve(
                model, M.init_cache(cfg, DRY_SERVE_B, max_len, dev,
                                    mesh=mesh), plan.groups))
            ranked_s = time.perf_counter() - t0
            counts = dict(par.COUNTS)
            moved = {k: v - bytes_before.get(k, 0)
                     for k, v in par.BYTES.items()}
        finally:
            dist.destroy_process_group()
    equal = [torch.equal(a, b) for a, b in zip(ranked, one)]
    cache_equal = all(torch.equal(cache[k], one_cache[k]) for k in one_cache)
    print(f"serve across ranks {arch} ({cut}) on {card}: "
          f"{'NCCL' if dev.type == 'cuda' else 'gloo'} world of one, "
          f"(1, 1) mesh: logits bit-equal at {sum(equal)} of {len(equal)} "
          f"steps, cache bit-equal {cache_equal}; {ranked_s:.2f} s against "
          f"one device's {one_s:.2f} s; collectives {counts}, bytes "
          f"{moved}", flush=True)
    check(all(equal) and cache_equal,
          f"serve across ranks {arch}: the world of one parted from one "
          f"device (steps {equal}, cache {cache_equal})")
    check(not any(made.values()) and not any(made_one.values()),
          f"serve across ranks launched {made} {made_one}")
    del model, one, ranked, cache, one_cache
    torch.cuda.empty_cache()
    return {"steps_equal": equal, "cache_equal": cache_equal,
            "seconds": ranked_s, "one_device_seconds": one_s,
            "collectives": counts, "collective_bytes": moved,
            "launches": made}


def dry_cell_line(res: dict, card: str) -> str:
    """One printed line a dry-run cell."""
    cut = f" ({res['n_layers']} layers)" if "n_layers" in res else ""
    head = (f"dryrun {res['arch']}{cut} x {res['shape']} x {res['mesh']} "
            f"on {card}")
    if res["status"] != "ok":
        return f"{head}: {res['status']} ({res.get('reason', '')})"
    rf, mem = res["roofline"], res["memory"]
    return (f"{head}: ok, {rf['chips']} ranks, flops {rf['flops']!r} "
            f"(model {rf['model_flops']!r}), coll_bytes {rf['coll_bytes']!r} "
            f"{ {k: v for k, v in rf['coll_breakdown'].items() if v} }, "
            f"peak {mem['peak_bytes_per_chip'] / 1e9:.3f} GB a rank, fits "
            f"{mem['fits_hbm']}, dominant {rf['dominant']}, "
            f"{res['compile_s']} s")


def check_dry_cell(res: dict, card: str) -> None:
    """Print one dry-run cell's line and hold it to its expected status:
    ``refused`` for DRY_REFUSED, else ``ok`` with FLOPs and collective
    bytes above 0 on 256 or 512 ranks."""
    print(dry_cell_line(res, card), flush=True)
    tag = f"{res['arch']} x {res['shape']} x {res['mesh']}"
    want = "refused" if res["arch"] in DRY_REFUSED else "ok"
    check(res["status"] == want,
          f"dryrun {tag}: {res['status']}, expected {want}")
    if want == "ok":
        rf = res["roofline"]
        check(rf["flops"] > 0 and rf["coll_bytes"] > 0 and res["chips"]
              == (512 if res["mesh"] == "multi_pod" else 256),
              f"dryrun {tag}: {rf}")


def phase_dryrun(seed: int, dev, card: str = "") -> dict:
    """The fifth card process: ``moe_repeat``, ``serve_world_of_one``,
    then the dry run's search cell on both production meshes, here on the
    card (its 1,000,000 x 768 shard), its kernel launches held to
    ``expected_launches`` through ``spy_lookups``.  (The fake cells run
    in ``DryCells``.)  ``seed`` is unused: every draw is seeded in the
    functions."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    out = {"moe_repeat": moe_repeat(dev, card),
           "serve": serve_world_of_one(dev, card), "cells": {}}
    launches = {"dryrun_moe_repeat": out["moe_repeat"]["launches"],
                "dryrun_serve": out["serve"]["launches"]}
    for multi in (False, True):
        (res, iters), made = counted(lambda: spy_lookups(
            lambda: dryrun.run_cell("catapultdb", "search", multi, dev)))
        want = expected_launches("catapult", "unfused", iters)
        check(made == want, f"dryrun search ({res['mesh']}) launched "
              f"{made}, expected {want}")
        launches[f"dryrun_search_{res['mesh']}"] = made
        res["launches"] = made
        check_dry_cell(res, card)
        out["cells"][f"catapultdb__search__{'mp' if multi else 'sp'}"] = res
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    print(f"phase dryrun: {out['seconds']:.1f} s", flush=True)
    return {"dryrun": out}


class DryCells:
    """The dry run's fake cells (DRY_CELLS but the search, on both
    production meshes), each ``python -m repro_torch.launch.dryrun
    --device cuda`` in a process of its own at the lowest CPU priority,
    DRY_JOBS at once, started before phase 1: host work on fake tensors
    (gemma2-27b's train_4k minutes of it) that launches nothing on the
    card, on cores the main process leaves idle.  ``result()`` waits for
    them and checks each (``check_dry_cell``); leaving the ``with`` stops
    any still running."""

    def __init__(self, tmp: Path, dev):
        self.tmp, self.dev, self.procs = tmp, dev, []
        self.cells = [(arch, shape, multi) for arch, shape in DRY_CELLS
                      if arch != "catapultdb" for multi in (False, True)]

    def __enter__(self):
        self.pool = ThreadPoolExecutor(DRY_JOBS)
        return self

    def start(self) -> None:
        from repro_torch.configs import get_config
        for (arch, shape), n in DRY_LAYERS.items():
            print(f"reduced: dryrun {arch} x {shape} n_layers "
                  f"{get_config(arch).n_layers} -> {n} (published widths, "
                  f"fake tensors)", flush=True)
        self.t0 = time.perf_counter()
        self.runs = [self.pool.submit(self._run, *c) for c in self.cells]

    def _run(self, arch, shape, multi):
        tag = f"{arch}__{shape}__{'mp' if multi else 'sp'}"
        dest = self.tmp / f"{tag}.json"
        layers = DRY_LAYERS.get((arch, shape))
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--device", self.dev.type, "--out",
             str(dest)] + (["--multi-pod"] if multi else [])
            + ([] if layers is None else ["--layers", str(layers)]),
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, preexec_fn=lambda: os.nice(19))
        self.procs.append(proc)
        _, err = proc.communicate()
        return tag, proc.returncode, err, dest

    def result(self, card: str) -> dict:
        t0 = time.perf_counter()
        out = {}
        for run in self.runs:
            tag, rc, err, dest = run.result()
            check(rc == 0, f"dryrun {tag} exited {rc}: {err[-2000:]}")
            out[tag] = json.loads(dest.read_text())
            check_dry_cell(out[tag], card)
        print(f"dryrun fake cells: {time.perf_counter() - self.t0:.1f} s "
              f"since their start; waited {time.perf_counter() - t0:.1f} s",
              flush=True)
        return out

    def __exit__(self, *exc):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
        self.pool.shutdown(wait=True, cancel_futures=True)
        return False


class TierPhases:
    """A second process on the card, started after phase 1 (so no kernel
    timing overlaps it) beside phases 2 to 5: ``--tiers`` runs the
    sharded, mesh and tiered phases at bench size and the sharded tier at
    1M x 768 (``tier_process``; its sharded and tiered builds are minutes
    of host RobustPrune, its 1M shard searches minutes of host fetch),
    and ``--ingest`` (a third process) this slice's ingest and baseline
    phases (``phase_ingest_all``; every cutover, growth and consolidate
    is a Vamana rebuild, host RobustPrune again), and ``--models`` (a
    fourth) the LM twins (``phase_lm_twins``; CPU twins at published
    widths), and ``--dryrun`` (a fifth) the production mesh's dry run
    (``phase_dryrun``; host work on fake tensors); run in turn they
    would push the run past its time limit.  Each one's launch counts come
    back in its JSON.  ``result()`` waits for it, prints its log and
    reads the JSON; leaving the ``with`` stops it."""

    def __init__(self, path: Path, flag: str = "--tiers"):
        self.path, self.flag, self.proc, self.log = path, flag, None, None

    def __enter__(self):
        return self

    def start(self) -> None:
        self.log = open(self.path.with_suffix(".log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), self.flag,
             str(self.path)], stdout=self.log, stderr=subprocess.STDOUT)

    def result(self) -> dict:
        t0 = time.perf_counter()
        rc = self.proc.wait()
        self.log.close()
        print(self.path.with_suffix(".log").read_text(), end="", flush=True)
        print(f"{self.flag[2:]} phases: waited "
              f"{time.perf_counter() - t0:.1f} s for their process",
              flush=True)
        check(rc == 0, f"the {self.flag[2:]} phases' process exited {rc}")
        return json.loads(self.path.read_text())

    def __exit__(self, *exc):
        if self.proc is not None:
            if self.proc.poll() is None:
                self.proc.kill()
            self.proc.wait()
            self.log.close()
        return False


def dist_train(mesh, dev, card: str, train_ref: dict | None) -> dict:
    """Training across ranks on the world of one: gemma-2b at its
    published config (batch 4 x 64, the reference driver's defaults)
    through ``launch.train.train`` on ``mesh`` (the (1, 1) mesh: every
    collective of ``models.parallel`` runs, over NCCL) and through the
    one-device ``train`` (``mesh`` of plain sizes 1) from the same seed-0
    init, DIST_TRAIN_STEPS steps each, one after the other (their states
    do not fit the card together); the losses held to each other; each
    step timed (``StepTimer``), the collectives of the mesh run counted
    (``parallel.COUNTS``) and kernel launches counted (none may run);
    then, on the mesh run's state, DIST_PAIRS mesh and one-device steps
    timed in turns, one of each profiled (device busy ms, idle share,
    the NCCL kernels' device ms; host self ms by op, the ops that grew
    most listed), and a lone collective's host µs; peak device memory
    of the mesh run."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import mesh as tm
    from repro_torch.launch import train
    from repro_torch.models import parallel as par
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import adamw
    cfg = get_config(LM_ARCH)
    kw = dict(steps=DIST_TRAIN_STEPS, global_batch=TRAIN_B,
              seq_len=TRAIN_S, device=dev, log=lambda *a: None)
    out = {}
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with StepTimer() as one:
        _, _, one_losses = train.train(cfg, mesh={"data": 1, "model": 1},
                                       **kw)
    out["one_device_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    par.COUNTS.clear()
    t0 = time.perf_counter()
    with StepTimer() as ranked:
        (model, opt_state, losses), made = counted(
            lambda: train.train(cfg, mesh=mesh, **kw))
    out["mesh_s"] = time.perf_counter() - t0
    out["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    counts = dict(par.COUNTS)
    check(not any(made.values()), f"dist train launched {made}")
    check(len(losses) == len(one_losses) == DIST_TRAIN_STEPS
          and all(np.isfinite(losses)),
          f"dist train: losses {losses} against {one_losses}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, one_losses)]
    check(rel[0] <= DIST_LOSS0_RTOL
          and all(r <= DIST_LOSS_RTOL for r in rel[1:]),
          f"dist train: the mesh run's losses {losses} part from the "
          f"one-device run's {one_losses} by {rel}")
    plan = train.RankPlan(cfg, mesh)
    zero1 = plan.zero1()
    step = make_train_step(cfg, adamw.AdamWConfig(total_steps=TRAIN_STEPS),
                           groups=plan.groups, zero1=zero1)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_S, TRAIN_B)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in tm.local_batch(
        pipe.batch_at(DIST_TRAIN_STEPS), mesh).items()}
    # the two steps in turns on one state (one after the other, then
    # the other way round): the distributed path's cost against host noise
    sides = {"mesh": lambda: step(model, opt_state, batch),
             "one": lambda: one_step(model, opt_state, batch)}
    one_step = make_train_step(cfg, adamw.AdamWConfig(
        total_steps=TRAIN_STEPS))
    paired = {"mesh": [], "one": []}
    for i in range(DIST_PAIRS):
        for side in (("one", "mesh") if i % 2 == 0 else ("mesh", "one")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sides[side]()
            torch.cuda.synchronize()
            paired[side].append((time.perf_counter() - t0) * 1e3)
    extra = [a - b for a, b in zip(paired["mesh"], paired["one"])]
    # where the mesh step's extra host time goes: the host ops whose
    # self time grew most against the one-device step's
    host = {side: host_op_ms(fn) for side, fn in sides.items()}
    grew = sorted(((host["mesh"].get(k, 0.0) - host["one"].get(k, 0.0), k)
                   for k in set(host["mesh"]) | set(host["one"])),
                  reverse=True)[:DIST_TOP_OPS]
    one_spans = device_events(sides["one"])
    spans = device_events(sides["mesh"])
    busy = busy_ms(spans)
    # a collective's host cost alone: all_reduces of one element in a
    # row over the model group, one sync at the end
    one_el = torch.ones(1, device=dev)
    par.all_reduce(one_el, plan.groups.model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(COLLECTIVE_REPS):
        par.all_reduce(one_el, plan.groups.model)
    torch.cuda.synchronize()
    collective_us = (time.perf_counter() - t0) / COLLECTIVE_REPS * 1e6
    nccl = [(a, b, n) for a, b, n in spans if "nccl" in n.lower()]
    nccl_us, nccl_n = sum(b - a for a, b, _ in nccl), len(nccl)
    del model, opt_state, step, one_step, sides, batch
    torch.cuda.empty_cache()
    med = float(np.median(paired["mesh"]))
    one_med = float(np.median(paired["one"]))
    out.update(
        losses=losses, one_device_losses=one_losses, loss_rel=rel,
        grad_norms=ranked.gnorm, one_device_grad_norms=one.gnorm,
        step_ms_all=ranked.ms, one_device_step_ms_all=one.ms,
        paired_ms=paired, paired_extra_ms=extra,
        host_ms=({side: sum(v.values()) for side, v in host.items()}),
        host_ops_grew_ms={k: d for d, k in grew},
        step_ms=med, one_device_step_ms=one_med, busy_ms=busy,
        one_device_busy_ms=busy_ms(one_spans),
        one_device_events=len(one_spans), device_events=len(spans),
        idle_share=1.0 - busy / med if busy else None,
        collectives=counts,
        collectives_per_step={k: v / DIST_TRAIN_STEPS
                              for k, v in counts.items()},
        nccl_kernels=nccl_n, nccl_device_ms=nccl_us / 1e3,
        collective_host_us=collective_us,
        launches=made, mesh=tm.axis_sizes(mesh))
    ref = train_ref or {}
    print(f"dist train {LM_ARCH} (published config, batch {TRAIN_B} x "
          f"{TRAIN_S}, {DIST_TRAIN_STEPS} steps a side) on {card}: mesh "
          f"{out['mesh']} over {torch.distributed.get_backend()}: step "
          f"{med:.2f} ms median of {DIST_PAIRS} in turns with the "
          f"one-device step's {one_med:.2f} ms (the mesh's extra "
          f"{float(np.median(extra)):.2f} ms median, above in "
          f"{sum(x > 0 for x in extra)} of {DIST_PAIRS} pairs; the runs' "
          f"steps 1-{DIST_TRAIN_STEPS - 1}: {np.median(ranked.ms[1:]):.2f}"
          f" and {np.median(one.ms[1:]):.2f} ms; phase_train "
          f"{ref.get('step_ms', float('nan')):.2f} ms, idle "
          f"{ref.get('idle_share') or float('nan'):.3f}); host self ms "
          f"{out['host_ms']}, grown most: "
          f"{ {k: round(d, 2) for d, k in grew} }; profiled step "
          f"busy {busy:.3f} ms in {len(spans)} kernels/copies (one device "
          f"{out['one_device_busy_ms']:.3f} in {len(one_spans)}), idle share "
          f"{out['idle_share'] or float('nan'):.3f}; collectives a step "
          f"{out['collectives_per_step']} ({collective_us:.1f} µs of host "
          f"each alone), {nccl_n} NCCL kernels {nccl_us / 1e3:.3f} ms in "
          f"the profiled step; peak device "
          f"memory {out['peak_gb']:.2f} GB (phase_train "
          f"{ref.get('peak_gb', float('nan')):.2f} GB); losses {losses} "
          f"against {one_losses} (rel {max(rel):.2e})", flush=True)
    return out


def dist_family(arch: str, cut: dict, steps: int, mesh, dev,
                card: str) -> dict:
    """One arch of ``phase_dist_families``: its published config with
    ``cut``, ``steps`` steps of the one-device ``train`` (``mesh`` of
    plain sizes 1), then of ``train(mesh=mesh)`` (one after the other:
    two states may not fit beside the other card processes), the losses
    held to each other, the mesh
    run's collectives counted and its peak memory read; then
    DIST_FAMILY_PAIRS mesh and one-device steps in
    turns on the mesh run's state, one of each profiled (busy ms, idle
    share against the median)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import mesh as tm
    from repro_torch.launch import train
    from repro_torch.models import parallel as par
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import adamw
    full = get_config(arch)
    cfg = dataclasses.replace(full, **cut)
    print(f"reduced: dist train {arch} "
          + ", ".join(f"{k} {getattr(full, k)} -> {v}"
                      for k, v in cut.items())
          + f" (published widths), {steps} steps a side", flush=True)
    kw = dict(steps=steps, global_batch=TRAIN_B, seq_len=TRAIN_S,
              device=dev, opt_cfg=adamw.AdamWConfig(total_steps=steps),
              log=lambda *a: None)
    torch.cuda.empty_cache()
    with StepTimer() as one:
        _, _, one_losses = train.train(cfg, mesh={"data": 1, "model": 1},
                                       **kw)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    par.COUNTS.clear()
    with StepTimer() as ranked:
        (model, opt_state, losses), made = counted(
            lambda: train.train(cfg, mesh=mesh, **kw))
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    counts = {k: v / steps for k, v in par.COUNTS.items()}
    check(not any(made.values()), f"dist train {arch} launched {made}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, one_losses)]
    check(len(losses) == len(one_losses) == steps
          and all(np.isfinite(losses))
          and rel[0] <= DIST_FAMILY_LOSS0_RTOL
          and all(r <= DIST_FAMILY_LOSS_RTOL for r in rel[1:]),
          f"dist train {arch}: the mesh run's losses {losses} against the "
          f"one-device run's {one_losses} (rel {rel})")
    plan = train.RankPlan(cfg, mesh)
    zero1 = plan.zero1()
    mesh_step = make_train_step(cfg, adamw.AdamWConfig(total_steps=steps),
                                groups=plan.groups, zero1=zero1)
    one_step = make_train_step(cfg, adamw.AdamWConfig(total_steps=steps))
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_S, TRAIN_B)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in tm.local_batch(
        pipe.batch_at(steps), mesh).items()}
    sides = {"mesh": lambda: mesh_step(model, opt_state, batch),
             "one": lambda: one_step(model, opt_state, batch)}
    paired = {"mesh": [], "one": []}
    for i in range(DIST_FAMILY_PAIRS):
        for side in (("one", "mesh") if i % 2 == 0 else ("mesh", "one")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sides[side]()
            torch.cuda.synchronize()
            paired[side].append((time.perf_counter() - t0) * 1e3)
    busy = {side: busy_ms(device_events(fn)) for side, fn in sides.items()}
    med = {side: float(np.median(v)) for side, v in paired.items()}
    idle = {side: (1.0 - busy[side] / med[side]) if busy[side] else None
            for side in sides}
    del model, opt_state, sides, mesh_step, one_step, batch
    torch.cuda.empty_cache()
    print(f"dist train {arch} (published widths, {cut}, batch {TRAIN_B} x "
          f"{TRAIN_S}, {steps} steps a side) on {card}: mesh "
          f"{tm.axis_sizes(mesh)} over {torch.distributed.get_backend()}: "
          f"losses {losses} against {one_losses} (rel {rel}); step "
          f"{med['mesh']:.2f} ms median of {DIST_FAMILY_PAIRS} in turns "
          f"with the one-device step's {med['one']:.2f} ms; busy "
          f"{busy['mesh']:.3f} / {busy['one']:.3f} ms, idle share "
          f"{idle['mesh'] or float('nan'):.3f} / "
          f"{idle['one'] or float('nan'):.3f}; collectives a step "
          f"{counts}; peak device memory {peak:.2f} GB; kernel launches "
          f"{made}", flush=True)
    return dict(cut=cut, steps=steps, losses=losses,
                one_device_losses=one_losses, loss_rel=rel,
                grad_norms=ranked.gnorm, one_device_grad_norms=one.gnorm,
                step_ms_all=ranked.ms, one_device_step_ms_all=one.ms,
                paired_ms=paired, step_ms=med["mesh"],
                one_device_step_ms=med["one"], busy_ms=busy["mesh"],
                one_device_busy_ms=busy["one"], idle_share=idle["mesh"],
                one_device_idle_share=idle["one"],
                collectives_per_step=counts, peak_gb=peak, launches=made)


def phase_dist_families(seed: int, dev, card: str = "") -> dict:
    """Training across ranks of the families beside gemma-2b's
    (``dist_train``), in the fourth card process after the LM twins (off
    the main process's path, which the time limit binds): a world of one
    of its own (NCCL on the card, gloo on the CPU) on a (1, 1)
    ``DeviceMesh``, and ``dist_family`` for each of DIST_FAMILIES (the
    MoE routing over the global batch with the experts' FSDP gathers,
    the mamba1 and mamba2 blocks' tensor-parallel collectives and the
    shared attention block's, on groups of one).  ``seed`` is unused:
    ``train`` draws its seed-0 init."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as tm
    out, launches = {}, {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tm.init_world(dev.type, init_method=f"file://{tmp}/store", rank=0,
                      world_size=1)
        try:
            mesh = tm.make_local_mesh(1, 1, dev.type)
            for arch, cut, steps in DIST_FAMILIES:
                out[arch] = dist_family(arch, cut, steps, mesh, dev, card)
                launches[arch] = out[arch]["launches"]
        finally:
            dist.destroy_process_group()
    out = {"dist_families": {"archs": out, "launches": launches,
                             "seconds": time.perf_counter() - t0}}
    print(f"phase dist families: {out['dist_families']['seconds']:.1f} s",
          flush=True)
    return out


def phase_dist(vectors, seed: int, dev, card: str = "",
               train_ref: dict | None = None) -> dict:
    """The mesh over ``torch.distributed``: a world of one rank (NCCL on
    the card, gloo on the CPU) on a (1, 1) ``DeviceMesh``.  The search at
    deployment width (the 1,000,000 x 768 table over a random regular
    graph of degree 64, beam 16, 3 batches of 4,096): the rank's step
    (``make_sharded_search(mesh, ...)`` on its ``shard_state``) and the
    one-card tuple (1, 1) step from the same state, in turns, must give
    bit-equal ids, distances, bucket tables and step after every batch
    and launch ``lsh_hash`` and ``gather_distance`` as often; each
    step's median wall ms, then one more profiled step each (device busy
    ms, idle share against the median).  Then ``reshard`` places
    gemma-2b's published-width bf16 parameters on the mesh per
    ``build_shardings``, and every ``full_tensor()`` must equal its
    source bit for bit.  Then training across ranks on that mesh
    (``dist_train``: gemma-2b at its published config beside the
    one-device run; ``train_ref`` is ``phase_train``'s output, printed
    beside)."""
    import torch.distributed as dist
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import lsh as lsh_mod
    from repro_torch.core import sharded as sh
    from repro_torch.core.beam_search import SearchSpec
    from repro_torch.core.vamana import _random_regular_init
    from repro_torch.ft.elastic import reshard
    from repro_torch.launch import mesh as tm
    from repro_torch.launch.train import build_shardings
    from repro_torch.models import model as M
    n, d = vectors.shape
    rng = np.random.default_rng(seed + 3)
    adj = torch.as_tensor(_random_regular_init(n, 64, rng), device=dev)
    medoid = int(torch.argmin(torch.square(vectors - vectors.mean(0))
                              .sum(1)))
    lsh = lsh_mod.make_lsh(torch.Generator().manual_seed(seed), 8, d, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    rows = torch.randint(0, n, (DIST_BATCHES * B,), generator=gen,
                         device=dev)
    queries = vectors[rows] + 0.1 * torch.randn(
        (DIST_BATCHES * B, d), generator=gen, device=dev)
    spec = SearchSpec(beam_width=16, k=10, max_iters=64)
    tables = ("bucket_ids", "bucket_stamp", "bucket_step")
    out, paths = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tm.init_world(dev.type, init_method=f"file://{tmp}/store", rank=0,
                      world_size=1)
        try:
            mesh = tm.make_local_mesh(1, 1, dev.type)
            out["init_s"] = time.perf_counter() - t0
            out["backend"] = dist.get_backend()
            check(out["backend"] == ("nccl" if dev.type == "cuda"
                                     else "gloo"),
                  f"the world of one runs over {out['backend']}")
            # the group's first collective sets up its communicator
            # (about a second over NCCL): timed apart from the steps
            t0 = time.perf_counter()
            warm = [torch.empty(1, device=dev)]
            dist.all_gather(warm, torch.ones(1, device=dev),
                            group=mesh.get_group("model"))
            torch.cuda.synchronize()
            out["first_collective_ms"] = (time.perf_counter() - t0) * 1e3
            full = sh.ShardedEngineState(
                vectors=vectors, adjacency=adj,
                medoids=torch.tensor([medoid], dtype=torch.int32,
                                     device=dev),
                hyperplanes=lsh.hyperplanes,
                bucket_ids=torch.full((2 ** 8, 40), -1, dtype=torch.int32,
                                      device=dev),
                bucket_stamp=torch.full((2 ** 8, 40), -1,
                                        dtype=torch.int32, device=dev),
                bucket_step=torch.zeros(1, dtype=torch.int32, device=dev))
            sides = {"dist": [sh.make_sharded_search(mesh, spec, n, 8),
                              sh.shard_state(full, mesh)],
                     "tuple": [sh.make_sharded_search((1, 1), spec, n, 8),
                               full]}
            ms = {side: [] for side in sides}

            def step(side, q):
                fn, state = sides[side]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, ids, dist_ = fn(state, q)
                torch.cuda.synchronize()
                sides[side][1] = state
                return (time.perf_counter() - t0) * 1e3, ids, dist_

            def run():
                launches = {side: {} for side in sides}
                for i in range(DIST_BATCHES):
                    q = queries[i * B: (i + 1) * B]
                    got = {}
                    for side in sides:
                        (t, ids, dd), n_l = launches_of(
                            lambda: step(side, q))
                        ms[side].append(t)
                        got[side] = (ids, dd)
                        add_launches(launches[side], n_l)
                    a, b = sides["dist"][1], sides["tuple"][1]
                    check(torch.equal(got["dist"][0], got["tuple"][0])
                          and torch.equal(got["dist"][1], got["tuple"][1]),
                          f"dist batch {i}: the rank's ids or distances "
                          f"differ from the tuple step's")
                    for name in tables:
                        check(torch.equal(getattr(a, name),
                                          getattr(b, name)),
                              f"dist batch {i}: the rank's {name} differs "
                              f"from the tuple step's")
                return launches

            (launches, iters), _ = counted(lambda: spy_lookups(run))
            paths["dist"], paths["dist_tuple"] = (launches["dist"],
                                                  launches["tuple"])
            want = expected_launches("catapult", "unfused", iters[::2])
            check(paths["dist"] == paths["dist_tuple"] == want
                  and iters[::2] == iters[1::2],
                  f"dist: the rank's step launched {paths['dist']}, the "
                  f"tuple step {paths['dist_tuple']}; their loop "
                  f"iterations {iters} imply {want} each")
            for side in sides:
                med = float(np.median(ms[side]))
                busy = device_busy_ms(lambda: step(side, queries[:B]))
                out[side] = dict(step_ms=ms[side], step_ms_median=med,
                                 device_busy_ms=busy,
                                 idle_share=(1.0 - busy / med) if busy > 0
                                 else None)
            out["loop_iterations"] = iters[::2]
            out["published"] = int(sides["dist"][1].bucket_step.sum())
            del sides

            # the parameters of gemma-2b at its published widths, placed
            cfg = get_config(LM_ARCH)
            model = M.init(cfg, torch.Generator(device=dev).manual_seed(
                seed), dev)
            tree = convert.stack_tree(dict(model.named_parameters()))
            del model
            param_sh, _ = build_shardings(cfg, mesh)
            pspecs = tm.tree_map(lambda s: s.spec, param_sh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            placed = reshard(tree, pspecs, mesh)
            torch.cuda.synchronize()
            out["reshard_s"] = time.perf_counter() - t0
            sizes = []

            def same(src, dt, spec):
                check(tuple(dt.placements) == tm.placements(spec, mesh,
                                                            src.shape)
                      and torch.equal(dt.full_tensor(), src),
                      f"reshard: a {tuple(src.shape)} leaf under {spec} "
                      f"did not come back bit-equal")
                sizes.append(src.numel() * src.element_size())

            tm.tree_map(same, tree, placed, pspecs)
            out["reshard"] = dict(leaves=len(sizes), gb=sum(sizes) / 1e9,
                                  dtype=str(cfg.dtype))
            del tree, placed
            t0 = time.perf_counter()
            out["train"] = dist_train(mesh, dev, card, train_ref)
            out["train"]["seconds"] = time.perf_counter() - t0
            paths["dist_train"] = out["train"]["launches"]
        finally:
            dist.destroy_process_group()
    out["launches"] = paths
    print(f"dist: {out}", flush=True)
    return out


def json_default(o):
    """numpy scalars and arrays as plain JSON."""
    return o.tolist() if hasattr(o, "tolist") else str(o)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every number of the run to this JSON")
    ap.add_argument("--shift-graph", default=None, metavar="NPZ",
                    help=argparse.SUPPRESS)   # the run's own helper process
    ap.add_argument("--tiers", default=None, metavar="JSON",
                    help=argparse.SUPPRESS)   # the run's own second process
    ap.add_argument("--ingest", default=None, metavar="JSON",
                    help=argparse.SUPPRESS)   # the run's own third process
    ap.add_argument("--models", default=None, metavar="JSON",
                    help=argparse.SUPPRESS)   # the run's own fourth process
    ap.add_argument("--dryrun", default=None, metavar="JSON",
                    help=argparse.SUPPRESS)   # the run's own fifth process
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    if args.shift_graph:
        sys.path.insert(0, str(ROOT / "src"))
        build_shift_graph(args.shift_graph)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    t_run = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build_dir = _build.build_all()
    build_s = time.perf_counter() - t0
    if args.tiers:
        Path(args.tiers).write_text(json.dumps(
            tier_process(args.seed, dev), default=json_default))
        return 0
    if args.ingest:
        Path(args.ingest).write_text(json.dumps(
            phase_ingest_all(dev), default=json_default))
        return 0
    if args.models:
        out = phase_lm_twins(args.seed, dev)
        out.update(phase_dist_families(args.seed, dev, card))
        Path(args.models).write_text(json.dumps(out, default=json_default))
        return 0
    if args.dryrun:
        Path(args.dryrun).write_text(json.dumps(
            phase_dryrun(args.seed, dev, card), default=json_default))
        return 0
    print(f"kernels built in {build_s:.1f} s into {build_dir}", flush=True)
    with tempfile.TemporaryDirectory() as tmp, \
            DryCells(Path(tmp), dev) as dry_cells, \
            ShiftGraph(Path(tmp) / "shift_graph.npz") as shift_graph, \
            TierPhases(Path(tmp) / "tiers.json") as tier_phases, \
            TierPhases(Path(tmp) / "ingest.json",
                       "--ingest") as ingest_phases, \
            TierPhases(Path(tmp) / "models.json",
                       "--models") as lm_phases, \
            TierPhases(Path(tmp) / "dryrun.json",
                       "--dryrun") as dry_phases:
        dry_cells.start()
        return run_phases(args, card, build_dir, build_s, t_run, dev,
                          shift_graph, (tier_phases, ingest_phases,
                                        lm_phases, dry_phases), dry_cells)


def run_phases(args, card, build_dir, build_s, t_run, dev,
               shift_graph, helpers, dry_cells) -> int:
    """Every phase, in order (the LM serving and training phases alone
    after phase 1; then the tier phases and the sharded deployment in a second process,
    the ingest and baseline phases in a third and the LM twins in a
    fourth, all beside phases 2 to 5), then the kernels line and the
    device line."""
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    vectors = torch.randn((N, D), generator=gen, device=dev)
    kernels = phase_kernels(vectors, gen, dev)
    kernels.update(phase_pq_kernels(gen, dev))
    kernels["l2_distance"] = phase_l2_distance(vectors, dev)
    t0 = time.perf_counter()
    serve = phase_serve(args.seed, dev)
    serve["seconds"] = time.perf_counter() - t0
    print(f"phase serve: {serve['seconds']:.1f} s", flush=True)
    t0 = time.perf_counter()
    trained = phase_train(args.seed, dev)
    trained["seconds"] = time.perf_counter() - t0
    print(f"phase train: {trained['seconds']:.1f} s", flush=True)
    for helper in helpers:
        helper.start()
    main_path = phase_main_path(args.seed, dev)
    t0 = time.perf_counter()
    filtered = phase_filtered(dev)
    filtered["seconds"] = time.perf_counter() - t0
    print(f"phase filtered: {filtered['seconds']:.1f} s", flush=True)
    t0 = time.perf_counter()
    shift = phase_adapt_shift(shift_graph.result(), dev)
    shift["seconds"] = time.perf_counter() - t0
    print(f"phase adapt shift: {shift['seconds']:.1f} s", flush=True)
    deploy = phase_deployment(vectors, gen, args.seed, dev,
                              {k: v["ms"] for k, v in kernels.items()})
    tiers = helpers[0].result()
    for helper in helpers[1:]:
        tiers.update(helper.result())
    tiers["dryrun"]["cells"].update(dry_cells.result(card))
    t0 = time.perf_counter()
    dist_out = phase_dist(vectors, args.seed, dev, card, trained)
    dist_out["seconds"] = time.perf_counter() - t0
    print(f"phase dist: {dist_out['seconds']:.1f} s", flush=True)

    sources = {"fused_hop_l2": ("fused_hop.cu", "fused_hop.py:160"),
               "fused_hop_pq": ("fused_hop_pq.cu", "fused_hop.py:204"),
               "lsh_hash": ("lsh_hash.cu", "lsh_hash.py:29"),
               "pq_adc": ("pq_adc.cu", "pq_adc.py:39"),
               "gather_distance": ("gather_distance.cu",
                                   "gather_distance.py:35"),
               "l2_distance": ("l2_distance.cu", "l2_distance.py:35")}
    by_path = {**serve["launches"], **trained["launches"],
               **main_path["launches"], **main_path["pq"]["launches"],
               **main_path["mutations"]["launches"],
               **main_path["disk"]["launches"],
               **main_path["modes"]["launches"], **filtered["launches"],
               **filtered["pq"]["launches"],
               "adapt_stationary": main_path["adapt_stationary"]["launches"],
               "adapt_shift": shift["adaptive"]["launches"],
               "adapt_shift_frozen": shift["frozen"]["launches"],
               **{name if name.startswith(part) else f"{part}_{name}": n
                  for part, out in tiers.items()
                  for name, n in out["launches"].items()},
               **{name if name.startswith("deployment_")
                  else f"deployment_{name}": n
                  for name, n in deploy["launches"].items()},
               **dist_out["launches"]}
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{src}",
         "replaces": f"src/repro/kernels/{tpu}",
         "launches": sum(n[name] for n in by_path.values()),
         "launches_by_path": {p: n[name] for p, n in by_path.items()},
         "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"],
         "bound_ms": kernels[name]["bound_ms"],
         "bound_by": kernels[name]["bound_by"],
         "library_ms": kernels[name].get("library_ms"),
         **({"bound_f32_ms": kernels[name]["bound_f32_ms"]}
            if "bound_f32_ms" in kernels[name] else {})}
        for name, (src, tpu) in sources.items()]}
    print(f"run seconds: {time.perf_counter() - t_run:.1f}", flush=True)
    if args.out:
        ptxas = {p.stem: p.read_text() for p in build_dir.glob("*.log")}
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "build_s": build_s, "kernels": kernels,
             "serve": serve, "train": trained, "main_path": main_path,
             "filtered": filtered,
             "adapt_shift": shift, "tiers": tiers,
             "deployment": deploy, "dist": dist_out, "ptxas": ptxas,
             "kernels_line": line}, indent=1, default=str))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
